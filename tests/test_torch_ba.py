"""Parity of the port's LM bundle adjuster (dense Schur and matrix-free
PCG) with the JAX package.

The problem is tests/conftest.make_scene, built as a JAX BAProblem and
carried across with problem.from_numpy.  Tolerances: f32 on both sides;
the linear systems agree to summation order, and after a fixed number of
LM iterations the solutions agree to the conditioning of the problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ba import LMConfig as JLM
from metricsfm_tpu.ba import lm as jlm
from metricsfm_tpu.ba import problem as jprob
from metricsfm_tpu.ba import solve_lm as jsolve
from metricsfm_tpu.ops import projection as jproj
from metricsfm_tpu_torch.ba import LMConfig as TLM
from metricsfm_tpu_torch.ba import lm as tlm
from metricsfm_tpu_torch.ba import problem as tprob
from metricsfm_tpu_torch.ba import solve_lm as tsolve
from tests.conftest import make_scene
from tests.test_ba import scene_to_problem
from tests.torch_threads import torch_threads  # noqa: F401


def _problem(seed=0, n_cams=6, n_pts=150, shared=False, noise_px=0.3):
    rng = np.random.default_rng(seed)
    sc = make_scene(rng, n_cams=n_cams, n_pts=n_pts, noise_px=noise_px)
    prob = scene_to_problem(sc, shared_model=shared)
    poses = np.asarray(prob.poses) + 0.01 * rng.normal(size=prob.poses.shape)
    pts = np.asarray(prob.points) + 0.05 * rng.normal(size=prob.points.shape)
    intrs = np.array(prob.intrs)
    intrs[:, 0] *= 1 + 0.01 * rng.normal(size=len(intrs))
    # gauge: first camera frozen; points partly frozen to exercise masks
    point_mut = (rng.uniform(size=n_pts) > 0.1).astype(np.float32)
    weight = np.where(rng.uniform(size=n_pts) > 0.5, 2.0, 1.0)
    return prob._replace(
        poses=jnp.asarray(poses, jnp.float32),
        points=jnp.asarray(pts, jnp.float32),
        intrs=jnp.asarray(intrs, jnp.float32),
        pose_mut=jnp.ones((n_cams,)).at[0].set(0.0),
        point_mut=jnp.asarray(point_mut),
        track_weight=jnp.asarray(weight, jnp.float32))


def _with_priors(prob, seed):
    """Nonzero GPS anchors (z down-weighted), full pose priors and four GPS
    triples, around the problem's own camera centers."""
    rng = np.random.default_rng(100 + seed)
    C = prob.poses.shape[0]
    centers = np.asarray(jax.vmap(jproj.camera_center)(prob.poses))
    triples = np.array([[0, 1, 2], [1, 2, 3], [2, 4, 5], [3, 1, 5]])
    return prob._replace(
        gps_pos=jnp.asarray(centers + 0.05 * rng.normal(size=centers.shape),
                            jnp.float32),
        gps_weight=jnp.asarray(np.tile([2.0, 2.0, 0.4], (C, 1)),
                               jnp.float32),
        pose_prior=jnp.asarray(np.asarray(prob.poses)
                               + 0.01 * rng.normal(size=(C, 6)), jnp.float32),
        pose_prior_weight=jnp.full((C, 6), 0.5, jnp.float32),
        gps_triple=jnp.asarray(triples, jnp.int32),
        gps_triple_weight=jnp.asarray(np.tile([3.0, 1.5], (4, 1)),
                                      jnp.float32))


def _carry(prob):
    return tprob.from_numpy({k: np.asarray(v)
                             for k, v in prob._asdict().items()}, "cpu")


def test_from_numpy_round_trip():
    prob = _with_priors(_problem(), 0)
    tp = _carry(prob)
    back = tprob.to_numpy(tp)
    for k in tprob.CORE_FIELDS + tprob.PRIOR_FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(prob, k)))


def test_cost_and_residuals_match():
    prob = _problem(1)
    tp = _carry(prob)
    np.testing.assert_allclose(tlm.compute_residuals(tp).numpy(),
                               np.asarray(jlm.compute_residuals(prob)),
                               atol=2e-3)
    np.testing.assert_allclose(float(tlm.problem_cost(tp, 1.0)),
                               float(jlm.problem_cost(prob, 1.0)), rtol=1e-5)


def test_reduced_camera_system_matches():
    """S and rhs of the Schur-reduced system (index_add_ assembly) equal the
    JAX package's one-hot-matmul assembly."""
    prob = _problem(2, noise_px=1.5)           # some Huber-downweighted rows
    cfg_j, cfg_t = JLM(), TLM()
    Sj, rj, _ = jlm.partial_camera_system(prob, 1e-3, cfg_j)
    St, rt, _ = tlm.partial_camera_system(_carry(prob), 1e-3, cfg_t)
    Sj, rj = np.asarray(Sj), np.asarray(rj)
    scale = np.abs(Sj).max()
    np.testing.assert_allclose(St.numpy(), Sj, atol=2e-5 * scale)
    np.testing.assert_allclose(rt.numpy(), rj, atol=2e-5 * np.abs(rj).max())
    # and the damped, masked solve + back-substitution
    dj = jlm._assemble_and_solve(prob, jnp.float32(1e-3), cfg_j)
    dt = tlm._assemble_and_solve(_carry(prob), 1e-3, cfg_t)
    for a, b in zip(dj, dt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=1e-3 * max(np.abs(a).max(), 1e-6))


@pytest.mark.parametrize("shared", [False, True])
def test_solve_lm_matches(shared):
    """A fixed number of LM iterations (rtol 0): final cost within 1e-3
    relative, poses within 2e-4, points within 2e-3, focal within 1e-4
    relative."""
    prob = _problem(3, shared=shared)
    jo, ji = jsolve(prob, JLM(max_iterations=8, rtol=0.0))
    to, ti = tsolve(_carry(prob), TLM(max_iterations=8, rtol=0.0))
    assert ti["iterations"] == int(ji["iterations"]) == 8
    np.testing.assert_allclose(ti["initial_cost"], float(ji["initial_cost"]),
                               rtol=1e-5)
    np.testing.assert_allclose(ti["final_cost"], float(ji["final_cost"]),
                               rtol=1e-3)
    assert ti["final_cost"] < 0.2 * ti["initial_cost"]
    np.testing.assert_allclose(to.poses.numpy(), np.asarray(jo.poses),
                               atol=2e-4)
    np.testing.assert_allclose(to.points.numpy(), np.asarray(jo.points),
                               atol=2e-3)
    np.testing.assert_allclose(to.intrs.numpy()[:, 0],
                               np.asarray(jo.intrs)[:, 0], rtol=1e-4)


def test_solve_lm_converges_like_jax():
    """Run to convergence at the pipeline's rtol (ba.rtol = 1e-6): both
    converge, to the same final cost."""
    prob = _problem(4)
    jo, ji = jsolve(prob, JLM(max_iterations=50, rtol=1e-6))
    to, ti = tsolve(_carry(prob), TLM(max_iterations=50, rtol=1e-6))
    assert ti["converged"] and bool(ji["converged"])
    np.testing.assert_allclose(ti["final_cost"], float(ji["final_cost"]),
                               rtol=1e-3)
    np.testing.assert_allclose(ti["rms_px"], float(ji["rms_px"]), rtol=1e-3)


def test_normalize_problem_matches():
    prob = _problem(5)
    nj, (mj, sj) = jprob.normalize_problem(prob, 100.0)
    nt, (mt, st) = tprob.normalize_problem(_carry(prob), 100.0)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    np.testing.assert_allclose(nt.points.numpy(), np.asarray(nj.points),
                               atol=1e-3)
    np.testing.assert_allclose(nt.poses.numpy(), np.asarray(nj.poses),
                               atol=1e-3)
    back = tprob.denormalize_problem(nt, (mt, st))
    np.testing.assert_allclose(back.points.numpy(),
                               np.asarray(prob.points), atol=1e-4)


def test_scene_to_ba_problem_matches():
    """Scene -> BAProblem materialization (tracks, V cap, masks, buckets)
    gives the same arrays in both packages, and update_from_ba writes back
    the same poses."""
    from metricsfm_tpu.models.scene import CameraModel as JCam
    from metricsfm_tpu.models.scene import Scene as JScene
    from metricsfm_tpu_torch.models.scene import CameraModel as TCam
    from metricsfm_tpu_torch.models.scene import Scene as TScene

    rng = np.random.default_rng(8)
    sc = make_scene(rng, n_cams=5, n_pts=40)
    kp_xy = {i: sc["obs"][i] for i in range(5)}
    scenes = []
    for Scene, Cam in ((JScene, JCam), (TScene, TCam)):
        s = Scene(6)
        for i in range(5):
            mi = s.add_camera_model(Cam(f=1000.0 + i, f_hint=1000.0))
            s.register_image(i, sc["poses"][i], mi, 40)
        for p in range(40):
            views = [i for i in range(5) if (p + i) % 4 != 0]
            s.add_track(sc["points"][p], {i: p for i in views})
        s.mark_bad(3)
        scenes.append(s)
    kw = dict(max_views=3, mutable_images=[1, 2, 3], weight_multiview=2.0)
    pj, mj = scenes[0].to_ba_problem(kp_xy, **kw)
    pt, mt = scenes[1].to_ba_problem(kp_xy, device="cpu", **kw)
    assert mj == mt
    for k in tprob.CORE_FIELDS:
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(pj, k)), err_msg=k)
    moved = pt._replace(poses=pt.poses + 0.01)
    scenes[1].update_from_ba(moved, mt)
    scenes[0].update_from_ba(pj._replace(poses=pj.poses + 0.01), mj)
    for i in range(5):
        np.testing.assert_allclose(scenes[1].poses[i], scenes[0].poses[i],
                                   atol=1e-6)


def test_unported_terms_raise():
    """The GPS / pose-prior / triple terms, once refused by from_numpy,
    are carried across with their weights; absent prior fields take the
    zero-weight defaults (one placeholder triple)."""
    prob = _problem(6)
    arrays = {k: np.asarray(v) for k, v in prob._asdict().items()}
    arrays["gps_weight"] = np.ones_like(arrays["gps_weight"])
    tp = tprob.from_numpy(arrays, "cpu")
    assert torch.equal(tp.gps_weight, torch.ones_like(tp.gps_weight))
    assert tlm.has_priors(tp)
    core = tprob.from_numpy({k: arrays[k] for k in tprob.CORE_FIELDS}, "cpu")
    assert not tlm.has_priors(core)
    assert core.gps_triple.shape == (1, 3)
    assert core.gps_triple_weight.shape == (1, 2)
    assert core.pose_prior.shape == core.poses.shape


def test_perturb_problem_uses_generator():
    tp = _carry(_problem(7))
    a = tprob.perturb_problem(tp, torch.Generator().manual_seed(1))
    b = tprob.perturb_problem(tp, torch.Generator().manual_seed(1))
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)
    d = (a.points - tp.points).numpy()
    assert 0.3 < d.std() < 0.7                     # sigma_pt = 0.5


@pytest.mark.parametrize("seed,shared,noise", [(15, False, 1.5),
                                               (9, True, 0.3)])
def test_cg_step_matches_jax(seed, shared, noise):
    """One PCG step (_assemble_and_solve_cg, converged to cg_tol 1e-7):
    d_pose, d_intr and d_pt within 1e-4 of their largest entry of the JAX
    package's.  What limits the agreement is the f32 linearization, not the
    CG: the two packages' Jacobians differ in the last bits, so on other
    problems their steps differ by up to 2.8e-4 of the largest entry (their
    dense-Schur steps by up to 1.6e-4), whatever the CG tolerance.  These
    two problems are well conditioned: measured 3.5e-5 and 4.3e-5.  With
    one shared camera model its intrinsics are frozen, as in
    tests/test_ba_scale.py: that direction is too ill-conditioned for a
    step-level comparison."""
    prob = _problem(seed, n_cams=10, n_pts=300, shared=shared,
                    noise_px=noise)
    if shared:
        prob = prob._replace(intr_mut=jnp.zeros_like(prob.intr_mut))
    cfg_j = JLM(cg_iterations=200, cg_tol=1e-7)
    cfg_t = TLM(cg_iterations=200, cg_tol=1e-7)
    dj = jlm._assemble_and_solve_cg(prob, jnp.float32(1e-3), cfg_j)
    dt = tlm._assemble_and_solve(_carry(prob), 1e-3, cfg_t)
    for a, b in zip(dj, dt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-6))
    # and the PCG step solves the same system as the dense Schur step
    dd = tlm._assemble_and_solve(_carry(prob), 1e-3, TLM())
    for a, b in zip(dd, dt):
        a = a.numpy()
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=1e-3 * max(np.abs(a).max(), 1e-6))


def test_cg_rhs_and_preconditioner_blocks_match_jax():
    prob = _problem(10, n_cams=8, n_pts=200, noise_px=1.5)
    tj, rj, _ = jlm._track_terms(prob, jnp.float32(1e-3), JLM())
    tt, rt, _ = tlm._track_terms(_carry(prob), 1e-3, TLM())
    rj = np.asarray(rj)
    np.testing.assert_allclose(rt.numpy(), rj, atol=2e-5 * np.abs(rj).max())
    for k in ("blk_pose", "blk_intr"):
        a = np.asarray(tj[k])
        np.testing.assert_allclose(tt[k].numpy(), a,
                                   atol=2e-5 * np.abs(a).max(), err_msg=k)


def test_cg_camera_solve_matches_dense():
    """As tests/test_ba_scale.py:51-72 for the JAX package: LM with the
    PCG camera solve (forcing off) reaches the dense-Schur solution."""
    prob = _carry(_problem(11, n_cams=12, n_pts=512))
    out_d, info_d = tsolve(prob, TLM(max_iterations=30))
    out_c, info_c = tsolve(prob, TLM(max_iterations=30, cg_iterations=100,
                                     cg_tol=1e-6, cg_forcing=False))
    c1, c2 = info_d["final_cost"], info_c["final_cost"]
    assert abs(c1 - c2) / max(c1, 1e-9) < 0.1 or max(c1, c2) < 1e-3
    np.testing.assert_allclose(out_c.poses.numpy(), out_d.poses.numpy(),
                               atol=1e-3)
    assert c2 < 0.2 * info_c["initial_cost"]


def test_cg_forcing_converges():
    """As tests/test_ba_scale.py:75-94: the inexact-Newton forcing
    sequence reaches the optimum of exact PCG solves."""
    prob = _carry(_problem(12, n_cams=12, n_pts=512))
    _, info_exact = tsolve(prob, TLM(max_iterations=40, cg_iterations=100,
                                     cg_tol=1e-6, cg_forcing=False))
    _, info_force = tsolve(prob, TLM(max_iterations=40, cg_iterations=100,
                                     cg_tol=1e-6, cg_forcing=True))
    c1, c2 = info_exact["final_cost"], info_force["final_cost"]
    assert abs(c1 - c2) / max(c1, 1e-9) < 0.05 or max(c1, c2) < 1e-3, \
        (c1, c2)
    # and both land where the JAX package's forcing solve does
    _, info_j = jsolve(_problem(12, n_cams=12, n_pts=512),
                       JLM(max_iterations=40, cg_iterations=100,
                           cg_tol=1e-6, cg_forcing=True))
    cj = float(info_j["final_cost"])
    assert abs(c2 - cj) / max(cj, 1e-9) < 0.05 or max(c2, cj) < 1e-3


def test_cg_stops_at_tolerance_like_a_per_iteration_check(monkeypatch):
    """The device-side flag freezes x once |r|^2 <= tol^2 and the host
    polls it every CG_POLL iterations: the result equals stopping at the
    first converged iteration."""
    prob = _carry(_problem(13, n_cams=8, n_pts=200))
    cfg = TLM(cg_iterations=100, cg_tol=1e-3)
    terms, rhs, _ = tlm._track_terms(prob, 1e-3, cfg)
    polled = tlm._cg_solve(prob, terms, rhs, 1e-3, cfg)
    monkeypatch.setattr(tlm, "CG_POLL", 1)
    every = tlm._cg_solve(prob, terms, rhs, 1e-3, cfg)
    assert torch.equal(polled, every)
    # a loose tolerance stops early: fewer iterations give another x
    few = tlm._cg_solve(prob, terms, rhs, 1e-3, cfg._replace(cg_iterations=2))
    assert not torch.equal(few, every)


# ------------------------------------------------- GPS / pose-prior / triples
@pytest.mark.parametrize("seed", [0, 1])
def test_prior_terms_cost_matches_jax(seed):
    """problem_cost with nonzero GPS, pose-prior and triple weights within
    1e-5 relative of the JAX package's, and each term's residuals within
    1e-5 of their largest entry."""
    prob = _with_priors(_problem(20 + seed), seed)
    tp = _carry(prob)
    np.testing.assert_allclose(float(tlm.problem_cost(tp, 1.0)),
                               float(jlm.problem_cost(prob, 1.0)), rtol=1e-5)
    for name in ("gps_residuals", "pose_prior_residuals",
                 "gps_triple_residuals"):
        a = np.asarray(getattr(jlm, name)(prob))
        np.testing.assert_allclose(getattr(tlm, name)(tp).numpy(), a,
                                   atol=1e-5 * np.abs(a).max(), err_msg=name)


def test_prior_blocks_match_jax():
    """The prior terms' Gauss-Newton blocks (Hg per camera, Ht per triple)
    and their rhs within 1e-5 of their largest entry of the JAX
    package's _gps_prior_blocks."""
    prob = _with_priors(_problem(17, n_cams=10, n_pts=100), 1)
    for a, b, name in zip(jlm._gps_prior_blocks(prob),
                          tlm._gps_prior_blocks(_carry(prob)),
                          ("Hg", "Ht", "rhs")):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, err_msg=name,
                                   atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-4),
                                       (np.float32, 1e-3)])
def test_prior_terms_dense_step_matches_jax(dtype, tol):
    """One dense-Schur LM step (GPS, prior and triple blocks added to S):
    d_pose, d_intr and d_pt within `tol` of their largest entry of the JAX
    package's.  In f64 (jax_enable_x64 for the JAX side) the algorithm
    agrees within 1e-4; in f32 the two packages' Jacobians differ in the
    last bits and their dense steps differ by 5e-5 to 7e-4 of the largest
    entry with or without the prior terms (measured over 5 problems), so
    f32 is held to test_reduced_camera_system_matches' 1e-3."""
    prob = _with_priors(_problem(15, n_cams=10, n_pts=300, noise_px=1.5), 0)
    with jax.enable_x64(dtype == np.float64):
        prob = jax.tree.map(
            lambda x: jnp.asarray(x, dtype)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, prob)
        dj = jax.jit(jlm._assemble_and_solve, static_argnums=2)(
            prob, jnp.asarray(1e-3, dtype), JLM())
        dj = [np.asarray(a) for a in dj]
    assert dj[0].dtype == dtype
    tp = tprob.from_numpy({k: np.asarray(v)
                           for k, v in prob._asdict().items()}, "cpu",
                          dtype=getattr(torch, np.dtype(dtype).name))
    dt = tlm._assemble_and_solve(tp, 1e-3, TLM())
    for a, b in zip(dj, dt):
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=tol * max(np.abs(a).max(), 1e-6))


def test_prior_terms_cg_step_matches_jax():
    """One PCG step with the prior blocks in the matvec and Hg in the
    block-Jacobi preconditioner (converged to cg_tol 1e-7): within 1e-4
    of the largest entry of the JAX package's step (measured 1.5e-5), and
    within 1e-3 of the port's dense-Schur step."""
    prob = _with_priors(_problem(15, n_cams=10, n_pts=300, noise_px=1.5), 1)
    cfg_j = JLM(cg_iterations=200, cg_tol=1e-7)
    cfg_t = TLM(cg_iterations=200, cg_tol=1e-7)
    dj = jlm._assemble_and_solve_cg(prob, jnp.float32(1e-3), cfg_j)
    dt = tlm._assemble_and_solve(_carry(prob), 1e-3, cfg_t)
    for a, b in zip(dj, dt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-6))
    dd = tlm._assemble_and_solve(_carry(prob), 1e-3, TLM())
    for a, b in zip(dd, dt):
        a = a.numpy()
        np.testing.assert_allclose(b.numpy(), a,
                                   atol=1e-3 * max(np.abs(a).max(), 1e-6))


def test_pose_prior_alone_fixes_the_gauge_in_pcg():
    """Every camera free and no gauge camera: the pose prior alone pins
    the gauge (as in a submap), and the PCG solve reaches the dense
    solve's cost."""
    prob = _problem(16, n_cams=8, n_pts=300)
    C = prob.poses.shape[0]
    prob = prob._replace(pose_mut=jnp.ones((C,)), pose_prior=prob.poses,
                         pose_prior_weight=jnp.ones((C, 6)))
    tp = _carry(prob)
    _, info_d = tsolve(tp, TLM(max_iterations=20))
    _, info_c = tsolve(tp, TLM(max_iterations=20, cg_iterations=50))
    _, info_j = jsolve(prob, JLM(max_iterations=20, cg_iterations=50))
    assert info_c["final_cost"] < 0.2 * info_c["initial_cost"]
    np.testing.assert_allclose(info_c["final_cost"], info_d["final_cost"],
                               rtol=1e-2)
    np.testing.assert_allclose(info_c["final_cost"],
                               float(info_j["final_cost"]), rtol=1e-2)


def test_triple_residual_jacobian_is_finite_at_coincident_cameras():
    """The zero-weight placeholder triple (0, 0, 0) has three coinciding
    cameras: the sqrt(|v|^2 + eps) guard keeps its Jacobian finite."""
    poses3 = torch.zeros((1, 3, 6))
    J, r = tlm._triple_rj(poses3, torch.zeros((1, 3, 3)), torch.ones((1, 2)))
    assert torch.isfinite(J).all() and torch.isfinite(r).all()
