"""Parity of the port's minimal and robust PnP solvers with the JAX package.

dlt_oriented, epnp_robust (with the JAX package's own subset draws), p3pf
and p4pf, on tests/test_pnp_minimal.py's problems.  The focal sweeps run
P3P through a Durand-Kerner quartic, whose f32 roots carry ~1e-3 of
noise; p4pf's Newton polish takes central differences of that noise, so
its f32 result is chaotic in both packages.  The sweeps' parity is
therefore held in f64 (jax.enable_x64 on the JAX side), and their f32
results by accuracy against the truth, as the JAX tests hold them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import pnp as jp
from metricsfm_tpu_torch.ops import pnp as tp
from tests.test_pnp_minimal import _pose_scene
from tests.torch_threads import torch_threads  # noqa: F401


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _report(**measured):
    """Print what a parity test measured (shown by pytest -rP)."""
    print("measured", {k: float(v) for k, v in measured.items()})


def _rot_err(Ra, Rb):
    """Rotation angle (rad) between two rotation matrices, last two axes."""
    M = np.asarray(Ra, np.float64) @ np.swapaxes(np.asarray(Rb, np.float64),
                                                 -1, -2)
    c = (np.trace(M, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


# -- dlt_oriented ---------------------------------------------------------------

@pytest.mark.parametrize("known", [True, False])
def test_dlt_oriented_matches_jax(known):
    """t and f within 1e-4 relative; with unit or 0/1 row weights."""
    rng = np.random.default_rng(2 if known else 3)
    f = 1000.0 if known else 1400.0
    R, t, Xw, uv = _pose_scene(rng, 12, f=f)
    w = np.ones(12, np.float32)
    w[[2, 7]] = 0.0
    uv_bad = uv.copy()
    uv_bad[[2, 7]] += 80.0
    for obs, weights in ((uv, None), (uv_bad, w)):
        a = jp.dlt_oriented(jnp.asarray(R, jnp.float32),
                            jnp.asarray(Xw, jnp.float32),
                            jnp.asarray(obs, jnp.float32),
                            f=f if known else None,
                            weights=None if weights is None
                            else jnp.asarray(weights))
        b = tp.dlt_oriented(_t(R), _t(Xw), _t(obs), f=f if known else None,
                            weights=None if weights is None else _t(weights))
        ta = np.asarray(a["t"])
        _report(t_err_rel=np.abs(b["t"].numpy() - ta).max()
                / np.abs(ta).max(),
                f_err_rel=abs(float(b["f"]) - float(a["f"]))
                / abs(float(a["f"])))
        assert np.abs(b["t"].numpy() - ta).max() <= 1e-4 * np.abs(ta).max()
        assert abs(float(b["f"]) - float(a["f"])) <= 1e-4 * abs(float(a["f"]))
        # and the truth (the JAX tests' gates)
        np.testing.assert_allclose(b["t"].numpy(), t,
                                   atol=1e-3 if known else 5e-2)
        assert abs(float(b["f"]) - f) / f < 0.01


# -- epnp_robust ----------------------------------------------------------------

def _gross_outlier_problem():
    """test_pnp_minimal.test_epnp_robust_rejects_gross_outliers's inputs."""
    rng = np.random.default_rng(3)
    f = 1000.0
    R, t, Xw, uv = _pose_scene(rng, 60, f=f)
    uv_bad = uv.copy()
    bad = rng.choice(60, size=6, replace=False)
    uv_bad[bad] += rng.uniform(300, 600, size=(6, 2)) * np.sign(
        rng.standard_normal((6, 2)))
    return R, t, Xw, uv_bad, bad, f


def test_epnp_robust_matches_jax_with_its_draws():
    """With JAX's subset draws: the keep-set equal, R and t within 1e-4.
    (Where a draw keeps a gross outlier, as JAX's own key 2 does, the
    refit is ill-conditioned and the two EPnPs part by ~1e-2.)"""
    R, t, Xw, uv_bad, bad, f = _gross_outlier_problem()
    mask = np.ones(60, bool)
    mask[:4] = False
    key = jax.random.PRNGKey(0)
    for m in (None, mask):
        a = jp.epnp_robust(jnp.asarray(Xw, jnp.float32),
                           jnp.asarray(uv_bad, jnp.float32), f, key,
                           mask=None if m is None else jnp.asarray(m))
        u = np.stack([np.asarray(jax.random.uniform(k, (60,)))
                      for k in jax.random.split(key, 10)])
        b = tp.epnp_robust(_t(Xw), _t(uv_bad), f,
                           mask=None if m is None else torch.tensor(m),
                           subset_u=_t(u))
        inl = b["inlier_mask"].numpy()
        _report(R_err=np.abs(b["R"].numpy() - np.asarray(a["R"])).max(),
                t_err=np.abs(b["t"].numpy() - np.asarray(a["t"])).max())
        np.testing.assert_array_equal(inl, np.asarray(a["inlier_mask"]))
        np.testing.assert_allclose(b["R"].numpy(), np.asarray(a["R"]),
                                   atol=1e-4)
        np.testing.assert_allclose(b["t"].numpy(), np.asarray(a["t"]),
                                   atol=1e-4)
        # the JAX test's gates
        assert np.linalg.norm(b["R"].numpy() - R) < 0.02
        assert float(b["avg_err"]) < 1.0
        assert not inl[bad].any()
        assert inl.sum() == int(0.9 * (60 if m is None else 56))


def test_epnp_robust_generator_draws():
    """From a torch.Generator: reproducible; over 8 seeds, as over JAX's
    keys 0-7 (5 of 8), most draws drop every gross outlier, and every
    rotation is within 0.05 rad."""
    R, t, Xw, uv_bad, bad, f = _gross_outlier_problem()
    clean = 0
    for seed in range(8):
        out = [tp.epnp_robust(_t(Xw), _t(uv_bad), f,
                              generator=torch.Generator().manual_seed(seed))
               for _ in range(2)]
        assert torch.equal(out[0]["R"], out[1]["R"])
        assert int(out[0]["inlier_mask"].sum()) == 54
        clean += not out[0]["inlier_mask"].numpy()[bad].any()
        assert _rot_err(out[0]["R"].numpy(), R) < 0.05
    assert clean >= 4


# -- p3pf -----------------------------------------------------------------------

def test_p3pf_matches_jax():
    """f64: R and t within 1e-4 where both are valid, valid >= 0.99 equal;
    f32: valid >= 0.99 equal and the candidate set contains the truth."""
    rng = np.random.default_rng(1)
    f_true = 900.0
    R, t, Xw, uv = _pose_scene(rng, 3, f=f_true)
    for dt, jdt in ((torch.float64, jnp.float64),
                    (torch.float32, jnp.float32)):
        with jax.enable_x64(dt == torch.float64):
            a = jp.p3pf(jnp.asarray(Xw, jdt), jnp.asarray(uv, jdt),
                        f_hyp=1000.0, num_focal_samples=256)
            a = {k: np.asarray(v) for k, v in a.items()}
        b = tp.p3pf(_t(Xw, dt), _t(uv, dt), f_hyp=1000.0,
                    num_focal_samples=256)
        b = {k: v.numpy() for k, v in b.items()}
        assert b["R"].shape == (256, 4, 3, 3) and b["valid"].shape == (256, 4)
        both = a["valid"] & b["valid"]
        _report(f64=dt == torch.float64,
                valid_equal=(a["valid"] == b["valid"]).mean(),
                R_err=np.abs(b["R"][both] - a["R"][both]).max(),
                t_err=np.abs(b["t"][both] - a["t"][both]).max())
        assert (a["valid"] == b["valid"]).mean() >= 0.99
        np.testing.assert_allclose(b["f"], a["f"], rtol=1e-6)
        if dt == torch.float64:
            assert both.sum() > 100
            np.testing.assert_allclose(b["R"][both], a["R"][both], atol=1e-4)
            np.testing.assert_allclose(b["t"][both], a["t"][both], atol=1e-4)
        Rs = b["R"].reshape(-1, 3, 3)[b["valid"].reshape(-1)]
        assert min(np.linalg.norm(Rs - R, axis=(1, 2))) < 0.05


# -- p4pf -----------------------------------------------------------------------

N_P4PF = 8


@pytest.fixture(scope="module")
def p4pf_problems():
    """test_pnp_minimal.test_p4pf_recovers_pose_and_focal's 8 problems, and
    a ninth whose four world points coincide (no P3P root is valid, every
    score is +inf and each Newton step meets inf - inf: the result is the
    first sweep focal, not valid)."""
    rng = np.random.default_rng(0)
    probs = [_pose_scene(rng, 4, f=1200.0) for _ in range(N_P4PF)]
    R, t, Xw, uv = probs[0]
    probs.append((R, t, np.repeat(Xw[:1], 4, axis=0), uv))
    return probs


@pytest.fixture(scope="module")
def p4pf_jax(p4pf_problems):
    """JAX's p4pf on every problem, in f64 and in f32: one jit of a vmap
    each (an eager call compiles for ~24 s)."""
    X = np.stack([p[2] for p in p4pf_problems])
    U = np.stack([p[3] for p in p4pf_problems])
    out = {}
    for name, jdt in (("f64", jnp.float64), ("f32", jnp.float32)):
        with jax.enable_x64(name == "f64"):
            fn = jax.jit(jax.vmap(lambda x, u: jp.p4pf(x, u, 1000.0)))
            r = fn(jnp.asarray(X, jdt), jnp.asarray(U, jdt))
            out[name] = {k: np.asarray(v) for k, v in r.items()}
    return out


def test_p4pf_matches_jax_in_f64(p4pf_problems, p4pf_jax):
    """f within 1e-3 relative, R within 1e-3 rad, valid equal."""
    a = p4pf_jax["f64"]
    for i, (_, _, Xw, uv) in enumerate(p4pf_problems):
        b = tp.p4pf(_t(Xw, torch.float64), _t(uv, torch.float64), 1000.0)
        assert bool(b["valid"]) == bool(a["valid"][i])
        _report(f_err_rel=abs(float(b["f"]) - a["f"][i]) / a["f"][i],
                R_err_rad=_rot_err(b["R"].numpy(), a["R"][i])
                if a["valid"][i] else 0.0)
        assert abs(float(b["f"]) - a["f"][i]) <= 1e-3 * a["f"][i]
        if a["valid"][i]:
            assert _rot_err(b["R"].numpy(), a["R"][i]) < 1e-3
            np.testing.assert_allclose(float(b["err4"]), a["err4"][i],
                                       rtol=1e-3, atol=1e-6)
    # the degenerate problem: no finite root, the first sweep focal
    assert not bool(b["valid"]) and abs(float(b["f"]) - 300.0) < 1e-6


def test_p4pf_f32_recovers_pose_and_focal(p4pf_problems, p4pf_jax):
    """f32 as the JAX test holds it: f within 5 % and R within 0.1 in >= 6
    of 8, and the port's 4th-point error no worse than 1.01 x JAX's + 1e-3
    px on each (both polish on f32 noise)."""
    a = p4pf_jax["f32"]
    hits = 0
    for i, (R, _, Xw, uv) in enumerate(p4pf_problems[:N_P4PF]):
        b = tp.p4pf(_t(Xw), _t(uv), 1000.0)
        assert bool(b["valid"]) and bool(a["valid"][i])
        assert float(b["err4"]) <= 1.01 * a["err4"][i] + 1e-3
        if (abs(float(b["f"]) - 1200.0) / 1200.0 < 0.05
                and np.linalg.norm(b["R"].numpy() - R) < 0.1):
            hits += 1
    assert hits >= 6


def test_p4pf_and_p3pf_batch_equal_single_calls(p4pf_problems):
    """Leading axes are problems: one batched call equals the calls one by
    one (f64)."""
    X = _t(np.stack([p[2] for p in p4pf_problems]), torch.float64)
    U = _t(np.stack([p[3] for p in p4pf_problems]), torch.float64)
    batch = tp.p4pf(X, U, 1000.0)
    for i in range(len(p4pf_problems)):
        one = tp.p4pf(X[i], U[i], 1000.0)
        for k in ("R", "t", "f", "err4"):
            torch.testing.assert_close(batch[k][i], one[k], rtol=1e-9,
                                       atol=1e-9, equal_nan=True)
        assert bool(batch["valid"][i]) == bool(one["valid"])
    b3 = tp.p3pf(X[:3, :3], U[:3, :3], 1000.0, num_focal_samples=16)
    one = tp.p3pf(X[1, :3], U[1, :3], 1000.0, num_focal_samples=16)
    assert b3["valid"].shape == (3, 16, 4)
    torch.testing.assert_close(b3["R"][1][one["valid"]],
                               one["R"][one["valid"]], rtol=1e-9, atol=1e-9)
