"""Parity of the port's calibrated seed with the JAX package: the bracketing
root finder, the Nister 5-point solver, 5-point RANSAC with the JAX
samples injected, the calibrated relative pose, and `cli sfm` end to end
on EXIF-tagged JPEGs (both packages seed through the 5-point path).

The 5-point solve is ill-conditioned in f32: the degree-10 polynomial's
roots move with the last bits of its coefficients, so two f32
implementations that differ only in summation order (or in the nullspace
basis their SVDs return) disagree on some minimal problems.  Measured on
the 200 problems below: the JAX package's own f32 solution sets agree with
an f64 solve on 153; the port's f32 sets with JAX's on 159 (151 from the
same nullspace basis).  The solution-set parity is therefore held in f64,
where it measures the algorithm (200 of 200 agree within 1e-3 from the
same basis); in f32, the dtype both packages run, the port is held to
recover the true essential matrix and to satisfy the epipolar constraints
at least as well as the JAX package does.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import five_point as jfp
from metricsfm_tpu.ops import polynomial as jpoly
from metricsfm_tpu_torch.ops import five_point as tfp
from metricsfm_tpu_torch.ops import polynomial as tpoly
from tests.test_five_point import _two_view
from tests.torch_threads import torch_threads  # noqa: F401

N_MINIMAL = 200


def _separated_roots(rng, n, lo=-5.0, hi=5.0, gap=0.25):
    """n roots in [lo, hi], pairwise at least `gap` apart.  Closer roots
    share a grid cell of the bracketing search (2,048 points over the root
    bound: ~0.02 apart at |x| = 5) and, in f32, sit inside each other's
    rounding band, where no f32 root finder pins them to 1e-4."""
    while True:
        r = np.sort(rng.uniform(lo, hi, n))
        if n < 2 or np.diff(r).min() >= gap:
            return r


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-4),
                                        (np.float32, 1e-3)])
def test_real_roots_bracketed_matches_jax(dtype, rtol):
    """50 seeded degree-10 polynomials with 2-10 known real roots in
    [-5, 5] (a random positive quadratic factor stands in for each missing
    pair): the same root count as the JAX package and as the truth, roots
    within `rtol` relative of JAX's.  f64 (jax_enable_x64 for the JAX
    side) holds the algorithm to 1e-4 (measured 4.9e-13); in f32 the
    coefficients' rounding alone moves these roots by up to 4.0e-4
    relative, and the two packages land 2.4e-4 apart (measured).  The port
    solves all 50 in one batched call."""
    rng = np.random.default_rng(0)
    coeffs, counts = [], []
    for _ in range(50):
        n_real = 2 * int(rng.integers(1, 6))
        c = np.poly(_separated_roots(rng, n_real))
        for _ in range((10 - n_real) // 2):
            # (x - a)^2 + b^2, b >= 0.5: no real root
            a, b = rng.uniform(-5, 5), rng.uniform(0.5, 3.0)
            c = np.polymul(c, [1.0, -2 * a, a * a + b * b])
        coeffs.append(c)
        counts.append(n_real)
    coeffs = np.asarray(coeffs, dtype)
    rt, vt = tpoly.real_roots_bracketed(torch.tensor(coeffs), max_roots=10)
    rt, vt = rt.numpy(), vt.numpy()
    with jax.enable_x64(dtype == np.float64):
        rj, vj = jax.jit(jax.vmap(lambda c: jpoly.real_roots_bracketed(
            c, max_roots=10)))(jnp.asarray(coeffs))
        rj, vj = np.asarray(rj), np.asarray(vj)
    assert rj.dtype == dtype
    for k in range(50):
        assert vj[k].sum() == vt[k].sum() == counts[k], k
        np.testing.assert_allclose(np.sort(rt[k][vt[k]]),
                                   np.sort(rj[k][vj[k]]), rtol=rtol, atol=0)


def _minimal_problems(dtype):
    rng = np.random.default_rng(0)
    x1, x2, e = zip(*[_two_view(rng) for _ in range(N_MINIMAL)])
    return (np.asarray(x1).astype(dtype), np.asarray(x2).astype(dtype),
            np.asarray(e))


def _canon(E):
    """Unit Frobenius norm, the largest entry positive."""
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def _solution_set(Es, valid):
    return [_canon(E) for E, v in zip(Es, valid) if v]


def _sets_match(a, b, tol):
    return len(a) == len(b) and all(
        min(np.abs(x - y).max() for y in b) < tol for x in a)


def _epipolar_residual(x1, x2, Es, valid):
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    h2 = np.concatenate([x2, np.ones((len(x2), 1))], axis=1)
    r = [np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)).max()
         for E, v in zip(Es, valid) if v]
    return max(r) if r else 0.0


def test_nullspace_matches_jax():
    """The two SVDs return different orthonormal bases of the same 4-dim
    nullspace: the projections onto it agree within 1e-10 in f64 (measured
    3.3e-13) and within 2e-4 in f32 (measured 7.3e-5: f32 rounding times
    the 5x9 system's condition)."""
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 2e-4)):
        x1, x2, _ = _minimal_problems(dtype)
        bt = tfp._nullspace4(torch.tensor(x1), torch.tensor(x2)).numpy()
        with jax.enable_x64(dtype == np.float64):
            bj = np.asarray(jax.vmap(jfp._nullspace4)(jnp.asarray(x1),
                                                      jnp.asarray(x2)))
        proj_t = np.einsum("kaij,kabc->kijbc", bt, bt)
        proj_j = np.einsum("kaij,kabc->kijbc", bj, bj)
        assert np.abs(proj_t - proj_j).max() < tol, dtype


def test_essential_5pt_solution_sets_match_jax_in_f64():
    """200 seeded minimal problems in f64 (jax_enable_x64 for the JAX
    side), the port solving from the JAX package's nullspace basis: the
    solution sets, unit Frobenius norm and fixed sign, match within 1e-3
    on >= 99 % of the problems (measured: all 200), and every solution of
    the port's own essential_5pt has |x2^T E x1| < 1e-5.  From its own
    basis the port's sets match on 197-198 of 200: the z of Nister's
    polynomial depends on the basis, and two roots that fall in one
    bracketing cell under one basis can fall in two under another."""
    x1, x2, _ = _minimal_problems(np.float64)
    with jax.enable_x64(True):
        bj = jax.vmap(jfp._nullspace4)(jnp.asarray(x1), jnp.asarray(x2))
        Ej, vj = jax.jit(jax.vmap(jfp.essential_5pt))(jnp.asarray(x1),
                                                      jnp.asarray(x2))
        bj, Ej, vj = np.asarray(bj), np.asarray(Ej), np.asarray(vj)
    assert Ej.dtype == np.float64
    Et, vt = tfp.essential_from_basis(torch.tensor(bj))
    Et, vt = Et.numpy(), vt.numpy()
    same = [_sets_match(_solution_set(Et[k], vt[k]),
                        _solution_set(Ej[k], vj[k]), 1e-3)
            for k in range(N_MINIMAL)]
    assert np.mean(same) >= 0.99, np.mean(same)
    Eo, vo = tfp.essential_5pt(torch.tensor(x1), torch.tensor(x2))
    Eo, vo = Eo.numpy(), vo.numpy()
    for k in range(N_MINIMAL):
        assert vo[k].any(), k
        assert _epipolar_residual(x1[k], x2[k], Eo[k], vo[k]) < 1e-5, k


def test_essential_5pt_f32_as_accurate_as_jax():
    """The same problems in f32: the port finds the true E (within 1e-3,
    up to sign) on at least as many problems as the JAX package, on at
    least 90 % of them, and its largest epipolar residual is no larger than
    JAX's (measured: 186 vs 180 found, residual 3.1e-5 vs 4.9e-5)."""
    x1, x2, e_true = _minimal_problems(np.float32)
    Et, vt = tfp.essential_5pt(torch.tensor(x1), torch.tensor(x2))
    Et, vt = Et.numpy(), vt.numpy()
    Ej, vj = jax.jit(jax.vmap(jfp.essential_5pt))(jnp.asarray(x1),
                                                  jnp.asarray(x2))
    Ej, vj = np.asarray(Ej), np.asarray(vj)

    def found(Es, valid):
        return sum(any(np.abs(E - _canon(e_true[k])).max() < 1e-3
                       for E in _solution_set(Es[k], valid[k]))
                   for k in range(N_MINIMAL))

    n_t, n_j = found(Et, vt), found(Ej, vj)
    assert n_t >= max(n_j, 0.9 * N_MINIMAL), (n_t, n_j)
    res_t = max(_epipolar_residual(x1[k], x2[k], Et[k], vt[k])
                for k in range(N_MINIMAL))
    res_j = max(_epipolar_residual(x1[k], x2[k], Ej[k], vj[k])
                for k in range(N_MINIMAL))
    assert res_t <= res_j, (res_t, res_j)


def _jax_5pt_samples(key, mask, n_hyp):
    """The samples essential_ransac_5pt draws from `key`."""
    m = jnp.asarray(mask)
    logits = jnp.where(m, 0.0, -1e9)
    keys = jax.random.split(key, n_hyp)
    return jax.vmap(lambda k: jax.random.choice(
        k, m.shape[0], shape=(5,), replace=False,
        p=jax.nn.softmax(logits)))(keys)


def _noisy_pair(seed, n=120, n_bad=36, noise=3e-4):
    rng = np.random.default_rng(seed)
    x1, x2, e_true = _two_view(rng, n=n)
    x1 = x1 + noise * rng.standard_normal(x1.shape)
    x2 = x2 + noise * rng.standard_normal(x2.shape)
    x2[:n_bad] += 0.3 * rng.standard_normal((n_bad, 2))
    mask = np.ones(n, bool)
    mask[-10:] = False
    return x1.astype(np.float32), x2.astype(np.float32), mask, e_true


@pytest.mark.parametrize("seed", [1, 2])
def test_essential_ransac_5pt_injected_samples(seed):
    """The JAX package's 128 samples injected: inlier masks agree on
    >= 0.99 of the rows, and the port rejects the corrupted rows.  The
    noise (3e-4 normalized, ~0.3 px at f = 1000) sits well inside the
    threshold, as the pipeline's 2 px does."""
    x1, x2, mask, _ = _noisy_pair(seed)
    key = jax.random.PRNGKey(seed)
    th = 4e-6
    rj = jfp.essential_ransac_5pt(jnp.asarray(x1), jnp.asarray(x2), key,
                                  mask=jnp.asarray(mask), th_sampson=th)
    idx = np.asarray(_jax_5pt_samples(key, mask, 128))
    rt = tfp.essential_ransac_5pt(torch.tensor(x1), torch.tensor(x2),
                                  mask=torch.tensor(mask), th_sampson=th,
                                  sample_idx=torch.tensor(idx))
    inl_t = rt["inlier_mask"].numpy()
    assert (np.asarray(rj["inlier_mask"]) == inl_t).mean() >= 0.99
    assert bool(rt["ok"]) and bool(rj["ok"])
    assert inl_t[:36].sum() <= 2 and inl_t[36:-10].sum() >= 70


def test_relative_pose_known_focal_5pt_matches_jax():
    """Pixel correspondences at focal 800 with 30 % outliers, the JAX
    samples injected: rotation and translation direction within 1e-3 rad
    of the JAX package's; of the truth within 5e-3 rad (rotation) and
    5e-2 rad (direction: 0.3 px noise over a 1.0-unit baseline)."""
    from metricsfm_tpu.ops import np_geom as jnpg
    rng = np.random.default_rng(5)
    f = 800.0
    R_true = jnpg.angle_axis_to_matrix(np.array([0.05, -0.2, 0.03]))
    t_true = np.array([1.0, 0.1, 0.2])
    t_true /= np.linalg.norm(t_true)
    X = rng.uniform(-3, 3, (200, 3)) + np.array([0, 0, 10.0])
    x1 = f * X[:, :2] / X[:, 2:]
    Xc = X @ R_true.T + t_true
    x2 = f * Xc[:, :2] / Xc[:, 2:]
    x1 += 0.3 * rng.standard_normal(x1.shape)
    x2 += 0.3 * rng.standard_normal(x2.shape)
    x2[:60] += rng.uniform(-80, 80, (60, 2))
    p1, p2 = x1.astype(np.float32), x2.astype(np.float32)
    key = jax.random.PRNGKey(4)
    rj = jfp.relative_pose_known_focal_5pt(jnp.asarray(p1), jnp.asarray(p2),
                                           f, f, key)
    idx = np.asarray(_jax_5pt_samples(key, np.ones(200, bool), 128))
    tfp.essential_ransac_5pt.calls = 0
    rt = tfp.relative_pose_known_focal_5pt(torch.tensor(p1),
                                           torch.tensor(p2), f, f,
                                           sample_idx=torch.tensor(idx))
    assert tfp.essential_ransac_5pt.calls == 1
    assert bool(rt["ok"]) and bool(rj["ok"])

    def rot_angle(A, B):
        c = (np.trace(A @ B.T) - 1.0) / 2.0
        return float(np.arccos(np.clip(c, -1.0, 1.0)))

    def dir_angle(a, b):
        a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
        return float(np.arccos(np.clip(a @ b, -1.0, 1.0)))

    Rt, tt = rt["R"].numpy(), rt["t"].numpy()
    assert rot_angle(Rt, np.asarray(rj["R"])) < 1e-3
    assert dir_angle(tt, np.asarray(rj["t"])) < 1e-3
    assert rot_angle(Rt, R_true) < 5e-3
    assert dir_angle(tt, t_true) < 5e-2


# ---------------------------------------------------------------- end to end
N_VIEWS = 8
WIDTH, HEIGHT = 640, 480
FOCAL = 1.1 * WIDTH


def write_exif_jpegs(fold, images, focal_px):
    """The rendered views as JPEGs (quality 95) whose EXIF carries the
    render's focal: FocalLength in mm with FocalPlaneXResolution of 2540
    per inch (100 px per mm), so focal_px = FocalLength * 100."""
    from PIL import Image
    os.makedirs(fold, exist_ok=True)
    exif = Image.Exif()
    exif[0x8769] = {0x920A: focal_px / 100.0,          # FocalLength
                    0xA20E: 2540.0, 0xA20F: 2540.0,    # FocalPlane X/Y res
                    0xA210: 2}                         # ... per inch
    for i, img in enumerate(images):
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        pil.save(os.path.join(fold, f"view_{i:03d}.jpg"), quality=95,
                 exif=exif)


@pytest.fixture(scope="module")
def exif_fold(tmp_path_factory):
    from metricsfm_tpu_torch.utils import synth
    fold = str(tmp_path_factory.mktemp("exif_jpegs"))
    gt = synth.render_scene(seed=0, n_cams=N_VIEWS, width=WIDTH,
                            height=HEIGHT, focal=FOCAL)
    write_exif_jpegs(fold, gt["images"], FOCAL)
    return fold, gt


def test_exif_focal_is_read_back(exif_fold):
    from metricsfm_tpu_torch.utils.exif import extract_image_info
    info = extract_image_info(os.path.join(exif_fold[0], "view_000.jpg"))
    assert abs(info["focal_px"] - FOCAL) < 0.005 * FOCAL, info


def _best_ate(scenes, gt):
    from metricsfm_tpu_torch.ops import np_geom
    from metricsfm_tpu_torch.utils import synth
    best = max(scenes, key=lambda s: len(s.registered))
    est = np.stack([np_geom.camera_center(best.poses[i])
                    for i in best.registered])
    return best, synth.ate_vs_gt(est, gt["centers"][best.registered])


def test_exif_jpegs_end_to_end_matches_jax(exif_fold, tmp_path):
    """`cli sfm` (port, on the CPU) and the JAX package's Database ->
    build_match_graph -> IncrementalSfM on the same 8 EXIF-tagged JPEGs:
    both register 8/8 at ATE < 0.05, and the port's seed ran the 5-point
    RANSAC."""
    import shutil

    from metricsfm_tpu.config import PRESETS as JPRESETS
    from metricsfm_tpu.models.database import Database as JDatabase
    from metricsfm_tpu.models.incremental import IncrementalSfM as JSfM
    from metricsfm_tpu.models.match_graph import build_match_graph as jbmg
    from metricsfm_tpu_torch import cli

    fold, gt = exif_fold
    mine = str(tmp_path / "port")
    shutil.copytree(fold, mine)
    tfp.essential_ransac_5pt.calls = 0
    scenes = cli.main(["sfm", mine, "--mode", "web", "--matching", "all",
                       "--no-resize", "--max-kp", "2048", "--device", "cpu"])
    assert tfp.essential_ransac_5pt.calls >= 1
    best, ate = _best_ate(scenes, gt)
    assert len(best.registered) == N_VIEWS, best.registered
    assert ate < 0.05, ate
    assert all(m.calibrated for m in best.models)

    theirs = str(tmp_path / "jax")
    shutil.copytree(fold, theirs)
    cfg = JPRESETS["web"]()
    cfg = dataclasses.replace(
        cfg, database=dataclasses.replace(cfg.database, resize=False,
                                          max_keypoints=2048),
        graph=dataclasses.replace(cfg.graph, matching_type="all"))
    db = JDatabase(theirs, cfg.database)
    db.feature_extraction()
    feats = {i: db.features(i) for i in range(db.n_images)}
    assert all(abs(f.focal_exif - FOCAL) < 0.005 * FOCAL
               for f in feats.values())
    jscenes = JSfM(feats, jbmg(db, cfg), cfg).run()
    jbest, jate = _best_ate(jscenes, gt)
    assert len(jbest.registered) == N_VIEWS, jbest.registered
    assert jate < 0.05, jate
