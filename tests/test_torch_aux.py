"""Parity of the port's auxiliary ops with the JAX package, on the CPU.

Essential-guided matching (through kernel 2a's plain version here), the
four geo-verification modes, exact undistortion, lines and Hough, GIST,
panorama zones, PSO, the synthetic BA problem, outlier culling and the
scene checkpoints.  The RNG streams differ, so each sampler is fed the
JAX package's own draws: RANSAC samples from its `_sample_indices`, PSO
uniforms from its key chain, one set a round where a round's mask depends
on the round before (match_pair_essential is replayed with JAX's public
functions).  Inputs mirror tests/test_aux_components.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import epipolar as jep
from metricsfm_tpu.ops import essential_matching as jem
from metricsfm_tpu.ops import gist as jgist
from metricsfm_tpu.ops import lines as jl
from metricsfm_tpu.ops import matching as jm
from metricsfm_tpu.ops import panorama as jpan
from metricsfm_tpu.ops import ransac as jr
from metricsfm_tpu.ops import sift as js
from metricsfm_tpu.utils import calibration as jcal
from metricsfm_tpu.utils import geo_verification as jgv
from metricsfm_tpu.utils import pso as jpso
from metricsfm_tpu.utils import synth as jsynth
from metricsfm_tpu_torch.ops import essential_matching as tem
from metricsfm_tpu_torch.ops import gist as tgist
from metricsfm_tpu_torch.ops import lines as tl
from metricsfm_tpu_torch.ops import panorama as tpan
from metricsfm_tpu_torch.ops import ransac as tr
from metricsfm_tpu_torch.ops import sift as ts
from metricsfm_tpu_torch.utils import calibration as tcal
from metricsfm_tpu_torch.utils import geo_verification as tgv
from metricsfm_tpu_torch.utils import pso as tpso
from metricsfm_tpu_torch.utils import synth as tsynth
from tests.conftest import make_scene
from tests.torch_threads import torch_threads  # noqa: F401


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _report(**measured):
    """Print what a parity test measured (shown by pytest -rP)."""
    print("measured", {k: float(v) for k, v in measured.items()})


def _same_up_to_sign(a, b):
    """Largest entry difference of two matrices after Frobenius
    normalization, the better of the two signs."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


# -- essential RANSAC and essential-guided matching -------------------------

def test_essential_ransac_injected_samples():
    """Masks equal, E within 1e-4 up to sign."""
    rng = np.random.default_rng(0)
    sc = make_scene(rng, n_cams=3, n_pts=300, noise_px=0.3)
    n1 = (sc["obs"][0] / 1000.0).astype(np.float32)
    n2 = (sc["obs"][2] / 1000.0).astype(np.float32)
    bad = rng.uniform(size=300) < 0.3
    n2[bad] += rng.uniform(-0.2, 0.2, size=(bad.sum(), 2)).astype(np.float32)
    mask = rng.uniform(size=300) > 0.1
    key = jax.random.PRNGKey(3)
    rj = jr.essential_ransac(jnp.asarray(n1), jnp.asarray(n2), key,
                             mask=jnp.asarray(mask))
    idx = jr._sample_indices(key, 300, jnp.asarray(mask), 256, 8)
    rt = tr.essential_ransac(_t(n1), _t(n2), mask=_t(mask),
                             sample_idx=_t(idx))
    np.testing.assert_array_equal(rt["inlier_mask"].numpy(),
                                  np.asarray(rj["inlier_mask"]))
    assert bool(rt["ok"]) and int(rt["n_inliers"]) == int(rj["n_inliers"])
    _report(E_err=_same_up_to_sign(rj["E"], rt["E"]))
    assert _same_up_to_sign(rj["E"], rt["E"]) < 1e-4
    # the inliers are the uncorrupted rows
    inl = rt["inlier_mask"].numpy()
    assert (inl[mask] == ~bad[mask]).mean() > 0.95


def test_essential_ransac_generator_draws():
    """From a torch.Generator: the same seed, the same result; the model
    separates the corrupted rows."""
    rng = np.random.default_rng(1)
    sc = make_scene(rng, n_cams=2, n_pts=200, noise_px=0.2)
    n1 = _t(sc["obs"][0] / 1000.0, torch.float32)
    n2 = sc["obs"][1] / 1000.0
    bad = rng.uniform(size=200) < 0.25
    n2[bad] += rng.uniform(-0.2, 0.2, size=(bad.sum(), 2))
    n2 = _t(n2, torch.float32)
    out = [tr.essential_ransac(n1, n2, torch.Generator().manual_seed(5))
           for _ in range(2)]
    assert torch.equal(out[0]["inlier_mask"], out[1]["inlier_mask"])
    assert (out[0]["inlier_mask"].numpy() == ~bad).mean() > 0.95


def _essential_problem():
    """test_aux_components.test_essential_guided_matching's inputs."""
    rng = np.random.default_rng(0)
    scene = make_scene(rng, n_cams=2, n_pts=256, noise_px=0.2)
    sel = np.where(scene["vis"].all(axis=0))[0][:192]
    f = float(scene["intrs"][0][0])
    desc = rng.normal(size=(len(sel), 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    d2 = desc + 0.02 * rng.normal(size=desc.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    xy1 = scene["obs"][0][sel].astype(np.float32)
    xy2 = scene["obs"][1][sel].astype(np.float32)
    return desc, d2, xy1, xy2, f


def _jax_round_samples(desc, d2, xy1, xy2, f, key, rounds=2):
    """The E-RANSAC samples each round of JAX's match_pair_essential draws,
    replayed with the JAX package's public functions (a round's sample
    support is the mask the round before left)."""
    m = jm.match_pair(jnp.asarray(desc), jnp.asarray(d2), None, None,
                      ratio_good=0.6, ratio_all=0.85)
    cand = m["all"]
    n1 = jnp.asarray(xy1) / f
    n2 = jnp.asarray(xy2)[m["idx2"]] / f
    inl = cand
    samples = []
    for k in jax.random.split(key, rounds):
        samples.append(np.asarray(jr._sample_indices(k, n1.shape[0], inl,
                                                     128, 8)))
        r = jr.essential_ransac(n1, n2, k, mask=inl, th_sampson=1e-3,
                                num_hypotheses=128, min_inliers=8)
        new = (jep.sampson_distance(r["E"], n1, n2) < 1e-3) & cand
        inl = jnp.where(jnp.sum(new) >= 8, new, inl)
    return np.stack(samples), np.asarray(inl)


def test_match_pair_essential_matches_jax():
    """idx2 >= 0.999 equal, masks >= 0.99 equal, E within 1e-3 up to sign,
    and the JAX test's own gates on the port's result."""
    desc, d2, xy1, xy2, f = _essential_problem()
    key = jax.random.PRNGKey(0)
    rj = jem.match_pair_essential(jnp.asarray(desc), jnp.asarray(d2),
                                  jnp.asarray(xy1), jnp.asarray(xy2), f, f,
                                  key)
    samples, replay = _jax_round_samples(desc, d2, xy1, xy2, f, key)
    np.testing.assert_array_equal(replay, np.asarray(rj["inlier_mask"]))
    rt = tem.match_pair_essential(_t(desc), _t(d2), _t(xy1), _t(xy2), f, f,
                                  sample_idx=_t(samples))
    inl = rt["inlier_mask"].numpy()
    _report(idx2_equal=(rt["idx2"].numpy() == np.asarray(rj["idx2"])).mean(),
            mask_equal=(inl == np.asarray(rj["inlier_mask"])).mean(),
            E_err=_same_up_to_sign(rj["E"], rt["E"]))
    assert (rt["idx2"].numpy() == np.asarray(rj["idx2"])).mean() >= 0.999
    assert (inl == np.asarray(rj["inlier_mask"])).mean() >= 0.99
    assert _same_up_to_sign(rj["E"], rt["E"]) < 1e-3
    idx2 = rt["idx2"].numpy()
    assert inl.sum() > 100
    assert (idx2[inl] == np.arange(len(desc))[inl]).mean() > 0.95


def test_match_pair_essential_generator_and_fallback():
    """A torch.Generator drives the rounds; a round that would keep fewer
    than 8 rows keeps the mask before it (here: every candidate)."""
    desc, d2, xy1, xy2, f = _essential_problem()
    g = torch.Generator().manual_seed(0)
    rt = tem.match_pair_essential(_t(desc), _t(d2), _t(xy1), _t(xy2), f, f,
                                  generator=g)
    inl = rt["inlier_mask"].numpy()
    assert inl.sum() > 100
    assert (rt["idx2"].numpy()[inl] == np.nonzero(inl)[0]).mean() > 0.95
    tight = tem.match_pair_essential(_t(desc), _t(d2), _t(xy1), _t(xy2),
                                     f, f, generator=g, th_sampson=1e-30)
    m = jm.match_pair(jnp.asarray(desc), jnp.asarray(d2), None, None)
    np.testing.assert_array_equal(tight["inlier_mask"].numpy(),
                                  np.asarray(m["all"]))


# -- geo-verification --------------------------------------------------------

@pytest.fixture(scope="module")
def geo_pts():
    """test_aux_components.test_geo_verification_modes's inputs."""
    rng = np.random.default_rng(0)
    scene = make_scene(rng, n_cams=2, n_pts=200, noise_px=0.3)
    sel = np.where(scene["vis"].all(axis=0))[0]
    p1 = scene["obs"][0][sel]
    p2 = scene["obs"][1][sel].copy()
    p2[:30] += 150.0
    return p1, p2


def test_geo_verify_fundamental_injected(geo_pts):
    """Mode 1: mask equal, F within 1e-4 up to scale, ok equal."""
    p1, p2 = geo_pts
    key = jax.random.PRNGKey(0)
    ok_j, inl_j, F_j = jgv.verify_fundamental(p1, p2, key)
    idx = jr._sample_indices(key, len(p1), jnp.ones(len(p1), bool), 256, 8)
    ok_t, inl_t, F_t = tgv.verify_fundamental(p1, p2, device="cpu",
                                              sample_idx=np.asarray(idx))
    assert isinstance(ok_t, bool) and ok_t == ok_j
    assert isinstance(inl_t, np.ndarray) and isinstance(F_t, np.ndarray)
    np.testing.assert_array_equal(inl_t, inl_j)
    _report(F_err=_same_up_to_sign(F_j, F_t))
    assert _same_up_to_sign(F_j, F_t) < 1e-4
    assert inl_t[:30].sum() <= 3


def test_geo_refilter_with_fundamental(geo_pts):
    """Mode 2: equal on the same F."""
    p1, p2 = geo_pts
    _, _, F = jgv.verify_fundamental(p1, p2, jax.random.PRNGKey(0))
    keep = tgv.refilter_with_fundamental(F, p1, p2, device="cpu")
    np.testing.assert_array_equal(
        keep, jgv.refilter_with_fundamental(F, p1, p2))
    assert keep[30:].mean() > 0.8


def test_geo_local_flow(geo_pts):
    """Mode 3 (host numpy): exactly equal."""
    p1, p2 = geo_pts
    keep = tgv.verify_local_flow(p1, p2)
    np.testing.assert_array_equal(keep, jgv.verify_local_flow(p1, p2))
    assert keep[30:].mean() > 0.7


def test_geo_patch_fundamental_injected(geo_pts):
    """Mode 4: JAX's per-patch samples (patch c draws from split(key,
    16)[c] over its own rows): masks equal."""
    p1, p2 = geo_pts
    key = jax.random.PRNGKey(0)
    want = jgv.verify_patch_fundamental(p1, p2, key)
    lo = p1.min(axis=0)
    hi = p1.max(axis=0) + 1e-6
    cell = np.clip(np.floor((p1 - lo) / (hi - lo) * 4).astype(int), 0, 3)
    pid = cell[:, 1] * 4 + cell[:, 0]
    keys = jax.random.split(key, 16)
    samples = {}
    for c in np.unique(pid):
        n = int((pid == c).sum())
        if n >= 16:
            samples[c] = np.asarray(jr._sample_indices(
                keys[c], n, jnp.ones(n, bool), 128, 8))
    assert samples, "no patch reaches min_per_patch"
    got = tgv.verify_patch_fundamental(p1, p2, device="cpu",
                                       sample_idx=samples)
    np.testing.assert_array_equal(got, want)
    assert got[30:].mean() > 0.5


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_geo_verification_refuses_cuda_without_card(geo_pts):
    """device defaults to "cuda" and nothing picks the CPU by itself."""
    p1, p2 = geo_pts
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgv.verify_fundamental(p1, p2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgv.refilter_with_fundamental(np.eye(3), p1, p2)


# -- exact undistortion --------------------------------------------------------

def test_undistort_radius_matches_jax():
    """Within 1e-5 of JAX's, and of the truth (the JAX test's radii)."""
    k1, k2 = -0.2, 0.05
    r_u = np.asarray([0.1, 0.3, 0.6], np.float32)
    r_d = r_u * (1 + k1 * r_u ** 2 + k2 * r_u ** 4)
    got = tcal.undistort_radius(_t(r_d), k1, k2).numpy()
    _report(err=np.abs(got - np.asarray(jcal.undistort_radius(
        jnp.asarray(r_d), k1, k2))).max())
    np.testing.assert_allclose(
        got, np.asarray(jcal.undistort_radius(jnp.asarray(r_d), k1, k2)),
        atol=1e-5)
    np.testing.assert_allclose(got, r_u, atol=1e-4)
    # a scalar in, a 0-d result out
    assert tcal.undistort_radius(torch.tensor(0.3), k1, k2).shape == ()


def test_undistort_points_exact_matches_jax():
    rng = np.random.default_rng(2)
    xy = rng.uniform(-0.7, 0.7, size=(500, 2)).astype(np.float32)
    xy[0] = 0.0                                   # r_d = 0: scale 1
    k1, k2 = np.float32(-0.15), np.float32(0.02)
    want = np.asarray(jcal.undistort_points_exact(jnp.asarray(xy), k1, k2))
    got = tcal.undistort_points_exact(_t(xy), float(k1), float(k2)).numpy()
    _report(err=np.abs(got - want).max())
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[0], 0.0)


# -- lines -----------------------------------------------------------------------

def _line_images():
    """The JAX tests' images: a full vertical line, a finite vertical
    segment, a step edge; and a random texture."""
    a = np.zeros((64, 64), np.float32)
    a[:, 30] = 1.0
    b = np.zeros((96, 96), np.float32)
    b[20:60, 40] = 1.0
    c = np.zeros((80, 80), np.float32)
    c[:, 40:] = 1.0
    d = np.random.default_rng(3).uniform(0, 1, (72, 88)).astype(np.float32)
    return [a, b, c, d]


@pytest.mark.parametrize("which", range(4))
def test_gradient_field_and_hough(which):
    """Gradients within 1e-6; the accumulator within 1e-4 of its largest
    entry (JAX sums by a one-hot matmul in f32, the port by scatter-add)."""
    img = _line_images()[which]
    gj = jl.gradient_field(jnp.asarray(img))
    gt = tl.gradient_field(_t(img))
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    mag = gt[2]
    accj, thj, rhj = jl.hough_lines(jnp.asarray(mag.numpy() > 0.05),
                                    weights=jnp.asarray(mag.numpy()))
    acct, tht, rht = tl.hough_lines(mag > 0.05, weights=mag)
    accj = np.asarray(accj)
    _report(grad_err=max(np.abs(b.numpy() - np.asarray(a)).max()
                         for a, b in zip(gj, gt)),
            acc_err_rel=np.abs(acct.numpy() - accj).max() / accj.max())
    assert np.abs(acct.numpy() - accj).max() <= 1e-4 * accj.max()
    np.testing.assert_array_equal(tht.numpy(), np.asarray(thj))
    np.testing.assert_array_equal(rht.numpy(), np.asarray(rhj))


def _bins(theta, rho, thetas, rhos):
    """Grid cell (theta bin, rho bin) of each peak."""
    ti = np.abs(np.asarray(theta)[:, None] - np.asarray(thetas)[None]
                ).argmin(axis=1)
    ri = np.abs(np.asarray(rho)[:, None] - np.asarray(rhos)[None]
                ).argmin(axis=1)
    return ti, ri


@pytest.mark.parametrize("which", range(3))
def test_detect_lines_matches_jax(which):
    """The same Hough cells in the same order; their theta and rho within
    2 ulp (inside the jitted detect_lines XLA fuses the grid into the
    gather and rounds it its own way; the grids themselves are equal, see
    above); scores within 1e-4 of the top score."""
    img = _line_images()[which]
    a = jl.detect_lines(jnp.asarray(img), max_lines=8)
    b = tl.detect_lines(_t(img), max_lines=8)
    _, thetas, rhos = tl.hough_lines(torch.zeros(img.shape, dtype=bool))
    np.testing.assert_array_equal(
        np.stack(_bins(b["theta"].numpy(), b["rho"].numpy(), thetas, rhos)),
        np.stack(_bins(a["theta"], a["rho"], thetas, rhos)))
    np.testing.assert_array_max_ulp(b["theta"].numpy(),
                                    np.asarray(a["theta"]), maxulp=2)
    np.testing.assert_array_max_ulp(b["rho"].numpy(), np.asarray(a["rho"]),
                                    maxulp=2)
    top = float(a["score"][0])
    _report(score_err_rel=np.abs(b["score"].numpy()
                                 - np.asarray(a["score"])).max() / top)
    np.testing.assert_allclose(b["score"].numpy(), np.asarray(a["score"]),
                               atol=1e-4 * top)
    if which == 0:           # the JAX test's gate: theta ~ 0, rho ~ 30
        assert abs(np.cos(float(b["theta"][0]))) > 0.9
        assert abs(abs(float(b["rho"][0])) - 30) < 3


def test_top_peaks_order_ties_by_lowest_index():
    """Equal votes come out lowest flat index first, as lax.top_k orders
    them."""
    acc = torch.tensor([[1.0, 3.0, 2.0], [3.0, 0.0, 3.0]])
    votes, idx = tl._top_peaks(acc, 4)
    np.testing.assert_array_equal(idx.numpy(), [1, 3, 5, 2])
    _, jidx = jax.lax.top_k(jnp.asarray(acc.numpy()).reshape(-1), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("which", range(3))
def test_detect_segments_matches_jax(which):
    """Endpoints within 1e-3 px, ok equal, on the JAX tests' images."""
    img = _line_images()[which]
    a = jl.detect_segments(jnp.asarray(img), max_segments=8)
    b = tl.detect_segments(_t(img), max_segments=8)
    ok = np.asarray(a["ok"])
    np.testing.assert_array_equal(b["ok"].numpy(), ok)
    _report(endpoint_err_px=max(np.abs(b[k].numpy()[ok]
                                       - np.asarray(a[k])[ok]).max()
                                for k in ("p0", "p1")))
    for k in ("p0", "p1"):
        np.testing.assert_allclose(b[k].numpy()[ok], np.asarray(a[k])[ok],
                                   atol=1e-3)
    if which == 1:           # the JAX test's gate: x = 40, y in [20, 60)
        p0, p1 = b["p0"][0].numpy(), b["p1"][0].numpy()
        ys = sorted([p0[1], p1[1]])
        assert ok[0] and abs(p0[0] - 40) < 3 and abs(p1[0] - 40) < 3
        assert abs(ys[0] - 20) < 5 and abs(ys[1] - 60) < 5


def test_local_orientation_matches_jax():
    """Within 1e-5, windows clipped at every border and origins truncated
    toward zero (points left of and above the image)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (80, 100)).astype(np.float32)
    pts = rng.uniform(-6, 106, (64, 2)).astype(np.float32)
    pts[0] = [-0.5, -0.5]
    pts[1] = [99.9, 79.9]
    a = np.asarray(jl.local_orientation(jnp.asarray(img), jnp.asarray(pts),
                                        win_half=8))
    b = tl.local_orientation(_t(img), _t(pts), win_half=8).numpy()
    _report(err=np.abs(b - a).max())
    np.testing.assert_allclose(b, a, atol=1e-5)
    # the JAX test's step edge: +-x on the edge, zero in the flat region
    step = _line_images()[2]
    d = tl.local_orientation(_t(step), _t([[40.0, 40.0], [15.0, 15.0]]),
                             win_half=8).numpy()
    assert abs(d[0, 0]) > 0.95 and abs(d[0, 1]) < 0.3
    assert np.allclose(d[1], 0.0, atol=1e-6)


def test_line_support_regions_matches_jax():
    """Masks equal off the bin edges: pixels whose wrapped angle distance
    to a bin centre is within 1e-5 rad of angle_tol are left out."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (72, 88)).astype(np.float32)
    a = np.asarray(jl.line_support_regions(jnp.asarray(img)))
    b = tl.line_support_regions(_t(img)).numpy()
    _, _, mag, angle = tl.gradient_field(_t(img))
    level = angle.double().numpy() + np.pi / 2
    centers = -np.pi + 2 * np.pi * np.arange(8) / 8
    d = np.angle(np.exp(1j * (level[None] - centers[:, None, None])))
    edge = np.abs(np.abs(d) - 0.3927) < 1e-5
    assert a.any() and (~edge).mean() > 0.99
    np.testing.assert_array_equal(b[~edge], a[~edge])


def test_angle_wrap_on_bin_edges():
    """atan2(sin x, cos x) and jnp.angle(exp(1j x)) agree where the wrap
    itself is decided: x exactly at +-pi and at multiples of pi/8."""
    x = np.concatenate([np.array([np.pi, -np.pi, 3 * np.pi, 0.0]),
                        np.arange(-16, 17) * np.pi / 8]).astype(np.float32)
    want = np.asarray(jnp.angle(jnp.exp(1j * jnp.asarray(x))))
    xt = _t(x)
    got = torch.atan2(torch.sin(xt), torch.cos(xt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# -- GIST ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_gist_matches_jax(shape):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, size=shape).astype(np.float32)
    a = np.asarray(jgist.gist_descriptor(jnp.asarray(img)))
    b = tgist.gist_descriptor(_t(img)).numpy()
    assert b.shape == (4 * 8 * 16,)
    _report(err=np.abs(b - a).max())
    np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b), 1.0, atol=1e-4)


# -- panorama ----------------------------------------------------------------------

def test_zone_to_pano_coords_matches_jax():
    """Within 1e-4 px plus 1e-7 relative, across the longitude wrap (yaw
    near 2 pi): near x = 1,000 px 1e-4 is under 2 f32 ulp, and the two
    atan2s differ by an ulp."""
    for yaw in (0.0, 0.7, 2 * np.pi * 11 / 12):
        a = np.asarray(jpan.zone_to_pano_coords(yaw, 600.0, 321, 256, 1024,
                                                256))
        b = tpan.zone_to_pano_coords(yaw, 600.0, 321, 256, 1024, 256,
                                     device="cpu").numpy()
        _report(err_px=np.abs(b - a).max())
        np.testing.assert_allclose(b, a, rtol=1e-7, atol=1e-4)
        assert (b[..., 0] >= 0).all() and (b[..., 0] < 1024).all()


@pytest.fixture(scope="module")
def pano():
    tex = tsynth.multiscale_texture(np.random.default_rng(0), 512)
    return np.ascontiguousarray(np.concatenate([tex[:256], tex[256:]],
                                               axis=1))      # 256 x 1024


def test_panorama_views_and_features_match_jax(pano):
    """Views within 1e-5; keypoints within 0.05 px and descriptors at
    cosine > 0.999, as SIFT parity is held."""
    from metricsfm_tpu.ops.sift import _bilinear as jbil
    coords = tpan.zone_to_pano_coords(1.3, 600.0, 321, 256, 1024, 256,
                                      device="cpu")
    np.testing.assert_allclose(
        ts._bilinear(_t(pano), coords).numpy(),
        np.asarray(jbil(jnp.asarray(pano), jnp.asarray(coords.numpy()))),
        atol=1e-5)
    za = jpan.extract_panorama(jnp.asarray(pano), n_zones=4,
                               cfg=js.SiftConfig(n_octaves=2,
                                                 max_keypoints=256))
    zb = tpan.extract_panorama(_t(pano), n_zones=4,
                               cfg=ts.SiftConfig(n_octaves=2,
                                                 max_keypoints=256))
    assert len(zb) == 4
    for a, b in zip(za, zb):
        assert b["yaw"] == a["yaw"]
        ma, mb = np.asarray(a["mask"]), b["mask"].numpy()
        xa, xb = np.asarray(a["xy"])[ma], b["xy"].numpy()[mb]
        da, db = np.asarray(a["desc"])[ma], b["desc"].numpy()[mb]
        assert len(xa) > 50 and abs(len(xa) - len(xb)) <= 0.02 * len(xa)
        d = np.linalg.norm(xa[:, None] - xb[None], axis=-1)
        near = d.min(axis=1) < 0.05
        assert near.mean() >= 0.98
        cos = np.array([max(float(da[i] @ db[j])
                            for j in np.nonzero(d[i] < 0.05)[0])
                        for i in np.nonzero(near)[0]])
        _report(near_share=near.mean(), cos_share=(cos > 0.999).mean(),
                max_d_px=d.min(axis=1)[near].max())
        assert (cos > 0.999).mean() >= 0.98


# -- PSO -----------------------------------------------------------------------------

def _jax_pso_draws(key, n, d, iters):
    """The uniforms JAX's pso_minimize draws from `key`."""
    k1, k2, k3 = jax.random.split(key, 3)
    r1, r2 = [], []
    k = k3
    for _ in range(iters):
        k, ka, kb = jax.random.split(k, 3)
        r1.append(np.asarray(jax.random.uniform(ka, (n, d))))
        r2.append(np.asarray(jax.random.uniform(kb, (n, d))))
    return {"x0": _t(jax.random.uniform(k1, (n, d))),
            "v0": _t(jax.random.uniform(k2, (n, d))),
            "r1": _t(np.stack(r1)), "r2": _t(np.stack(r2))}


def test_pso_matches_jax_with_its_draws():
    """Best within 1e-5 (the JAX test's objective and swarm)."""
    goal = np.array([1.0, -2.0, 0.5], np.float32)
    lo, hi = np.full(3, -5.0, np.float32), np.full(3, 5.0, np.float32)
    key = jax.random.PRNGKey(0)
    bj, vj = jpso.pso_minimize(
        lambda x: jnp.sum((x - jnp.asarray(goal)) ** 2, axis=-1),
        jnp.asarray(lo), jnp.asarray(hi), key, n_particles=48, iters=80)
    bt, vt = tpso.pso_minimize(
        lambda x: torch.sum((x - _t(goal)) ** 2, dim=-1), _t(lo), _t(hi),
        n_particles=48, iters=80, draws=_jax_pso_draws(key, 48, 3, 80))
    _report(best_err=np.abs(bt.numpy() - np.asarray(bj)).max())
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5)
    np.testing.assert_allclose(float(vt), float(vj), atol=1e-5)
    assert float(vt) < 1e-2


def test_pso_generator_draws():
    """From a torch.Generator, reproducible, on a 6-D quadratic."""
    goal = torch.tensor([0.3, -1.0, 2.0, 0.0, 1.5, -0.7])
    lo, hi = torch.full((6,), -4.0), torch.full((6,), 4.0)
    out = [tpso.pso_minimize(lambda x: torch.sum((x - goal) ** 2, dim=-1),
                             lo, hi, torch.Generator().manual_seed(1),
                             n_particles=64, iters=150) for _ in range(2)]
    assert torch.equal(out[0][0], out[1][0])
    assert float(out[0][1]) < 1e-2


# -- the synthetic BA problem ---------------------------------------------------

def test_synthetic_ba_problem_matches_jax():
    """Every field within 1e-6 of JAX's, at 16 cameras x 512 points."""
    pj = jsynth.synthetic_ba_problem(n_cams=16, n_pts=512, seed=0)
    pt = tsynth.synthetic_ba_problem(n_cams=16, n_pts=512, seed=0,
                                     device="cpu")
    assert set(pt._fields) == set(pj._fields)
    for name, v in pj._asdict().items():
        got = getattr(pt, name).numpy()
        want = np.asarray(v)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert float(pt.pose_mut[0]) == 0.0 and float(pt.pose_mut[1:].min()) == 1
    assert float(pt.intr_mut.abs().max()) == 0.0


def test_synthetic_ba_problem_solves():
    """LM lowers the cost of the perturbed problem (PCG camera solve)."""
    from metricsfm_tpu_torch.ba.lm import LMConfig, solve_lm
    prob = tsynth.synthetic_ba_problem(n_cams=16, n_pts=512, seed=1,
                                       device="cpu")
    _, info = solve_lm(prob, LMConfig(max_iterations=4, cg_iterations=50,
                                      cg_tol=1e-4, cg_forcing=True,
                                      rtol=0.0))
    assert info["final_cost"] < 0.1 * info["initial_cost"]


# -- outlier culling and scene checkpoints -------------------------------------

def _scenes(rng):
    """The same reconstruction as a JAX Scene and a port Scene, with some
    tracks' observations moved 25 px off."""
    from metricsfm_tpu.models import scene as jscene
    from metricsfm_tpu_torch.models import scene as tscene
    sc = make_scene(rng, n_cams=3, n_pts=120, noise_px=0.3)
    n = sc["points"].shape[0]
    kp_xy = {i: sc["obs"][i].astype(np.float32).copy() for i in range(3)}
    moved = rng.choice(n, size=12, replace=False)
    kp_xy[1][moved] += 25.0
    out = []
    for mod in (jscene, tscene):
        s = mod.Scene(3)
        m = s.add_camera_model(mod.CameraModel(f=1000.0, f_hint=1000.0))
        for i in range(3):
            s.register_image(i, sc["poses"][i], m, n)
        for p in range(n):
            s.add_track(sc["points"][p], {i: p for i in range(3)
                                          if sc["vis"][i, p]})
        s.localization_failures = {2: 1}
        out.append(s)
    return out[0], out[1], kp_xy, moved


def test_cull_outliers_matches_jax():
    """The same count and the same tracks marked bad."""
    from metricsfm_tpu.models import accuracy as jacc
    from metricsfm_tpu_torch.models import accuracy as tacc
    sj, st, kp_xy, moved = _scenes(np.random.default_rng(6))
    nj = jacc.cull_outliers(sj, kp_xy, th_rmse_px=4.0)
    nt = tacc.cull_outliers(st, kp_xy, th_rmse_px=4.0, device="cpu")
    assert nt == nj and nt >= len(moved) - 1
    bad_j = {i for i, t in enumerate(sj.tracks) if t.is_bad}
    bad_t = {i for i, t in enumerate(st.tracks) if t.is_bad}
    assert bad_t == bad_j
    assert bad_t <= set(moved.tolist())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scene_checkpoint_round_trip_across_packages(tmp_path, writer):
    """A checkpoint written by one package is read by the other: the same
    poses, models, tracks (bad ones dropped) and failures."""
    from metricsfm_tpu.io import store as jstore
    from metricsfm_tpu_torch.io import store as tstore
    sj, st, _, _ = _scenes(np.random.default_rng(7))
    for s in (sj, st):
        s.mark_bad(3)
    src, (w, r) = (sj, (jstore, tstore)) if writer == "jax" else \
        (st, (tstore, jstore))
    out = str(tmp_path)
    w.write_scene_checkpoint(out, src, "partial")
    assert r.read_scene_checkpoint(out, "missing", {}) is None
    back = r.read_scene_checkpoint(out, "partial", {i: 120 for i in range(3)})
    assert back.registered == src.registered
    for i in src.registered:
        np.testing.assert_array_equal(back.poses[i], src.poses[i])
        assert back.model_of_image[i] == src.model_of_image[i]
    assert [vars(m) for m in back.models] == [vars(m) for m in src.models]
    live = [t for t in src.tracks if not t.is_bad]
    assert len(back.tracks) == len(live) == 119
    for a, b in zip(back.tracks, live):
        np.testing.assert_array_equal(a.xyz, b.xyz)
        assert a.obs == b.obs
    assert back.localization_failures == src.localization_failures
