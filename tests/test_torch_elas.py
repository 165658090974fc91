"""ELAS on the PyTorch port against the JAX package, on the CPU: each step
on the same inputs, `stereo_elas` for both presets, the JAX test's own
oracles (tests/test_elas.py) on the port, and `cli dense --method elas`
against the JAX DenseReconstruction."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.config import DenseOptions as JDenseOptions
from metricsfm_tpu.models import dense as jdense
from metricsfm_tpu.ops import elas as jelas
from metricsfm_tpu_torch import cli
from metricsfm_tpu_torch.ops import elas
from tests.test_sgm_dense import textured_scene
from tests.test_torch_dense import _gates, _write_fold
from tests.torch_threads import torch_threads  # noqa: F401

PRESETS = {"robotics": (jelas.ElasParams(), elas.ElasParams()),
           "middlebury": (jelas.middlebury_params(), elas.middlebury_params())}


@pytest.fixture(scope="module")
def scene():
    left, right, disp = textured_scene(np.random.default_rng(1))
    return left.astype(np.float32), right.astype(np.float32), disp


@pytest.mark.parametrize("src,dst", [((2, 3), (3, 5)), ((3, 3), (5, 6)),
                                     ((10, 13), (20, 26)),
                                     ((20, 26), (39, 52)),
                                     ((13, 21), (64, 96))])
def test_resize_matches_jax(rng, src, dst):
    """Bilinear enlargement at the ragged shapes of the prior pyramid
    against jax.image.resize: within 1e-5 on values in [0, 1) (float32
    rounding of the same weights in another order)."""
    x = rng.uniform(0, 1, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = elas.resize_bilinear(torch.tensor(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sobel_descriptor_matches_jax(rng):
    """Within 1e-4 (responses up to 127; convolution sums in another
    order); a constant image gives a zero descriptor."""
    img = rng.uniform(0, 1, (40, 56)).astype(np.float32)
    got = elas.sobel_descriptor(torch.tensor(img))
    assert got.shape == (40, 56, 16) and got.dtype == torch.float32
    want = np.asarray(jelas.sobel_descriptor(jnp.asarray(img)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    flat = elas.sobel_descriptor(torch.full((40, 56), 0.5))
    np.testing.assert_allclose(flat.numpy()[2:-2, 2:-2], 0.0, atol=1e-4)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_support_matches_and_prior_match_jax(scene, preset):
    """Support disparities and masks equal; the filled prior within
    1e-4."""
    jp, tp = PRESETS[preset]
    left, right, _ = scene
    jl, jr = (jelas.sobel_descriptor(jnp.asarray(x)) for x in (left, right))
    tl, tr = (torch.tensor(np.asarray(x)) for x in (jl, jr))
    jd, jv = jelas.support_matches(jl, jr, 32, jp)
    td, tv = elas.support_matches(tl, tr, 32, tp)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tv.sum() > 50
    want = np.asarray(jelas.fill_prior(jd, jv))
    got = elas.fill_prior(td, tv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fill_prior_matches_jax_on_ragged_grids(rng):
    """Random sparse supports on odd grids (every pyramid level ragged):
    within 1e-4 of the JAX fill, and the masked 2x2 pool likewise."""
    for gy, gx in ((23, 31), (9, 14)):
        d = rng.uniform(0, 40, (gy, gx)).astype(np.float32)
        v = rng.uniform(size=(gy, gx)) < 0.3
        want = np.asarray(jelas.fill_prior(jnp.asarray(d), jnp.asarray(v)))
        got = elas.fill_prior(torch.tensor(d), torch.tensor(v)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        jm, jmv = jelas._masked_downsample(jnp.asarray(d), jnp.asarray(v))
        tm, tmv = elas._masked_downsample(torch.tensor(d), torch.tensor(v))
        np.testing.assert_array_equal(tmv.numpy(), np.asarray(jmv))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_stereo_elas_matches_jax(scene, preset):
    """The whole pipeline on the 96x160 / D 32 scene: valid masks agree on
    >= 0.999 of the pixels and disparity within 1e-3 px where both are
    valid.  Measured: masks equal, disparity within 2.2e-6 px (both
    presets)."""
    jp, tp = PRESETS[preset]
    left, right, _ = scene
    jd, jv = jelas.stereo_elas(jnp.asarray(left), jnp.asarray(right),
                               max_disp=32, params=jp)
    jd, jv = np.asarray(jd), np.asarray(jv)
    d, v = elas.stereo_elas(torch.tensor(left), torch.tensor(right),
                            max_disp=32, params=tp)
    d, v = d.numpy(), v.numpy()
    assert d.dtype == np.float32 and v.dtype == bool
    assert (v == jv).mean() >= 0.999
    both = v & jv
    np.testing.assert_allclose(d[both], jd[both], atol=1e-3, rtol=0)
    assert (d[~v] == -1.0).all()


def test_jax_oracles_hold_on_the_port(scene):
    """tests/test_elas.py's gates on the port: support points agree with
    the ground truth, the prior fills a plane, stereo_elas recovers the
    disparity, and MIDDLEBURY is at least as dense as ROBOTICS."""
    left, right, disp_gt = scene
    L, R = torch.tensor(left), torch.tensor(right)
    p = elas.ElasParams()
    sup_d, sup_v = elas.support_matches(elas.sobel_descriptor(L),
                                        elas.sobel_descriptor(R), 32, p)
    s = p.candidate_stepsize
    sel = sup_v.numpy().copy()
    sel[:, : 32 // s + 1] = False
    assert sel.sum() > 50
    err = np.abs(sup_d.numpy() - disp_gt[s // 2::s, s // 2::s])[sel]
    assert np.median(err) < 1.0

    yy, xx = np.mgrid[0:24, 0:32]
    plane = (4.0 + 0.2 * xx + 0.1 * yy).astype(np.float32)
    valid = (yy % 4 == 0) & (xx % 4 == 0)
    filled = elas.fill_prior(torch.tensor(plane * valid),
                             torch.tensor(valid)).numpy()
    assert np.median(np.abs(filled - plane)[2:-2, 2:-2]) < 0.5

    disp, v_rob = elas.stereo_elas(L, R, max_disp=32)
    region = np.zeros(disp.shape, bool)
    region[4:-4, 40:-8] = True
    sel = v_rob.numpy() & region
    assert sel.mean() > 0.3
    err = np.abs(disp.numpy() - disp_gt)[sel]
    assert np.median(err) < 1.0
    assert (err < 2).mean() > 0.9
    _, v_mid = elas.stereo_elas(L, R, max_disp=32,
                                params=elas.middlebury_params())
    assert v_mid.float().mean() >= v_rob.float().mean()


def test_cli_dense_elas_matches_jax_reconstruction(tmp_path):
    """`cli dense --method elas` on a 64x96 PNG pair against the JAX
    DenseReconstruction on the same pair: point counts within 1 %, the SGM
    test's ground-truth gates met."""
    from metricsfm_tpu_torch.utils import synth
    from tests.test_torch_dense import BASELINE, DISP, FOCAL, H, W
    left, right, disp_gt = synth.stereo_pair(np.random.default_rng(0), H=H,
                                             W=W, disp_bg=6.0, disp_fg=16.0)
    mine, ref = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    ref.mkdir()
    _write_fold(str(mine), left, right, png=True)
    _write_fold(str(ref), left, right, png=True)
    clouds = cli.main(["dense", str(mine), "--disp", str(DISP), "--method",
                       "elas", "--device", "cpu"])
    jclouds = jdense.DenseReconstruction(
        JDenseOptions(disp_size=DISP, method="elas")).run(str(ref))
    n, jn = len(clouds[0]), len(jclouds[0])
    assert n > 200 and abs(n - jn) <= 0.01 * jn, (n, jn)
    for f in ("depth_0.npy", "pose_rect_0.txt", "dense_cloud.txt"):
        assert os.path.exists(mine / "dense" / f), f
    depth = np.load(mine / "dense" / "depth_0.npy")
    valid = depth > 0
    disp = np.where(valid, 20.0 * FOCAL * BASELINE / np.maximum(depth, 1e-6),
                    -1.0)
    _gates(disp, valid, disp_gt)
