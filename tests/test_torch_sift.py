"""Parity of the port's SIFT with the JAX package on a rendered view.

Both run on the CPU on the same 640x480 image.  Measured here: every JAX
keypoint has a port keypoint within a few thousandths of a pixel and the
descriptors agree to cosine > 0.9999, so the gates below are tighter than
the 0.5 px / 0.99 first asked for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.ops import sift as js
from metricsfm_tpu.utils import synth as jsynth
from metricsfm_tpu_torch.ops import sift as ts
from metricsfm_tpu_torch.utils import synth as tsynth
from tests.torch_threads import torch_threads  # noqa: F401

MAX_KP = 1024


@pytest.fixture(scope="module")
def views():
    return tsynth.render_scene(seed=0, n_cams=2, width=640, height=480,
                               focal=640.0)["images"]


@pytest.fixture(scope="module")
def both(views):
    a = js.extract(jnp.asarray(views[0]), js.SiftConfig(max_keypoints=MAX_KP))
    b = ts.extract(torch.tensor(views[0]), ts.SiftConfig(max_keypoints=MAX_KP))
    return ({k: np.asarray(v) for k, v in a.items()},
            {k: v.numpy() for k, v in b.items()})


def test_render_scene_matches_jax_package(views):
    """The jax-free renderer draws the same pixels from the same seed."""
    ref = jsynth.render_scene(seed=0, n_cams=2, width=640, height=480,
                              focal=640.0)
    np.testing.assert_array_equal(views, ref["images"])


def test_keypoints_match(both):
    a, b = both
    xa, xb = a["xy"][a["mask"]], b["xy"][b["mask"]]
    assert len(xa) > 300
    assert abs(len(xa) - len(xb)) <= 0.01 * len(xa)
    d = np.linalg.norm(xa[:, None] - xb[None], axis=-1).min(axis=1)
    assert (d < 0.05).mean() >= 0.99, np.percentile(d, [50, 99])


def test_descriptors_match(both):
    a, b = both
    xa, xb = a["xy"][a["mask"]], b["xy"][b["mask"]]
    da, db = a["desc"][a["mask"]], b["desc"][b["mask"]]
    d = np.linalg.norm(xa[:, None] - xb[None], axis=-1)
    near = d.min(axis=1) < 0.05
    # a location may carry two orientation slots: take the best slot there
    cos = np.array([max(float(da[i] @ db[j]) for j in
                        np.nonzero(d[i] < 0.05)[0]) if near[i] else 0.0
                    for i in range(len(xa))])
    assert (cos[near] > 0.999).mean() >= 0.99
    np.testing.assert_allclose(np.linalg.norm(db, axis=1), 1.0, atol=1e-5)


def test_scale_and_angle_match(both):
    a, b = both
    m = a["mask"] & b["mask"] & (np.linalg.norm(a["xy"] - b["xy"], axis=1)
                                 < 1e-3)
    assert m.mean() > 0.5
    np.testing.assert_allclose(b["sigma"][m], a["sigma"][m], rtol=1e-4)
    dang = np.abs((b["angle"][m] - a["angle"][m] + np.pi) % (2 * np.pi)
                  - np.pi)
    assert (dang < 1e-3).mean() >= 0.99


def test_image_batch_equals_single(views):
    """The leading image axis replaces jit(vmap): a batch of two equals two
    single calls, up to the summation order the convolution picks for the
    batch size (sub-millipixel after the quadratic refinement)."""
    cfg = ts.SiftConfig(max_keypoints=256, n_octaves=3)
    imgs = torch.tensor(views[:, :256, :320])
    batch = ts.extract(imgs, cfg)
    for i in range(2):
        one = ts.extract(imgs[i], cfg)
        assert torch.equal(batch["mask"][i], one["mask"])
        torch.testing.assert_close(batch["xy"][i], one["xy"], atol=2e-3,
                                   rtol=0)
        torch.testing.assert_close(batch["desc"][i], one["desc"], atol=2e-3,
                                   rtol=0)
