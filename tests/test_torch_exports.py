"""The exports the street path added to the PyTorch port (io/exports:
write_qin, write_accuracy, undistort_image, write_undistorted_images,
write_track_overlay_image) against the JAX package's writers on the same
scene and images."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from metricsfm_tpu.io import exports as jex
from metricsfm_tpu.models.scene import CameraModel as JCam
from metricsfm_tpu.models.scene import Scene as JScene
from metricsfm_tpu_torch.io import exports as tex
from metricsfm_tpu_torch.models.scene import Scene
from tests.torch_threads import torch_threads  # noqa: F401


def _scenes(tmp_path, k1=-0.1, k2=0.02):
    """One JAX scene of 5 cameras (rotations up to ~pi, centres ~100 m
    out) and the port's copy of it through the shared checkpoint."""
    rng = np.random.default_rng(3)
    s = JScene(5)
    mi = s.add_camera_model(JCam(f=812.5, k1=k1, k2=k2))
    for i in range(5):
        aa = rng.normal(0, 1.0, 3)
        s.register_image(i, np.concatenate([aa, rng.uniform(-100, 100, 3)]),
                         mi, 10)
    path = str(tmp_path / "scene.npz")
    s.save(path)
    return s, Scene.load(path)


def _rows(path):
    with open(path) as f:
        return f.read().split("\n")


def test_write_qin_matches_jax(tmp_path):
    sj, st = _scenes(tmp_path)
    names = {i: f"{i:06d}" for i in range(5)}
    pj, pt = str(tmp_path / "j.qin"), str(tmp_path / "t.qin")
    jex.write_qin(pj, sj, names, cols=1280, rows=720)
    tex.write_qin(pt, st, names, cols=1280, rows=720)
    rj, rt = _rows(pj), _rows(pt)
    assert rt[:2] == rj[:2] and len(rt) == len(rj) == 7
    for a, b in zip(rj[2:], rt[2:]):
        a, b = a.split(), b.split()
        assert a[0] == b[0]
        np.testing.assert_allclose(np.array(b[1:], float),
                                   np.array(a[1:], float), atol=1e-6)


def test_write_accuracy_and_overlay_match_jax(tmp_path):
    for mod, name in ((jex, "j"), (tex, "t")):
        mod.write_accuracy(str(tmp_path / f"{name}.txt"), 0.3298804,
                           0.1403538, 1183)
    assert _rows(str(tmp_path / "j.txt")) == _rows(str(tmp_path / "t.txt"))
    rng = np.random.default_rng(4)
    est = np.cumsum(rng.normal(0, 1, (30, 3)), 0)
    gps = est + rng.normal(0, 0.2, est.shape)
    for mod, name in ((jex, "j"), (tex, "t")):
        mod.write_track_overlay_image(str(tmp_path / f"{name}.png"), est, gps)
    a = np.asarray(Image.open(tmp_path / "j.png"))
    b = np.asarray(Image.open(tmp_path / "t.png"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [0, 3])
def test_undistort_image_matches_jax(channels):
    """A seeded 48x64 image, k1 = -0.1, k2 = 0.02: within 1e-5."""
    rng = np.random.default_rng(5)
    shape = (48, 64, channels) if channels else (48, 64)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    f, k1, k2 = 55.0, -0.1, 0.02
    want = np.asarray(jex.undistort_image(img, f, k1, k2))
    got = tex.undistort_image(img, f, k1, k2, device="cpu")
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # a tensor stays on its own device
    same = tex.undistort_image(torch.from_numpy(img), f, k1, k2)
    assert torch.equal(same, got)


def test_write_undistorted_images_matches_jax(tmp_path):
    """PNG in, PNG out: uint8 within 1 of the JAX package's files; a
    missing file and an image with no path are skipped."""
    sj, st = _scenes(tmp_path)
    for m in (sj.models[0], st.models[0]):
        m.f = 60.0
    rng = np.random.default_rng(6)
    src = tmp_path / "src"
    src.mkdir()
    paths = {}
    for i in (0, 1, 3):
        arr = rng.integers(0, 256, (48, 64, 3) if i != 3 else (48, 64),
                           np.uint8)
        p = str(src / f"{i:06d}.png")
        Image.fromarray(arr).save(p)
        paths[i] = p
    paths[2] = str(src / "missing.png")
    wj = jex.write_undistorted_images(str(tmp_path / "j"), sj, paths)
    wt = tex.write_undistorted_images(str(tmp_path / "t"), st, paths,
                                      device="cpu")
    assert [os.path.basename(p) for p in wt] == \
        [os.path.basename(p) for p in wj] == \
        ["000000.png", "000001.png", "000003.png"]
    for a, b in zip(wj, wt):
        x = np.asarray(Image.open(a)).astype(int)
        y = np.asarray(Image.open(b)).astype(int)
        assert x.shape == y.shape and np.abs(x - y).max() <= 1
    # k1 = k2 = 0 still resamples every pixel through the warp (the last
    # row and column are read at H - 1.001 and W - 1.001, as in the JAX package)
    ramp = np.arange(20, dtype=np.float32).reshape(4, 5)
    ident = tex.undistort_image(ramp, 60.0, 0.0, 0.0, device="cpu")
    np.testing.assert_allclose(ident.numpy(),
                               np.asarray(jex.undistort_image(ramp, 60.0,
                                                              0.0, 0.0)),
                               atol=1e-5)
    np.testing.assert_allclose(ident.numpy()[:3, :4], ramp[:3, :4],
                               atol=1e-5)
