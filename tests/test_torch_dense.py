"""The port's dense driver and `cli dense` against the JAX package, on the
CPU, on the two-view scene of tests/test_sgm_dense.py (a rectified rig:
R = I, baseline along x, so rectification is the identity and the
ground-truth disparity holds)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.config import DenseOptions as JDenseOptions
from metricsfm_tpu.models import dense as jdense
from metricsfm_tpu_torch import cli
from metricsfm_tpu_torch.config import DenseOptions
from metricsfm_tpu_torch.models import dense
from metricsfm_tpu_torch.utils import synth
from tests.torch_threads import torch_threads  # noqa: F401

H, W, FOCAL, BASELINE, DISP = 64, 96, 80.0, 0.5, 32


@pytest.fixture(scope="module")
def scene():
    return synth.stereo_pair(np.random.default_rng(0), H=H, W=W,
                             disp_bg=6.0, disp_fg=16.0)


def _write_fold(path, left, right, png=False):
    synth.write_stereo_sure(os.path.join(path, "sfm_sure.txt"),
                            ["a.png", "b.png"], W, H, FOCAL, BASELINE)
    if png:
        from PIL import Image
        for name, img in (("a.png", left), ("b.png", right)):
            Image.fromarray((img * 255).round().astype(np.uint8)).save(
                os.path.join(path, name))
    return {"a.png": left, "b.png": right}


def _gates(disp, valid, disp_gt):
    """The JAX test's accuracy gates (test_sgm_dense.py:159-166), away from
    the left band and the block edges."""
    region = np.zeros_like(valid)
    region[4:-4, 40:-8] = True
    sel = valid & region
    assert sel.mean() > 0.3, f"too few valid pixels: {sel.mean()}"
    err = np.abs(disp - disp_gt)[sel]
    assert np.median(err) < 1.0, f"median disparity error {np.median(err)}"
    assert (err < 2).mean() > 0.8


def test_read_sure_and_rectify_match_jax(tmp_path, rng):
    path = str(tmp_path / "sfm_sure.txt")
    synth.write_stereo_sure(path, ["a.png", "b.png"], W, H, FOCAL, BASELINE)
    mine, ref = dense.read_sure_pose_file(path), jdense.read_sure_pose_file(path)
    assert [p.name for p in mine] == ["a.png", "b.png"]
    for a, b in zip(mine, ref):
        assert (a.name, a.w, a.h) == (b.name, b.w, b.h)
        for k in ("K", "R", "t"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    Rn, Kn, H1, H2, bl = dense.rectify_pair(mine[0].K, mine[0].R, mine[0].t,
                                            mine[1].K, mine[1].R, mine[1].t)
    np.testing.assert_allclose(H1, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(H2, np.eye(3), atol=1e-12)
    assert bl == BASELINE
    # a general pair: the same numpy as the JAX package
    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
    R2 = np.linalg.qr(rng.normal(size=(3, 3)) * 0.05 + np.eye(3))[0]
    args = (K, np.eye(3), np.zeros(3), K * 1.01, R2, np.array([-1.0, .1, .05]))
    for a, b in zip(dense.rectify_pair(*args), jdense.rectify_pair(*args)):
        np.testing.assert_array_equal(a, b)


def test_warp_homography_matches_jax(rng):
    img = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    Hm = np.array([[0.98, 0.03, 1.7], [-0.02, 1.01, -2.3], [1e-4, -2e-4, 1.0]])
    got = dense.warp_homography(torch.tensor(img), Hm).numpy()
    want = np.asarray(jdense.warp_homography(jnp.asarray(img), Hm))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_driver_matches_jax_driver(tmp_path, scene):
    """DenseReconstruction.run on the CPU against the JAX driver (whose
    CPU stereo branch takes a subpixel right disparity, ROADMAP 3a): depth
    equal where both are valid, the valid masks equal on all but 0.29 %
    of the pixels (18 of 6,144), and the ground-truth gates met."""
    left, right, disp_gt = scene
    mine_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    mine_dir.mkdir()
    jax_dir.mkdir()
    imgs = _write_fold(str(mine_dir), left, right)
    _write_fold(str(jax_dir), left, right)
    clouds = dense.DenseReconstruction(DenseOptions(disp_size=DISP),
                                       device="cpu").run(
        str(mine_dir), image_loader=lambda n: imgs[n])
    jclouds = jdense.DenseReconstruction(JDenseOptions(disp_size=DISP)).run(
        str(jax_dir), image_loader=lambda n: imgs[n])
    assert len(clouds) == len(jclouds) == 1 and len(clouds[0]) > 200
    depth = np.load(mine_dir / "dense" / "depth_0.npy")
    jdepth = np.load(jax_dir / "dense" / "depth_0.npy")
    both = (depth > 0) & (jdepth > 0)
    np.testing.assert_allclose(depth[both], jdepth[both], rtol=1e-6, atol=0)
    differ = (depth > 0) != (jdepth > 0)
    assert differ.sum() == 18, differ.sum()
    with open(mine_dir / "dense" / "pose_rect_0.txt") as f:
        mine_pose = f.read()
    with open(jax_dir / "dense" / "pose_rect_0.txt") as f:
        assert f.read() == mine_pose
    valid = depth > 0
    disp = np.where(valid, 20.0 * FOCAL * BASELINE / np.maximum(depth, 1e-6),
                    -1.0)
    _gates(disp, valid, disp_gt)


def test_cli_dense_writes_its_files(tmp_path, scene, capsys):
    left, right, _ = scene
    _write_fold(str(tmp_path), left, right, png=True)
    clouds = cli.main(["dense", str(tmp_path), "--disp", str(DISP),
                       "--device", "cpu"])
    assert len(clouds) == 1 and len(clouds[0]) > 200
    for f in ("depth_0.npy", "pose_rect_0.txt", "dense_cloud.txt"):
        assert os.path.exists(tmp_path / "dense" / f), f
    with open(tmp_path / "dense" / "dense_cloud.txt") as f:
        assert sum(1 for _ in f) == len(clouds[0])
    out = capsys.readouterr().out
    assert "-- stage times --" in out and "dense/stereo" in out


def test_cli_dense_refuses(tmp_path, scene):
    """--device cuda without a card raises; so does a stereo method other
    than sgm and elas (the CLI's choices refuse it before
    DenseReconstruction does)."""
    _write_fold(str(tmp_path), *scene[:2], png=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["dense", str(tmp_path), "--device", "cuda"])
    with pytest.raises(ValueError, match="census"):
        dense.DenseReconstruction(DenseOptions(method="census"),
                                  device="cpu")
    with pytest.raises(SystemExit):
        cli.main(["dense", str(tmp_path), "--method", "census",
                  "--device", "cpu"])
