"""`cli sfm` -> `cli dense` chained, on the CPU: the port's sparse
reconstruction of rendered views feeds dense stereo through the
`sfm_sure.txt` it writes, so the rectification warps see real, estimated
poses (not the identity of tests/test_torch_dense.py).

The port's `DenseReconstruction` and the JAX package's run on that same
pose file (JAX's SGM takes its XLA branch on the CPU, no Pallas kernel):
rectified poses within 1e-5; depths equal within 1e-5 relative on at
least 99 % of the pixels both call valid; and the port's points, aligned
to the truth by Umeyama on the camera centres, on the rendered planes
(`chip_smoke.sfm_to_truth` and `chain_gates`, the gate of
`chip_smoke.py` phase 14e).
"""
import os
import shutil

import numpy as np
import pytest

from metricsfm_tpu.config import DenseOptions as JDenseOptions
from metricsfm_tpu.models import dense as jdense
import chip_smoke
from metricsfm_tpu_torch import cli
from metricsfm_tpu_torch.config import DenseOptions
from metricsfm_tpu_torch.models import dense
from metricsfm_tpu_torch.utils import synth
from tests.torch_threads import torch_threads  # noqa: F401

N_VIEWS, W, H, DISP = 6, 400, 300, 64


@pytest.fixture(scope="module")
def chained(tmp_path_factory):
    """The rendered views, `cli sfm` on them (the port, on the CPU), and
    both packages' dense drivers on the sfm_sure.txt it wrote, each in a
    folder of its own holding the views."""
    root = tmp_path_factory.mktemp("chain")
    gt = synth.render_scene(seed=0, n_cams=N_VIEWS, width=W, height=H,
                            focal=1.1 * W)
    sfm = str(root / "sfm")
    synth.write_scene_images(sfm, gt)
    scenes = cli.main(["sfm", sfm, "--no-resize", "--max-kp", "2048",
                       "--device", "cpu"])
    sure = os.path.join(sfm, "mtpu_db", "model_0", "sfm_sure.txt")
    out = {"gt": gt, "scenes": scenes, "sure": sure}
    for name in ("port", "jax"):
        fold = str(root / name)
        shutil.copytree(sfm, fold, ignore=lambda d, names: [
            n for n in names if not n.endswith(".png")])
        out[name] = fold
    dense.DenseReconstruction(DenseOptions(disp_size=DISP),
                              device="cpu").run(out["port"], pose_file=sure)
    jdense.DenseReconstruction(JDenseOptions(disp_size=DISP)).run(
        out["jax"], pose_file=sure)
    return out


def test_sfm_registers_every_view(chained):
    best = max(chained["scenes"], key=lambda s: len(s.registered))
    assert best.registered == list(range(N_VIEWS))
    cams = dense.read_sure_pose_file(chained["sure"])
    assert [c.name for c in cams] == [f"view_{i:03d}.png"
                                      for i in range(N_VIEWS)]


@pytest.mark.parametrize("pair", range(N_VIEWS - 1))
def test_rectified_poses_match_jax(chained, pair):
    got = np.loadtxt(os.path.join(chained["port"], "dense",
                                  f"pose_rect_{pair}.txt"))
    want = np.loadtxt(os.path.join(chained["jax"], "dense",
                                   f"pose_rect_{pair}.txt"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pair", range(N_VIEWS - 1))
def test_depth_maps_match_jax(chained, pair):
    """Depth equal within 1e-5 relative on >= 99 % of the pixels both
    packages call valid (their SGM branches differ in validity on a few
    pixels, ROADMAP 3a, and their warps within 1e-5 of intensity), the
    valid masks equal on >= 99 % of all pixels."""
    got = np.load(os.path.join(chained["port"], "dense", f"depth_{pair}.npy"))
    want = np.load(os.path.join(chained["jax"], "dense", f"depth_{pair}.npy"))
    both = (got > 0) & (want > 0)
    close = np.abs(got[both] - want[both]) <= 1e-5 * want[both]
    assert both.mean() > 0.3
    assert close.mean() >= 0.99, close.mean()
    assert ((got > 0) == (want > 0)).mean() >= 0.99


def test_dense_points_lie_on_the_rendered_planes(chained):
    """Every pair's valid share > 0.3 and the port's points on the planes
    once the SfM frame is aligned to the truth (chip_smoke.chain_gates)."""
    opts = DenseOptions()
    cams, pairs = chip_smoke.chain_points(chained["port"], chained["sure"],
                                          opts.depth_scale,
                                          opts.depth_clamp, stride=2)
    align = chip_smoke.sfm_to_truth(cams, chained["gt"]["centers"])
    stats = chip_smoke.chain_gates(pairs, align, "chained SGM (CPU)")
    assert stats["pairs"] == N_VIEWS - 1
    lo, hi = stats["disparity_px"]
    assert 0 < lo <= hi < DISP
