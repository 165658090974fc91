"""The port's default `cli sfm` above 12 images (web mode: BoW candidates),
`cli sfm --debug-matches` and its match renders, and `cli calib`, against
the JAX package where both run.

The renders are pixel-equal to the JAX package's at the working
resolution; with resize on, the port draws the keypoints on the native
pixels (the JAX package draws working-resolution coordinates unscaled).
"""
import os
import types

import numpy as np
import pytest
from PIL import Image

from metricsfm_tpu import cli as jcli
from metricsfm_tpu.io import exports as jexports
from metricsfm_tpu.models import match_graph as jmg
from metricsfm_tpu_torch import cli
from metricsfm_tpu_torch.io import exports
from metricsfm_tpu_torch.models import match_graph as tmg
from metricsfm_tpu_torch.models.incremental import ImageFeatures, PairMatches
from metricsfm_tpu_torch.ops import np_geom
from metricsfm_tpu_torch.utils import synth
from tests.torch_threads import torch_threads  # noqa: F401

N_VIEWS = 14


@pytest.fixture(scope="module")
def web_run(tmp_path_factory):
    """`cli sfm` with the user's defaults (web mode, no --matching) on 14
    rendered 400x300 views, with --debug-matches.  (At 320x240 SIFT finds
    ~230 keypoints a view, under the preset's min_keypoints_for_words of
    300, so no view would get words and no pair would be a candidate;
    400x300 with a budget of 768 gives a 625-word vocabulary and all 91
    pairs as candidates.)"""
    fold = str(tmp_path_factory.mktemp("torch_web14"))
    gt = synth.render_scene(seed=0, n_cams=N_VIEWS, width=400, height=300,
                            focal=440.0, arc_step=0.04)
    synth.write_scene_images(fold, gt)
    scenes = cli.main(["sfm", fold, "--max-kp", "768", "--debug-matches",
                       "--device", "cpu"])
    return fold, gt, scenes


def test_web_default_above_12_images_takes_bow(web_run):
    fold, gt, scenes = web_run
    out = os.path.join(fold, "mtpu_db")
    assert os.path.exists(os.path.join(out, "voctree.npz"))
    assert all(os.path.exists(os.path.join(out, f"{i}_words.npz"))
               for i in range(N_VIEWS))
    assert scenes
    best = max(scenes, key=lambda s: len(s.registered))
    assert len(best.registered) >= 12
    est = np.stack([np_geom.camera_center(best.poses[i])
                    for i in best.registered])
    assert synth.ate_vs_gt(est, gt["centers"][best.registered]) < 0.05


def test_debug_matches_writes_renders(web_run):
    fold = web_run[0]
    rdir = os.path.join(fold, "mtpu_db", "match_renders")
    names = sorted(os.listdir(rdir))
    assert names and all(n.startswith("match_") and n.endswith(".png")
                         for n in names)
    with Image.open(os.path.join(rdir, names[0])) as im:
        assert im.size == (800, 300)


def _pair_fixture(rng, W=120, H=90, K=40, n=25):
    img_i = rng.random((H, W)).astype(np.float32)
    img_j = rng.random((H, W)).astype(np.float32)
    xy_i = (rng.random((K, 2)) * [W - 20, H - 20] - [W / 2 - 10, H / 2 - 10]
            ).astype(np.float32)
    xy_j = (rng.random((K, 2)) * [W - 20, H - 20] - [W / 2 - 10, H / 2 - 10]
            ).astype(np.float32)
    kp_i = rng.choice(K, n, replace=False)
    kp_j = rng.choice(K, n, replace=False)
    return img_i, img_j, xy_i, xy_j, kp_i, kp_j


@pytest.mark.parametrize("good", [False, True])
def test_write_match_visualization_matches_jax(tmp_path, good):
    rng = np.random.default_rng(0)
    img_i, img_j, xy_i, xy_j, kp_i, kp_j = _pair_fixture(rng)
    g = rng.random(len(kp_i)) > 0.5 if good else None
    a = exports.write_match_visualization(str(tmp_path / "t.png"), img_i,
                                          img_j, xy_i, xy_j, kp_i, kp_j,
                                          good=g, max_lines=12)
    b = jexports.write_match_visualization(str(tmp_path / "j.png"), img_i,
                                           img_j, xy_i, xy_j, kp_i, kp_j,
                                           good=g, max_lines=12)
    with Image.open(a) as ta, Image.open(b) as jb:
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(jb))


def _render_db(tmp_path, native, work):
    """Two black native-size images and a database stub whose features sit
    at the working resolution `work` (W, H)."""
    paths = []
    for k in range(2):
        p = str(tmp_path / f"im{k}.png")
        Image.new("L", native).save(p)
        paths.append(p)
    rng = np.random.default_rng(1)
    W, H = work
    feats = {k: ImageFeatures(
        xy=(rng.random((8, 2)) * [W - 8, H - 8] - [W / 2 - 4, H / 2 - 4]
            ).astype(np.float32),
        desc=None, mask=np.ones(8, bool), width=W, height=H)
        for k in range(2)}
    db = types.SimpleNamespace(image_paths=paths, n_images=2,
                               features=feats.__getitem__)
    m = {(0, 1): PairMatches(kp_i=np.arange(8), kp_j=np.arange(8)[::-1].copy())}
    return db, feats, m


def test_render_pair_matches_matches_jax_without_resize(tmp_path):
    db, feats, m = _render_db(tmp_path, (160, 120), (160, 120))
    a = tmg.render_pair_matches(db, m, str(tmp_path / "t"), features=feats)
    b = jmg.render_pair_matches(db, m, str(tmp_path / "j"), features=feats)
    assert [os.path.basename(p) for p in a] == ["match_0000_0001.png"]
    with Image.open(a[0]) as ta, Image.open(b[0]) as jb:
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(jb))


def test_render_pair_matches_scales_to_native_pixels(tmp_path):
    """Features found at half resolution are drawn on the native pixels:
    the render equals the JAX drawing of the coordinates scaled by 2, and
    differs from the JAX package's render_pair_matches, which draws them
    unscaled (its fault 3d-i)."""
    db, feats, m = _render_db(tmp_path, (200, 160), (100, 80))
    path = tmg.render_pair_matches(db, m, str(tmp_path / "t"),
                                   features=feats)[0]
    black = np.zeros((160, 200), np.float32)
    want = jexports.write_match_visualization(
        str(tmp_path / "want.png"), black, black, feats[0].xy * 2.0,
        feats[1].xy * 2.0, m[(0, 1)].kp_i, m[(0, 1)].kp_j)
    unscaled = jmg.render_pair_matches(db, m, str(tmp_path / "j"),
                                       features=feats)[0]
    with Image.open(path) as a, Image.open(want) as b, \
            Image.open(unscaled) as c:
        got = np.asarray(a)
        np.testing.assert_array_equal(got, np.asarray(b))
        assert (got != np.asarray(c)).any()


def _video(path, n=23, size=(64, 48)):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, size)
    rng = np.random.default_rng(0)
    for i in range(n):
        frame = np.full((size[1], size[0], 3), 10 * i % 255, np.uint8)
        frame[rng.integers(0, size[1], 50), rng.integers(0, size[0], 50)] = 255
        vw.write(frame)
    vw.release()
    assert os.path.getsize(path) > 0


def test_cli_calib_matches_jax(tmp_path, monkeypatch):
    """`cli calib` writes every frame_step-th frame as the JAX package does
    (byte-equal JPEGs), then runs `sfm` in web mode on them with no --out."""
    video = str(tmp_path / "clip.avi")
    _video(video)
    calls = []

    def record(args):
        calls.append((args.fold, args.mode, args.out))

    monkeypatch.setattr(jcli, "cmd_sfm", record)
    monkeypatch.setattr(cli, "cmd_sfm", record)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.main(["calib", video, jout, "--frame-step", "4"])
    cli.main(["calib", video, tout, "--frame-step", "4", "--device", "cpu"])
    names = sorted(os.listdir(tout))
    assert names == sorted(os.listdir(jout)) == [f"{k:06d}.jpg"
                                                 for k in range(6)]
    for n in names:
        with open(os.path.join(tout, n), "rb") as a, \
                open(os.path.join(jout, n), "rb") as b:
            assert a.read() == b.read()
    assert calls == [(jout, "web", None), (tout, "web", None)]


def test_cli_calib_needs_cv2(tmp_path, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="calib requires cv2"):
        cli.main(["calib", str(tmp_path / "v.avi"), str(tmp_path / "o"),
                  "--device", "cpu"])
