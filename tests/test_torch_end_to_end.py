"""End to end on the PyTorch port: images -> SIFT -> matching ->
reconstruction -> exports, on the CPU.

The scene and gates are tests/test_end_to_end.py's: three textured planes
viewed from 6 cameras on an arc, 640x480, 2048 keypoints, WEB preset with
exhaustive matching.  The port also opens feature stores the JAX package
wrote, and the JAX package opens the port's.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

from metricsfm_tpu_torch import cli
from metricsfm_tpu_torch.config import PRESETS
from metricsfm_tpu_torch.models import accuracy
from metricsfm_tpu_torch.models.database import Database
from metricsfm_tpu_torch.models.incremental import IncrementalSfM
from metricsfm_tpu_torch.models.match_graph import build_match_graph
from metricsfm_tpu_torch.ops import np_geom
from metricsfm_tpu_torch.utils import synth
from tests.torch_threads import torch_threads  # noqa: F401

N_CAMS = 6
FOCAL = 640.0


def _cfg():
    cfg = PRESETS["web"]()
    return dataclasses.replace(
        cfg,
        database=dataclasses.replace(cfg.database, resize=False,
                                     max_keypoints=2048),
        graph=dataclasses.replace(cfg.graph, matching_type="all"))


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    fold = str(tmp_path_factory.mktemp("torch_e2e_images"))
    scene = synth.render_scene(seed=0, n_cams=N_CAMS, width=640, height=480,
                               focal=FOCAL)
    synth.write_scene_images(fold, scene)
    return fold, scene


@pytest.fixture(scope="module")
def reconstruction(rendered):
    """The cmd_sfm composition: Database -> build_match_graph ->
    IncrementalSfM, on the CPU."""
    fold, gt = rendered
    cfg = _cfg()
    db = Database(fold, cfg.database, device="cpu")
    db.feature_extraction()
    matches = build_match_graph(db, cfg)
    feats = {i: db.features(i) for i in range(db.n_images)}
    scenes = IncrementalSfM(feats, matches, cfg, device="cpu").run()
    return db, feats, matches, scenes, gt


def _best(scenes):
    assert scenes, "no model reconstructed"
    return max(scenes, key=lambda s: len(s.registered))


def test_matching_recall_on_real_pixels(reconstruction):
    _, _, matches, _, _ = reconstruction
    for i in range(N_CAMS - 1):
        m = matches.get((i, i + 1))
        assert m is not None and len(m.kp_i) > 200, \
            f"pair ({i},{i + 1}): {0 if m is None else len(m.kp_i)} matches"


def test_full_registration_and_ate(reconstruction):
    _, _, _, scenes, gt = reconstruction
    scene = _best(scenes)
    assert len(scene.registered) == N_CAMS
    assert scene.n_points() > 400
    est = np.stack([np_geom.camera_center(scene.poses[i])
                    for i in scene.registered])
    ate = synth.ate_vs_gt(est, gt["centers"][scene.registered])
    assert ate < 0.02, f"ATE {ate:.4f} of trajectory extent"


def test_focal_selfcalibration(reconstruction):
    _, _, _, scenes, _ = reconstruction
    for m in _best(scenes).models:
        assert abs(m.f - FOCAL) / FOCAL < 0.03, f"focal {m.f} vs {FOCAL}"


def test_reprojection_error(reconstruction):
    _, feats, _, scenes, _ = reconstruction
    scene = _best(scenes)
    stats = accuracy.assess(scene, {i: feats[i].xy for i in scene.registered},
                            device="cpu")
    assert stats["n_obs"] > 1500
    assert stats["avg_err"] < 1.0, f"avg reproj {stats['avg_err']:.3f}px"


def test_cli_sfm_runs_and_exports(rendered, reconstruction, capsys):
    """The CLI on the same folder (features and matches resume from the
    store), with the stage table and every export of the JAX `cmd_sfm`."""
    fold, _ = rendered
    scenes = cli.main(["sfm", fold, "--mode", "web", "--max-kp", "2048",
                       "--no-resize", "--matching", "all", "--device", "cpu"])
    assert len(_best(scenes).registered) == N_CAMS
    out = capsys.readouterr().out
    assert "-- stage times --" in out and "sfm/reconstruct" in out
    model = os.path.join(fold, "mtpu_db", "model_0")
    for f in ["bundle.rd.out", "cloud.txt", "sfm_openmvs.txt",
              "sfm_sure.txt", "cams.txt", "pts.txt"]:
        assert os.path.exists(os.path.join(model, f)), f
    assert os.path.isdir(os.path.join(model, "cmvs", "cmvs0", "txt"))
    # undistorted copies of every registered view, named as the inputs
    und = os.path.join(model, "undistort_images")
    assert sorted(os.listdir(und)) == sorted(
        n for n in os.listdir(fold) if n.endswith(".png"))
    assert len(os.listdir(und)) == N_CAMS
    with open(os.path.join(model, "bundle.rd.out")) as fh:
        header = fh.readlines()[1].split()
    assert int(header[0]) == N_CAMS


def test_scene_checkpoint_opens_in_jax(reconstruction, tmp_path):
    """The port's scene checkpoint (Scene.save) is the JAX package's format."""
    from metricsfm_tpu.models.scene import Scene as JScene

    scene = _best(reconstruction[3])
    path = str(tmp_path / "temp_result0.npz")
    scene.save(path)
    back = JScene.load(path)
    assert back.registered == scene.registered
    assert back.n_points() == scene.n_points()
    for i in scene.registered:
        np.testing.assert_array_equal(back.poses[i], scene.poses[i])
    assert [m.f for m in back.models] == [m.f for m in scene.models]


def test_cli_refuses_missing_cuda(rendered):
    """--device cuda without a card raises; nothing carries on on the CPU."""
    import torch
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["sfm", rendered[0], "--device", "cuda"])


@pytest.mark.parametrize("entry", ["Database", "MatchGraphBuilder",
                                   "IncrementalSfM", "DenseReconstruction"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Built with no `device`, each entry point takes the card; without
    one it raises the RuntimeError `cli --device cuda` raises, and runs
    nothing on the CPU."""
    import torch

    from metricsfm_tpu_torch.config import DenseOptions, GraphOptions
    from metricsfm_tpu_torch.models.dense import DenseReconstruction
    from metricsfm_tpu_torch.models.match_graph import MatchGraphBuilder
    build = {
        "Database": lambda: Database(str(tmp_path), _cfg().database),
        "MatchGraphBuilder": lambda: MatchGraphBuilder(GraphOptions()),
        "IncrementalSfM": lambda: IncrementalSfM({}, {}, _cfg()),
        "DenseReconstruction": lambda: DenseReconstruction(DenseOptions()),
    }[entry]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_reads_jax_feature_store(rendered, tmp_path):
    """Features extracted by the JAX Database are read and matched by the
    port; the JAX Database reads the port's store back."""
    from metricsfm_tpu.config import PRESETS as JPRESETS
    from metricsfm_tpu.models.database import Database as JDatabase

    from metricsfm_tpu_torch.io import store

    src, _ = rendered
    fold = str(tmp_path / "imgs")
    os.makedirs(fold)
    for name in sorted(n for n in os.listdir(src) if n.endswith(".png"))[:2]:
        shutil.copy(os.path.join(src, name), os.path.join(fold, name))
    jcfg = JPRESETS["web"]()
    jcfg = dataclasses.replace(jcfg, database=dataclasses.replace(
        jcfg.database, resize=False, max_keypoints=2048))
    jdb = JDatabase(fold, jcfg.database)
    jdb.feature_extraction()

    cfg = _cfg()
    db = Database(fold, cfg.database, device="cpu")
    assert all(store.has_features(db.out, i) for i in range(db.n_images))
    db.feature_extraction()                 # resume: nothing left to do
    for i in range(db.n_images):
        a, b = jdb.features(i), db.features(i)
        np.testing.assert_array_equal(a.desc, b.desc)
        np.testing.assert_array_equal(a.xy, b.xy)
        assert (a.width, a.height) == (b.width, b.height)
    matches = build_match_graph(db, cfg)
    assert len(matches[(0, 1)].kp_i) > 200

    # and the port's own store (from the e2e folder) opens in JAX
    jdb2 = JDatabase(src, jcfg.database)
    port_db = Database(src, cfg.database, device="cpu")
    np.testing.assert_array_equal(jdb2.features(0).desc,
                                  port_db.features(0).desc)
