"""The street path of the PyTorch port (models/slam_gps, `cli slam`) against
the JAX package on the same synthetic street sequence, on the CPU.

The fixtures are tests/test_slam_gps.py's: `synth_street` (20 keyframes,
200 points, written as KeyFramePts.txt / pos.txt / rgb.txt) and
`synth_keyframe_features`.  Each package runs in its own copy of the fold.

The fixed path draws no random numbers.  Two things keep a whole run from
matching the JAX package to the last millimetre, and the tests are split
around them:
* the alignment: the JAX package applies the SLAM->UTM similarity, with
  its f32 rotation (orthonormal to ~1e-7), to poses whose translations
  are ~4e6 m, which moves its cameras by decimetres; the port composes the
  similarity with the demean exactly (x -> s R (x - mc)).  The gps_offset
  and the UTM camera centres agree all the same, because the GPS
  registration snaps every camera onto its GPS position;
* the BA from two starting points: this sequence's GPS altitude is
  constant (averaged) and its track nearly straight, so the roll of the
  cameras about the track lies in a flat valley of the cost, where two
  f32 solvers stop up to ~1e-2 rad apart from starts ~0.3 m apart.
So the stages after the alignment are also run by both packages from the
JAX package's aligned scene, and held there at the tighter tolerances.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from metricsfm_tpu.config import street_preset as jstreet_preset
from metricsfm_tpu.models import slam_gps as jsg
from metricsfm_tpu_torch import cli
from metricsfm_tpu_torch.config import street_preset
from metricsfm_tpu_torch.models import slam_gps as tsg
from metricsfm_tpu_torch.models.incremental import ImageFeatures
from metricsfm_tpu_torch.models.scene import CameraModel, Scene
from metricsfm_tpu_torch.ops import np_geom
from tests.test_slam_gps import synth_keyframe_features, synth_street
from tests.torch_threads import torch_threads  # noqa: F401

EXPORTS = ["pose.qin", "sfm_sure.txt", "sfm_openmvs.txt", "cloud.txt",
           "gps_pos.txt", "gps_overlay.png", "cams.txt", "pts.txt"]


def _street(path, rematch=False):
    """The JAX test's sequence (and, for the re-match, its keyframe
    features, drawn from the same rng after the sequence)."""
    rng = np.random.default_rng(0)
    os.makedirs(path, exist_ok=True)
    centers, _, (e0, n0) = synth_street(path, rng)
    feats = synth_keyframe_features(rng, path) if rematch else None
    gt = np.array([[e0 + c[0], n0 + c[1]] for c in centers])
    return gt, feats


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _centers(scene):
    return np.stack([np_geom.camera_center(scene.poses[i])
                     for i in scene.registered])


def _rotations(scene):
    return [np_geom.pose_to_Rt(scene.poses[i])[0] for i in scene.registered]


def _max_angle(Ra, Rb):
    return max(np.linalg.norm(np_geom.matrix_to_angle_axis(a @ b.T))
               for a, b in zip(Ra, Rb))


def _accuracy(fold):
    with open(os.path.join(fold, "accuracy.txt")) as f:
        avg, mse, n = f.read().split()
    return float(avg), float(mse), int(n)


def _qin(fold):
    with open(os.path.join(fold, "mtpu_out", "pose.qin")) as f:
        lines = f.read().split("\n")
    rows = [ln.split() for ln in lines[2:]]
    return (lines[:2], [r[0] for r in rows],
            np.array([[float(v) for v in r[1:]] for r in rows]))


def _euler_to_R(e):
    from metricsfm_tpu_torch.ops import lie
    return lie.euler_xyz_to_matrix(torch.tensor(e, dtype=torch.float64)
                                   ).numpy()


def _utm_error(pipe, scene, gt):
    est = np.array([pipe.convert_to_gps(c) for c in _centers(scene)])
    return float(np.median(np.linalg.norm(est[:, :2] - gt, axis=1)))


# -- readers ---------------------------------------------------------------
def test_readers_match_jax(tmp_path):
    """read_slam / read_gps / read_frame_ids / turn_weights on the street
    files: the same values (the JAX package converts the poses in f32, the
    port in f64: they agree within 1e-6)."""
    fold = str(tmp_path)
    _street(fold)
    kf = os.path.join(fold, "KeyFramePts.txt")
    sj, st = jsg.read_slam(kf), tsg.read_slam(kf)
    np.testing.assert_array_equal(st.cam_ids, sj.cam_ids)
    np.testing.assert_allclose(st.poses, sj.poses, atol=1e-6)
    assert (st.f, st.cx, st.cy) == (sj.f, sj.cx, sj.cy)
    np.testing.assert_array_equal(st.points, sj.points)
    assert st.obs == sj.obs
    gj = jsg.read_gps(os.path.join(fold, "pos.txt"))
    gt = tsg.read_gps(os.path.join(fold, "pos.txt"))
    assert gj == gt
    assert len({v[2] for v in gt.values()}) == 1      # altitude averaged
    fj = jsg.read_frame_ids(os.path.join(fold, "rgb.txt"))
    assert tsg.read_frame_ids(os.path.join(fold, "rgb.txt")) == fj
    gps = np.array([gt[i] for i in fj])
    np.testing.assert_array_equal(tsg.turn_weights(gps),
                                  jsg.turn_weights(gps))


def test_reset_tracks_keeps_bookkeeping_consistent():
    s = Scene(3)
    mi = s.add_camera_model(CameraModel(f=500.0, calibrated=True))
    for i in range(3):
        s.register_image(i, np.zeros(6), mi, 4)
    s.add_track(np.ones(3), {0: 1, 1: 2})
    s.add_track(np.ones(3), {1: 0, 2: 3})
    s.mark_bad(0)
    v = dict(s.k2t_version)
    s.reset_tracks()
    assert s.tracks == [] and s.bad_mask().shape == (0,)
    assert all((k2t == -1).all() for k2t in s.kp_to_track.values())
    assert all(s.k2t_version[i] > v[i] for i in range(3))
    assert len(s._obs_arrays()[0]) == 0
    t = s.add_track(np.zeros(3), {0: 0, 2: 1})
    assert t == 0 and s.kp_to_track[2][1] == 0
    prob, maps = s.to_ba_problem({i: np.zeros((4, 2)) for i in range(3)},
                                 device="cpu")
    assert maps["tracks"] == [0] and int(prob.track_mask.sum()) == 2


# -- the fixed path (the default `cli slam`) ---------------------------------
@pytest.fixture(scope="module")
def fixed_runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("street_fixed"))
    gt, _ = _street(os.path.join(base, "src"))
    fj = _copy(os.path.join(base, "src"), os.path.join(base, "jax"))
    ft = _copy(os.path.join(base, "src"), os.path.join(base, "port"))
    jp = jsg.SLAMGPS(jstreet_preset())
    js = jp.run(fj)
    tp = tsg.SLAMGPS(street_preset(), device="cpu")
    ts = tp.run(ft)
    return gt, (jp, js, fj), (tp, ts, ft)


def test_fixed_path_matches_jax(fixed_runs):
    gt, (jp, js, fj), (tp, ts, ft) = fixed_runs
    assert ts.registered == js.registered and len(ts.registered) == 20
    # relative to the offset's UTM magnitude (its altitude is ~1.6 m)
    assert np.linalg.norm(tp.gps_offset - jp.gps_offset) <= \
        1e-6 * np.linalg.norm(jp.gps_offset)
    # camera centres after the GPS BA, in UTM
    cj = _centers(js) + jp.gps_offset
    ct = _centers(ts) + tp.gps_offset
    assert np.abs(ct - cj).max() < 1e-3
    aj, at = _accuracy(fj), _accuracy(ft)
    assert at[2] == aj[2]
    np.testing.assert_allclose(at[:2], aj[:2], atol=1e-3)
    bj = np.array([t.is_bad for t in js.tracks])
    bt = np.array([t.is_bad for t in ts.tracks])
    assert len(bt) == len(bj) and (bt == bj).mean() >= 0.99
    # pose.qin: the same header and names; each row's centre, with its
    # package's gps_offset added back, is the same UTM position
    hj, nj, qj = _qin(fj)
    ht, nt, qt = _qin(ft)
    assert ht == hj and nt == nj and len(nt) == 20
    assert np.abs((qt[:, :3] + tp.gps_offset)
                  - (qj[:, :3] + jp.gps_offset)).max() < 1e-3
    # the JAX test's gate, on the port
    assert _utm_error(tp, ts, gt) < 1.0


def _inputs(fold, pkg):
    slam = pkg.read_slam(os.path.join(fold, "KeyFramePts.txt"))
    gps = pkg.read_gps(os.path.join(fold, "pos.txt"))
    frames = [f for f in pkg.read_frame_ids(os.path.join(fold, "rgb.txt"))
              if f in gps]
    return slam, np.array([gps[frames[c]] for c in slam.cam_ids])


def test_alignment_lands_on_gps(tmp_path):
    """The sequence's SLAM track is an exact similarity of its GPS track
    (in easting / northing), so the aligned camera centres must land on
    their GPS positions.  The port's composed alignment does, within
    f32 rounding; the JAX package's is off by ~0.2 m (see the module
    docstring), which its later GPS registration absorbs."""
    fold = str(tmp_path)
    _street(fold)
    slam, cams_gps = _inputs(fold, tsg)
    tp = tsg.SLAMGPS(street_preset(), device="cpu")
    scene = tp._build_scene(slam)
    tp._align_global(scene, cams_gps, False)
    err = _centers(scene) + tp.gps_offset - cams_gps
    assert np.abs(err[:, :2]).max() < 0.01
    np.testing.assert_allclose(tp._cams_gps_centered,
                               cams_gps - tp.gps_offset)


def test_stages_after_alignment_match_jax(tmp_path):
    """GPS registration, GPS BA, accuracy cull and exports of both packages
    from the JAX package's aligned scene: centres within 1e-3 m, points
    within 1e-2 m (median), rotations and the .qin's rotations within
    1e-3 rad, .qin centres within 1e-3 m, accuracy.txt within 1e-3."""
    fold = str(tmp_path / "src")
    _street(fold)
    jp = jsg.SLAMGPS(jstreet_preset())
    slam, cams_gps = _inputs(fold, jsg)
    sj = jp._build_scene(slam)
    jp._align_global(sj, cams_gps, False)
    sj.save(str(tmp_path / "aligned.npz"))
    st = Scene.load(str(tmp_path / "aligned.npz"))
    tp = tsg.SLAMGPS(street_preset(), device="cpu")
    tp.kp_xy = {k: np.asarray(v, np.float64) for k, v in jp.kp_xy.items()}
    tp.gps_offset = jp.gps_offset.copy()
    tp._cams_gps_centered = jp._cams_gps_centered.copy()
    tslam = tsg.read_slam(os.path.join(fold, "KeyFramePts.txt"))
    folds = []
    for pipe, scene, sl, name in ((jp, sj, slam, "jax"),
                                  (tp, st, tslam, "port")):
        out = str(tmp_path / name)
        os.makedirs(out)
        pipe._gps_registration(scene, pipe._cams_gps_centered)
        pipe._gps_bundle(scene, pipe._cams_gps_centered)
        pipe._accuracy_cull(scene, out)
        pipe._exports(out, scene, sl)
        folds.append(out)
    assert np.abs(_centers(st) - _centers(sj)).max() < 1e-3
    xj = np.stack([t.xyz for t in sj.tracks])
    xt = np.stack([t.xyz for t in st.tracks])
    assert np.median(np.linalg.norm(xt - xj, axis=1)) < 1e-2
    assert _max_angle(_rotations(st), _rotations(sj)) < 1e-3
    aj, at = _accuracy(folds[0]), _accuracy(folds[1])
    assert at[2] == aj[2]
    np.testing.assert_allclose(at[:2], aj[:2], atol=1e-3)
    hj, nj, qj = _qin(folds[0])
    ht, nt, qt = _qin(folds[1])
    assert ht == hj and nt == nj
    assert np.abs(qt[:, :3] - qj[:, :3]).max() < 1e-3
    assert _max_angle([_euler_to_R(e) for e in qt[:, 3:]],
                      [_euler_to_R(e) for e in qj[:, 3:]]) < 1e-3
    bj = np.array([t.is_bad for t in sj.tracks])
    bt = np.array([t.is_bad for t in st.tracks])
    assert (bt == bj).mean() >= 0.99


# -- the re-match path (kernel 2a on the card) -------------------------------
def _port_features(feats):
    return {k: ImageFeatures(xy=f.xy, desc=f.desc, mask=f.mask,
                             width=f.width, height=f.height,
                             focal_exif=f.focal_exif)
            for k, f in feats.items()}


def _recording(pipe, name, rec):
    """Wrap pipe.<name> so that its result is kept in rec[name]."""
    orig = getattr(pipe, name)

    def wrapped(*a, **k):
        rec[name] = orig(*a, **k)
        return rec[name]
    setattr(pipe, name, wrapped)


@pytest.fixture(scope="module")
def rematch_runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("street_rematch"))
    gt, feats = _street(os.path.join(base, "src"), rematch=True)
    out = {}
    for name, pipe, f in (
            ("jax", jsg.SLAMGPS(jstreet_preset()), feats),
            ("port", tsg.SLAMGPS(street_preset(), device="cpu"),
             _port_features(feats))):
        rec = {}
        _recording(pipe, "window_match_priors", rec)
        _recording(pipe, "feature_matching", rec)
        fold = _copy(os.path.join(base, "src"), os.path.join(base, name))
        scene = pipe.run(fold, features=f, rematch=True)
        out[name] = (pipe, scene, rec)
    return gt, feats, out


def test_rematch_priors_and_matches_match_jax(rematch_runs):
    """The same prior pairs; per pair, the kept matches agree with JAX's on
    >= 0.95 of image j's keypoints (kept or not, and the same keypoint of
    image i when kept; the F-RANSAC draws differ)."""
    _, feats, out = rematch_runs
    rj, rt = out["jax"][2], out["port"][2]
    assert set(rt["window_match_priors"]) == set(rj["window_match_priors"])
    assert len(rt["window_match_priors"]) > 0
    mj, mt = rj["feature_matching"], rt["feature_matching"]
    assert set(mt) == set(mj)
    for (i, j), (ki, kj) in mj.items():
        n = len(feats[j].xy)
        a = np.full(n, -1)
        b = np.full(n, -1)
        a[kj] = ki
        b[mt[(i, j)][1]] = mt[(i, j)][0]
        assert (a == b).mean() >= 0.95, (i, j, (a == b).mean())
    assert out["port"][0].stats["verified_pairs"] == len(mt)


def test_rematch_gates_match_jax(rematch_runs):
    """The JAX test's gates on the port, and a good-track count within
    10 % of JAX's."""
    gt, _, out = rematch_runs
    tp, ts, _ = out["port"]
    cfg = street_preset()
    good = [t for t in ts.tracks if not t.is_bad]
    assert len(good) >= 50
    assert all(len(t.obs) >= cfg.slam.min_track_views for t in good)
    assert sum(len(t.obs) > 3 for t in good) > 10
    assert _utm_error(tp, ts, gt) < 1.0
    n_jax = out["jax"][1].n_points()
    assert abs(len(good) - n_jax) <= 0.1 * n_jax
    assert tp.stats["retriangulated"] >= len(good)


# -- the CLI -------------------------------------------------------------------
def test_cli_slam_writes_every_export(tmp_path, capsys):
    fold = str(tmp_path)
    _street(fold)
    # two keyframes' images on disk: the undistorted copies are written
    # for those, and the missing ones are skipped
    from PIL import Image
    os.makedirs(os.path.join(fold, "rgb"))
    rng = np.random.default_rng(1)
    for i in (0, 3):
        Image.fromarray(rng.integers(0, 256, (36, 64, 3), np.uint8)).save(
            os.path.join(fold, "rgb", f"{i}.png"))
    scene = cli.main(["slam", fold, "--device", "cpu"])
    assert len(scene.registered) == 20
    out = capsys.readouterr().out
    assert "-- stage times --" in out and "slam/run" in out
    assert "slam/gps_bundle" in out
    mo = os.path.join(fold, "mtpu_out")
    for f in EXPORTS:
        assert os.path.exists(os.path.join(mo, f)), f
    assert sorted(os.listdir(os.path.join(mo, "undistort_images"))) == \
        ["0.png", "3.png"]
    assert os.path.exists(os.path.join(fold, "accuracy.txt"))
    with open(os.path.join(mo, "pose.qin")) as f:
        assert int(f.readline()) == 20


def test_slam_refuses_missing_cuda(tmp_path):
    """Without --device (or device=), the street path takes the card and,
    without one, raises; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        assert tsg.SLAMGPS(street_preset()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsg.SLAMGPS(street_preset())
    _street(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["slam", str(tmp_path)])


def test_smoke_street_sequence_runs_cli_slam(tmp_path):
    """chip_smoke.py's street sequence (phase 11a's writer and gates), at
    40 keyframes and 2,000 facade points, through `cli slam --device
    cpu`."""
    import chip_smoke

    fold = str(tmp_path)
    gt = chip_smoke.street_fixed_fold(fold, n=40, n_pts=2000)
    scene = cli.main(["slam", fold, "--device", "cpu"])
    assert len(scene.registered) == 40 and scene.n_points() > 1000
    assert chip_smoke.street_gates(fold, gt, 40) < 0.5
