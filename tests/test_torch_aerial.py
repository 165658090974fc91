"""Parity of the port's aerial pieces with the JAX package, and a small
aerial reconstruction on the port.

UTM conversion and GPS-priori candidates are host code copied from the JAX
package: equal results.  The aerial renderer shares its f64 host
precompute (equal poses) and shades in f32 on both sides (pixels within
1e-3 but for a few cos() roundings at tile edges).  The reconstruction is
the aerial run's configuration (UAV preset, priori candidates from the
ground-truth centers) at the smallest grid where the JAX package itself
registers >= 95 % on the CPU among those tried, with sfm.th_cg_cameras
lowered to 24 so that the PCG camera solve runs: 3 x 10 views at 320 x 240
with 1024 keypoints (JAX: 30/30, ATE 0.0025).  3 x 5 registers 6/15 (at 15
images the mutual k-NN has k = 2 and links only along the flight lines),
and 3 x 10 at 256 x 192 with 768 keypoints 22/30.
"""
import dataclasses

import numpy as np
import pytest

from metricsfm_tpu.models import match_graph as jmg
from metricsfm_tpu.utils import synth as jsynth
from metricsfm_tpu.utils import utm as jutm
from metricsfm_tpu_torch.config import PRESETS
from metricsfm_tpu_torch.models import match_graph as tmg
from metricsfm_tpu_torch.models.database import Database
from metricsfm_tpu_torch.models.incremental import IncrementalSfM
from metricsfm_tpu_torch.ops import matching as tmatching
from metricsfm_tpu_torch.ops import np_geom
from metricsfm_tpu_torch.utils import synth as tsynth
from metricsfm_tpu_torch.utils import utm as tutm
from tests.torch_threads import torch_threads  # noqa: F401

LATLON = [(47.3769, 8.5417), (-33.8688, 151.2093), (60.0, 5.0),
          (78.2, 15.6), (0.0, 0.0), (40.7128, -74.006), (-54.8, -68.3),
          (63.9, 3.5), (83.5, 179.99)]


@pytest.mark.parametrize("ellipsoid", [22, 0, 13])
def test_utm_matches_jax(ellipsoid):
    for lat, lon in LATLON:
        je, jn, jz = jutm.ll_to_utm(lat, lon, ellipsoid)
        te, tn, tz = tutm.ll_to_utm(lat, lon, ellipsoid)
        assert tz == jz
        assert abs(te - je) < 1e-6 and abs(tn - jn) < 1e-6
        jl = jutm.utm_to_ll(je, jn, jz, ellipsoid)
        tl = tutm.utm_to_ll(te, tn, tz, ellipsoid)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-12)
        # and the round trip lands where it started
        assert abs(tl[0] - lat) < 1e-5
        assert abs(((tl[1] - lon + 180) % 360) - 180) < 1e-5


@pytest.mark.parametrize("n,knn", [(57, 50), (200, 50), (31, 3), (12, 8)])
def test_candidates_gps_matches_jax(n, knn):
    rng = np.random.default_rng(n)
    utm_xy = rng.uniform(0, 500, size=(n, 2)) + np.array([4.6e5, 5.2e6])
    want = jmg.candidates_gps(utm_xy, knn)
    got = tmg.candidates_gps(utm_xy, knn)
    assert got == want and len(got) > 0


class _GpsOnlyDatabase:
    """What build_match_graph reads of a Database for candidate selection."""

    def __init__(self, latlon):
        self.latlon = latlon
        self.n_images = len(latlon)
        self.out = None
        self.device = "cpu"

    def gps(self, i):
        return (*self.latlon[i], 100.0)

    def features(self, i):
        return None

    def build_words(self, verbose=False):
        """Word bags in which only images 2k and 2k + 1 share a word."""
        counts = np.zeros((self.n_images, 400), np.float32)
        for i in range(self.n_images):
            counts[i, i // 2] = 1.0
        return None, counts


@pytest.mark.parametrize("source", ["exif gps", "priori_utm"])
def test_priori_branch_selects_gps_pairs(source, monkeypatch):
    rng = np.random.default_rng(9)
    latlon = np.array([47.0, 8.0]) + rng.uniform(0, 0.01, size=(40, 2))
    seen = {}

    def fake_build(self, feats, pairs, verbose=False, owner=None):
        seen["pairs"] = pairs
        return {}
    monkeypatch.setattr(tmg.MatchGraphBuilder, "build", fake_build)
    cfg = PRESETS["uav"]()
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, matching_type="priori", knn=6))
    coords = np.array([jutm.ll_to_utm(a, b)[:2] for a, b in latlon])
    kw = {"priori_utm": coords} if source == "priori_utm" else {}
    tmg.build_match_graph(_GpsOnlyDatabase(latlon), cfg, device="cpu", **kw)
    assert seen["pairs"] == jmg.candidates_gps(coords, 6)
    # the "feature" branch selects by the database's word bags, not GPS
    bow = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, matching_type="feature", word_seed_min_matches=1))
    tmg.build_match_graph(_GpsOnlyDatabase(latlon), bow, device="cpu", **kw)
    assert seen["pairs"] == [(i, i + 1) for i in range(0, 40, 2)]


def test_render_aerial_matches_jax():
    kw = dict(seed=3, rows=2, cols=3, width=96, height=72)
    want = jsynth.render_aerial(**kw)
    got = tsynth.render_aerial(**kw, device="cpu", cam_chunk=4)
    np.testing.assert_array_equal(got["poses"], want["poses"])
    np.testing.assert_array_equal(got["centers"], want["centers"])
    assert got["focal"] == want["focal"]
    assert got["images"].shape == want["images"].shape == (6, 72, 96)
    close = np.abs(got["images"] - want["images"]) <= 1e-3
    assert close.mean() >= 0.995, close.mean()
    # textured, not blank: the shading reached every view
    assert got["images"].std(axis=(1, 2)).min() > 0.02


def test_small_aerial_reconstruction_runs_pcg(tmp_path, monkeypatch):
    rows, cols = 3, 10
    gt = tsynth.render_aerial(seed=0, rows=rows, cols=cols, width=320,
                              height=240, device="cpu")
    fold = str(tmp_path / "aerial")
    tsynth.write_scene_images(fold, gt)
    cfg = PRESETS["uav"]()
    cfg = dataclasses.replace(
        cfg,
        database=dataclasses.replace(cfg.database, resize=False,
                                     max_keypoints=1024),
        graph=dataclasses.replace(cfg.graph, matching_type="priori"),
        sfm=dataclasses.replace(cfg.sfm, th_cg_cameras=24))
    db = Database(fold, cfg.database, device="cpu")
    db.feature_extraction()
    # the 2-NN of each verify batch runs on the batch's pairs, not padding
    batches = []
    knn2_gather = tmatching.knn2_gather

    def spy(desc, mask, ii, jj):
        batches.append(int(ii.shape[0]))
        return knn2_gather(desc, mask, ii, jj)
    monkeypatch.setattr(tmatching, "knn2_gather", spy)
    matches = tmg.build_match_graph(db, cfg, priori_utm=gt["centers"][:, :2])
    cand = tmg.candidates_gps(gt["centers"][:, :2], cfg.graph.knn)
    assert set(matches) <= set(cand)
    assert sum(batches) == len(cand) and max(batches) <= 32
    feats = {i: db.features(i) for i in range(db.n_images)}
    sfm = IncrementalSfM(feats, matches, cfg, device="cpu")
    scenes = sfm.run()
    best = max(scenes, key=lambda s: len(s.registered))
    reg = sorted(best.registered)
    assert len(reg) >= 0.95 * rows * cols, f"{len(reg)}/{rows * cols}"
    est = np.stack([np_geom.camera_center(best.poses[i]) for i in reg])
    ate = tsynth.ate_vs_gt(est, gt["centers"][reg])
    assert ate < 0.05, ate
    assert sfm.stats["cg_solves"] > 0 and sfm.stats["full_ba_cg"] > 0
