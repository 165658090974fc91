"""GPS-aided SLAM-refinement pipeline (street/GoPro-video workload).

Counterpart of metricsfm_tpu/models/slam_gps.py, the re-design of the
reference SLAMGPS pipeline (SfM/src/slam_gps.{h,cc}, SURVEY.md §3.4),
file-format compatible with its inputs:

  KeyFramePts.txt  — n cams (id, ts, fx fy cx cy, t, R) + n points with
                     per-view observations (slam_gps.cc:139-216); pixel obs
                     are centered at (cx, cy) and rescaled by resize_ratio.
  pos.txt          — 'id lat lon alt' GPS rows; lat/lon -> UTM, altitude
                     replaced by the track average (slam_gps.cc:218-245).
  rgb.txt          — TUM-style frame index used to associate cameras with
                     GPS rows (slam_gps.cc:247-288).

Stages: global weighted-Umeyama alignment SLAM->GPS with turn-aware
weights (slam_gps.cc:1596-1674), optional windowed re-matching +
multi-view triangulation (>=3 views), per-point IDW GPS registration
(GPSRegistration2, :917-983), GPS-anchored full BA (Schur-LM with
camera-center anchors, weight = #reproj-residuals/#cams, z/5), accuracy
cull, and georeferenced exports with offset re-addition (Convert2GPS).

The device work (alignment, priors, re-matching, triangulation, BA) runs on
the pipeline's torch device.  The re-match is batched like
models/match_graph.verify_pairs: one launch of the 2-NN kernel (kernel 2a,
ops/matching.knn2_gather) per batch of 32 pairs over a bf16 descriptor
store, then the ratio, prior-F and prior-H gates and one batched F-RANSAC.
The window priors run one batched F-RANSAC and one batched H-RANSAC per
group of pairs of one padded length, where the JAX package dispatches
each pair on its own.  The re-match batches are split over the ranks of
a mesh (parallel/mesh) as MatchGraphBuilder splits its batches
(each rank one 2-NN launch on its rows, the whole batch's RANSAC draws on
every rank, the results gathered); the rest of the run is replicated, and
rank 0 alone writes.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ba import LMConfig, solve_lm
from ..config import PipelineConfig
from ..io import exports
from ..ops import np_geom, umeyama
from ..parallel.mesh import Mesh
from ..utils import utm as utm_util
from ..utils.device import resolve as resolve_device
from ..utils.tracing import span
from .incremental import cg_plan
from .match_graph import descriptor_store, gather_rows, split_batch
from .scene import CameraModel, Scene, bucket

REMATCH_BATCH = 32          # pairs per 2-NN launch
PRIOR_BATCH = 256           # pairs per batched prior F-/H-RANSAC


@dataclass
class SLAMInput:
    cam_ids: np.ndarray          # (C,) original frame ids
    poses: np.ndarray            # (C, 6) world->cam [aa, t]
    f: float                     # shared focal (rescaled)
    cx: float
    cy: float
    points: np.ndarray           # (P, 3)
    obs: List[Dict[int, Tuple[float, float]]]  # per point: cam_row -> (x, y) centered


def read_slam(path: str, resize_ratio: float = 0.5) -> SLAMInput:
    """Parse KeyFramePts.txt (ref ReadinSLAM, slam_gps.cc:139-216).  Poses
    are converted in f64 (np_geom.pose_from_Rt)."""
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)

    def nxt():
        return next(it)

    n = int(nxt())
    ids, poses = [], []
    fx = fy = cx = cy = 0.0
    for _ in range(n):
        ids.append(int(nxt()))
        _ts = float(nxt())
        fx, fy, cx, cy = (float(nxt()) for _ in range(4))
        t = np.array([float(nxt()) for _ in range(3)])
        R = np.array([float(nxt()) for _ in range(9)]).reshape(3, 3)
        poses.append(np_geom.pose_from_Rt(R, t))
    id_to_row = {cid: r for r, cid in enumerate(ids)}

    n_pts = int(nxt())
    pts = np.zeros((n_pts, 3))
    obs: List[Dict[int, Tuple[float, float]]] = []
    for i in range(n_pts):
        pts[i] = [float(nxt()) for _ in range(3)]
        n_obs = int(nxt())
        d = {}
        for _ in range(n_obs):
            cid = int(nxt())
            px = float(nxt())
            py = float(nxt())
            if cid in id_to_row:
                # centered then rescaled (ref :199)
                d[id_to_row[cid]] = ((px - cx) / resize_ratio,
                                     (py - cy) / resize_ratio)
        obs.append(d)
    f_shared = (fx + fy) / 2.0 / resize_ratio
    return SLAMInput(cam_ids=np.array(ids), poses=np.stack(poses),
                     f=f_shared, cx=cx / resize_ratio, cy=cy / resize_ratio,
                     points=pts, obs=obs)


def read_gps(path: str, ellipsoid: int = utm_util.WGS84
             ) -> Dict[int, Tuple[float, float, float]]:
    """Parse pos.txt -> {frame_id: (easting, northing, alt_avg)}
    (ref ReadinGPS, slam_gps.cc:218-245: altitude averaged over the track)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            fid = int(parts[0])
            lat, lon, alt = map(float, parts[1:4])
            e, n, _ = utm_util.ll_to_utm(lat, lon, ellipsoid)
            rows.append((fid, e, n, alt))
    if not rows:
        return {}
    alt_avg = sum(r[3] for r in rows) / len(rows)
    return {fid: (e, n, alt_avg) for fid, e, n, _ in rows}


def read_frame_ids(path: str) -> List[int]:
    """Parse rgb.txt frame list (3 header lines; ref :247-288)."""
    out = []
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines[3:]:
        line = line.strip()
        if not line:
            break
        name = line.split("/")[-1]
        name = name.rsplit(".", 1)[0].split()[-1]
        try:
            out.append(int(name))
        except ValueError:
            continue
    return out


def turn_weights(gps: np.ndarray, window: int = 20, max_deg: float = 80.0
                 ) -> np.ndarray:
    """Turn-aware alignment weights w = tan(|angle - pi| clipped to 80deg)
    (ref AbsoluteOrientationWithGPSGlobal, slam_gps.cc:1601-1626)."""
    n = len(gps)
    w = np.zeros(n)
    for i in range(n):
        s = max(i - window, 0)
        e = min(i + window, n - 1)
        dxs, dys = gps[s, 0] - gps[i, 0], gps[s, 1] - gps[i, 1]
        dxe, dye = gps[e, 0] - gps[i, 0], gps[e, 1] - gps[i, 1]
        denom = math.sqrt(dxs * dxs + dys * dys + 0.1) * \
            math.sqrt(dxe * dxe + dye * dye + 0.1)
        ang = math.acos(max(-1.0, min(1.0, (dxs * dxe + dys * dye) / denom)))
        ang = abs(ang - math.pi)
        ang = min(ang, math.radians(max_deg))
        w[i] = math.tan(ang)
    return w


def rematch_pairs(desc, xy, mask, ii, jj, F, H, generator, ratio: float,
                  th_epi: float, th_dist: float, draw_rows=None):
    """The prior-gated re-match chain for a batch of keyframe pairs (ref
    slam_gps.cc:424-553), all pairs at once.

    desc (M, N, 128) bf16, xy (M, N, 2), mask (M, N): the device store;
    ii, jj (B,) int32 store rows of each pair (i < j); F, H (B, 3, 3) the
    pairs' priors.  The 2-NN runs from image j's keypoints (queries) into
    image i (database), ratio `ratio`; a match survives the epipolar gate
    against F (<= th_epi), the prior-H displacement gate (<= 40 th_dist)
    and a batched F-RANSAC over the gated set (draw_rows: its whole-batch
    draw when the pairs are one rank's rows of a split batch,
    ransac.fundamental_ransac).
    Returns (keep (B, N) over image j's keypoints, idx_i (B, N) their best
    keypoint of image i, ok (B,)).
    """
    from ..ops import epipolar, matching, ransac

    d1_sq, d2_sq, idx_i = matching.knn2_gather(desc, mask, jj, ii)
    iil, jjl = ii.long(), jj.long()
    keep = matching.ratio_tests(d1_sq, d2_sq, idx_i, mask[jjl], ratio,
                                ratio)["all"]
    p1 = xy[iil[:, None], idx_i.long()]                    # (B, N, 2) in i
    p2 = xy[jjl]                                           # (B, N, 2) in j
    # epipolar gate vs the prior F (ref :481-489)
    keep = keep & (epipolar.epipolar_distance(F, p1, p2) <= th_epi)
    # homography displacement gate (ref :492-499, 40*th_distance)
    ph = epipolar._homog(p1) @ H.transpose(-1, -2)
    w = ph[..., 2:]
    w = torch.where(torch.abs(w) < 1e-9, torch.where(w < 0, -1e-9, 1e-9), w)
    disp = torch.linalg.norm(ph[..., :2] / w - p2, dim=-1)
    keep = keep & (disp <= 40 * th_dist)
    # final F-RANSAC geo-verification over the gated set
    fr = ransac.fundamental_ransac(p1, p2, generator, mask=keep,
                                   draw_rows=draw_rows)
    keep = keep & fr["inlier_mask"]
    ok = fr["ok"] & (torch.sum(keep, dim=-1) >= 8)
    return keep & ok[:, None], idx_i, ok


class SLAMGPS:
    """The SLAMGPS::Run pipeline (slam_gps.cc:63-137) on one torch device.

    `device` defaults to the card and raises without one; its random draws
    (the RANSACs of the re-match path) come from a torch.Generator seeded
    with `seed`.  The re-match batches are split over the ranks of `mesh`
    (parallel/mesh.Mesh; default: the one process on `device`), on the
    mesh's device (`device` is then unused); every rank runs the whole
    pipeline on the same inputs, and rank 0 alone writes (the keyframe
    feature store, accuracy.txt and the exports).  `stats` counts the last
    run's prior pairs, verified re-match pairs and retriangulated tracks;
    the GPS BA's solve is the span slam/ba_solve/pcg (from
    sfm.th_cg_cameras cameras) or slam/ba_solve/dense.
    """

    def __init__(self, config: PipelineConfig, seed: int = 0, device="cuda",
                 mesh=None):
        self.cfg = config
        self.mesh = mesh or Mesh(device=resolve_device(device))
        self.lead = self.mesh.rank == 0
        self.device = self.mesh.device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.gps_offset = np.zeros(3)
        self.stats = {"prior_pairs": 0, "verified_pairs": 0,
                      "retriangulated": 0}

    def run(self, fold: str, verbose: bool = False,
            features: Optional[Dict[int, object]] = None,
            rematch: Optional[bool] = None) -> Scene:
        """Full pipeline.  When `rematch` is enabled (or keyframe images are
        on disk and self.cfg.slam.rematch is True), keyframe features are
        extracted (ref FeatureExtraction, slam_gps.cc:290-310), re-matched
        within the +-matching_window under prior F/H gates (:312-555), and
        tracks are re-triangulated with the >=min_track_views filter
        (:557-668).  `features` may inject precomputed ImageFeatures keyed
        by camera row (tests / precomputed stores)."""
        with span("slam/read_inputs"):
            slam = read_slam(os.path.join(fold, "KeyFramePts.txt"),
                             self.cfg.slam.resize_ratio)
            gps_info = read_gps(os.path.join(fold, "pos.txt"))
            frame_ids = read_frame_ids(os.path.join(fold, "rgb.txt"))
            # cams_gps[i] = gps of the cam's frame (ref association quirk
            # kept: index into the gps-bearing frame list by cam id)
            frames_with_gps = [fid for fid in frame_ids if fid in gps_info]
            cams_gps = np.array([gps_info[frames_with_gps[cid]]
                                 if cid < len(frames_with_gps)
                                 else gps_info[frames_with_gps[-1]]
                                 for cid in slam.cam_ids])

        scene = self._build_scene(slam)
        with span("slam/align_global", sync=True):
            self._align_global(scene, cams_gps, verbose)
        do_rematch = self.cfg.slam.rematch if rematch is None else rematch
        if do_rematch:
            if features is None:
                with span("slam/feature_extraction", sync=True):
                    features = self.feature_extraction(fold, slam, verbose)
            if features:
                with span("slam/windowed_matching", sync=True):
                    matches = self.feature_matching(scene, features, verbose)
                with span("slam/retriangulate", sync=True):
                    self.retriangulate(scene, matches, features,
                                       use_slam_pt=self.cfg.slam.use_slam_pt,
                                       verbose=verbose)
        with span("slam/gps_registration", sync=True):
            self._gps_registration(scene, self._cams_gps_centered)
        with span("slam/gps_bundle", sync=True):
            info = self._gps_bundle(scene, self._cams_gps_centered)
        if verbose:
            print("GPS BA:", info)
        with span("slam/accuracy_cull", sync=True):
            self._accuracy_cull(scene, fold)
        if self.lead:
            with span("slam/exports"):
                self._exports(fold, scene, slam)
        return scene

    # -- keyframe features + windowed matching + re-triangulation ---------
    def feature_extraction(self, fold: str, slam: SLAMInput, verbose=False):
        """SIFT over the keyframe images (ref slam_gps.cc:290-310: Database
        extraction with resize=false) on the pipeline's device.  Returns
        {cam_row: ImageFeatures}, or None when the image folder or a
        keyframe's image is absent."""
        import dataclasses
        from .database import Database

        img_fold = os.path.join(fold, "image")
        if not os.path.isdir(img_fold):
            return None
        opts = dataclasses.replace(self.cfg.database, resize=False)
        db = Database(img_fold, opts,
                      output_fold=os.path.join(fold, "feature"),
                      device=self.device)
        if db.n_images == 0:
            return None
        # rank 0 extracts and writes the store; the others wait, then
        # read it
        if self.lead:
            db.feature_extraction(verbose=verbose)
        self.mesh.barrier()
        if not self.lead:
            db.feature_extraction(verbose=verbose)
        # map cam rows to database rows by keyframe name (zero-padded id)
        by_name = {os.path.basename(p).rsplit(".", 1)[0]: k
                   for k, p in enumerate(db.image_paths)}
        feats = {}
        for r, cid in enumerate(slam.cam_ids):
            k = by_name.get(str(int(cid)).zfill(6))
            if k is None:
                return None
            feats[r] = db.features(k)
        return feats

    def window_match_priors(self, scene: Scene, verbose=False):
        """Step 1 of ref FeatureMatching (slam_gps.cc:324-420): for every
        in-window pair sharing >=20 SLAM tracks, estimate a prior F
        (inliers >= max(0.5 n, 30)) and reject near-planar pairs where the
        homography explains >90% of the F inliers.  Returns
        {(i, j): (F 3x3, H 3x3)} in SLAM observation coordinates.

        The pairs of one padded length (bucket(n, 64)) go through one
        batched F-RANSAC, and those that pass through one batched
        H-RANSAC, PRIOR_BATCH pairs a call."""
        from ..ops import homography as homog, ransac

        win = self.cfg.slam.matching_window
        th_epi = self.cfg.slam.epipolar_px / self.cfg.slam.resize_ratio
        th_dist = 5.0 / self.cfg.slam.resize_ratio
        imgs = scene.registered
        C = len(imgs)
        # per-camera track lists from the SLAM scene
        cam_tracks: Dict[int, Dict[int, int]] = {i: {} for i in imgs}
        for ti, tr in enumerate(scene.tracks):
            for img, kp in tr.obs.items():
                cam_tracks[img][ti] = kp
        groups: Dict[int, list] = {}
        for a in range(C):
            i = imgs[a]
            for b in range(a + 1, min(a + win + 1, C)):
                j = imgs[b]
                shared = [t for t in cam_tracks[i] if t in cam_tracks[j]]
                if len(shared) < 20:
                    continue
                p1 = self.kp_xy[i][[cam_tracks[i][t] for t in shared]]
                p2 = self.kp_xy[j][[cam_tracks[j][t] for t in shared]]
                groups.setdefault(bucket(len(shared), 64), []).append(
                    ((i, j), p1, p2))

        dev = self.device
        priors: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        for L, items in sorted(groups.items()):
            for lo in range(0, len(items), PRIOR_BATCH):
                chunk = items[lo:lo + PRIOR_BATCH]
                B = len(chunk)
                p1 = np.zeros((B, L, 2), np.float32)
                p2 = np.zeros((B, L, 2), np.float32)
                m = np.zeros((B, L), bool)
                for b, (_, q1, q2) in enumerate(chunk):
                    p1[b, :len(q1)] = q1
                    p2[b, :len(q2)] = q2
                    m[b, :len(q1)] = True
                n = m.sum(1)
                p1t, p2t, mt = (torch.from_numpy(a).to(dev)
                                for a in (p1, p2, m))
                fr = ransac.fundamental_ransac(p1t, p2t, self.gen, mask=mt,
                                               th_px=th_epi, min_inliers=30)
                n_f = fr["n_inliers"].cpu().numpy()
                sel = np.nonzero(n_f >= np.maximum(0.5 * n, 30))[0]
                if not len(sel):
                    continue
                st = torch.from_numpy(sel).to(dev)
                hr = homog.homography_ransac(p1t[st], p2t[st], self.gen,
                                             mask=mt[st], th_px=th_dist)
                n_h = hr["n_inliers"].cpu().numpy()
                Fs = fr["F"][st].cpu().numpy()
                Hs = hr["H"].cpu().numpy()
                for k, b in enumerate(sel):
                    if n_h[k] > 0.9 * n_f[b]:
                        continue        # near-planar / degenerate pair
                    priors[chunk[b][0]] = (Fs[k], Hs[k])
        if verbose:
            print(f"slam-gps priors: {len(priors)} windowed pairs")
        return priors

    def feature_matching(self, scene: Scene, features, verbose=False):
        """Step 2 of ref FeatureMatching (slam_gps.cc:424-553): 2-NN from
        image j's descriptors into image i (ratio 0.8), gated by the prior
        F epipolar distance and the prior-H displacement, then F-RANSAC
        geo-verification.  Returns {(i, j): (kp_i, kp_j) arrays}.

        The descriptor store goes to the device once (bf16, N padded to
        128); each batch of REMATCH_BATCH prior pairs is one rematch_pairs
        call (one 2-NN kernel launch) and one copy back.  The last batch is
        short: only real pairs are matched.  Each batch (of REMATCH_BATCH
        rounded up to a multiple of the mesh size) is split over the mesh's
        ranks and gathered back (match_graph.split_batch)."""
        priors = self.window_match_priors(scene, verbose)
        self.stats["prior_pairs"] = len(priors)
        if not priors:
            return {}
        th_epi = self.cfg.slam.epipolar_px / self.cfg.slam.resize_ratio
        th_dist = 5.0 / self.cfg.slam.resize_ratio
        ratio = self.cfg.slam.ratio_video

        imgs = sorted({k for p in priors for k in p})
        row_of = {im: r for r, im in enumerate(imgs)}
        dev = self.device
        desc, xy, mask = descriptor_store(features, imgs, dev)

        pair_list = sorted(priors)
        Fs = torch.tensor(np.stack([priors[p][0] for p in pair_list]),
                          dtype=torch.float32, device=dev)
        Hs = torch.tensor(np.stack([priors[p][1] for p in pair_list]),
                          dtype=torch.float32, device=dev)
        out: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        mesh = self.mesh
        B = -(-REMATCH_BATCH // mesh.size) * mesh.size
        for b0 in range(0, len(pair_list), B):
            chunk_pairs = pair_list[b0:b0 + B]
            mine, draw_rows = split_batch(mesh, chunk_pairs)
            sl = b0 + draw_rows[1]
            ii = torch.tensor([row_of[i] for i, _ in mine],
                              dtype=torch.int32).to(dev)
            jj = torch.tensor([row_of[j] for _, j in mine],
                              dtype=torch.int32).to(dev)
            keep, idx_i, ok = rematch_pairs(
                desc, xy, mask, ii, jj, Fs[sl], Hs[sl], self.gen, ratio,
                th_epi, th_dist, draw_rows)
            keep, idx_i, ok = gather_rows(mesh, keep, idx_i, ok)
            keep, idx_i, ok = (keep.cpu().numpy(), idx_i.cpu().numpy(),
                               ok.cpu().numpy())
            for b, (i, j) in enumerate(chunk_pairs):
                if not ok[b]:
                    continue
                kp_j = np.nonzero(keep[b])[0]
                out[(i, j)] = (idx_i[b][kp_j].astype(np.int64),
                               kp_j.astype(np.int64))
                if verbose:
                    print(f"  slam match {i}-{j}: {len(kp_j)} matches")
        self.stats["verified_pairs"] = len(out)
        return out

    def retriangulate(self, scene: Scene, matches, features,
                      use_slam_pt: bool = False, verbose=False):
        """Ref Triangulation (slam_gps.cc:557-668): union tracks over the
        re-matched pairs via global keypoint ids, midpoint-triangulate, and
        keep only tracks with >= min_track_views views that pass the
        3-degree parallax and reprojection gates.  Replaces the SLAM tracks
        (or appends to them when use_slam_pt)."""
        from ..ops import triangulation as tri

        idx_max = scene.idx_max
        pts_map: Dict[int, int] = {}
        new_tracks: List[Dict[int, int]] = []
        for (i, j), (kp_i, kp_j) in sorted(matches.items()):
            for a, b in zip(kp_i.tolist(), kp_j.tolist()):
                g1 = i * idx_max + a
                g2 = j * idx_max + b
                t1 = pts_map.get(g1)
                t2 = pts_map.get(g2)
                if t1 is not None:
                    new_tracks[t1][j] = b
                    pts_map[g2] = t1
                elif t2 is not None:
                    new_tracks[t2][i] = a
                    pts_map[g1] = t2
                else:
                    new_tracks.append({i: a, j: b})
                    pts_map[g1] = pts_map[g2] = len(new_tracks) - 1

        self.stats["retriangulated"] = 0
        if not new_tracks:
            return 0
        # batched midpoint triangulation with gates (ref Trianglate2 +
        # th_tri_angle=3deg; >=min_track_views filter at :643-647)
        V = max(self.cfg.slam.min_track_views,
                max(len(t) for t in new_tracks))
        V = min(V, 16)
        T = len(new_tracks)
        poses_a = np.zeros((T, V, 6), np.float32)
        intrs_a = np.zeros((T, V, 3), np.float32)
        obs_a = np.zeros((T, V, 2), np.float32)
        mask_a = np.zeros((T, V), bool)
        model = scene.models[0]
        for ti, t in enumerate(new_tracks):
            for vi, (img, kp) in enumerate(list(t.items())[:V]):
                poses_a[ti, vi] = scene.poses[img]
                intrs_a[ti, vi] = [model.f, model.k1, model.k2]
                obs_a[ti, vi] = features[img].xy[kp]
                mask_a[ti, vi] = True
        dev = self.device
        xyz, ok, _ = tri.triangulate_and_gate(
            *(torch.from_numpy(a).to(dev)
              for a in (poses_a, intrs_a, obs_a, mask_a)),
            th_error_px=self.cfg.sfm.th_mse_reprojection,
            th_angle_deg=self.cfg.sfm.th_angle_small)
        xyz = xyz.cpu().numpy()
        ok = ok.cpu().numpy() & (mask_a.sum(1)
                                 >= self.cfg.slam.min_track_views)

        if not use_slam_pt:
            scene.reset_tracks()
            for img in scene.registered:
                scene.kp_to_track[img] = np.full(
                    len(features[img].xy), -1, np.int64)
        else:
            for img in scene.registered:
                old = scene.kp_to_track[img]
                grown = np.full(max(len(old), len(features[img].xy)), -1,
                                np.int64)
                grown[:len(old)] = old
                scene.kp_to_track[img] = grown
        n_added = 0
        for ti, t in enumerate(new_tracks):
            if ok[ti]:
                scene.add_track(xyz[ti], t)
                n_added += 1
        # downstream stages (GPS registration/BA/accuracy) now observe the
        # feature keypoints instead of the synthetic SLAM observations
        self.kp_xy = {r: np.asarray(features[r].xy, np.float64)
                      for r in scene.registered}
        self.stats["retriangulated"] = n_added
        if verbose:
            print(f"slam-gps retriangulation: {n_added}/{T} tracks kept "
                  f"(>= {self.cfg.slam.min_track_views} views)")
        return n_added

    # ------------------------------------------------------------------
    def _build_scene(self, slam: SLAMInput) -> Scene:
        """One synthetic keypoint per (point, camera) observation of every
        point seen at least twice; kp_to_track sized to those counts."""
        C = len(slam.cam_ids)
        scene = Scene(C)
        mi = scene.add_camera_model(CameraModel(f=slam.f, calibrated=True))
        kp_xy: Dict[int, list] = {r: [] for r in range(C)}
        obs_maps = []
        for p_idx, d in enumerate(slam.obs):
            if len(d) < 2:
                continue
            obs_map = {}
            for cam_row, (x, y) in d.items():
                obs_map[cam_row] = len(kp_xy[cam_row])
                kp_xy[cam_row].append((x, y))
            obs_maps.append((p_idx, obs_map))
        for r in range(C):
            scene.register_image(r, slam.poses[r], mi, n_kps=len(kp_xy[r]))
        for p_idx, obs_map in obs_maps:
            scene.add_track(slam.points[p_idx], obs_map)
        self.kp_xy = {r: np.array(kp_xy[r], np.float64).reshape(-1, 2)
                      for r in range(C)}
        return scene

    def _align_global(self, scene: Scene, cams_gps: np.ndarray, verbose):
        """Weighted similarity SLAM->GPS + offset demeaning (ref :1596-1674).

        The clouds are demeaned on the host in f64 and aligned in f32 on
        the device (raw UTM eastings ~5e5 m carry only ~3 cm in f32).  The
        similarity x -> s R x + t_full and the demean by the mean aligned
        camera centre compose to x -> s R (x - mc), with gps_offset =
        s R mc + t_full = t + mg: the scene is moved by that composite,
        with R projected to the nearest rotation in f64, so no UTM-scale
        translation ever enters a pose (the f32 R is orthonormal only to
        ~1e-7, which times ~4e6 m of northing would move every camera by
        decimetres)."""
        centers = np.stack([np_geom.camera_center(scene.poses[i])
                            for i in scene.registered])
        w = turn_weights(cams_gps)
        if w.sum() < 1e-9:
            w = np.ones_like(w)
        mc = np.asarray(centers, np.float64).mean(axis=0)
        mg = np.asarray(cams_gps, np.float64).mean(axis=0)

        def dev32(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        s, R, t = umeyama.similarity_align(dev32(centers - mc),
                                           dev32(cams_gps - mg),
                                           weights=dev32(w))
        s_ = float(s)
        U, _, Vt = np.linalg.svd(R.cpu().numpy().astype(np.float64))
        R_ = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
        self.gps_offset = t.cpu().numpy().astype(np.float64) + mg
        t_ = -s_ * (R_ @ mc)
        for img in scene.registered:
            scene.poses[img] = np_geom.apply_similarity_to_pose(
                scene.poses[img], s_, R_, t_)
        for tr in scene.tracks:
            tr.xyz = s_ * R_ @ tr.xyz + t_
        self._cams_gps_centered = cams_gps - self.gps_offset
        if verbose:
            print(f"slam-gps alignment: scale {s_:.6f}, offset "
                  f"{self.gps_offset}")

    def _gps_registration(self, scene: Scene, cams_gps: np.ndarray):
        """Per-point IDW blend of per-camera GPS offsets, then snap cameras
        to GPS positions (ref GPSRegistration2, slam_gps.cc:917-983).  Host
        numpy over all observations at once."""
        imgs = scene.registered
        row_of = {im: k for k, im in enumerate(imgs)}
        centers = np.stack([np_geom.camera_center(scene.poses[i])
                            for i in imgs])
        cam_offset = cams_gps - centers
        live = [k for k, tr in enumerate(scene.tracks) if not tr.is_bad]
        if live:
            trows, crows = [], []
            for r, k in enumerate(live):
                obs = scene.tracks[k].obs
                trows.extend([r] * len(obs))
                crows.extend(row_of[im] for im in obs)
            trows = np.asarray(trows, np.int64)
            crows = np.asarray(crows, np.int64)
            xyz = np.stack([scene.tracks[k].xyz for k in live])
            d = np.linalg.norm(xyz[trows] - centers[crows], axis=1)
            w = 1.0 / (np.sqrt(d) + 5.0)
            wsum = np.bincount(trows, w, len(live))
            osum = np.stack([np.bincount(trows, w * cam_offset[crows, a],
                                         len(live)) for a in range(3)], 1)
            has = wsum > 0
            xyz[has] += osum[has] / wsum[has, None]
            for r, k in enumerate(live):
                scene.tracks[k].xyz = xyz[r]
        # snap each camera's center to its GPS position, keeping rotation
        for k, img in enumerate(imgs):
            scene.poses[img] = np_geom.pose_from_center(
                scene.poses[img][:3], cams_gps[k])

    def _gps_bundle(self, scene: Scene, cams_gps: np.ndarray):
        """GPS-anchored full BA: weight = #reproj-residuals/#cams, z/5
        (ref slam_gps.cc:718-830, gps_error_pose_absolute.h:41).  No gauge
        freeze: the GPS anchors fix it.  From sfm.th_cg_cameras cameras the
        reduced camera system is solved by PCG (ba.cg_iterations: -1 = the
        auto cap), below by dense Schur."""
        imgs = scene.registered
        n_res = sum(len(t.obs) for t in scene.tracks if not t.is_bad)
        w = float(n_res) / max(len(imgs), 1)
        prob, maps = scene.to_ba_problem(self.kp_xy, max_views=16,
                                         mutable_images=imgs,
                                         device=self.device)
        # camera-indexed terms sized to the problem's (bucketed) camera
        # axis: padded rows have zero weight and contribute nothing
        Cp = prob.n_cameras
        gps_pos = np.zeros((Cp, 3), np.float32)
        gps_pos[:len(imgs)] = cams_gps
        gps_w = np.zeros((Cp, 3), np.float32)
        gps_w[:len(imgs)] = [w, w, w * self.cfg.slam.gps_weight_z_scale]
        dev = self.device
        prob = prob._replace(gps_pos=torch.from_numpy(gps_pos).to(dev),
                             gps_weight=torch.from_numpy(gps_w).to(dev))
        if self.cfg.slam.use_gps_relative and len(imgs) >= 3:
            # consecutive keyframe triples (i-1, i, i+1), scaled like the
            # absolute term (ref slam_gps.cc:824 weight heuristic)
            k = np.arange(len(imgs) - 2)
            trip = np.stack([k, k + 1, k + 2], axis=1)
            tw = np.tile(np.array([[
                w * self.cfg.slam.gps_relative_angle_weight,
                w * self.cfg.slam.gps_relative_dist_weight]], np.float32),
                (len(trip), 1))
            prob = prob._replace(
                gps_triple=torch.from_numpy(trip).to(dev),
                gps_triple_weight=torch.from_numpy(tw).to(dev))
        ba = self.cfg.ba
        use_cg, cg_its = cg_plan(self.cfg, len(imgs))
        lm_cfg = LMConfig(max_iterations=ba.max_iterations,
                          huber_delta=ba.huber_delta, rtol=ba.rtol,
                          cg_iterations=cg_its, cg_tol=ba.cg_tol,
                          cg_forcing=ba.cg_forcing)
        with span("slam/ba_solve/pcg" if use_cg else "slam/ba_solve/dense",
                  sync=True):
            prob, info = solve_lm(prob, lm_cfg)
        scene.update_from_ba(prob, maps)
        return info

    def _accuracy_cull(self, scene: Scene, fold: str):
        """Reprojection stats + outlier cull + fold/accuracy.txt
        (ref GetAccuracy, slam_gps.cc:1573-1594)."""
        from .accuracy import assess

        st = assess(scene, self.kp_xy, max_views=16, device=self.device)
        if self.lead:
            exports.write_accuracy(os.path.join(fold, "accuracy.txt"),
                                   st["avg_err"], st["mse"], st["n_obs"])
        rows = np.nonzero(st["per_track_rmse"]
                          > self.cfg.sfm.th_mse_outliers * 3)[0]
        for row in rows:
            if row < len(st["track_rows"]):
                scene.mark_bad(st["track_rows"][row])

    def convert_to_gps(self, xyz: np.ndarray) -> np.ndarray:
        """Re-add the UTM offset (ref Convert2GPS, slam_gps.cc:1915-1948)."""
        return xyz + self.gps_offset

    def _exports(self, fold: str, scene: Scene, slam: SLAMInput):
        out = os.path.join(fold, "mtpu_out")
        os.makedirs(out, exist_ok=True)
        exports.write_cams_points(out, scene)
        exports.write_point_cloud(os.path.join(out, "cloud.txt"), scene)
        names = {i: str(int(slam.cam_ids[k])).zfill(6)
                 for k, i in enumerate(scene.registered)}
        principal = {i: (slam.cx, slam.cy) for i in scene.registered}
        sizes = {i: (int(2 * slam.cx), int(2 * slam.cy))
                 for i in scene.registered}
        exports.write_qin(os.path.join(out, "pose.qin"), scene, names,
                          cols=int(2 * slam.cx), rows=int(2 * slam.cy))
        exports.write_sure(os.path.join(out, "sfm_sure.txt"), scene, names,
                           principal, sizes)
        exports.write_openmvs(os.path.join(out, "sfm_openmvs.txt"), scene,
                              self.kp_xy, names, principal, sizes)
        # undistorted keyframe copies (ref SaveUndistortedImage call at
        # slam_gps.cc:130-136); frames whose image file is absent are
        # skipped
        frame_path: Dict[int, str] = {}
        rgb_file = os.path.join(fold, "rgb.txt")
        if os.path.exists(rgb_file):
            with open(rgb_file) as f:
                for line in f.read().splitlines()[3:]:
                    parts = line.split()
                    if len(parts) < 2:
                        continue
                    rel = parts[-1]
                    stem = os.path.basename(rel).rsplit(".", 1)[0]
                    try:
                        frame_path[int(stem)] = os.path.join(fold, rel)
                    except ValueError:
                        pass
        img_paths = {i: frame_path.get(int(slam.cam_ids[k]), "")
                     for k, i in enumerate(scene.registered)}
        exports.write_undistorted_images(
            os.path.join(out, "undistort_images"), scene, img_paths,
            device=self.device)
        # gps_pos.txt overlay (ref :1885-1905)
        est = np.stack([np_geom.camera_center(scene.poses[i])
                        for i in scene.registered])
        with open(os.path.join(out, "gps_pos.txt"), "w") as f:
            for k in range(len(est)):
                c = self.convert_to_gps(est[k])
                g = self.convert_to_gps(self._cams_gps_centered[k])
                f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} "
                        f"{g[0]:.4f} {g[1]:.4f} {g[2]:.4f}\n")
        # GrawGPS/GrawSLAM-style overlay render (ref slam_gps.cc:1107-1213)
        exports.write_track_overlay_image(
            os.path.join(out, "gps_overlay.png"), est,
            np.asarray(self._cams_gps_centered))
