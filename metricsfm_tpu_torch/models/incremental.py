"""Incremental SfM driver.

Counterpart of metricsfm_tpu/models/incremental.py.  Re-design of the
reference pipeline (SfM/src/sfm_incremental.cc): host-side orchestration of
batched device calls on one torch device, mirroring the reference control
flow stage by stage (SURVEY.md §3.2):

  seed-pair ranking (sfm_incremental.cc:1790-1829)
  -> seed reconstruction: relative pose + triangulation + full BA with
     normalize/perturb (:224-415)
  -> loop: next-image selection by 2D-3D correspondence count damped by
     failure count (:417-563), PnP localization (:565-753), new-point
     triangulation (:755-915), partial BA (:917-1014), full BA every 5
     images (:180-183), reprojection outlier cull (:1831-1863)
  -> multi-model outer loop until no seed remains (:99-220).

Inputs are per-image feature sets + a sparse pairwise match table (from
models.match_graph or fed directly for tests); device work uses the JAX
package's bucketed shapes.  Random draws (RANSAC samples, the seed BA
perturbation) come from one torch.Generator on the device, seeded from
`seed`.

Pairs whose images both carry an EXIF focal (or sfm.calibrated) seed by
5-point RANSAC (ops/five_point.py), falling back to the 8-point essential
matrix when too few inliers survive.  BA over sfm.th_cg_cameras or more
cameras solves the reduced camera system by matrix-free PCG (ba/lm.py);
periodic full BAs above sfm.th_hierarchical_cameras cameras run
hierarchical submap BA (parallel/submap_ba.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..ba import LMConfig, solve_lm
from ..ba import problem as ba_problem
from ..ops import epipolar, five_point, np_geom, pnp, triangulation
from ..parallel.submap_ba import hierarchical_ba
from .scene import CameraModel, Scene, bucket
from ..utils.device import resolve as resolve_device
from ..utils.tracing import span


@dataclass
class ImageFeatures:
    """Per-image feature set (host mirror of the {i}_feature files)."""
    xy: np.ndarray           # (K, 2) centered pixel coords
    desc: Optional[np.ndarray]  # (K, D) or None when matches are precomputed
    mask: np.ndarray         # (K,) valid keypoints
    width: int = 0
    height: int = 0
    focal_exif: float = 0.0  # 0 = unknown

    @property
    def f_hint(self) -> float:
        if self.focal_exif > 0:
            return self.focal_exif
        return 1.2 * max(self.width, self.height)


@dataclass
class PairMatches:
    """Verified matches for one image pair (i < j)."""
    kp_i: np.ndarray         # (N,) keypoint indices in image i
    kp_j: np.ndarray         # (N,) keypoint indices in image j


def cg_plan(config, n_images: int):
    """Solver routing for a BA over n_images cameras: dense Schur below
    sfm.th_cg_cameras (exact, cheap at small C); matrix-free PCG above
    it (the dense per-point camera factor is O(P*C)).
    ba.cg_iterations: -1 = auto-enable at scale (the default), 0 =
    never, >0 = explicit cap.

    Returns (use_cg, effective_cg_iterations)."""
    cg_req = config.ba.cg_iterations
    use_cg = cg_req != 0 and n_images >= config.sfm.th_cg_cameras
    cg_its = (cg_req if cg_req > 0
              else config.ba.cg_auto_iterations) if use_cg else 0
    return use_cg, cg_its


class IncrementalSfM:
    """The reference IncrementalSfM::Run loop on a torch device."""

    def __init__(self, features: Dict[int, ImageFeatures],
                 matches: Dict[Tuple[int, int], PairMatches],
                 config: PipelineConfig, seed: int = 0, device="cuda"):
        self.features = features
        self.matches = {}
        for (i, j), m in matches.items():
            if i > j:
                i, j, m = j, i, PairMatches(kp_i=m.kp_j, kp_j=m.kp_i)
            self.matches[(i, j)] = m
        self.cfg = config
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.scenes: List[Scene] = []
        self._neighbors: Dict[int, List[int]] = {}
        for (i, j) in self.matches:
            self._neighbors.setdefault(i, []).append(j)
            self._neighbors.setdefault(j, []).append(i)
        # base LMConfig is the DENSE path; _bundle swaps in the PCG camera
        # solve (cg_iterations > 0) when the problem reaches
        # sfm.th_cg_cameras and ba.cg_iterations allows it (-1 = auto)
        self._lm_cfg = LMConfig(
            max_iterations=self.cfg.ba.max_iterations,
            huber_delta=self.cfg.ba.huber_delta,
            init_lambda=self.cfg.ba.init_lambda,
            rtol=self.cfg.ba.rtol,
            cg_iterations=0,
            cg_tol=self.cfg.ba.cg_tol,
            cg_forcing=self.cfg.ba.cg_forcing,
        )
        # solver-path counters; *_iters track actual LM iterations consumed
        # so a stage table can attribute BA seconds to iteration counts;
        # cg_solves counts every BA (partial or full) that ran the PCG solve
        self.stats = {"full_ba": 0, "full_ba_cg": 0, "full_ba_hier": 0,
                      "partial_ba": 0, "partial_ba_iters": 0,
                      "full_ba_iters": 0, "cg_solves": 0}

    # -- helpers -----------------------------------------------------------
    def _tensor(self, a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _pair(self, i, j) -> Optional[PairMatches]:
        if i <= j:
            return self.matches.get((i, j))
        m = self.matches.get((j, i))
        if m is None:
            return None
        return PairMatches(kp_i=m.kp_j, kp_j=m.kp_i)

    def _match_strength(self):
        """Pair ranking log(sum_i) * log(sum_j) * log(n_match)
        (ref SortImagePairs, sfm_incremental.cc:1790-1829)."""
        row_sum: Dict[int, int] = {}
        for (i, j), m in self.matches.items():
            n = len(m.kp_i)
            row_sum[i] = row_sum.get(i, 0) + n
            row_sum[j] = row_sum.get(j, 0) + n
        ranked = []
        for (i, j), m in self.matches.items():
            n = len(m.kp_i)
            if n < 16:
                continue
            s = math.log(max(row_sum[i], 2)) * math.log(max(row_sum[j], 2)) \
                * math.log(max(n, 2))
            ranked.append((s, i, j))
        ranked.sort(reverse=True)
        return ranked

    # -- seed --------------------------------------------------------------
    def _try_seed(self, i, j, used: set) -> Optional[Scene]:
        """Seed reconstruction from pair (i, j) (ref :224-415)."""
        m = self._pair(i, j)
        fi, fj = self.features[i], self.features[j]
        p1 = self._tensor(fi.xy[m.kp_i])
        p2 = self._tensor(fj.xy[m.kp_j])
        n = p1.shape[0]
        if n < max(16, self.cfg.sfm.th_seedpair_structures):
            return None

        calibrated = self.cfg.sfm.calibrated or (
            fi.focal_exif > 0 and fj.focal_exif > 0)
        if calibrated:
            f1 = f2 = float(fi.focal_exif or fi.f_hint)
            # 5-point RANSAC (planar-safe, the reference's calibrated path
            # essential_matrix_five_point.cc); the 8-point E estimate when
            # too few RANSAC inliers survive
            res5 = five_point.relative_pose_known_focal_5pt(
                p1, p2, f1, f2, self.gen,
                num_hypotheses=self.cfg.sfm.ransac_5pt_iters)
            if bool(res5["ok"]):
                res = res5
            else:
                res = epipolar.relative_pose_known_focal(p1, p2, f1, f2)
        else:
            res = epipolar.relative_pose_unknown_focal(p1, p2)
            if not bool(res["valid"]):
                return None
            f1, f2 = float(res["f1"]), float(res["f2"])
            # reject absurd focal estimates (reference gates on downstream mse)
            hint = 0.5 * (fi.f_hint + fj.f_hint)
            if not (0.2 * hint < f1 < 5.0 * hint and 0.2 * hint < f2 < 5.0 * hint):
                return None

        scene = Scene(len(self.features), self.cfg.sfm.idx_max_per_image)
        shared = self.cfg.sfm.use_same_camera
        mi0 = scene.add_camera_model(CameraModel(
            f=f1, f_hint=fi.f_hint, calibrated=calibrated))
        mi1 = mi0 if shared else scene.add_camera_model(CameraModel(
            f=f2, f_hint=fj.f_hint, calibrated=calibrated))
        pose_i = np.zeros(6)
        R, t = res["R"].cpu().numpy(), res["t"].cpu().numpy()
        pose_j = np_geom.pose_from_Rt(R, t)
        scene.register_image(i, pose_i, mi0, len(fi.xy))
        scene.register_image(j, pose_j, mi1, len(fj.xy))

        # triangulate all matches (two-view), gate, install tracks
        poses = self._tensor(np.stack([pose_i, pose_j]))
        intrs = self._tensor(np.array([[f1, 0, 0], [f2, 0, 0]]))
        P = n
        tp = poses.expand(P, 2, 6)
        ti = intrs.expand(P, 2, 3)
        to = torch.stack([p1, p2], dim=1)
        tm = torch.ones((P, 2), dtype=torch.float32, device=self.device)
        xyz, ok, mse = triangulation.triangulate_tracks(
            tp, ti, to, tm, self.cfg.sfm.th_mse_reprojection,
            self.cfg.sfm.th_angle_small, "midpoint")
        xyz, ok = xyz.cpu().numpy(), ok.cpu().numpy()
        n_ok = int(ok.sum())
        if n_ok < self.cfg.sfm.th_seedpair_structures or n_ok < n // 5:
            return None
        for a in np.where(ok)[0]:
            scene.add_track(xyz[a], {i: int(m.kp_i[a]), j: int(m.kp_j[a])})

        # seed full BA with normalize + perturb (ref optimizer.cc:50-60)
        self._bundle(scene, full=True, seed_run=True)
        self._cull_outliers(scene, self.cfg.sfm.th_mse_outliers)
        if scene.n_points() < self.cfg.sfm.th_seedpair_structures:
            return None
        return scene

    # -- localization ------------------------------------------------------
    def _gather_2d3d(self, scene: Scene, img: int):
        """Harvest 2D-3D correspondences for an unregistered image via its
        matched neighbours (ref FindImageToLocalize, :417-563)."""
        kp_list, track_list = [], []
        for nb in self._neighbors.get(img, []):
            if nb not in scene.poses:
                continue
            m = self._pair(img, nb)
            if m is None:
                continue
            k2t = scene.kp_to_track[nb]
            tid = k2t[m.kp_j]
            live = tid >= 0
            kp_list.append(m.kp_i[live])
            track_list.append(tid[live])
        if not kp_list:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        kp = np.concatenate(kp_list)
        tr = np.concatenate(track_list)
        # dedupe per keypoint (a kp may map to one track via several pairs)
        _, first = np.unique(kp, return_index=True)
        return kp[first], tr[first]

    def _corr_for(self, scene: Scene, img: int):
        """Cached `_gather_2d3d`, invalidated by neighbours' k2t versions.

        The reference re-harvests every remaining image every step
        (sfm_incremental.cc:417-563) — O(n_remaining * pairs) per step,
        quadratic over a run.  Keying on (registered neighbour, its
        kp_to_track version) makes the per-step cost proportional to the
        neighbourhood the step actually changed.
        """
        key = tuple((nb, scene.k2t_version.get(nb, 0))
                    for nb in self._neighbors.get(img, ())
                    if nb in scene.poses)
        ent = self._corr_cache.get(img)
        if ent is not None and ent[0] == key:
            return ent[1]
        corr = self._gather_2d3d(scene, img)
        self._corr_cache[img] = (key, corr)
        return corr

    def _select_next_image(self, scene: Scene, remaining: set):
        best, best_score, best_corr = None, 0.0, None
        for img in remaining:
            fails = scene.localization_failures.get(img, 0)
            if fails >= self.cfg.sfm.th_max_failure_localization:
                continue
            kp, tr = self._corr_for(scene, img)
            if len(kp) < self.cfg.sfm.min_2d3d_correspondences:
                continue
            score = len(kp) / (5.0 + fails)
            if score > best_score:
                best, best_score, best_corr = img, score, (kp, tr)
        return best, best_corr

    def _localize(self, scene: Scene, img: int, corr) -> bool:
        """PnP localization of one image (ref LocalizeImage, :565-753)."""
        kp, tr = corr
        feat = self.features[img]
        Xw = np.stack([scene.tracks[t].xyz for t in tr])
        obs = feat.xy[kp]
        N = bucket(len(kp), 64)
        pad = N - len(kp)
        Xw_p = np.pad(Xw, ((0, pad), (0, 0)))
        obs_p = np.pad(obs, ((0, pad), (0, 0)))
        mask = np.zeros(N, bool)
        mask[:len(kp)] = True

        calibrated = self.cfg.sfm.calibrated or feat.focal_exif > 0
        shared = self.cfg.sfm.use_same_camera
        Xw_t, obs_t = self._tensor(Xw_p), self._tensor(obs_p)
        mask_t = self._tensor(mask, torch.bool)
        if shared and scene.models:
            f_known = scene.models[0].f
            res = pnp.pnp_ransac(
                Xw_t, obs_t, f_known, self.gen, mask=mask_t,
                num_hypotheses=self.cfg.sfm.ransac_pnp_iters,
                th_inlier_px=self.cfg.sfm.th_inlier_pnp_px)
            f_est = f_known
        elif calibrated:
            f_est = feat.focal_exif or feat.f_hint
            res = pnp.pnp_ransac(
                Xw_t, obs_t, float(f_est), self.gen, mask=mask_t,
                num_hypotheses=self.cfg.sfm.ransac_pnp_iters,
                th_inlier_px=self.cfg.sfm.th_inlier_pnp_px)
        else:
            res = pnp.pnp_ransac_unknown_focal(
                Xw_t, obs_t, float(feat.f_hint), self.gen, mask=mask_t,
                num_hypotheses=max(self.cfg.sfm.ransac_pnp_iters // 4, 32),
                num_focal_samples=64,
                th_inlier_px=self.cfg.sfm.th_inlier_pnp_px)
            f_est = float(res["f"])

        res = {k: v.cpu().numpy() for k, v in res.items()}
        n_inl = int(res["n_inliers"])
        avg = float(res["avg_err"])
        if n_inl < self.cfg.sfm.min_2d3d_correspondences or \
                avg > self.cfg.sfm.th_mse_localization:
            scene.localization_failures[img] = \
                scene.localization_failures.get(img, 0) + 1
            return False

        pose = np_geom.pose_from_Rt(np.asarray(res["R"]),
                                    np.asarray(res["t"]))
        if shared:
            mi = 0
        else:
            mi = scene.add_camera_model(CameraModel(
                f=float(f_est), f_hint=feat.f_hint, calibrated=calibrated))
        scene.register_image(img, pose, mi, len(feat.xy))
        # attach inlier observations to their tracks
        inl = np.asarray(res["inlier_mask"])[:len(kp)]
        for a in np.where(inl)[0]:
            scene.add_observation(int(tr[a]), img, int(kp[a]))
        return True

    # -- new points --------------------------------------------------------
    def _triangulate_new(self, scene: Scene, img: int):
        """New tracks between img and registered neighbours
        (ref GenerateNew3DPoints, :755-915)."""
        feat = self.features[img]
        k2t_img = scene.kp_to_track[img]
        ki_parts, nb_parts, kj_parts = [], [], []
        nbrow_parts, uv_parts = [], []
        # small per-call pose/intr tables; row 0 = the new image, the
        # device gathers per-view rows by index (triangulate_tracks_indexed)
        table_imgs = [img]
        row_of_img = {img: 0}
        with span("sfm/triangulate_new/prep"):
            for nb in self._neighbors.get(img, []):
                if nb not in scene.poses:
                    continue
                m = self._pair(img, nb)
                if m is None or len(m.kp_i) == 0:
                    continue
                k2t_nb = scene.kp_to_track[nb]
                ti = k2t_img[m.kp_i]
                tj = k2t_nb[m.kp_j]
                # img kp already tracked, nb kp free -> extend the track
                ext = np.where((ti >= 0) & (tj < 0))[0]
                if len(ext):
                    scene.add_observations_bulk(ti[ext], nb, m.kp_j[ext])
                new = np.where((ti < 0) & (tj < 0))[0]
                if len(new) == 0:
                    continue
                if nb not in row_of_img:
                    row_of_img[nb] = len(table_imgs)
                    table_imgs.append(nb)
                ki_parts.append(m.kp_i[new].astype(np.int64))
                nb_parts.append(np.full(len(new), nb, np.int64))
                kj_parts.append(m.kp_j[new].astype(np.int64))
                nbrow_parts.append(np.full(len(new), row_of_img[nb],
                                           np.int32))
                uv_parts.append(self.features[nb].xy[m.kp_j[new]])
            if not ki_parts:
                return 0
            # group candidate observations by img keypoint (numpy, no
            # per-match Python loop)
            ki_all = np.concatenate(ki_parts)
            order = np.argsort(ki_all, kind="stable")
            ki_s = ki_all[order]
            nb_s = np.concatenate(nb_parts)[order]
            kj_s = np.concatenate(kj_parts)[order]
            nbrow_s = np.concatenate(nbrow_parts)[order]
            uv_s = np.concatenate(uv_parts)[order]
            uk, start, counts = np.unique(ki_s, return_index=True,
                                          return_counts=True)
            n_items = min(len(uk), self.cfg.sfm.max_new_points_per_step)
            group = np.repeat(np.arange(len(uk)), counts)
            slot = np.arange(len(ki_s)) - np.repeat(start, counts)

            V = 8
            P = bucket(n_items, 64)
            R = bucket(len(table_imgs), 8)
            pose_table = np.zeros((R, 6), np.float32)
            intr_table = np.zeros((R, 3), np.float32)
            for im2, rr in row_of_img.items():
                pose_table[rr] = scene.poses[im2]
                intr_table[rr] = \
                    scene.models[scene.model_of_image[im2]].as_array()
            cam_idx = np.zeros((P, V), np.int32)
            obs = np.zeros((P, V, 2), np.float32)
            mask = np.zeros((P, V), np.float32)
            # slot 0: the new image's own observation (table row 0)
            obs[:n_items, 0] = feat.xy[uk[:n_items]]
            mask[:n_items, 0] = 1.0
            keep = (group < n_items) & (slot < V - 1)
            r, v = group[keep], slot[keep] + 1
            cam_idx[r, v] = nbrow_s[keep]
            obs[r, v] = uv_s[keep]
            mask[r, v] = 1.0
        th_angle = self.cfg.sfm.th_angle_small if n_items <= 500 \
            else self.cfg.sfm.th_angle_large
        with span("sfm/triangulate_new/device"):
            xyz, ok, mse = triangulation.triangulate_tracks_indexed(
                self._tensor(pose_table), self._tensor(intr_table),
                self._tensor(cam_idx, torch.int64), self._tensor(obs),
                self._tensor(mask), self.cfg.sfm.th_mse_reprojection,
                th_angle, "midpoint")
            xyz, ok = xyz.cpu().numpy(), ok.cpu().numpy()
        added = 0
        with span("sfm/triangulate_new/install"):
            nb_keep, kj_keep = nb_s[keep], kj_s[keep]
            views_of: Dict[int, Dict[int, int]] = {}
            for a in np.where(ok[r])[0]:
                views_of.setdefault(int(r[a]), {})[int(nb_keep[a])] = \
                    int(kj_keep[a])
            for row in np.where(ok[:n_items])[0]:
                track_obs = {img: int(uk[row])}
                track_obs.update(views_of.get(int(row), {}))
                scene.add_track(xyz[row], track_obs)
                added += 1
        return added

    # -- BA + culling ------------------------------------------------------
    def _bundle(self, scene: Scene, full: bool, seed_run: bool = False,
                around_img: Optional[int] = None, final: bool = False):
        """Partial/full bundle adjustment (ref :917-1026, optimizer.cc).

        Partial BA is a LOCAL problem: cameras covisible with around_img
        are mutable, every track any of them observes is in the problem
        (mutable), and every other camera observing those tracks is
        included FROZEN as an anchor — so the device work is O(local
        neighbourhood) regardless of scene size, unlike the reference
        which rebuilds the whole Ceres problem each step
        (sfm_incremental.cc:917-1014).  Track weight 2.0 for >=3-view
        tracks.  Full BA: everything mutable, gauge fixed at the first
        registered camera.

        Returns the list of scene track indices the solve could have
        moved (the partial problem's tracks; None for a full BA = all).
        """
        if (full and not final and
                len(scene.registered) > self.cfg.sfm.th_hierarchical_cameras):
            # large scene, PERIODIC full BA: hierarchical submap BA +
            # pose-graph merge (cheap, local).  The FINAL full BA always
            # runs the single global matrix-free CG solve instead: the
            # pose-graph merge leaves low-frequency stitching error that
            # only a global solve removes.  Periodic budget: the iteration
            # cap and loose rtol of every intermediate solve.
            kp_xy = {im: self.features[im].xy for im in scene.registered}
            with span("sfm/ba_solve/hier"):
                info = hierarchical_ba(
                    scene, kp_xy, max_cams=self.cfg.sfm.submap_max_cams,
                    overlap=self.cfg.sfm.submap_overlap,
                    cfg=self._lm_cfg._replace(
                        max_iterations=self.cfg.sfm.th_step_full_ba_iterations,
                        rtol=max(self._lm_cfg.rtol,
                                 self.cfg.sfm.intermediate_ba_rtol)),
                    device=self.device)
            self.stats["full_ba"] += 1
            self.stats["full_ba_hier"] += 1
            self.stats["full_ba_iters"] += int(np.sum(info["iterations"]))
            return None
        if full:
            mutable = list(scene.registered)
            weight = 1.0
            images = None
            local_tracks = None
        else:
            # local-neighbourhood selection off the flat observation log
            # (pure numpy).  Stale log
            # entries (keypoint overwrites) don't matter here: membership
            # of (track, img) is what's queried, and obs are only removed
            # by whole-track culls, which the bad mask filters.
            t_all, i_all, _ = scene._obs_arrays()
            bad = scene.bad_mask()
            n_tr = len(scene.tracks)
            reg_mask = np.zeros(scene.n_images, bool)
            reg_mask[np.fromiter(scene.poses.keys(), np.int64,
                                 len(scene.poses))] = True
            vis_ids = np.zeros(0, np.int64)
            if around_img is not None and around_img in scene.kp_to_track:
                k2t = scene.kp_to_track[around_img]
                seed_tracks = np.unique(k2t[k2t >= 0])
                in_seed = np.zeros(n_tr, bool)
                in_seed[seed_tracks] = True
                vis_ids = np.unique(i_all[in_seed[t_all]])
                vis_ids = vis_ids[reg_mask[vis_ids]]
            vis = np.unique(np.append(vis_ids, around_img)) \
                if around_img in scene.poses else vis_ids
            # tracks observed by any mutable camera (the ADVICE-r2 cull
            # scope: these are exactly the points the step can move)
            vis_mask = np.zeros(scene.n_images, bool)
            vis_mask[vis] = True
            tset = np.unique(t_all[vis_mask[i_all]])
            local_arr = tset[~bad[tset]] if tset.size else tset
            local_tracks = local_arr.tolist()
            # anchor cameras: frozen observers of the local tracks
            in_local = np.zeros(n_tr, bool)
            in_local[local_arr] = True
            cam_ids = np.unique(i_all[in_local[t_all]])
            cam_ids = cam_ids[reg_mask[cam_ids]]
            mutable = [int(v) for v in vis]
            images = sorted({int(c) for c in cam_ids} | set(mutable))
            weight = self.cfg.sfm.weight_multiview
        gauge = scene.registered[0]
        mutable = [im for im in mutable if im != gauge]
        if images is not None and all(im in mutable for im in images):
            # no frozen anchor in the local problem: pin the lowest id
            mutable = [im for im in mutable if im != images[0]]

        kp_imgs = scene.registered if images is None else images
        kp_xy = {im: self.features[im].xy for im in kp_imgs}
        prob, maps = scene.to_ba_problem(
            kp_xy, max_views=16, mutable_images=mutable,
            weight_multiview=weight, images=images, tracks=local_tracks,
            device=self.device)
        use_cg, cg_its = cg_plan(self.cfg, len(kp_imgs))
        base_cfg = self._lm_cfg._replace(cg_iterations=cg_its)
        self.stats["cg_solves"] += int(use_cg)
        if full:
            self.stats["full_ba"] += 1
            self.stats["full_ba_cg"] += int(use_cg)
        else:
            self.stats["partial_ba"] += 1
        if seed_run:
            prob, tf = ba_problem.normalize_problem(
                prob, self.cfg.ba.normalize_scale)
            prob = ba_problem.perturb_problem(
                prob, self.gen, self.cfg.ba.perturb_sigma_rot,
                self.cfg.ba.perturb_sigma_t, self.cfg.ba.perturb_sigma_pt)
        loose = self.cfg.sfm.intermediate_ba_rtol
        if full:
            lm_cfg = base_cfg if final else base_cfg._replace(
                max_iterations=self.cfg.sfm.th_step_full_ba_iterations,
                rtol=max(base_cfg.rtol, loose))
        else:
            lm_cfg = base_cfg._replace(
                max_iterations=self.cfg.sfm.partial_ba_iterations,
                rtol=max(base_cfg.rtol, loose))
        # the solve's seconds by solver path, nested in the BA spans
        with span("sfm/ba_solve/pcg" if use_cg else "sfm/ba_solve/dense"):
            prob, info = solve_lm(prob, lm_cfg)
        self.stats["full_ba_iters" if full else "partial_ba_iters"] += \
            int(info["iterations"])
        if seed_run:
            prob = ba_problem.denormalize_problem(prob, tf)
        scene.update_from_ba(prob, maps)
        return local_tracks

    def _cull_outliers(self, scene: Scene, th_px: float, tracks=None):
        """Mark tracks with sqrt(mse) > th as bad (ref RemovePointOutliers,
        :1831-1863 — an in-place sweep).

        With `tracks` set (after a partial BA), only those tracks — the
        ones the partial problem could have moved — are swept; tracks
        untouched by the step cannot have become outliers.  The reference
        pays a full O(P) sweep per image.
        """
        if tracks is not None:
            cand = np.unique(np.asarray(sorted(tracks), np.int64))
        else:
            cand = np.arange(len(scene.tracks), dtype=np.int64)
        if cand.size == 0:
            return 0
        bad = np.fromiter((scene.tracks[int(r)].is_bad for r in cand),
                          bool, cand.size)
        rows = cand[~bad]
        if rows.size == 0:
            return 0
        # observation harvest straight off the scene's flat log (numpy
        # only)
        t_all, i_all, k_all = scene._obs_arrays()
        ridx_of = np.full(len(scene.tracks), -1, np.int64)
        ridx_of[rows] = np.arange(rows.size)
        reg_imgs = scene.registered
        islot_of = np.full(scene.n_images, -1, np.int64)
        islot_of[np.asarray(reg_imgs, np.int64)] = np.arange(len(reg_imgs))
        ridx = ridx_of[t_all]
        slot = islot_of[i_all]
        m = (ridx >= 0) & (slot >= 0)
        pos = np.nonzero(m)[0]
        ridx, slot, kp = ridx[m], slot[m], k_all[m]
        if ridx.size == 0:
            return 0
        # keep-LAST per (track, img): Track.obs dict-overwrite semantics
        key = ridx * len(reg_imgs) + slot
        srt = np.lexsort((pos, key))
        key_s = key[srt]
        last = np.ones(srt.size, bool)
        if srt.size > 1:
            last[:-1] = key_s[1:] != key_s[:-1]
        sel = srt[last]
        ridx, slot, kp = ridx[sel], slot[sel], kp[sel]

        Rs = np.stack([np_geom.pose_to_Rt(scene.poses[im])[0]
                       for im in reg_imgs])
        ts = np.stack([np_geom.pose_to_Rt(scene.poses[im])[1]
                       for im in reg_imgs])
        fs = np.array([scene.models[scene.model_of_image[im]].f
                       for im in reg_imgs])
        k1 = np.array([scene.models[scene.model_of_image[im]].k1
                       for im in reg_imgs])
        k2 = np.array([scene.models[scene.model_of_image[im]].k2
                       for im in reg_imgs])
        X = np.array([scene.tracks[int(r)].xyz for r in rows])[ridx]
        Xc = np.einsum("nij,nj->ni", Rs[slot], X) + ts[slot]
        z = np.where(np.abs(Xc[:, 2]) < 1e-12, 1e-12, Xc[:, 2])
        xn = Xc[:, :2] / z[:, None]
        r2 = (xn ** 2).sum(1)
        xd = xn * (1.0 + r2 * (k1[slot] + r2 * k2[slot]))[:, None]
        uv = fs[slot, None] * xd
        base, uv_all = self._kp_store()
        kp_obs = uv_all[base[np.asarray(reg_imgs, np.int64)[slot]] + kp]
        err2 = ((uv - kp_obs) ** 2).sum(1)
        err2 = np.where(Xc[:, 2] > 0, err2, 1e12)
        sums = np.zeros(rows.size)
        cnts = np.zeros(rows.size)
        np.add.at(sums, ridx, err2)
        np.add.at(cnts, ridx, 1.0)
        mse = sums / np.maximum(cnts, 1)
        removed = 0
        for i in np.nonzero(np.sqrt(mse) > th_px)[0]:
            scene.mark_bad(int(rows[i]))
            removed += 1
        return removed

    def _kp_store(self):
        """Concatenated keypoint coords over all images with per-image base
        offsets (built once; features are immutable inputs)."""
        if getattr(self, "_kp_store_cache", None) is None:
            ids = sorted(self.features.keys())
            n = max(ids) + 1 if ids else 0
            base = np.zeros(n + 1, np.int64)
            parts = []
            off = 0
            for im in range(n):
                base[im] = off
                if im in self.features:
                    xy = np.asarray(self.features[im].xy, np.float64)
                    parts.append(xy)
                    off += len(xy)
            base[n] = off
            uv_all = (np.concatenate(parts) if parts
                      else np.zeros((0, 2)))
            self._kp_store_cache = (base, uv_all)
        return self._kp_store_cache

    # -- checkpoint / resume (ref use_temp re-entry, sfm_incremental.cc:83-110,
    #    WriteTempResultOut every 10 images :207-211) ----------------------
    def _checkpoint_path(self, checkpoint_dir: str, model_idx: int) -> str:
        import os
        return os.path.join(checkpoint_dir, f"temp_result{model_idx}.npz")

    def _write_checkpoint(self, checkpoint_dir: Optional[str],
                          model_idx: int, scene: Scene):
        if checkpoint_dir is None:
            return
        import os
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = self._checkpoint_path(checkpoint_dir, model_idx)
        scene.save(path + ".tmp.npz")
        os.replace(path + ".tmp.npz", path)

    def _load_checkpoint(self, checkpoint_dir: Optional[str],
                         model_idx: int) -> Optional[Scene]:
        if checkpoint_dir is None:
            return None
        import os
        path = self._checkpoint_path(checkpoint_dir, model_idx)
        if not os.path.exists(path):
            return None
        return Scene.load(path)

    def _debug_dump(self, dump_dir: Optional[str], scene: Scene, step: int):
        """Per-added-image point-cloud dump (ref pts{N}.txt after every
        registration, sfm_incremental.cc:204-205,1425-1463 — the
        reference's main debugging affordance)."""
        if dump_dir is None:
            return
        import os
        from ..io.exports import write_point_cloud
        os.makedirs(dump_dir, exist_ok=True)
        write_point_cloud(os.path.join(dump_dir, f"pts{step}.txt"), scene)

    # -- main loop ---------------------------------------------------------
    def run(self, max_models: int = 8, verbose: bool = False,
            checkpoint_dir: Optional[str] = None, resume: bool = False,
            debug_dump_dir: Optional[str] = None):
        """Reconstruct one or more models (ref Run, :81-220).

        With checkpoint_dir set, the model state is serialized every
        cfg.sfm.checkpoint_every registered images (temp_result{N}.npz);
        resume=True re-enters from the newest checkpoint of each model
        instead of re-seeding (ref use_temp switch).  debug_dump_dir
        writes a colored cloud + frustum glyphs after every registration
        (ref pts{N}.txt dumps).
        """
        remaining = set(self.features.keys())
        ranked = self._match_strength()
        for model_idx in range(max_models):
            self._corr_cache: Dict[int, tuple] = {}
            scene = self._load_checkpoint(checkpoint_dir, model_idx) \
                if resume else None
            if scene is not None:
                remaining -= set(scene.registered)
                if verbose:
                    print(f"resumed model {model_idx}: "
                          f"{len(scene.registered)} images")
            else:
                for s, i, j in ranked:
                    if i in remaining and j in remaining:
                        with span("sfm/seed"):
                            scene = self._try_seed(i, j, remaining)
                        if scene is not None:
                            break
                if scene is None:
                    break
                remaining -= set(scene.registered)
                for img in scene.registered:
                    scene.localization_failures.pop(img, None)

            step = 0
            # growth-ratio full-BA schedule (default): next full BA when
            # the model has grown >= full_ba_growth_ratio cameras since
            # the last one — O(log n) full BAs over a run instead of the
            # reference-literal every-5-registrations (O(n) solves of
            # O(n)-sized problems, sfm_incremental.cc:180-183, kept as
            # full_ba_schedule="step")
            grow = 1.0 + self.cfg.sfm.full_ba_growth_ratio
            next_full_at = max(len(scene.registered) + 1,
                               math.ceil(len(scene.registered) * grow))
            while True:
                with span("sfm/select_next"):
                    img, corr = self._select_next_image(scene, remaining)
                if img is None:
                    break
                with span("sfm/localize"):
                    ok = self._localize(scene, img, corr)
                if not ok:
                    if verbose:
                        print(f"localize fail img={img}")
                    continue
                remaining.discard(img)
                with span("sfm/triangulate_new"):
                    n_new = self._triangulate_new(scene, img)
                with span("sfm/partial_ba"):
                    moved = self._bundle(scene, full=False, around_img=img)
                step += 1
                if self.cfg.sfm.full_ba_schedule == "step":
                    full_step = (step %
                                 self.cfg.sfm.th_step_full_bundle_adjustment
                                 == 0)
                else:
                    full_step = len(scene.registered) >= next_full_at
                if full_step:
                    with span("sfm/full_ba"):
                        self._bundle(scene, full=True)
                    n_reg = len(scene.registered)
                    next_full_at = max(n_reg + 1, math.ceil(n_reg * grow))
                with span("sfm/cull_outliers"):
                    # full sweep only when a full BA moved everything;
                    # otherwise only the tracks the partial problem moved
                    self._cull_outliers(scene, self.cfg.sfm.th_mse_outliers,
                                        tracks=None if full_step else moved)
                if step % self.cfg.sfm.checkpoint_every == 0:
                    self._write_checkpoint(checkpoint_dir, model_idx, scene)
                self._debug_dump(debug_dump_dir, scene, step)
                if verbose:
                    print(f"+img {img}: {n_new} new pts, "
                          f"{scene.n_points()} total, {len(remaining)} left")
            # final full BA + cull
            if len(scene.registered) > 2:
                with span("sfm/final_ba"):
                    self._bundle(scene, full=True, final=True)
                    self._cull_outliers(scene, self.cfg.sfm.th_mse_outliers)
            self._write_checkpoint(checkpoint_dir, model_idx, scene)
            self.scenes.append(scene)
            if len(remaining) < 2:
                break
        return self.scenes
