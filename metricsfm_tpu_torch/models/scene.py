"""Host-side scene state for incremental reconstruction.

Counterpart of metricsfm_tpu/models/scene.py: the same host data model and
checkpoint format; BA problems are materialized on a torch device.
Re-design of the reference's pointer-graph data model
(SfM/src/camera.{h,cc}, structure.{h,cc}, sfm_incremental.h:31-108):

* The reference tracks observations as ``map<globalKpId, Camera*>`` per
  Point3D and ``pts_`` maps per Camera; here the scene keeps flat numpy
  arrays + per-image keypoint->point index maps, and *materializes* fixed
  shape masked track tensors (BAProblem) on demand for the device.
* Global keypoint ids follow the reference scheme
  ``img_idx * idx_max_per_image + kp_idx`` (basic_structs.h:169-171).
* The incremental loop itself stays host-side (SURVEY.md §7 hard part #4);
  every numeric step (matching, RANSAC, triangulation, BA) is a batched
  device call.  Shapes sent to the device are bucketed (next power of two)
  as in the JAX package, so both see the same padded problems.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..ba import problem as ba_problem


def bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two bucket >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class CameraModel:
    """Intrinsics block [f, k1, k2] (ref CameraModel::data, basic_structs.h:120)."""
    f: float
    k1: float = 0.0
    k2: float = 0.0
    f_hint: float = 0.0          # prior focal (EXIF or 1.2*max(w,h), ref camera.h)
    calibrated: bool = False     # if True, intrinsics frozen in BA

    def as_array(self):
        return np.array([self.f, self.k1, self.k2], np.float64)


@dataclass
class Track:
    """One 3D point's observations: img_idx -> kp_idx."""
    xyz: np.ndarray
    obs: Dict[int, int] = field(default_factory=dict)
    is_bad: bool = False
    is_new: bool = True


class Scene:
    """Mutable reconstruction state for one model (one pass of the outer loop)."""

    def __init__(self, n_images: int, idx_max_per_image: int = 1_000_000):
        self.n_images = n_images
        self.idx_max = idx_max_per_image
        # per-image registration state
        self.poses: Dict[int, np.ndarray] = {}          # img -> (6,)
        self.model_of_image: Dict[int, int] = {}        # img -> model idx
        self.models: List[CameraModel] = []
        self.tracks: List[Track] = []
        # per-image kp -> track index (-1 = unassigned), filled lazily
        self.kp_to_track: Dict[int, np.ndarray] = {}
        self.localization_failures: Dict[int, int] = {}
        # monotonically bumped whenever kp_to_track[img] changes structure
        # (new track / observation / cull); drivers key incremental
        # 2D-3D correspondence caches on it so the per-step next-image
        # scan is O(changed neighbourhood), not O(n_remaining * pairs)
        # (the reference re-harvests every remaining image every step,
        # sfm_incremental.cc:417-563 — quadratic over a run)
        self.k2t_version: Dict[int, int] = {}
        # flat observation log (track, img, kp), appended by add_track /
        # add_observation; to_ba_problem materializes from it with numpy
        # only (keep-LAST per (track, img) = the dict-overwrite semantics).
        self._obs_t: List[int] = []
        self._obs_i: List[int] = []
        self._obs_k: List[int] = []
        self._obs_np = None          # cached np conversion (prefix-stable)
        self._bad: List[bool] = []   # parallel to tracks (mark_bad syncs)

    def reset_tracks(self):
        """Drop all tracks (SLAM retriangulation rebuilds from scratch): the
        observation log, the bad mask and every keypoint's track index go
        with them."""
        self.tracks = []
        self._obs_t, self._obs_i, self._obs_k = [], [], []
        self._obs_np = None
        self._bad = []
        for img, k2t in self.kp_to_track.items():
            k2t.fill(-1)
            self._bump(img)

    def bad_mask(self) -> np.ndarray:
        """(n_tracks,) bool; True = culled."""
        return np.asarray(self._bad, bool) if self._bad \
            else np.zeros(0, bool)

    def _obs_arrays(self):
        """Numpy views of the observation log (cached; only the appended
        tail is converted on each call)."""
        n = len(self._obs_t)
        if self._obs_np is None:
            self._obs_np = (np.asarray(self._obs_t, np.int64),
                            np.asarray(self._obs_i, np.int64),
                            np.asarray(self._obs_k, np.int64))
        elif self._obs_np[0].shape[0] < n:
            m = self._obs_np[0].shape[0]
            self._obs_np = tuple(
                np.concatenate([old, np.asarray(lst[m:], np.int64)])
                for old, lst in zip(self._obs_np,
                                    (self._obs_t, self._obs_i, self._obs_k)))
        return self._obs_np

    # -- registration ------------------------------------------------------
    def add_camera_model(self, model: CameraModel) -> int:
        self.models.append(model)
        return len(self.models) - 1

    def register_image(self, img: int, pose: np.ndarray, model_idx: int,
                       n_kps: int):
        self.poses[img] = np.asarray(pose, np.float64)
        self.model_of_image[img] = model_idx
        if img not in self.kp_to_track:
            self.kp_to_track[img] = np.full(n_kps, -1, np.int64)
        self._bump(img)  # registration changes neighbours' harvests too

    @property
    def registered(self) -> List[int]:
        return sorted(self.poses.keys())

    def n_points(self) -> int:
        return sum(1 for t in self.tracks if not t.is_bad)

    # -- tracks ------------------------------------------------------------
    def _bump(self, img: int):
        self.k2t_version[img] = self.k2t_version.get(img, 0) + 1

    def add_track(self, xyz, obs: Dict[int, int]) -> int:
        t = Track(xyz=np.asarray(xyz, np.float64), obs=dict(obs))
        idx = len(self.tracks)
        self.tracks.append(t)
        self._bad.append(False)
        for img, kp in obs.items():
            self.kp_to_track[img][kp] = idx
            self._bump(img)
            self._obs_t.append(idx)
            self._obs_i.append(img)
            self._obs_k.append(int(kp))
        return idx

    def add_observation(self, track_idx: int, img: int, kp: int):
        self.tracks[track_idx].obs[img] = kp
        self.kp_to_track[img][kp] = track_idx
        self._bump(img)
        self._obs_t.append(track_idx)
        self._obs_i.append(img)
        self._obs_k.append(int(kp))

    def add_observations_bulk(self, track_idx: np.ndarray, img: int,
                              kp: np.ndarray):
        """Vectorized add_observation for many tracks of ONE image: one
        numpy scatter + one version bump instead of a Python loop."""
        track_idx = np.asarray(track_idx, np.int64)
        kp = np.asarray(kp, np.int64)
        for t, k in zip(track_idx.tolist(), kp.tolist()):
            self.tracks[t].obs[img] = k
        self.kp_to_track[img][kp] = track_idx
        self._bump(img)
        self._obs_t.extend(track_idx.tolist())
        self._obs_i.extend([img] * len(track_idx))
        self._obs_k.extend(kp.tolist())

    def mark_bad(self, track_idx: int):
        t = self.tracks[track_idx]
        t.is_bad = True
        self._bad[track_idx] = True
        for img, kp in t.obs.items():
            if self.kp_to_track[img][kp] == track_idx:
                self.kp_to_track[img][kp] = -1
                self._bump(img)

    # -- BAProblem materialization ----------------------------------------
    def to_ba_problem(self, kp_xy: Dict[int, np.ndarray], max_views: int = 16,
                      mutable_images=None, mutable_points=None,
                      weight_multiview: float = 1.0, dtype=np.float32,
                      images=None, tracks=None, *, device):
        """Build a fixed-shape BAProblem from the live tracks.

        Args:
          kp_xy: img -> (K, 2) centered keypoint coords.
          max_views: V cap; tracks keep their first V observations.
          mutable_images: iterable of image ids free to move (None = all,
            except gauge handling is the caller's job).
          mutable_points: None = all live points mutable.
          weight_multiview: weight for >=3-view tracks (ref :1012, 2.0 in
            partial BA).
          images: restrict the camera axis to these image ids (None = all
            registered).  Observations from excluded images are dropped.
          tracks: restrict the point axis to these track indices (None =
            all live tracks).  Together with `images` this materializes a
            LOCAL problem — partial BA over the step's covisible
            neighbourhood stays O(local) regardless of scene size.
          device: torch device of the returned problem.
        Returns (problem, index_maps) where index_maps maps problem rows back
        to scene track indices and camera image ids.
        """
        imgs = self.registered if images is None else sorted(images)
        img_to_row = {im: i for i, im in enumerate(imgs)}
        # Camera and model axes are bucketed like the point axis: padded
        # rows are frozen (pose_mut/intr_mut = 0) and unreferenced by any
        # track, so solve_lm's freeze mask makes them inert.
        C = bucket(len(imgs), 8)
        bad = self.bad_mask()
        if tracks is None:
            live = np.nonzero(~bad)[0].tolist()
        else:
            arr = np.unique(np.asarray(sorted(tracks), np.int64))
            live = arr[~bad[arr]].tolist() if arr.size else []
        P = bucket(max(len(live), 1))
        V = max_views

        poses = np.zeros((C, 6))
        poses[: len(imgs)] = np.stack([self.poses[im] for im in imgs])
        model_rows: Dict[int, int] = {}
        intrs_list = []
        cam_model = np.zeros(C, np.int32)
        for i, im in enumerate(imgs):
            mi = self.model_of_image[im]
            if mi not in model_rows:
                model_rows[mi] = len(intrs_list)
                intrs_list.append(self.models[mi].as_array())
            cam_model[i] = model_rows[mi]
        M = bucket(len(intrs_list), 4)
        intrs = np.tile(np.array([1.0, 0.0, 0.0]), (M, 1))
        intrs[: len(intrs_list)] = np.stack(intrs_list)

        points = np.zeros((P, 3))
        track_cam = np.zeros((P, V), np.int32)
        track_uv = np.zeros((P, V, 2))
        track_mask = np.zeros((P, V), bool)
        track_weight = np.ones((P,))
        point_mut = np.zeros((P,))

        mutable_img_set = set(imgs) if mutable_images is None else set(mutable_images)
        nl = len(live)
        if nl:
            live_arr = np.asarray(live, np.int64)
            points[:nl] = np.array([self.tracks[i].xyz for i in live])
            point_mut[:nl] = 1.0

            # observation harvest: pure numpy over the flat log
            t_all, i_all, k_all = self._obs_arrays()
            trow_of = np.full(len(self.tracks), -1, np.int64)
            trow_of[live_arr] = np.arange(nl)
            irow_of = np.full(self.n_images, -1, np.int64)
            irow_of[np.asarray(imgs, np.int64)] = np.arange(len(imgs))
            tr = trow_of[t_all]
            ir = irow_of[i_all]
            m = (tr >= 0) & (ir >= 0)
            pos = np.nonzero(m)[0]
            tr, ir, kp = tr[m], ir[m], k_all[m]
            # keep-LAST per (track, img): the Track.obs dict-overwrite
            # semantics (a re-matched keypoint replaces the old one)
            key = tr * len(imgs) + ir
            srt = np.lexsort((pos, key))
            key_s = key[srt]
            last = np.ones(len(srt), bool)
            if len(srt) > 1:
                last[:-1] = key_s[1:] != key_s[:-1]
            sel = srt[last]                     # track-major, img-minor
            tr2, ir2, kp2 = tr[sel], ir[sel], kp[sel]
            uniq, start, cnt = np.unique(tr2, return_index=True,
                                         return_counts=True)
            # V cap: spread kept views over the whole track with a per-row
            # rotation — slot kept iff slot in {(k*n//V + row) % n}, i.e.
            # u = (slot-row) % n has an integer k in [u*V/n, (u+1)*V/n)
            slot = np.arange(len(tr2)) - np.repeat(start, cnt)
            n_per = np.repeat(cnt, cnt)
            u = (slot - tr2) % n_per
            c1 = -(-(u * V) // n_per)
            c2 = -(-((u + 1) * V) // n_per)
            keep = (n_per <= V) | ((c1 < c2) & (c1 < V))
            tr3, ir3, kp3 = tr2[keep], ir2[keep], kp2[keep]
            uniq3, start3, cnt3 = np.unique(tr3, return_index=True,
                                            return_counts=True)
            vslot = np.arange(len(tr3)) - np.repeat(start3, cnt3)
            lens = np.fromiter((len(kp_xy[im]) for im in imgs), np.int64,
                               len(imgs))
            base = np.zeros(len(imgs) + 1, np.int64)
            np.cumsum(lens, out=base[1:])
            # reshape(-1, 2): empty per-image arrays may arrive as (0,)
            uv_all = (np.concatenate([np.asarray(kp_xy[im],
                                                 np.float64).reshape(-1, 2)
                                      for im in imgs])
                      if len(imgs) else np.zeros((0, 2)))
            track_cam[tr3, vslot] = ir3.astype(np.int32)
            track_uv[tr3, vslot] = uv_all[base[ir3] + kp3]
            track_mask[tr3, vslot] = True
            track_weight[uniq3[cnt3 >= 3]] = weight_multiview
            if mutable_points is not None:
                frozen = ~np.isin(live_arr,
                                  np.asarray(sorted(mutable_points),
                                             np.int64))
                point_mut[:nl][frozen] = 0.0

        pose_mut = np.zeros(C)
        pose_mut[: len(imgs)] = [1.0 if im in mutable_img_set else 0.0
                                 for im in imgs]
        intr_mut = np.zeros(M)
        for mi, rowm in model_rows.items():
            intr_mut[rowm] = 0.0 if self.models[mi].calibrated else 1.0
        # intrinsics of frozen cameras stay frozen too (partial BA semantics
        # handled by caller passing mutable_images per camera-model)

        prob = ba_problem.build_problem(
            poses.astype(dtype), intrs.astype(dtype), cam_model,
            points.astype(dtype), track_cam, track_uv.astype(dtype),
            track_mask, track_weight.astype(dtype), pose_mut.astype(dtype),
            intr_mut.astype(dtype), point_mut.astype(dtype), device=device)
        index_maps = {"images": imgs, "tracks": live,
                      "model_rows": model_rows}
        return prob, index_maps

    def update_from_ba(self, prob, index_maps):
        """Write optimized parameters back into the scene (ref UpdateParameters,
        optimizer.cc:142-153)."""
        poses = prob.poses.detach().cpu().numpy().astype(np.float64)
        intrs = prob.intrs.detach().cpu().numpy().astype(np.float64)
        points = prob.points.detach().cpu().numpy().astype(np.float64)
        for i, im in enumerate(index_maps["images"]):
            self.poses[im] = poses[i]
        for mi, rowm in index_maps["model_rows"].items():
            self.models[mi].f = float(intrs[rowm, 0])
            self.models[mi].k1 = float(intrs[rowm, 1])
            self.models[mi].k2 = float(intrs[rowm, 2])
        for row, ti in enumerate(index_maps["tracks"]):
            self.tracks[ti].xyz = points[row]

    # -- checkpoint / resume (ref WriteTempResultOut/ReadTempResultIn,
    #    sfm_incremental.cc:1465-1749) -----------------------------------
    def save(self, path: str):
        """Serialize the full model state to one .npz file.

        The reference checkpoints cam models, cameras, points, observation
        maps, and failure counters to temp_result{N}.txt every 10 images;
        this is the columnar equivalent.
        """
        imgs = self.registered
        obs_track, obs_img, obs_kp = [], [], []
        for ti, t in enumerate(self.tracks):
            for img, kp in t.obs.items():
                obs_track.append(ti)
                obs_img.append(img)
                obs_kp.append(kp)
        fail_imgs = np.asarray(sorted(self.localization_failures), np.int64)
        np.savez_compressed(
            path,
            n_images=self.n_images,
            idx_max=self.idx_max,
            imgs=np.asarray(imgs, np.int64),
            poses=np.stack([self.poses[i] for i in imgs]) if imgs else
            np.zeros((0, 6)),
            model_of_image=np.asarray([self.model_of_image[i] for i in imgs],
                                      np.int64),
            kp_counts=np.asarray([len(self.kp_to_track[i]) for i in imgs],
                                 np.int64),
            models=np.asarray([[m.f, m.k1, m.k2, m.f_hint,
                                float(m.calibrated)] for m in self.models],
                              np.float64).reshape(len(self.models), 5),
            xyz=np.stack([t.xyz for t in self.tracks]) if self.tracks else
            np.zeros((0, 3)),
            is_bad=np.asarray([t.is_bad for t in self.tracks], bool),
            obs_track=np.asarray(obs_track, np.int64),
            obs_img=np.asarray(obs_img, np.int64),
            obs_kp=np.asarray(obs_kp, np.int64),
            fail_imgs=fail_imgs,
            fail_counts=np.asarray([self.localization_failures[i]
                                    for i in fail_imgs], np.int64),
        )

    @classmethod
    def load(cls, path: str) -> "Scene":
        """Rebuild a Scene from a save() checkpoint."""
        with np.load(path) as f:
            z = {k: f[k] for k in f.files}
        scene = cls(int(z["n_images"]), int(z["idx_max"]))
        for row in z["models"]:
            scene.add_camera_model(CameraModel(
                f=float(row[0]), k1=float(row[1]), k2=float(row[2]),
                f_hint=float(row[3]), calibrated=bool(row[4])))
        imgs = z["imgs"]
        for r, img in enumerate(imgs):
            scene.register_image(int(img), z["poses"][r],
                                 int(z["model_of_image"][r]),
                                 int(z["kp_counts"][r]))
        xyz = z["xyz"]
        is_bad = z["is_bad"]
        obs_by_track: Dict[int, Dict[int, int]] = {}
        for ti, img, kp in zip(z["obs_track"], z["obs_img"], z["obs_kp"]):
            obs_by_track.setdefault(int(ti), {})[int(img)] = int(kp)
        for ti in range(len(xyz)):
            idx = scene.add_track(xyz[ti], obs_by_track.get(ti, {}))
            if bool(is_bad[ti]):
                scene.mark_bad(idx)
        for img, cnt in zip(z["fail_imgs"], z["fail_counts"]):
            scene.localization_failures[int(img)] = int(cnt)
        return scene
