"""Bundle-adjustment problem representation.

Counterpart of metricsfm_tpu/ba/problem.py (the reference's pointer-graph
problem construction, SfM/src/optimizer.cc:62-129, as fixed-shape masked
tensors):

* A track tensor of shape (P, V) holds, per 3D point, up to V observing
  views (camera index, centered uv, mask) — structure.h:64-67.
* Mutability masks replace the functor matrix (optimizer.cc:86-125):
  pose_mut (C,), intr_mut (M,), point_mut (P,).
* Shared vs per-image camera models: the cam_model map (C,) -> M blocks.
* Camera-indexed prior terms, each off at weight 0 (the default): GPS
  camera-center anchors, full 6-dof pose priors and GPS relative
  constraints over camera triples.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie

CORE_FIELDS = ("poses", "intrs", "cam_model", "points", "track_cam",
               "track_uv", "track_mask", "track_weight", "pose_mut",
               "intr_mut", "point_mut")
PRIOR_FIELDS = ("gps_pos", "gps_weight", "pose_prior", "pose_prior_weight",
                "gps_triple", "gps_triple_weight")


class BAProblem(NamedTuple):
    """Static-shape BA problem of tensors on one device.

    Shapes: C cameras, M camera models, P points, V max views per track.
    """
    poses: torch.Tensor        # (C, 6)  [angle-axis, t] world->cam
    intrs: torch.Tensor        # (M, 3)  [f, k1, k2]
    cam_model: torch.Tensor    # (C,)    int64 camera -> model index
    points: torch.Tensor       # (P, 3)
    track_cam: torch.Tensor    # (P, V)  int64 camera index (0 where masked)
    track_uv: torch.Tensor     # (P, V, 2) centered pixel observations
    track_mask: torch.Tensor   # (P, V)  bool
    track_weight: torch.Tensor  # (P,)   per-track residual weight (ref :1012)
    pose_mut: torch.Tensor     # (C,)   1.0 = free, 0.0 = frozen
    intr_mut: torch.Tensor     # (M,)
    point_mut: torch.Tensor    # (P,)
    # GPS camera-center anchors (ref gps_error_pose_absolute.h): residual
    # gps_weight * (camera_center(pose) - gps_pos); per-axis weights
    gps_pos: torch.Tensor      # (C, 3)
    gps_weight: torch.Tensor   # (C, 3)
    # full 6-dof pose priors (ref cam_error_pose_absolute.h): residual
    # pose_prior_weight * (pose - pose_prior)
    pose_prior: torch.Tensor         # (C, 6)
    pose_prior_weight: torch.Tensor  # (C, 6)
    # GPS relative constraints over camera triples (i, j, k) (ref
    # gps_error_pose_raletive_angle.h / _dis.h): w0 * (cos angle_est -
    # cos angle_gps) at j, w1 * (ratio_est - ratio_gps) of |ci-cj|/|cj-ck|
    gps_triple: torch.Tensor         # (T, 3) int64 camera indices
    gps_triple_weight: torch.Tensor  # (T, 2) [angle_w, dist_w]

    @property
    def n_cameras(self):
        return self.poses.shape[0]

    @property
    def n_models(self):
        return self.intrs.shape[0]

    @property
    def n_points(self):
        return self.points.shape[0]

    @property
    def max_views(self):
        return self.track_cam.shape[1]

    @property
    def n_camera_dofs(self):
        return 6 * self.n_cameras + 3 * self.n_models

    def n_observations(self):
        return torch.sum(self.track_mask.to(torch.int64))


def build_problem(poses, intrs, cam_model, points, track_cam, track_uv,
                  track_mask, track_weight=None, pose_mut=None, intr_mut=None,
                  point_mut=None, gps_pos=None, gps_weight=None,
                  pose_prior=None, pose_prior_weight=None, gps_triple=None,
                  gps_triple_weight=None, *, device,
                  dtype=torch.float32) -> BAProblem:
    """Assemble a BAProblem from host arrays on `device`, filling default
    masks; every prior term defaults to weight 0 (one zero-weight
    placeholder triple)."""
    def to_t(a, dt):
        if torch.is_tensor(a):
            return a.to(device=device, dtype=dt)
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    def f(a):
        return to_t(a, dtype)

    def i(a):
        return to_t(a, torch.int64)

    poses, intrs, points = f(poses), f(intrs), f(points)
    C, M, P = poses.shape[0], intrs.shape[0], points.shape[0]

    def ones_or(a, n):
        return torch.ones((n,), dtype=dtype, device=device) if a is None \
            else f(a)

    def zeros_or(a, *shape):
        return torch.zeros(shape, dtype=dtype, device=device) if a is None \
            else f(a)

    return BAProblem(
        poses=poses, intrs=intrs, cam_model=i(cam_model), points=points,
        track_cam=i(track_cam), track_uv=f(track_uv),
        track_mask=to_t(track_mask, torch.bool),
        track_weight=ones_or(track_weight, P),
        pose_mut=ones_or(pose_mut, C), intr_mut=ones_or(intr_mut, M),
        point_mut=ones_or(point_mut, P),
        gps_pos=zeros_or(gps_pos, C, 3),
        gps_weight=zeros_or(gps_weight, C, 3),
        pose_prior=zeros_or(pose_prior, C, 6),
        pose_prior_weight=zeros_or(pose_prior_weight, C, 6),
        gps_triple=torch.zeros((1, 3), dtype=torch.int64, device=device)
        if gps_triple is None else i(gps_triple),
        gps_triple_weight=zeros_or(gps_triple_weight, 1, 2))


def from_numpy(arrays, device, dtype=torch.float32) -> BAProblem:
    """The port's BAProblem from a dict of numpy arrays, e.g. a JAX
    ``BAProblem._asdict()`` brought to the host; absent prior fields take
    their zero-weight defaults."""
    return build_problem(**{k: arrays[k] for k in CORE_FIELDS},
                         **{k: arrays.get(k) for k in PRIOR_FIELDS},
                         device=device, dtype=dtype)


def to_numpy(problem: BAProblem) -> dict:
    """Host copy of every field (one transfer per field)."""
    return {k: v.detach().cpu().numpy() for k, v in problem._asdict().items()}


def normalize_problem(problem: BAProblem, target_scale: float = 100.0):
    """Recentre points at the median and rescale the mean absolute deviation
    to target_scale (reference BundleAdjuster::Normalize, optimizer.cc:
    155-195).  Returns (problem, (center, s)) so callers can undo it."""
    m = problem.track_mask.any(dim=1)
    w = m.to(problem.points.dtype)
    pts = torch.where(m[:, None], problem.points, torch.nan)
    # numpy-style median (mean of the two middle values), NaNs skipped
    med = torch.nanquantile(pts, 0.5, dim=0)
    dev = torch.sum(torch.abs(problem.points - med), dim=-1)
    mad = torch.sum(dev * w) / torch.clamp(torch.sum(w), min=1.0)
    s = target_scale / torch.clamp(mad, min=1e-8)

    new_points = (problem.points - med) * s
    # x' = s (x - med): R x + t = (1/s)(R x' + s (t + R med))
    R = lie.angle_axis_to_matrix(problem.poses[:, :3])
    t = problem.poses[:, 3:6]
    t_new = s * (t + R @ med)
    new_poses = torch.cat([problem.poses[:, :3], t_new], dim=-1)
    return problem._replace(points=new_points, poses=new_poses,
                            gps_pos=(problem.gps_pos - med) * s), (med, s)


def denormalize_problem(problem: BAProblem, transform):
    """Undo normalize_problem."""
    med, s = transform
    new_points = problem.points / s + med
    R = lie.angle_axis_to_matrix(problem.poses[:, :3])
    t_new = problem.poses[:, 3:6] / s - R @ med
    new_poses = torch.cat([problem.poses[:, :3], t_new], dim=-1)
    return problem._replace(points=new_points, poses=new_poses,
                            gps_pos=problem.gps_pos / s + med)


def perturb_problem(problem: BAProblem, generator, sigma_rot=0.1,
                    sigma_t=0.5, sigma_pt=0.5):
    """Gaussian perturbation of the seed reconstruction
    (reference BundleAdjuster::Perturb, optimizer.cc:197-232)."""
    def normal(shape):
        return torch.randn(shape, generator=generator,
                           dtype=problem.points.dtype,
                           device=problem.points.device)

    C = problem.n_cameras
    d_pose = torch.cat([sigma_rot * normal((C, 3)), sigma_t * normal((C, 3))],
                       dim=-1)
    return problem._replace(poses=problem.poses + d_pose,
                            points=problem.points
                            + sigma_pt * normal(problem.points.shape))
