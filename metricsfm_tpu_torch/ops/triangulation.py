"""Multi-view triangulation.

Counterpart of metricsfm_tpu/ops/triangulation.py (the reference Point3D
triangulators, SfM/src/structure.cc:163-265, and the parallax gate,
structure.cc:325-355).  A track of up to V views is (poses (V, 6), intrs
(V, 3), obs (V, 2), mask (V,)); every function takes leading track axes,
so a step's new points are one batched call.
"""
from __future__ import annotations

import math

import torch

from . import projection

_EPS = 1e-10


def triangulate_dlt(poses, intrs, obs, mask):
    """Masked multiview DLT (reference Trianglate, structure.cc:163-209)
    via the 4x4 normal equations; poses (..., V, 6) -> xyz (..., 3)."""
    R, t = projection.pose_to_Rt(poses)
    M = torch.cat([R, t[..., None]], dim=-1)                    # (...,V,3,4)
    f = intrs[..., 0]
    x, y = obs[..., 0], obs[..., 1]
    row0 = -f[..., None] * M[..., 1, :] + y[..., None] * M[..., 2, :]
    row1 = f[..., None] * M[..., 0, :] - x[..., None] * M[..., 2, :]
    A = torch.cat([row0, row1], dim=-2)                         # (...,2V,4)
    m = torch.cat([mask, mask], dim=-1).to(A.dtype)[..., None]
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=_EPS)
    A = A * m
    _, V4 = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    h = V4[..., :, 0]
    w = torch.where(torch.abs(h[..., 3]) < _EPS, _EPS, h[..., 3])
    return h[..., :3] / w[..., None]


def triangulate_midpoint(poses, intrs, obs, mask):
    """Masked ray-midpoint triangulation (reference Trianglate2,
    structure.cc:211-265): solve sum_i (I - d_i d_i^T) X = sum_i (I - d_i
    d_i^T) o_i; poses (..., V, 6) -> xyz (..., 3)."""
    origins, dirs = projection.backproject_ray(poses, intrs, obs)
    m = mask.to(poses.dtype)[..., None, None]
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device)
    P = (eye - dirs[..., :, None] * dirs[..., None, :]) * m     # (...,V,3,3)
    A = torch.sum(P, dim=-3) + 1e-8 * eye
    b = torch.sum((P @ origins[..., None])[..., 0], dim=-2)
    return torch.linalg.solve(A, b)


def triangulation_angle_deg(poses, xyz, mask):
    """Max pairwise parallax angle (deg) between viewing rays to xyz."""
    centers = projection.camera_center(poses)                  # (...,V,3)
    rays = xyz[..., None, :] - centers
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True),
                              min=_EPS)
    cosang = torch.clamp(rays @ rays.transpose(-1, -2), -1.0, 1.0)
    ang = torch.acos(cosang) * (180.0 / math.pi)
    m = mask.to(poses.dtype)
    pair_mask = m[..., :, None] * m[..., None, :]
    ang = torch.where(pair_mask > 0, ang, 0.0)
    return torch.amax(ang, dim=(-2, -1))


def track_reprojection_mse(poses, intrs, obs, mask, xyz):
    """Per-track masked reprojection MSE in px^2 (structure.cc:267-300)."""
    uv, _ = projection.project(poses, intrs, xyz[..., None, :])
    err2 = torch.sum((uv - obs) ** 2, dim=-1)
    w = mask.to(err2.dtype)
    return torch.sum(err2 * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1),
                                                     min=1.0)


def cheirality_mask(poses, xyz, mask):
    """Views where the point is in front of the camera (z > 0)."""
    z = projection.transform_to_camera(poses, xyz[..., None, :])[..., 2]
    return (mask > 0) & (z > 0)


def triangulate_and_gate(poses, intrs, obs, mask, th_error_px, th_angle_deg,
                         method: str = "midpoint"):
    """Triangulate tracks and apply the reference acceptance gates: RMSE <=
    th_error_px AND parallax >= th_angle_deg AND >= 2 valid views AND
    cheirality in all valid views.  Returns (xyz, ok, mse)."""
    tri = triangulate_midpoint if method == "midpoint" else triangulate_dlt
    xyz = tri(poses, intrs, obs, mask)
    mse = track_reprojection_mse(poses, intrs, obs, mask, xyz)
    angle = triangulation_angle_deg(poses, xyz, mask)
    nviews = torch.sum(mask.to(torch.int32), dim=-1)
    front = cheirality_mask(poses, xyz, mask)
    all_front = torch.sum(front.to(torch.int32), dim=-1) == nviews
    ok = (torch.sqrt(mse) <= th_error_px) & (angle >= th_angle_deg) \
        & (nviews >= 2) & all_front
    return xyz, ok, mse


def triangulate_tracks(poses, intrs, obs, mask, th_error_px, th_angle_deg,
                       method: str = "midpoint"):
    """(P, V, ...) track tensors -> (xyz (P, 3), ok (P,), mse (P,))."""
    return triangulate_and_gate(poses, intrs, obs, mask, th_error_px,
                                th_angle_deg, method)


def triangulate_tracks_indexed(pose_table, intr_table, cam_idx, obs, mask,
                               th_error_px, th_angle_deg,
                               method: str = "midpoint"):
    """triangulate_tracks with per-view poses/intrs gathered from small
    (R, 6)/(R, 3) tables by (P, V) camera rows."""
    cam_idx = cam_idx.long()
    return triangulate_and_gate(pose_table[cam_idx], intr_table[cam_idx],
                                obs, mask, th_error_px, th_angle_deg, method)
