"""Camera model and projection.

Counterpart of metricsfm_tpu/ops/projection.py (the reference data model,
SfM/src/basic_structs.h:48-145, camera.{h,cc}, structure.cc:267-300):

* Pose is a 6-vector ``[aa(3), t(3)]`` (world->camera), the reference's
  ``Camera::data`` BA block (camera.h:79).
* Intrinsics are ``[f, k1, k2]`` (``CameraModel::data``, basic_structs.h:120).
* Observations are *centered* at the principal point (database.cc:522-527).
* Projection follows reprojection_error_pose_cam_xyz.h:40-63:
  ``pred = f * (1 + r2*(k1 + k2*r2)) * (x/z, y/z)`` with +z forward.

Everything broadcasts over leading axes.
"""
from __future__ import annotations

import torch

from . import lie

_EPS = 1e-12


def pose_from_Rt(R, t):
    """(R, t) world->cam  ->  6-vector [angle_axis, t]."""
    return torch.cat([lie.matrix_to_angle_axis(R), t], dim=-1)


def pose_to_Rt(pose):
    return lie.angle_axis_to_matrix(pose[..., :3]), pose[..., 3:6]


def camera_center(pose):
    """c = -R^T t (the reference's ACPose.c, camera.cc:67-77)."""
    R, t = pose_to_Rt(pose)
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def pose_from_center(aa, c):
    """Angle-axis + camera center -> [aa, t] with t = -R c."""
    R = lie.angle_axis_to_matrix(aa)
    t = -(R @ c[..., None])[..., 0]
    return torch.cat([aa, t], dim=-1)


def compose_relative(pose_ref, rel):
    """World pose from a reference pose and a relative pose:
    R = R_rel R_ref, t = R_rel t_ref + t_rel (reference camera.cc:55-65)."""
    R_ref, t_ref = pose_to_Rt(pose_ref)
    R_rel, t_rel = pose_to_Rt(rel)
    R = R_rel @ R_ref
    t = (R_rel @ t_ref[..., None])[..., 0] + t_rel
    return pose_from_Rt(R, t)


def transform_to_camera(pose, points):
    """World -> camera frame: p = R x + t, via direct angle-axis rotation."""
    return lie.rotate_point(pose[..., :3], points) + pose[..., 3:6]


def distort_radial(xn, k1, k2):
    """Apply radial distortion factor (1 + r2*(k1 + k2*r2)) to normalized coords."""
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    factor = 1.0 + r2 * (k1[..., None] + k2[..., None] * r2)
    return xn * factor


def undistort_radial(xd, k1, k2, iters: int = 8):
    """Invert the radial model by fixed-point iteration
    x <- xd / distortion(|x|^2) (replaces utils/calibration.cc:17-19)."""
    x = xd
    for _ in range(iters):
        r2 = torch.sum(x * x, dim=-1, keepdim=True)
        factor = 1.0 + r2 * (k1[..., None] + k2[..., None] * r2)
        x = xd / torch.clamp(factor, min=1e-6)
    return x


def project(pose, intr, points):
    """Project world points into centered pixel coordinates.

    pose (..., 6) [aa, t] world->camera, intr (..., 3) [f, k1, k2],
    points (..., 3).  Returns (uv (..., 2), depth (...,)).
    """
    p = transform_to_camera(pose, points)
    z = p[..., 2]
    zsafe = torch.where(torch.abs(z) < _EPS, _EPS, z)
    xn = p[..., :2] / zsafe[..., None]
    xd = distort_radial(xn, intr[..., 1], intr[..., 2])
    uv = intr[..., 0, None] * xd
    return uv, z


def reprojection_residual(pose, intr, points, obs, weight=None):
    """Per-observation residual weight*(pred - obs), shape (..., 2)
    (reprojection_error_pose_cam_xyz.h:40-69)."""
    uv, _ = project(pose, intr, points)
    r = uv - obs
    if weight is not None:
        r = r * weight[..., None]
    return r


def reprojection_mse(pose, intr, points, obs, mask=None):
    """Mean squared reprojection error in px^2 (structure.cc:267-300)."""
    uv, _ = project(pose, intr, points)
    err2 = torch.sum((uv - obs) ** 2, dim=-1)
    if mask is None:
        return torch.mean(err2)
    w = mask.to(err2.dtype)
    return torch.sum(err2 * w) / torch.clamp(torch.sum(w), min=1.0)


def backproject_ray(pose, intr, uv):
    """Centered pixel -> (origin, world unit direction), structure.cc:219-224.
    Ignores distortion, like the reference's Trianglate2."""
    f = intr[..., 0]
    dir_c = torch.cat([uv, f[..., None].expand(uv[..., :1].shape)], dim=-1)
    R, _ = pose_to_Rt(pose)
    dir_w = (R.transpose(-1, -2) @ dir_c[..., None])[..., 0]
    dir_w = dir_w / torch.clamp(torch.linalg.norm(dir_w, dim=-1, keepdim=True),
                                min=_EPS)
    return camera_center(pose), dir_w


def intrinsic_matrix(intr):
    """K for centered coordinates: diag(f, f, 1)."""
    f = intr[..., 0]
    zero = torch.zeros_like(f)
    one = torch.ones_like(f)
    return torch.stack([torch.stack([f, zero, zero], dim=-1),
                        torch.stack([zero, f, zero], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def projection_matrix(pose, intr):
    """P = K [R | t], (..., 3, 4) (reference camera.cc:89-137)."""
    R, t = pose_to_Rt(pose)
    return intrinsic_matrix(intr) @ torch.cat([R, t[..., None]], dim=-1)


def apply_similarity_to_pose(pose, s, R_s, t_s):
    """Update a world->cam pose under a world similarity x' = s R_s x + t_s
    (reference camera.cc:79-87)."""
    R, t = pose_to_Rt(pose)
    R_new = R @ R_s.transpose(-1, -2)
    t_new = s * t - (R_new @ t_s[..., None])[..., 0]
    return pose_from_Rt(R_new, t_new)
