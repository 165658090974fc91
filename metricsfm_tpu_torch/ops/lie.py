"""SO(3) parameterizations: rotation matrix <-> angle-axis <-> quaternion <-> Euler.

Counterpart of metricsfm_tpu/ops/lie.py (the reference's rotation
conversions, SfM/src/utils/basic_funcs.h:201-219, camera.cc:43-137).  All
functions are batched over leading axes and numerically safe at the
theta -> 0 limit via Taylor expansions (the BA Jacobians differentiate
through them).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def hat(w):
    """Skew-symmetric matrix of a 3-vector: hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def angle_axis_to_matrix(aa):
    """Rodrigues formula with small-angle Taylor fallback.

    R = I + sin(t)/t * hat(aa) + (1-cos(t))/t^2 * hat(aa)^2, t = |aa|.
    """
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]  # (...,1,1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = hat(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def matrix_to_angle_axis(R):
    """Log map SO(3) -> R^3 via quaternion (stable near 0 and pi)."""
    return quaternion_to_angle_axis(matrix_to_quaternion(R))


def matrix_to_quaternion(R):
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free
    four-candidate construction (Shepperd), selected per element."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    sw = safe_sqrt(qw2) * 2.0
    cand_w = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                          (m10 - m01) / sw], dim=-1)
    sx = safe_sqrt(qx2) * 2.0
    cand_x = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                          (m02 + m20) / sx], dim=-1)
    sy = safe_sqrt(qy2) * 2.0
    cand_y = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                          (m12 + m21) / sy], dim=-1)
    sz = safe_sqrt(qz2) * 2.0
    cand_z = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz,
                          (m12 + m21) / sz, 0.25 * sz], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)                       # (...)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (...,4,4)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quaternion_to_angle_axis(q):
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 => theta in [0, pi]
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vnorm[..., 0], w)[..., None]
    # aa = theta * v / |v|; small-angle: 2*v (since q ~ [1, aa/2])
    scale = torch.where(vnorm < 1e-6, 2.0,
                        theta / torch.clamp(vnorm, min=_EPS))
    return v * scale


def angle_axis_to_quaternion(aa):
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-6
    s = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=_EPS))
    w = torch.where(small, 1.0 - half * half / 2.0, torch.cos(half))
    return torch.cat([w, aa * s], dim=-1)


def rotate_point(aa, p):
    """Rotate p by the rotation whose angle-axis is aa, without forming R
    (Ceres AngleAxisRotatePoint semantics, the reference's residual
    functors, utils/reprojection_error_pose_cam_xyz.h:36).  Differentiable
    at theta = 0."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    axis = aa / theta
    w_cross_p = _cross(axis, p)
    w_dot_p = torch.sum(axis * p, dim=-1, keepdim=True)
    rotated = p * cos_t + w_cross_p * sin_t + axis * w_dot_p * (1.0 - cos_t)
    approx = p + _cross(aa, p)
    return torch.where(small, approx, rotated)


def euler_zyx_to_matrix(euler):
    """Euler (roll=x, pitch=y, yaw=z) -> R = Rz @ Ry @ Rx."""
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    row0 = torch.stack([cz * cy, cz * sy * sx - sz * cx,
                        cz * sy * cx + sz * sx], dim=-1)
    row1 = torch.stack([sz * cy, sz * sy * sx + cz * cx,
                        sz * sy * cx - cz * sx], dim=-1)
    row2 = torch.stack([-sy, cy * sx, cy * cx], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_zyx(R):
    sy = -R[..., 2, 0]
    pitch = torch.asin(torch.clamp(sy, -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_xyz_to_matrix(euler):
    """Euler (rx, ry, rz) -> R = Rx @ Ry @ Rz (the reference's
    EulerAnglesToRotationMatrix, SfM/src/utils/basic_funcs.cc:245-249)."""
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    row0 = torch.stack([cy * cz, -cy * sz, sy], dim=-1)
    row1 = torch.stack([cx * sz + sx * sy * cz, cx * cz - sx * sy * sz,
                        -sx * cy], dim=-1)
    row2 = torch.stack([sx * sz - cx * sy * cz, sx * cz + cx * sy * sz,
                        cx * cy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_xyz(R):
    """Inverse of euler_xyz_to_matrix (RotationMatrixToEulerAngles)."""
    rx = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    ry = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    rz = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([rx, ry, rz], dim=-1)


def project_to_so3(M):
    """Nearest rotation matrix (Frobenius) via SVD with det correction."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt

