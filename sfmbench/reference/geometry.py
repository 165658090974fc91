"""Plain camera geometry of the yardstick: Rodrigues rotations, the
[f, k1, k2] radial pinhole of the upstream reprojection functor
(pred = f (1 + k1 r^2 + k2 r^4) (x/z, y/z), centred pixels), and its
analytic derivatives.

Plain PyTorch, written for the benchmark: it shares no code with the
program.  Products of small matrices go through `mm`, which the control
swaps for one that rounds its operands to TF32.
"""
from __future__ import annotations

import torch


def mm(a, b):
    return torch.matmul(a, b)


def round_tf32(x):
    """Round float32 values to TF32's 11 significant bits (nearest even),
    as the tensor cores read a TF32 product's operands."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)


def mm_tf32(a, b):
    return torch.matmul(round_tf32(a), round_tf32(b))


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(aa):
    """sin(t)/t, (1-cos t)/t^2, (t-sin t)/t^3 of t = |aa|, with Taylor
    series near 0."""
    t2 = (aa * aa).sum(dim=-1)[..., None, None]
    t = torch.sqrt(t2)
    small = t2 < 1e-6
    ts = torch.where(small, torch.ones_like(t), t)
    a = torch.where(small, 1 - t2 / 6, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(ts)) / ts ** 2)
    c = torch.where(small, 1.0 / 6 - t2 / 120, (ts - torch.sin(ts)) / ts ** 3)
    return a, b, c


def rotation(aa, mm=mm):
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3)."""
    K = hat(aa)
    a, b, _ = _coeffs(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + a * K + b * mm(K, K)


def right_jacobian(aa, mm=mm):
    """J_r with R(aa + d) = R(aa) Exp(J_r(aa) d) to first order."""
    K = hat(aa)
    _, b, c = _coeffs(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye - b * K + c * mm(K, K)


def project_all(R, t, intr, X):
    """Every point (n, 3) in every camera (C): centred pixels (n, C, 2)
    and depths (n, C)."""
    p = torch.einsum("cij,nj->nci", R, X) + t[None]
    z = p[..., 2]
    xn = p[..., :2] / z[..., None]
    r2 = (xn * xn).sum(dim=-1, keepdim=True)
    return intr[0] * (1 + r2 * (intr[1] + intr[2] * r2)) * xn, z


def residuals(R, t, intr, X, uv, mm=mm):
    """Per-observation residuals (N, 2) of rotations R (N, 3, 3),
    translations t (N, 3), one intrinsics row [f, k1, k2] (N, 3) each,
    points X (N, 3) against observations uv (N, 2)."""
    p = mm(R, X[:, :, None])[:, :, 0] + t
    xn = p[:, :2] / p[:, 2:3]
    r2 = (xn * xn).sum(dim=1, keepdim=True)
    d = 1 + r2 * (intr[:, 1:2] + intr[:, 2:3] * r2)
    return intr[:, 0:1] * d * xn - uv


def jacobians(aa, R, t, intr, X, uv, mm=mm):
    """Residuals (N, 2) and their derivatives by the camera's 9
    parameters [angle-axis, t, f, k1, k2] (N, 2, 9) and the point's 3
    (N, 2, 3), with the pose updated additively in angle-axis."""
    p = mm(R, X[:, :, None])[:, :, 0] + t
    z = p[:, 2:3]
    xn = p[:, :2] / z
    r2 = (xn * xn).sum(dim=1, keepdim=True)
    f, k1, k2 = intr[:, 0:1], intr[:, 1:2], intr[:, 2:3]
    d = 1 + r2 * (k1 + k2 * r2)
    res = f * d * xn - uv
    # d uv / d xn = f (d I + xn (dd/dxn)^T), dd/dxn = 2 (k1 + 2 k2 r2) xn
    dd = 2 * (k1 + 2 * k2 * r2) * xn
    eye2 = torch.eye(2, dtype=p.dtype, device=p.device)
    du_dxn = f[:, :, None] * (d[:, :, None] * eye2 + xn[:, :, None]
                              * dd[:, None, :])
    zero = torch.zeros_like(z[:, 0])
    iz = 1 / z[:, 0]
    dxn_dp = torch.stack([torch.stack([iz, zero, -xn[:, 0] * iz], -1),
                          torch.stack([zero, iz, -xn[:, 1] * iz], -1)], -2)
    du_dp = mm(du_dxn, dxn_dp)                                    # (N,2,3)
    # d(R X)/d aa = -R [X]x J_r(aa)
    dp_daa = -mm(mm(R, hat(X)), right_jacobian(aa, mm))
    J_cam = torch.cat([mm(du_dp, dp_daa), du_dp,
                       (d * xn)[:, :, None], (f * r2 * xn)[:, :, None],
                       (f * r2 * r2 * xn)[:, :, None]], dim=2)
    J_pt = mm(du_dp, R)
    return res, J_cam, J_pt
