"""Point undistortion via polynomial root finding.

Counterpart of metricsfm_tpu/utils/calibration.py (re-design of
SfM/src/utils/calibration.{h,cc}): invert the radial model
r_d = r_u (1 + k1 r_u^2 + k2 r_u^4) exactly by solving the quintic in r_u
with the Durand-Kerner finder (ops/polynomial.py), one coefficient row a
radius, all rows at once.  ops/projection.undistort_radial is the fast
fixed-point alternative used in the hot path.
"""
from __future__ import annotations

import torch

from ..ops import polynomial


def undistort_radius(r_d, k1, k2, iters: int = 80):
    """Solve k2 r^5 + k1 r^3 + r - r_d = 0 for the positive real root
    nearest r_d.

    r_d: a tensor (any shape, computed on its device) or a scalar; k1, k2
    scalars or tensors broadcastable to r_d.  Returns r_u shaped as r_d.
    """
    rd_in = torch.as_tensor(r_d)
    rd = rd_in.to(torch.float32).reshape(-1)
    dev = rd.device
    a1 = torch.as_tensor(k1, dtype=torch.float32, device=dev)
    a2 = torch.as_tensor(k2, dtype=torch.float32, device=dev)
    a1 = torch.broadcast_to(a1, rd_in.shape).reshape(-1)
    a2 = torch.broadcast_to(a2, rd_in.shape).reshape(-1)
    zeros = torch.zeros_like(rd)
    coeffs = torch.stack([a2, zeros, a1, zeros, torch.ones_like(rd), -rd],
                         dim=-1)                                  # (n, 6)
    roots, is_real = polynomial.real_roots(coeffs, iters)         # (n, 5)
    score = torch.where(is_real & (roots > 0),
                        torch.abs(roots - rd[:, None]), torch.inf)
    best = torch.argmin(score, dim=-1, keepdim=True)
    return torch.gather(roots, -1, best)[:, 0].reshape(rd_in.shape)


def undistort_points_exact(xy_d, k1, k2):
    """Undistort centered normalized points (..., 2) via the exact radial
    inverse."""
    r_d = torch.linalg.norm(xy_d, dim=-1)
    r_u = undistort_radius(r_d, k1, k2)
    scale = torch.where(r_d > 1e-9, r_u / torch.clamp(r_d, min=1e-9), 1.0)
    return xy_d * scale[..., None]
