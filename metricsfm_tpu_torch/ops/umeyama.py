"""Weighted rigid / similarity alignment (Umeyama).

Counterpart of metricsfm_tpu/ops/umeyama.py (the reference's
utils/transformation.cpp:49-216): solves
argmin sum_i w_i |dst_i - (s R src_i + t)|^2.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def similarity_align(src, dst, weights=None, with_scale=True):
    """Weighted Umeyama alignment.

    src, dst (..., N, 3); weights (..., N) nonnegative (0 masks a pair).
    Returns (s (...,), R (..., 3, 3), t (..., 3)) with dst ~= s R src + t.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=_EPS)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    # weighted covariance dst <- src
    Sigma = (cd * w[..., None]).transpose(-1, -2) @ cs
    U, D, Vt = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    one = torch.ones_like(det)
    S = torch.stack([one, one, torch.sign(det)], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        var_s = torch.sum(w * torch.sum(cs * cs, dim=-1), dim=-1)
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=_EPS)
    else:
        s = one
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def rigid_align(src, dst, weights=None):
    """Weighted rigid (s=1) alignment — reference RigidTransformation."""
    return similarity_align(src, dst, weights, with_scale=False)


def align_residuals(src, dst, s, R, t):
    """Per-point residual norms after applying the transform."""
    pred = s[..., None, None] * (src @ R.transpose(-1, -2)) + t[..., None, :]
    return torch.linalg.norm(dst - pred, dim=-1)
