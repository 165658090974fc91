"""Homography estimation (DLT + batched RANSAC).

Counterpart of metricsfm_tpu/ops/homography.py: the reference's homography
gating in windowed video matching (slam_gps.cc:312-555 prior-H gate) and
planar-degeneracy checks.  Convention: x2 ~ H x1 (centered pixels).  Every
function takes leading pair axes, like ransac.fundamental_ransac, so one
call estimates the homographies of a whole batch of pairs.
"""
from __future__ import annotations

import torch

from .epipolar import (_homog, _nullvec_minimal, _smallest_right_singular,
                       normalize_points)
from .ransac import _gather_rows, _sample_indices


def homography_dlt(pts1, pts2, weights=None, exact: bool = True):
    """Normalized DLT homography from >=4 correspondences (..., N, 2),
    optionally row-weighted (..., N); returns H / |H[2, 2]|.
    exact=True: the smallest eigenvector of A^T A (eigh); exact=False:
    the unrolled-Householder null vector of the 8 x 9 system of a minimal
    4-point sample (plain batched arithmetic, for RANSAC hypotheses:
    cuSOLVER's batched eigh failed on the card at 65,536 9 x 9
    matrices); larger systems take the exact path."""
    p1n, T1 = normalize_points(pts1)
    p2n, T2 = normalize_points(pts2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    # rows: [-x1 -y1 -1 0 0 0 x2x1 x2y1 x2], [0 0 0 -x1 -y1 -1 y2x1 y2y1 y2]
    r1 = torch.stack([-x1, -y1, -one, zero, zero, zero, x2 * x1, x2 * y1, x2],
                     dim=-1)
    r2 = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2],
                     dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    exact = exact or pts1.shape[-2] != 4
    h = _smallest_right_singular(A) if exact else _nullvec_minimal(A)
    H = h.reshape(*h.shape[:-1], 3, 3)
    # denormalize: T2^-1 H T1, T2 = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]]
    inv_s = 1.0 / T2[..., 0, 0]
    zero = torch.zeros_like(inv_s)
    T2_inv = torch.stack([
        torch.stack([inv_s, zero, -T2[..., 0, 2] * inv_s], dim=-1),
        torch.stack([zero, inv_s, -T2[..., 1, 2] * inv_s], dim=-1),
        torch.stack([zero, zero, torch.ones_like(inv_s)], dim=-1)], dim=-2)
    H = T2_inv @ (H @ T1)
    return H / torch.clamp(torch.abs(H[..., 2:3, 2:3]), min=1e-12)


def transfer_error(H, pts1, pts2):
    """Forward transfer error |H x1 - x2| in px (..., N)."""
    Hx = _homog(pts1) @ H.transpose(-1, -2)
    z = Hx[..., 2:]
    z = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    return torch.linalg.norm(Hx[..., :2] / z - pts2, dim=-1)


def homography_ransac(pts1, pts2, generator=None, mask=None,
                      num_hypotheses: int = 256, th_px: float = 3.0,
                      min_inliers: int = 20, sample_idx=None):
    """Batched 4-point H-RANSAC.

    pts1, pts2: (..., N, 2); mask (..., N) valid rows.  Each pair draws
    `num_hypotheses` 4-point samples without replacement among its valid
    rows (or takes the injected `sample_idx` (..., H, 4)), keeps the
    hypothesis with the most inliers, refits on its inliers by weighted DLT
    and keeps the refit when it holds at least half of them (and 4),
    else the best hypothesis.
    Returns dict H (..., 3, 3), inlier_mask (..., N), n_inliers, ok
    (n_inliers >= min_inliers).
    """
    m = torch.ones(pts1.shape[:-1], dtype=torch.bool, device=pts1.device) \
        if mask is None else mask.bool()
    idx = sample_idx if sample_idx is not None else \
        _sample_indices(generator, m, num_hypotheses, 4)
    idx = idx.long()
    Hs = homography_dlt(_gather_rows(pts1, idx), _gather_rows(pts2, idx),
                        exact=False)
    err = transfer_error(Hs, pts1[..., None, :, :], pts2[..., None, :, :])
    inl = (err < th_px) & m[..., None, :]                       # (..., H, N)
    best = torch.argmax(torch.sum(inl, dim=-1), dim=-1)         # (...)
    inl_best = torch.gather(
        inl, -2, best[..., None, None].expand(*best.shape, 1, inl.shape[-1])
    )[..., 0, :]
    H_best = torch.gather(
        Hs, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3)
    )[..., 0, :, :]
    H = homography_dlt(pts1, pts2, weights=inl_best.to(pts1.dtype))
    fin = (transfer_error(H, pts1, pts2) < th_px) & m
    n_best = torch.sum(inl_best, dim=-1)
    ok = torch.sum(fin, dim=-1) >= torch.clamp(n_best // 2, min=4)
    H = torch.where(ok[..., None, None], H, H_best)
    fin = torch.where(ok[..., None], fin, inl_best)
    n = torch.sum(fin, dim=-1)
    return {"H": H, "inlier_mask": fin, "n_inliers": n,
            "ok": n >= min_inliers}
