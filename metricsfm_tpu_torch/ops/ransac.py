"""Batched two-view RANSAC.

Counterpart of metricsfm_tpu/ops/ransac.py (replacing the reference's
sequential loops, fundamental_matrix_eight_point.cc:30-97 and
utils/geo_verification.cc:30-79 — cv::findFundamentalMat @3px).

All hypotheses of all pairs are generated at once, scored against every
correspondence in one batched product, and each pair's winner is refit on
its inlier set with masked weights.  Leading axes of the inputs are pairs.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import epipolar


def _sample_indices(generator: Optional[torch.Generator], mask,
                    num_hypotheses: int, sample_size: int):
    """(..., H, S) index samples drawn without replacement from the valid
    entries of mask (..., N): Gumbel top-k, an exact uniform sample over the
    masked support (with fewer valid entries than S, masked ones fill in,
    as in the JAX package)."""
    shape = mask.shape[:-1] + (num_hypotheses, mask.shape[-1])
    u = torch.rand(shape, generator=generator, device=mask.device,
                   dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    logits = torch.where(mask, 0.0, -1e9)[..., None, :]
    return torch.topk(g + logits, sample_size, dim=-1).indices


def _gather_rows(pts, idx):
    """pts (..., N, 2), idx (..., H, S) -> (..., H, S, 2)."""
    lead = idx.shape[:-2]
    H, S = idx.shape[-2:]
    flat = idx.reshape(*lead, H * S, 1).expand(*lead, H * S, pts.shape[-1])
    return torch.gather(pts, -2, flat).reshape(*lead, H, S, pts.shape[-1])


def _consensus(pts1, pts2, fit, dist, th, generator, mask, num_hypotheses,
               min_inliers, refit_rounds, sample_idx):
    """The RANSAC harness both two-view models share: 8-row hypotheses
    fit non-exactly, the winner by inlier count, then `refit_rounds`
    weighted exact refits, each kept only if it keeps at least half the
    inliers (and 8).  Returns (model, inlier_mask, n_inliers, ok)."""
    m = torch.ones(pts1.shape[:-1], dtype=torch.bool, device=pts1.device) \
        if mask is None else mask.bool()
    idx = sample_idx if sample_idx is not None else \
        _sample_indices(generator, m, num_hypotheses, 8)
    idx = idx.long()

    models = fit(_gather_rows(pts1, idx), _gather_rows(pts2, idx),
                 exact=False)
    d = dist(models, pts1[..., None, :, :], pts2[..., None, :, :])
    inl = (d < th) & m[..., None, :]                          # (..., H, N)
    n_inl = torch.sum(inl, dim=-1)
    best = torch.argmax(n_inl, dim=-1)                         # (...)
    inlier_mask = torch.gather(
        inl, -2, best[..., None, None].expand(*best.shape, 1, inl.shape[-1])
    )[..., 0, :]

    model = None
    for _ in range(refit_rounds):
        w = inlier_mask.to(pts1.dtype)
        model = fit(pts1, pts2, weights=w)
        new = (dist(model, pts1, pts2) < th) & m
        keep = torch.sum(new, dim=-1) >= torch.clamp(
            torch.sum(inlier_mask, dim=-1) // 2, min=8)
        inlier_mask = torch.where(keep[..., None], new, inlier_mask)
    n = torch.sum(inlier_mask, dim=-1)
    return model, inlier_mask, n, n >= min_inliers


def fundamental_ransac(pts1, pts2, generator=None, mask=None,
                       num_hypotheses: int = 256, th_px: float = 3.0,
                       min_inliers: int = 30, refit_rounds: int = 2,
                       sample_idx=None):
    """Batched 8-point F-RANSAC with epipolar-distance scoring.

    pts1, pts2: (..., N, 2) centered-pixel correspondences (masked).
    mask: (..., N) valid rows.  th_px/min_inliers mirror geo_verification.cc.
    sample_idx: optional (..., H, 8) injected minimal samples (replaces the
      draw from `generator`, so tests can feed both packages one sample set).
    Returns dict: F (..., 3, 3), inlier_mask (..., N), n_inliers, ok.
    """
    F, inl, n, ok = _consensus(
        pts1, pts2, epipolar.fundamental_8pt, epipolar.epipolar_distance,
        th_px, generator, mask, num_hypotheses, min_inliers, refit_rounds,
        sample_idx)
    return {"F": F, "inlier_mask": inl, "n_inliers": n, "ok": ok}


def essential_ransac(norm1, norm2, generator=None, mask=None,
                     num_hypotheses: int = 256, th_sampson: float = 1e-5,
                     min_inliers: int = 30, refit_rounds: int = 2,
                     sample_idx=None):
    """Batched E-RANSAC on K-normalized correspondences (Sampson scoring).

    Replaces the reference 5-point RANSAC (essential_matrix_five_point.cc)
    with non-minimal 8-point samples and a larger hypothesis budget.
    norm1, norm2: (..., N, 2); mask (..., N); sample_idx optional injected
    (..., H, 8) samples.  Returns dict: E, inlier_mask, n_inliers, ok.
    """
    E, inl, n, ok = _consensus(
        norm1, norm2, epipolar.essential_8pt, epipolar.sampson_distance,
        th_sampson, generator, mask, num_hypotheses, min_inliers,
        refit_rounds, sample_idx)
    return {"E": E, "inlier_mask": inl, "n_inliers": n, "ok": ok}
