"""Match geometric verification suite.

Counterpart of metricsfm_tpu/utils/geo_verification.py (re-design of
SfM/src/utils/geo_verification.{h,cc}): the four verification modes the
reference exposes —
  F-RANSAC (geo_verification.cc:30-58, 3 px / >= 30 inliers),
  re-filter by a fixed F (:60-79),
  local-flow grid consistency (:81-154),
  per-patch local F (:156-222).
They take host arrays and return host results (a Python bool and numpy
arrays); the RANSAC and the distances run on `device`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import epipolar, ransac
from . import device as device_util


def _tensor(a, dev, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, device=dev)


def verify_fundamental(pts1, pts2, generator: Optional[torch.Generator] = None,
                       mask=None, th_px: float = 3.0, min_inliers: int = 30,
                       num_hypotheses: int = 256, *, device="cuda",
                       sample_idx=None):
    """Mode 1: F-RANSAC verification (cv::findFundamentalMat equivalent).

    sample_idx: optional injected (num_hypotheses, 8) samples.
    Returns (ok, inlier_mask (N,), F (3, 3))."""
    dev = device_util.resolve(device)
    res = ransac.fundamental_ransac(
        _tensor(pts1, dev), _tensor(pts2, dev), generator,
        mask=None if mask is None else _tensor(mask, dev, torch.bool),
        th_px=th_px, min_inliers=min_inliers, num_hypotheses=num_hypotheses,
        sample_idx=None if sample_idx is None else _tensor(
            sample_idx, dev, torch.int64))
    return (bool(res["ok"]), res["inlier_mask"].cpu().numpy(),
            res["F"].cpu().numpy())


def refilter_with_fundamental(F, pts1, pts2, th_px: float = 3.0, *,
                              device="cuda"):
    """Mode 2: keep matches within th_px of the epipolar lines of a fixed F."""
    dev = device_util.resolve(device)
    d = epipolar.epipolar_distance(_tensor(F, dev), _tensor(pts1, dev),
                                   _tensor(pts2, dev))
    return (d < th_px).cpu().numpy()


def verify_local_flow(pts1, pts2, grid: int = 8, th_mad: float = 3.0,
                      min_per_cell: int = 3):
    """Mode 3: local-flow grid check (geo_verification.cc:81-154), on the
    host.

    Matches vote with their displacement vector; within each grid cell the
    flow should be locally consistent — outliers deviate from the cell
    median by more than th_mad median-absolute-deviations.
    """
    pts1 = np.asarray(pts1)
    pts2 = np.asarray(pts2)
    flow = pts2 - pts1
    lo = pts1.min(axis=0)
    hi = pts1.max(axis=0) + 1e-6
    cell = np.floor((pts1 - lo) / (hi - lo) * grid).astype(int)
    cell = np.clip(cell, 0, grid - 1)
    key = cell[:, 1] * grid + cell[:, 0]
    keep = np.ones(len(pts1), bool)
    for c in np.unique(key):
        sel = key == c
        if sel.sum() < min_per_cell:
            continue
        med = np.median(flow[sel], axis=0)
        dev = np.linalg.norm(flow[sel] - med, axis=1)
        mad = np.median(dev) + 1e-6
        keep[sel] = dev <= th_mad * max(mad, 2.0)
    return keep


def verify_patch_fundamental(pts1, pts2,
                             generator: Optional[torch.Generator] = None,
                             n_patches: int = 4, th_px: float = 3.0,
                             min_per_patch: int = 16, *, device="cuda",
                             sample_idx=None):
    """Mode 4: per-patch F verification (geo_verification.cc:156-222):
    split image 1 into n_patches x n_patches tiles and F-verify each tile
    with enough matches on its own (128 hypotheses, min(8, n // 2)
    inliers); a tile with fewer than min_per_patch matches is kept.

    sample_idx: optional injected samples by patch id (row-major tile
    index): sample_idx[c] is a (128, 8) index set into that tile's rows.
    """
    pts1 = np.asarray(pts1)
    pts2 = np.asarray(pts2)
    lo = pts1.min(axis=0)
    hi = pts1.max(axis=0) + 1e-6
    cell = np.floor((pts1 - lo) / (hi - lo) * n_patches).astype(int)
    cell = np.clip(cell, 0, n_patches - 1)
    pid = cell[:, 1] * n_patches + cell[:, 0]
    keep = np.zeros(len(pts1), bool)
    for c in np.unique(pid):
        sel = np.where(pid == c)[0]
        if len(sel) < min_per_patch:
            keep[sel] = True  # too few to verify locally; defer to global F
            continue
        ok, inl, _ = verify_fundamental(
            pts1[sel], pts2[sel], generator, th_px=th_px,
            min_inliers=min(8, len(sel) // 2), num_hypotheses=128,
            device=device,
            sample_idx=None if sample_idx is None else sample_idx[c])
        keep[sel] = inl if ok else False
    return keep
