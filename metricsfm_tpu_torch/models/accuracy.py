"""Accuracy assessment: per-point and global reprojection statistics.

Counterpart of metricsfm_tpu/models/accuracy.py; re-design of
SfM/src/accuracy_accessment.{h,cc} (ErrorReprojectionPts:
avg / mse / #obs per point and globally, used for reporting and outlier
culling — slam_gps.cc:1573-1594).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def assess(scene, kp_xy: Dict[int, np.ndarray], max_views: int = 16, *,
           device):
    """Compute reprojection statistics over all live tracks, with the
    residuals on `device`.

    Returns dict: avg_err (px), mse (px^2), n_obs, per_track_rmse (ndarray
    aligned with the problem's track rows), track_rows (scene track ids).
    """
    from ..ba.lm import compute_residuals
    prob, maps = scene.to_ba_problem(kp_xy, max_views=max_views,
                                     device=device)
    r = compute_residuals(prob).cpu().numpy()
    msk = prob.track_mask.cpu().numpy()
    err = np.linalg.norm(r, axis=-1)
    n_obs = int(msk.sum())
    avg = float(err[msk].mean()) if n_obs else 0.0
    mse = float((err[msk] ** 2).mean()) if n_obs else 0.0
    per_track_mse = (err ** 2 * msk).sum(1) / np.maximum(msk.sum(1), 1)
    return {
        "avg_err": avg,
        "mse": mse,
        "n_obs": n_obs,
        "per_track_rmse": np.sqrt(per_track_mse),
        "track_rows": maps["tracks"],
    }
