"""Essential-guided matching: 2-NN + iterative E-RANSAC re-filtering.

Counterpart of metricsfm_tpu/ops/essential_matching.py (re-design of
SfM/src/feature/feature_matching_essential.{h,cpp}): after the ratio-test
2-NN pass (kernel 2a on CUDA tensors), `rounds` times estimate E on the
current inliers and re-filter all candidates by Sampson distance (<= 1e-3
in normalized coordinates).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import epipolar, matching, ransac


def match_pair_essential(desc1, desc2, xy1, xy2, f1, f2,
                         generator: Optional[torch.Generator] = None,
                         mask1=None, mask2=None, ratio: float = 0.85,
                         th_sampson: float = 1e-3, rounds: int = 2,
                         sample_idx=None):
    """Match desc1 -> desc2, then keep the candidates consistent with E.

    desc1 (N1, 128), desc2 (N2, 128) L2-normalized; xy1 (N1, 2), xy2
    (N2, 2) centered pixels; f1, f2 focals.  sample_idx: optional injected
    (rounds, 128, 8) E-RANSAC samples, one set a round (in place of draws
    from `generator`).  A round keeps its re-filtered mask only if it has
    at least 8 rows.
    Returns dict idx2 (N1,), inlier_mask (N1,), E (normalized coordinates).
    """
    res = matching.match_pair(desc1, desc2, mask1, mask2,
                              ratio_good=0.6, ratio_all=ratio)
    idx2 = res["idx2"]
    cand = res["all"]
    n1 = xy1 / f1
    n2 = xy2[idx2.long()] / f2
    inl = cand
    E = torch.eye(3, dtype=n1.dtype, device=n1.device)
    for r in range(rounds):
        E = ransac.essential_ransac(
            n1, n2, generator, mask=inl, th_sampson=th_sampson,
            num_hypotheses=128, min_inliers=8,
            sample_idx=None if sample_idx is None else sample_idx[r])["E"]
        new = (epipolar.sampson_distance(E, n1, n2) < th_sampson) & cand
        inl = torch.where(torch.sum(new) >= 8, new, inl)
    return {"idx2": idx2, "inlier_mask": inl, "E": E}
