"""Data-parallel pairwise matching over a mesh of ranks.

Counterpart of metricsfm_tpu/parallel/sharded_matching.py.  The reference
parallelizes candidate-pair matching with OpenMP threads
(fine_matching_graph.cc:87); here a batch of image pairs is split over the
mesh's ranks, and each rank matches its pairs with one launch of the 2-NN
kernel (2a, ops/csrc/knn2.cu, through matching.match_pairs_batch).  No
collective runs until the results are gathered.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import matching
from .mesh import Mesh, pad_to_multiple


def make_sharded_matcher(mesh: Mesh, ratio_good: float = 0.6,
                         ratio_all: float = 0.85, chunk: int = 2048,
                         axis_name: str = "data"):
    """Matcher for (B, N, D) descriptor pair batches split on B.

    Returns match(d1, d2, m1, m2) over the WHOLE batch (B a multiple of the
    mesh size): each rank matches its contiguous rows, and idx2, good, all
    and dist_sq come back gathered, (B, N), on every rank.  `chunk` is
    accepted for the JAX signature: the 2-NN kernel tiles its database
    itself."""
    del chunk
    n = mesh.shape[axis_name]

    def match(d1, d2, m1, m2):
        B = d1.shape[0]
        assert B % n == 0, f"pair count {B} not divisible by mesh axis {n}"
        lo, hi = mesh.rows(B)

        def local(t):
            return torch.as_tensor(t[lo:hi]).to(mesh.device)

        res = matching.match_pairs_batch(
            local(d1), local(d2), local(m1), local(m2),
            ratio_good=ratio_good, ratio_all=ratio_all)
        return {k: mesh.all_gather_rows(res[k])
                for k in ("idx2", "good", "all", "dist_sq")}

    return match


def match_pairs_sharded(desc1, desc2, mask1, mask2, mesh: Mesh, **kw):
    """Match (B, N, D) pair batches split over the mesh: B is padded to a
    multiple of the mesh size with masked pairs, each rank matches its
    rows, and the gathered results are cut back to B.  Inputs are numpy
    arrays or tensors; results are (B, N) tensors on the mesh's device,
    on every rank."""
    n = mesh.shape[kw.get("axis_name", "data")]
    B = desc1.shape[0]

    def pad(a):
        if not torch.is_tensor(a):
            return pad_to_multiple(np.asarray(a), n)
        fill = a.new_zeros(((-B) % n, *a.shape[1:]))
        return torch.cat([a, fill]) if fill.shape[0] else a

    out = make_sharded_matcher(mesh, **kw)(
        pad(desc1), pad(desc2), pad(mask1), pad(mask2))
    return {k: v[:B] for k, v in out.items()}
