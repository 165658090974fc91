"""Brute-force descriptor matching: exact 2-NN + the reference's ratio tests.

Counterpart of metricsfm_tpu/ops/matching.py (replacing the reference's
KD-tree / GPU matchers, SfM/src/feature/feature_matching*.cpp and
graph/fine_matching_graph.cc:71-147 ratio tests + F-verify).

Descriptors are L2-normalized SIFT vectors, so d^2 = 2 - 2 s with s the
similarity; the similarity product runs on bf16-rounded operands with f32
accumulation, like the JAX package.

The 2-NN itself has two implementations of one contract (`knn2_gather`):
  * on a CUDA tensor, the hand-written kernel ops/csrc/knn2.cu (the port of
    the TPU kernel metricsfm_tpu/ops/pallas/match_kernel.py:_kernel);
  * on a CPU tensor, the plain PyTorch version `knn2_reference`.
Any other device raises; a failed kernel build raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def knn2_reference(desc_store, mask, ii, jj, chunk: int = 2048):
    """Plain PyTorch exact 2-NN over gathered pairs (the kernel's reference).

    Args:
      desc_store: (M, N, D) descriptors (any float dtype; rounded to bf16).
      mask: (M, N) bool validity of database rows.
      ii, jj: (B,) int image rows of the query / database side of each pair.
      chunk: database columns per step (bounds memory at B*N*chunk).
    Returns (d1_sq, d2_sq, idx): (B, N) f32, f32, int32 — best/second-best
    squared distances and the best column.  Ties go to the lowest column
    (first-occurrence argmax, as jnp.argmax); second-best excludes only the
    best column.
    """
    ii = ii.long()
    jj = jj.long()
    N = desc_store.shape[1]
    q = desc_store[ii].to(torch.bfloat16).float()          # (B, N, D)
    B = q.shape[0]
    dev = desc_store.device
    neg_inf = float("-inf")
    best = torch.full((B, N), neg_inf, dtype=torch.float32, device=dev)
    second = torch.full((B, N), neg_inf, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((B, N), dtype=torch.int32, device=dev)
    for off in range(0, N, chunk):
        db = desc_store[jj, off:off + chunk].to(torch.bfloat16).float()
        m = mask[jj, off:off + chunk].bool()                # (B, c)
        sim = torch.matmul(q, db.transpose(1, 2))          # (B, N, c)
        sim = sim.masked_fill(~m[:, None, :], neg_inf)
        blk_arg = torch.argmax(sim, dim=2, keepdim=True)
        blk_best = sim.gather(2, blk_arg)[..., 0]
        blk_second = sim.scatter(2, blk_arg, neg_inf).amax(dim=2)
        best_idx = torch.where(blk_best > best,
                               off + blk_arg[..., 0].to(torch.int32), best_idx)
        # top-2 of {best, second, blk_best, blk_second}
        second = torch.maximum(torch.minimum(best, blk_best),
                               torch.maximum(second, blk_second))
        best = torch.maximum(best, blk_best)
    d1_sq = torch.clamp(2.0 - 2.0 * best, min=0.0)
    d2_sq = torch.clamp(2.0 - 2.0 * second, min=0.0)
    return d1_sq, d2_sq, best_idx


def _check_knn2_args(desc_store, mask, ii, jj):
    if desc_store.dim() != 3:
        raise ValueError(f"desc_store must be (M, N, D), got {tuple(desc_store.shape)}")
    M, N, D = desc_store.shape
    if desc_store.dtype != torch.bfloat16:
        raise TypeError(f"desc_store must be bfloat16, got {desc_store.dtype}")
    if D != 128:
        raise ValueError(f"descriptor width must be 128, got {D}")
    if mask.shape != (M, N) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool (M, N) = {(M, N)}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    for name, t in (("ii", ii), ("jj", jj)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if ii.shape != jj.shape:
        raise ValueError("ii and jj must have the same length")
    if not all(t.device == desc_store.device for t in (mask, ii, jj)):
        raise ValueError("desc_store, mask, ii and jj must share a device")
    if N >= 2 ** 31 or ii.shape[0] > 65535:
        raise ValueError("N must fit int32 and at most 65535 pairs per call")


def _launch_knn2_cuda(desc_store, mask, ii, jj):
    lib = cuda_build.load_library("knn2")
    fn = lib.knn2_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    M, N, D = desc_store.shape
    B = ii.shape[0]
    if B:
        lo_hi = torch.stack([ii.min(), ii.max(), jj.min(), jj.max()]).tolist()
        if min(lo_hi) < 0 or max(lo_hi) >= M:
            raise IndexError(f"pair indices {lo_hi} outside [0, {M})")
    desc_store = desc_store.contiguous()
    mask = mask.contiguous()
    ii = ii.contiguous()
    jj = jj.contiguous()
    dev = desc_store.device
    d1 = torch.empty((B, N), dtype=torch.float32, device=dev)
    d2 = torch.empty((B, N), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(desc_store.data_ptr(), mask.data_ptr(), ii.data_ptr(),
                jj.data_ptr(), B, N, D, d1.data_ptr(), d2.data_ptr(),
                idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"knn2 kernel launch failed: cudaError {rc}")
    knn2_gather.launches += 1
    return d1, d2, idx


def knn2_gather(desc_store, mask, ii, jj):
    """Exact 2-NN for a batch of pairs gathered from a descriptor store.

    Args:
      desc_store: (M, N, D=128) bf16, the per-image descriptors (padded).
      mask: (M, N) bool validity.
      ii, jj: (B,) int32: pair b matches image ii[b] (queries) against image
        jj[b] (database, masked by mask[jj[b]]).
    Returns (d1_sq, d2_sq, idx): (B, N) f32, f32, int32.

    CUDA tensors go through the kernel (one launch for the whole batch);
    CPU tensors through `knn2_reference`.  `knn2_gather.launches` counts
    kernel launches.
    """
    _check_knn2_args(desc_store, mask, ii, jj)
    dev = desc_store.device.type
    if dev == "cuda":
        return _launch_knn2_cuda(desc_store, mask, ii, jj)
    if dev == "cpu":
        return knn2_reference(desc_store, mask, ii, jj)
    raise ValueError(f"knn2 has no implementation for device {dev!r}")


knn2_gather.launches = 0


def _pair_store(desc1, desc2, mask2):
    """Stack one query and one database set into a 2-image store."""
    N1, D = desc1.shape
    N2 = desc2.shape[0]
    N = max(N1, N2)
    dev = desc1.device
    store = torch.zeros((2, N, D), dtype=torch.bfloat16, device=dev)
    store[0, :N1] = desc1
    store[1, :N2] = desc2
    mask = torch.zeros((2, N), dtype=torch.bool, device=dev)
    mask[1, :N2] = True if mask2 is None else mask2.bool()
    ii = torch.zeros(1, dtype=torch.int32, device=dev)
    return store, mask, ii, ii + 1


def knn2(desc1, desc2, mask2=None):
    """Exact 2-nearest-neighbour search desc1 -> desc2 (one pair).

    desc1 (N1, D), desc2 (N2, D) L2-normalized rows; mask2 (N2,) validity.
    Returns (d1_sq, d2_sq, idx1), each (N1,): the B = 1 case of knn2_gather.
    """
    d1, d2, idx = knn2_gather(*_pair_store(desc1, desc2, mask2))
    N1 = desc1.shape[0]
    return d1[0, :N1], d2[0, :N1], idx[0, :N1]


def ratio_tests(d1_sq, d2_sq, idx2, mask1=None, ratio_good: float = 0.6,
                ratio_all: float = 0.85):
    """The reference's dual ratio tests (fine_matching_graph.cc:42-43,
    116-133) as masks over the query rows: "good" (< 0.6) estimates F,
    "all" (< 0.85) keeps candidates.  L2 ratio d1/d2 < r <=> d1^2 < r^2 d2^2.
    """
    m1 = torch.ones_like(d1_sq, dtype=torch.bool) if mask1 is None \
        else mask1.bool()
    safe2 = torch.clamp(d2_sq, min=1e-12)
    good = (d1_sq < ratio_good ** 2 * safe2) & m1
    allm = (d1_sq < ratio_all ** 2 * safe2) & m1
    return {"idx2": idx2, "good": good, "all": allm, "dist_sq": d1_sq}


def match_pair(desc1, desc2, mask1=None, mask2=None,
               ratio_good: float = 0.6, ratio_all: float = 0.85):
    """Match one image pair with the reference's dual ratio tests.

    Returns dict: idx2 (N1,) best-neighbour index into desc2, good (N1,),
    all (N1,) ratio-test masks, dist_sq (N1,) best squared distance.
    """
    d1_sq, d2_sq, idx2 = knn2(desc1, desc2, mask2)
    return ratio_tests(d1_sq, d2_sq, idx2, mask1, ratio_good, ratio_all)


def mutual_filter(idx12, idx21, mask=None):
    """Cross-check: keep i where idx21[idx12[i]] == i."""
    back = idx21[idx12.long()]
    ok = back == torch.arange(idx12.shape[0], device=idx12.device)
    if mask is not None:
        ok = ok & mask
    return ok


def match_pairs_batch(desc1, desc2, mask1, mask2,
                      ratio_good: float = 0.6, ratio_all: float = 0.85):
    """match_pair over a leading pair axis: desc* (B, N, D), mask* (B, N);
    one kernel launch for the batch."""
    B = desc1.shape[0]
    dev = desc1.device
    store = torch.cat([desc1, desc2]).to(torch.bfloat16)
    mask = torch.cat([torch.ones_like(mask2, dtype=torch.bool),
                      mask2.bool()])
    ii = torch.arange(B, dtype=torch.int32, device=dev)
    d1_sq, d2_sq, idx2 = knn2_gather(store, mask, ii, ii + B)
    return ratio_tests(d1_sq, d2_sq, idx2, mask1, ratio_good, ratio_all)
