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

`knn2_int8` is the int8 variant (2-NN in the space of descriptors
quantized to [0, 127]), with the same split: the kernel
ops/csrc/knn2_int8.cu (the port of match_kernel.py:_kernel_int8) on CUDA,
`knn2_int8_reference` on the CPU.  Its operands come from one fused
quantize pass (`quantize_pair_int8`, a second entry of knn2_int8.cu;
plain version `quantize_int8_reference`).  The JAX package reaches it only
from its matching benchmark; `matching_throughput` is the port's
counterpart.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
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


_KNN2_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p] * 4
_SIGNATURES = {   # (library, symbol): argtypes; every entry returns c_int
    ("knn2", "knn2_launch"): _KNN2_ARGS,
    ("knn2_int8", "knn2_int8_launch"): _KNN2_ARGS,
    ("knn2_int8", "knn2_int8_quantize_launch"):   # two sets, then stream
        ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
         + [ctypes.c_void_p] * 3) * 2 + [ctypes.c_void_p],
}
_fns = {}


def _kernel_fn(lib: str, sym: str):
    """The C entry `sym` of csrc/<lib>.cu, built and loaded on first use,
    with its ctypes signature set once."""
    fn = _fns.get((lib, sym))
    if fn is None:
        fn = getattr(cuda_build.load_library(lib), sym)
        fn.argtypes = _SIGNATURES[(lib, sym)]
        fn.restype = ctypes.c_int
        _fns[(lib, sym)] = fn
    return fn


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
    if M * N >= 2 ** 31 or ii.shape[0] > 65535:
        raise ValueError("M * N must fit int32 and at most 65535 pairs per "
                         "call")


def _launch_knn2_cuda(desc_store, mask, ii, jj):
    fn = _kernel_fn("knn2", "knn2_launch")
    M, N, D = desc_store.shape
    B = ii.shape[0]
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
                jj.data_ptr(), M, B, N, D, d1.data_ptr(), d2.data_ptr(),
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
    kernel launches.  A pair index outside [0, M) raises: on the CPU here,
    on the card without a host sync, the kernel trapping at launch (the
    error surfaces at the next synchronize).
    """
    _check_knn2_args(desc_store, mask, ii, jj)
    dev = desc_store.device.type
    if dev == "cuda":
        return _launch_knn2_cuda(desc_store, mask, ii, jj)
    if dev == "cpu":
        M = desc_store.shape[0]
        both = torch.cat((ii, jj))
        if both.numel() and not bool(((both >= 0) & (both < M)).all()):
            raise IndexError(f"knn2: pair indices outside [0, {M})")
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


INT8_SCALE = 256.0          # q = clip(round(d * 256), 0, 127)


def quantize_desc_int8(desc):
    """Quantize non-negative L2-normalized descriptors to int8 [0, 127]
    (round half to even, as jnp.round)."""
    return torch.clamp(torch.round(desc.float() * INT8_SCALE), 0, 127).to(
        torch.int8)


INT8_NB_MASKED = 1 << 26    # the norm kernel 2b reads for a masked row


def quantize_int8_reference(desc, mask=None):
    """Plain version of the fused quantize pass: (q8, norms) with q8 =
    `quantize_desc_int8(desc)` (any leading axes, last axis 128) and norms
    the int32 |q8|^2 of each row, `INT8_NB_MASKED` where `mask` (bool, the
    leading axes) is False."""
    q8 = quantize_desc_int8(desc)
    q = q8.to(torch.int32)
    norms = torch.sum(q * q, dim=-1, dtype=torch.int32)
    if mask is not None:
        norms = torch.where(mask.bool(), norms, INT8_NB_MASKED)
    return q8, norms


def _quantize_launch_args(desc, mask):
    if desc.data_ptr() % 16:
        desc = desc.clone()
    q8 = torch.empty(desc.shape, dtype=torch.int8, device=desc.device)
    norms = torch.empty(desc.shape[:-1], dtype=torch.int32,
                        device=desc.device)
    m = None if mask is None else mask.bool().contiguous().view(torch.uint8)
    args = (desc.data_ptr(), int(desc.dtype == torch.bfloat16),
            desc.numel() // 128, 0 if m is None else m.data_ptr(),
            q8.data_ptr(), norms.data_ptr())
    return args, (q8, norms, desc, m)


def quantize_pair_int8(desc1, desc2, mask2=None):
    """Quantize a query and a database set for kernel 2b in one pass:
    returns (q8, nq, db8, nb), q8 / db8 int8 like `quantize_desc_int8`, nq
    the int32 query norms, nb the database norms with `INT8_NB_MASKED` on
    rows where mask2 is False.  desc* are f32 or bf16 with last axis 128.

    CUDA tensors go through the fused quantize kernel (one launch for both
    sets, counted in `quantize_pair_int8.launches`); CPU tensors through
    `quantize_int8_reference`.
    """
    dev = desc1.device
    if dev.type == "cpu":
        return (*quantize_int8_reference(desc1),
                *quantize_int8_reference(desc2, mask2))
    if dev.type != "cuda" or desc2.device != dev:
        raise ValueError("quantize_pair_int8 takes tensors on one CPU or "
                         "CUDA device")
    for t in (desc1, desc2):
        if t.dtype not in (torch.float32, torch.bfloat16) \
                or t.shape[-1] != 128:
            raise ValueError("descriptors must be f32 or bf16 (..., 128)")
    a1, keep1 = _quantize_launch_args(desc1.contiguous(), None)
    a2, keep2 = _quantize_launch_args(desc2.contiguous(), mask2)
    fn = _kernel_fn("knn2_int8", "knn2_int8_quantize_launch")
    with torch.cuda.device(dev):
        rc = fn(*a1, *a2, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 quantize kernel launch failed: "
                           f"cudaError {rc}")
    quantize_pair_int8.launches += 1
    return keep1[0], keep1[1], keep2[0], keep2[1]


quantize_pair_int8.launches = 0


def _int8_operands(desc1, desc2, mask2):
    """(B, N1, D) / (B, N2, D) views and a (B, N2) bool mask (all valid
    when mask2 is None); a leading pair axis is added to 2-D inputs."""
    if desc1.dim() == 2:
        desc1, desc2 = desc1[None], desc2[None]
        if mask2 is not None:
            mask2 = mask2[None]
    B, N2 = desc2.shape[:2]
    if mask2 is None:
        mask2 = torch.ones((B, N2), dtype=torch.bool, device=desc2.device)
    return desc1, desc2, mask2.bool()


def knn2_int8_reference(desc1, desc2, mask2=None, chunk: int = 2048):
    """Plain PyTorch exact 2-NN in int8-quantized space (the kernel's
    reference).

    Args:
      desc1: (N1, D) or (B, N1, D) non-negative unit queries (float).
      desc2: (N2, D) or (B, N2, D) database.
      mask2: (N2,) or (B, N2) bool validity of database rows, or None.
      chunk: database columns per step (bounds memory at B*N1*chunk).
    Returns (d1_sq, d2_sq, idx) shaped like the queries' leading axes:
    with q = quantize_desc_int8, val = 2 q1.q2 - |q2|^2 (exact integers,
    carried in f32: every value is below 2^24), the top-2 of val over the
    valid columns (best ties to the lowest column, second-best excluding
    only the best column), d^2 = max(|q1|^2 - val, 0) / 65536; +inf where
    there is no such column.
    """
    squeeze = desc1.dim() == 2
    desc1, desc2, mask2 = _int8_operands(desc1, desc2, mask2)
    q = quantize_desc_int8(desc1).float()                   # (B, N1, D)
    B, N1 = q.shape[:2]
    N2 = desc2.shape[1]
    dev = q.device
    na = torch.sum(q * q, dim=-1)
    neg_inf = float("-inf")
    best = torch.full((B, N1), neg_inf, dtype=torch.float32, device=dev)
    second = torch.full((B, N1), neg_inf, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((B, N1), dtype=torch.int32, device=dev)
    for off in range(0, N2, chunk):
        db = quantize_desc_int8(desc2[:, off:off + chunk]).float()
        nb = torch.sum(db * db, dim=-1)                     # (B, c)
        val = 2.0 * torch.matmul(q, db.transpose(1, 2)) - nb[:, None, :]
        val = val.masked_fill(~mask2[:, None, off:off + chunk], neg_inf)
        blk_arg = torch.argmax(val, dim=2, keepdim=True)
        blk_best = val.gather(2, blk_arg)[..., 0]
        blk_second = val.scatter(2, blk_arg, neg_inf).amax(dim=2)
        best_idx = torch.where(blk_best > best,
                               off + blk_arg[..., 0].to(torch.int32), best_idx)
        second = torch.maximum(torch.minimum(best, blk_best),
                               torch.maximum(second, blk_second))
        best = torch.maximum(best, blk_best)
    inv = 1.0 / (INT8_SCALE * INT8_SCALE)
    d1_sq = torch.clamp(na - best, min=0.0) * inv
    d2_sq = torch.clamp(na - second, min=0.0) * inv
    if squeeze:
        return d1_sq[0], d2_sq[0], best_idx[0]
    return d1_sq, d2_sq, best_idx


def _check_knn2_int8_args(desc1, desc2, mask2):
    if desc1.dim() not in (2, 3) or desc2.dim() != desc1.dim():
        raise ValueError("desc1 and desc2 must both be (N, D) or (B, N, D), "
                         f"got {tuple(desc1.shape)} and {tuple(desc2.shape)}")
    for name, t in (("desc1", desc1), ("desc2", desc2)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.shape[-1] != 128:
            raise ValueError(f"descriptor width must be 128, got {t.shape[-1]}")
    if desc1.dim() == 3 and desc1.shape[0] != desc2.shape[0]:
        raise ValueError("desc1 and desc2 must have the same pair count")
    if mask2 is not None:
        if mask2.dtype != torch.bool or mask2.shape != desc2.shape[:-1]:
            raise ValueError(f"mask2 must be bool {tuple(desc2.shape[:-1])}, "
                             f"got {mask2.dtype} {tuple(mask2.shape)}")
        if mask2.device != desc2.device:
            raise ValueError("desc2 and mask2 must share a device")
    if desc1.device != desc2.device:
        raise ValueError("desc1 and desc2 must share a device")
    if desc1.dim() == 3 and desc1.shape[0] > 65535:
        raise ValueError("at most 65535 pairs per call")
    if max(desc1.shape[-2], desc2.shape[-2]) >= 2 ** 31 // 128:
        raise ValueError("too many descriptors for int32 offsets")


def knn2_int8_kernel(q8, db8, nq, nb):
    """Launch kernel 2b on quantized operands (as `quantize_pair_int8`
    returns them): q8 (B, N1, 128) and db8 (B, N2, 128) contiguous int8 in
    [0, 127], nq (B, N1) int32 query norms, nb (B, N2) int32 database norms
    (`INT8_NB_MASKED` on masked rows), all on one CUDA device.  The kernel
    checks nothing about nq and nb: they must be `quantize_pair_int8`'s.
    Returns (d1_sq, d2_sq, idx) (B, N1) f32, f32, int32 (+inf, +inf, 0 for
    every row when N2 = 0, without a launch); counts the launch in
    `knn2_int8.launches`."""
    if q8.dim() != 3 or db8.dim() != 3 or nq.shape != q8.shape[:2] \
            or nb.shape != db8.shape[:2] or q8.shape[0] != db8.shape[0]:
        raise ValueError(f"shapes {tuple(q8.shape)}, {tuple(db8.shape)}, "
                         f"{tuple(nq.shape)}, {tuple(nb.shape)} are not "
                         "(B, N1, 128), (B, N2, 128), (B, N1), (B, N2)")
    if q8.dtype != torch.int8 or db8.dtype != torch.int8 \
            or nq.dtype != torch.int32 or nb.dtype != torch.int32:
        raise TypeError("q8 and db8 must be int8, nq and nb int32")
    ops = (q8, db8, nq, nb)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("q8, db8, nq and nb must be contiguous")
    dev = q8.device
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError("kernel 2b takes tensors on one CUDA device")
    B, N1, D = q8.shape
    N2 = db8.shape[1]
    if N2 == 0:     # no database row: no match, as in the plain version
        inf = torch.full((B, N1), float("inf"), device=dev)
        return inf, inf.clone(), torch.zeros((B, N1), dtype=torch.int32,
                                             device=dev)
    fn = _kernel_fn("knn2_int8", "knn2_int8_launch")
    d1 = torch.empty((B, N1), dtype=torch.float32, device=dev)
    d2 = torch.empty((B, N1), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q8.data_ptr(), db8.data_ptr(), nq.data_ptr(), nb.data_ptr(),
                B, N1, N2, D, d1.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"knn2_int8 kernel launch failed: cudaError {rc}")
    knn2_int8.launches += 1
    return d1, d2, idx


def knn2_int8(desc1, desc2, mask2=None):
    """Exact 2-NN in int8-quantized space (counterpart of
    `_knn2_pallas_int8_impl`, kernel 2b).

    Args:
      desc1: (N1, 128) or (B, N1, 128) non-negative unit queries, float32
        or bfloat16 (quantized here, on the card by `quantize_pair_int8`).
      desc2: (N2, 128) or (B, N2, 128) database, same type of layout.
      mask2: (N2,) or (B, N2) bool validity, or None (all valid).
    Returns (d1_sq, d2_sq, idx): (N1,) or (B, N1) f32, f32, int32, with the
    semantics of `knn2_int8_reference` (exact values, lowest-column ties,
    d2 = +inf with fewer than two valid columns).

    CUDA tensors go through the kernel (one launch for the whole batch);
    CPU tensors through `knn2_int8_reference`.  `knn2_int8.launches`
    counts kernel launches.
    """
    _check_knn2_int8_args(desc1, desc2, mask2)
    dev = desc1.device.type
    if dev == "cpu":
        return knn2_int8_reference(desc1, desc2, mask2)
    if dev != "cuda":
        raise ValueError(f"knn2_int8 has no implementation for device "
                         f"{dev!r}")
    squeeze = desc1.dim() == 2
    desc1, desc2, mask2 = _int8_operands(desc1, desc2, mask2)
    q8, nq, db8, nb = quantize_pair_int8(desc1, desc2, mask2)
    out = knn2_int8_kernel(q8, db8, nq, nb)
    return tuple(t[0] for t in out) if squeeze else out


knn2_int8.launches = 0


def throughput_descriptors(n_pairs: int, n_kp: int, seed: int = 0):
    """The matching benchmark's inputs (bench.py:178-182): non-negative
    L2-normalized (n_pairs, n_kp, 128) query and database sets, numpy f32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        d = np.abs(rng.normal(size=(n_pairs, n_kp, 128))).astype(np.float32)
        out.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return out


def matching_throughput(n_pairs: int = 96, n_kp: int = 4096,
                        iters: int = 6, device="cuda"):
    """Pairs/s of the two fused 2-NN kernels on the same descriptors: the
    port's counterpart of the JAX matching benchmark (bench.py:160-205).

    `n_pairs` pairs are in flight per call; `iters` calls are chained with
    a data dependency (each call's first best distance nudges the next
    call's first query row, as the benchmark's bf16 carry does), after one
    untimed warm-up chain; the host clock runs until a synchronize.  The
    int8 path (kernel 2b, `knn2_int8`) quantizes the f32 database and the
    bf16 carry inside every call, as `_knn2_pallas_int8_impl` does; the
    bf16 path (kernel 2a, `knn2_gather`) reads both sets from one bf16
    store.  Returns {"int8": pairs/s, "bf16": pairs/s}.
    """
    dev = torch.device(device)
    d1, d2 = throughput_descriptors(n_pairs, n_kp)
    carry = torch.tensor(d1, device=dev).to(torch.bfloat16)
    db = torch.tensor(d2, device=dev)
    store = torch.cat([carry, db.to(torch.bfloat16)])
    mask = torch.ones(store.shape[:2], dtype=torch.bool, device=dev)
    ii = torch.arange(n_pairs, dtype=torch.int32, device=dev)

    def int8_step():
        r = knn2_int8(carry, db)
        carry[:, :1] += (r[0][:, :1, None] * 1e-12).to(carry.dtype)

    def bf16_step():
        r = knn2_gather(store, mask, ii, ii + n_pairs)
        store[:n_pairs, :1] += (r[0][:, :1, None] * 1e-12).to(store.dtype)

    out = {}
    for name, step in (("int8", int8_step), ("bf16", bf16_step)):
        for _ in range(2):      # a warm-up chain, then the timed one
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
        out[name] = n_pairs * iters / dt
    return out


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
