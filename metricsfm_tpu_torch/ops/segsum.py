"""Segment sums in one fixed order: the port's replacement for atomic scatters.

`segment_sum(values, plan)` computes, for every bin s of a `SegmentPlan`,
the sum of the rows of `values` whose slots the plan put in bin s.  The
plan is a stable sort of the slots' integer bins, made once for a fixed
index set (a BA problem's observation slots, a k-means assignment) and
reused for every sum over it.

On a CUDA tensor the sum is one launch of the hand-written kernel
`ops/csrc/segsum.cu` (no atomics: each output element is written by one
thread after a reduction whose shape depends only on the plan; it adds in
double and rounds once), so two runs on the same inputs give the same
bits; a failed build or launch raises, there is no fallback.  On a CPU
tensor it is the plain version, `segment_sum_reference`: a
`torch.segment_reduce` over the sorted slots, which adds each bin's slots
one after another in slot order in the values' dtype, bit for bit what a
CPU `index_add_` of the same slots gives (and what XLA's CPU scatter-add
gives the JAX package).  Values are float32 or float64.

This is a port-only kernel: the JAX package sums the same quantities by
one-hot contractions and XLA segment sums (`metricsfm_tpu/ba/lm.py:
270-271`, `ops/kmeans.py:86-87`), which XLA evaluates in a fixed order.
`segment_sum.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build


class SegmentPlan(NamedTuple):
    """Slots sorted by bin, stably: bin s holds slots perm[off[s]:off[s+1]],
    in their original order.

    perm: (N,) int32; the kept slots sorted by bin, then the dropped ones.
    off: (n_bins + 1,) int32 offsets into perm.
    shape: the shape of the slot index (the leading dims of the values).
    n_bins: the number of bins.
    """
    perm: torch.Tensor
    off: torch.Tensor
    shape: Tuple[int, ...]
    n_bins: int

    @property
    def n_slots(self) -> int:
        return math.prod(self.shape)


def make_plan(bins, n_bins: int, mask: Optional[torch.Tensor] = None
              ) -> SegmentPlan:
    """Plan the sums of slots into `n_bins` bins by their integer `bins`
    (any shape); slots where `mask` is False are dropped.  A kept bin
    outside [0, n_bins) raises IndexError here, on the host (one read),
    before any kernel runs."""
    shape = tuple(bins.shape)
    flat = bins.reshape(-1).to(torch.int64)
    n = flat.numel()
    if n >= 2 ** 31 or n_bins >= 2 ** 31 - 1:
        raise ValueError(f"segment plan of {n} slots into {n_bins} bins "
                         "does not fit int32")
    if mask is not None:
        keep = mask.reshape(-1).to(device=flat.device, dtype=torch.bool)
        flat = torch.where(keep, flat, n_bins)   # dropped: past the last bin
        checked = torch.where(keep, flat, 0)
    else:
        checked = flat
    if n:
        lo, hi = (int(v) for v in torch.aminmax(checked))
        if lo < 0 or hi >= n_bins:
            raise IndexError(f"segment bins outside [0, {n_bins}): "
                             f"[{lo}, {hi}]")
    perm = torch.argsort(flat, stable=True).to(torch.int32)
    # integer counts: exact in any order
    counts = torch.bincount(flat, minlength=n_bins + 1)[:n_bins]
    off = torch.zeros(n_bins + 1, dtype=torch.int32, device=flat.device)
    off[1:] = torch.cumsum(counts, 0)
    return SegmentPlan(perm=perm, off=off, shape=shape, n_bins=n_bins)


def _rows(values, plan: SegmentPlan):
    """values (*plan.shape, *tail) -> ((N, K) view or copy, tail)."""
    lead = len(plan.shape)
    if tuple(values.shape[:lead]) != plan.shape:
        raise ValueError(f"values of shape {tuple(values.shape)} do not "
                         f"lead with the plan's slot shape {plan.shape}")
    tail = tuple(values.shape[lead:])
    return values.reshape(plan.n_slots, math.prod(tail)), tail


def segment_sum_reference(values, plan: SegmentPlan):
    """The plain version: the kept slots gathered in plan order and summed
    per bin by `torch.segment_reduce`, one after another in slot order, in
    values' dtype.  Returns (n_bins, *tail)."""
    v, tail = _rows(values, plan)
    lengths = (plan.off[1:] - plan.off[:-1]).to(torch.int64)
    kept = int(plan.off[-1]) if plan.n_bins else 0
    data = v[plan.perm[:kept].to(torch.int64)]
    if plan.n_bins == 0:
        out = data.new_zeros((0, v.shape[1]))
    else:
        out = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
    return out.reshape(plan.n_bins, *tail)


_SYMBOLS = {torch.float32: "segsum_f32_launch",
            torch.float64: "segsum_f64_launch"}
_fns = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(cuda_build.load_library("segsum"), _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _launch(values, plan: SegmentPlan):
    v, tail = _rows(values, plan)
    if v.dtype not in _SYMBOLS:
        raise TypeError("segsum kernel takes float32 or float64 values, got "
                        f"{v.dtype}")
    if not (plan.perm.device == plan.off.device == v.device):
        raise ValueError("values and plan must share a device")
    K = v.shape[1]
    if v.shape[0] > 1 and ((K > 1 and v.stride(1) != 1) or v.stride(0) < K):
        v = v.contiguous()
    ld = v.stride(0) if v.shape[0] > 1 else K
    out = torch.empty((plan.n_bins, K), dtype=v.dtype, device=v.device)
    if K and plan.n_bins:
        with torch.cuda.device(v.device):
            stream = torch.cuda.current_stream(v.device).cuda_stream
            rc = _kernel(v.dtype)(v.data_ptr(), ld, K, plan.perm.data_ptr(),
                                  plan.off.data_ptr(), plan.n_bins,
                                  out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"segsum kernel launch failed: cudaError {rc}")
        segment_sum.launches += 1
    return out.reshape(plan.n_bins, *tail)


def segment_sum(values, plan: SegmentPlan):
    """Sum `values` (*plan.shape, *tail) into (plan.n_bins, *tail) bins in
    the plan's fixed order.

    CUDA tensors go through the segsum kernel (one launch, counted in
    `segment_sum.launches`); CPU tensors through `segment_sum_reference`.
    Values are float32 or float64; the result has their dtype."""
    dev = values.device.type
    if dev == "cuda":
        return _launch(values, plan)
    if dev == "cpu":
        return segment_sum_reference(values, plan)
    raise ValueError(f"segment_sum has no implementation for device {dev!r}")


segment_sum.launches = 0
