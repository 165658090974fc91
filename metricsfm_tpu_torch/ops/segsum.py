"""Segment sums in one fixed order: the port's replacement for atomic scatters.

`segment_sum(values, plan)` computes, for every bin s of a `SegmentPlan`,
the sum of the rows of `values` whose slots the plan put in bin s.  The
plan is a stable sort of the slots' integer bins, made once for a fixed
index set (a BA problem's observation slots, a k-means assignment) and
reused for every sum over it.

On a CUDA tensor the sum is one launch of the hand-written kernel
`ops/csrc/segsum.cu` (no float atomics: each output element is written by
one thread after a reduction whose shape depends only on the plan; it adds
in double and rounds once), so two runs on the same inputs give the same
bits; a failed build or launch raises, there is no fallback.  The kernel
splits the plan's kept slots and bin ends into blocks of `CHUNK` items
(merge path), so a long bin costs what as many short ones do; the plan
holds each block's first bin (`chunk_bin`) and the counters that elect
the block adding a cross-block bin's partials (`tickets`, 0 between
launches: one plan is used by one stream at a time).  On a CPU
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

from ..utils.tracing import span
from . import cuda_build


# Items (kept slots and bin ends) a block of the kernel takes: its kChunk.
CHUNK = 1024


class SegmentPlan(NamedTuple):
    """Slots sorted by bin, stably: bin s holds slots perm[off[s]:off[s+1]],
    in their original order.

    perm: (N,) int32; the kept slots sorted by bin, then the dropped ones.
    off: (n_bins + 1,) int32 offsets into perm.
    shape: the shape of the slot index (the leading dims of the values).
    n_bins: the number of bins.
    kept: off[n_bins], the kept slots, as a host int.
    chunk_bin: (ceil((N + n_bins) / chunk) + 1,) int32; entry b counts
        the bins whose end lies before item b * chunk of the merged
        sequence (bin s's kept slots, then its end at off[s + 1] + s),
        so block b of the kernel starts at bin chunk_bin[b] and slot
        b * chunk - chunk_bin[b].
    tickets: (ceil((N + n_bins) / chunk),) int32 zeros; the kernel counts
        a cross-block bin's blocks there and puts the 0 back.
    chunk: the items a block takes (the kernel's kChunk).
    """
    perm: torch.Tensor
    off: torch.Tensor
    shape: Tuple[int, ...]
    n_bins: int
    kept: int
    chunk_bin: torch.Tensor
    tickets: torch.Tensor
    chunk: int

    @property
    def n_slots(self) -> int:
        return math.prod(self.shape)


def make_plan(bins, n_bins: int, mask: Optional[torch.Tensor] = None,
              chunk: int = CHUNK) -> SegmentPlan:
    """Plan the sums of slots into `n_bins` bins by their integer `bins`
    (any shape); slots where `mask` is False are dropped.  A kept bin
    outside [0, n_bins) raises IndexError here, on the host (one read,
    which also brings the kept count), before any kernel runs.  `chunk`
    must be the kernel's kChunk (other values serve probe builds)."""
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
    kept = n if mask is None else 0
    if n:
        lo, hi = torch.aminmax(checked)
        read = torch.stack([lo, hi] if mask is None else [lo, hi, keep.sum()])
        with span("segsum/read.plan"):
            lo, hi, *rest = read.tolist()
        kept = rest[0] if rest else kept
        if lo < 0 or hi >= n_bins:
            raise IndexError(f"segment bins outside [0, {n_bins}): "
                             f"[{lo}, {hi}]")
    dev = flat.device
    perm = torch.argsort(flat, stable=True)
    # bin s ends before the first sorted slot of a later bin (a CUDA
    # bincount would read its input's range on the host)
    ends = torch.searchsorted(flat[perm],
                              torch.arange(1, n_bins + 1, device=dev))
    perm = perm.to(torch.int32)
    off = torch.zeros(n_bins + 1, dtype=torch.int32, device=dev)
    off[1:] = ends
    # bin s's end in the merged sequence is off[s + 1] + s; the blocks are
    # sized by N, not by the kept count (no host read)
    blocks = -(-(n + n_bins) // chunk)
    chunk_bin = torch.searchsorted(
        ends + torch.arange(n_bins, device=dev),
        torch.arange(0, (blocks + 1) * chunk, chunk, device=dev),
        out_int32=True)
    tickets = torch.zeros(blocks, dtype=torch.int32, device=dev)
    return SegmentPlan(perm=perm, off=off, shape=shape, n_bins=n_bins,
                       kept=kept, chunk_bin=chunk_bin, tickets=tickets,
                       chunk=chunk)


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
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _launch(values, plan: SegmentPlan, fn=None):
    """One launch of the kernel (`fn`: its C entry for the values' dtype,
    by default the built csrc/segsum.cu's)."""
    v, tail = _rows(values, plan)
    if v.dtype not in _SYMBOLS:
        raise TypeError("segsum kernel takes float32 or float64 values, got "
                        f"{v.dtype}")
    dev = v.device
    if plan.perm.device != dev:       # make_plan puts all of a plan on one
        raise ValueError("values and plan must share a device")
    N, K = v.shape
    if N > 1 and ((K > 1 and v.stride(1) != 1) or v.stride(0) < K):
        v = v.contiguous()
    ld = v.stride(0) if N > 1 else K
    out = torch.empty((plan.n_bins, K), dtype=v.dtype, device=dev)
    if K and plan.n_bins:
        blocks = -(-(plan.kept + plan.n_bins) // plan.chunk)
        # each block's head and tail partials of its cross-block bins
        carry = torch.empty(2 * blocks * K, dtype=torch.float64, device=dev)
        args = (v.data_ptr(), ld, K, plan.perm.data_ptr(),
                plan.off.data_ptr(), plan.n_bins, plan.kept, plan.chunk,
                plan.chunk_bin.data_ptr(), plan.tickets.data_ptr(),
                carry.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        fn = fn or _kernel(v.dtype)
        if dev.index == torch.cuda.current_device():
            rc = fn(*args)
        else:                          # the launch goes to the current device
            with torch.cuda.device(dev):
                rc = fn(*args)
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
