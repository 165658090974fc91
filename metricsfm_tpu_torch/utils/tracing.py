"""Tracing: named spans of the host's work, and device traces.

``span(name)`` times a block into ``GLOBAL_TRACER``: totals and counts by
name, the stage report that ``cli sfm``, ``slam`` and ``dense`` print.
While a torch profiler is running, the span is also a profiler range
under its own name, so it lands in the profiler's trace with its start,
its end and its parent (the range it nests in), on the clock the
device's kernels are placed on.  The range is recorded as a plain CPU
op (``_RecordFunctionFast``), not as a user annotation: the profiler
mirrors a ``record_function`` annotation as a device-typed event from
the block's first kernel to its last, which a reading of device busy
time would count as busy, and ``record_function`` costs about 12 us a
range even with no profiler.  With no profiler running a span costs one
flag check and its timing.  The profiler keeps the ranges and writes
them out with its trace; the tracer keeps only totals and counts.

Names are ``<layer>/<stage>``.  A span that holds one blocking
device-to-host read, and nothing else, is named ``<layer>/read.<what>``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as autograd_profiler


class _Span:
    """One timed block of a Tracer (see the module docstring)."""

    __slots__ = ("tracer", "name", "sync", "range", "t0")

    def __init__(self, tracer: "Tracer", name: str, sync: bool):
        self.tracer, self.name, self.sync = tracer, name, sync

    def __enter__(self):
        self.range = None
        if autograd_profiler._is_profiler_enabled:
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available() \
                and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        self.tracer.totals[self.name] += dt
        self.tracer.counts[self.name] += 1
        return False


class Tracer:
    """Aggregating scoped timer: with tracer.span("match"): ..."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def span(self, name: str, sync: bool = False) -> _Span:
        """Time the block.  sync=True waits for queued CUDA work before the
        clock stops (launches are asynchronous, so without it a span times
        the enqueue, not the device work)."""
        return _Span(self, name, sync)

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{name:<32} {total:9.3f}s  x{self.counts[name]}"
                 for name, total in rows]
        return "\n".join(lines)

    def as_dict(self):
        return {k: {"total_s": v, "count": self.counts[k]}
                for k, v in self.totals.items()}


GLOBAL_TRACER = Tracer()
span = GLOBAL_TRACER.span


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace (CPU + CUDA activities) of the block,
    yield the profiler (for key_averages), and write a gzipped Chrome trace
    to log_dir/trace.json.gz."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json.gz"))
