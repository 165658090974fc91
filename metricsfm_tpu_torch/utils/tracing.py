"""Tracing / profiling instrumentation.

Scoped wall-clock timers with aggregated reports, and a hook into
torch.profiler for per-kernel device traces.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict


class Tracer:
    """Aggregating scoped timer: with tracer.span("match"): ..."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the block.  sync=True waits for queued CUDA work before the
        clock stops (launches are asynchronous, so without it a span times
        the enqueue, not the device work)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                import torch
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

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

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)


GLOBAL_TRACER = Tracer()
span = GLOBAL_TRACER.span


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace (CPU + CUDA activities) of the block,
    yield the profiler (for key_averages), and write a gzipped Chrome trace
    to log_dir/trace.json.gz."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json.gz"))
