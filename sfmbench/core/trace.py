"""The traced part of a run: a torch.profiler capture of CPU ops and
device activity, reduced to busy time, idle gaps labelled by the host op
running during each, and device time by kernel name."""
from __future__ import annotations

import re
import time
from collections import defaultdict


class Trace:
    """Device intervals and host ops of one traced stretch of work."""

    def __init__(self, device, host, window_s):
        self.device = device      # [(name, start_s, end_s)], by start
        self.host = host          # [(name, start_s, end_s)], by start
        self.window_s = window_s

    def busy_intervals(self):
        merged = []
        for _, a, b in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_s(self, pattern: str) -> float:
        """Seconds of device activity whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.device if rx.search(n))

    def top_device_ops(self, k=10):
        tot = defaultdict(float)
        for n, a, b in self.device:
            tot[n[:120]] += b - a
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """Idle time between device intervals, summed by the innermost
        host op running at each gap's midpoint."""
        edges = [[0.0, 0.0]] + self.busy_intervals() + \
            [[self.window_s, self.window_s]]
        gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1])
                      for a, b in zip(edges, edges[1:]) if b[0] > a[1])
        tot = defaultdict(float)
        stack, i = [], 0
        for mid, length in gaps:
            while i < len(self.host) and self.host[i][1] <= mid:
                while stack and stack[-1][2] <= self.host[i][1]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            inner = [h for h in stack if h[1] <= mid <= h[2]]
            tot[inner[-1][0] if inner else "host (no op)"] += length
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]


def capture(fn):
    """Run fn() under the profiler, synchronising at both ends.  Returns
    (fn's result, Trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        out = fn()
        sync()
        t1 = time.perf_counter_ns()
    events = prof.profiler.kineto_results.events()
    # profiler clocks and perf_counter differ by an offset: place the
    # window on the profiler's clock by its first and last host op
    host_ev = [e for e in events if e.device_type() == DeviceType.CPU]
    base = min((e.start_ns() for e in events), default=0)
    window_s = max((t1 - t0) * 1e-9,
                   max((e.end_ns() for e in events), default=base) * 1e-9
                   - base * 1e-9)
    dev = sorted(((e.name(), (e.start_ns() - base) * 1e-9,
                   (e.end_ns() - base) * 1e-9)
                  for e in events if e.device_type() != DeviceType.CPU),
                 key=lambda x: x[1])
    host = sorted(((e.name(), (e.start_ns() - base) * 1e-9,
                    (e.end_ns() - base) * 1e-9) for e in host_ev),
                  key=lambda x: (x[1], -x[2]))
    return out, Trace(dev, host, window_s)
