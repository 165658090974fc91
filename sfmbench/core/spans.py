"""The program's spans in a traced stretch of work.

``metricsfm_tpu_torch.utils.tracing.span`` records each span as a CPU op
of the profiler under its own name, so a ``Trace`` holds the spans among
its host ops, on the clock of its device intervals.  The LM solver's
spans: ``ba/lm/solve`` (one a solve), ``ba/lm/iteration`` (one an LM
iteration, inside a solve) and in it the stages ``STAGES``, in order.  A
span named ``<layer>/read.<what>`` holds one blocking device-to-host
read.  A program without these spans gives a trace without them, and the
functions here then give None.
"""
from __future__ import annotations

import bisect
import re

SOLVE = "ba/lm/solve"
ITERATION = "ba/lm/iteration"
STAGES = ("ba/lm/linearize", "ba/lm/reduce", "ba/lm/camera_solve",
          "ba/lm/step")
READ = re.compile(r"/read\.[^/]+$")


def union(intervals):
    """Sorted, disjoint [start, end] covering the given intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def overlap(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def named(tr, pattern):
    """(start, end) of the host ops whose name matches `pattern` (a name,
    or a compiled regular expression searched in the name)."""
    if isinstance(pattern, str):
        return [(a, b) for n, a, b in tr.host if n == pattern]
    return [(a, b) for n, a, b in tr.host if pattern.search(n)]


def inside(spans, outer):
    """The spans that lie within one of the sorted, disjoint `outer`."""
    starts = [a for a, _ in outer]
    out = []
    for a, b in spans:
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and b <= outer[k][1]:
            out.append((a, b))
    return out


def idle(tr):
    """The traced window's idle intervals: [0, window_s] less the union of
    device intervals."""
    out, t = [], 0.0
    for a, b in tr.busy_intervals():
        if a > t:
            out.append([t, a])
        t = max(t, b)
    if tr.window_s > t:
        out.append([t, tr.window_s])
    return out


def solves(tr):
    return union(named(tr, SOLVE))


def iterations(tr) -> int:
    """LM iterations of the traced solves: their ba/lm/iteration spans."""
    return len(inside(named(tr, ITERATION), solves(tr)))


def reads(tr):
    """(start, end) of the read spans inside the traced solves."""
    return inside(named(tr, READ), solves(tr))


def per_iteration(tr, value_of):
    """value_of(tr) over the traced solves' LM iterations; None without
    iterations."""
    n = iterations(tr)
    return value_of(tr) / n if n else None


def idle_split(tr):
    """Idle seconds of the traced window by where the host was: each stage
    of STAGES (idle while it is the innermost stage span), ``solve_self``
    (inside ba/lm/solve, in no stage span: plans, the initial cost, the
    loop's bookkeeping, the final count) and ``outside`` (between
    solves).  The parts sum to the window's idle.  None where no device
    op or no solve was traced."""
    if not tr.device:
        return None
    sol = solves(tr)
    if not sol:
        return None
    gaps = idle(tr)
    split = {s: overlap(gaps, union(inside(named(tr, s), sol)))
             for s in STAGES}
    in_solves = overlap(gaps, sol)
    split["solve_self"] = in_solves - sum(split[s] for s in STAGES)
    split["outside"] = sum(b - a for a, b in gaps) - in_solves
    return split


def idle_ms_per_iter(tr, part):
    """Milliseconds of idle_split's `part` per LM iteration, or None."""
    split = idle_split(tr)
    if split is None:
        return None
    return per_iteration(tr, lambda _: 1e3 * split[part])
