"""What the LM solver's spans see in one cell's solves, and what they cost.

  python3 sfmbench/tools/lm_spans.py --workload <cell> --seed <n>
      --solves <k> [--out FILE]

Set-up as a run's, then three passes over the same k solves (the
window's order and seeded starts, after the set-up's warm-up):

  plain   host wall per LM iteration, no profiler;
  traced  the same under the profiler (``core.trace.capture``): wall per
          iteration, the span metrics of ``core.spans``, the idle
          between solves, every idle gap's host op, and the device events
          that carry a span's name (there should be none);
  syncs   the same under ``torch.cuda.set_sync_debug_mode("warn")``: every
          synchronising call, by the innermost program span open at it
          and the program's source line, beside the read spans that the
          program's tracer counted.

Also the host cost of an empty span, with no profiler running and under
one.  Prints one JSON line (also appended to --out).  Runs on a program
without spans too: then the span numbers are None and every sync falls
in no span.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PACKAGE = os.path.join(ROOT, "metricsfm_tpu_torch")


def span_us(profiled, n=200_000, repeats=5):
    """Host microseconds of one empty span, with no profiler running or
    (`profiled`) under one that records CPU and CUDA activity: the best
    of `repeats` loops of n, less the empty loop's own time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from metricsfm_tpu_torch.utils.tracing import Tracer
    span = Tracer().span
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])

    def best(body):
        out = float("inf")
        for _ in range(repeats):
            with (profile(activities=acts) if profiled
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                body()
                out = min(out, (time.perf_counter() - t0) / n)
        return out

    def spans():
        for _ in range(n):
            with span("ba/lm/x"):
                pass

    def empty():
        for _ in range(n):
            pass

    return 1e6 * (best(spans) - best(empty))


def solve_range(drv, k0, k):
    """Solves k0 .. k0 + k - 1 of the driver, synchronised; iterations."""
    its = 0
    for j in range(k0, k0 + k):
        p = drv.problems[drv.order[j % len(drv.problems)]]
        its += int(drv._solve(p, j)[1]["iterations"])
    drv._sync()
    return its


@contextlib.contextmanager
def span_stack():
    """Track the open program spans: every module's `span` (the tracer's)
    is wrapped to push and pop its name.  Yields the stack."""
    from metricsfm_tpu_torch.utils import tracing
    orig = tracing.span
    stack = []

    @contextlib.contextmanager
    def tracked(name, sync=False):
        stack.append(name)
        try:
            with orig(name, sync):
                yield
        finally:
            stack.pop()

    mods = [m for m in list(sys.modules.values())
            if m is not None and getattr(m, "__name__", "").startswith(
                "metricsfm_tpu_torch") and getattr(m, "span", None) == orig]
    for m in mods:
        m.span = tracked
    try:
        yield stack
    finally:
        for m in mods:
            m.span = orig


def program_line():
    """file:line of the innermost frame in the program's package."""
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(PACKAGE):
            return f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
    return "(outside the program)"


def count_syncs(drv, k0, k):
    """Synchronising calls of solves k0.. under sync debug mode, by
    (innermost span, program line), and the read spans the tracer
    counted over the same solves."""
    import torch

    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER
    counts = collections.Counter()
    before = dict(GLOBAL_TRACER.counts)
    with span_stack() as stack, warnings.catch_warnings():
        warnings.simplefilter("always")

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if "synchroniz" not in str(message):
                return
            where = stack[-1] if stack else "(no span)"
            solve = "ba/lm/solve" in stack
            counts[(solve, where, program_line())] += 1

        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            its = solve_range(drv, k0, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reads = {n: c - before.get(n, 0)
             for n, c in GLOBAL_TRACER.counts.items()
             if "/read." in n and c - before.get(n, 0)}
    in_solve = sum(c for (s, _, _), c in counts.items() if s)
    in_reads = sum(c for (s, w, _), c in counts.items()
                   if s and "/read." in w)
    return {"iterations": its, "syncs_in_solves": in_solve,
            "syncs_in_read_spans": in_reads,
            "syncs_outside_solves": sum(c for (s, _, _), c in counts.items()
                                        if not s),
            "read_spans": reads, "read_spans_total": sum(reads.values()),
            "by_span_and_line": sorted(
                ([w, ln, c, s] for (s, w, ln), c in counts.items()),
                key=lambda x: -x[2])}


def traced_pass(drv, k0, k):
    from sfmbench.core import spans, trace
    its, tr = trace.capture(lambda: solve_range(drv, k0, k))
    split = spans.idle_split(tr)
    n = spans.iterations(tr)
    named = sorted({d[0] for d in tr.device
                    if "/read." in d[0] or d[0].startswith("ba/lm/")})
    return {"iterations": its, "ms_per_iter": 1e3 * tr.window_s / its,
            "window_s": tr.window_s, "busy_s": tr.busy_s(),
            "window_idle_s": tr.window_s - tr.busy_s(),
            "span_iterations": n,
            "reads_per_iter": len(spans.reads(tr)) / n if n else None,
            "read_wait_ms_per_iter": (
                1e3 * sum(b - a for a, b in spans.reads(tr)) / n
                if n else None),
            "idle_ms_per_iter": ({p: 1e3 * v / n for p, v in split.items()}
                                 if split and n else None),
            "idle_s": split, "device_events_named_as_spans": named,
            "idle_gaps": tr.idle_gaps(k=len(tr.host) + 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--solves", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from sfmbench import run
    from sfmbench.core import spec
    run.cache_dirs()
    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        print("lm_spans: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    cell = spec.cell(args.workload)
    drv = spec.driver(cell).Driver(cell, args.seed, device)
    drv.setup()
    k = args.solves
    t0 = time.perf_counter()
    its = solve_range(drv, 0, k)
    plain = {"iterations": its,
             "ms_per_iter": 1e3 * (time.perf_counter() - t0) / its}
    line = json.dumps({
        "workload": args.workload, "seed": args.seed, "solves": k,
        "device": torch.cuda.get_device_name(device),
        "span_off_us": span_us(False),
        "span_on_us": span_us(True, n=20_000, repeats=3), "plain": plain,
        "traced": traced_pass(drv, 0, k), "syncs": count_syncs(drv, 0, k)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
