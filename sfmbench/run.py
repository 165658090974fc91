"""One run of one benchmark cell of the PyTorch port.

  python3 sfmbench/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

Set-up (inputs and weights from the seed, the program's first use of
every shape), then whole jobs or solves back to back until `--seconds`
have passed, then (with --trace 1) one more under torch.profiler, then
the check against the plain reference.  The last line of standard output
is the result as one JSON object; the numbers compared, each beside its
limit, end standard error.  A run needs as many CUDA devices as the cell
asks for and fails without them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

JAX_NAMES = {"jax", "jaxlib", "flax", "metricsfm_tpu"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs():
    """Kernel caches at fixed paths inside the checkout: the program's
    nvcc libraries stay in its own _build/, and any torch extension or
    Triton cache lands here, so a cell's later runs find them built."""
    base = os.path.join(ROOT, ".sfmbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def jax_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & JAX_NAMES)


def cell_metrics(cell_name: str):
    """(end-to-end, per-layer) entries of BENCHMARK.json for this cell."""
    from sfmbench.core import spec
    b = spec.benchmark()
    e2e = [m for m in b["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in b["per_layer"]
             if cell_name in m.get("workloads", [cell_name])
             and m["moves"] in names]
    return e2e, layer


def execute(cell, seed, seconds, trace, device, solver="program"):
    """Set-up, window, optional trace and check of one run.  Returns
    (result dict, checks)."""
    import torch

    from sfmbench.core import spec

    drv = spec.driver(cell).Driver(cell, seed, device, solver)
    drv.setup()
    setup_s = time.perf_counter() - T0
    t_win = time.perf_counter()
    win = drv.window(seconds)
    for line in win["lines"]:
        print(line, flush=True)
    t_trace = time.perf_counter()
    tr = drv.traced() if trace else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    drv.release()
    t_check = time.perf_counter()
    checks, failed = drv.check()
    print(f"phases: set-up {setup_s:.3f} s, window {t_trace - t_win:.3f} s,"
          f" traced {t_check - t_trace:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    e2e, layer = cell_metrics(cell["name"])
    metrics = {}
    if trace:
        record = drv.record(win, tr)
        for m in layer:
            v = spec.metric(m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(drv.end_to_end(win), setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(win["attempted"] > 0 and failed == 0
                              and all(v <= lim for _, v, lim in checks)),
              "attempted": win["attempted"], "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    from sfmbench.core import spec
    cell = spec.cell(args.workload)
    cache_dirs()
    import torch
    # one process with few host threads: the program's host work is small
    # launches and syncs, and a full pool of threads only adds noise
    torch.set_num_threads(2)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"sfmbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none or too few here", file=sys.stderr)
        return 3
    result, checks = execute(cell, args.seed, args.seconds, args.trace,
                             torch.device("cuda:0"))
    bad = jax_modules()
    if bad:
        print(f"sfmbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"correct {result['correct']}", file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
