"""Runs of one cell as the benchmark's own command, one process each, and
the spread of every metric: the distance between the first and third
quartile (statistics.quantiles, n=4) as a share of the median.

  python3 sfmbench/tools/spread.py --workload <cell> --seconds <s>
      --seeds <n> [<n> ...] [--trace 0|1] [--out FILE]

Prints each run's result line and then the spreads, as JSON lines (also
appended to --out).  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "run.py")


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else float("inf")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in args.seeds:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, RUN, "--workload", args.workload, "--seed",
             str(seed), "--seconds", str(args.seconds), "--trace",
             str(args.trace)], capture_output=True, text=True)
        wall = time.perf_counter() - t0
        last = proc.stdout.strip().splitlines()[-1:] or [""]
        try:
            res = json.loads(last[0])
        except json.JSONDecodeError:
            res = None
        emit({"workload": args.workload, "seed": seed, "rc": proc.returncode,
              "wall_s": wall, "result": res,
              "lines": proc.stdout.strip().splitlines()[:-1][-40:],
              "stderr": proc.stderr[-3000:] if proc.returncode or not res
              else proc.stderr[-600:]})
        if res:
            rows.append(res)
    if len(rows) >= 2:
        names = sorted({k for r in rows for k in r["metrics"]})
        emit({"workload": args.workload, "runs": len(rows), "spread": {
            n: spread([r["metrics"][n]["value"] for r in rows
                       if n in r["metrics"]])
            for n in names if sum(n in r["metrics"] for r in rows) >= 2},
            "median": {n: statistics.median(
                [r["metrics"][n]["value"] for r in rows
                 if n in r["metrics"]]) for n in names}})
    if out:
        out.close()


if __name__ == "__main__":
    main()
