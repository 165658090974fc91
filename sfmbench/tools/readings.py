"""Readings that the limits of a cell's check are set from: every number
the check compares, for the program and for the control (the plain
reference in the program's place, in the next precision down), on many
seeds in one process.

  python3 sfmbench/tools/readings.py --workload <cell> --seconds <s>
      --seeds <n> [<n> ...] [--solvers program control] [--out FILE]

Each reading is one JSON line: workload, solver, seed, attempted, failed
and the numbers.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solvers", nargs="+", default=["program", "control"])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from sfmbench import run
    from sfmbench.core import spec
    run.cache_dirs()
    device = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None
    for solver in args.solvers:
        for seed in args.seeds:
            cell = spec.cell(args.workload)
            cell["limits"] = {}
            res, checks = run.execute(cell, seed, args.seconds, 0, device,
                                      solver)
            line = json.dumps({"workload": args.workload, "solver": solver,
                               "seed": seed, "attempted": res["attempted"],
                               "failed": res["failed"],
                               "numbers": {n: v for n, v, _ in checks}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
