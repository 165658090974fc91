"""How far two calls of solve_lm on the card agree, by iteration count.

Phase 12h's problem (synthetic_ba_problem at 1,024 cameras x 131,072
points, exact observations) and phase 13's copy of it with 0.5 px of
seeded observation noise (chip_smoke.mesh_ba_problem), each solved twice
with 12h's LMConfig (PCG) cut to 1 ... 8 iterations; and a dense-Schur
problem (64 cameras x 32,768 points, V 6, 0.5 px of noise) the same way
with LMConfig(rtol=0), which runs the dense path's linearize and reduce
kernels and its segment sums.  Every solve also runs the LM candidate
kernel (ops/csrc/ba_candidate_cost.cu) once an iteration and once for
its initial cost, whose fixed-order cost decides each accept.  Prints,
for each pair of calls, whether they gave the same bits
(chip_smoke.lm_bit_equal), each call's candidate-kernel launches against
its iterations + 1, and the gaps of chip_smoke.lm_gaps: final cost and
rms_px relative, poses raw and modulo the problem's scale gauge, and the
scale factor between the two.  Exits non-zero if a pair differs or a
call's launches do not match.  Needs one NVIDIA card; run from the
repository root:

    python3 tools/probe_lm_repeat.py
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    import torch
    from metricsfm_tpu_torch.ba.lm import LMConfig, solve_lm
    from metricsfm_tpu_torch.ops import ba_candidate_cost
    from metricsfm_tpu_torch.utils import synth

    print(chip_smoke.gpu_line(), flush=True)
    pcg = chip_smoke.mesh_lm_config()
    dense = LMConfig(max_iterations=pcg.max_iterations, rtol=0.0)
    problems = {
        "exact": (synth.synthetic_ba_problem(1024, 131072, device="cuda"),
                  pcg),
        "noisy": (chip_smoke.mesh_ba_problem("cuda", 1024, 131072), pcg),
        "dense": (chip_smoke.mesh_ba_problem("cuda", 64, 32768), dense)}
    for prob, cfg in problems.values():                        # warm-up
        solve_lm(prob, cfg._replace(max_iterations=1))
    rows = []
    for name, (prob, cfg) in problems.items():
        for n in range(1, cfg.max_iterations + 1):
            runs, launches = [], []
            for _ in range(2):
                before = ba_candidate_cost.candidate_cost.launches
                out, info = solve_lm(prob, cfg._replace(max_iterations=n))
                torch.cuda.synchronize()
                launches.append(ba_candidate_cost.candidate_cost.launches
                                - before)
                runs.append({"info": info,
                             "poses": chip_smoke.poses_of(out)})
            gap = chip_smoke.lm_gaps(runs[1], runs[0])
            row = {"problem": name, "iterations": n,
                   "final_cost": runs[0]["info"]["final_cost"],
                   "bit_equal": chip_smoke.lm_bit_equal(runs[1], runs[0]),
                   "candidate_launches": launches,
                   "launches_ok": launches == [
                       r["info"]["iterations"] + 1 for r in runs], **gap}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(r["bit_equal"] and r["launches_ok"] for r in main())
             else 1)
