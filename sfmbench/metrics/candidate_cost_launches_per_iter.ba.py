"""Launches of the LM candidate kernel (``ops/csrc/ba_candidate_cost.cu``)
per LM iteration: device events whose name holds the kernel's, counted
over the traced solves.  Every LM iteration evaluates its candidate once
and every solve its initial cost once, so a program that evaluates both
through the kernel reads (iterations + solves) / iterations; one that
does not has no such event and reads nothing."""
import re

LAYER = "kernels (ops/csrc)"
UNIT = "launches/iter"
MOVES = "ba_solves_per_min"
SOURCE = "device_trace"
PATTERN = r"ba_candidate_cost_kernel"


def read(record):
    tr = record["trace"]
    rx = re.compile(PATTERN)
    n = sum(1 for name, _, _ in tr.device if rx.search(name))
    if not n or not getattr(tr, "iterations", 0):
        return None
    return n / tr.iterations
