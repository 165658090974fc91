"""Launches of the dense-Schur reduce kernel
(``ops/csrc/ba_reduce_slots.cu``) per LM iteration: device events whose
name holds the kernel's, counted over the traced solves.  Every dense LM
iteration reduces its slots once, so a program that reduces through the
kernel reads 1.0; one that does not has no such event and reads
nothing."""
import re

LAYER = "kernels (ops/csrc)"
UNIT = "launches/iter"
MOVES = "ba_solves_per_min"
SOURCE = "device_trace"
PATTERN = r"ba_reduce_slots_kernel"


def read(record):
    tr = record["trace"]
    rx = re.compile(PATTERN)
    n = sum(1 for name, _, _ in tr.device if rx.search(name))
    if not n or not getattr(tr, "iterations", 0):
        return None
    return n / tr.iterations
