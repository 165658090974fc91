"""Device time of the LM candidate kernel
(``ops/csrc/ba_candidate_cost.cu``) per LM iteration, summed over the
traced solves (the solves' initial costs included); nothing where no
device event holds the kernel's name."""
LAYER = "kernels (ops/csrc)"
UNIT = "ms"
MOVES = "ba_solves_per_min"
SOURCE = "device_trace"
PATTERN = r"ba_candidate_cost_kernel"


def read(record):
    tr = record["trace"]
    s = tr.device_s(PATTERN)
    if s <= 0 or not getattr(tr, "iterations", 0):
        return None
    return 1e3 * s / tr.iterations
