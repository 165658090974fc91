"""Device time of the dense-Schur reduce kernel
(``ops/csrc/ba_reduce_slots.cu``) per LM iteration, summed over the
traced solves; nothing where no device event holds the kernel's name."""
LAYER = "kernels (ops/csrc)"
UNIT = "ms"
MOVES = "ba_solves_per_min"
SOURCE = "device_trace"
PATTERN = r"ba_reduce_slots_kernel"


def read(record):
    tr = record["trace"]
    s = tr.device_s(PATTERN)
    if s <= 0 or not getattr(tr, "iterations", 0):
        return None
    return 1e3 * s / tr.iterations
