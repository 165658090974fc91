"""Device time of the segment-sum kernel per LM iteration, summed by
kernel name over the traced solve."""
LAYER = "kernels (ops/csrc)"
UNIT = "ms"
MOVES = "ba_solves_per_min"
SOURCE = "device_trace"
PATTERN = r"segsum_"


def read(record):
    tr = record["trace"]
    s = tr.device_s(PATTERN)
    if s <= 0 or not getattr(tr, "iterations", 0):
        return None
    return 1e3 * s / tr.iterations
