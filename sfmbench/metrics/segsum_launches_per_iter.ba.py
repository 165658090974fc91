"""Launches of the segment-sum kernel per LM iteration over the window,
from the difference of ``ops.segsum.segment_sum.launches``."""
LAYER = "kernels (ops/csrc)"
UNIT = "launches/iter"
MOVES = "ba_solves_per_min"
SOURCE = "program_counter"


def read(record):
    win = record["window"]
    if not win.get("iterations") or not win.get("segsum_launches"):
        return None
    return win["segsum_launches"] / win["iterations"]
