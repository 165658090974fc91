"""Device idle per LM iteration while ``ba/lm/camera_solve`` is the innermost
stage span of the traced solves (``sfmbench.core.spans.idle_split``)."""
from sfmbench.core import spans

LAYER = "bundle adjustment (ba/lm, ba/problem)"
UNIT = "ms"
MOVES = "ba_solves_per_min"
SOURCE = "program_span"


def read(record):
    return spans.idle_ms_per_iter(record["trace"], "ba/lm/camera_solve")
