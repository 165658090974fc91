"""Device idle per LM iteration inside the traced ``ba/lm/solve`` spans
but in no stage span: the plans, the initial cost, the loop's
bookkeeping and the final count (``sfmbench.core.spans.idle_split``)."""
from sfmbench.core import spans

LAYER = "bundle adjustment (ba/lm, ba/problem)"
UNIT = "ms"
MOVES = "ba_solves_per_min"
SOURCE = "program_span"


def read(record):
    return spans.idle_ms_per_iter(record["trace"], "solve_self")
