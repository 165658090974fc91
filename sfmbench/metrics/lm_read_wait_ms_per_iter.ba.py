"""Host time spent waiting in the LM solver's blocking reads per LM
iteration: the summed duration of the read spans (``*/read.*``) inside
the traced ``ba/lm/solve`` spans over their ``ba/lm/iteration`` spans."""
from sfmbench.core import spans

LAYER = "bundle adjustment (ba/lm, ba/problem)"
UNIT = "ms"
MOVES = "ba_solves_per_min"
SOURCE = "program_span"


def read(record):
    return spans.per_iteration(
        record["trace"],
        lambda tr: 1e3 * sum(b - a for a, b in spans.reads(tr)))
