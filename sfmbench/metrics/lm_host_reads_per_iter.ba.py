"""Blocking device-to-host reads of the LM solver per LM iteration: the
read spans (``*/read.*``) inside the traced ``ba/lm/solve`` spans over
their ``ba/lm/iteration`` spans."""
from sfmbench.core import spans

LAYER = "bundle adjustment (ba/lm, ba/problem)"
UNIT = "reads/iter"
MOVES = "ba_solves_per_min"
SOURCE = "program_span"


def read(record):
    return spans.per_iteration(record["trace"],
                               lambda tr: len(spans.reads(tr)))
