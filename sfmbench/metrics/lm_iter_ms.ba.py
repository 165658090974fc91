"""Wall time of one LM iteration over the window: the window's wall over
the iterations that ``solve_lm`` reports in ``info["iterations"]``."""
LAYER = "bundle adjustment (ba/lm, ba/problem)"
UNIT = "ms"
MOVES = "ba_solves_per_min"
SOURCE = "host_clock"


def read(record):
    win = record["window"]
    if not win.get("iterations"):
        return None
    return 1e3 * win["wall_s"] / win["iterations"]
