"""The span metrics (core/spans.py and the seven readers) on hand-built
traces with known spans and gaps, and on a run at a test size on the CPU,
where no device op runs."""
import random

import pytest
import torch

from sfmbench import run
from sfmbench.core import spans, spec
from sfmbench.core.trace import Trace
from sfmbench.tests.test_sfmbench_run import SEED, small

IDLE = ["linearize_idle_ms_per_iter.ba", "reduce_idle_ms_per_iter.ba",
        "camera_solve_idle_ms_per_iter.ba", "step_idle_ms_per_iter.ba",
        "solve_self_idle_ms_per_iter.ba"]
READS = ["lm_host_reads_per_iter.ba", "lm_read_wait_ms_per_iter.ba"]

# one solve of two LM iterations in a 10 s window; busy 0.5-1, 2-3,
# 4-4.5, 6-9; idle 0-0.5, 1-2, 3-4, 4.5-6, 9-10 (5 s)
DEVICE = [("k0", 0.5, 1.0), ("k1", 2.0, 3.0), ("k2", 4.0, 4.5),
          ("k3", 6.0, 9.0)]
HOST = [("ba/lm/solve", 0.2, 8.0),
        ("ba/lm/read.initial_cost", 0.22, 0.25),
        ("ba/lm/plans", 0.3, 0.8), ("segsum/read.plan", 0.6, 0.7),
        ("aten::argsort", 0.4, 0.5),
        ("ba/lm/iteration", 1.0, 4.0),
        ("ba/lm/linearize", 1.0, 1.5), ("ba/lm/reduce", 1.5, 2.5),
        ("ba/lm/camera_solve", 2.5, 3.5), ("ba/lm/step", 3.5, 4.0),
        ("ba/lm/read.cost", 3.7, 3.9),
        ("ba/lm/iteration", 4.0, 7.5),
        ("ba/lm/linearize", 4.0, 5.0), ("ba/lm/reduce", 5.0, 5.5),
        ("ba/lm/camera_solve", 5.5, 6.5), ("ba/lm/step", 6.5, 7.5),
        ("ba/lm/read.cost", 7.0, 7.4),
        ("ba/lm/read.n_obs", 7.8, 7.9),
        # outside the solve: not the solver's
        ("segsum/read.plan", 8.5, 8.6), ("ba/lm/linearize", 9.2, 9.4)]
EXPECT = {"lm_host_reads_per_iter.ba": 5 / 2,
          "lm_read_wait_ms_per_iter.ba": 1e3 * 0.83 / 2,
          "linearize_idle_ms_per_iter.ba": 1e3 * 1.0 / 2,
          "reduce_idle_ms_per_iter.ba": 1e3 * 1.0 / 2,
          "camera_solve_idle_ms_per_iter.ba": 1e3 * 1.0 / 2,
          "step_idle_ms_per_iter.ba": 1e3 * 0.5 / 2,
          "solve_self_idle_ms_per_iter.ba": 1e3 * 0.3 / 2}


def trace(device=DEVICE, host=HOST, window=10.0):
    return Trace(sorted(device, key=lambda x: x[1]),
                 sorted(host, key=lambda x: (x[1], -x[2])), window)


def read(name, tr):
    return spec.metric(name).read({"trace": tr})


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_on_a_known_trace(name):
    assert read(name, trace()) == pytest.approx(EXPECT[name], rel=1e-12)


def test_idle_split_on_a_known_trace():
    split = spans.idle_split(trace())
    assert split == pytest.approx({
        "ba/lm/linearize": 1.0, "ba/lm/reduce": 1.0,
        "ba/lm/camera_solve": 1.0, "ba/lm/step": 0.5, "solve_self": 0.3,
        "outside": 1.2}, abs=1e-12)
    assert spans.iterations(trace()) == 2


@pytest.mark.parametrize("seed", range(4))
def test_idle_parts_add_up_to_the_window_idle(seed):
    """The five idle metrics times the iterations, plus the idle outside
    ba/lm/solve, are the window's idle, on random device activity."""
    rng = random.Random(seed)
    dev = []
    for _ in range(40):
        a = rng.uniform(0, 9.6)   # inside the window, as a capture is
        dev.append((f"k{len(dev)}", a, a + rng.uniform(0.001, 0.3)))
    tr = trace(device=dev)
    its = spans.iterations(tr)
    parts = sum(read(n, tr) for n in IDLE) * its / 1e3
    outside = spans.idle_split(tr)["outside"]
    assert parts + outside == pytest.approx(tr.window_s - tr.busy_s(),
                                            abs=1e-9)


def test_readers_are_silent_without_spans_or_device():
    no_spans = trace(host=[("aten::mul", 1.0, 2.0)])
    for name in READS + IDLE:
        assert read(name, no_spans) is None
    no_device = trace(device=[])
    for name in IDLE:
        assert read(name, no_device) is None
    for name in READS:
        assert read(name, no_device) == pytest.approx(EXPECT[name])


def test_a_traced_run_on_the_cpu():
    """The program's own spans reach the result line: a read count per
    iteration; the idle readers give None (no device op), never 0."""
    res, _ = run.execute(small("uav_local_ba400"), SEED, 0.5, 1,
                         torch.device("cpu"))
    m = res["metrics"]
    assert m["lm_host_reads_per_iter.ba"]["value"] > 1
    assert m["lm_host_reads_per_iter.ba"]["unit"] == "reads/iter"
    assert m["lm_read_wait_ms_per_iter.ba"]["value"] > 0
    for name in IDLE:
        assert name not in m
