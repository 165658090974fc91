"""The candidate kernel's readers (`candidate_cost_launches_per_iter.ba`,
`candidate_cost_device_ms_per_iter.ba`) on hand-built traces: the
kernel's device events counted and timed per LM iteration (an LM
iteration's candidate and a solve's initial cost each launch it once);
nothing where the trace holds none of them (a program that evaluates its
candidates without the kernel, or a run on the CPU)."""
import pytest
import torch

from sfmbench import run
from sfmbench.core import spec
from sfmbench.tests.test_sfmbench_linearize import KERNEL as LINEARIZE
from sfmbench.tests.test_sfmbench_linearize import OTHER, read, trace
from sfmbench.tests.test_sfmbench_reduce_slots import KERNEL as REDUCE
from sfmbench.tests.test_sfmbench_run import SEED, small

KERNEL = ("void (anonymous namespace)::ba_candidate_cost_kernel<float>("
          "float const*, float const*, float const*, long long const*, "
          "long long const*, float const*, float const*, unsigned char "
          "const*, float const*, float const*, float const*, float const*, "
          "float const*, float const*, float const*, long long, int, int, "
          "int, int, float, float, float*, float*, float*, float*, double*, "
          "int*)")
NAMES = ["candidate_cost_launches_per_iter.ba",
         "candidate_cost_device_ms_per_iter.ba"]


@pytest.mark.parametrize("solves,iterations", [(1, 3), (2, 9), (4, 4)])
def test_readers_on_a_known_trace(solves, iterations):
    """Each solve's initial cost and each iteration's candidate: the
    launches read (iterations + solves) / iterations."""
    launches = iterations + solves
    dev = OTHER + [(LINEARIZE, 0.01 * i, 0.01 * i + 40e-6)
                   for i in range(iterations)] \
        + [(REDUCE, 0.01 * i + 0.002, 0.01 * i + 0.002 + 120e-6)
           for i in range(iterations)] \
        + [(KERNEL, 0.01 * i + 0.005, 0.01 * i + 0.005 + 15e-6)
           for i in range(launches)]
    tr = trace(dev, iterations)
    assert read(NAMES[0], tr) == pytest.approx(launches / iterations,
                                               rel=1e-12)
    assert read(NAMES[1], tr) == pytest.approx(
        1e3 * launches * 15e-6 / iterations, rel=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_readers_are_silent_without_the_kernel(name):
    assert read(name, trace(OTHER, 5)) is None
    assert read(name, trace(OTHER + [(LINEARIZE, 0.01, 0.02),
                                     (REDUCE, 0.03, 0.04)], 5)) is None
    assert read(name, trace([], 5)) is None
    assert read(name, trace(OTHER + [(KERNEL, 0.01, 0.02)], 0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_declared_in_the_benchmark(name):
    m = spec.metric(name)
    (entry,) = [e for e in spec.benchmark()["per_layer"]
                if e["name"] == name]
    assert (entry["unit"], entry["source"], entry["layer"],
            entry["moves"]) == (m.UNIT, m.SOURCE, m.LAYER, m.MOVES)
    assert entry["workloads"] == ["uav_local_ba400"]


def test_a_traced_run_on_the_cpu_leaves_them_out():
    """On the CPU the plain version evaluates the candidates: no device
    event, so the result line has neither metric (and no 0 in their
    place)."""
    res, _ = run.execute(small("uav_local_ba400"), SEED, 0.5, 1,
                         torch.device("cpu"))
    for name in NAMES:
        assert name not in res["metrics"]
