"""The linearize kernel's readers (`linearize_launches_per_iter.ba`,
`linearize_device_ms_per_iter.ba`) on hand-built traces: the kernel's
device events counted and timed per LM iteration; nothing where the
trace holds none of them (a program that linearizes without the kernel,
or a run on the CPU)."""
import pytest
import torch

from sfmbench import run
from sfmbench.core import spec
from sfmbench.core.trace import Trace
from sfmbench.tests.test_sfmbench_run import SEED, small

KERNEL = ("void (anonymous namespace)::ba_linearize_kernel<float>(float "
          "const*, float const*, float const*, long long const*, long long "
          "const*, float const*, float const*, unsigned char const*, long "
          "long, int, float, float, float*, float*, float*, float*)")
OTHER = [("void (anonymous namespace)::segsum_rows<float, 9>(...)", 0.0,
          0.001), ("void at::native::elementwise_kernel<128, 2>(...)", 0.002,
                   0.0035)]
NAMES = ["linearize_launches_per_iter.ba", "linearize_device_ms_per_iter.ba"]


def trace(device, iterations):
    tr = Trace(sorted(device, key=lambda x: x[1]), [], 0.05)
    tr.iterations = iterations
    return tr


def read(name, tr):
    return spec.metric(name).read({"trace": tr})


@pytest.mark.parametrize("launches,iterations", [(3, 3), (6, 3), (1, 4)])
def test_readers_on_a_known_trace(launches, iterations):
    dev = OTHER + [(KERNEL, 0.01 * i, 0.01 * i + 25e-6)
                   for i in range(launches)]
    tr = trace(dev, iterations)
    assert read(NAMES[0], tr) == pytest.approx(launches / iterations,
                                               rel=1e-12)
    assert read(NAMES[1], tr) == pytest.approx(
        1e3 * launches * 25e-6 / iterations, rel=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_readers_are_silent_without_the_kernel(name):
    assert read(name, trace(OTHER, 5)) is None
    assert read(name, trace([], 5)) is None
    assert read(name, trace(OTHER + [(KERNEL, 0.01, 0.02)], 0)) is None


def test_a_traced_run_on_the_cpu_leaves_them_out():
    """On the CPU the plain version linearizes: no device event, so the
    result line has neither metric (and no 0 in their place)."""
    res, _ = run.execute(small("uav_local_ba400"), SEED, 0.5, 1,
                         torch.device("cpu"))
    for name in NAMES:
        assert name not in res["metrics"]
