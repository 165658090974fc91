"""A run, end to end, at a test size on the CPU: the last line's schema,
the no-JAX check, and `correct` coming out false for the control and for
each fault the BA cells can have.  The card's own runs are in the `card`
test at the end."""
import json
import subprocess
import sys

import pytest
import torch

from sfmbench import run
from sfmbench.core import spec

SEED = 2 ** 31 + 4099
# the BA cells: uav_local_ba400 is in BENCHMARK.json; uav_full_ba400's
# files wait there for a fix of the program (PERF.md, Open questions 1)
CELLS = ["uav_full_ba400", "uav_local_ba400"]
BENCH_CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(name):
    """The cell with its survey cut to a test size (limits kept)."""
    cell = spec.cell(name)
    cell["config_spec"]["survey"].update(grid=[4, 6], obs_per_view=400)
    if "around_views" in cell["mix"]:
        cell["mix"]["around_views"] = 3
    return cell


def execute(cell, trace=0, solver="program", seconds=0.5):
    return run.execute(cell, SEED, seconds, trace, torch.device("cpu"),
                       solver)


@pytest.mark.parametrize("name", BENCH_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(name, trace):
    res, checks = execute(small(name), trace)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] >= 1 and isinstance(line["correct"], bool)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    e2e, layer = run.cell_metrics(name)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no device op runs: the device readers stay silent
        assert "lm_iter_ms.ba" in line["metrics"]
        assert set(line["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for n, v in line["checks"].items():
        assert set(v) == {"value", "limit"}
    assert [c[0] for c in checks] == list(line["checks"])


def test_no_jax_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "metricsfm_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.jax_modules() == []
    monkeypatch.setitem(sys.modules, "metricsfm_tpu.ops", sys)
    assert run.jax_modules() == ["metricsfm_tpu"]


def test_a_run_imports_no_jax():
    code = ("import sys; sys.argv = ['run']; import torch; "
            "from sfmbench import run; from sfmbench.core import spec; "
            "from sfmbench.traffic import ba_solves; "
            "import metricsfm_tpu_torch.ba.lm; "
            "print(run.jax_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "sfmbench/run.py", "--workload",
                          CELLS[0], "--seed", str(SEED), "--seconds", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def _faults():
    from metricsfm_tpu_torch.ba import lm
    real = lm.solve_lm

    def unchanged(prob, cfg, reduce=None):
        c = float(lm.problem_cost(prob, cfg.huber_delta))
        return prob, {"initial_cost": c, "final_cost": c, "iterations": 1}

    def half_batch(prob, cfg, reduce=None):
        keep = torch.arange(prob.n_points) % 2 == 0
        out, info = real(prob._replace(
            track_mask=prob.track_mask & keep[:, None]), cfg)
        return out._replace(track_mask=prob.track_mask), info

    def altered(prob, cfg, reduce=None):
        out, info = real(prob, cfg)
        poses = out.poses.clone()
        poses[1, :3] += 0.01
        return out._replace(poses=poses), info

    return {"unchanged": unchanged, "half_batch": half_batch,
            "altered": altered}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    from metricsfm_tpu_torch.ba import lm
    monkeypatch.setattr(lm, "solve_lm", _faults()[fault])
    cell = small(name)
    assert cell["limits"]
    res, _ = execute(cell)
    assert res["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The plain reference in the program's place, its products in TF32."""
    cell = small(name)
    assert cell["limits"]
    res, _ = execute(cell, solver="control")
    assert res["correct"] is False


def test_the_program_is_correct_at_a_test_size():
    res, _ = execute(small("uav_full_ba400"))
    assert res["correct"] is True and res["failed"] == 0


@pytest.fixture
def card():
    """Skips where no NVIDIA GPU is found (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "sfmbench/run.py", "--workload",
                          CELLS[1], "--seed", str(SEED), "--seconds", "2"],
                         capture_output=True, text=True, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
