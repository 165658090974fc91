"""The port's tracer (utils/tracing): totals and counts as before, and each
span a CPU-op range of a running torch profiler, nested in its parent;
and the LM solver's stage and read spans on both of its paths."""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metricsfm_tpu_torch.ba import LMConfig as TLM
from metricsfm_tpu_torch.ba import lm as tlm
from metricsfm_tpu_torch.utils import tracing
from tests.test_torch_ba import _carry, _problem
from tests.torch_threads import torch_threads  # noqa: F401

STAGES = ["ba/lm/linearize", "ba/lm/reduce", "ba/lm/camera_solve",
          "ba/lm/step"]


def _ranges(prof):
    """(name, start_ns, end_ns, is_user_annotation, device_type) of every
    event the profiler kept whose name has a '/' (the spans), by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(),
                    e.is_user_annotation(), e.device_type())
                   for e in prof.profiler.kineto_results.events()
                   if "/" in e.name()), key=lambda r: (r[1], -r[2]))


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_tracer_totals_counts_and_sync():
    tr = tracing.Tracer()
    for _ in range(3):
        with tr.span("a/x"):
            with tr.span("a/y", sync=True):   # no card: nothing to wait for
                pass
    with pytest.raises(ValueError):
        with tr.span("a/x"):
            raise ValueError("the block's error goes through")
    assert dict(tr.counts) == {"a/x": 4, "a/y": 3}
    assert tr.totals["a/x"] >= tr.totals["a/y"] >= 0
    assert set(tr.as_dict()) == {"a/x", "a/y"}
    assert tr.as_dict()["a/y"]["count"] == 3
    assert tr.report().splitlines()[0].startswith("a/x")
    tr.reset()
    assert not tr.totals and not tr.counts
    assert not hasattr(tr, "dump")


def test_span_is_a_cpu_op_nested_in_its_parent():
    tr = tracing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer/stage"):
            with tr.span("outer/read.x"):
                torch.ones(4).sum()
    rows = _ranges(prof)
    assert [r[0] for r in rows] == ["outer/stage", "outer/read.x"]
    for name, a, b, annotation, dev in rows:
        assert not annotation and dev == torch.autograd.DeviceType.CPU
        assert b > a
    assert _within(rows[1], rows[0])
    parents = {e.name: e.cpu_parent for e in prof.events()}
    assert parents["outer/read.x"].name == "outer/stage"
    assert parents["aten::ones"].name == "outer/read.x"
    # the tracer still counts them
    assert dict(tr.counts) == {"outer/stage": 1, "outer/read.x": 1}


def test_no_range_without_a_profiler(monkeypatch):
    opened = []

    class Fake:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_RecordFunctionFast", Fake)
    tr = tracing.Tracer()
    with tr.span("a/off"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("a/on"):
            pass
    assert opened == ["a/on"]
    assert dict(tr.counts) == {"a/off": 1, "a/on": 1}


@pytest.mark.parametrize("cg", [0, 30], ids=["dense", "pcg"])
def test_lm_stage_and_read_spans(cg):
    """One ba/lm/solve; one ba/lm/iteration per LM iteration, each holding
    the four stage spans in order; the cost read in each step; and the
    solve's own reads: the initial cost, the prior check, one per segment
    plan (5 dense, 3 PCG), the observation count; PCG polls its flag
    inside the camera solve."""
    prob = _carry(_problem(3, n_cams=6, n_pts=150, noise_px=1.0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = tlm.solve_lm(prob, TLM(max_iterations=3, cg_iterations=cg))
    rows = [r for r in _ranges(prof)
            if r[0].startswith(("ba/lm/", "segsum/"))]
    for r in rows:
        assert not r[3] and r[4] == torch.autograd.DeviceType.CPU
    by = {}
    for r in rows:
        by.setdefault(r[0], []).append(r)
    (solve,) = by["ba/lm/solve"]
    assert all(_within(r, solve) for r in rows)
    its = by["ba/lm/iteration"]
    assert len(its) == info["iterations"] >= 1
    for it in its:
        kids = [r for r in rows if r[0] in STAGES and _within(r, it)]
        assert [r[0] for r in kids] == STAGES
        assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))
        step = kids[-1]
        assert [r[0] for r in rows if "/read." in r[0]
                and _within(r, step)] == ["ba/lm/read.cost"]
    (plans,) = by["ba/lm/plans"]
    assert len(by["segsum/read.plan"]) == (5 if cg == 0 else 3)
    assert all(_within(r, plans) for r in by["segsum/read.plan"])
    for name in ("ba/lm/read.initial_cost", "ba/lm/read.priors",
                 "ba/lm/read.n_obs"):
        assert len(by[name]) == 1 and not _within(by[name][0], its[0])
    reads = {n: len(v) for n, v in by.items() if "/read." in n}
    polls = reads.pop("ba/lm/read.cg_poll", 0)
    assert reads == {"ba/lm/read.initial_cost": 1, "ba/lm/read.priors": 1,
                     "segsum/read.plan": 5 if cg == 0 else 3,
                     "ba/lm/read.cost": info["iterations"],
                     "ba/lm/read.n_obs": 1}
    if cg == 0:
        assert polls == 0
    else:
        per_step = math.ceil(cg / tlm.CG_POLL)
        assert info["iterations"] <= polls <= per_step * info["iterations"]
        cams = by["ba/lm/camera_solve"]
        assert all(any(_within(p, c) for c in cams)
                   for p in by["ba/lm/read.cg_poll"])
