"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric is found by name and is well formed."""
import json
import os
import re

import pytest

from sfmbench.core import spec

B = spec.benchmark()
TEXT = re.compile(r"^[^\n\t]{1,200}$")
LAYER_NAMES = {m["layer"] for m in B["per_layer"]}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["sfmbench"]
    assert 1 <= len(B["command"]) <= 32
    for word in B["command"]:
        assert TEXT.match(word) and not word.startswith("/")
        assert ".." not in word
    assert os.path.exists(os.path.join(spec.ROOT, B["command"][1]))
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(B)) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in B["configs"]]
             + [w["name"] for w in B["workloads"]]
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]]
             + [w["traffic"] for w in B["workloads"]])
    for n in names:
        assert spec.NAME.match(n), n
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in B[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(ms) == len(set(ms))
    for m in B["end_to_end"] + B["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert TEXT.match(cfg["source"]) and TEXT.match(cfg["why"])
    assert cfg["file"] == f"sfmbench/configs/{cfg['name']}.json"
    body = spec.load_json("configs", cfg["name"])
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert TEXT.match(body["source"])
    assert set(body["reduced"]) <= set(body["assumed"])
    for k in cfg["reduced"]:
        assert spec.NAME.match(k)
        assert not re.search(r"(_dim|_rank|width|height|size)$", k)
    assert any(w["config"] == cfg["name"] for w in B["workloads"])


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    cell = spec.cell(w["name"])
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
    assert hasattr(spec.driver(cell), "Driver")
    e2e = [m for m in B["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    moved = {m["name"] for m in e2e}
    assert any(w["name"] in m.get("workloads", [w["name"]])
               and m["moves"] in moved for m in B["per_layer"])
    pairs = [(x["config"], x["traffic"]) for x in B["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_end_to_end():
    names = [m["name"] for m in B["end_to_end"]]
    assert "setup_s" in names
    cells = {w["name"] for w in B["workloads"]}
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_file(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert TEXT.match(m["layer"])
    mod = spec.metric(m["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        m["layer"], m["unit"], m["moves"], m["source"])
    assert callable(mod.read)
    e2e = {x["name"]: x for x in B["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    for cell in m.get("workloads", []):
        assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_layers_are_in_perf_md():
    with open(os.path.join(spec.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in LAYER_NAMES:
        assert layer in perf, layer


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(spec.BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
