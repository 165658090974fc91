"""Finding the benchmark's pieces by name.

A cell is ``workloads/<cell>.json``, its configuration
``configs/<config>.json``, its traffic mix ``mixes/<traffic>.json``, whose
``driver`` names ``traffic/<driver>.py``, and a per-layer metric
``metrics/<metric>.py``.  Adding a cell, a configuration, a mix or a metric
is adding files: nothing here lists them.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, check_name(name) + ".json")) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell with its configuration and mix resolved."""
    c = load_json("workloads", name)
    c["name"] = name
    c["config_spec"] = load_json("configs", c["config"])
    c["mix"] = load_json("mixes", c["traffic"])
    return c


def driver(c: dict):
    return importlib.import_module(
        f"sfmbench.traffic.{check_name(c['mix']['driver'])}")


def metric(name: str):
    """The module of a per-layer metric: LAYER, UNIT, MOVES, SOURCE and
    read(record) -> float or None."""
    path = os.path.join(BENCH, "metrics", check_name(name) + ".py")
    spec = importlib.util.spec_from_file_location(
        "sfmbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

