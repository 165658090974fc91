"""The probe builds of tools/probe_sgm.py still make the edits they claim
on the current kernel source (the builds and their times need the card)."""
import importlib.util
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "probe_sgm", os.path.join(ROOT, "tools", "probe_sgm.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

with open(os.path.join(probe.cuda_build.CSRC, f"{probe.LIB}.cu")) as _f:
    SRC = _f.read()


@pytest.mark.parametrize("variant", sorted(probe.EDITS))
def test_probe_edit_applies_and_keeps_the_entries(variant):
    out = probe.probe_source(variant)
    assert out != SRC
    for entry in re.findall(r'extern "C" int (\w+)', SRC):
        assert f'extern "C" int {entry}' in out
    # only chain_kernel (2d, 2e) and their entries change: the 2f/2g path
    # kernel is the same text
    start = SRC.index("path_kernel(")
    end = SRC.index("// ---- 2d and 2e")
    assert SRC[start:end] in out


def test_probe_edits_cut_what_they_name():
    assert "__reduce_min_sync(kFull" not in probe.probe_source("no redux")
    assert "warp_min(lm)" in probe.probe_source("shuffle min")
    assert "load(ring[s], t + A)" not in probe.probe_source("no loads")
    assert len(probe.STORE.findall(SRC)) == 2
    assert probe.probe_source("no stores").count("if (a.p2 < 0)") == 2
    first = probe.probe_source("first launch only")
    assert "run_chains<kAhead2d, 1, false, false>" not in first
    assert "run_chains<kAhead2e, 2, true, false>" not in first
    assert "kAhead2d = 64;" in probe.probe_source("2d ahead 64")
    assert "kAhead2e = 4;" in probe.probe_source("2e ahead 4")


def test_probe_edit_that_no_longer_matches_raises(monkeypatch):
    monkeypatch.setitem(probe.EDITS, "no loads", [(r"no such code", "", 1)])
    with pytest.raises(ValueError):
        probe.probe_source("no loads")
