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
    # only the aggregation kernels 2d-2g and their launches change: 2h's
    # wta_maps_kernel is the same text
    start = SRC.index("// 2h: one warp per pixel")
    end = SRC.index("unsigned warp_blocks(")
    assert "wta_maps_kernel(" in SRC[start:end]
    assert SRC[start:end] in out


def test_probe_edits_cut_what_they_name():
    assert "__reduce_min_sync(kFull, lm)" not in probe.probe_source("no redux")
    assert "warp_min(lm)" in probe.probe_source("shuffle min")
    assert "load(ring[s], t + A)" not in probe.probe_source("no loads")
    assert len(probe.STORE.findall(SRC)) == 2
    assert probe.probe_source("no stores").count("if (a.p2 < 0)") == 2
    first = probe.probe_source("first launch only")
    assert "run_chains<kAhead2d, 1, false, false>" not in first
    assert "run_chains<AHEAD, 2, true, false>" not in first
    assert "kAhead2d = 64;" in probe.probe_source("2d ahead 64")
    e4 = probe.probe_source("2e ahead 4")
    assert "vertical_paths<4>(cost, hsum" in e4
    assert e4.count("vertical_paths<kAhead2e>(cost, partial") == 2
    up = probe.probe_source("up ahead 16")
    assert up.count("vertical_paths<16>(cost, partial") == 2
    assert "vertical_paths<kAhead2e>(cost, hsum" in up
    assert "return wta_tiles(" not in probe.probe_source("2f without WTA")
    assert "kWtaTile = 256;" in probe.probe_source("WTA tile 256")


def test_probe_edit_that_no_longer_matches_raises(monkeypatch):
    monkeypatch.setitem(probe.EDITS, "no loads", [(r"no such code", "", 1)])
    with pytest.raises(ValueError):
        probe.probe_source("no loads")
