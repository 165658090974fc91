"""The probe builds of tools/probe_sgm.py still make the edits they claim
on the current kernel sources (the builds and their times need the card)."""
import importlib.util
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "probe_sgm", os.path.join(ROOT, "tools", "probe_sgm.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)


def _source(lib):
    with open(os.path.join(probe.cuda_build.CSRC, f"{lib}.cu")) as f:
        return f.read()


SRCS = {lib: _source(lib) for lib in (probe.LIB, probe.CENSUS)}
SRC = SRCS[probe.LIB]


def _between(src, start, end):
    return src[src.index(start):src.index(end)]


# 2h's kernel and its launch helper; chain_kernel (2d-2g)
WTA_2H = _between(SRC, "// ---- 2h: the left WTA maps", "bool bad_shape(")
CHAIN = _between(SRC, "template <int K, int AHEAD, bool VEC, typename S",
                 "// ---- 2f's WTA")


@pytest.mark.parametrize("variant", sorted(probe.EDITS))
def test_probe_edit_applies_and_keeps_the_entries(variant):
    src = SRCS[probe.lib_of(variant)]
    out = probe.probe_source(variant)
    assert out != src
    for entry in re.findall(r'extern "C" int (\w+)', src):
        assert f'extern "C" int {entry}' in out
    if variant.startswith("2c "):
        # 2c's edits are of sgm_census.cu: chain_kernel and 2h build as
        # they are
        assert probe.lib_of(variant) == probe.CENSUS
        assert "chain_kernel" not in out
    elif variant.startswith("2h "):
        # 2h's edits leave chain_kernel the same text
        assert "wta_stream_kernel(" in WTA_2H
        assert CHAIN in out
    else:
        # the 2d-2g edits leave 2h's kernel the same text
        assert WTA_2H in out


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
    # 2h
    assert "if (dm < 0) step(ring[s], t0 + s);" in probe.probe_source(
        "2h loads only")
    assert "kWta2hWarps = 8;" in probe.probe_source("2h warps 8")
    assert "kWta2hWarps = 16;" in probe.probe_source("2h warps 16")
    assert "kWta2hRing = 16;" in probe.probe_source("2h ring 16")
    assert "kWta2hRing = 64;" in probe.probe_source("2h ring 64")
    # 2c
    store = probe.probe_source("2c store only")
    assert store.count("if (h < 0)") == 3 and "if (w > 0) {" in store
    assert "__popc" not in probe.probe_source("2c no popc")
    assert "h < 0 && p < np;" in probe.probe_source("2c census only")
    assert "kTile = 64;" in probe.probe_source("2c tile 64")
    assert "kTile = 128;" in probe.probe_source("2c tile 128")
    assert "__stcs((uint4*)out, make_uint4(" in probe.probe_source(
        "2c streaming stores")


def test_probe_edit_that_no_longer_matches_raises(monkeypatch):
    monkeypatch.setitem(probe.EDITS, "no loads", [(r"no such code", "", 1)])
    with pytest.raises(ValueError):
        probe.probe_source("no loads")
