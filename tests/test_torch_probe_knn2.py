"""The probe builds of tools/probe_knn2.py still cut what they claim from the
current kernel sources (the builds and their times need the card)."""
import importlib.util
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "probe_knn2", os.path.join(ROOT, "tools", "probe_knn2.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

WGMMA = re.compile(r"hopper::wgmma_\w+<[01]>\(")


@pytest.mark.parametrize("lib", ["knn2", "knn2_int8"])
@pytest.mark.parametrize("variant", ["product only", "fold only"])
def test_probe_edit_cuts_only_its_half(lib, variant):
    with open(os.path.join(probe.cuda_build.CSRC, f"{lib}.cu")) as f:
        src = f.read()
    out = probe.probe_source(lib, variant)
    assert len(WGMMA.findall(src)) == 2
    if variant == "product only":
        # the product stays; the fold's top-2 updates are gone
        assert len(WGMMA.findall(out)) == 2
        assert "fold_tile_top2(r[1]" not in out
        assert out.count(probe.ONE_READ) == 1
        assert "min(b0" not in out and "minf(b0" not in out
    else:
        # the fold stays; no wgmma is issued
        assert not WGMMA.findall(out)
        assert "fold_tile_top2(r[1]" in out
        assert "wgmma_commit()" in out
    # nothing but the edited span changes: the entries are all still there
    for entry in re.findall(r'extern "C" int (\w+)', src):
        assert f'extern "C" int {entry}' in out


def test_probe_edit_that_no_longer_matches_raises(monkeypatch):
    monkeypatch.setitem(probe.EDITS, ("knn2", "fold only"),
                        (r"no such code", ""))
    with pytest.raises(ValueError):
        probe.probe_source("knn2", "fold only")
