"""The probe builds of tools/probe_segsum.py still set the constants they
name in the current segsum source, and nothing else (the builds and their
times need the card)."""
import importlib.util
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "probe_segsum", os.path.join(ROOT, "tools", "probe_segsum.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

CONSTANT = re.compile(r"constexpr int (\w+) = (\d+);")


@pytest.mark.parametrize("variant", sorted(probe.VARIANTS))
def test_probe_sets_only_its_constants(variant):
    from metricsfm_tpu_torch.ops import cuda_build, segsum

    with open(os.path.join(cuda_build.CSRC, "segsum.cu")) as f:
        src = f.read()
    out = probe.probe_source(variant)
    before, after = dict(CONSTANT.findall(src)), dict(CONSTANT.findall(out))
    want = {k: str(v) for k, v in probe.VARIANTS[variant].items()}
    assert set(want) <= set(before)
    assert {k: v for k, v in after.items() if before[k] != v} == {
        k: v for k, v in want.items() if before[k] != v}
    assert CONSTANT.sub("", src) == CONSTANT.sub("", out)
    # the plans a variant's build is timed on use its block size
    assert probe.chunk_of(variant) == int(after["kChunk"])
    if variant == "as built":
        assert int(before["kChunk"]) == segsum.CHUNK
