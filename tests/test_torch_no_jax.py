"""The PyTorch port never imports jax or the JAX package.

tests/conftest.py imports jax into the test process, so the check runs in
a fresh interpreter.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "metricsfm_tpu_torch",
    "metricsfm_tpu_torch.cli",
    "metricsfm_tpu_torch.models.incremental",
    "metricsfm_tpu_torch.models.match_graph",
    "metricsfm_tpu_torch.models.database",
    "metricsfm_tpu_torch.ba.lm",
    "metricsfm_tpu_torch.ops.sift",
    "metricsfm_tpu_torch.ops.sgm",
    "metricsfm_tpu_torch.ops.sgm_kernel",
    "metricsfm_tpu_torch.ops.elas",
    "metricsfm_tpu_torch.models.dense",
    "metricsfm_tpu_torch.io.exports",
    "metricsfm_tpu_torch.utils.synth",
    "metricsfm_tpu_torch.utils.utm",
    "metricsfm_tpu_torch.ops.matching",
    "metricsfm_tpu_torch.ops.five_point",
    "metricsfm_tpu_torch.ops.polynomial",
    "metricsfm_tpu_torch.parallel.submap_ba",
    "metricsfm_tpu_torch.utils.device",
    "metricsfm_tpu_torch.models.slam_gps",
    "metricsfm_tpu_torch.ops.homography",
    "metricsfm_tpu_torch.ops.kmeans",
    "metricsfm_tpu_torch.ops.essential_matching",
    "metricsfm_tpu_torch.ops.ransac",
    "metricsfm_tpu_torch.ops.pnp",
    "metricsfm_tpu_torch.ops.lines",
    "metricsfm_tpu_torch.ops.gist",
    "metricsfm_tpu_torch.ops.panorama",
    "metricsfm_tpu_torch.utils.geo_verification",
    "metricsfm_tpu_torch.utils.calibration",
    "metricsfm_tpu_torch.utils.pso",
    "metricsfm_tpu_torch.models.accuracy",
    "metricsfm_tpu_torch.io.store",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'metricsfm_tpu' or "
            "m.startswith('metricsfm_tpu.')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_no_jax_in_port_sources():
    """No source file of the port names jax in an import."""
    root = os.path.join(REPO, "metricsfm_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for ln in fh:
                        s = ln.strip()
                        assert not (s.startswith("import jax")
                                    or s.startswith("from jax")
                                    or s.startswith("import metricsfm_tpu.")
                                    or s.startswith("from metricsfm_tpu.")
                                    or s.startswith("from metricsfm_tpu ")), \
                            (f, ln)
