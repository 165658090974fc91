"""Build the CUDA kernels in ops/csrc with nvcc and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for sm_90a
(Hopper).  Libraries land in ``metricsfm_tpu_torch/_build/``, named by a
hash of their source and of the shared headers (csrc/*.cuh), so an edited
kernel is rebuilt and a built one is reused.  A missing nvcc or a failed
build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "..", "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: Dict[str, ctypes.CDLL] = {}
# per-library build record: {"seconds": float, "log": str, "path": str}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            if os.path.exists(cand):
                path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels in "
                           f"{CSRC} cannot be built")
    return path


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    out_dir = os.path.abspath(BUILD_DIR)
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{name}_{digest}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{log}")
        os.replace(tmp, lib_path)
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "path": lib_path}
    lib = ctypes.CDLL(lib_path)
    _loaded[name] = lib
    return lib
