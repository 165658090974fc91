"""What limits kernels 2a (knn2.cu) and 2b (knn2_int8.cu): each is timed as
built and in two probe builds made from copies of its source, one with the
product and no fold ("product only": the per-value top-2 fold is cut to one
read of the accumulator), one with the fold and no product ("fold only":
the wgmma instructions are cut).  The probes' outputs are meaningless;
only their times are read.

Times go through each kernel's C entry at chip_smoke.py phase 3's shapes
(2a: 32 pairs of 4096 and of 2048 rows; 2b: 96 pairs of 4096, quantized),
as the best of two CUDA-event runs of 10 launches.  Needs one NVIDIA
Hopper card and nvcc; run from the repository root:

    python3 tools/probe_knn2.py
"""
from __future__ import annotations

import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from metricsfm_tpu_torch.ops import cuda_build  # noqa: E402

ONE_READ = "r[0].best += acc.d[0];"
# (library, variant): (pattern, replacement) applied once to the source
EDITS = {
    ("knn2", "product only"): (
        r"float b0 = neg_inf\(\).*?fold_tile_top2\(r\[1\][^;]*;", ONE_READ),
    ("knn2_int8", "product only"): (
        r"const int\* nbk = .*?fold_tile_top2\(r\[1\][^;]*;", ONE_READ),
}
for _lib in ("knn2", "knn2_int8"):
    EDITS[(_lib, "fold only")] = (r"hopper::wgmma_\w+<[01]>\(", "(void)(")


def probe_source(lib: str, variant: str) -> str:
    """The source of one probe build: csrc/<lib>.cu with its edit applied
    (raises if the pattern no longer matches the kernel)."""
    with open(os.path.join(cuda_build.CSRC, f"{lib}.cu")) as f:
        src = f.read()
    pattern, repl = EDITS[(lib, variant)]
    out, n = re.subn(pattern, repl, src, flags=re.S)
    if n == 0:
        raise ValueError(f"{lib} {variant}: the edit no longer matches")
    return out


def build_probe(lib: str, variant: str) -> ctypes.CDLL:
    out_dir = os.path.join(os.path.abspath(cuda_build.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    tag = variant.replace(" ", "_")
    src = os.path.join(out_dir, f"{lib}_{tag}.cu")
    with open(src, "w") as f:
        f.write(probe_source(lib, variant))
    for h in os.listdir(cuda_build.CSRC):
        if h.endswith(".cuh"):
            with open(os.path.join(cuda_build.CSRC, h)) as f_in, \
                    open(os.path.join(out_dir, h), "w") as f_out:
                f_out.write(f_in.read())
    lib_path = os.path.join(out_dir, f"lib{lib}_{tag}.so")
    cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(lib_path)


def main() -> int:
    import numpy as np
    import torch
    from chip_smoke import cuda_time_ms, gpu_line, unit_store
    from metricsfm_tpu_torch.ops import matching

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probes need one card")
    print(gpu_line(), flush=True)
    variants = [(lib, v) for lib in ("knn2", "knn2_int8")
                for v in ("as built", "product only", "fold only")]
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(
            lambda lv: cuda_build.load_library(lv[0]) if lv[1] == "as built"
            else build_probe(*lv), variants))

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    pairs = list(itertools.combinations(range(8), 2))
    pairs = pairs + pairs[:32 - len(pairs)]
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
    calls = []   # (library, shape label, entry, arguments without the stream)
    for n in (4096, 2048):
        store = torch.tensor(unit_store(rng, 8, n), device=dev).to(
            torch.bfloat16)
        mask = torch.tensor(rng.uniform(size=(8, n)) > 0.03,
                            device=dev).view(torch.uint8)
        out = [torch.empty((32, n), dtype=t, device=dev)
               for t in (torch.float32, torch.float32, torch.int32)]
        calls.append(("knn2", f"32x{n}^2", "knn2_launch",
                      [store, mask, ii, jj, 8, 32, n, 128, *out]))
    d1, d2 = matching.throughput_descriptors(96, 4096)
    q8, nq, db8, nb = matching.quantize_pair_int8(
        torch.tensor(d1, device=dev).to(torch.bfloat16),
        torch.tensor(d2, device=dev))
    out = [torch.empty((96, 4096), dtype=t, device=dev)
           for t in (torch.float32, torch.float32, torch.int32)]
    calls.append(("knn2_int8", "96x4096^2", "knn2_int8_launch",
                  [q8, db8, nq, nb, 96, 4096, 4096, 128, *out]))

    times = {}
    for (lib, variant), so in zip(variants, libs):
        for clib, label, sym, args in calls:
            if clib != lib:
                continue
            fn = getattr(so, sym)
            fn.argtypes = matching._SIGNATURES[(lib, sym)]
            fn.restype = ctypes.c_int
            raw = [a.data_ptr() if torch.is_tensor(a) else a for a in args]

            def call():
                rc = fn(*raw, stream)
                if rc != 0:
                    raise RuntimeError(f"{lib} {variant}: cudaError {rc}")
            ms = min(cuda_time_ms(call) for _ in range(2))
            times[f"{lib} {label} {variant}"] = ms
            print(f"  {lib} {label}: {variant} {ms:.4f} ms", flush=True)
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
