"""What limits the SGM aggregation kernels 2d, 2e, 2f and 2g (chain_kernel
and 2f's wta_tile_kernel in sgm_aggregate.cu): each is timed as built and
in probe builds made from edited copies of the source.  The probes'
outputs are meaningless; only their times are read.

  2d ahead N           2d's register ring holds N steps (built: 32)
  2e ahead N           2e's register ring holds N steps (built: 8)
  up ahead N           the ring of 2f's and 2g's up pass holds N steps
                       (built: 8, 2e's)
  shuffle min          m by five xor-shuffles (warp_min) instead of one
                       redux.sync
  no redux             m is the lane's own minimum: the warp reduction
                       leaves the dependent chain
  no loads             the ring is filled once and never refilled: no
                       memory reads after the first steps
  no stores            the stores are skipped (a runtime test that never
                       holds)
  first launch only    2d: left->right into the scratch; 2e, 2f and 2g:
                       both diagonal families (down or up)
  2f without WTA       2f's up pass alone (its WTA kernel is not launched)
  WTA tile N           2f's WTA block takes N pixels of a row (built: 128)
  WTA staging only     2f's WTA blocks copy their row tiles into shared
                       memory and stop (a runtime test that always holds)
  WTA warps N          2f's WTA block has N warps (built: 8)

Times go through the C entries at chip_smoke.py phase 3's full shape
(768 x 1024, D 128, P1 10, P2 120, 8 paths) on the census cost of its
synthetic pair, as the best of two CUDA-event runs of 10 launches.  Needs
one NVIDIA Hopper card and nvcc; run from the repository root:

    python3 tools/probe_sgm.py
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from metricsfm_tpu_torch.ops import cuda_build  # noqa: E402

LIB = "sgm_aggregate"
STORE = re.compile(r"out\.template store<VEC>\(")
# variant: [(pattern, replacement, expected matches)], applied in order
EDITS = {
    **{f"2d ahead {n}": [(r"kAhead2d = 32;", f"kAhead2d = {n};", 1)]
       for n in (16, 48, 64)},
    **{f"2e ahead {n}": [(r"vertical_paths<kAhead2e>\(cost, hsum",
                          f"vertical_paths<{n}>(cost, hsum", 1)]
       for n in (4, 12, 16)},
    **{f"up ahead {n}": [(r"vertical_paths<kAhead2e>\(cost, partial",
                          f"vertical_paths<{n}>(cost, partial", 2)]
       for n in (4, 12, 16)},
    "shuffle min": [(r"__reduce_min_sync\(kFull, lm\)", "warp_min(lm)", 1)],
    "no redux": [(r"__reduce_min_sync\(kFull, lm\)", "lm", 1)],
    "no loads": [(r"if \(t \+ A < len\) load\(ring\[s\], t \+ A\);", "", 1)],
    "no stores": [(STORE.pattern, "if (a.p2 < 0) out.template store<VEC>(",
                   2)],
    "first launch only": [
        (r"return run_chains<kAhead2d, 1, false, false>\(a, scratch16, s\);",
         "return 0;", 1),
        (r"return diag \? run_chains<AHEAD, 2, true, false>\(a, "
         r"scratch16, s\)", "return diag ? 0", 1)],
    "2f without WTA": [(r"return wta_tiles\(total, maps, h, w, dm, s\);",
                        "return 0;", 1)],
    **{f"WTA tile {n}": [(r"kWtaTile = 128;", f"kWtaTile = {n};", 1)]
       for n in (64, 256)},
    **{f"WTA warps {n}": [(r"kWtaWarps = 8;", f"kWtaWarps = {n};", 1)]
       for n in (4, 16)},
    "WTA staging only": [(r"__syncthreads\(\);\n", "__syncthreads();\n"
                          "  if (h > 0) return;\n", 1)],
}


def probe_source(variant: str) -> str:
    """csrc/sgm_aggregate.cu with the variant's edits applied (raises if a
    pattern no longer matches the kernel as often as it should)."""
    with open(os.path.join(cuda_build.CSRC, f"{LIB}.cu")) as f:
        src = f.read()
    for pattern, repl, count in EDITS[variant]:
        src, n = re.subn(pattern, repl, src)
        if n != count:
            raise ValueError(f"{variant}: {pattern!r} matched {n} times, "
                             f"not {count}")
    return src


def build_probe(variant: str) -> ctypes.CDLL:
    out_dir = os.path.join(os.path.abspath(cuda_build.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    tag = variant.replace(" ", "_")
    src = os.path.join(out_dir, f"{LIB}_{tag}.cu")
    with open(src, "w") as f:
        f.write(probe_source(variant))
    lib_path = os.path.join(out_dir, f"lib{LIB}_{tag}.so")
    cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(lib_path)


def main() -> int:
    import torch
    from chip_smoke import cuda_time_ms, dense_scene, gpu_line
    from metricsfm_tpu_torch.ops import sgm_kernel as sk

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probes need one card")
    print(gpu_line(), flush=True)
    variants = ["as built", *EDITS]
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(
            lambda v: cuda_build.load_library(LIB) if v == "as built"
            else build_probe(v), variants))

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    left, right, _ = dense_scene()
    H, W, D = 768, 1024, 128
    cost = sk.census_cost(torch.tensor(left, device=dev),
                          torch.tensor(right, device=dev), D)
    hsum = sk.sgm_horizontal(cost)
    part = sk.sgm_partial(cost, hsum)
    scratch = torch.empty((2, H, W, D), dtype=torch.uint8, device=dev)
    out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
    maps = torch.empty((9, H, W), dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    calls = {   # kernel: (entry, argtypes, arguments without the stream)
        "2d": ("sgm_horizontal_launch", [vp] * 3 + [ci] * 6 + [vp],
               [cost, scratch[0], out, H, W, D, 10, 120, 0]),
        "2e": ("sgm_partial_launch", [vp] * 5 + [ci] * 7 + [vp],
               [cost, hsum, scratch[0], scratch[1], out, H, W, D, 10, 120,
                1, 0]),
        "2f": ("sgm_total_wta_launch", [vp] * 6 + [ci] * 7 + [vp],
               [cost, part, scratch[0], scratch[1], out, maps, H, W, D, 10,
                120, 1, 0]),
        "2g": ("sgm_total_launch", [vp] * 5 + [ci] * 7 + [vp],
               [cost, part, scratch[0], scratch[1], out, H, W, D, 10, 120,
                1, 0]),
    }
    times = {}
    for variant, so in zip(variants, libs):
        for kernel, (sym, argtypes, args) in calls.items():
            fn = getattr(so, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            raw = [a.data_ptr() if torch.is_tensor(a) else a for a in args]

            def call():
                rc = fn(*raw, stream)
                if rc != 0:
                    raise RuntimeError(f"{kernel} {variant}: cudaError {rc}")
            ms = min(cuda_time_ms(call) for _ in range(2))
            times[f"{kernel} {variant}"] = ms
            print(f"  {kernel} 768x1024x128: {variant} {ms:.4f} ms",
                  flush=True)
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
