"""What limits the SGM kernels 2c-2h (sgm_census.cu's census_cost_kernel;
chain_kernel, 2f's wta_tile_kernel and 2h's wta_stream_kernel in
sgm_aggregate.cu): each is timed as built and in probe builds made from
edited copies of its source.  The probes' outputs are meaningless; only
their times are read.

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
  2h loads only        2h's loads run, its reductions and shuffles do not
                       (a runtime test that never holds)
  2h warps N           2h's block has N warps, 32 pixels each (built: 4)
  2h ring N            2h's lanes keep N bytes of loads in flight (built:
                       32, 4 pixels at D = 128, int16)
  2c store only        2c stores the constant 64 and computes nothing:
                       no staging, no census, no counts (runtime tests)
  2c census only       2c stages its rows and builds its census words but
                       writes no cost (a runtime test that never holds)
  2c no popc           2c adds the two xor words instead of counting their
                       bits
  2c tile N            2c's block takes N pixels of a row (built: 256)
  2c streaming stores  2c's 16-byte stores are __stcs (evict first)

Times go through the C entries at chip_smoke.py phase 3's full shape
(768 x 1024, D 128, P1 10, P2 120, 8 paths) on the census cost of its
synthetic pair (2h on its int16 total, cap 30000), as the best of two
CUDA-event runs of 10 launches; a probe build of one source times the
kernels of that source.  Needs one NVIDIA Hopper card and nvcc; run from
the repository root:

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
    "2h loads only": [(r"step\(ring\[s\], t0 \+ s\);",
                       "if (dm < 0) step(ring[s], t0 + s);", 1)],
    **{f"2h warps {n}": [(r"kWta2hWarps = 4;", f"kWta2hWarps = {n};", 1)]
       for n in (8, 16)},
    **{f"2h ring {n}": [(r"kWta2hRing = 32;", f"kWta2hRing = {n};", 1)]
       for n in (16, 64)},
    # sgm_census.cu
    "2c store only": [
        (r"  stage_rows<", "  if (h < 0) stage_rows<", 2),
        (r"  census_words\(sl, sr", "  if (h < 0) census_words(sl, sr", 1),
        (r"if \(x < d0\) \{", "if (w > 0) {", 1)],
    "2c census only": [(r"for \(int p = p0; p < np;",
                        "for (int p = p0; h < 0 && p < np;", 1)],
    "2c no popc": [(r"__popc\(cl\.x \^ cr\.x\) \+ __popc\(cl\.y \^ cr\.y\)",
                    "((cl.x ^ cr.x) + (cl.y ^ cr.y))", 1)],
    **{f"2c tile {n}": [(r"kTile = 256;", f"kTile = {n};", 1)]
       for n in (64, 128)},
    "2c streaming stores": [(r"\*\(uint4\*\)out = (make_uint4\([^;]*\));",
                             r"__stcs((uint4*)out, \1);", 1)],
}
CENSUS = "sgm_census"


def lib_of(variant: str) -> str:
    """The source a variant edits: 2c's is sgm_census.cu, the others'
    sgm_aggregate.cu."""
    return CENSUS if variant.startswith("2c ") else LIB


def probe_source(variant: str) -> str:
    """The variant's source (lib_of) with its edits applied (raises if a
    pattern no longer matches the kernel as often as it should)."""
    with open(os.path.join(cuda_build.CSRC, f"{lib_of(variant)}.cu")) as f:
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
    lib = lib_of(variant)
    src = os.path.join(out_dir, f"{lib}_{tag}.cu")
    with open(src, "w") as f:
        f.write(probe_source(variant))
    lib_path = os.path.join(out_dir, f"lib{lib}_{tag}.so")
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
    with ThreadPoolExecutor(len(EDITS)) as pool:
        probes = dict(zip(EDITS, pool.map(build_probe, EDITS)))
    built = {lib: cuda_build.load_library(lib) for lib in (CENSUS, LIB)}

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    left, right, _ = dense_scene()
    H, W, D = 768, 1024, 128
    L = torch.tensor(left, device=dev)
    R = torch.tensor(right, device=dev)
    cost = sk.census_cost(L, R, D)
    hsum = sk.sgm_horizontal(cost)
    part = sk.sgm_partial(cost, hsum)
    total = sk.sgm_total(cost, part)
    scratch = torch.empty((2, H, W, D), dtype=torch.uint8, device=dev)
    out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
    vol = torch.empty((H, W, D), dtype=torch.uint8, device=dev)
    maps = torch.empty((9, H, W), dtype=torch.int32, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    calls = {   # kernel: (library, entry, argtypes, arguments but the stream)
        "2c": (CENSUS, "sgm_census_cost_launch", [vp] * 3 + [ci] * 3 + [vp],
               [L, R, vol, H, W, D]),
        "2d": (LIB, "sgm_horizontal_launch", [vp] * 3 + [ci] * 6 + [vp],
               [cost, scratch[0], out, H, W, D, 10, 120, 0]),
        "2e": (LIB, "sgm_partial_launch", [vp] * 5 + [ci] * 7 + [vp],
               [cost, hsum, scratch[0], scratch[1], out, H, W, D, 10, 120,
                1, 0]),
        "2f": (LIB, "sgm_total_wta_launch", [vp] * 6 + [ci] * 7 + [vp],
               [cost, part, scratch[0], scratch[1], out, maps, H, W, D, 10,
                120, 1, 0]),
        "2g": (LIB, "sgm_total_launch", [vp] * 5 + [ci] * 7 + [vp],
               [cost, part, scratch[0], scratch[1], out, H, W, D, 10, 120,
                1, 0]),
        "2h": (LIB, "sgm_wta_launch", [vp] * 3 + [ci] * 4 + [cf, vp],
               [total, maps[:5], maps[5], H, W, D, 0, 30000.0]),
    }
    times = {}
    for variant in variants:
        for kernel, (lib, sym, argtypes, args) in calls.items():
            if variant == "as built":
                so = built[lib]
            elif lib_of(variant) == lib:
                so = probes[variant]
            else:
                continue
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
