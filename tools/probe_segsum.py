"""What sets the segsum kernel's time: csrc/segsum.cu is timed as built and
in probe builds made from copies of its source with one constant changed:
the block size (kChunk, the merged items a block takes; its plans are made
with the same chunk, `make_plan(..., chunk=)`), the blocks an SM must hold
(the __launch_bounds__ minimum, which caps registers), and the partials
below which a cross-block bin is added by the thread or warp that wrote
the last one instead of the whole block (kFewPartials).  At chip_smoke.py
phase 14a's main shapes; every probe is also held to the f64 plain version
(chip_smoke.SEGSUM_TOL) and to itself over repeats.

With --tree DIR it times only the kernel as built in another tree (a
parent commit unpacked by `git archive`), through that tree's own
`segment_sum`, at the same shapes: run it beside this tree's run in one
call to compare the two kernels on one card.

Times are the device's, 10 launches replayed from one CUDA graph after 2
warm-ups (chip_smoke.graph_time_ms), the best of two.  Needs one NVIDIA
Hopper card and nvcc; run from the repository root:

    python3 tools/probe_segsum.py [--tree DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# variant: {constant: value} set in a copy of csrc/segsum.cu
VARIANTS = {
    "as built": {},
    "chunk 512": {"kChunk": 512},
    "chunk 2048": {"kChunk": 2048},
    "rows 2 blocks/SM": {"kRowMinBlocks": 2},
    "cols 1 block/SM fewer": {"kColMinBlocks": 2},
    # every cross-block bin through the block-wide barrier and combine
    "block-wide tickets": {"kFewPartials": 0},
    # every cross-block bin added by the one thread or warp that is last
    "writer adds all": {"kFewPartials": 1 << 30},
}


def chunk_of(variant: str) -> int:
    from metricsfm_tpu_torch.ops import segsum
    return VARIANTS[variant].get("kChunk", segsum.CHUNK)


def probe_source(variant: str) -> str:
    """csrc/segsum.cu with the variant's constants set (raises if one is no
    longer a constant there)."""
    from metricsfm_tpu_torch.ops import cuda_build
    with open(os.path.join(cuda_build.CSRC, "segsum.cu")) as f:
        src = f.read()
    for name, value in VARIANTS[variant].items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"segsum.cu: {name} is no longer one constant")
    return src


def build_probe(variant: str) -> ctypes.CDLL:
    from metricsfm_tpu_torch.ops import cuda_build
    out_dir = os.path.join(os.path.abspath(cuda_build.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    tag = re.sub(r"\W+", "_", variant)
    src = os.path.join(out_dir, f"segsum_{tag}.cu")
    with open(src, "w") as f:
        f.write(probe_source(variant))
    lib_path = os.path.join(out_dir, f"libsegsum_{tag}.so")
    cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib_path,
           src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    # registers and spills of the f32 kernels, by instantiation
    regs = re.findall(r"Function properties for \S*segsum_(rows|cols)If"
                      r"Li(\d+)E.*?(\d+) bytes spill stores.*?Used (\d+) "
                      r"registers", proc.stdout + proc.stderr, flags=re.S)
    print(json.dumps({"variant": variant, "f32 (mode, width, spill bytes, "
                      "registers)": regs}), flush=True)
    return ctypes.CDLL(lib_path)


def entry(lib: ctypes.CDLL, dtype):
    import torch
    from metricsfm_tpu_torch.ops import segsum
    fn = getattr(lib, {torch.float32: "segsum_f32_launch",
                       torch.float64: "segsum_f64_launch"}[dtype])
    fn.argtypes = segsum._kernel(dtype).argtypes
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help="time only the kernel as built in this "
                    "tree (its own make_plan and segment_sum)")
    args = ap.parse_args(argv)
    import torch
    from chip_smoke import SEGSUM_TOL, gpu_line, graph_time_ms
    if args.tree:                     # that tree's package from here on
        sys.path.insert(0, os.path.abspath(args.tree))
    from metricsfm_tpu_torch.ops import cuda_build, segsum

    card = gpu_line()
    print(card, flush=True)
    if args.tree:
        cuda_build.load_library("segsum")
        libs = {"as built": None}
    else:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = dict(zip(VARIANTS, pool.map(build_probe, VARIANTS)))
    gen = torch.Generator(device="cuda").manual_seed(15)

    def uniform(n, n_bins):
        return torch.randint(0, n_bins, (n,), generator=gen, device="cuda")

    skewed = uniform(98304, 85)
    skewed[torch.rand(98304, generator=gen, device="cuda") < 0.3] = 0
    cases = [("BA matvec", uniform(786432, 1024), 1024, 9),
             ("BA blocks", uniform(786432, 1024), 1024, 36),
             ("BA blocks", uniform(786432, 1024), 1024, 81),
             ("shared model", uniform(786432, 1), 1, 3),
             ("shared model", uniform(786432, 1), 1, 9),
             ("k-means", skewed, 85, 128),
             ("mostly empty bins", uniform(5000, 1 << 20), 1 << 20, 18),
             ("masked slots", uniform(50000, 64), 64, 27),
             ("Hough votes", uniform(400000, 46080), 46080, 1)]
    rows = []
    for label, bins, n_bins, K in cases:
        values = torch.randn((bins.numel(), K), generator=gen, device="cuda")
        want = segsum.segment_sum_reference(
            values.double(), segsum.make_plan(bins, n_bins))
        mass = segsum.segment_sum_reference(
            values.abs().double(), segsum.make_plan(bins, n_bins))
        row = {"case": label, "K": K, "slots": bins.numel(), "bins": n_bins}
        for variant, lib in libs.items():
            if lib is None:           # --tree: that tree's public calls
                plan = segsum.make_plan(bins, n_bins)

                def run():
                    return segsum.segment_sum(values, plan)
            else:
                plan = segsum.make_plan(bins, n_bins, chunk=chunk_of(variant))
                fn = entry(lib, values.dtype)

                def run():
                    return segsum._launch(values, plan, fn)
            got = [run() for _ in range(3)]
            torch.cuda.synchronize()
            err = float(((got[0].double() - want).abs()
                         / mass.clamp_min(1e-300)).max())
            same = all(torch.equal(g, got[0]) for g in got)
            if not (err <= SEGSUM_TOL and same):
                raise AssertionError(f"{variant}, {label} K {K}: error "
                                     f"{err}, bit-equal {same}")
            row[variant] = min(graph_time_ms(run) for _ in range(2))
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"card": card, "tree": os.path.abspath(args.tree or ROOT),
                      "probe_segsum": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
