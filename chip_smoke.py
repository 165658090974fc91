"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each printing its own line with seconds; the first failure raises
and the script exits non-zero:
  1. refuse to run without CUDA; print the card's name and power limit;
  2. build every CUDA kernel from ops/csrc with nvcc (one nvcc per source,
     all started together) and print each kernel's registers, spills,
     shared memory and any wgmma-serialization warning from the build log;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it, and time both beside the kernel's
     bound: knn2 (2a) at the sfm verify batch (and timed at the aerial
     batch, 32 pairs of 2048), and at the street re-match batch (32 pairs
     of 8,192 x 8,192 x 128, checked and timed beside its bound, its plain
     version and the bf16 product alone); knn2_int8 (2b) at the matching-throughput
     shape (96 pairs of 4096 x 4096 x 128), a ragged masked pair, one
     valid column, a duplicate-best tie and N2 = 9000, exact on idx and
     both distances, timed through its wrapper, alone, and its fused
     quantize pass alone (bit-equal to quantize_desc_int8 and its norms);
     both 2-NN kernels also on the edges of their 128 x 128 tiling (N =
     50, 2047, 4097; B = 1; a wholly masked database tile; an image with
     no valid column, d1 = d2 = +inf; the boundary trap: a tile past row N
     reads the next image, whose first rows equal the queries);
     census_cost (2c), sgm_horizontal (2d), sgm_partial (2e),
     sgm_total_wta (2f), sgm_total (2g) and wta (2h) at 768x1024 / D=128
     and at a ragged 37x61 / D=48, exact on every output (2h also on the
     skewed right volume, an int32 and a float32 volume) and within 1e-5
     on the disparity after the torch tail; 2d-2g also at P2 = 120,
     191, 200 (uint8 and int16 scratch) and 4031 (P1 40000), with 4 and
     8 paths, on D % 4 != 0, one row, one column, one pixel, W < 32,
     W < D, D = 4, 160 and 256, a misaligned cost volume, 2e on an hsum
     and 2f / 2g on a partial of any sign, and timed at P2 = 200; 2c
     and 2h also on the shapes and values their code paths branch on
     (sgm_2c2h_cases: one row, one column, W < D, a partial last tile,
     D = 4 .. 256, constant and 8-level images, int16 extremes, int32 and
     float32 beyond 2^24 with ties and +-0.0, caps 16000 / 30000 / 1e9,
     operands at an offset), 2h timed on int32 and float32 volumes too;
     the bare products (bf16 torch.matmul, torch._int_mm), 2c's store
     stream (torch.full) and 2h's c0 / best alone (torch.min) are timed
     as yardsticks only;
  4. drive `metricsfm_tpu_torch.cli sfm` on a rendered 8-view 1024x768
     scene with 4096 keypoints per image, with the knn2 launch count reset
     just before and read just after, and check the reconstruction against
     the scene's ground truth;
 4b. drive `cli sfm` on the same 8 views written as JPEGs (quality 95)
     whose EXIF carries the render's focal, so the seed takes the
     calibrated 5-point path, with the knn2 launch count and the 5-point
     RANSAC call count reset just before and read just after; gates: 8/8
     registered, ATE < 0.05, the 5-point RANSAC ran; then time the 5-point
     pieces on the card (128 batched 5x9 SVDs, the 128-sample solve, the
     RANSAC with its refits);
  4c. drive `cli sfm` with the user's defaults (web mode, no --matching,
     so BoW candidates: vocabulary, word bags, top-k similarity, the
     word-seed gate) on 24 rendered 1024x768 views (arc step 0.03 rad),
     4096 keypoints, twice: a warm-up with --debug-matches, then timed,
     the knn2 count reset just before and read just after each; gates:
     24/24 registered, ATE < 0.05, voctree.npz and 24 word files, BoW
     candidates matched through 2a, renders written by the warm-up;
  5. drive `metricsfm_tpu_torch.cli dense` (SGM, the fused path) on a
     synthetic rectified 768x1024 pair with known disparity (24 px
     background, 72 px block), D=128, written through the SURE pose
     format, with every SGM kernel's launch count reset just before and
     read just after, and check the disparity against the ground truth
     (the JAX test's gates);
  6. drive the SGM volume path (`ops.sgm.stereo_sgm_volume`: 2c, 2d, 2e,
     2g, then 2h on the left and on the skewed right volume) on the same
     pair, with the counts reset just before and read just after and every
     plain version barred, check the same gates, and count the pixels
     whose validity differs from the fused path's;
  7. drive `cli dense --method elas` (plain torch, no kernel) on the same
     folder and check the ELAS test's gates;
  8. drive the matching-throughput path (`ops.matching.
     matching_throughput`: 96 pairs x 4096 keypoints, 6 chained calls of
     2b, then of 2a) with both counts reset just before and read just
     after, and print pairs/s of each;
  9. drive the aerial path once: 200 views (10 x 20) rendered at 640x480,
     UAV preset, 2048 keypoints, GPS-priori candidates, Database ->
     build_match_graph -> IncrementalSfM (PCG from 128 cameras), with the
     2a count reset just before and read just after; gates: >= 95 %
     registered in one model, ATE < 0.05, at least one PCG solve;
 9c. the same path once on 500 views (20 x 25, the JAX bench's 500-view
     configuration), whose periodic full BAs above 400 cameras run
     hierarchical submap BA; gates as phase 9 and at least one
     hierarchical full BA; its stage table shows the `sfm/ba_solve/hier`
     span;
 9d. the aerial path of phase 9 with vocabulary-tree candidates
     ("feature", BASELINE.json config 3's strategy) in place of GPS priori:
     the word stage runs as its own span (`sfm/build_words`) before
     build_match_graph; gates as phase 9 and a trained vocabulary;
 11a. the street path, `cli slam` with the street preset (no re-match,
     the reference's default), on a synthetic street sequence written in
     the reference's SLAM-GPS formats: 1,000 keyframes of a 1280x720 frame
     at 2 m along a 2 km road with gentle turns, 50,000 facade points;
     gates: every keyframe kept, median UTM error < 1.0 m, pose.qin of
     1,000 rows, the GPS BA by the PCG solve;
 11b. the street re-match path, `SLAMGPS(street_preset()).run(fold,
     rematch=True)` on 100 keyframes of a street canyon rendered at
     1280x720 on the card (SIFT up to 8,192 keypoints, window priors, the
     re-match through 2a, retriangulation, dense GPS BA), with the 2a count
     reset just before and read just after; gates: median UTM error < 1.0
     m, >= 1,000 tracks of >= 3 views, 100 undistorted images, pose.qin of
     100 rows; then 2a against its plain version on 32 pairs of the run's
     own keyframe descriptors (ragged N);
 12. the auxiliary ops at full size (`aux_phase`): essential-guided
     matching of two rendered 1024x768 views through 2a (count reset just
     before, read just after; >= 100 inliers, >= 95 % under the rendered
     E) and the four geo-verification modes on its matches; 8 segments
     recovered within 5 px and local orientation at 4,096 points; GIST
     against the CPU within 1e-4; 12 panorama zones of a 4096x2048 image;
     p4pf (32 problems in f64, f within 1 % in >= 95 %), dlt_oriented (f
     within 0.5 %) and epnp_robust (20 % gross outliers: below plain
     EPnP; 10 %: < 0.5 deg) at N = 2,000;
     exact undistortion of 4,096 points (1e-4); PSO on a 6-D quadratic;
     the synthetic BA problem at 1,024 cameras x 131,072 points solved
     with bench.py's production LMConfig (cost must drop; LM
     iterations/s printed);
 10. print the paths' numbers, the kernel table (2a-2h, launches summed
     over the paths), the card line and the result line.
`--skip-e2e` stops after phase 3; `--profile DIR` adds a torch.profiler run
of each end-to-end path (the aerial one device activity only, no trace).
A failed build raises with its nvcc log; to keep a whole run's record,
redirect it: `python3 -X faulthandler chip_smoke.py > smoke.log 2>&1`.
The last line of standard output is the result:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def phase(name):
    """Context manager printing one line per phase, with its seconds."""
    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[phase] {name} ...", flush=True)
            return self

        def __exit__(self, et, ev, tb):
            dt = time.perf_counter() - self.t0
            status = "ok" if et is None else f"FAILED ({et.__name__}: {ev})"
            print(f"[phase] {name} {status} in {dt:.3f} s", flush=True)
            return False
    return _P()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# Published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet): the
# tensor cores in bf16 and int8, HBM3.  Integer work outside the tensor
# cores issues on the SM's 32-bit integer lanes, 64 per SM a clock
# (a quarter of the 67 TFLOP/s float32 rate, which counts an FMA as two):
# 132 SMs at the 1.98 GHz boost clock.
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_INT32 = 132 * 64 * 1.98e9
PEAK_BYTES = 3.35e12
# Population count issues at 16 results per SM a clock on compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of arithmetic
# instructions), a quarter of the 32-bit integer rate.
PEAK_POPC = 132 * 16 * 1.98e9


def bound(ops, rate, nbytes):
    """The least time the card could take: the larger of ops / peak rate
    and bytes (each input read once, each output written once) / HBM
    rate; both times are kept."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def bound_text(b):
    popc = f", popc {b['popc_ms']:.4f}" if "popc_ms" in b else ""
    return (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; operations "
            f"{b['ops_ms']:.4f}{popc}, bytes {b['bytes_ms']:.4f})")


def census_bound(H, W, D, nbytes):
    """2c's bound: two 63-neighbour census transforms a pixel (252 32-bit
    operations), and for each (x, d) with x >= d, which this input needs
    (64 elsewhere), two xors and an add at the 32-bit integer rate and two
    population counts at their own, a quarter of it; the max of the
    integer, popc and byte terms.  pr2_bound_ms keeps PR 2's count, 252 H
    W + 5 H W D 32-bit operations with no popc term."""
    n_x = sum((W - d) * H for d in range(min(D, W)))   # elements with x >= d
    b = bound(252 * H * W + 3 * n_x, PEAK_INT32, nbytes)
    b["popc_ms"] = 2 * n_x / PEAK_POPC * 1e3
    if b["popc_ms"] > b["bound_ms"]:
        b["bound_ms"], b["bound_by"] = b["popc_ms"], "operations"
    b["pr2_bound_ms"] = bound(252 * H * W + 5 * H * W * D, PEAK_INT32,
                              nbytes)["bound_ms"]
    return b


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def unit_store(rng, m, n, d=128):
    import numpy as np
    x = rng.normal(size=(m, n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def compare_knn2(store_np, mask_np, ii_np, jj_np, label):
    """Kernel vs plain on the card; returns (max_abs_err, agreement)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import matching

    dev = torch.device("cuda")
    store = torch.tensor(store_np, device=dev).to(torch.bfloat16)
    mask = torch.tensor(mask_np, device=dev)
    ii = torch.tensor(ii_np, dtype=torch.int32, device=dev)
    jj = torch.tensor(jj_np, dtype=torch.int32, device=dev)
    k1, k2, kidx = matching.knn2_gather(store, mask, ii, jj)
    r1, r2, ridx = matching.knn2_reference(store, mask, ii, jj)
    torch.cuda.synchronize()
    k1, k2, kidx, r1, r2, ridx = (t.cpu().numpy() for t in
                                  (k1, k2, kidx, r1, r2, ridx))
    for name, a, b in (("d1_sq", k1, r1), ("d2_sq", k2, r2)):
        if not np.array_equal(np.isinf(a), np.isinf(b)):
            raise AssertionError(f"{label}: {name} inf pattern differs")
    fin1, fin2 = np.isfinite(r1), np.isfinite(r2)
    err = max(float(np.abs(k1[fin1] - r1[fin1]).max(initial=0.0)),
              float(np.abs(k2[fin2] - r2[fin2]).max(initial=0.0)))
    agree = float((kidx == ridx).mean())
    # off exact ties (best and second within f32 summation noise) the
    # indices must agree exactly
    with np.errstate(invalid="ignore"):     # inf - inf on empty rows
        clear = (r2 - r1) > 2e-5
    clear_agree = float((kidx == ridx)[clear].mean()) if clear.any() else 1.0
    print(f"  knn2 {label}: shape {store_np.shape} B={len(ii_np)} "
          f"max|d2 err|={err:.3g} idx agree={agree:.6f} "
          f"(off ties {clear_agree:.6f})", flush=True)
    if err > 1e-4:
        raise AssertionError(f"{label}: distance error {err} > 1e-4")
    if agree < 0.999 or clear_agree < 1.0:
        raise AssertionError(f"{label}: index agreement {agree} / "
                             f"{clear_agree}")
    return err, agree


def knn2_phase():
    """Phase 3 for kernel 2a; returns its table row (without launches)."""
    import itertools

    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import matching

    rng = np.random.default_rng(0)
    # the verify batch of the main path: 32 pairs of 4096 x 128 out of an
    # 8-image store (28 exhaustive pairs + 4 repeats), ~3% rows masked
    store = unit_store(rng, 8, 4096)
    mask = rng.uniform(size=(8, 4096)) > 0.03
    pairs = list(itertools.combinations(range(8), 2))
    pairs = pairs + pairs[:32 - len(pairs)]
    ii = np.array([p[0] for p in pairs], np.int32)
    jj = np.array([p[1] for p in pairs], np.int32)
    err, _ = compare_knn2(store, mask, ii, jj, "B=32 N=4096")
    errs = [err]
    # ragged N (not a tile multiple)
    s2 = unit_store(rng, 3, 1000)
    m2 = rng.uniform(size=(3, 1000)) > 0.1
    errs.append(compare_knn2(s2, m2, np.array([0, 1, 2], np.int32),
                             np.array([1, 2, 0], np.int32), "ragged N=1000")[0])
    # one valid database column: d2 must be +inf, idx that column
    m3 = np.zeros((2, 1000), bool)
    m3[1, 517] = True
    compare_knn2(s2[:2], m3, np.array([0], np.int32),
                 np.array([1], np.int32), "one valid column")
    # duplicate best: queries equal to a database row that appears twice;
    # the tie goes to the lower column and second == best
    s4 = unit_store(rng, 2, 512)
    s4[1, 300] = s4[1, 40]
    s4[0, :8] = s4[1, 40]
    m4 = np.ones((2, 512), bool)
    compare_knn2(s4, m4, np.array([0], np.int32), np.array([1], np.int32),
                 "duplicate-best tie")
    errs += knn2_tiling_cases(rng)
    dev = torch.device("cuda")
    st = torch.tensor(s4, device=dev).to(torch.bfloat16)
    d1, d2, idx = matching.knn2_gather(st, torch.tensor(m4, device=dev),
                                       torch.tensor([0], dtype=torch.int32,
                                                    device=dev),
                                       torch.tensor([1], dtype=torch.int32,
                                                    device=dev))
    if idx[0, :8].tolist() != [40] * 8 or \
            not torch.equal(d1[0, :8], d2[0, :8]):
        raise AssertionError("duplicate-best tie not resolved to the lower "
                             "column with second == best")

    street, street_err = knn2_street(rng)
    errs.append(street_err)
    # time kernel vs plain at the main path's verify batch
    aerial_ms = knn2_time_aerial(rng)
    store_t = torch.tensor(store, device=dev).to(torch.bfloat16)
    mask_t = torch.tensor(mask, device=dev)
    ii_t = torch.tensor(ii, device=dev)
    jj_t = torch.tensor(jj, device=dev)
    plain_ms = cuda_time_ms(lambda: matching.knn2_reference(
        store_t, mask_t, ii_t, jj_t))
    ms = cuda_time_ms(lambda: matching.knn2_gather(store_t, mask_t, ii_t,
                                                   jj_t))
    plain_ms2 = cuda_time_ms(lambda: matching.knn2_reference(
        store_t, mask_t, ii_t, jj_t))
    ms2 = cuda_time_ms(lambda: matching.knn2_gather(store_t, mask_t, ii_t,
                                                    jj_t))
    # yardstick: the bf16 product alone (cuBLAS), not the same function
    a_t = store_t[ii_t.long()]
    bt_t = store_t[jj_t.long()].transpose(1, 2)
    prod_ms = cuda_time_ms(lambda: torch.matmul(a_t, bt_t))
    del a_t, bt_t
    flop = 2.0 * 32 * 4096 * 4096 * 128
    nbytes = nbytes_of(store_t, mask_t, ii_t, jj_t) + 32 * 4096 * 12
    b = bound(flop, PEAK_BF16, nbytes)
    print(f"  knn2 B=32 N=4096: kernel {ms:.3f}/{ms2:.3f} ms "
          f"({flop / (min(ms, ms2) * 1e9):.1f} TFLOP/s), plain "
          f"{plain_ms:.3f}/{plain_ms2:.3f} ms, {bound_text(b)}; product "
          f"only, not the same function (bf16 "
          f"torch.matmul): {prod_ms:.3f} ms", flush=True)
    return {"name": "knn2", "route": "cuda",
            "source": "metricsfm_tpu_torch/ops/csrc/knn2.cu",
            "replaces": "metricsfm_tpu/ops/pallas/match_kernel.py:45",
            "max_abs_err": max(errs), "ms": min(ms, ms2),
            "plain_ms": min(plain_ms, plain_ms2), **b, "library_ms": None,
            "product_only_ms": prod_ms, "aerial_batch_ms": aerial_ms,
            **street}


def knn2_street(rng):
    """2a at the street re-match batch: 32 pairs of 8,192 x 8,192 x 128
    (the keyframes' 8,192 keypoints, no resize), ~3% rows masked, query
    image k + 1 against database image k as the re-match runs them: held
    to the plain version, then timed beside its bound, the plain version
    and the bf16 product alone."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import matching

    B, N = 32, 8192
    store = unit_store(rng, B + 1, N)
    mask = rng.uniform(size=(B + 1, N)) > 0.03
    ii = np.arange(B, dtype=np.int32)
    err = compare_knn2(store, mask, ii + 1, ii, f"street B={B} N={N}")[0]
    dev = torch.device("cuda")
    st = torch.tensor(store, device=dev).to(torch.bfloat16)
    del store
    mk = torch.tensor(mask, device=dev)
    q = torch.tensor(ii + 1, device=dev)
    d = torch.tensor(ii, device=dev)
    ms = min(cuda_time_ms(lambda: matching.knn2_gather(st, mk, q, d))
             for _ in range(2))
    plain_ms = cuda_time_ms(lambda: matching.knn2_reference(st, mk, q, d),
                            reps=3, warmup=1)
    a_t, bt_t = st[q.long()], st[d.long()].transpose(1, 2)
    prod_ms = cuda_time_ms(lambda: torch.matmul(a_t, bt_t), reps=5)
    del a_t, bt_t
    flop = 2.0 * B * N * N * 128
    b = bound(flop, PEAK_BF16, nbytes_of(st, mk, q, d) + B * N * 12)
    print(f"  knn2 street batch B={B} N={N}: kernel {ms:.4f} ms "
          f"({flop / (ms * 1e9):.1f} TFLOP/s, {b['bound_ms'] / ms:.1%} of "
          f"the bound), plain {plain_ms:.3f} ms, {bound_text(b)}; product "
          f"only (bf16 torch.matmul): {prod_ms:.3f} ms", flush=True)
    return {"street_batch_ms": ms, "street_plain_ms": plain_ms,
            "street_bound_ms": b["bound_ms"], "street_bound_by": b["bound_by"],
            "street_product_only_ms": prod_ms}, err


def knn2_tiling_cases(rng):
    """2a on the edges of its 128 x 128 tiling: N below one tile and one
    past a multiple, B = 1, a wholly masked database tile, an image with no
    valid row (d1 = d2 = +inf), and the image-boundary trap (the tensor
    map runs on into the next image, whose first rows equal the queries).
    Returns the distance errors."""
    import numpy as np

    errs = []
    for n, b in ((50, 3), (2047, 4), (4097, 1)):
        st = unit_store(rng, b + 1, n)
        m = rng.uniform(size=(b + 1, n)) > 0.05
        ii = np.arange(b, dtype=np.int32)
        errs.append(compare_knn2(st, m, ii, ii + 1, f"N={n} B={b}")[0])
    st = unit_store(rng, 3, 1000)
    m = rng.uniform(size=(3, 1000)) > 0.05
    m[1, 256:384] = False
    m[2] = False
    errs.append(compare_knn2(st, m, np.array([0, 0], np.int32),
                             np.array([1, 2], np.int32),
                             "masked tile + no valid row")[0])
    # pair (0, 1) with N = 1000: the last tile reads image 2's first 24
    # rows, set equal to the queries; a leak would win with s = 1
    st[2, :24] = st[0, :24]
    m[:] = True
    errs.append(compare_knn2(st, m, np.array([0], np.int32),
                             np.array([1], np.int32),
                             "image-boundary trap N=1000")[0])
    return errs


def knn2_time_aerial(rng):
    """2a at the aerial path's batch (32 pairs of 2048 x 2048 x 128)."""
    import itertools

    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import matching

    dev = torch.device("cuda")
    store = torch.tensor(unit_store(rng, 8, 2048), device=dev).to(
        torch.bfloat16)
    mask = torch.tensor(rng.uniform(size=(8, 2048)) > 0.03, device=dev)
    pairs = list(itertools.combinations(range(8), 2))
    pairs = pairs + pairs[:32 - len(pairs)]
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
    ms = min(cuda_time_ms(lambda: matching.knn2_gather(store, mask, ii, jj))
             for _ in range(2))
    b = bound(2.0 * 32 * 2048 * 2048 * 128, PEAK_BF16,
              nbytes_of(store, mask, ii, jj) + 32 * 2048 * 12)
    print(f"  knn2 aerial batch B=32 N=2048: kernel {ms:.4f} ms, "
          f"{bound_text(b)}", flush=True)
    return ms


def compare_knn2_int8(q, db, mask, label):
    """Kernel 2b vs its plain version on the card, on the same tensors:
    the integer arithmetic is exact in both, so idx and both d^2 must be
    equal (+inf included).  Returns the kernel's (d1_sq, d2_sq, idx) and
    the largest |d1_sq| or |d2_sq| difference (inf - inf counts as 0)."""
    import torch
    from metricsfm_tpu_torch.ops import matching

    got = matching.knn2_int8(q, db, mask)
    want = matching.knn2_int8_reference(q, db, mask)
    torch.cuda.synchronize()
    for what, a, b in zip(("d1_sq", "d2_sq", "idx"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            n_bad = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"knn2_int8 {label}: {what} differs from "
                                 f"the plain version on {n_bad} rows")
    err = max(float(torch.where(a == b, 0.0, (a - b).abs()).max())
              for a, b in zip(got[:2], want[:2]))
    print(f"  knn2_int8 {label}: q {tuple(q.shape)} {q.dtype}, db "
          f"{tuple(db.shape)}, idx, d1_sq and d2_sq equal to plain, max "
          f"|d^2 diff| {err:.3g} ({int(torch.isinf(got[1]).sum())} rows with "
          f"d2 = +inf)", flush=True)
    return got, err


def knn2_int8_phase():
    """Phase 3 for kernel 2b; returns its table row (without launches)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import matching

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    def nonneg(*shape):
        return torch.tensor(np.abs(unit_store(rng, *shape)), device=dev)

    # the matching-throughput path's shape and types: 96 pairs of 4096
    # bf16 queries (the chained carry) against 4096 f32 database rows
    d1, d2 = matching.throughput_descriptors(96, 4096)
    q = torch.tensor(d1, device=dev).to(torch.bfloat16)
    db = torch.tensor(d2, device=dev)
    errs = [compare_knn2_int8(q, db, None, "bench 96x4096x4096")[1]]
    # ragged single pair (2-D call), a fifth of the columns masked
    qr, dbr = nonneg(1, 1000)[0], nonneg(1, 777)[0]
    mr = torch.tensor(rng.uniform(size=777) > 0.2, device=dev)
    errs.append(compare_knn2_int8(qr, dbr, mr,
                                  "ragged N1=1000 N2=777 masked")[1])
    # one valid column: idx that column, d2 = +inf
    m1 = torch.zeros(777, dtype=torch.bool, device=dev)
    m1[517] = True
    (_, s2, si), err = compare_knn2_int8(qr, dbr, m1, "one valid column")
    errs.append(err)
    if not (torch.all(si == 517) and torch.all(torch.isinf(s2))):
        raise AssertionError("one valid column: idx != 517 or d2 finite")
    # duplicate best: the tie goes to the lower column, second == best
    qt, dbt = nonneg(1, 300)[0], nonneg(1, 512)[0]
    dbt[300] = dbt[40]
    qt[:8] = dbt[40]
    (t1, t2, ti), err = compare_knn2_int8(qt, dbt, None, "duplicate-best tie")
    errs.append(err)
    if ti[:8].tolist() != [40] * 8 or not torch.equal(t1[:8], t2[:8]):
        raise AssertionError("duplicate-best tie not resolved to the lower "
                             "column with second == best")
    # past the Pallas kernel's N2 <= 8192 cap, two pairs
    ql, dbl = nonneg(2, 1000), nonneg(2, 9000)
    ml = torch.tensor(rng.uniform(size=(2, 9000)) > 0.05, device=dev)
    (_, _, li), err = compare_knn2_int8(ql, dbl, ml, "N2=9000 > 8192")
    errs.append(err)
    if int(li.max()) < 8192:
        raise AssertionError("N2=9000: no best column past 8192")
    errs += knn2_int8_tiling_cases(rng, nonneg)
    compare_quantize(q, db, rng)

    # times at the bench shape: the wrapper as the path calls it (its
    # quantization included), the kernel alone on quantized operands, the
    # plain version, and the int8 product alone as a yardstick
    q8, nq, db8, nb = matching.quantize_pair_int8(q, db)
    plain_ms = cuda_time_ms(lambda: matching.knn2_int8_reference(q, db),
                            reps=3, warmup=1)
    ms = cuda_time_ms(lambda: matching.knn2_int8(q, db))
    kern_ms = cuda_time_ms(lambda: matching.knn2_int8_kernel(q8, db8, nq, nb))
    quant_ms = cuda_time_ms(lambda: matching.quantize_pair_int8(q, db))
    ms2 = cuda_time_ms(lambda: matching.knn2_int8(q, db))
    plain_ms2 = cuda_time_ms(lambda: matching.knn2_int8_reference(q, db),
                             reps=3, warmup=1)
    prod_ms = cuda_time_ms(lambda: torch._int_mm(q8.view(-1, 128),
                                                 db8[0].t()))
    ops = 2.0 * 96 * 4096 * 4096 * 128
    b = bound(ops, PEAK_INT8, nbytes_of(q, db) + 96 * 4096 * 12)
    bk = bound(ops, PEAK_INT8, nbytes_of(q8, db8, nq, nb) + 96 * 4096 * 12)
    bq = bound(0, PEAK_INT8, nbytes_of(q, db, q8, db8, nq, nb))
    print(f"  knn2_int8 96x4096x4096: wrapper {ms:.3f}/{ms2:.3f} ms, kernel "
          f"alone {kern_ms:.3f} ms ({ops / (kern_ms * 1e9):.1f} TOP/s), "
          f"quantize pass alone {quant_ms:.4f} ms ({bound_text(bq)}), "
          f"plain {plain_ms:.3f}/{plain_ms2:.3f} ms, {bound_text(b)}, "
          f"kernel alone {bound_text(bk)}; product only, not the same "
          f"function (torch._int_mm of the 393216x128 queries by one pair's "
          f"database): {prod_ms:.3f} ms", flush=True)
    return {"name": "knn2_int8", "route": "cuda",
            "source": "metricsfm_tpu_torch/ops/csrc/knn2_int8.cu",
            "replaces": "metricsfm_tpu/ops/pallas/match_kernel.py:170",
            "max_abs_err": max(errs), "ms": min(ms, ms2),
            "plain_ms": min(plain_ms, plain_ms2), **b, "library_ms": None,
            "kernel_only_ms": kern_ms, "kernel_only_bound_ms": bk["bound_ms"],
            "quantize_ms": quant_ms, "quantize_bound_ms": bq["bound_ms"],
            "product_only_ms": prod_ms}


def knn2_int8_tiling_cases(rng, nonneg):
    """2b on the edges of its tiling, exact against the plain version: N
    below one tile and one past a multiple, B = 1, a wholly masked
    database tile, a pair with no valid column (d1 = d2 = +inf, idx 0),
    the pair-boundary trap (the database map runs on into the next pair,
    whose first rows equal the queries) and an empty database."""
    import torch

    dev = torch.device("cuda")
    errs = []
    for n, b in ((50, 3), (2047, 4), (4097, 1)):
        m = torch.tensor(rng.uniform(size=(b, n)) > 0.05, device=dev)
        errs.append(compare_knn2_int8(nonneg(b, n), nonneg(b, n), m,
                                      f"N1=N2={n} B={b}")[1])
    q, db = nonneg(2, 1000), nonneg(2, 1000)
    m = torch.tensor(rng.uniform(size=(2, 1000)) > 0.05, device=dev)
    m[0, 256:384] = False
    m[1] = False
    (g1, g2, gi), err = compare_knn2_int8(q, db, m,
                                          "masked tile + no valid column")
    errs.append(err)
    if not (torch.isinf(g1[1]).all() and torch.isinf(g2[1]).all()
            and (gi[1] == 0).all()):
        raise AssertionError("no valid column: d1, d2 not +inf or idx != 0")
    db[1, :24] = q[0, :24]
    m[:] = True
    (_, _, gi), err = compare_knn2_int8(q, db, m, "pair-boundary trap N=1000")
    errs.append(err)
    if int(gi.max()) >= 1000:
        raise AssertionError("pair-boundary trap: a column past N2 won")
    # no database row at all: no launch, the plain version's +inf and 0
    (e1, e2, ei), err = compare_knn2_int8(q, db[:, :0], m[:, :0], "N2=0")
    errs.append(err)
    if not (torch.isinf(e1).all() and torch.isinf(e2).all()
            and (ei == 0).all()):
        raise AssertionError("N2=0: d1, d2 not +inf or idx != 0")
    return errs


def compare_quantize(q, db, rng):
    """The fused quantize pass (one launch for queries and database) against
    its plain version, bit for bit: int8 rows, query norms, database norms
    with masked rows at INT8_NB_MASKED; also on values at the .5 rounding
    boundary."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import matching

    dev = q.device
    edge = torch.tensor(np.abs(unit_store(rng, 1, 64))[0], device=dev)
    edge[0, :8] = torch.tensor([0.5, 1.5, 2.5, 3.5, 100.5, 126.5, 127.5,
                                300.0], device=dev) / 256
    edge[1, :3] = torch.tensor([-0.2, 0.0, 64.5 / 256], device=dev)
    mask = torch.tensor(rng.uniform(size=db.shape[:2]) > 0.1, device=dev)
    for label, a, b, m in (("bench", q, db, mask),
                           ("half steps f32/bf16", edge,
                            edge.to(torch.bfloat16), None)):
        got = matching.quantize_pair_int8(a, b, m)
        torch.cuda.synchronize()
        want = (*matching.quantize_int8_reference(a),
                *matching.quantize_int8_reference(b, m))
        for what, x, y in zip(("q8", "nq", "db8", "nb"), got, want):
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not torch.equal(x, y):
                raise AssertionError(f"quantize {label}: {what} differs "
                                     "from the plain version")
        if not torch.equal(got[0], matching.quantize_desc_int8(a)):
            raise AssertionError(f"quantize {label}: q8 != quantize_desc_int8")
        print(f"  quantize pass {label}: {tuple(a.shape)} {a.dtype} + "
              f"{tuple(b.shape)} {b.dtype}, q8, norms and masked nb equal "
              "to plain", flush=True)


SGM_ROWS = (
    # name, wrapper, source, replaced TPU kernel body
    ("census_cost", "census_cost", "sgm_census.cu",
     "metricsfm_tpu/ops/pallas/sgm_kernel.py:605"),
    ("sgm_horizontal", "sgm_horizontal", "sgm_aggregate.cu",
     "metricsfm_tpu/ops/pallas/sgm_kernel.py:118"),
    ("sgm_partial", "sgm_partial", "sgm_aggregate.cu",
     "metricsfm_tpu/ops/pallas/sgm_kernel.py:156"),
    ("sgm_total_wta", "sgm_total_wta", "sgm_aggregate.cu",
     "metricsfm_tpu/ops/pallas/sgm_kernel.py:283"),
    ("sgm_total", "sgm_total", "sgm_aggregate.cu",
     "metricsfm_tpu/ops/pallas/sgm_kernel.py:761"),
    ("wta", "wta", "sgm_aggregate.cu",
     "metricsfm_tpu/ops/pallas/sgm_kernel.py:358"),
)


def _map_pairs(what, got, want):
    """(label, kernel tensor, plain tensor) for every map of a WTA result
    (a dict, or a (left, right) pair of dicts), or the one tensor."""
    if isinstance(want, dict):
        return [(f"{what} {k}", got[k], want[k]) for k in want]
    if isinstance(want, tuple):
        return _map_pairs(f"{what} left", got[0], want[0]) + \
            _map_pairs(f"{what} right", got[1], want[1])
    return [(what, got, want)]


def _check_equal(label, pairs):
    import torch
    for what, a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            n_bad = int((a.double() != b.double()).sum()) \
                if a.shape == b.shape else -1
            raise AssertionError(f"{label}: {what} differs from the plain "
                                 f"version ({n_bad} elements, {a.dtype} vs "
                                 f"{b.dtype})")


def sgm_2d2g_cases():
    """2d-2g bit-equal to their plain versions beyond the default
    penalties: P2 = 120, 191 (uint8 scratch up to its top, 255), 200
    (int16 scratch) and 4031 with P1 = 40000 (the largest P2 the wrappers
    take, P1 above it), 4 and 8 paths, on D % 4 != 0, degenerate chains
    (one row, one column, one pixel, W < 32: diagonals of length 1 that
    leave at both edges; W < D: the right maps mostly out of range), the
    narrowest and widest lanes (D = 4: 2 disparities a lane; D = 160, 256:
    8, and 2f's largest shared-memory tile), a cost volume at an odd
    address (the scalar loads), 2e on an hsum and 2f / 2g on a partial of
    any sign (int16 wrap per disparity).  2f and 2g take the plain
    partial sum, their own input.  Half the pixels cost 64 but at d = 0,
    so single path values climb to 64 + P2."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import sgm_kernel as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    shapes = ((37, 61, 48), (37, 61, 37), (1, 61, 48), (37, 1, 48),
              (1, 1, 48), (37, 20, 48), (45, 29, 4), (23, 31, 160),
              (17, 19, 256))
    n = 0
    top = {}

    def up_pairs(label, cost, part, p1, p2, paths):
        tot = sk.total_reference(cost, part, p1, p2, paths)
        return _map_pairs(f"2g {label}", sk.sgm_total(
            cost, part, p1, p2, paths), tot) + _map_pairs(
            f"2f {label}", sk.sgm_total_wta(cost, part, p1, p2, paths),
            sk.wta_maps_reference(tot))

    for H, W, D in shapes:
        c = rng.integers(0, 65, (H, W, D))
        band = rng.uniform(size=(H, W)) < 0.5
        c[band] = 64
        c[band, 0] = 0
        cost = torch.tensor(c.astype(np.uint8), device=dev)
        if (H, W, D) == shapes[0]:
            # the same data at an odd address: the scalar specialization
            buf = torch.empty(cost.numel() + 1, dtype=torch.uint8, device=dev)
            odd = buf[1:].view(H, W, D)
            odd.copy_(cost)
        for p1, p2 in ((10, 120), (10, 191), (10, 200), (40000, 4031)):
            label = f"2d-2g {H}x{W}x{D} P1={p1} P2={p2}"
            h_p = sk.horizontal_reference(cost, p1, p2)
            _check_equal(label, [("2d", sk.sgm_horizontal(cost, p1, p2),
                                  h_p)])
            top[p2] = max(top.get(p2, 0), int(sk._scan(
                cost, False, (0,), p1, p2).max()))
            # a partial of any sign, up to the int16 ends: each int16 half
            # wraps on its own, as the int32 add cast to int16 does
            signed = torch.randint(-32768, 32768, (H, W, D), device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(p2),
                                   dtype=torch.int32).to(torch.int16)
            for paths in (4, 8):
                part_p = sk.partial_reference(cost, h_p, p1, p2, paths)
                _check_equal(
                    f"{label} {paths} paths",
                    _map_pairs("2e", sk.sgm_partial(cost, h_p, p1, p2,
                                                    paths), part_p)
                    + up_pairs("", cost, part_p, p1, p2, paths)
                    + up_pairs("signed partial", cost, signed, p1, p2,
                               paths))
                n += 1
            if (H, W, D) == shapes[0]:
                part_p = sk.partial_reference(cost, h_p, p1, p2)
                _check_equal(f"{label} misaligned cost", [
                    ("2d", sk.sgm_horizontal(odd, p1, p2), h_p),
                    ("2e", sk.sgm_partial(odd, h_p, p1, p2), part_p)]
                    + up_pairs("misaligned cost", odd, part_p, p1, p2, 8))
                # an hsum of any sign
                for paths in (4, 8):
                    _check_equal(f"{label} {paths} paths signed hsum", [
                        ("2e", sk.sgm_partial(cost, signed, p1, p2, paths),
                         sk.partial_reference(cost, signed, p1, p2,
                                              paths))])
        torch.cuda.synchronize()
    dims = ", ".join("x".join(map(str, s)) for s in shapes)
    print(f"  sgm 2d-2g: {n} cases equal to plain (P1/P2 10/120, 10/191, "
          f"10/200, 40000/4031; 4 and 8 paths, shapes {dims}; 2f and 2g "
          f"on the plain partial and on a signed partial; a misaligned "
          f"cost volume; 2e on a signed hsum); largest single-path value "
          f"on the down path: {top} (64 + P2 is the bound)", flush=True)
    return n


def sgm_2c2h_cases():
    """2c and 2h bit-equal to their plain versions on the shapes and values
    their code paths branch on.  2c: one row (no vertical context), one
    column, one pixel, W < D, D = 4 and 37 (the scalar stores), 160 and
    256, and W = 1000, not a multiple of the tile (a partial last tile);
    on images with values below 0 and above 1, on a constant image, on
    images of 8 levels (equal neighbours test the strict >), and on images
    one float past a 16-byte boundary.  2h: D = 4, 37, 48, 160 and 256;
    int16 volumes at -32768 and 32767, a flat pixel (best 0, c1 = c0), best
    at 0 and at D - 1, ties; int32 volumes beyond +-2^24 with ties; float32
    volumes beyond 2^24 with +0.0 / -0.0 ties; caps 16000, 30000 and 1e9;
    each volume also at a storage offset (the scalar loads)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import sgm_kernel as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)

    def at_offset(t):   # the same values one element past the allocation
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    n = 0
    shapes = ((37, 61, 48), (37, 61, 37), (1, 61, 48), (37, 1, 48),
              (1, 1, 48), (37, 20, 48), (45, 29, 4), (23, 31, 160),
              (17, 19, 256), (9, 1000, 128))
    for H, W, D in shapes:
        images = {
            "values in [-0.5, 1.5)": [rng.uniform(-0.5, 1.5, (H, W))
                                      for _ in range(2)],
            "8 levels": [rng.integers(0, 8, (H, W)) / 7 for _ in range(2)],
            "constant": [np.full((H, W), 0.5)] * 2}
        for what, (left, right) in images.items():
            L = torch.tensor(left.astype(np.float32), device=dev)
            R = torch.tensor(right.astype(np.float32), device=dev)
            want = sk.census_cost_reference(L, R, D)
            pairs = [("2c", sk.census_cost(L, R, D), want)]
            if what == "8 levels":
                pairs.append(("2c, images at an offset", sk.census_cost(
                    at_offset(L), at_offset(R), D), want))
            _check_equal(f"2c {H}x{W}x{D} {what}", pairs)
            n += len(pairs)

    def wta_pairs(label, vol, caps):
        out = []
        for cap in caps:
            want = sk.wta_reference(vol, cap)
            out += _map_pairs(f"{label} cap {cap}", sk.wta(vol, cap), want)
            out += _map_pairs(f"{label} cap {cap} at an offset",
                              sk.wta(at_offset(vol), cap), want)
        return out

    for D in (4, 37, 48, 128, 160, 256):
        H, W = 13, 37
        v16 = rng.integers(-32768, 32768, (H, W, D))
        v16[0, 0] = 7                      # flat: best 0, c1 = c0
        v16[0, 1] = -32768
        v16[0, 2] = 32767
        v16[1, :, 0] = -32768              # best at 0
        v16[2, :, D - 1] = -32768          # best at D - 1
        v16[3] = rng.integers(0, 4, (W, D))   # ties
        i32 = rng.integers(-2 ** 30, 2 ** 30, (H, W, D))
        i32[0, :, ::3] = -2 ** 29 - 1      # ties beyond 2^24
        i32[1] = rng.integers(0, 3, (W, D)) * 2 ** 25
        f32 = rng.integers(-3, 4, (H, W, D)) * 3.0e7
        f32[0] = rng.uniform(-1, 1, (W, D))
        f32 = f32.astype(np.float32)
        f32[f32 == 0] = -0.0
        f32[1, :, ::2] = 0.0               # +0.0 / -0.0 ties at the min
        f32[1, :, 1::2] = -0.0
        pairs = (wta_pairs(f"2h int16 D={D}", torch.tensor(
                     v16.astype(np.int16), device=dev), (16000, 30000))
                 + wta_pairs(f"2h int32 D={D}", torch.tensor(
                     i32.astype(np.int32), device=dev), (30000, 10 ** 9))
                 + wta_pairs(f"2h float32 D={D}", torch.tensor(
                     f32, device=dev), (1e9, 16000.0)))
        _check_equal(f"2h D={D}", pairs)
        n += len(pairs) // len(sk.WTA_LEFT)
    torch.cuda.synchronize()
    print(f"  sgm 2c / 2h: {n} cases equal to plain (2c: shapes "
          f"{', '.join('x'.join(map(str, sh)) for sh in shapes)}; values "
          f"in [-0.5, 1.5), 8 levels, constant; images at an offset; 2h: "
          f"D 4, 37, 48, 128, 160, 256; int16 extremes, flat, best at 0 "
          f"and D - 1, ties; int32 beyond 2^24 with ties; float32 beyond "
          f"2^24 with +-0.0 ties; caps 16000, 30000, 1e9; every volume "
          f"also at an offset)", flush=True)
    return n


def compare_sgm(H, W, D, seed, label, time_it):
    """Kernels 2c-2h against their plain versions on the card, each fed the
    same inputs; every output must be equal (2h also on an int32 and a
    float32 volume, and on the skewed right volume of the volume path).
    Returns {name: (max_abs_err, ms, plain_ms)} (times only when
    time_it)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import sgm
    from metricsfm_tpu_torch.ops import sgm_kernel as sk
    from metricsfm_tpu_torch.utils import synth

    dev = torch.device("cuda")
    left, right, _ = synth.stereo_pair(np.random.default_rng(seed), H=H,
                                       W=W, disp_bg=D // 5, disp_fg=D // 2)
    L = torch.tensor(left, device=dev)
    R = torch.tensor(right, device=dev)
    cost_p = sk.census_cost_reference(L, R, D)
    h_p = sk.horizontal_reference(cost_p)
    part_p = sk.partial_reference(cost_p, h_p)
    total_p = sk.total_reference(cost_p, part_p)
    wl_p, wr_p = sk.wta_maps_reference(total_p)
    wta_p = sk.wta_reference(total_p, 30000)
    calls = {   # name: (kernel call, plain call, plain result)
        "census_cost": (lambda: sk.census_cost(L, R, D),
                        lambda: sk.census_cost_reference(L, R, D), cost_p),
        "sgm_horizontal": (lambda: sk.sgm_horizontal(cost_p),
                           lambda: sk.horizontal_reference(cost_p), h_p),
        "sgm_partial": (lambda: sk.sgm_partial(cost_p, h_p),
                        lambda: sk.partial_reference(cost_p, h_p), part_p),
        "sgm_total_wta": (lambda: sk.sgm_total_wta(cost_p, part_p),
                          lambda: sk.total_wta_reference(cost_p, part_p),
                          (wl_p, wr_p)),
        "sgm_total": (lambda: sk.sgm_total(cost_p, part_p),
                      lambda: sk.total_reference(cost_p, part_p), total_p),
        "wta": (lambda: sk.wta(total_p, 30000),
                lambda: sk.wta_reference(total_p, 30000), wta_p),
    }
    # the bound of each kernel: its inputs read once and its outputs
    # written once, against an estimate of its 32-bit integer work per
    # volume element (a path: about 8 ops per element; WTA: about 6) at
    # the card's 32-bit integer issue rate; 2c's in census_bound
    vol = H * W * D

    def maps(m):
        return nbytes_of(*(t for _, t, _ in _map_pairs("", m, m)))
    io = {   # name: (input and output bytes, integer ops, of which path
        #        steps, which run two disparities per DPX 16x2 instruction)
        "census_cost": (nbytes_of(L, R, cost_p), None, 0),
        "sgm_horizontal": (nbytes_of(cost_p, h_p), 17 * vol, 17 * vol),
        "sgm_partial": (nbytes_of(cost_p, h_p, part_p), 27 * vol, 27 * vol),
        "sgm_total_wta": (nbytes_of(cost_p, part_p) + maps((wl_p, wr_p)),
                          36 * vol, 27 * vol),
        "sgm_total": (nbytes_of(cost_p, part_p, total_p), 27 * vol,
                      27 * vol),
        "wta": (nbytes_of(total_p) + maps(wta_p), 6 * vol, 0),
    }
    out = {}
    for name, (kern, plain, want) in calls.items():
        got = kern()
        torch.cuda.synchronize()
        _check_equal(label, _map_pairs(name, got, want))
        nbytes, ops, pair_ops = io[name]
        b = census_bound(H, W, D, nbytes) if name == "census_cost" \
            else bound(ops, PEAK_INT32, nbytes)
        if pair_ops:
            # the path steps run two disparities per DPX 16x2 instruction:
            # at that rate their operation term halves (2f's WTA does not);
            # kept beside the int32 bound
            b["pair_bound_ms"] = max(
                b["ops_ms"] * (ops - pair_ops / 2) / ops, b["bytes_ms"])
        out[name] = [0.0, None, None, b]
    # 2h on the other volumes it takes: the skewed right volume of the
    # volume path (30000 fills), int32 and float32 volumes with ties
    gen = torch.Generator(device=dev).manual_seed(seed)
    others = {
        "right int16": sk.skew_right(total_p, 30000),
        "int32": torch.randint(-50_000, 50_000, (H, W, D), generator=gen,
                               device=dev, dtype=torch.int32),
        "float32": torch.randint(0, 4000, (H, W, D), generator=gen,
                                 device=dev).float() * 0.37,
    }
    for what, vol in others.items():
        cap = 1e9 if vol.is_floating_point() else 30000
        got = sk.wta(vol, cap)
        torch.cuda.synchronize()
        _check_equal(label, _map_pairs(f"wta {what}", got,
                                       sk.wta_reference(vol, cap)))
        if time_it and what != "right int16":
            ms = min(cuda_time_ms(lambda: sk.wta(vol, cap))
                     for _ in range(2))
            out["wta"][3][f"{what}_ms"] = ms
            print(f"  wta {H}x{W}x{D} {what} volume: kernel {ms:.3f} ms, "
                  f"equal to plain", flush=True)
    del others
    # the disparity after the torch tail, kernel maps vs plain maps
    wl, wr = sk.sgm_total_wta(cost_p, part_p)
    d_k, v_k = sgm.disparity_from_wta(wl, wr, D)
    d_p, v_p = sgm.disparity_from_wta(wl_p, wr_p, D)
    derr = float((d_k - d_p).abs().max())
    if not torch.equal(v_k, v_p) or derr > 1e-5:
        raise AssertionError(f"{label}: disparity differs ({derr})")
    out["sgm_total_wta"][0] = derr
    print(f"  sgm {label}: 2c-2h equal to plain on every output (volume, "
          f"hf+hb, partial, 9 WTA maps, total, 6 WTA maps of the int16 "
          f"total, its skewed right volume, an int32 and a float32 volume); "
          f"disparity max err {derr:.3g}, valid "
          f"{float(v_k.float().mean()):.4f}", flush=True)
    if time_it:
        # 2d-2g with int16 scratch (P2 = 200), equal and timed
        h200 = sk.horizontal_reference(cost_p, 10, 200)
        part200 = sk.partial_reference(cost_p, h200, 10, 200)
        tot200 = sk.total_reference(cost_p, part200, 10, 200)
        extra = {"sgm_horizontal": (lambda: sk.sgm_horizontal(cost_p, 10,
                                                              200), h200),
                 "sgm_partial": (lambda: sk.sgm_partial(cost_p, h200, 10,
                                                        200), part200),
                 "sgm_total_wta": (lambda: sk.sgm_total_wta(
                     cost_p, part200, 10, 200), sk.wta_maps_reference(
                         tot200)),
                 "sgm_total": (lambda: sk.sgm_total(cost_p, part200, 10,
                                                    200), tot200)}
        for name, (kern, want) in extra.items():
            _check_equal(f"{label} P2=200", _map_pairs(name, kern(), want))
            out[name].append(min(cuda_time_ms(kern), cuda_time_ms(kern)))
            print(f"  {name} {H}x{W}x{D} P2=200 (int16 scratch): kernel "
                  f"{out[name][4]:.3f} ms, equal to plain", flush=True)
        del h200, part200, tot200, extra
        for name, (kern, plain, _) in calls.items():
            # plain versions are Python loops of small launches (~0.1-1 s a
            # call at this shape): 3 repetitions after 1 warm-up
            p1 = cuda_time_ms(plain, reps=3, warmup=1)
            k1 = cuda_time_ms(kern)
            k2 = cuda_time_ms(kern)
            p2 = cuda_time_ms(plain, reps=3, warmup=1)
            out[name][1:3] = [min(k1, k2), min(p1, p2)]
            b = out[name][3]
            share = f"{100 * b['bound_ms'] / out[name][1]:.1f} % of bound"
            if "pair_bound_ms" in b:
                share += (f", {100 * b['pair_bound_ms'] / out[name][1]:.1f} % "
                          f"of the pair-rate bound {b['pair_bound_ms']:.4f} ms")
            if "pr2_bound_ms" in b:
                share += (f"; PR 2's count {b['pr2_bound_ms']:.4f} ms, "
                          f"{100 * b['pr2_bound_ms'] / out[name][1]:.1f} %")
            print(f"  {name} {H}x{W}x{D}: kernel {k1:.3f}/{k2:.3f} ms, "
                  f"plain {p1:.3f}/{p2:.3f} ms, {bound_text(b)}, {share}",
                  flush=True)
        # yardsticks, not the same function: 2c's store stream alone, and
        # c0 / best alone of 2h's total
        yard = {"census_cost": ("torch.full of 64", lambda: torch.full(
                    (H, W, D), 64, dtype=torch.uint8, device=dev)),
                "wta": ("torch.min over d",
                        lambda: torch.min(total_p, dim=-1))}
        for name, (what, fn) in yard.items():
            ms = min(cuda_time_ms(fn) for _ in range(2))
            out[name][3]["yardstick_ms"] = ms
            print(f"  {name} yardstick ({what}): {ms:.3f} ms", flush=True)
    return out


def ptxas_registers(log):
    """{entry function: (registers, spill bytes)} from an nvcc -Xptxas -v
    build log."""
    import re
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = (int(m.group(1)), spill)
    return out


SGM_FUNCTIONS = (   # label, library, pattern of the mangled name
    ("2c census_cost_kernel (vector: D % 16 == 0)", "sgm_census",
     r"census_cost_kernelILb1E"),
    ("2c census_cost_kernel (scalar)", "sgm_census",
     r"census_cost_kernelILb0E"),
    ("2d chain_kernel (K 4, ring 32, vector: D = 128)", "sgm_aggregate",
     r"chain_kernelILi4ELi32ELb1E"),
    ("2e/2f/2g chain_kernel (K 4, ring 8, vector: D = 128)", "sgm_aggregate",
     r"chain_kernelILi4ELi8ELb1E"),
    ("2d-2g chain_kernel (K 2, scalar: D = 37)", "sgm_aggregate",
     r"chain_kernelILi2ELi\d+ELb0E"),
    ("2d-2g chain_kernel (K 8, ring 16 / 4, vector: D = 256)",
     "sgm_aggregate", r"chain_kernelILi8ELi\d+ELb1E"),
    ("2f wta_tile_kernel (2 words a lane, vector: D = 128)", "sgm_aggregate",
     r"wta_tile_kernelILi2ELb1E"),
    ("2f wta_tile_kernel (D = 37 .. 256)", "sgm_aggregate",
     r"wta_tile_kernelILi\dELb\dE"),
    ("2h wta_stream_kernel (int16, K 4, vector: D = 128)", "sgm_aggregate",
     r"wta_stream_kernelIsLi4ELb1E"),
    ("2h wta_stream_kernel (int32 / float32, vector)", "sgm_aggregate",
     r"wta_stream_kernelI[if]Li\dELb1E"),
    ("2h wta_stream_kernel (scalar)", "sgm_aggregate",
     r"wta_stream_kernelI\w+Li\dELb0E"),
)


def sgm_registers():
    """Print the registers and spills of the SGM kernels' builds (when
    this process built them: a library found already built has no build
    log), 2c's shared memory a block and that of 2f's WTA tiles."""
    import ctypes
    import re
    from metricsfm_tpu_torch.ops import cuda_build
    fn = cuda_build.load_library("sgm_census").sgm_census_cost_tile
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    nbytes = ctypes.c_int()
    tile = fn(ctypes.byref(nbytes))
    print(f"  2c census_cost_kernel: {tile} pixels a block, "
          f"{nbytes.value} B of static shared memory", flush=True)
    fn = cuda_build.load_library("sgm_aggregate").sgm_total_wta_tile
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    tiles = []
    for D in (4, 37, 48, 128, 160, 256):
        tiles.append(f"D {D}: {fn(D, ctypes.byref(nbytes))} pixels, "
                     f"{nbytes.value} B")
    print(f"  2f wta_tile_kernel dynamic shared memory a block: "
          f"{'; '.join(tiles)}", flush=True)
    regs = {}
    for lib in ("sgm_census", "sgm_aggregate"):
        log = cuda_build.build_info[lib]["log"]
        if not log:
            print(f"  registers: {lib} was already built, no build log",
                  flush=True)
        regs[lib] = ptxas_registers(log)
    for label, lib, key in SGM_FUNCTIONS:
        if not cuda_build.build_info[lib]["log"]:
            continue
        hits = [v for k, v in regs[lib].items() if re.search(key, k)]
        if not hits:
            raise AssertionError(f"no ptxas line for {label}")
        print(f"  registers {label}: {min(r for r, _ in hits)}-"
              f"{max(r for r, _ in hits)} a thread over {len(hits)} "
              f"instantiations, spill bytes {sum(s for _, s in hits)}",
              flush=True)


def sgm_phase():
    """Phase 3 for kernels 2c-2h; returns their table rows (no launches)."""
    sgm_registers()
    ragged = compare_sgm(37, 61, 48, seed=1, label="ragged 37x61x48",
                         time_it=False)
    sgm_2d2g_cases()
    sgm_2c2h_cases()
    full = compare_sgm(768, 1024, 128, seed=0, label="768x1024x128",
                       time_it=True)
    rows = []
    for name, _, src, replaces in SGM_ROWS:
        err = max(full[name][0], ragged[name][0])
        row = {"name": name, "route": "cuda",
               "source": f"metricsfm_tpu_torch/ops/csrc/{src}",
               "replaces": replaces, "max_abs_err": err,
               "ms": full[name][1], "plain_ms": full[name][2],
               **full[name][3], "library_ms": None}
        if len(full[name]) > 4:
            row["int16_scratch_ms"] = full[name][4]
        rows.append(row)
    return rows


def dense_scene(H=768, W=1024, disp_bg=24.0, disp_fg=72.0):
    import numpy as np
    from metricsfm_tpu_torch.utils import synth
    return synth.stereo_pair(np.random.default_rng(0), H=H, W=W,
                             disp_bg=disp_bg, disp_fg=disp_fg)


def write_dense_fold(fold, left, right, focal, baseline):
    import numpy as np
    from PIL import Image
    from metricsfm_tpu_torch.utils import synth

    H, W = left.shape
    synth.write_stereo_sure(os.path.join(fold, "sfm_sure.txt"),
                            ["left.png", "right.png"], W, H, focal, baseline)
    for name, img in (("left.png", left), ("right.png", right)):
        Image.fromarray((np.clip(img, 0, 1) * 255).round().astype(
            np.uint8)).save(os.path.join(fold, name))


def dense_region(H, W):
    """The pixels the gates read: away from the left band (x < 24, where
    the background's match leaves the image) and the borders."""
    import numpy as np
    region = np.zeros((H, W), bool)
    region[8:-8, 64:-8] = True
    return region


def dense_gates(disp, valid, disp_gt, within2_min, what):
    """The JAX tests' accuracy gates (tests/test_sgm_dense.py: |err| < 2 px
    share > 0.8; tests/test_elas.py:59-62: > 0.9); returns (valid share,
    median |err|, |err| < 2 px share)."""
    import numpy as np
    sel = valid & dense_region(*valid.shape)
    err = np.abs(disp - disp_gt)[sel]
    share, med = float(sel.mean()), float(np.median(err))
    within2 = float((err < 2).mean())
    if share <= 0.3 or med >= 1.0 or within2 <= within2_min:
        raise AssertionError(f"{what} accuracy gates failed: valid {share}, "
                             f"median {med}, <2px {within2}")
    return share, med, within2


def dense_phase(D=128, runs=2, method="sgm"):
    """Run `cli dense --method <method>` on the synthetic pair `runs` times
    (fresh folders; the last run is timed); returns the last run's (SGM
    kernel launch counts, stats)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch import cli
    from metricsfm_tpu_torch.ops import sgm_kernel
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER

    left, right, disp_gt = dense_scene()
    H, W = left.shape
    focal, baseline = 1.1 * W, 0.5
    for run in range(runs):
        fold = tempfile.mkdtemp(prefix="msf_smoke_dense_")
        try:
            write_dense_fold(fold, left, right, focal, baseline)
            GLOBAL_TRACER.reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            sgm_kernel.reset_launches()
            t0 = time.perf_counter()
            clouds = cli.main(["dense", fold, "--disp", str(D), "--method",
                               method, "--device", "cuda"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in sgm_kernel.KERNELS}
            depth = np.load(os.path.join(fold, "dense", "depth_0.npy"))
        finally:
            shutil.rmtree(fold, ignore_errors=True)
        valid = depth > 0
        disp = np.where(valid, 20.0 * focal * baseline
                        / np.maximum(depth, 1e-6), -1.0)
        share, med, within2 = dense_gates(
            disp, valid, disp_gt, 0.9 if method == "elas" else 0.8,
            f"dense {method}")
        peak = torch.cuda.max_memory_allocated()
        stages = GLOBAL_TRACER.as_dict()
        stereo_s = stages["dense/stereo"]["total_s"]
        label = "warm-up" if run < runs - 1 else "timed"
        print(f"  dense {method} run {run} ({label}): {dt:.4f} s wall, "
              f"dense/stereo {stereo_s:.4f} s = "
              f"{H * W / 1e6 / stereo_s:.3f} MP/s, {len(clouds[0])} points, "
              f"valid share {share:.4f}, median |err| {med:.4f} px, "
              f"|err|<2 {within2:.4f}, peak {peak / 2**20:.1f} MiB, "
              f"launches {launches}", flush=True)
        stats = {"dense_seconds": dt, "stereo_seconds": stereo_s,
                 "stereo_mp_per_s": H * W / 1e6 / stereo_s,
                 "valid_share": share, "median_err_px": med,
                 "within_2px": within2, "peak_bytes": peak,
                 "stages": GLOBAL_TRACER.report()}
    print("  stage table (timed run):\n" + "\n".join(
        "    " + ln for ln in stats["stages"].splitlines()), flush=True)
    return launches, stats


def quantized_pair(left, right, dev):
    """The pair as `cli dense` reads it back from its 8-bit PNGs."""
    import numpy as np
    import torch
    return [torch.tensor(np.round(np.clip(x, 0, 1) * 255).astype(
        np.uint8).astype(np.float32) / 255.0, device=dev)
        for x in (left, right)]


@contextlib.contextmanager
def no_plain_versions():
    """Make every plain SGM version raise while the block runs, so a path
    that reaches one on the card fails instead of running a Python scan."""
    from metricsfm_tpu_torch.ops import sgm_kernel as sk
    names = ("census_cost_reference", "horizontal_reference",
             "partial_reference", "total_reference", "total_wta_reference",
             "wta_reference")
    saved = {n: getattr(sk, n) for n in names}

    def barred(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"plain version {name} ran on the card")
        return fn
    try:
        for n in names:
            setattr(sk, n, barred(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(sk, n, f)


VOLUME_LAUNCHES = {"census_cost": 1, "sgm_horizontal": 1, "sgm_partial": 1,
                   "sgm_total_wta": 0, "sgm_total": 1, "wta": 2}


def volume_phase(D=128, runs=2):
    """Run `stereo_sgm_volume` (path A) on the dense pair `runs` times (the
    last timed); returns the last run's (launch counts, stats)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import sgm, sgm_kernel

    dev = torch.device("cuda")
    left, right, disp_gt = dense_scene()
    H, W = left.shape
    L, R = quantized_pair(left, right, dev)
    for run in range(runs):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        sgm_kernel.reset_launches()
        t0 = time.perf_counter()
        with no_plain_versions():
            disp, valid = sgm.stereo_sgm_volume(L, R, max_disp=D)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in sgm_kernel.KERNELS}
        peak = torch.cuda.max_memory_allocated()
        if launches != VOLUME_LAUNCHES:
            raise AssertionError(f"volume path launches {launches}, "
                                 f"expected {VOLUME_LAUNCHES}")
        share, med, within2 = dense_gates(
            disp.cpu().numpy(), valid.cpu().numpy(), disp_gt, 0.8,
            "SGM volume path")
        label = "warm-up" if run < runs - 1 else "timed"
        print(f"  volume run {run} ({label}): {dt * 1e3:.3f} ms = "
              f"{H * W / 1e6 / dt:.3f} MP/s, valid share {share:.4f}, "
              f"median |err| {med:.4f} px, |err|<2 {within2:.4f}, peak "
              f"{peak / 2**20:.1f} MiB, launches {launches}", flush=True)
    fused_disp, fused_valid = sgm.stereo_sgm(L, R, max_disp=D)
    differ = float((fused_valid != valid).float().mean())
    both = fused_valid & valid
    derr = float((fused_disp - disp).abs()[both].max())
    print(f"  volume vs fused stereo_sgm: valid masks differ on "
          f"{100 * differ:.4f} % of the pixels, disparity max |diff| "
          f"{derr:.3g} px where both are valid", flush=True)
    return launches, {"seconds": dt, "mp_per_s": H * W / 1e6 / dt,
                      "valid_share": share, "median_err_px": med,
                      "within_2px": within2, "peak_bytes": peak,
                      "valid_differs_from_fused": differ}


def main_path_phase(n_cams=8, width=1024, height=768, max_kp=4096, runs=2):
    """Run `cli sfm` on a rendered scene `runs` times (fresh folders; the
    first run warms CUDA and library initialization, the last is timed);
    returns the last run's (launch counts, stats)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch import cli
    from metricsfm_tpu_torch.ops import matching, np_geom
    from metricsfm_tpu_torch.utils import synth
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER

    gt = synth.render_scene(seed=0, n_cams=n_cams, width=width,
                            height=height, focal=1.1 * width)
    stats = {}
    for run in range(runs):
        fold = tempfile.mkdtemp(prefix="msf_smoke_")
        try:
            synth.write_scene_images(fold, gt)
            GLOBAL_TRACER.reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            matching.knn2_gather.launches = 0
            t0 = time.perf_counter()
            scenes = cli.main(["sfm", fold, "--mode", "web", "--matching",
                               "all", "--no-resize", "--max-kp",
                               str(max_kp), "--device", "cuda"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {"knn2": matching.knn2_gather.launches}
        finally:
            shutil.rmtree(fold, ignore_errors=True)
        if not scenes:
            raise AssertionError("no model reconstructed")
        best = max(scenes, key=lambda s: len(s.registered))
        est = np.stack([np_geom.camera_center(best.poses[i])
                        for i in best.registered])
        ate = synth.ate_vs_gt(est, gt["centers"][best.registered])
        peak = torch.cuda.max_memory_allocated()
        label = "warm-up" if run < runs - 1 else "timed"
        print(f"  e2e run {run} ({label}): {len(best.registered)}/{n_cams} "
              f"registered, {best.n_points()} points, ATE {ate:.5f}, "
              f"{dt:.3f} s = {n_cams / dt:.4f} images/s, peak "
              f"{peak / 2**20:.1f} MiB, launches {launches}", flush=True)
        if len(best.registered) != n_cams:
            raise AssertionError(f"registered {len(best.registered)}/{n_cams}")
        if ate >= 0.05:
            raise AssertionError(f"ATE {ate} >= 0.05 of trajectory extent")
        if peak <= 0:
            raise AssertionError("no device memory was allocated")
        stats = {"images_per_s": n_cams / dt, "seconds": dt, "ate": ate,
                 "peak_bytes": peak, "stages": GLOBAL_TRACER.report()}
    print("  stage table (timed run):\n" + "\n".join(
        "    " + ln for ln in stats["stages"].splitlines()), flush=True)
    return launches, stats


def web_path_phase(n_cams=24, width=1024, height=768, max_kp=4096,
                   arc_step=0.03):
    """4c: `cli sfm` with the user's defaults (web mode, no --matching: BoW
    candidates above 12 images) on `n_cams` rendered views, twice in fresh
    folders: a warm-up with --debug-matches (gate: renders written) and a
    timed run without.  `arc_step` 0.03 rad keeps the 24-view arc on the
    planes (>= 90 % of every view).  Returns the timed run's (launches,
    stats)."""
    import dataclasses

    import numpy as np
    import torch
    from metricsfm_tpu_torch import cli
    from metricsfm_tpu_torch.config import PRESETS
    from metricsfm_tpu_torch.io import store as fstore
    from metricsfm_tpu_torch.models.database import Database
    from metricsfm_tpu_torch.models.match_graph import candidates_feature
    from metricsfm_tpu_torch.ops import matching, np_geom
    from metricsfm_tpu_torch.utils import synth
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER

    gt = synth.render_scene(seed=0, n_cams=n_cams, width=width,
                            height=height, focal=1.1 * width,
                            arc_step=arc_step)
    cfg = PRESETS["web"]()
    db_opts = dataclasses.replace(cfg.database, resize=False,
                                  max_keypoints=max_kp)
    for run, debug in enumerate((True, False)):
        fold = tempfile.mkdtemp(prefix="msf_smoke_web_")
        try:
            synth.write_scene_images(fold, gt)
            GLOBAL_TRACER.reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            matching.knn2_gather.launches = 0
            t0 = time.perf_counter()
            scenes = cli.main(["sfm", fold, "--no-resize", "--max-kp",
                               str(max_kp), "--device", "cuda"]
                              + (["--debug-matches"] if debug else []))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {"knn2": matching.knn2_gather.launches}
            peak = torch.cuda.max_memory_allocated()
            # what the run stored: the vocabulary, the word bags, renders;
            # the candidates before and after the word-seed gate are
            # recounted from those stores (nothing is retrained)
            out = os.path.join(fold, "mtpu_db")
            voc = fstore.read_vocabulary(out, "cuda")
            n_word_files = sum(os.path.exists(os.path.join(
                out, f"{i}_words.npz")) for i in range(n_cams))
            renders = os.path.join(out, "match_renders")
            n_renders = len(os.listdir(renders)) \
                if os.path.isdir(renders) else 0
            cands, kept = candidates_feature(
                Database(fold, db_opts, device="cuda"), cfg.graph, "cuda")
        finally:
            shutil.rmtree(fold, ignore_errors=True)
        if not scenes:
            raise AssertionError("web: no model reconstructed")
        best = max(scenes, key=lambda s: len(s.registered))
        est = np.stack([np_geom.camera_center(best.poses[i])
                        for i in best.registered])
        ate = synth.ate_vs_gt(est, gt["centers"][best.registered])
        label = "warm-up, --debug-matches" if debug else "timed"
        print(f"  web run {run} ({label}): vocabulary "
              f"{voc.n_words if voc is not None else 0} words, "
              f"{n_word_files} word files; {len(cands)} candidate pairs, "
              f"{len(kept)} after the word-seed gate; "
              f"{len(best.registered)}/{n_cams} registered, "
              f"{best.n_points()} points, ATE {ate:.5f}, {dt:.3f} s = "
              f"{n_cams / dt:.4f} images/s, peak {peak / 2**20:.1f} MiB, "
              f"launches {launches}, renders {n_renders}", flush=True)
        if voc is None or n_word_files != n_cams:
            raise AssertionError(f"web: vocabulary {voc is not None}, "
                                 f"{n_word_files}/{n_cams} word files")
        if not kept or launches["knn2"] < 1:
            raise AssertionError("web: the feature branch matched nothing")
        if debug and n_renders < 1:
            raise AssertionError("web: --debug-matches wrote no render")
        if len(best.registered) != n_cams:
            raise AssertionError(f"web: registered {len(best.registered)}/"
                                 f"{n_cams}")
        if ate >= 0.05:
            raise AssertionError(f"web: ATE {ate} >= 0.05")
        stats = {"images_per_s": n_cams / dt, "seconds": dt, "ate": ate,
                 "peak_bytes": peak, "words": voc.n_words,
                 "candidate_pairs": len(cands),
                 "pairs_after_word_gate": len(kept), "renders": n_renders,
                 "stages": GLOBAL_TRACER.report()}
    print("  stage table (timed run):\n" + "\n".join(
        "    " + ln for ln in stats["stages"].splitlines()), flush=True)
    return launches, stats


def write_exif_jpegs(fold, images, focal_px):
    """The rendered views as JPEGs (quality 95) whose EXIF carries the
    render's focal: FocalLength in mm with FocalPlaneXResolution of 2540
    per inch (100 px per mm), so focal_px = FocalLength * 100."""
    import numpy as np
    from PIL import Image

    os.makedirs(fold, exist_ok=True)
    exif = Image.Exif()
    exif[0x8769] = {0x920A: focal_px / 100.0,          # FocalLength
                    0xA20E: 2540.0, 0xA20F: 2540.0,    # FocalPlane X/Y res
                    0xA210: 2}                         # ... per inch
    for i, img in enumerate(images):
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        pil.save(os.path.join(fold, f"view_{i:03d}.jpg"), quality=95,
                 exif=exif)


def exif_path_phase(n_cams=8, width=1024, height=768, max_kp=4096, runs=2):
    """Run `cli sfm` on the rendered scene of phase 4 written as EXIF-tagged
    JPEGs, so every pair seeds through the calibrated 5-point path; the
    knn2 launch count and the 5-point RANSAC call count are reset just
    before each run and read just after.  Gates: 8/8 registered, ATE <
    0.05, the 5-point RANSAC ran, every camera model calibrated.  Returns
    the last run's (launch counts, stats)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch import cli
    from metricsfm_tpu_torch.ops import five_point, matching, np_geom
    from metricsfm_tpu_torch.utils import synth
    from metricsfm_tpu_torch.utils.exif import extract_image_info
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER

    focal = 1.1 * width
    gt = synth.render_scene(seed=0, n_cams=n_cams, width=width,
                            height=height, focal=focal)
    stats = {}
    for run in range(runs):
        fold = tempfile.mkdtemp(prefix="msf_smoke_exif_")
        try:
            write_exif_jpegs(fold, gt["images"], focal)
            f_read = extract_image_info(
                os.path.join(fold, "view_000.jpg"))["focal_px"]
            if abs(f_read - focal) > 0.005 * focal:
                raise AssertionError(f"EXIF focal {f_read} != {focal}")
            GLOBAL_TRACER.reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            matching.knn2_gather.launches = 0
            five_point.essential_ransac_5pt.calls = 0
            t0 = time.perf_counter()
            scenes = cli.main(["sfm", fold, "--mode", "web", "--matching",
                               "all", "--no-resize", "--max-kp",
                               str(max_kp), "--device", "cuda"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {"knn2": matching.knn2_gather.launches}
            calls_5pt = five_point.essential_ransac_5pt.calls
        finally:
            shutil.rmtree(fold, ignore_errors=True)
        if not scenes:
            raise AssertionError("exif: no model reconstructed")
        best = max(scenes, key=lambda s: len(s.registered))
        est = np.stack([np_geom.camera_center(best.poses[i])
                        for i in best.registered])
        ate = synth.ate_vs_gt(est, gt["centers"][best.registered])
        peak = torch.cuda.max_memory_allocated()
        label = "warm-up" if run < runs - 1 else "timed"
        print(f"  exif run {run} ({label}): EXIF focal {f_read:.3f} px "
              f"(true {focal:.3f}); {len(best.registered)}/{n_cams} "
              f"registered, {best.n_points()} points, ATE {ate:.5f}, "
              f"{dt:.3f} s = {n_cams / dt:.4f} images/s, peak "
              f"{peak / 2**20:.1f} MiB, launches {launches}, 5-point "
              f"RANSAC calls {calls_5pt}", flush=True)
        if len(best.registered) != n_cams:
            raise AssertionError(
                f"exif: registered {len(best.registered)}/{n_cams}")
        if ate >= 0.05:
            raise AssertionError(f"exif: ATE {ate} >= 0.05")
        if calls_5pt < 1:
            raise AssertionError("exif: the 5-point seed never ran")
        if not all(m.calibrated for m in best.models):
            raise AssertionError("exif: a camera model is not calibrated")
        stats = {"images_per_s": n_cams / dt, "seconds": dt, "ate": ate,
                 "peak_bytes": peak, "five_point_calls": calls_5pt,
                 "focal_exif": f_read, "stages": GLOBAL_TRACER.report()}
    print("  stage table (timed run):\n" + "\n".join(
        "    " + ln for ln in stats["stages"].splitlines()), flush=True)
    stats["five_point_ms"] = time_five_point()
    return launches, stats


def time_five_point(n_hyp=128, n=2000):
    """Device times of the calibrated seed's pieces at the seed's shapes:
    the batched 5x9 SVDs of 128 minimal samples alone, the whole 5-point
    solve of the 128 samples, and the 5-point RANSAC with its refits over
    `n` correspondences (plain torch ops, no kernel of this repo)."""
    import torch
    from metricsfm_tpu_torch.ops import five_point

    g = torch.Generator(device="cuda").manual_seed(0)
    x1 = torch.rand((n, 2), generator=g, device="cuda") - 0.5
    x2 = x1 + 0.01 * torch.rand((n, 2), generator=g, device="cuda")
    s1, s2 = x1[:5 * n_hyp].reshape(n_hyp, 5, 2), \
        x2[:5 * n_hyp].reshape(n_hyp, 5, 2)
    ms = {"svd_5x9_x128": cuda_time_ms(
              lambda: five_point._nullspace4(s1, s2)),
          "essential_5pt_x128": cuda_time_ms(
              lambda: five_point.essential_5pt(s1, s2)),
          "essential_ransac_5pt": cuda_time_ms(
              lambda: five_point.essential_ransac_5pt(
                  x1, x2, g, num_hypotheses=n_hyp, th_sampson=1e-5),
              reps=5)}
    print(f"  5-point pieces on the card (ms): {ms}", flush=True)
    return ms


def throughput_phase(n_pairs=96, n_kp=4096, iters=6):
    """The matching-throughput path (`ops.matching.matching_throughput`,
    the counterpart of the JAX bench's bench_matching): pairs/s of kernels
    2b and 2a on the same descriptors, with both launch counts reset just
    before and read just after."""
    import torch
    from metricsfm_tpu_torch.ops import matching

    torch.cuda.synchronize()
    matching.knn2_int8.launches = 0
    matching.quantize_pair_int8.launches = 0
    matching.knn2_gather.launches = 0
    rates = matching.matching_throughput(n_pairs, n_kp, iters, device="cuda")
    launches = {"knn2_int8": matching.knn2_int8.launches,
                "quantize_pair_int8": matching.quantize_pair_int8.launches,
                "knn2": matching.knn2_gather.launches}
    print(f"  {n_pairs} pairs x {n_kp}^2 x 128, {iters} chained calls: int8 "
          f"(2b) {rates['int8']:.1f} pairs/s, bf16 (2a) {rates['bf16']:.1f} "
          f"pairs/s, launches {launches}", flush=True)
    return launches, rates


def aerial_setup(rows=10, cols=20, width=640, height=480, max_kp=2048,
                 device="cuda", matching="priori"):
    """The JAX bench's bench_e2e_aerial configuration (bench.py:321-390):
    a lawnmower survey of rows x cols views rendered on the card, and the
    UAV preset without resizing, `max_kp` keypoints, GPS-priori candidates
    (or `matching="feature"`: vocabulary-tree candidates, BASELINE.json
    config 3's strategy).  Returns (scene, config, render seconds)."""
    import dataclasses

    from metricsfm_tpu_torch.config import PRESETS
    from metricsfm_tpu_torch.utils import synth

    t0 = time.perf_counter()
    gt = synth.render_aerial(seed=0, rows=rows, cols=cols, width=width,
                             height=height, device=device)
    render_s = time.perf_counter() - t0
    cfg = PRESETS["uav"]()
    cfg = dataclasses.replace(
        cfg,
        database=dataclasses.replace(cfg.database, resize=False,
                                     max_keypoints=max_kp),
        graph=dataclasses.replace(cfg.graph, matching_type=matching))
    return gt, cfg, render_s


def aerial_run(gt, cfg, device="cuda"):
    """One run of the aerial path on the views written as PNGs into a fresh
    folder: Database -> build_match_graph (priori candidates from the
    ground-truth centres, or with "feature" candidates the word stage first,
    `sfm/build_words`, which build_match_graph then resumes) ->
    IncrementalSfM.run, each stage a span of the global tracer.  Returns
    (scenes, the IncrementalSfM, verified pairs, seconds, candidates), where
    candidates = (vocabulary words or 0, candidate pairs, pairs after the
    word-seed gate), counted after the timed run from its stores."""
    import torch
    from metricsfm_tpu_torch.io import store as fstore
    from metricsfm_tpu_torch.models.database import Database
    from metricsfm_tpu_torch.models.incremental import IncrementalSfM
    from metricsfm_tpu_torch.models.match_graph import (build_match_graph,
                                                        candidates_feature,
                                                        candidates_gps)
    from metricsfm_tpu_torch.utils import synth
    from metricsfm_tpu_torch.utils.tracing import span

    dev = torch.device(device)
    fold = tempfile.mkdtemp(prefix="msf_smoke_aerial_")
    try:
        synth.write_scene_images(fold, gt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with span("sfm/feature_extraction", sync=True):
            db = Database(fold, cfg.database, device=dev)
            db.feature_extraction()
        feature = cfg.graph.matching_type == "feature"
        if feature:
            with span("sfm/build_words", sync=True):
                db.build_words()
        with span("sfm/match_graph", sync=True):
            matches = build_match_graph(db, cfg,
                                        priori_utm=gt["centers"][:, :2])
        feats = {i: db.features(i) for i in range(db.n_images)}
        with span("sfm/reconstruct", sync=True):
            sfm = IncrementalSfM(feats, matches, cfg, device=dev)
            scenes = sfm.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if feature:
            cands, kept = candidates_feature(db, cfg.graph, dev)
            cand = (fstore.read_vocabulary(db.out, dev).n_words,
                    len(cands), len(kept))
        else:
            n = len(candidates_gps(gt["centers"][:, :2], cfg.graph.knn))
            cand = (0, n, n)
        return scenes, sfm, len(matches), dt, cand
    finally:
        shutil.rmtree(fold, ignore_errors=True)


def aerial_phase(rows=10, cols=20, hierarchical=False, matching="priori"):
    """Run the aerial path once on a rows x cols survey with `matching`
    candidates ("priori" or "feature"), with the kernel-2a launch count
    reset just before and read just after.  Gates (bench.py:389): >= 95 %
    of the views registered in one model, ATE < 0.05, and the PCG camera
    solve ran; with `hierarchical`, also at least one periodic full BA
    through hierarchical submap BA; with "feature", a vocabulary.  Returns
    (launches, stats)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ops import matching as ops_matching
    from metricsfm_tpu_torch.ops import np_geom
    from metricsfm_tpu_torch.utils import synth
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER

    gt, cfg, render_s = aerial_setup(rows=rows, cols=cols, matching=matching)
    n_cams = len(gt["images"])
    GLOBAL_TRACER.reset()
    torch.cuda.reset_peak_memory_stats()
    ops_matching.knn2_gather.launches = 0
    scenes, sfm, n_verified, dt, (n_words, n_cand, n_kept) = \
        aerial_run(gt, cfg)
    launches = {"knn2": ops_matching.knn2_gather.launches}
    peak = torch.cuda.max_memory_allocated()
    if not scenes:
        raise AssertionError("aerial: no model reconstructed")
    best = max(scenes, key=lambda s: len(s.registered))
    reg = sorted(best.registered)
    est = np.stack([np_geom.camera_center(best.poses[i]) for i in reg])
    ate = float(synth.ate_vs_gt(est, gt["centers"][reg]))
    stages = GLOBAL_TRACER.report()
    h, w = gt["images"].shape[1:]
    words = (f"{n_words} words, {n_kept} after the word-seed gate, "
             if matching == "feature" else "")
    print(f"  aerial {n_cams} views at {w}x{h}, "
          f"{cfg.database.max_keypoints} keypoints, {matching} candidates: "
          f"rendered in {render_s:.3f} s; {n_cand} candidate pairs, {words}"
          f"{n_verified} verified; {len(reg)}/{n_cams} registered in the "
          f"largest of "
          f"{len(scenes)} models, {best.n_points()} points, ATE {ate:.5f}; "
          f"{dt:.3f} s = {n_cams / dt:.4f} images/s; peak "
          f"{peak / 2**20:.1f} MiB; launches {launches}; solver counts "
          f"{sfm.stats}", flush=True)
    print("  stage table:\n" + "\n".join("    " + ln
                                         for ln in stages.splitlines()),
          flush=True)
    if len(reg) < 0.95 * n_cams:
        raise AssertionError(f"aerial: registered {len(reg)}/{n_cams} < 95 %")
    if ate >= 0.05:
        raise AssertionError(f"aerial: ATE {ate} >= 0.05")
    if sfm.stats["cg_solves"] < 1:
        raise AssertionError("aerial: the PCG camera solve never ran")
    if hierarchical and sfm.stats["full_ba_hier"] < 1:
        raise AssertionError("aerial: no hierarchical submap BA ran")
    if matching == "feature" and n_words < 1:
        raise AssertionError("aerial: no vocabulary was trained")
    return launches, {"images_per_s": n_cams / dt, "seconds": dt,
                      "registered": len(reg), "n_images": n_cams,
                      "ate": ate, "candidate_pairs": n_cand,
                      "pairs_after_word_gate": n_kept, "words": n_words,
                      "verified_pairs": n_verified, "peak_bytes": peak,
                      "render_seconds": render_s,
                      "solver_counts": dict(sfm.stats),
                      "stages": GLOBAL_TRACER.as_dict()}


def profile_aerial():
    """One more aerial run under torch.profiler, recording device activity
    only (the run launches millions of ops: no host-op records and no trace
    file): device busy share over the run's wall time, kernel 2a's device
    time and share, and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gt, cfg, _ = aerial_setup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, wall, _ = aerial_run(gt, cfg)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    dev_s = sum(t for t, _ in by_name.values()) / 1e6
    n_ops = sum(n for _, n in by_name.values())
    print(f"  profiled aerial: wall {wall:.4f} s, device busy {dev_s:.4f} s "
          f"({100 * dev_s / wall:.1f}%), idle {100 * (1 - dev_s / wall):.1f}% "
          f"(profiler on), {n_ops} device ops", flush=True)
    knn2 = [v for k, v in by_name.items() if "knn2_kernel" in k]
    knn2_us, knn2_n = sum(t for t, _ in knn2), sum(n for _, n in knn2)
    print(f"  kernel 2a (knn2_kernel): {knn2_n} launches, "
          f"{knn2_us / 1e3:.3f} ms of device time = "
          f"{100 * knn2_us / 1e6 / wall:.4f} % of the wall, "
          f"{100 * knn2_us / 1e6 / dev_s:.4f} % of the device time",
          flush=True)
    for name, (t, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:15]:
        print(f"    {t / 1e3:9.3f} ms  x{n:<7} {name[:90]}", flush=True)


def kernel_label(name):
    """A device kernel's name and template arguments, without its return
    type, namespace and parameters."""
    import re
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
    return m.group(1) if m else name


SGM_DEVICE_NAMES = ("census_cost_kernel", "chain_kernel", "wta_tile_kernel",
                    "wta_stream_kernel")


def profile_phase(out_dir, n_cams=8, width=1024, height=768, max_kp=4096):
    """Two more runs of each end-to-end path under torch.profiler, the
    second counted: device busy share (sum of device-op time over wall
    time; one stream, so kernels do not overlap), the top kernels by device
    time, and a Chrome trace per path in out_dir/<path>."""
    import torch
    from torch.autograd import DeviceType
    from metricsfm_tpu_torch import cli
    from metricsfm_tpu_torch.ops import sgm
    from metricsfm_tpu_torch.utils import synth
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER, device_trace

    def prepare_sfm(fold):
        synth.write_scene_images(fold, synth.render_scene(
            seed=0, n_cams=n_cams, width=width, height=height,
            focal=1.1 * width))
        argv = ["sfm", fold, "--mode", "web", "--matching", "all",
                "--no-resize", "--max-kp", str(max_kp), "--device", "cuda"]
        return lambda: cli.main(argv)

    def prepare_dense(method):
        def prepare(fold):
            left, right, _ = dense_scene()
            write_dense_fold(fold, left, right, 1.1 * left.shape[1], 0.5)
            argv = ["dense", fold, "--disp", "128", "--method", method,
                    "--device", "cuda"]
            return lambda: cli.main(argv)
        return prepare

    def prepare_volume(fold):
        left, right, _ = dense_scene()
        L, R = quantized_pair(left, right, torch.device("cuda"))
        return lambda: sgm.stereo_sgm_volume(L, R, max_disp=128)

    for label, prepare in (("sfm", prepare_sfm),
                           ("dense", prepare_dense("sgm")),
                           ("dense_volume", prepare_volume),
                           ("dense_elas", prepare_dense("elas"))):
        folds = [tempfile.mkdtemp(prefix=f"msf_smoke_prof_{label}_")
                 for _ in range(2)]
        try:
            warm, timed = (prepare(f) for f in folds)
            GLOBAL_TRACER.reset()
            torch.cuda.synchronize()
            with device_trace(os.path.join(out_dir, label)) as prof:
                # the tracer records device work only some time after it
                # starts: an untimed run first, then the counted one
                warm()
                torch.cuda.synchronize()
                with torch.profiler.record_function("timed_run"):
                    t0 = time.perf_counter()
                    timed()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
        finally:
            for f in folds:
                shutil.rmtree(f, ignore_errors=True)
        events = prof.events()
        span = next(e for e in events if e.name == "timed_run").time_range
        by_name = {}
        for e in events:
            # the range itself also shows on the device timeline
            if e.device_type == DeviceType.CUDA and e.name != "timed_run" \
                    and span.start <= e.time_range.start <= span.end:
                tot, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
        dev_s = sum(t for t, _ in by_name.values()) / 1e6
        n_ops = sum(n for _, n in by_name.values())
        print(f"  profiled {label}: wall {wall:.4f} s, device busy "
              f"{dev_s:.4f} s ({100 * dev_s / wall:.1f}%), idle "
              f"{100 * (1 - dev_s / wall):.1f}% (profiler on), "
              f"{n_ops} device ops", flush=True)
        for name, (t, n) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
            print(f"    {t / 1e3:9.3f} ms  x{n:<6} {name[:90]}", flush=True)
        if label.startswith("dense") and label != "dense_elas":
            # the SGM kernels launch by launch, in stream order (a
            # chain_kernel instantiation serves several stages)
            sgm_events = sorted(
                (e for e in events if e.device_type == DeviceType.CUDA
                 and span.start <= e.time_range.start <= span.end
                 and any(k in e.name for k in SGM_DEVICE_NAMES)),
                key=lambda e: e.time_range.start)
            print("    SGM launches in order: " + "; ".join(
                f"{kernel_label(e.name)} "
                f"{e.time_range.elapsed_us() / 1e3:.3f} ms"
                for e in sgm_events), flush=True)


# -- the street path (phase 11) ----------------------------------------------
# A synthetic street sequence in the reference's SLAM-GPS formats: keyframes
# of a 1280x720 GoPro frame (focal 800 px) written at resize_ratio 0.5, in a
# SLAM frame that is a similarity of the ground truth (scale 0.3), with GPS
# from the true centres (0.1 m noise across the road plane).
STREET_W, STREET_H, STREET_F, STREET_RESIZE = 1280, 720, 800.0, 0.5
STREET_LATLON = (40.0, -83.0)


def street_track(n, step=2.0, turn=0.35, period=600.0, wiggle=0.0,
                 wiggle_period=60.0):
    """Keyframe centres (n, 3) and headings (n,) of a camera 1.5 m up
    driving at `step` m a keyframe: heading turn * sin(2 pi s / period)
    (gentle turns, so the alignment's turn weights are not flat), or with
    turn = 0 a straight road with a lateral wiggle."""
    import numpy as np

    s = np.arange(n) * step
    if turn:
        psi = turn * np.sin(2 * np.pi * s / period)
        xy = np.zeros((n, 2))
        xy[1:] = np.cumsum(step * np.stack([np.cos(psi[:-1]),
                                            np.sin(psi[:-1])], 1), 0)
    else:
        y = wiggle * np.sin(2 * np.pi * s / wiggle_period)
        dy = wiggle * 2 * np.pi / wiggle_period * np.cos(
            2 * np.pi * s / wiggle_period)
        xy = np.stack([s, y], 1)
        psi = np.arctan(dy)
    z = 1.5 + 0.05 * np.sin(s / 37.0)
    return np.concatenate([xy, z[:, None]], 1), psi


def street_rotations(psi):
    """World->camera rotations looking along the heading: rows right,
    down, forward (x east, y north, z up)."""
    import numpy as np

    c, s = np.cos(psi), np.sin(psi)
    zero = np.zeros_like(psi)
    right = np.stack([s, -c, zero], 1)
    down = np.stack([zero, zero, zero - 1.0], 1)
    fwd = np.stack([c, s, zero], 1)
    return np.stack([right, down, fwd], 1)


def street_facade_points(centers, psi, n_pts, rng, step=2.0):
    """Points on both facades of the road of `street_track`: 6-10 m either
    side of the centre line, 0-10 m up, spread along its length.  Returns
    the points and their distance along the road."""
    import numpy as np

    L = (len(centers) - 1) * step
    s = rng.uniform(0, L + 30.0, n_pts)
    k = np.clip(s / step, 0, len(centers) - 1)
    k0 = np.minimum(k.astype(int), len(centers) - 2)
    fr = (k - k0)[:, None]
    base = centers[k0] * (1 - fr) + centers[k0 + 1] * fr
    extra = np.maximum(s - L, 0.0)[:, None]
    head = psi[k0] * (1 - fr[:, 0]) + psi[k0 + 1] * fr[:, 0]
    d = np.stack([np.cos(head), np.sin(head), 0 * head], 1)
    nrm = np.stack([-np.sin(head), np.cos(head), 0 * head], 1)
    side = rng.choice([-1.0, 1.0], n_pts)[:, None]
    pts = base + extra * d + side * rng.uniform(6.0, 10.0, (n_pts, 1)) * nrm
    pts[:, 2] = rng.uniform(0.0, 10.0, n_pts)
    return pts, s


def write_street_fold(fold, centers, Rs, pts, rng, window=None,
                      width=STREET_W, height=STREET_H, focal=STREET_F):
    """Write KeyFramePts.txt / pos.txt / rgb.txt for true poses (Rs,
    centers) and points pts, as the reference's SLAM front end leaves them:
    keyframes and points in a SLAM frame that is a similarity of the truth,
    observations in 640x360 pixels (the width x height = 1280x720 frame
    at resize 0.5) with 0.3 full-resolution pixels of noise, the points a
    keyframe sees in front of it up to 40 m; GPS with 0.1 m of noise
    across the road plane.  `window` (keyframe index -> indices of
    points sorted along the road) bounds each keyframe's visibility test.
    Returns the true UTM easting / northing of every keyframe."""
    import numpy as np
    from metricsfm_tpu_torch.ops import np_geom
    from metricsfm_tpu_torch.utils import utm

    os.makedirs(fold, exist_ok=True)
    zfar, noise_px, gps_noise = 40.0, 0.3, 0.1
    n = len(centers)
    r = STREET_RESIZE
    cx, cy = width / 2.0, height / 2.0
    s_slam = 0.3
    R_slam = np_geom.angle_axis_to_matrix(np.array([0.05, 0.3, -0.1]))
    t_slam = np.array([2.0, -1.0, 0.5])
    cam_rows = [str(n)]
    obs_p, obs_c, obs_x, obs_y = [], [], [], []
    for i in range(n):
        R = Rs[i]
        t = -R @ centers[i]
        sel = np.arange(len(pts)) if window is None else window(i)
        xc = pts[sel] @ R.T + t
        z = xc[:, 2]
        ok = (z > 0.5) & (z < zfar)
        u = focal * xc[:, 0] / np.where(ok, z, 1.0)
        v = focal * xc[:, 1] / np.where(ok, z, 1.0)
        ok &= (np.abs(u) < cx) & (np.abs(v) < cy)
        k = np.nonzero(ok)[0]
        obs_p.append(sel[k])
        obs_c.append(np.full(len(k), i))
        obs_x.append((u[k] + rng.normal(0, noise_px, len(k))) * r + cx * r)
        obs_y.append((v[k] + rng.normal(0, noise_px, len(k))) * r + cy * r)
        R_s = R @ R_slam.T
        t_s = -R_s @ (s_slam * R_slam @ centers[i] + t_slam)
        fx = focal * r
        cam_rows.append(" ".join(
            [str(i), f"{i * 0.1:.3f}", f"{fx}", f"{fx}", f"{cx * r}",
             f"{cy * r}"] + [f"{v_:.9f}" for v_ in t_s]
            + [f"{v_:.9f}" for v_ in R_s.reshape(-1)]))
    p = np.concatenate(obs_p)
    order = np.argsort(p, kind="stable")
    p, c = p[order], np.concatenate(obs_c)[order]
    x, y = np.concatenate(obs_x)[order], np.concatenate(obs_y)[order]
    slam_pts = s_slam * pts @ R_slam.T + t_slam
    starts = np.searchsorted(p, np.arange(len(pts) + 1))
    lines = [str(len(pts))]
    for k in range(len(pts)):
        a, b = starts[k], starts[k + 1]
        q = slam_pts[k]
        lines.append(f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {b - a} " + " ".join(
            f"{c[j]} {x[j]:.4f} {y[j]:.4f}" for j in range(a, b)))
    with open(os.path.join(fold, "KeyFramePts.txt"), "w") as f:
        f.write("\n".join(cam_rows + lines))
    e0, n0, zone = utm.ll_to_utm(*STREET_LATLON)
    gps = centers[:, :2] + rng.normal(0, gps_noise, (n, 2))
    with open(os.path.join(fold, "pos.txt"), "w") as f:
        for i in range(n):
            lat, lon = utm.utm_to_ll(e0 + gps[i, 0], n0 + gps[i, 1], zone)
            f.write(f"{i} {lat:.10f} {lon:.10f} {centers[i, 2]:.3f}\n")
    with open(os.path.join(fold, "rgb.txt"), "w") as f:
        f.write("# color images\n# keyframes\n# timestamp filename\n")
        for i in range(n):
            f.write(f"{i * 0.1:.2f} image/{i:06d}.png\n")
    return centers[:, :2] + np.array([e0, n0])


def street_planes(length, seed=0):
    """The street canyon of the re-match sequence: two 12 m facades at
    y = +-7 m and the road, each a textured rectangle (P0, U, V) whose
    texture is 480-texel `multiscale_texture` tiles laid along the road
    at 3 cm a texel."""
    import numpy as np
    from metricsfm_tpu_torch.utils import synth

    half_width, height, texel, tile = 7.0, 12.0, 0.03, 480
    rng = np.random.default_rng(seed)
    x0, x1 = -15.0, length + 60.0
    n_tiles = int(np.ceil((x1 - x0) / (tile * texel)))

    def tex(rows):
        t = np.concatenate([synth.multiscale_texture(rng, tile)
                            for _ in range(n_tiles)], 1)
        return t[:rows]

    span = np.array([x1 - x0, 0.0, 0.0])
    w_rows = int(round(2 * half_width / texel))
    h_rows = int(round(height / texel))
    if w_rows > tile:
        raise ValueError("road wider than one texture tile")
    return [
        dict(P0=np.array([x0, half_width, 0.0]), U=span,
             V=np.array([0.0, 0.0, height]), tex=tex(h_rows)),
        dict(P0=np.array([x0, -half_width, 0.0]), U=span,
             V=np.array([0.0, 0.0, height]), tex=tex(h_rows)),
        dict(P0=np.array([x0, -half_width, 0.0]), U=span,
             V=np.array([0.0, 2 * half_width, 0.0]), tex=tex(w_rows)),
    ]


def render_street(centers, Rs, planes, device="cuda", width=STREET_W,
                  height=STREET_H, focal=STREET_F):
    """Render the keyframes (pinhole, pixel centres at +0.5, principal
    point at the image centre) of a scene of textured rectangles by ray
    casting on `device`: per pixel the nearest plane hit in front of the
    camera, its texture sampled bilinearly; a flat sky of 0.6 elsewhere.
    Returns (n, H, W) uint8."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    dev = torch.device(device)
    xs = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5
          - width / 2.0) / focal
    ys = (torch.arange(height, device=dev, dtype=torch.float32) + 0.5
          - height / 2.0) / focal
    rays = torch.stack([xs[None, :].expand(height, width),
                        ys[:, None].expand(height, width),
                        torch.ones(height, width, device=dev)], -1)
    texs = [torch.tensor(p["tex"], dtype=torch.float32,
                         device=dev)[None, None] for p in planes]
    out = np.zeros((len(centers), height, width), np.uint8)
    for i in range(len(centers)):
        R = torch.tensor(Rs[i], dtype=torch.float32, device=dev)
        C = torch.tensor(centers[i], dtype=torch.float32, device=dev)
        d = rays @ R                                  # world directions
        best = torch.full((height, width), float("inf"), device=dev)
        img = torch.full((height, width), 0.6, device=dev)
        for p, tx in zip(planes, texs):
            P0, U, V = (torch.tensor(p[k], dtype=torch.float32, device=dev)
                        for k in ("P0", "U", "V"))
            nrm = torch.linalg.cross(U, V)
            den = d @ nrm
            t = torch.dot(nrm, P0 - C) / torch.where(
                den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
            X = C + t[..., None] * d - P0
            a = X @ U / torch.dot(U, U)
            b = X @ V / torch.dot(V, V)
            hit = (t > 0.1) & (t < best) & (a >= 0) & (a <= 1) & \
                (b >= 0) & (b <= 1)
            grid = torch.stack([2 * a - 1, 2 * b - 1], -1)[None]
            val = F.grid_sample(tx, grid.clamp(-1, 1), mode="bilinear",
                                align_corners=True)[0, 0]
            img = torch.where(hit, val, img)
            best = torch.where(hit, t, best)
        out[i] = (img.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
    return out


def street_fixed_fold(fold, n=1000, n_pts=50000, seed=0):
    """The 11a sequence: n keyframes 2 m apart on a gently turning road,
    n_pts points on its facades, no images.  Returns the true UTM
    easting / northing of the keyframes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers, psi = street_track(n)
    pts, along = street_facade_points(centers, psi, n_pts, rng)
    order = np.argsort(along)
    pts, along = pts[order], along[order]

    def window(i):       # keyframe i sees at most 40 m ahead
        lo, hi = np.searchsorted(along, [2.0 * i - 10.0, 2.0 * i + 50.0])
        return np.arange(lo, hi)

    return write_street_fold(fold, centers, street_rotations(psi), pts, rng,
                             window=window)


def street_rematch_fold(fold, n=100, n_pts=6000, seed=1, device="cuda",
                        width=STREET_W, height=STREET_H):
    """The 11b sequence: n keyframes 2 m apart along a straight street
    canyon (a lateral wiggle of 1 m), rendered at width x height on
    `device` and written as image/000000.png..., with n_pts SLAM points on
    its facades and road.  Returns (true UTM easting / northing, render
    seconds)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    centers, psi = street_track(n, turn=0.0, wiggle=1.0)
    Rs = street_rotations(psi)
    planes = street_planes((n - 1) * 2.0)
    # SLAM points on the two facades and the road, in proportion to area
    k = rng.choice(3, n_pts, p=[0.37, 0.37, 0.26])
    a, b = rng.uniform(0, 1, n_pts), rng.uniform(0, 1, n_pts)
    pts = np.stack([planes[j]["P0"] + a[m] * planes[j]["U"]
                    + b[m] * planes[j]["V"] for m, j in enumerate(k)])
    t0 = time.perf_counter()
    focal = STREET_F * width / STREET_W
    images = render_street(centers, Rs, planes, device=device, width=width,
                           height=height, focal=focal)
    render_s = time.perf_counter() - t0
    os.makedirs(os.path.join(fold, "image"), exist_ok=True)
    for i, im in enumerate(images):
        Image.fromarray(im).save(os.path.join(fold, "image", f"{i:06d}.png"),
                                 compress_level=1)
    gt = write_street_fold(fold, centers, Rs, pts, rng, width=width,
                           height=height, focal=focal)
    return gt, render_s


def street_gates(fold, gt, n):
    """Read back `cli slam`'s exports: every keyframe kept, pose.qin with n
    rows, and the median easting / northing error of the exported camera
    centres (gps_pos.txt, UTM) against the truth.  Returns that error."""
    import numpy as np

    out = os.path.join(fold, "mtpu_out")
    with open(os.path.join(out, "pose.qin")) as f:
        rows = f.read().split("\n")
    if int(rows[0]) != n or len(rows) - 2 != n:
        raise AssertionError(f"pose.qin: {rows[0]} / {len(rows) - 2} rows, "
                             f"want {n}")
    est = np.loadtxt(os.path.join(out, "gps_pos.txt"))[:, :2]
    if len(est) != n:
        raise AssertionError(f"{len(est)}/{n} keyframes kept")
    err = float(np.median(np.linalg.norm(est - gt, axis=1)))
    if not err < 1.0:
        raise AssertionError(f"median UTM error {err} m >= 1.0")
    if not os.path.exists(os.path.join(fold, "accuracy.txt")):
        raise AssertionError("no accuracy.txt")
    return err


def street_fixed_phase(n=1000, n_pts=50000, device="cuda"):
    """11a: `cli slam` with the street preset (no re-match, the reference's
    default) on a street sequence of n keyframes written in the reference
    formats.  Gates: every keyframe kept, median UTM error < 1.0 m, a
    pose.qin of n rows, and from 128 keyframes the GPS BA's PCG solve.
    Returns stats."""
    import torch
    from metricsfm_tpu_torch import cli
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER

    fold = tempfile.mkdtemp(prefix="msf_smoke_street_")
    try:
        t0 = time.perf_counter()
        gt = street_fixed_fold(fold, n, n_pts)
        write_s = time.perf_counter() - t0
        GLOBAL_TRACER.reset()
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene = cli.main(["slam", fold, "--device", device])
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        err = street_gates(fold, gt, n)
    finally:
        shutil.rmtree(fold, ignore_errors=True)
    stages = GLOBAL_TRACER.as_dict()
    pcg = "slam/ba_solve/pcg" in stages
    print(f"  street {n} keyframes, {n_pts} facade points (written in "
          f"{write_s:.3f} s): {len(scene.registered)}/{n} kept, "
          f"{scene.n_points()} points, median UTM error {err:.4f} m; "
          f"{dt:.3f} s = {n / dt:.4f} keyframes/s; peak "
          f"{peak / 2**20:.1f} MiB; GPS BA {'PCG' if pcg else 'dense'}",
          flush=True)
    print("  stage table:\n" + "\n".join(
        "    " + ln for ln in GLOBAL_TRACER.report().splitlines()),
        flush=True)
    if len(scene.registered) != n:
        raise AssertionError(f"street: {len(scene.registered)}/{n} kept")
    if n >= 128 and not pcg:
        raise AssertionError("street: the GPS BA did not run the PCG solve")
    return {"keyframes_per_s": n / dt, "seconds": dt, "keyframes": n,
            "points": scene.n_points(), "median_utm_err_m": err,
            "peak_bytes": peak, "gps_ba": "pcg" if pcg else "dense",
            "stages": stages}


def street_rematch_phase(n=100, n_pts=6000, min_tracks=1000,
                         device="cuda", width=STREET_W, height=STREET_H):
    """11b: the re-match path, `SLAMGPS(street_preset()).run(fold,
    rematch=True)` on n keyframes rendered at width x height: SIFT (up to
    8,192 keypoints, no resize), window priors, the re-match through 2a,
    retriangulation and the GPS BA, with the 2a count reset just before
    and read just after.  Gates: median UTM error < 1.0 m, at least
    min_tracks retriangulated tracks of >= 3 views, every keyframe's
    undistorted copy, pose.qin of n rows.  Then 2a is held against its
    plain version on a batch of the run's own keyframe descriptors (real,
    ragged N); those launches are not counted.  Returns (launches, stats,
    that check's distance error)."""
    import torch
    from metricsfm_tpu_torch.config import street_preset
    from metricsfm_tpu_torch.models import slam_gps
    from metricsfm_tpu_torch.ops import matching
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER, span

    fold = tempfile.mkdtemp(prefix="msf_smoke_street_rematch_")
    cuda = torch.device(device).type == "cuda"
    try:
        gt, render_s = street_rematch_fold(fold, n, n_pts, device=device,
                                           width=width, height=height)
        GLOBAL_TRACER.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        matching.knn2_gather.launches = 0
        t0 = time.perf_counter()
        pipe = slam_gps.SLAMGPS(street_preset(), device=device)
        with span("slam/run", sync=True):
            scene = pipe.run(fold, rematch=True)
        dt = time.perf_counter() - t0
        launches = {"knn2": matching.knn2_gather.launches}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        err = street_gates(fold, gt, n)
        und = os.listdir(os.path.join(fold, "mtpu_out", "undistort_images"))
        good = [t for t in scene.tracks if not t.is_bad]
        n3 = sum(len(t.obs) >= 3 for t in good)
        feats = pipe.feature_extraction(
            fold, slam_gps.read_slam(os.path.join(fold, "KeyFramePts.txt")))
        kp = [int(feats[i].mask.sum()) for i in range(n)]
        ragged_err = ragged_knn2_check(feats, device) if cuda else 0.0
    finally:
        shutil.rmtree(fold, ignore_errors=True)
    print(f"  street re-match {n} keyframes at {width}x{height} (rendered "
          f"in {render_s:.3f} s), keypoints {min(kp)}-{max(kp)}: "
          f"{pipe.stats['prior_pairs']} prior pairs, "
          f"{pipe.stats['verified_pairs']} verified, "
          f"{pipe.stats['retriangulated']} tracks retriangulated, {n3} "
          f"kept with >= 3 views; median UTM error {err:.4f} m; {dt:.3f} s "
          f"= {n / dt:.4f} keyframes/s; peak {peak / 2**20:.1f} MiB; "
          f"launches {launches}", flush=True)
    print("  stage table:\n" + "\n".join(
        "    " + ln for ln in GLOBAL_TRACER.report().splitlines()),
        flush=True)
    if n3 < min_tracks:
        raise AssertionError(f"street re-match: {n3} tracks of >= 3 views "
                             f"< {min_tracks}")
    if len(und) != n:
        raise AssertionError(f"street re-match: {len(und)}/{n} undistorted "
                             "images")
    return launches, {
        "keyframes_per_s": n / dt, "seconds": dt, "keyframes": n,
        "median_utm_err_m": err, "prior_pairs": pipe.stats["prior_pairs"],
        "verified_pairs": pipe.stats["verified_pairs"],
        "tracks_3_views": n3, "keypoints": [min(kp), max(kp)],
        "peak_bytes": peak, "render_seconds": render_s,
        "stages": GLOBAL_TRACER.as_dict()}, ragged_err


def ragged_knn2_check(feats, device, B=32):
    """2a against its plain version on the re-match's own store: the
    keyframes' descriptors padded to a multiple of 128 rows of the longest
    (each image masked to its own count), pairs (k, k + 1) with k + 1 the
    query side, as the re-match runs them."""
    import numpy as np

    n = len(feats)
    kmax = max(int(feats[i].mask.shape[0]) for i in range(n))
    N = -(-kmax // 128) * 128
    m = min(B + 1, n)
    store = np.zeros((m, N, 128), np.float32)
    mask = np.zeros((m, N), bool)
    for r in range(m):
        k = feats[r].mask.shape[0]
        store[r, :k] = feats[r].desc
        mask[r, :k] = feats[r].mask
    ii = np.arange(m - 1, dtype=np.int32)
    return compare_knn2(store, mask, ii + 1, ii, f"street keyframes "
                        f"B={m - 1} N={N} (ragged)")[0]


# -- the auxiliary ops (phase 12) --------------------------------------------

# 8 segments (x0, y0, x1, y1) of a 1024x768 test image: four horizontal in
# the top band, four vertical below it, no segment's end or body within
# reach of another one's infinite line (the support band of a Hough peak
# runs across the whole image, and an aligned pixel anywhere on it widens
# the segment)
AUX_SEGMENTS = ((80, 60, 330, 60), (620, 120, 950, 120), (100, 180, 300, 180),
                (640, 240, 900, 240), (400, 320, 400, 720),
                (470, 340, 470, 600), (540, 300, 540, 700),
                (610, 360, 610, 740))


def segment_image(W=1024, H=768, segs=AUX_SEGMENTS):
    """1-px segments of 0.9 drawn on a 0.2 background (host numpy)."""
    import numpy as np

    img = np.full((H, W), 0.2, np.float32)
    for x0, y0, x1, y1 in segs:
        s = np.linspace(0.0, 1.0, int(4 * np.hypot(x1 - x0, y1 - y0)) + 1)
        img[np.rint(y0 + s * (y1 - y0)).astype(int),
            np.rint(x0 + s * (x1 - x0)).astype(int)] = 0.9
    return img


def pnp_problems(n, n_pts, f, seed):
    """n random poses (world->camera) with n_pts world points in front of
    each and their exact centered projections at focal f."""
    import numpy as np
    from metricsfm_tpu_torch.ops import np_geom

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        R = np_geom.angle_axis_to_matrix(rng.standard_normal(3) * 0.3)
        t = np.array([0.3, -0.2, 0.5]) + rng.standard_normal(3) * 0.1
        Xw = rng.standard_normal((n_pts, 3)) * 2
        Xw[:, 2] += 8.0
        Xc = Xw @ R.T + t
        out.append((R, t, Xw, f * Xc[:, :2] / Xc[:, 2:]))
    return out


def rot_err_deg(Ra, Rb):
    import numpy as np

    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb).T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@contextlib.contextmanager
def aux_part(label, stats, dev):
    """Time one part of phase 12 (host clock around work that ends in a
    synchronize of the card) into stats[label]."""
    import torch

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    stats[label] = {"seconds": time.perf_counter() - t0}


def aux_phase(card, device="cuda", ba_cams=1024, ba_pts=131072):
    """12: the auxiliary ops at full size on the card, each part timed.

    (a) essential-guided matching of views 0 and 1 of render_scene(seed=0,
        n_cams=8) at 1024x768 (port SIFT, 4,096 keypoints, centered xy):
        2a once, then two E-RANSAC re-filters, with the 2a count reset just
        before and read just after; gates >= 100 inliers and >= 95 % of
        them under Sampson 1e-3 against the rendered poses' E; then the
        four geo-verification modes on those matches (mode 1 must pass);
    (b) detect_segments on a 1024x768 image of 8 segments (n_rho 2048,
        64 peaks): each segment recovered within 5 px by a peak with ok;
        local_orientation at 4,096 points (finite, unit or zero rows);
    (c) GIST of one rendered view, held to the same function on the CPU
        within 1e-4;
    (d) extract_panorama on a 4096x2048 equirectangular multiscale_texture
        image, 12 zones: every zone has keypoints, descriptors finite;
    (e) p4pf on 32 noise-free problems in f64 (f within 1 % in >= 95 %;
        the f32 share is printed: f32 P3P roots carry ~1e-3 of noise),
        dlt_oriented at N = 2,000 with unknown focal (f within 0.5 %),
        epnp_robust at N = 2,000 with 20 % gross outliers (rotation error
        below plain EPnP's: the method drops 10 % of the points, so 10 %
        outliers stay in its refit) and with 10 % (< 0.5 deg);
    (f) undistort_points_exact on 4,096 points (within 1e-4 of the truth);
    (g) pso_minimize on a 6-D quadratic (value < 1e-2);
    (h) synthetic_ba_problem at the BASELINE shape (1,024 cameras,
        131,072 points, 6 views) built on the card and solved with
        bench.py's production LMConfig (8 iterations, 50 CG, forcing):
        the final cost below the initial; LM iterations/s and the cost
        drop are printed beside the card.
    `device="cpu"` with a small BA shape rehearses the phase on the CPU.
    Returns (launches, stats)."""
    import numpy as np
    import torch
    from metricsfm_tpu_torch.ba.lm import LMConfig, solve_lm
    from metricsfm_tpu_torch.ops import (epipolar, essential_matching, gist,
                                         lie, lines, matching, panorama,
                                         pnp, sift)
    from metricsfm_tpu_torch.utils import (calibration, geo_verification,
                                           pso, synth)

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    stats = {}

    def part(label):
        return aux_part(label, stats, dev)

    # (a) essential-guided matching through 2a, then geo-verification
    gt = synth.render_scene(seed=0, n_cams=8, width=1024, height=768,
                            focal=1.1 * 1024)
    f = gt["focal"]
    with part("a_match_pair_essential"):
        feats = sift.extract(torch.tensor(gt["images"][:2], device=dev),
                             sift.SiftConfig(max_keypoints=4096))
        gen.manual_seed(0)
        matching.knn2_gather.launches = 0
        res = essential_matching.match_pair_essential(
            feats["desc"][0], feats["desc"][1], feats["xy"][0],
            feats["xy"][1], f, f, gen, mask1=feats["mask"][0],
            mask2=feats["mask"][1])
        inl = res["inlier_mask"]
        n_inl = int(inl.sum())
        launches = {"knn2": matching.knn2_gather.launches}
    Rs = [lie.angle_axis_to_matrix(torch.tensor(gt["poses"][i, :3]))
          for i in (0, 1)]
    ts = [torch.tensor(gt["poses"][i, 3:]) for i in (0, 1)]
    R01 = Rs[1] @ Rs[0].T
    tx = lie.hat(ts[1] - R01 @ ts[0])
    E_gt = (tx @ R01).to(device=dev, dtype=torch.float32)
    xy1 = feats["xy"][0][inl]
    xy2 = feats["xy"][1][res["idx2"].long()][inl]
    d_gt = epipolar.sampson_distance(E_gt, xy1 / f, xy2 / f)
    share = float((d_gt < 1e-3).float().mean())
    print(f"  12a match_pair_essential: {int(feats['mask'][0].sum())} / "
          f"{int(feats['mask'][1].sum())} keypoints, {n_inl} inliers, "
          f"{share:.4f} of them under Sampson 1e-3 against the rendered E "
          f"(median {float(d_gt.median()) * f * f:.4f} px^2), launches "
          f"{launches}, {stats['a_match_pair_essential']['seconds']:.3f} s",
          flush=True)
    if n_inl < 100 or share < 0.95:
        raise AssertionError(f"essential matching: {n_inl} inliers, "
                             f"{share:.4f} under the ground-truth E")
    p1, p2 = xy1.cpu().numpy(), xy2.cpu().numpy()
    with part("a_geo_verification"):
        gen.manual_seed(1)
        ok, m1, F = geo_verification.verify_fundamental(p1, p2, gen,
                                                        device=dev)
        m2 = geo_verification.refilter_with_fundamental(F, p1, p2,
                                                        device=dev)
        m3 = geo_verification.verify_local_flow(p1, p2)
        m4 = geo_verification.verify_patch_fundamental(p1, p2, gen,
                                                       device=dev)
    kept = {"fundamental": int(m1.sum()), "refilter": int(m2.sum()),
            "local_flow": int(m3.sum()), "patch_fundamental": int(m4.sum())}
    print(f"  12a geo-verification of {len(p1)} matches: mode 1 ok {ok}, "
          f"kept {kept}, {stats['a_geo_verification']['seconds']:.3f} s",
          flush=True)
    if not ok:
        raise AssertionError("geo-verification mode 1 rejected the pair")
    stats["a_match_pair_essential"].update(
        inliers=n_inl, gt_share=share, launches=launches["knn2"])
    stats["a_geo_verification"]["kept"] = kept

    # (b) segments and local orientation
    img = torch.tensor(segment_image(), device=dev)
    with part("b_lines"):
        seg = lines.detect_segments(img, max_segments=64, n_rho=2048)
        pts = torch.rand((4096, 2), generator=gen.manual_seed(2),
                         device=dev) * torch.tensor([1023.0, 767.0],
                                                    device=dev)
        ori = lines.local_orientation(img, pts)
    p0, q0 = seg["p0"].cpu().numpy(), seg["p1"].cpu().numpy()
    ok_seg = seg["ok"].cpu().numpy()
    errs = []
    for x0, y0, x1, y1 in AUX_SEGMENTS:
        a, b = np.array([x0, y0], float), np.array([x1, y1], float)
        e = np.minimum(
            np.maximum(np.linalg.norm(p0 - a, axis=1),
                       np.linalg.norm(q0 - b, axis=1)),
            np.maximum(np.linalg.norm(p0 - b, axis=1),
                       np.linalg.norm(q0 - a, axis=1)))
        errs.append(float(np.where(ok_seg, e, np.inf).min()))
    nrm = torch.linalg.norm(ori, dim=-1)
    unit = bool(torch.all(torch.isfinite(ori))
                and torch.all((torch.abs(nrm - 1) < 1e-4) | (nrm == 0)))
    print(f"  12b detect_segments: {int(ok_seg.sum())} of 64 peaks ok, "
          f"endpoint errors {[round(e, 3) for e in errs]} px; "
          f"local_orientation at 4,096 points, unit or zero rows {unit}; "
          f"{stats['b_lines']['seconds']:.3f} s", flush=True)
    if max(errs) > 5.0 or not unit:
        raise AssertionError(f"lines: endpoint errors {errs}, unit {unit}")
    stats["b_lines"]["endpoint_err_px"] = errs

    # (c) GIST on the card against the same function on the CPU
    view = torch.tensor(gt["images"][0])
    with part("c_gist"):
        g = gist.gist_descriptor(view.to(dev))
    g_err = float(torch.abs(g.cpu() - gist.gist_descriptor(view)).max())
    print(f"  12c gist_descriptor 768x1024: {g.numel()} values, max |card -"
          f" CPU| {g_err:.3e}, {stats['c_gist']['seconds']:.3f} s",
          flush=True)
    if not g_err <= 1e-4:
        raise AssertionError(f"gist: card vs CPU {g_err}")
    stats["c_gist"]["max_abs_err_vs_cpu"] = g_err

    # (d) panorama: 12 zones of a 4096x2048 equirectangular image
    rng = np.random.default_rng(3)
    pano = np.concatenate([synth.multiscale_texture(rng, 2048)
                           for _ in range(2)], axis=1)
    pano_t = torch.tensor(pano, device=dev)
    with part("d_panorama"):
        zones = panorama.extract_panorama(pano_t)
    n_kp = [int(z["mask"].sum()) for z in zones]
    finite = all(bool(torch.isfinite(z["desc"]).all()) for z in zones)
    print(f"  12d extract_panorama 4096x2048, {len(zones)} zones of "
          f"{tuple(zones[0]['mask'].shape)} slots: keypoints {n_kp}, "
          f"descriptors finite {finite}, "
          f"{stats['d_panorama']['seconds']:.3f} s", flush=True)
    if len(zones) != 12 or min(n_kp) < 1 or not finite:
        raise AssertionError(f"panorama: keypoints {n_kp}, finite {finite}")
    stats["d_panorama"]["keypoints"] = n_kp

    # (e) the minimal and robust PnP solvers
    def tens(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    probs = pnp_problems(32, 4, 1200.0, seed=4)
    X4 = np.stack([p[2] for p in probs])
    u4 = np.stack([p[3] for p in probs])
    f_rel = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        with part(f"e_p4pf_{name}"):       # the 32 problems in one batch
            f_est = pnp.p4pf(tens(X4, dtype), tens(u4, dtype),
                             1000.0)["f"].cpu().numpy()
        f_rel[name] = np.abs(f_est - 1200.0) / 1200.0
    hit = {k: float((v < 0.01).mean()) for k, v in f_rel.items()}
    (R, t, X, u), = pnp_problems(1, 2000, 1400.0, seed=5)
    with part("e_dlt_oriented"):
        f_dlt = float(pnp.dlt_oriented(tens(R), tens(X), tens(u))["f"])
    rob_err, plain_err = {}, {}
    for frac in (0.2, 0.1):
        (R, t, X, u), = pnp_problems(1, 2000, 1000.0, seed=6)
        bad = np.random.default_rng(7).uniform(size=2000) < frac
        u = u.copy()
        u[bad] += np.random.default_rng(8).uniform(100, 400, (bad.sum(), 2)) \
            * np.sign(np.random.default_rng(9).standard_normal((bad.sum(), 2)))
        with part(f"e_epnp_robust_{frac}"):
            rob = pnp.epnp_robust(tens(X), tens(u), 1000.0,
                                  generator=gen.manual_seed(5))
            rob_err[frac] = rot_err_deg(rob["R"].cpu().numpy(), R)
        R0, _ = pnp.epnp(tens(X), tens(u / 1000.0))
        plain_err[frac] = rot_err_deg(R0.cpu().numpy(), R)
    print(f"  12e p4pf on 32 problems: f within 1 % in {hit['f64']:.4f} (f64;"
          f" max {float(f_rel['f64'].max()):.5f}, "
          f"{stats['e_p4pf_f64']['seconds']:.3f} s), in {hit['f32']:.4f} "
          f"(f32; max {float(f_rel['f32'].max()):.5f}, "
          f"{stats['e_p4pf_f32']['seconds']:.3f} s); dlt_oriented N = 2,000"
          f" f {f_dlt:.3f} (true 1400), "
          f"{stats['e_dlt_oriented']['seconds']:.3f} s; epnp_robust N = "
          f"2,000: rotation error {rob_err[0.2]:.5f} deg at 20 % gross "
          f"outliers (plain EPnP {plain_err[0.2]:.5f}), {rob_err[0.1]:.5f} "
          f"at 10 % (plain {plain_err[0.1]:.5f}), "
          f"{stats['e_epnp_robust_0.2']['seconds']:.3f} s", flush=True)
    if (hit["f64"] < 0.95 or abs(f_dlt - 1400.0) > 0.005 * 1400.0
            or not rob_err[0.2] < plain_err[0.2] or rob_err[0.1] >= 0.5):
        raise AssertionError(f"pnp: p4pf {hit}, dlt f {f_dlt}, epnp_robust "
                             f"{rob_err} deg (plain {plain_err})")
    stats["e_p4pf_f64"]["f_within_1pct"] = hit["f64"]
    stats["e_p4pf_f32"]["f_within_1pct"] = hit["f32"]
    stats["e_dlt_oriented"]["f"] = f_dlt
    for frac in (0.2, 0.1):
        stats[f"e_epnp_robust_{frac}"].update(rot_err_deg=rob_err[frac],
                                              plain_rot_err_deg=plain_err[frac])

    # (f) exact undistortion
    k1, k2 = -0.2, 0.05
    xy_u = (torch.rand((4096, 2), generator=gen.manual_seed(6), device=dev)
            - 0.5) * 1.4
    r2 = torch.sum(xy_u * xy_u, dim=-1, keepdim=True)
    xy_d = xy_u * (1 + k1 * r2 + k2 * r2 * r2)
    with part("f_undistort"):
        back = calibration.undistort_points_exact(xy_d, k1, k2)
    u_err = float(torch.abs(back - xy_u).max())
    print(f"  12f undistort_points_exact on 4,096 points: max error "
          f"{u_err:.3e}, {stats['f_undistort']['seconds']:.3f} s",
          flush=True)
    if not u_err <= 1e-4:
        raise AssertionError(f"undistort_points_exact: error {u_err}")
    stats["f_undistort"]["max_abs_err"] = u_err

    # (g) particle swarm on a 6-D quadratic
    goal = torch.tensor([0.3, -1.0, 2.0, 0.0, 1.5, -0.7], device=dev)
    with part("g_pso"):
        _, val = pso.pso_minimize(
            lambda x: torch.sum((x - goal) ** 2, dim=-1),
            torch.full((6,), -4.0, device=dev),
            torch.full((6,), 4.0, device=dev), gen.manual_seed(7))
        val = float(val)
    print(f"  12g pso_minimize 6-D: value {val:.3e}, "
          f"{stats['g_pso']['seconds']:.3f} s", flush=True)
    if not val < 1e-2:
        raise AssertionError(f"pso: value {val}")
    stats["g_pso"]["value"] = val

    # (h) the synthetic BA problem at the BASELINE shape
    with part("h_build"):
        prob = synth.synthetic_ba_problem(n_cams=ba_cams, n_pts=ba_pts,
                                            device=dev)
    cfg = LMConfig(max_iterations=8, cg_iterations=50, cg_tol=1e-4,
                   cg_forcing=True, rtol=0.0)
    solve_lm(prob, cfg._replace(max_iterations=1))         # warm-up
    with part("h_solve"):
        _, info = solve_lm(prob, cfg)
    dt = stats["h_solve"]["seconds"]
    rate = info["iterations"] / dt
    print(f"  12h synthetic_ba_problem {prob.n_cameras} cameras, "
          f"{prob.n_points} points, {int(prob.n_observations())} "
          f"observations, built in {stats['h_build']['seconds']:.3f} s; "
          f"solve_lm {info['iterations']} iterations in {dt:.3f} s = "
          f"{rate:.4f} LM iterations/s, cost {info['initial_cost']:.6e} -> "
          f"{info['final_cost']:.6e} ({card})", flush=True)
    if not info["final_cost"] < info["initial_cost"]:
        raise AssertionError(f"BA: cost {info['initial_cost']} -> "
                             f"{info['final_cost']}")
    stats["h_solve"].update(
        iterations=info["iterations"], lm_iterations_per_s=rate,
        initial_cost=info["initial_cost"], final_cost=info["final_cost"])
    return launches, stats


def build_phase(names=("knn2", "knn2_int8", "sgm_census", "sgm_aggregate")):
    """Build every kernel source at once (one nvcc process each)."""
    from concurrent.futures import ThreadPoolExecutor
    from metricsfm_tpu_torch.ops import cuda_build

    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(cuda_build.load_library, n) for n in names]:
            f.result()
    for name in names:
        info = cuda_build.build_info[name]
        print(f"  {name}.cu built in {info['seconds']:.3f} s", flush=True)
        for ln in info["log"].splitlines():
            if any(k in ln for k in ("registers", "spill", "smem",
                                     "Function properties", "wgmma",
                                     "setmaxnreg", "arning")):
                print("    " + ln.strip(), flush=True)


FUSED_KERNELS = ("census_cost", "sgm_horizontal", "sgm_partial",
                 "sgm_total_wta")


def check_launches(launches, path):
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched on {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-e2e", action="store_true",
                    help="stop after the kernel phase")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile one run of each end-to-end path; "
                    "traces to DIR")
    args = ap.parse_args(argv)

    import torch
    with phase("1 device"):
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: this smoke run needs "
                             "one NVIDIA GPU")
        card = gpu_line()
        print(f"  card: {card}", flush=True)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
    with phase("2 build kernels"):
        build_phase()
    with phase("3 kernels vs plain"):
        rows = [knn2_phase(), knn2_int8_phase()] + sgm_phase()
    if args.skip_e2e:
        return 0
    with phase("4 main path: cli sfm"):
        launches, stats = main_path_phase()
        check_launches(launches, "the sfm path")
    with phase("4b calibrated path: cli sfm on EXIF-tagged JPEGs"):
        exif_launches, exif_stats = exif_path_phase()
        check_launches(exif_launches, "the calibrated sfm path")
    with phase("4c web path: default cli sfm on 24 views, BoW candidates"):
        web_launches, web_stats = web_path_phase()
        check_launches(web_launches, "the web sfm path")
    with phase("5 dense path: cli dense"):
        dense_launches, dense_stats = dense_phase()
        check_launches({k: n for k, n in dense_launches.items()
                        if k in FUSED_KERNELS}, "the dense path")
    with phase("6 dense volume path: stereo_sgm_volume"):
        volume_launches, volume_stats = volume_phase()
    with phase("7 dense ELAS path: cli dense --method elas"):
        _, elas_stats = dense_phase(method="elas")
    with phase("8 matching-throughput path: kernels 2b and 2a"):
        tput_launches, tput_rates = throughput_phase()
        check_launches(tput_launches, "the matching-throughput path")
    with phase("9 aerial path: 200 views, priori candidates, PCG"):
        aerial_launches, aerial_stats = aerial_phase()
        check_launches(aerial_launches, "the aerial path")
    with phase("9c aerial path: 500 views, hierarchical submap BA"):
        big_launches, big_stats = aerial_phase(rows=20, cols=25,
                                               hierarchical=True)
        check_launches(big_launches, "the 500-view aerial path")
    with phase("9d aerial path: 200 views, vocabulary-tree candidates"):
        bow_launches, bow_stats = aerial_phase(matching="feature")
        check_launches(bow_launches, "the BoW aerial path")
    with phase("11a street path: cli slam, 1,000 keyframes, GPS BA by PCG"):
        street_stats = street_fixed_phase()
    with phase("11b street re-match path: 100 rendered keyframes, 2a"):
        street_launches, rematch_stats, ragged_err = street_rematch_phase()
        check_launches(street_launches, "the street re-match path")
    with phase("12 auxiliary ops"):
        aux_launches, aux_stats = aux_phase(card)
        check_launches(aux_launches, "the auxiliary ops")
    # a kernel's launches: the sum of its counts over the paths' timed runs
    for path_launches in (exif_launches, web_launches, dense_launches,
                          volume_launches, tput_launches, aerial_launches,
                          big_launches, bow_launches, street_launches,
                          aux_launches):
        for k, n in path_launches.items():
            launches[k] = launches.get(k, 0) + n
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["name"] == "knn2_int8":   # its quantize pass, same row
            row["quantize_launches"] = launches["quantize_pair_int8"]
        if row["name"] == "knn2":        # the street keyframes' own store
            row["max_abs_err"] = max(row["max_abs_err"], ragged_err)
    check_launches({r["name"]: r["launches"] for r in rows}, "a path")
    if args.profile:
        with phase("9b profiled end-to-end paths"):
            profile_phase(args.profile)
            profile_aerial()
    with phase("10 report"):
        print(json.dumps({
            "e2e": {k: v for k, v in stats.items() if k != "stages"},
            "e2e_exif": {k: v for k, v in exif_stats.items()
                         if k != "stages"},
            "e2e_web": {k: v for k, v in web_stats.items()
                        if k != "stages"},
            "dense": {k: v for k, v in dense_stats.items() if k != "stages"},
            "dense_volume": volume_stats,
            "dense_elas": {k: v for k, v in elas_stats.items()
                           if k != "stages"},
            "matching_throughput_pairs_per_s": tput_rates,
            "aerial": {k: v for k, v in aerial_stats.items()
                       if k != "stages"},
            "aerial_500": {k: v for k, v in big_stats.items()
                           if k != "stages"},
            "aerial_bow": {k: v for k, v in bow_stats.items()
                           if k != "stages"},
            "street": {k: v for k, v in street_stats.items()
                       if k != "stages"},
            "street_rematch": {k: v for k, v in rematch_stats.items()
                               if k != "stages"},
            "aux": aux_stats}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
