// Fused exact 2-NN descriptor matcher for Hopper (sm_90a): wgmma + TMA.
//
// Replaces the TPU kernel metricsfm_tpu/ops/pallas/match_kernel.py:_kernel
// (reached through _knn2_pallas_impl).  For every query row of image ii[b]
// it finds the best and second-best similarity over the masked rows of
// image jj[b], with the semantics of metricsfm_tpu/ops/matching.knn2:
//   s = sum_k bf16(q_k) * bf16(db_k), accumulated in f32;
//   masked (and out-of-range) columns are never chosen;
//   best ties go to the LOWEST column; second-best excludes only the best
//   column (a duplicate of the best value elsewhere makes second == best);
//   d^2 = max(2 - 2 s, 0); with fewer than two valid columns d2 = +inf.
// No similarity quantization, no column packing, no N <= 8192 cap: those
// were workarounds for the TPU compiler.
//
// What bounds it: a 4096 x 4096 x 128 pair is ~4.3 GFLOP against ~2 MB of
// bf16 operands, so the kernel is bound by the tensor cores (32 pairs:
// 0.139 ms at 989 TFLOP/s); the N x N similarity matrix never reaches
// device memory.  What stands in the way is the fold: every similarity
// goes into a running top-2, 5 ALU instructions a value, and the SM's ALU
// pipe issues 64 lanes a clock (vs 1/16 of an SM clock of tensor work a
// value): the fold alone takes longer than the product alone.
//
// Design: one block = 128 query rows of one pair (grid.y walks the pairs)
// = two consumer warpgroups of 64 rows + a producer warpgroup, of which
// one warp issues the loads.
//   * The store is one (M n, 128) bf16 tensor map with 128-byte swizzle
//     (a 128-wide row is two 64-element swizzle atoms; boxes of 64 rows x
//     64).  The producer loads the block's query rows once, then walks the
//     database image in tiles of 128 rows through a ring of kStages
//     shared-memory stages behind full / empty mbarriers.  With each tile
//     it writes a per-column bias (0, or -inf for a masked column or one at
//     or past row n) and a flag saying whether the tile has any such
//     column.  The trap: the map spans the whole store, so a tile that runs
//     past row n of image jj[b] reads the NEXT image's rows (only the end
//     of the store zero-fills); the bias rules them out.
//   * Each consumer warpgroup issues wgmma.m64n128k16 (8 k-steps) for its
//     64 rows against the tile, with two accumulator sets: it commits
//     tile t+1's product, waits for tile t's, and folds tile t while the
//     tensor cores run.  The fold keeps a per-thread tile top-2 with
//       second = max(second, min(best, v)); idx = v > best ? c : idx;
//       best = max(best, v)
//     (5 instructions a value; each thread sees its columns in increasing
//     order, so lowest-column ties hold) and adds the bias only on flagged
//     tiles.  A tile's top-2 then merges into the row's running top-2;
//     the four lanes that share a row merge theirs with shuffles at the
//     end (each thread of the wgmma accumulator holds rows g and g + 8,
//     columns 2 q and 2 q + 1 of every 8-column block).
//   * Registers: a 384-thread block gets 168 a thread, too few for two
//     64-float accumulator sets and the top-2 state; setmaxnreg moves the
//     producer warpgroup to 56 and the consumers to 224.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kDim = 128;           // descriptor width
constexpr int kAtom = 64;           // bf16 columns per 128-byte swizzle atom
constexpr int kBox = 64;            // rows per TMA box
constexpr int kBM = 128;            // query rows per block
constexpr int kBN = 128;            // database rows per tile
constexpr int kStages = 5;          // database ring depth
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kBoxBytes = kBox * kAtom * 2;       // 8 KB
constexpr int kQBytes = 2 * kBM * kAtom * 2;      // 32 KB: [atom][128 rows]
constexpr int kTileBytes = 2 * kBN * kAtom * 2;   // 32 KB: [atom][128 rows]
constexpr int kSmemBytes = 1024 + kQBytes + kTileBytes * kStages +
                           kStages * (kBN * 4 + 4) + 16 +
                           (2 * kStages + 1) * 8;

struct Smem {
  uint8_t* q;        // query rows, atom-major
  uint8_t* db;       // kStages database tiles
  float* bias;       // kStages x kBN
  int* flag;         // kStages
  uint64_t* full;    // kStages
  uint64_t* empty;   // kStages
  uint64_t* qbar;
};

__device__ __forceinline__ Smem carve(uint8_t* raw) {
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Smem s;
  s.q = base;
  s.db = base + kQBytes;
  s.bias = reinterpret_cast<float*>(s.db + kStages * kTileBytes);
  s.flag = reinterpret_cast<int*>(s.bias + kStages * kBN);
  s.full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(s.flag + kStages) + 7) & ~uintptr_t(7));
  s.empty = s.full + kStages;
  s.qbar = s.empty + kStages;
  return s;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Top2 {
  float best, second;
  int idx;
};

// Fold a tile's partial top-2 (columns above every column seen so far).
__device__ __forceinline__ void fold_tile_top2(Top2& t, float tb, float ts,
                                               int col) {
  if (tb > t.best) {
    t.second = fmaxf(t.best, ts);
    t.best = tb;
    t.idx = col;
  } else {
    t.second = fmaxf(t.second, tb);
  }
}

// Merge a partial top-2 over a disjoint column set (symmetric in its two
// arguments, so xor-shuffle partners agree).
__device__ __forceinline__ void merge(Top2& t, float ob, float os, int oi) {
  if (ob > t.best || (ob == t.best && oi < t.idx)) {
    t.second = fmaxf(t.best, os);
    t.best = ob;
    t.idx = oi;
  } else {
    t.second = fmaxf(t.second, ob);
  }
}

__device__ __forceinline__ void merge_lanes(Top2& t) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, t.best, off);
    const float os = __shfl_xor_sync(0xffffffffu, t.second, off);
    const int oi = __shfl_xor_sync(0xffffffffu, t.idx, off);
    merge(t, ob, os, oi);
  }
}

// One accumulator set: a warpgroup's 64 rows x the tile's 128 columns.
struct Acc {
  float d[64];
};


// Descriptor offset (16-byte units) of k-step kk in an operand stored
// atom-major with `atom_bytes` per atom: 32 bytes a step inside an atom.
__device__ __forceinline__ uint64_t k_offset(int kk, int atom_bytes) {
  return (uint64_t)((kk >> 2) * (atom_bytes >> 4) + (kk & 3) * 2);
}

// acc = this warpgroup's 64 query rows . db_tile^T, one wgmma group.
__device__ __forceinline__ void issue_tile(Acc& acc, uint64_t da, uint64_t db) {
  hopper::acc_fence(acc.d);
  hopper::wgmma_fence();
  hopper::wgmma_bf16_m64n128k16<0>(acc.d, da, db);
#pragma unroll
  for (int kk = 1; kk < kDim / 16; ++kk)
    hopper::wgmma_bf16_m64n128k16<1>(acc.d, da + k_offset(kk, kBM * 128),
                                     db + k_offset(kk, kBN * 128));
  hopper::wgmma_commit();
}

// Fold one tile's similarities (rows g and g + 8 of this warp, columns
// 8 j + 2 q + e) into the running top-2 of the two rows.
template <bool kMasked>
__device__ __forceinline__ void fold_tile(const Acc& acc, const float* bias,
                                          int col0, Top2 (&r)[2]) {
  float b0 = neg_inf(), s0 = neg_inf(), b1 = neg_inf(), s1 = neg_inf();
  int i0 = 0, i1 = 0;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    float2 bj = make_float2(0.f, 0.f);
    if (kMasked) bj = *reinterpret_cast<const float2*>(bias + 8 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v0 = acc.d[4 * j + e];
      float v1 = acc.d[4 * j + 2 + e];
      if (kMasked) {
        const float be = e ? bj.y : bj.x;
        v0 += be;
        v1 += be;
      }
      s0 = fmaxf(s0, fminf(b0, v0));
      i0 = v0 > b0 ? 8 * j + e : i0;
      b0 = fmaxf(b0, v0);
      s1 = fmaxf(s1, fminf(b1, v1));
      i1 = v1 > b1 ? 8 * j + e : i1;
      b1 = fmaxf(b1, v1);
    }
  }
  fold_tile_top2(r[0], b0, s0, col0 + i0);
  fold_tile_top2(r[1], b1, s1, col0 + i1);
}

__device__ __forceinline__ void consume(const Smem& sm, const Acc& acc, int t,
                                        int q4, Top2 (&r)[2]) {
  const int s = t % kStages;
  const float* bias = sm.bias + s * kBN + 2 * q4;
  const int col0 = t * kBN + 2 * q4;
  if (sm.flag[s])
    fold_tile<true>(acc, bias, col0, r);
  else
    fold_tile<false>(acc, bias, col0, r);
  hopper::mbar_arrive(&sm.empty[s]);
}

__device__ __forceinline__ void wait_and_issue(const Smem& sm, Acc& acc,
                                               uint64_t da, int t) {
  const int s = t % kStages;
  hopper::mbar_wait(&sm.full[s], (t / kStages) & 1);
  issue_tile(acc, da, hopper::desc_sw128(sm.db + s * kTileBytes));
}

__device__ __forceinline__ float dist(float s) { return fmaxf(2.f - 2.f * s, 0.f); }

__global__ void __launch_bounds__(kThreads, 1)
knn2_kernel(const __grid_constant__ CUtensorMap store_map,
            const uint8_t* __restrict__ mask, const int* __restrict__ ii,
            const int* __restrict__ jj, int m, int n, float* __restrict__ d1,
            float* __restrict__ d2, int* __restrict__ idx_out) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw);
  const int pair = blockIdx.y;
  const int m0 = blockIdx.x * kBM;
  const int n_tiles = (n + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 32);
      hopper::mbar_init(&sm.empty[s], kConsumers);
    }
    hopper::mbar_init(sm.qbar, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // the role, warpgroup-uniform in a form the compiler can see
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (role == 2) {
    // ---- producer warpgroup: one warp issues, the registers go to the
    // consumers ----
    hopper::setmaxnreg_dec<56>();
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    // a pair index outside the store fails the launch (reported at the next
    // synchronize) instead of reading past it; a trap, not assert(): its
    // function call would make the compiler serialize the consumers' wgmma
    if ((unsigned)ii[pair] >= (unsigned)m || (unsigned)jj[pair] >= (unsigned)m)
      __trap();
    const int jrow = jj[pair] * n;
    const uint8_t* m = mask + (size_t)jj[pair] * n;
    if (lane == 0) {
      hopper::prefetch_tensor_map(&store_map);
      const int qrow = ii[pair] * n + m0;
      hopper::mbar_arrive_expect_tx(sm.qbar, kQBytes);
      for (int a = 0; a < 2; ++a)
        for (int r = 0; r < kBM / kBox; ++r)
          hopper::tma_load_2d(sm.q + a * (kQBytes / 2) + r * kBoxBytes,
                              &store_map, sm.qbar, a * kAtom, qrow + r * kBox);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      hopper::mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
      const int n0 = t * kBN;
      if (lane == 0) {
        uint8_t* dst = sm.db + s * kTileBytes;
        hopper::mbar_expect_tx(&sm.full[s], kTileBytes);
        for (int a = 0; a < 2; ++a)
          for (int r = 0; r < kBN / kBox; ++r)
            hopper::tma_load_2d(dst + a * (kTileBytes / 2) + r * kBoxBytes,
                                &store_map, &sm.full[s], a * kAtom,
                                jrow + n0 + r * kBox);
      }
      bool masked = false;
#pragma unroll
      for (int i = 0; i < kBN / 32; ++i) {
        const int c = lane + 32 * i;
        const bool ok = n0 + c < n && m[n0 + c] != 0;
        sm.bias[s * kBN + c] = ok ? 0.f : neg_inf();
        masked |= !ok;
      }
      masked = __any_sync(0xffffffffu, masked);
      if (lane == 0) sm.flag[s] = masked;
      __syncwarp();
      hopper::mbar_arrive(&sm.full[s]);
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    hopper::setmaxnreg_inc<224>();
    const int wg = role;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int q4 = lane & 3;
    hopper::mbar_wait(sm.qbar, 0);
    const uint64_t da = hopper::desc_sw128(sm.q + wg * kBoxBytes);

    Top2 r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) r[i] = {neg_inf(), neg_inf(), 0};
    Acc acc_a, acc_b;
    hopper::pipelined_tiles(
        n_tiles, acc_a, acc_b,
        [&](Acc& acc, int t) { wait_and_issue(sm, acc, da, t); },
        [&](const Acc& acc, int t) { consume(sm, acc, t, q4, r); });

    const size_t base = (size_t)pair * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      merge_lanes(r[i]);
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * i;
      if (q4 == 0 && row < n) {
        d1[base + row] = dist(r[i].best);
        d2[base + row] = dist(r[i].second);
        idx_out[base + row] = r[i].idx;
      }
    }
  }
}

}  // namespace

// store (m, n, dim) bf16 contiguous, mask (m, n) uint8, ii/jj (b,) int32 in
// [0, m) -> d1, d2 (b, n) f32, idx (b, n) int32.  Launches on `stream`;
// returns a cudaError_t (cudaErrorInvalidValue for a shape the kernel does
// not take or a tensor map the driver refuses).  A pair index outside
// [0, m) traps in the kernel: the error shows at the next synchronize.
extern "C" int knn2_launch(const void* store, const void* mask, const void* ii,
                           const void* jj, int m, int b, int n, int dim,
                           void* d1, void* d2, void* idx, void* stream) {
  if (dim != kDim || b < 0 || b > 65535 || n < 0 || m < 0 ||
      (int64_t)m * n >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  CUtensorMap map;
  if (!hopper::encode_rows(&map, store, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                           (uint64_t)m * n, kDim, kBox, kAtom))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((n + kBM - 1) / kBM, b);
  knn2_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map, (const uint8_t*)mask, (const int*)ii, (const int*)jj, m, n, (float*)d1,
      (float*)d2, (int*)idx);
  return (int)cudaGetLastError();
}
