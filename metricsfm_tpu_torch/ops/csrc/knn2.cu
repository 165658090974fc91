// Fused exact 2-NN descriptor matcher for Hopper (sm_90a).
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
// bf16 operands, so the kernel is compute-bound; the N x N similarity
// matrix never reaches device memory.
//
// Design (simple first): one block = 8 warps = 128 query rows of one pair
// (grid.y walks the pair batch, so one launch covers a whole verify
// batch).  Each warp keeps its 16 query rows as mma.sync A fragments in
// registers for the whole run, and the block walks the database in tiles
// of 64 rows staged in padded shared memory.  Per tile a warp issues
// 8 k-steps x 8 n-tiles of mma.sync.m16n8k16 (bf16 in, f32 accumulate) and
// folds the 16 x 64 similarities straight into a per-thread running
// (best, second, argbest); the four lanes that share a row merge their
// partial top-2 with shuffles at the end.
//
// Left on the table for later: wgmma (the only path to full tensor-core
// rate), TMA or cp.async double-buffering of the database tiles (loads and
// math do not overlap within a block here), larger warp tiles to cut
// shared-memory reads per mma, and keeping the epilogue off the critical
// path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;            // descriptor width
constexpr int kSteps = kDim / 16;    // mma k-steps per row
constexpr int kWarps = 8;
constexpr int kBM = kWarps * 16;     // query rows per block
constexpr int kBN = 64;              // database rows per shared tile
constexpr int kNT = kBN / 8;         // mma n-tiles per shared tile
constexpr int kLds = kDim + 8;       // padded row stride: conflict-free B reads

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Top2 {
  float best, second;
  int idx;
};

// Candidates of one thread arrive in increasing column order, so a strict
// comparison keeps the lowest column on ties.
__device__ __forceinline__ void push(Top2& t, float v, int col) {
  if (v > t.best) {
    t.second = t.best;
    t.best = v;
    t.idx = col;
  } else if (v > t.second) {
    t.second = v;
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

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* rows, int row,
                                              int n, int k) {
  if (row >= n) return 0u;
  return *reinterpret_cast<const uint32_t*>(rows + (size_t)row * kDim + k);
}

__global__ void __launch_bounds__(kWarps * 32)
knn2_kernel(const __nv_bfloat16* __restrict__ store,
            const uint8_t* __restrict__ mask, const int* __restrict__ ii,
            const int* __restrict__ jj, int n, float* __restrict__ d1,
            float* __restrict__ d2, int* __restrict__ idx_out) {
  __shared__ __align__(16) __nv_bfloat16 tile[kBN * kLds];
  __shared__ uint8_t tmask[kBN];

  const int pair = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // mma groupID: fragment row
  const int tig = lane & 3;   // thread in group: fragment column pair
  const size_t image = (size_t)n * kDim;
  const __nv_bfloat16* q = store + (size_t)ii[pair] * image;
  const __nv_bfloat16* db = store + (size_t)jj[pair] * image;
  const uint8_t* m = mask + (size_t)jj[pair] * n;
  const int row0 = blockIdx.x * kBM + warp * 16 + g;
  const int row1 = row0 + 8;

  // A fragments (m16n8k16, row-major): a0a1 (row g, k..k+1), a2a3 (row g+8),
  // a4a5 (row g, k+8..k+9), a6a7 (row g+8, k+8..k+9), k = 16 s + 2 tig.
  uint32_t a[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int k = s * 16 + tig * 2;
    a[s][0] = load_pair(q, row0, n, k);
    a[s][1] = load_pair(q, row1, n, k);
    a[s][2] = load_pair(q, row0, n, k + 8);
    a[s][3] = load_pair(q, row1, n, k + 8);
  }

  Top2 t0 = {neg_inf(), neg_inf(), 0};
  Top2 t1 = {neg_inf(), neg_inf(), 0};

  for (int n0 = 0; n0 < n; n0 += kBN) {
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < kBN * (kDim / 8); c += blockDim.x) {
      const int r = c / (kDim / 8);
      const int kc = (c % (kDim / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < n)
        v = *reinterpret_cast<const uint4*>(db + (size_t)(n0 + r) * kDim + kc);
      *reinterpret_cast<uint4*>(&tile[r * kLds + kc]) = v;
    }
    if (threadIdx.x < kBN)
      tmask[threadIdx.x] = (n0 + threadIdx.x < n) ? m[n0 + threadIdx.x] : 0;
    __syncthreads();

    float acc[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        // B fragment (col-major 16x8): b0b1 = db row (8t + g), k..k+1;
        // b2b3 = same row, k+8..k+9.
        const __nv_bfloat16* bp = &tile[(t * 8 + g) * kLds + s * 16 + tig * 2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
        mma_bf16_16816(acc[t], a[s], b0, b1);
      }
    }
    // C fragment: c0c1 = (row g, cols 2 tig, 2 tig + 1), c2c3 = row g + 8.
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = t * 8 + tig * 2 + e;
        if (tmask[cl]) {
          push(t0, acc[t][e], n0 + cl);
          push(t1, acc[t][2 + e], n0 + cl);
        }
      }
    }
  }

  // the four lanes of a group hold disjoint columns of the same two rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    float ob = __shfl_xor_sync(0xffffffffu, t0.best, off);
    float os = __shfl_xor_sync(0xffffffffu, t0.second, off);
    int oi = __shfl_xor_sync(0xffffffffu, t0.idx, off);
    merge(t0, ob, os, oi);
    ob = __shfl_xor_sync(0xffffffffu, t1.best, off);
    os = __shfl_xor_sync(0xffffffffu, t1.second, off);
    oi = __shfl_xor_sync(0xffffffffu, t1.idx, off);
    merge(t1, ob, os, oi);
  }
  if (tig == 0) {
    const size_t base = (size_t)pair * n;
    if (row0 < n) {
      d1[base + row0] = fmaxf(2.f - 2.f * t0.best, 0.f);
      d2[base + row0] = fmaxf(2.f - 2.f * t0.second, 0.f);
      idx_out[base + row0] = t0.idx;
    }
    if (row1 < n) {
      d1[base + row1] = fmaxf(2.f - 2.f * t1.best, 0.f);
      d2[base + row1] = fmaxf(2.f - 2.f * t1.second, 0.f);
      idx_out[base + row1] = t1.idx;
    }
  }
}

}  // namespace

// store (M, n, dim) bf16, mask (M, n) uint8, ii/jj (b,) int32 -> d1, d2 (b, n)
// f32, idx (b, n) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int knn2_launch(const void* store, const void* mask, const void* ii,
                           const void* jj, int b, int n, int dim, void* d1,
                           void* d2, void* idx, void* stream) {
  if (dim != kDim || b < 0 || b > 65535 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  dim3 grid((n + kBM - 1) / kBM, b);
  knn2_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)store, (const uint8_t*)mask, (const int*)ii,
      (const int*)jj, n, (float*)d1, (float*)d2, (int*)idx);
  return (int)cudaGetLastError();
}
