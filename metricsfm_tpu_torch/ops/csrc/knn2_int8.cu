// Fused int8 2-NN descriptor matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel metricsfm_tpu/ops/pallas/match_kernel.py:
// _kernel_int8 (reached through _knn2_pallas_int8_impl / knn2_pallas_int8).
// Descriptors arrive quantized to int8 in [0, 127] (q = clip(round(256 d),
// 0, 127), done by the wrapper), and the 2-NN runs exactly in that
// quantized space.  For every query row of pair b:
//   val(c) = 2 q.db_c - |db_c|^2, summed in int32 (exact: |q.db| <=
//            128 * 127^2 = 2,064,512);
//   the top-2 of val over the valid (unmasked, in-range) columns, best ties
//   to the LOWEST column, second-best excluding only the best column;
//   d^2 = max(|q|^2 - val, 0) / 65536 (exact in f32: every integer here is
//   below 2^24); with fewer than two valid columns d2 = +inf (and with none
//   d1 = +inf, idx = 0).
// No 64-unit value floor, no 13-bit column packing and no N2 <= 8192 cap:
// those exist only for the TPU's packed max.
//
// What bounds it: a 4096 x 4096 x 128 pair is 4.29 G int8 operations on
// 1 MB of operands, so the kernel is compute-bound (96 pairs: 0.208 ms at
// the 1,979 TOP/s int8 dense peak); the N1 x N2 value matrix never reaches
// device memory.
//
// Design (simple first, the shape of knn2.cu): one block = 8 warps = 128
// query rows of one pair (grid.y walks the pairs).  Each warp keeps its 16
// query rows as mma.sync A fragments in registers for the whole run; the
// block walks the database in tiles of 64 rows staged in padded shared
// memory, computes the tile's |db|^2 once there (dp4a) and reads its mask
// once.  Per tile a warp runs 4 k-steps x 8 n-tiles of
// mma.sync.m16n8k32 (s8 x s8 -> s32) and folds the 16 x 64 values straight
// into a per-thread running (best, second, argbest); the four lanes that
// share a row merge their partial top-2 with shuffles at the end.  The s8
// m16n8k32 fragments hold the same bytes per register as the bf16 m16n8k16
// ones (a row of 32 bytes either way), so the load pattern is knn2.cu's in
// bytes.
//
// Left for later: wgmma + TMA (the path to the full int8 rate),
// double-buffered tiles, and a cheaper epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;            // descriptor width (bytes per row)
constexpr int kSteps = kDim / 32;    // mma k-steps per row
constexpr int kWarps = 8;
constexpr int kBM = kWarps * 16;     // query rows per block
constexpr int kBN = 64;              // database rows per shared tile
constexpr int kNT = kBN / 8;         // mma n-tiles per shared tile
constexpr int kLds = kDim + 16;      // padded row stride (bytes): 36 words,
                                     // conflict-free B fragment reads
constexpr int kNone = INT32_MIN;     // below any real val (>= -2,064,512)

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Top2 {
  int best, second, idx;
};

// Candidates of one thread arrive in increasing column order, so a strict
// comparison keeps the lowest column on ties.
__device__ __forceinline__ void push(Top2& t, int v, int col) {
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
__device__ __forceinline__ void merge(Top2& t, int ob, int os, int oi) {
  if (ob > t.best || (ob == t.best && oi < t.idx)) {
    t.second = max(t.best, os);
    t.best = ob;
    t.idx = oi;
  } else {
    t.second = max(t.second, ob);
  }
}

__device__ __forceinline__ void merge_lanes(Top2& t) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, t.best, off);
    const int os = __shfl_xor_sync(0xffffffffu, t.second, off);
    const int oi = __shfl_xor_sync(0xffffffffu, t.idx, off);
    merge(t, ob, os, oi);
  }
}

__device__ __forceinline__ uint32_t load4(const int8_t* rows, int row, int n,
                                          int k) {
  if (row >= n) return 0u;
  return *reinterpret_cast<const uint32_t*>(rows + (size_t)row * kDim + k);
}

__device__ __forceinline__ float dist(int na, int v) {
  if (v == kNone) return __int_as_float(0x7f800000);  // +inf
  return (float)max(na - v, 0) * (1.0f / 65536.0f);
}

__global__ void __launch_bounds__(kWarps * 32)
knn2_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ db8,
                 const uint8_t* __restrict__ mask, int n1, int n2,
                 float* __restrict__ d1, float* __restrict__ d2,
                 int* __restrict__ idx_out) {
  __shared__ __align__(16) int8_t tile[kBN * kLds];
  __shared__ int tnb[kBN];
  __shared__ uint8_t tmask[kBN];

  const int pair = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // mma groupID: fragment row
  const int tig = lane & 3;   // thread in group: fragment 4-byte column
  const int8_t* q = q8 + (size_t)pair * n1 * kDim;
  const int8_t* db = db8 + (size_t)pair * n2 * kDim;
  const uint8_t* m = mask + (size_t)pair * n2;
  const int row0 = blockIdx.x * kBM + warp * 16 + g;
  const int row1 = row0 + 8;

  // A fragments (m16n8k32 s8, row-major): a0 = (row g, bytes 4 tig..+3),
  // a1 = (row g + 8, same), a2 = (row g, 16 + 4 tig..+3), a3 = (row g + 8,
  // same), of k-step s (32 bytes at 32 s).  |q|^2 from the same registers.
  uint32_t a[kSteps][4];
  int na0 = 0, na1 = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int k = s * 32 + tig * 4;
    a[s][0] = load4(q, row0, n1, k);
    a[s][1] = load4(q, row1, n1, k);
    a[s][2] = load4(q, row0, n1, k + 16);
    a[s][3] = load4(q, row1, n1, k + 16);
    na0 = __dp4a((int)a[s][0], (int)a[s][0], na0);
    na0 = __dp4a((int)a[s][2], (int)a[s][2], na0);
    na1 = __dp4a((int)a[s][1], (int)a[s][1], na1);
    na1 = __dp4a((int)a[s][3], (int)a[s][3], na1);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    na0 += __shfl_xor_sync(0xffffffffu, na0, off);
    na1 += __shfl_xor_sync(0xffffffffu, na1, off);
  }

  Top2 t0 = {kNone, kNone, 0};
  Top2 t1 = {kNone, kNone, 0};

  for (int n0 = 0; n0 < n2; n0 += kBN) {
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < kBN * (kDim / 16); c += blockDim.x) {
      const int r = c / (kDim / 16);
      const int kc = (c % (kDim / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < n2)
        v = *reinterpret_cast<const uint4*>(db + (size_t)(n0 + r) * kDim + kc);
      *reinterpret_cast<uint4*>(&tile[r * kLds + kc]) = v;
    }
    if (threadIdx.x < kBN)
      tmask[threadIdx.x] = (n0 + threadIdx.x < n2) ? m[n0 + threadIdx.x] : 0;
    __syncthreads();
    {  // |db|^2 of the tile: four threads per row, 32 bytes each
      const int r = threadIdx.x >> 2;
      const int* w = reinterpret_cast<const int*>(&tile[r * kLds +
                                                        (threadIdx.x & 3) * 32]);
      int s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) s = __dp4a(w[i], w[i], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((threadIdx.x & 3) == 0) tnb[r] = s;
    }
    __syncthreads();

    int acc[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        // B fragment (col-major 32x8): b0 = db row (8t + g), bytes
        // 4 tig..+3 of the k-step; b1 = same row, 16 bytes further.
        const int8_t* bp = &tile[(t * 8 + g) * kLds + s * 32 + tig * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
        mma_s8_16832(acc[t], a[s], b0, b1);
      }
    }
    // C fragment: c0c1 = (row g, cols 2 tig, 2 tig + 1), c2c3 = row g + 8.
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = t * 8 + tig * 2 + e;
        if (tmask[cl]) {
          const int nb = tnb[cl];
          push(t0, 2 * acc[t][e] - nb, n0 + cl);
          push(t1, 2 * acc[t][2 + e] - nb, n0 + cl);
        }
      }
    }
  }

  // the four lanes of a group hold disjoint columns of the same two rows
  merge_lanes(t0);
  merge_lanes(t1);
  if (tig == 0) {
    const size_t base = (size_t)pair * n1;
    if (row0 < n1) {
      d1[base + row0] = dist(na0, t0.best);
      d2[base + row0] = dist(na0, t0.second);
      idx_out[base + row0] = t0.idx;
    }
    if (row1 < n1) {
      d1[base + row1] = dist(na1, t1.best);
      d2[base + row1] = dist(na1, t1.second);
      idx_out[base + row1] = t1.idx;
    }
  }
}

}  // namespace

// q8 (b, n1, dim) int8, db8 (b, n2, dim) int8, mask (b, n2) uint8 ->
// d1, d2 (b, n1) f32, idx (b, n1) int32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int knn2_int8_launch(const void* q8, const void* db8,
                                const void* mask, int b, int n1, int n2,
                                int dim, void* d1, void* d2, void* idx,
                                void* stream) {
  if (dim != kDim || b < 0 || b > 65535 || n1 < 0 || n2 < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n1 == 0) return 0;
  dim3 grid((n1 + kBM - 1) / kBM, b);
  knn2_int8_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const int8_t*)db8, (const uint8_t*)mask, n1, n2,
      (float*)d1, (float*)d2, (int*)idx);
  return (int)cudaGetLastError();
}
