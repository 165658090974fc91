// Fused int8 2-NN descriptor matcher for Hopper (sm_90a): wgmma + TMA, and
// the fused quantize pass that feeds it.
//
// Replaces the TPU kernel metricsfm_tpu/ops/pallas/match_kernel.py:
// _kernel_int8 (reached through _knn2_pallas_int8_impl / knn2_pallas_int8).
// Descriptors arrive quantized to int8 in [0, 127] (q = clip(rint(256 d),
// 0, 127), by the quantize pass below), and the 2-NN runs exactly in that
// quantized space.  For every query row of pair b:
//   val(c) = 2 q.db_c - |db_c|^2, exact int32 (|q.db| <= 128 * 127^2 =
//            2,064,512, so every real val lies in [-2,064,512, 2,064,512]);
//   the top-2 of val over the valid (unmasked, in-range) columns, best ties
//   to the LOWEST column, second-best excluding only the best column;
//   d^2 = max(|q|^2 - val, 0) / 65536 (exact in f32: every integer here is
//   below 2^24); with fewer than two valid columns d2 = +inf (and with none
//   d1 = +inf, idx = 0).
// No 64-unit value floor, no 13-bit column packing and no N2 <= 8192 cap:
// those exist only for the TPU's packed max.
//
// What bounds it: a 4096 x 4096 x 128 pair is 4.29 G int8 operations on
// 1 MB of operands, so the kernel is bound by the tensor cores (96 pairs:
// 0.208 ms at the 1,979 TOP/s int8 dense peak); the N1 x N2 value matrix
// never reaches device memory.  At the int8 rate the per-value fold, not
// the product, is the limit (the ALU pipe issues 64 lanes a clock per SM),
// so it is cut to 4 instructions a value.
//
// Design (knn2.cu's, with int8 operands): one block = 128 query rows of
// one pair (grid.y walks the pairs) = two consumer warpgroups + a producer
// warpgroup (one warp issues; setmaxnreg gives the consumers 224 registers
// and the producers 56).  Queries and database are (B N, 128) int8 tensor
// maps with the 128-byte swizzle (a 128-byte row is exactly one atom); the
// producer loads the query rows once and the database in 128-row tiles
// through a ring of kStages stages behind full / empty mbarriers.  With
// each tile it writes a per-column key bias
//   nbk(c) = (127 - c) - 128 |db_c|^2  (valid column c of the tile), or
//   kMaskedKey = -2^30                  (masked, or at or past row n2: the
//                                        map runs on into the next pair),
// from the row norms the quantize pass wrote (mask folded in as
// kMaskedNb).  Consumers issue wgmma.m64n128k32.s32.s8.s8 (4 k-steps) for
// their 64 rows, with two accumulator sets, folding tile t while tile
// t+1's product runs.  The fold packs value and column into one key,
//   key = 256 acc + nbk(c) = 128 val + (127 - c)
// (|key| < 2^28 for a valid column, below -5.4e8 for a masked one), so
// that a plain integer top-2 of keys, second = max(second, min(best, key)),
// best = max(best, key), is exact and keeps the lowest column on ties; a
// tile's top-2 keys then merge into the row's running (val, column) top-2,
// and the four lanes that share a row merge theirs with shuffles at the
// end.  Any val below -2,064,512 after the merge is "no column".
//
// The quantize pass (knn2_int8_quantize_launch) replaces the nine
// plain-torch passes of the wrapper: it reads f32 or bf16 descriptors once
// and writes the int8 rows and their int32 norms |q|^2 (kMaskedNb for a
// masked row), up to two tensors in one launch, eight threads a row.
// knn2_int8_kernel takes only norms in that form: it reads nb >= kMaskedNb
// as a masked row and checks nothing else about them.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kDim = 128;           // descriptor width (bytes per row)
constexpr int kBM = 128;            // query rows per block
constexpr int kBN = 128;            // database rows per tile
constexpr int kBox = 64;            // rows per TMA box
constexpr int kStages = 6;          // database ring depth
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kTileBytes = kBN * kDim;          // 16 KB
constexpr int kQBytes = kBM * kDim;             // 16 KB
constexpr int kSmemBytes = 1024 + kQBytes + kTileBytes * kStages +
                           kStages * kBN * 4 + (2 * kStages + 1) * 8;
constexpr int kNone = INT32_MIN;
constexpr int kValMin = -2064512;               // below it: no column
constexpr int kMaskedNb = 1 << 26;              // norm of a masked row
constexpr int kMaskedKey = -(1 << 30);

struct Smem {
  uint8_t* q;
  uint8_t* db;
  int* nbk;          // kStages x kBN
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;
};

__device__ __forceinline__ Smem carve(uint8_t* raw) {
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Smem s;
  s.q = base;
  s.db = base + kQBytes;
  s.nbk = reinterpret_cast<int*>(s.db + kStages * kTileBytes);
  s.full = reinterpret_cast<uint64_t*>(s.nbk + kStages * kBN);
  s.empty = s.full + kStages;
  s.qbar = s.empty + kStages;
  return s;
}

struct Top2 {
  int best, second, idx;
};

// Fold a tile's top-2 keys (columns above every column seen so far).
__device__ __forceinline__ void fold_tile_top2(Top2& t, int kb, int ks,
                                               int n0) {
  const int vb = kb >> 7;   // arithmetic: floor, so the value even if < 0
  const int vs = ks >> 7;
  if (vb > t.best) {
    t.second = max(t.best, vs);
    t.best = vb;
    t.idx = n0 + 127 - (kb & 127);
  } else {
    t.second = max(t.second, vb);
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

// One accumulator set: a warpgroup's 64 rows x the tile's 128 columns.
struct Acc {
  int d[64];
};


// acc = this warpgroup's 64 query rows . db_tile^T, one wgmma group; a
// k-step is 32 bytes of the single 128-byte atom.
__device__ __forceinline__ void issue_tile(Acc& acc, uint64_t da, uint64_t db) {
  hopper::acc_fence(acc.d);
  hopper::wgmma_fence();
  hopper::wgmma_s8_m64n128k32<0>(acc.d, da, db);
#pragma unroll
  for (int kk = 1; kk < kDim / 32; ++kk)
    hopper::wgmma_s8_m64n128k32<1>(acc.d, da + 2 * kk, db + 2 * kk);
  hopper::wgmma_commit();
}

// Fold one tile (rows g and g + 8 of this warp, columns 8 j + 2 q + e).
__device__ __forceinline__ void consume(const Smem& sm, const Acc& acc, int t,
                                        int q4, Top2 (&r)[2]) {
  const int s = t % kStages;
  const int* nbk = sm.nbk + s * kBN + 2 * q4;
  int b0 = kNone, s0 = kNone, b1 = kNone, s1 = kNone;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int2 nj = *reinterpret_cast<const int2*>(nbk + 8 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ne = e ? nj.y : nj.x;
      const int k0 = acc.d[4 * j + e] * 256 + ne;
      const int k1 = acc.d[4 * j + 2 + e] * 256 + ne;
      s0 = max(s0, min(b0, k0));
      b0 = max(b0, k0);
      s1 = max(s1, min(b1, k1));
      b1 = max(b1, k1);
    }
  }
  // a key's low 7 bits hold 127 - c of its tile column c
  fold_tile_top2(r[0], b0, s0, t * kBN);
  fold_tile_top2(r[1], b1, s1, t * kBN);
  hopper::mbar_arrive(&sm.empty[s]);
}

__device__ __forceinline__ void wait_and_issue(const Smem& sm, Acc& acc,
                                               uint64_t da, int t) {
  const int s = t % kStages;
  hopper::mbar_wait(&sm.full[s], (t / kStages) & 1);
  issue_tile(acc, da, hopper::desc_sw128(sm.db + s * kTileBytes));
}

__device__ __forceinline__ float dist(int na, int v) {
  if (v < kValMin) return __int_as_float(0x7f800000);  // +inf: no column
  return (float)max(na - v, 0) * (1.0f / 65536.0f);
}

__global__ void __launch_bounds__(kThreads, 1)
knn2_int8_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap db_map,
                 const int* __restrict__ nq, const int* __restrict__ nb,
                 int n1, int n2, float* __restrict__ d1,
                 float* __restrict__ d2, int* __restrict__ idx_out) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw);
  const int pair = blockIdx.y;
  const int m0 = blockIdx.x * kBM;
  const int n_tiles = (n2 + kBN - 1) / kBN;

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
    const int jrow = pair * n2;
    const int* nbp = nb + (size_t)pair * n2;
    if (lane == 0) {
      hopper::prefetch_tensor_map(&q_map);
      hopper::prefetch_tensor_map(&db_map);
      hopper::mbar_arrive_expect_tx(sm.qbar, kQBytes);
      for (int r = 0; r < kBM / kBox; ++r)
        hopper::tma_load_2d(sm.q + r * kBox * kDim, &q_map, sm.qbar, 0,
                            pair * n1 + m0 + r * kBox);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      hopper::mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
      const int n0 = t * kBN;
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.full[s], kTileBytes);
        for (int r = 0; r < kBN / kBox; ++r)
          hopper::tma_load_2d(sm.db + s * kTileBytes + r * kBox * kDim, &db_map,
                              &sm.full[s], 0, jrow + n0 + r * kBox);
      }
#pragma unroll
      for (int i = 0; i < kBN / 32; ++i) {
        const int c = lane + 32 * i;
        const int v = n0 + c < n2 ? nbp[n0 + c] : kMaskedNb;
        sm.nbk[s * kBN + c] = v < kMaskedNb ? (127 - c) - 128 * v : kMaskedKey;
      }
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
    const uint64_t da = hopper::desc_sw128(sm.q + wg * 64 * kDim);

    Top2 r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) r[i] = {kNone, kNone, 0};
    Acc acc_a, acc_b;
    hopper::pipelined_tiles(
        n_tiles, acc_a, acc_b,
        [&](Acc& acc, int t) { wait_and_issue(sm, acc, da, t); },
        [&](const Acc& acc, int t) { consume(sm, acc, t, q4, r); });

    const size_t base = (size_t)pair * n1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      merge_lanes(r[i]);
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * i;
      if (q4 == 0 && row < n1) {
        const int na = nq[base + row];
        d1[base + row] = dist(na, r[i].best);
        d2[base + row] = dist(na, r[i].second);
        idx_out[base + row] = r[i].best < kValMin ? 0 : r[i].idx;
      }
    }
  }
}

// ---- the fused quantize pass ----------------------------------------------

struct QuantSeg {
  const void* src;        // (rows, 128) f32 or bf16
  int bf16;
  int rows;
  const uint8_t* mask;    // (rows,) or null: all valid
  int8_t* out;            // (rows, 128)
  int* norms;             // (rows,) or null
};

constexpr int kQRows = 32;  // rows per 256-thread block, 8 threads a row

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d) {
  // clip(rint(256 x), 0, 127); x 256 is exact, rint rounds half to even
  const auto q = [](float x) {
    return (uint32_t)__float2int_rn(fminf(fmaxf(x * 256.f, 0.f), 127.f));
  };
  return q(a) | (q(b) << 8) | (q(c) << 16) | (q(d) << 24);
}

__global__ void __launch_bounds__(256)
quantize_kernel(QuantSeg seg0, QuantSeg seg1) {
  const QuantSeg s = blockIdx.y ? seg1 : seg0;
  const int row = blockIdx.x * kQRows + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;            // 16 values of the row
  const bool live = row < s.rows;
  float x[16];
  if (live) {
    if (s.bf16) {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(s.src) + (size_t)row * kDim +
          part * 16);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = p[h];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[8 * h + 2 * i] = __uint_as_float(w[i] << 16);
          x[8 * h + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    } else {
      const float4* p = reinterpret_cast<const float4*>(
          static_cast<const float*>(s.src) + (size_t)row * kDim + part * 16);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float4 v = p[h];
        x[4 * h] = v.x;
        x[4 * h + 1] = v.y;
        x[4 * h + 2] = v.z;
        x[4 * h + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0.f;
  }
  uint4 o;
  o.x = quant4(x[0], x[1], x[2], x[3]);
  o.y = quant4(x[4], x[5], x[6], x[7]);
  o.z = quant4(x[8], x[9], x[10], x[11]);
  o.w = quant4(x[12], x[13], x[14], x[15]);
  int nrm = __dp4a((int)o.x, (int)o.x, 0);
  nrm = __dp4a((int)o.y, (int)o.y, nrm);
  nrm = __dp4a((int)o.z, (int)o.z, nrm);
  nrm = __dp4a((int)o.w, (int)o.w, nrm);
  nrm += __shfl_xor_sync(0xffffffffu, nrm, 1);
  nrm += __shfl_xor_sync(0xffffffffu, nrm, 2);
  nrm += __shfl_xor_sync(0xffffffffu, nrm, 4);
  if (!live) return;
  *reinterpret_cast<uint4*>(s.out + (size_t)row * kDim + part * 16) = o;
  if (s.norms != nullptr && part == 0)
    s.norms[row] = (s.mask != nullptr && s.mask[row] == 0) ? kMaskedNb : nrm;
}

}  // namespace

// q8 (b, n1, dim) and db8 (b, n2, dim) int8 in [0, 127], contiguous;
// nq (b, n1) int32 query norms; nb (b, n2) int32 database norms with masked
// rows at 2^26 (as the quantize pass writes them) -> d1, d2 (b, n1) f32,
// idx (b, n1) int32.  Launches on `stream`; returns a cudaError_t.
extern "C" int knn2_int8_launch(const void* q8, const void* db8, const void* nq,
                                const void* nb, int b, int n1, int n2, int dim,
                                void* d1, void* d2, void* idx, void* stream) {
  if (dim != kDim || b < 0 || b > 65535 || n1 < 0 || n2 < 0 ||
      (int64_t)b * n1 >= (int64_t)1 << 31 || (int64_t)b * n2 >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n1 == 0) return 0;
  if (n2 == 0) return (int)cudaErrorInvalidValue;  // no tile to run
  CUtensorMap q_map, db_map;
  if (!hopper::encode_rows(&q_map, q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                           (uint64_t)b * n1, kDim, kBox, kDim) ||
      !hopper::encode_rows(&db_map, db8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                           (uint64_t)b * n2, kDim, kBox, kDim))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn2_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((n1 + kBM - 1) / kBM, b);
  knn2_int8_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      q_map, db_map, (const int*)nq, (const int*)nb, n1, n2, (float*)d1,
      (float*)d2, (int*)idx);
  return (int)cudaGetLastError();
}

// Quantize up to two descriptor sets in one launch: src (rows, 128) f32
// (bf16 = 0) or bf16 (bf16 = 1) -> out (rows, 128) int8 clip(rint(256 x),
// 0, 127), and, where `norms` is not null, norms (rows,) int32 = |out|^2,
// or 2^26 where `mask` (uint8, may be null) is 0.  rows2 = 0 skips the
// second set.  Launches on `stream`; returns cudaGetLastError().
extern "C" int knn2_int8_quantize_launch(
    const void* src1, int bf16_1, int rows1, const void* mask1, void* out1,
    void* norms1, const void* src2, int bf16_2, int rows2, const void* mask2,
    void* out2, void* norms2, void* stream) {
  if (rows1 < 0 || rows2 < 0) return (int)cudaErrorInvalidValue;
  const int rows = rows1 > rows2 ? rows1 : rows2;
  if (rows == 0) return 0;
  const QuantSeg s1 = {src1, bf16_1, rows1, (const uint8_t*)mask1,
                       (int8_t*)out1, (int*)norms1};
  const QuantSeg s2 = {src2, bf16_2, rows2, (const uint8_t*)mask2,
                       (int8_t*)out2, (int*)norms2};
  dim3 grid((rows + kQRows - 1) / kQRows, rows2 > 0 ? 2 : 1);
  quantize_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(s1, s2);
  return (int)cudaGetLastError();
}
