// Census transform + Hamming cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel metricsfm_tpu/ops/pallas/sgm_kernel.py:
// _census_cost_kernel (reached through census_cost_pallas), with the
// semantics of metricsfm_tpu/ops/sgm.py census_transform +
// matching_cost_volume:
//   census: 9x7 window, bit = centre > neighbour, zero-padded context,
//     bits in dy-outer / dx-inner order with the centre skipped, bits 0-31
//     in word 0 and 32-61 in word 1;
//   cost(y, x, d) = popc(cl(y, x) ^ cr(y, x - d)), and 64 where x < d.
// The volume is (H, W, D) uint8, d fastest.  No row-pair int32 packing,
// no (8, 128) padding, no _BIG pad lanes: those were TPU layouts.
//
// One launch.  A block takes one row y and a tile of kTile consecutive
// pixels x0 .. x0 + kTile - 1, whose costs are one contiguous run of
// kTile * D bytes of the volume:
//  1. it stages the 9 image rows y - 4 .. y + 4 of the left image for
//     columns [x0 - 3, x0 + kTile + 3) and of the right image for columns
//     [x0 - D + 1 - 3, x0 + kTile + 3) in shared memory, zeros outside the
//     image, so no border test is left in the census;
//  2. it builds in shared memory the census words of its kTile left pixels
//     and of the kTile + D - 1 right pixels its disparities reach (the
//     right census is recomputed by the neighbouring tiles: about 1.5x its
//     pixels at D = 128, a small part of the work);
//  3. each thread writes 16 consecutive disparities of one pixel: it reads
//     cl once and 16 right words, xors and counts both words, packs the 16
//     bytes and stores them as one 16-byte store.  Consecutive threads
//     write consecutive 16 B, so a warp writes 512 contiguous bytes at D =
//     128.  x, d and the run's offset come from the block and thread
//     indices: no 64-bit division is left.  A chunk with x < d0 is 64 in
//     every byte and counts nothing.
// The vector store needs an aligned run: D % 16 == 0 and a 16-byte aligned
// volume; any other D or address takes the scalar specialization (byte
// stores), chosen at launch.  The right words are stored with `step`
// padding words after every 16 (position a + step * (a >> 4)), step = 16 /
// c, the power of two >= the D / 16 chunks of a pixel: the 16 lanes of a
// 64-bit shared load (a half warp: 16 / c pixels x c chunks, 16
// disparities apart) then hit 16 different bank pairs at any
// power-of-two D.
//
// What bounds it.  At 768 x 1024 x 128 the volume is 100.7 MB of stores
// (0.030 ms at 3.35 TB/s) and 2 x 94 M popcs run at 16 a clock an SM
// (0.046 ms at 132 SMs, 1.98 GHz; CUDA C++ Programming Guide, throughput
// of arithmetic instructions, compute capability 9.0).  Measured on an
// H100 (tools/probe_sgm.py), neither sets the time: the staging and the
// census alone take about half of it (the census of 2.5 pixels a pixel at
// kTile = 256, 62 compares each), the stores alone a third, and the
// popcs about a tenth; so the tile is wide, a thread issues all its
// staging loads before its first store, and a census thread takes two
// neighbouring pixels, whose windows share most of their reads.  The
// stores are plain: streaming stores (__stcs) measured no faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWinH = 9;
constexpr int kWinW = 7;
constexpr int kTile = 256;            // pixels of one row a block takes
constexpr int kThreads = 256;
constexpr int kMaxDisp = 256;
// staged columns, one more than a tile reads: the census takes pixels in
// pairs, and the second of an odd count's last pair is never stored
constexpr int kLeftCols = kTile + kWinW;
constexpr int kRightCols = kTile + kMaxDisp - 1 + kWinW;
constexpr int kRightWords = kTile + kMaxDisp + 32;   // with the padding

// The padded position of right pixel a of a tile.
__host__ __device__ __forceinline__ int padded(int a, int step) {
  return a + step * (a >> 4);
}

// Padding words after every 16 right words: 16 / (the power of two >= the
// chunks of 16 disparities of a pixel), 0 for a single chunk.
int pad_step(int dm) {
  const int chunks = (dm + 15) / 16;
  int p2 = 1;
  while (p2 < chunks) p2 *= 2;
  return p2 == 1 ? 0 : 16 / p2;
}

// Rows y - 4 .. y + 4 of img, columns [gx0, gx0 + n), into s (row stride
// COLS), zeros outside the image.  A thread issues all its loads before
// its first store, so the block waits on one round trip, not on 9 x U.
template <int COLS>
__device__ __forceinline__ void stage_rows(const float* __restrict__ img,
                                           int h, int w, int y, int gx0,
                                           int n, float* s) {
  constexpr int U = (COLS + kThreads - 1) / kThreads;
  float v[kWinH][U];
#pragma unroll
  for (int r = 0; r < kWinH; ++r) {
    const int gy = y + r - kWinH / 2;
    const bool row_in = gy >= 0 && gy < h;
    const float* src = img + (size_t)(row_in ? gy : 0) * w;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = threadIdx.x + u * kThreads;
      const int gx = gx0 + j;
      v[r][u] = row_in && j < n && gx >= 0 && gx < w ? src[gx] : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < kWinH; ++r)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = threadIdx.x + u * kThreads;
      if (j < n) s[r * COLS + j] = v[r][u];
    }
}

// The census words of the two pixels whose windows start at columns j and
// j + 1 of the staged rows s (centres s[4][j + 3], s[4][j + 4]): the two
// windows share 9 x 6 of their 9 x 8 columns, so each value is read once.
template <int COLS>
__device__ __forceinline__ void census_pair(const float* s, int j, uint2& p,
                                            uint2& q) {
  const float c0 = s[(kWinH / 2) * COLS + j + kWinW / 2];
  const float c1 = s[(kWinH / 2) * COLS + j + kWinW / 2 + 1];
  uint32_t w[4] = {0u, 0u, 0u, 0u};   // p lo, p hi, q lo, q hi
  int bit = 0;
#pragma unroll
  for (int dy = 0; dy < kWinH; ++dy) {
    float row[kWinW + 1];
#pragma unroll
    for (int dx = 0; dx <= kWinW; ++dx) row[dx] = s[dy * COLS + j + dx];
#pragma unroll
    for (int dx = 0; dx < kWinW; ++dx) {
      if (dy == kWinH / 2 && dx == kWinW / 2) continue;
      w[bit >> 5] |= (c0 > row[dx] ? 1u : 0u) << (bit & 31);
      w[2 + (bit >> 5)] |= (c1 > row[dx + 1] ? 1u : 0u) << (bit & 31);
      ++bit;
    }
  }
  p = make_uint2(w[0], w[1]);
  q = make_uint2(w[2], w[3]);
}

// The census words of the tile's np left pixels into wl, and of its np +
// dm - 1 right pixels (x0 - dm + 1 .. x0 + np - 1) into wr, padded; a
// thread takes two neighbouring pixels.
__device__ __forceinline__ void census_words(const float* sl, const float* sr,
                                             int np, int nr, int step,
                                             uint2* wl, uint2* wr) {
  const int lp = (np + 1) >> 1, rp = (nr + 1) >> 1;   // pixel pairs
  for (int i = threadIdx.x; i < lp + rp; i += kThreads) {
    uint2 p, q;
    if (i < lp) {
      const int a = 2 * i;
      census_pair<kLeftCols>(sl, a, p, q);
      wl[a] = p;
      if (a + 1 < np) wl[a + 1] = q;
    } else {
      const int a = 2 * (i - lp);
      census_pair<kRightCols>(sr, a, p, q);
      wr[padded(a, step)] = p;
      if (a + 1 < nr) wr[padded(a + 1, step)] = q;
    }
  }
}

// Block (blockIdx.x, y): pixels x0 .. x0 + np - 1 of row y, x0 = blockIdx.x
// * kTile.  Thread tid writes chunk c = tid % chunks (disparities 16c ..
// 16c + 15) of pixels tid / chunks, + per_pass, ...  VEC: D % 16 == 0 and
// an aligned volume (one 16-byte store a chunk); otherwise byte stores of
// the disparities < D.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
census_cost_kernel(const float* __restrict__ left,
                   const float* __restrict__ right, int h, int w, int dm,
                   int step, uint8_t* __restrict__ vol) {
  __shared__ float sl[kWinH * kLeftCols];
  __shared__ float sr[kWinH * kRightCols];
  __shared__ uint2 wl[kTile];
  __shared__ uint2 wr[kRightWords];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int np = min(kTile, w - x0);
  const int nr = np + dm - 1;
  stage_rows<kLeftCols>(left, h, w, y, x0 - kWinW / 2, np + kWinW - 1, sl);
  stage_rows<kRightCols>(right, h, w, y, x0 - dm + 1 - kWinW / 2,
                         nr + kWinW - 1, sr);
  __syncthreads();
  census_words(sl, sr, np, nr, step, wl, wr);
  __syncthreads();

  const int chunks = (dm + 15) >> 4;
  const int per_pass = kThreads / chunks;   // pixels a pass of the block
  if ((int)threadIdx.x >= per_pass * chunks) return;
  const int p0 = threadIdx.x / chunks;
  const int d0 = (threadIdx.x - p0 * chunks) << 4;
  uint8_t* row = vol + ((size_t)y * w + x0) * dm + d0;
  const bool edge = x0 < dm;   // block-uniform: some x < d in this tile
  for (int p = p0; p < np; p += per_pass) {
    const int x = x0 + p;
    uint32_t wd[4];
    if (x < d0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) wd[q] = 0x40404040u;
    } else {
      const uint2 cl = wl[p];
      const int a0 = p + dm - 1 - d0;   // right pixel x - d0 in the tile
#pragma unroll
      for (int q = 0; q < 4; ++q) wd[q] = 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (!VEC && d0 + k >= dm) break;
        const uint2 cr = wr[padded(a0 - k, step)];
        uint32_t c = __popc(cl.x ^ cr.x) + __popc(cl.y ^ cr.y);
        if (edge && x < d0 + k) c = 64u;
        wd[k >> 2] += c << (8 * (k & 3));
      }
    }
    uint8_t* out = row + (size_t)p * dm;
    if constexpr (VEC) {
      *(uint4*)out = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (d0 + k < dm) out[k] = (uint8_t)(wd[k >> 2] >> (8 * (k & 3)));
    }
  }
}

bool bad_shape(int h, int w, int dm) {
  return h <= 0 || w <= 0 || dm < 4 || dm > kMaxDisp || h > 65535 ||
         padded(kTile + dm - 1, pad_step(dm)) >= kRightWords;
}

}  // namespace

// left, right (h, w) f32 -> vol (h, w, d_max) uint8, in one launch on
// `stream`; returns cudaGetLastError().
extern "C" int sgm_census_cost_launch(const void* left, const void* right,
                                      void* vol, int h, int w, int d_max,
                                      void* stream) {
  if (bad_shape(h, w, d_max)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((w + kTile - 1) / kTile), (unsigned)h);
  const int step = pad_step(d_max);
  if (d_max % 16 == 0 && (uintptr_t)vol % 16 == 0)
    census_cost_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)left, (const float*)right, h, w, d_max, step,
        (uint8_t*)vol);
  else
    census_cost_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float*)left, (const float*)right, h, w, d_max, step,
        (uint8_t*)vol);
  return (int)cudaGetLastError();
}

// The pixels a block takes; *smem_bytes gets its (static) shared memory.
extern "C" int sgm_census_cost_tile(int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, census_cost_kernel<true>);
  *smem_bytes = e == cudaSuccess ? (int)attr.sharedSizeBytes : -1;
  return kTile;
}
