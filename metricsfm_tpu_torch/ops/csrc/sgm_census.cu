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
// What bounds it: the volume write.  At 768 x 1024 x 128 it is 100 MB
// against two 3 MB images and 12 MB of census words, so the kernel is a
// store stream at best (~30 us at 3.35 TB/s).
//
// Design (simple first): two launches.  One thread per pixel builds the
// two census words of both images into a small scratch array (62 reads of
// the image, all from L1/L2).  Then one thread per (y, x, d) writes one
// cost byte: consecutive threads write consecutive bytes, so the stores
// coalesce, and the census words each warp reads are a handful of cached
// 4-byte loads.  Left for later: computing the census in shared memory
// tiles and writing 16 bytes per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWinH = 9;
constexpr int kWinW = 7;

// words: (4, H, W) uint32 = left lo, left hi, right lo, right hi.
__global__ void census_kernel(const float* __restrict__ left,
                              const float* __restrict__ right, int h, int w,
                              uint32_t* __restrict__ words) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int img = blockIdx.z;
  if (x >= w) return;
  const float* src = img == 0 ? left : right;
  const float c = src[(size_t)y * w + x];
  uint32_t lo = 0u, hi = 0u;
  int bit = 0;
#pragma unroll
  for (int dy = 0; dy < kWinH; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kWinW; ++dx) {
      if (dy == kWinH / 2 && dx == kWinW / 2) continue;
      const int yy = y + dy - kWinH / 2;
      const int xx = x + dx - kWinW / 2;
      const float nb = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                           ? src[(size_t)yy * w + xx] : 0.f;
      const uint32_t b = c > nb ? 1u : 0u;
      if (bit < 32) lo |= b << bit; else hi |= b << (bit - 32);
      ++bit;
    }
  }
  const size_t plane = (size_t)h * w;
  words[(size_t)(2 * img) * plane + (size_t)y * w + x] = lo;
  words[(size_t)(2 * img + 1) * plane + (size_t)y * w + x] = hi;
}

__global__ void cost_kernel(const uint32_t* __restrict__ words, int h, int w,
                            int d_max, uint8_t* __restrict__ vol) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)h * w * d_max;
  if (i >= n) return;
  const int d = (int)(i % d_max);
  const size_t pix = i / d_max;
  const int x = (int)(pix % w);
  if (x < d) {
    vol[i] = 64;
    return;
  }
  const size_t plane = (size_t)h * w;
  const uint32_t* ll = words;
  const uint32_t* lh = words + plane;
  const uint32_t* rl = words + 2 * plane;
  const uint32_t* rh = words + 3 * plane;
  const size_t pr = pix - d;   // (y, x - d)
  vol[i] = (uint8_t)(__popc(ll[pix] ^ rl[pr]) + __popc(lh[pix] ^ rh[pr]));
}

}  // namespace

// left, right (h, w) f32 -> vol (h, w, d_max) uint8; words is a (4, h, w)
// uint32 scratch.  Launches on `stream`; returns cudaGetLastError().
extern "C" int sgm_census_cost_launch(const void* left, const void* right,
                                      void* words, void* vol, int h, int w,
                                      int d_max, void* stream) {
  if (h <= 0 || w <= 0 || d_max <= 0 || h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 cgrid((w + 127) / 128, h, 2);
  census_kernel<<<cgrid, 128, 0, s>>>((const float*)left,
                                      (const float*)right, h, w,
                                      (uint32_t*)words);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t n = (size_t)h * w * d_max;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cost_kernel<<<blocks, 256, 0, s>>>((const uint32_t*)words, h, w, d_max,
                                     (uint8_t*)vol);
  return (int)cudaGetLastError();
}
