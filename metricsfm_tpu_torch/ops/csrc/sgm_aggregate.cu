// SGM path aggregation and fused winner-takes-all for Hopper (sm_90a).
//
// Replaces three TPU kernels of metricsfm_tpu/ops/pallas/sgm_kernel.py:
//   sgm_horizontal_launch  <- _horizontal_kernel   (via _horizontal_pass)
//   sgm_partial_launch     <- _vertical_fwd_kernel (via _partial_sum)
//   sgm_total_wta_launch   <- _vertical_bwd_kernel (via aggregate_wta_pallas)
// with the semantics of the JAX package's fused stereo branch:
//   L(p, d) = c(p, d) + min(L(q, d), L(q, d-1) + P1, L(q, d+1) + P1,
//                           m + P2) - m,   m = min_d L(q, .),
// q the predecessor of p on the path; disparities outside [0, D) are
// +big; the first pixel of a path has L = c (a restart).  Volumes are
// (H, W, D) with d fastest: cost uint8, sums int16 (a path value is
// <= 64 + P2, the 8-path sum <= 1,472); everything is an integer, so the
// result is exact whatever the order of the sums.
//
// What bounds it on the card: each path is a chain of dependent steps
// (up to 1,024 at 768 x 1024), so the kernel is latency-bound per chain
// and has to run many chains at once; the bytes are ~5 volume passes per
// stage (read cost + acc, write acc: 100 + 200 + 200 MB at D = 128).
//
// Design (libSGM's, not the TPU's carry-shift trick): every path family
// is a set of independent 1-D chains (rows for the horizontal paths,
// columns for the vertical ones, the lines x - y = const and x + y = const
// for the diagonals).  One warp walks one chain with the D disparities
// across its lanes, K = ceil(D / 32) consecutive disparities per lane, and
// keeps the carry in registers: m is a lane min plus 5 xor-shuffles, and
// L(q, d-1) / L(q, d+1) across lane borders are one shuffle up and one
// down.  Each path family is its own launch that reads an accumulator and
// writes the sum back (in place for the second and third family of a
// stage), so no two threads ever touch one element concurrently and no
// atomics are needed.  The WTA epilogue of 2f is a second kernel, one warp
// per pixel, over the 8-path total kept in device memory (int16):
//   left:  c0, best (ties -> smallest d), c1 (|d - best| > 1, capped at
//          16000 like the TPU kernel's masked fill), cm/cc/cp at
//          clip(best, 1, D-2) -1/0/+1;
//   right: c0, best, c1 over cost_r(x, d) = total(x + d, d), 30000 where
//          x + d >= W (integer only: it feeds the <= 1 px L/R check).
// Left for later: fusing the WTA into the up pass, prefetching the next
// step's cost and accumulator, shared-memory tiling, cp.async / TMA.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;             // chains (or pixels) per block
constexpr int kPad = 1 << 24;         // disparities d >= D
constexpr int kC1Cap = 16000;
constexpr int kRightOutOfRange = 30000;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One warp per chain.  Chain numbering: rows for dy == 0, columns for
// dx == 0; for a diagonal, chains 0..w-1 start on the first row of the
// walk (column = chain) and chains w..w+h-2 on its first column.
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
path_kernel(const uint8_t* __restrict__ cost, const int16_t* acc_in,
            int16_t* acc_out, int h, int w, int dm, int dy, int dx, int p1,
            int p2, int n_chains) {
  const int chain = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chain >= n_chains) return;   // warp-uniform
  int y, x;
  if (dy == 0) {
    y = chain;
    x = dx > 0 ? 0 : w - 1;
  } else if (dx == 0 || chain < w) {
    x = chain;
    y = dy > 0 ? 0 : h - 1;
  } else {
    const int r = chain - w + 1;
    y = dy > 0 ? r : h - 1 - r;
    x = dx > 0 ? 0 : w - 1;
  }
  const int d0 = lane * K;
  int prev[K];
  bool first = true;
  while (y >= 0 && y < h && x >= 0 && x < w) {
    const size_t base = ((size_t)y * w + x) * dm;
    int c[K], a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      c[k] = d < dm ? (int)cost[base + d] : 0;
      a[k] = (acc_in != nullptr && d < dm) ? (int)acc_in[base + d] : 0;
    }
    int L[K];
    if (first) {
#pragma unroll
      for (int k = 0; k < K; ++k) L[k] = d0 + k < dm ? c[k] : kPad;
      first = false;
    } else {
      int m = prev[0];
#pragma unroll
      for (int k = 1; k < K; ++k) m = min(m, prev[k]);
      m = warp_min(m);
      int below = __shfl_up_sync(kFull, prev[K - 1], 1);   // L(q, d0 - 1)
      int above = __shfl_down_sync(kFull, prev[0], 1);     // L(q, d0 + K)
      if (lane == 0) below = kPad;
      if (lane == 31) above = kPad;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int lo = k > 0 ? prev[k - 1] : below;
        const int hi = k < K - 1 ? prev[k + 1] : above;
        const int v = min(min(prev[k], m + p2), min(lo, hi) + p1);
        L[k] = d0 + k < dm ? c[k] + v - m : kPad;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (d0 + k < dm) acc_out[base + d0 + k] = (int16_t)(a[k] + L[k]);
      prev[k] = L[k];
    }
    y += dy;
    x += dx;
  }
}

// c0 = min, best = smallest d reaching it, c1 = min over |d - best| > 1
// (capped at kC1Cap) of one pixel's values spread K per lane.
template <int K>
__device__ __forceinline__ void wta3(const int v[K], int d0, int& c0,
                                     int& best, int& c1) {
  int m = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min(m, v[k]);
  c0 = warp_min(m);
  int b = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (v[k] == c0) b = min(b, d0 + k);
  best = warp_min(b);
  int s = kC1Cap;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (abs(d0 + k - best) > 1) s = min(s, v[k]);
  c1 = warp_min(s);
}

// One warp per pixel; maps (9, h, w) int32: left c0, best, c1, cm, cc, cp,
// right c0, best, c1.
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
wta_kernel(const int16_t* __restrict__ total, int h, int w, int dm,
           int* __restrict__ maps) {
  const size_t plane = (size_t)h * w;
  const size_t pix = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pix >= plane) return;   // warp-uniform
  const int x = (int)(pix % w);
  const int d0 = lane * K;
  const int16_t* t = total + pix * dm;
  int v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = d0 + k < dm ? (int)t[d0 + k] : kPad;
  int c0, best, c1;
  wta3<K>(v, d0, c0, best, c1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    v[k] = d >= dm ? kPad
           : x + d < w ? (int)total[(pix + d) * dm + d] : kRightOutOfRange;
  }
  int r0, rbest, r1;
  wta3<K>(v, d0, r0, rbest, r1);
  if (lane == 0) {
    const int bm = min(max(best, 1), dm - 2);
    maps[pix] = c0;
    maps[plane + pix] = best;
    maps[2 * plane + pix] = c1;
    maps[3 * plane + pix] = t[bm - 1];
    maps[4 * plane + pix] = t[bm];
    maps[5 * plane + pix] = t[bm + 1];
    maps[6 * plane + pix] = r0;
    maps[7 * plane + pix] = rbest;
    maps[8 * plane + pix] = r1;
  }
}

template <int K>
void launch_path(const uint8_t* cost, const int16_t* in, int16_t* out, int h,
                 int w, int dm, int dy, int dx, int p1, int p2,
                 cudaStream_t s) {
  const int n = dy == 0 ? h : dx == 0 ? w : w + h - 1;
  path_kernel<K><<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      cost, in, out, h, w, dm, dy, dx, p1, p2, n);
}

template <int K>
void launch_wta(const int16_t* total, int h, int w, int dm, int* maps,
                cudaStream_t s) {
  const size_t n = (size_t)h * w;
  wta_kernel<K><<<(unsigned)((n + kWarps - 1) / kWarps), kWarps * 32, 0, s>>>(
      total, h, w, dm, maps);
}

// One path family: out = in + L along (dy, dx); in may be null (out = L)
// or equal to out (in place).  Returns cudaGetLastError().
int path(const void* cost, const void* in, void* out, int h, int w, int dm,
         int dy, int dx, int p1, int p2, void* stream) {
  const uint8_t* c = (const uint8_t*)cost;
  const int16_t* a = (const int16_t*)in;
  int16_t* o = (int16_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((dm + 31) / 32) {
    case 1: launch_path<1>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    case 2: launch_path<2>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    case 3: launch_path<3>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    case 4: launch_path<4>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    case 5: launch_path<5>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    case 6: launch_path<6>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    case 7: launch_path<7>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    case 8: launch_path<8>(c, a, o, h, w, dm, dy, dx, p1, p2, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int h, int w, int dm) {
  return h <= 0 || w <= 0 || dm < 4 || dm > 256;
}

}  // namespace

// cost (h, w, dm) uint8 -> out (h, w, dm) int16 = left->right + right->left.
extern "C" int sgm_horizontal_launch(const void* cost, void* out, int h,
                                     int w, int dm, int p1, int p2,
                                     void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  int rc = path(cost, nullptr, out, h, w, dm, 0, 1, p1, p2, stream);
  if (rc == 0) rc = path(cost, out, out, h, w, dm, 0, -1, p1, p2, stream);
  return rc;
}

// out = hsum + down (+ down-right + down-left when diag), int16.
extern "C" int sgm_partial_launch(const void* cost, const void* hsum,
                                  void* out, int h, int w, int dm, int p1,
                                  int p2, int diag, void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  int rc = path(cost, hsum, out, h, w, dm, 1, 0, p1, p2, stream);
  if (diag) {
    if (rc == 0) rc = path(cost, out, out, h, w, dm, 1, 1, p1, p2, stream);
    if (rc == 0) rc = path(cost, out, out, h, w, dm, 1, -1, p1, p2, stream);
  }
  return rc;
}

// total = partial + up (+ up-right + up-left when diag) into the int16
// scratch `total`, then the 9 WTA maps (9, h, w) int32.
extern "C" int sgm_total_wta_launch(const void* cost, const void* partial,
                                    void* total, void* maps, int h, int w,
                                    int dm, int p1, int p2, int diag,
                                    void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  int rc = path(cost, partial, total, h, w, dm, -1, 0, p1, p2, stream);
  if (diag) {
    if (rc == 0) rc = path(cost, total, total, h, w, dm, -1, 1, p1, p2, stream);
    if (rc == 0) rc = path(cost, total, total, h, w, dm, -1, -1, p1, p2, stream);
  }
  if (rc != 0) return rc;
  const int16_t* t = (const int16_t*)total;
  int* m = (int*)maps;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((dm + 31) / 32) {
    case 1: launch_wta<1>(t, h, w, dm, m, s); break;
    case 2: launch_wta<2>(t, h, w, dm, m, s); break;
    case 3: launch_wta<3>(t, h, w, dm, m, s); break;
    case 4: launch_wta<4>(t, h, w, dm, m, s); break;
    case 5: launch_wta<5>(t, h, w, dm, m, s); break;
    case 6: launch_wta<6>(t, h, w, dm, m, s); break;
    case 7: launch_wta<7>(t, h, w, dm, m, s); break;
    case 8: launch_wta<8>(t, h, w, dm, m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
