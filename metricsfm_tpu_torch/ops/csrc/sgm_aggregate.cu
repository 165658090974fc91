// SGM path aggregation and winner-takes-all for Hopper (sm_90a).
//
// Replaces five TPU kernels of metricsfm_tpu/ops/pallas/sgm_kernel.py:
//   sgm_horizontal_launch  <- _horizontal_kernel   (via _horizontal_pass)
//   sgm_partial_launch     <- _vertical_fwd_kernel (via _partial_sum)
//   sgm_total_wta_launch   <- _vertical_bwd_kernel (via aggregate_wta_pallas)
//   sgm_total_launch       <- _vertical_bwd_total_kernel
//                             (via aggregate_paths_pallas)
//   sgm_wta_launch         <- _wta_kernel          (via wta_pallas)
// with the semantics of the JAX package's stereo branches:
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
// atomics are needed.  2g (sgm_total_launch) is the up-path half of 2f:
// the same three launches onto the partial sum, with the total volume as
// its output.  The WTA epilogue of 2f is a second kernel, one warp per
// pixel, over the 8-path total kept in device memory (int16):
//   left:  c0, best (ties -> smallest d), c1 (|d - best| > 1, capped at
//          16000 like the TPU kernel's masked fill), cm/cc/cp at
//          clip(best, 1, D-2) -1/0/+1;
//   right: c0, best, c1 over cost_r(x, d) = total(x + d, d), 30000 where
//          x + d >= W (integer only: it feeds the <= 1 px L/R check).
// 2h (sgm_wta_launch) is the left half alone over any (H, W, D) volume,
// int16, int32 or float32, with the c1 cap as an argument (30000 for an
// integer volume, 1e9 for a float one in ops/sgm.winner_takes_all); the
// TPU kernel's 16-channel packing, its 8000-valued D pads and the
// (8, 128) padding are gone: disparities >= D do not exist.  It reads the
// volume once (200 MB at 768 x 1024 x 128 int16, 60 us at 3.35 TB/s) and
// is bound by the warp reductions per pixel (3 x 5 shuffles).
// Left for later: fusing the WTA into the up pass, prefetching the next
// step's cost and accumulator, shared-memory tiling, cp.async / TMA.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;             // chains (or pixels) per block
constexpr int kPad = 1 << 24;         // disparities d >= D
constexpr int kC1Cap = 16000;
constexpr int kRightOutOfRange = 30000;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T type_max();
template <>
__device__ __forceinline__ int type_max<int>() { return INT_MAX; }
template <>
__device__ __forceinline__ float type_max<float>() { return INFINITY; }

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = vmin(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Run the statement with the compile-time K = ceil(dm / 32) disparities
// per lane; a D above 256 returns cudaErrorInvalidValue from the caller.
#define SGM_DISPATCH_K(dm, ...)                              \
  switch (((dm) + 31) / 32) {                                \
    case 1: { constexpr int K = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int K = 2; __VA_ARGS__; } break;     \
    case 3: { constexpr int K = 3; __VA_ARGS__; } break;     \
    case 4: { constexpr int K = 4; __VA_ARGS__; } break;     \
    case 5: { constexpr int K = 5; __VA_ARGS__; } break;     \
    case 6: { constexpr int K = 6; __VA_ARGS__; } break;     \
    case 7: { constexpr int K = 7; __VA_ARGS__; } break;     \
    case 8: { constexpr int K = 8; __VA_ARGS__; } break;     \
    default: return (int)cudaErrorInvalidValue;              \
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
// capped at `cap`, of one pixel's values spread K per lane (lane values
// at d >= dm are not disparities and are never read).
template <typename T, int K>
__device__ __forceinline__ void wta3(const T v[K], int d0, int dm, T cap,
                                     T& c0, int& best, T& c1) {
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) on[k] = d0 + k < dm;
  T m = type_max<T>();
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (on[k]) m = vmin(m, v[k]);
  c0 = warp_min(m);
  int b = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (on[k] && v[k] == c0) b = min(b, d0 + k);
  best = warp_min(b);
  T s = cap;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (on[k] && abs(d0 + k - best) > 1) s = vmin(s, v[k]);
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
  for (int k = 0; k < K; ++k) v[k] = d0 + k < dm ? (int)t[d0 + k] : 0;
  int c0, best, c1;
  wta3<int, K>(v, d0, dm, kC1Cap, c0, best, c1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    v[k] = d >= dm ? 0
           : x + d < w ? (int)total[(pix + d) * dm + d] : kRightOutOfRange;
  }
  int r0, rbest, r1;
  wta3<int, K>(v, d0, dm, kC1Cap, r0, rbest, r1);
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

// 2h: one warp per pixel of an (n, dm) volume of T, compared in C (int for
// the integer volumes, float for float32).  vals (5, n) of C: c0, c1, cm,
// cc, cp; best (n) int32.
template <typename T, typename C, int K>
__global__ void __launch_bounds__(kWarps * 32)
wta_maps_kernel(const T* __restrict__ vol, size_t n, int dm, C cap,
                C* __restrict__ vals, int* __restrict__ best_out) {
  const size_t pix = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pix >= n) return;   // warp-uniform
  const int d0 = lane * K;
  const T* t = vol + pix * dm;
  C v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = d0 + k < dm ? (C)t[d0 + k] : cap;
  C c0, c1;
  int best;
  wta3<C, K>(v, d0, dm, cap, c0, best, c1);
  if (lane == 0) {
    const int bm = min(max(best, 1), dm - 2);
    vals[pix] = c0;
    vals[n + pix] = c1;
    vals[2 * n + pix] = (C)t[bm - 1];
    vals[3 * n + pix] = (C)t[bm];
    vals[4 * n + pix] = (C)t[bm + 1];
    best_out[pix] = best;
  }
}

unsigned warp_blocks(size_t n_warps) {
  return (unsigned)((n_warps + kWarps - 1) / kWarps);
}

// One path family: out = in + L along (dy, dx); in may be null (out = L)
// or equal to out (in place).  Returns cudaGetLastError().
int path(const void* cost, const void* in, void* out, int h, int w, int dm,
         int dy, int dx, int p1, int p2, void* stream) {
  const int n = dy == 0 ? h : dx == 0 ? w : w + h - 1;
  SGM_DISPATCH_K(dm, path_kernel<K><<<warp_blocks(n), kWarps * 32, 0,
                                      (cudaStream_t)stream>>>(
      (const uint8_t*)cost, (const int16_t*)in, (int16_t*)out, h, w, dm, dy,
      dx, p1, p2, n));
  return (int)cudaGetLastError();
}

// The up half of the aggregation: total = partial + up (+ up-right +
// up-left when diag), int16 (2g, and the first half of 2f).
int up_paths(const void* cost, const void* partial, void* total, int h,
             int w, int dm, int p1, int p2, int diag, void* stream) {
  int rc = path(cost, partial, total, h, w, dm, -1, 0, p1, p2, stream);
  if (diag) {
    if (rc == 0) rc = path(cost, total, total, h, w, dm, -1, 1, p1, p2, stream);
    if (rc == 0) rc = path(cost, total, total, h, w, dm, -1, -1, p1, p2, stream);
  }
  return rc;
}

template <typename T, typename C>
int wta_maps(const void* vol, void* vals, void* best, size_t n, int dm,
             C cap, cudaStream_t s) {
  SGM_DISPATCH_K(dm, wta_maps_kernel<T, C, K><<<warp_blocks(n), kWarps * 32,
                                                0, s>>>(
      (const T*)vol, n, dm, cap, (C*)vals, (int*)best));
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

// 2g: total = partial + up (+ up-right + up-left when diag), the full
// 4/8-path sum (h, w, dm) int16.
extern "C" int sgm_total_launch(const void* cost, const void* partial,
                                void* total, int h, int w, int dm, int p1,
                                int p2, int diag, void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  return up_paths(cost, partial, total, h, w, dm, p1, p2, diag, stream);
}

// 2f: the up paths of 2g into the int16 scratch `total`, then the 9 WTA
// maps (9, h, w) int32.
extern "C" int sgm_total_wta_launch(const void* cost, const void* partial,
                                    void* total, void* maps, int h, int w,
                                    int dm, int p1, int p2, int diag,
                                    void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  int rc = up_paths(cost, partial, total, h, w, dm, p1, p2, diag, stream);
  if (rc != 0) return rc;
  SGM_DISPATCH_K(dm, wta_kernel<K><<<warp_blocks((size_t)h * w),
                                     kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int16_t*)total, h, w, dm, (int*)maps));
  return (int)cudaGetLastError();
}

// 2h: the left WTA maps of a (h, w, dm) volume; dtype 0 = int16, 1 =
// int32 (vals int32), 2 = float32 (vals float32); c1 is capped at `cap`.
extern "C" int sgm_wta_launch(const void* vol, void* vals, void* best, int h,
                              int w, int dm, int dtype, float cap,
                              void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return wta_maps<int16_t, int>(vol, vals, best, n, dm, (int)cap, s);
    case 1: return wta_maps<int32_t, int>(vol, vals, best, n, dm, (int)cap, s);
    case 2: return wta_maps<float, float>(vol, vals, best, n, dm, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
