// Fixed-order segment sum for Hopper (sm_90a):
//   out[s, c] = sum of values[perm[i], c] for i in [off[s], off[s + 1])
//
// A port-only kernel: no TPU kernel corresponds to it.  It takes the place
// of the float sums the port used to scatter through atomics
// (index_add_, scatter_add_, index_put_(accumulate=True)): BA's camera,
// model and (point, camera) sums and its PCG matvec (ba/lm.py), k-means'
// cluster sums (ops/kmeans.py) and the Hough accumulator (ops/lines.py).
// On the card those atomics land in whatever order the warps reach them,
// so two runs on the same inputs differed in the last bits, and BA's
// loose CG solves amplified that into visibly different poses.  The JAX
// package sums by one-hot contractions and XLA segment sums instead.
//
// Order: one warp owns one (segment, tile of W columns).  Its 32 lanes
// form G = 32 / W groups of W lanes; group g adds slots off[s] + g,
// off[s] + g + G, ... in that order, then a fixed __shfl_down_sync tree
// folds the groups (offsets 16, 8, ..., W) and group 0 writes.  The tree's
// shape depends only on off and K (W is the smallest power of two >= K,
// at most 32), never on the launch or on timing, and each output element
// is written by exactly one thread: no atomics.  The sums run in double
// and are rounded to the values' type once, so a float result is (nearly
// always) the correctly rounded sum; the plain version (ops/segsum.py)
// adds in the values' type one slot after another, as index_add_ does on
// the CPU, so the two differ by the plain version's rounding.
//
// values is read through perm (no gathered copy), row i at values + i * ld,
// so a column slice of a wider row-major tensor is read in place.  Empty
// segments write 0.  float (every BA and k-means sum) and double (the
// Hough accumulator, whose votes the port sums in double as it did before
// the kernel, so its peaks keep their CPU parity).
//
// What bounds it: the bytes (each kept slot's K floats and its perm entry
// read once, off read once, the (S, K) output written once); a slot costs
// one double add a column.  Design for that: consecutive lanes read
// consecutive columns of one row (W floats, a 32-byte sector at W = 8);
// slots are walked with four loads in flight.  A long segment is walked by
// one warp (a skewed k-means cluster, a camera seen by every point):
// correct, and the first thing to split if a profile asks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    segsum_kernel(const T* __restrict__ values, int64_t ld, int k,
                  const int* __restrict__ perm, const int* __restrict__ off,
                  int n_seg, T* __restrict__ out) {
  constexpr int G = 32 / W;
  const int64_t seg =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= n_seg) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int g = lane / W;
  const int col = blockIdx.y * W + lane % W;
  const int lo = off[seg];
  const int hi = off[seg + 1];
  double acc = 0.0;
  if (col < k) {
#pragma unroll 4
    for (int i = lo + g; i < hi; i += G)
      acc += (double)__ldg(values + (int64_t)__ldg(perm + i) * ld + col);
  }
#pragma unroll
  for (int o = 16; o >= W; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (g == 0 && col < k) out[seg * k + col] = (T)acc;
}

template <typename T, int W>
cudaError_t launch(const T* values, int64_t ld, int k, const int* perm,
                   const int* off, int n_seg, T* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((k + W - 1) / W));
  segsum_kernel<T, W><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      values, ld, k, perm, off, n_seg, out);
  return cudaGetLastError();
}

// W: the smallest power of two >= k, at most 32
template <typename T>
int dispatch(const void* values, long long ld, int k, const void* perm,
             const void* off, int n_seg, void* out, void* stream) {
  if (k < 0 || n_seg < 0 || ld < k || (k + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  if (k == 0 || n_seg == 0) return 0;
  const T* v = (const T*)values;
  const int* p = (const int*)perm;
  const int* o = (const int*)off;
  T* d = (T*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 1) return (int)launch<T, 1>(v, ld, k, p, o, n_seg, d, s);
  if (k <= 2) return (int)launch<T, 2>(v, ld, k, p, o, n_seg, d, s);
  if (k <= 4) return (int)launch<T, 4>(v, ld, k, p, o, n_seg, d, s);
  if (k <= 8) return (int)launch<T, 8>(v, ld, k, p, o, n_seg, d, s);
  if (k <= 16) return (int)launch<T, 16>(v, ld, k, p, o, n_seg, d, s);
  return (int)launch<T, 32>(v, ld, k, p, o, n_seg, d, s);
}

}  // namespace

// values (rows, ld) with k <= ld columns read; perm int32 slot -> row; off
// (n_seg + 1) int32 nondecreasing; out (n_seg, k) of the values' type.
extern "C" int segsum_f32_launch(const void* values, long long ld, int k,
                                 const void* perm, const void* off, int n_seg,
                                 void* out, void* stream) {
  return dispatch<float>(values, ld, k, perm, off, n_seg, out, stream);
}

extern "C" int segsum_f64_launch(const void* values, long long ld, int k,
                                 const void* perm, const void* off, int n_seg,
                                 void* out, void* stream) {
  return dispatch<double>(values, ld, k, perm, off, n_seg, out, stream);
}
