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
// (up to 1,024 at 768 x 1024), and 2d has only 768 chains, 2e's down
// family 1,024: a few warps an SM.  A step that waits on its own loads
// costs a DRAM round trip (~1,000 SM clocks), so the chain's latency,
// not the card's bytes or operations, sets the time.  The bytes come
// next: at D = 128 a volume pass is 100.7 MB of uint8 cost or 201 MB of
// int16 sums, above the 50 MB L2.  With the loads out of the chain (2d,
// 2e below; tools/probe_sgm.py on an H100) the step's own dependent
// chain, ~190 SM clocks, is about two thirds of 2d's time and under half
// of 2e's; the rest is memory traffic that the ring does not hide.
//
// Design (libSGM's, not the TPU's carry-shift trick): every path family
// is a set of independent 1-D chains (rows for the horizontal paths,
// columns for the vertical ones, the lines x - y = const and x + y = const
// for the diagonals).  One warp walks one chain with the D disparities
// across its lanes and keeps the carry in registers; L(q, d-1) / L(q, d+1)
// across lane borders are one shuffle up and one down.
//
// 2d and 2e (chain_kernel) take the chain's loads out of its dependent
// steps and cut the volume passes:
//  * a ring of the next steps' inputs lives in registers (32 steps for
//    2d's 768 chains, 8 for 2e's 1,024-3,582; half that at D > 128),
//    refilled as each step is done, so a step seldom waits on memory;
//  * the step works on two disparities at once, int16 pairs in 32-bit
//    words, with Hopper's DPX 16x2 instructions (__vimin3_s16x2,
//    __viaddmin_s16x2, __vimax3_s16x2), and m is one redux.sync
//    (__reduce_min_sync) after the lane min;
//  * K, the disparities a lane holds, is 2, 4 or 8, so a lane's K values
//    are one aligned vector load or store where D % K == 0 (D = 128: 4
//    bytes of cost, 8 of int16); another D takes the scalar
//    specialization, chosen from D at launch;
//  * a single path value is <= 64 + P2, exact in uint8 for P2 <= 191 (in
//    int16 above).  The first launch of a stage writes single-path scratch
//    volumes; the last family reads them and writes the stage's int16 sum
//    once, as the TPU kernel folds hf + hb into its vertical pass.  2d:
//    L->R into scratch, then R->L writes scratch + L (604 MB at D = 128,
//    was 805).  2e: down-right and down-left together (2 x 1,791 chains,
//    two scratch volumes), then down writes hsum + dr + dl + L (~1.1 GB,
//    was 1.51).  Every element has one writer per launch and launches run
//    in stream order, so there are no races and no atomics.
//
// path_kernel (2f, 2g) still loads each step in the step, with m from 5
// xor-shuffles, and each family is its own launch that reads an
// accumulator and writes the sum back (in place for the second and third
// family).  2g (sgm_total_launch) is the up-path half of 2f:
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
// Left for later: 2f and 2g on chain_kernel's design (ROADMAP B3), fusing
// the WTA into the up pass.

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
// path_kernel carries the up families of 2f and 2g, one launch each,
// loading each step's cost and accumulator in the step itself; ROADMAP
// queue 2, item B3, moves them onto chain_kernel below.
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

// ---- 2d and 2e: chains whose loads run ahead of the dependent steps ----

// K values of T (uint8_t or int16_t) of one lane, packed into 32-bit words.
// With VEC the lane's K values are one aligned vector, all of them
// disparities or none (D % K == 0); otherwise they move one at a time and
// only the n < K values at d < D are touched.
template <typename T, int K>
struct Pack {
  static constexpr int kBytes = K * (int)sizeof(T);
  static constexpr int kWords = (kBytes + 3) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0;
  }
  __device__ __forceinline__ int get(int k) const {
    if constexpr (sizeof(T) == 1)
      return (int)((w[k >> 2] >> (8 * (k & 3))) & 0xffu);
    else
      return (int)(int16_t)(w[k >> 1] >> (16 * (k & 1)));
  }
  __device__ __forceinline__ void set(int k, int v) {   // after zero()
    if constexpr (sizeof(T) == 1)
      w[k >> 2] |= ((uint32_t)v & 0xffu) << (8 * (k & 3));
    else
      w[k >> 1] |= ((uint32_t)v & 0xffffu) << (16 * (k & 1));
  }
  template <bool VEC>
  __device__ __forceinline__ void load(const T* p, int n) {
    if constexpr (VEC) {
      if (n <= 0) {
        zero();
      } else if constexpr (kBytes == 1) {
        w[0] = *(const uint8_t*)p;
      } else if constexpr (kBytes == 2) {
        w[0] = *(const uint16_t*)p;
      } else if constexpr (kBytes == 4) {
        w[0] = *(const uint32_t*)p;
      } else if constexpr (kBytes == 8) {
        const uint2 v = *(const uint2*)p;
        w[0] = v.x;
        w[1] = v.y;
      } else {
        const uint4 v = *(const uint4*)p;
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      }
    } else {
      zero();
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k < n) set(k, (int)p[k]);
    }
  }
  template <bool VEC>
  __device__ __forceinline__ void store(T* p, int n) const {
    if constexpr (VEC) {
      if (n <= 0) return;
      if constexpr (kBytes == 1) {
        *(uint8_t*)p = (uint8_t)w[0];
      } else if constexpr (kBytes == 2) {
        *(uint16_t*)p = (uint16_t)w[0];
      } else if constexpr (kBytes == 4) {
        *(uint32_t*)p = w[0];
      } else if constexpr (kBytes == 8) {
        *(uint2*)p = make_uint2(w[0], w[1]);
      } else {
        *(uint4*)p = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k < n) p[k] = (T)get(k);
    }
  }
};

// What one step of a chain reads: its cost, and for a family that folds
// the earlier ones in, hsum (int16) and NA single-path volumes of S.
template <int K, typename S, int NA, bool HSUM>
struct Step {
  Pack<uint8_t, K> c;
  Pack<int16_t, K> h;
  Pack<S, K> a[NA > 0 ? NA : 1];
};

// One launch of chain_kernel: n_families path families (dy, dx[f]) of
// n_chains chains each.  Family f writes out[f]: its single-path values
// (S) when the launch writes scratch, else the int16 sum L + hsum +
// add[0..NA) into out[0].
struct Chains {
  const uint8_t* cost;
  const int16_t* hsum;
  const void* add[2];
  void* out[2];
  int h, w, dm, p1, p2;
  int dy, dx[2];
  int n_chains, n_families;
};

// Steps a chain loads ahead.  The card needs some MB in flight to keep
// its memory busy (3.35 TB/s over ~1 us); 2d has 768 chains of 128-256 B
// a step, so it loads 32 steps ahead, while 2e has 1,024 to 3,582 chains
// and loads 8 ahead (tools/probe_sgm.py times both).  At K = 8 the ring
// is half as deep, to keep its registers within bounds.
constexpr int kAhead2d = 32;
constexpr int kAhead2e = 8;
template <int K, int AHEAD>
__host__ __device__ constexpr int ring_steps() {
  return K >= 8 ? AHEAD / 2 : AHEAD;
}

// The step works on pairs of disparities, (d, d + 1) as two int16 halves
// of one 32-bit word, through Hopper's DPX instructions: a 16x2 min of
// three and a 16x2 add-then-min are one instruction each.  Every value
// is in [0, kPad16 + P1] with P1 <= P2 <= 4,031, so no half overflows.
// The output sums add with __vadd2, a per-half add with no carry between
// halves: each half wraps as an int32 add cast to int16 does, whatever
// the sign of the hsum the caller passes.
constexpr unsigned kPad16 = 0x4000u;                // disparities d >= D
constexpr unsigned kPadPair = kPad16 | kPad16 << 16;

__device__ __forceinline__ unsigned pair_of(unsigned v) {
  return v | v << 16;
}
// (hi half of a, lo half of b): the pair one disparity below b's
__device__ __forceinline__ unsigned shift_pair(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5432);
}
// word j (disparities 2j, 2j + 1) of a lane's K values as int16 halves
template <int K>
__device__ __forceinline__ unsigned pair_at(const Pack<uint8_t, K>& p,
                                            int j) {
  return __byte_perm(p.w[j >> 1], 0, (j & 1) ? 0x4342 : 0x4140);
}
template <int K>
__device__ __forceinline__ unsigned pair_at(const Pack<int16_t, K>& p,
                                            int j) {
  return p.w[j];
}
// K / 2 words of int16 pairs (values in [0, 255] for uint8) -> a Pack
template <int K>
__device__ __forceinline__ void from_pairs(Pack<uint8_t, K>& p,
                                           const unsigned* v) {
#pragma unroll
  for (int i = 0; i < Pack<uint8_t, K>::kWords; ++i)
    p.w[i] = __byte_perm(v[2 * i], K / 2 > 2 * i + 1 ? v[2 * i + 1] : 0,
                         0x6420);
}
template <int K>
__device__ __forceinline__ void from_pairs(Pack<int16_t, K>& p,
                                           const unsigned* v) {
#pragma unroll
  for (int i = 0; i < K / 2; ++i) p.w[i] = v[i];
}

// One warp per chain, the D disparities across its lanes (K consecutive
// ones a lane, K = 2, 4 or 8).  A ring of ring_steps<K, AHEAD>() steps
// of inputs lives in registers: step t's slot is refilled with step t + A as
// soon as step t is done, so a step waits on memory only if the chain
// runs ahead of its loads.  The dependent chain of a step is the lane
// min, one redux.sync and three DPX / add instructions; the two shuffles
// for d -+ 1 run beside the redux.  With P1 > P2 the P1 term can never
// undercut m + P2, so P1 is taken as min(P1, P2): the same integers.
template <int K, int AHEAD, bool VEC, typename S, int NA, bool HSUM,
          bool TO_SCRATCH>
__global__ void __launch_bounds__(kWarps * 32)
chain_kernel(const Chains a) {
  constexpr int A = ring_steps<K, AHEAD>();
  constexpr int W = K / 2;   // words of disparity pairs a lane
  const int gid = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gid >= a.n_chains * a.n_families) return;   // warp-uniform
  const int f = gid / a.n_chains;
  const int chain = gid - f * a.n_chains;
  const int h = a.h, w = a.w, dm = a.dm, dy = a.dy, dx = a.dx[f];
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
  // steps until the walk leaves the image (1 to min(h, w) on a diagonal)
  const int len = dy == 0 ? w
                  : dx == 0 ? h
                            : min(dy > 0 ? h - y : y + 1,
                                  dx > 0 ? w - x : x + 1);
  const int d0 = lane * K;
  const int n = dm - d0;   // disparities of this lane: min(n, K), or none
  const long long first = ((long long)y * w + x) * dm + d0;
  const long long stride = ((long long)dy * w + dx) * dm;
  const unsigned p1x2 = pair_of((unsigned)min(a.p1, a.p2));
  const unsigned p2x2 = pair_of((unsigned)a.p2);

  Step<K, S, NA, HSUM> ring[A];
  auto load = [&](Step<K, S, NA, HSUM>& st, int t) {
    const long long o = first + t * stride;
    st.c.template load<VEC>(a.cost + o, n);
    if constexpr (HSUM) st.h.template load<VEC>(a.hsum + o, n);
#pragma unroll
    for (int i = 0; i < NA; ++i)
      st.a[i].template load<VEC>((const S*)a.add[i] + o, n);
  };
#pragma unroll
  for (int s = 0; s < A; ++s)
    if (s < len) load(ring[s], s);

  // kPad16 in the halves at d >= D, 0 elsewhere: the carry before the
  // first step (uniform, so L = c: the restart), and the floor that keeps
  // those halves at kPad16 after every step (their L is <= P2 < kPad16)
  unsigned pad[W];
#pragma unroll
  for (int j = 0; j < W; ++j)
    pad[j] = (2 * j < n ? 0u : kPad16) | (2 * j + 1 < n ? 0u : kPad16 << 16);
  unsigned prev[W];
#pragma unroll
  for (int j = 0; j < W; ++j) prev[j] = pad[j];
  for (int t0 = 0; t0 < len; t0 += A) {
#pragma unroll
    for (int s = 0; s < A; ++s) {
      const int t = t0 + s;
      if (t >= len) break;   // warp-uniform
      unsigned lm = prev[0];
#pragma unroll
      for (int j = 1; j < W; j += 2)
        lm = __vimin3_s16x2(lm, prev[j], j + 1 < W ? prev[j + 1] : prev[j]);
      lm = min(lm & 0xffffu, lm >> 16);
      const unsigned m = __reduce_min_sync(kFull, lm);
      unsigned below = __shfl_up_sync(kFull, prev[W - 1], 1);
      unsigned above = __shfl_down_sync(kFull, prev[0], 1);
      if (lane == 0) below = kPadPair;
      if (lane == 31) above = kPadPair;
      const unsigned negm = pair_of((0u - m) & 0xffffu);
      const Step<K, S, NA, HSUM>& st = ring[s];
      unsigned L[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const unsigned lo = shift_pair(j > 0 ? prev[j - 1] : below, prev[j]);
        const unsigned hi = shift_pair(prev[j], j < W - 1 ? prev[j + 1]
                                                          : above);
        // v = min(L(q, d), L(q, d -+ 1) + P1); L = c + min(v - m, P2)
        const unsigned v =
            __viaddmin_s16x2(__vimin3_s16x2(lo, hi, hi), p1x2, prev[j]);
        L[j] = __vimax3_s16x2(__viaddmin_s16x2(v, negm, p2x2) +
                                  pair_at(st.c, j),
                              pad[j], pad[j]);
      }
      const long long o = first + t * stride;
      if constexpr (TO_SCRATCH) {
        Pack<S, K> out;
        from_pairs<K>(out, L);
        out.template store<VEC>((S*)a.out[f] + o, n);
      } else {
        unsigned sum[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          sum[j] = L[j];
          if constexpr (HSUM) sum[j] = __vadd2(sum[j], pair_at(st.h, j));
#pragma unroll
          for (int i = 0; i < NA; ++i)
            sum[j] = __vadd2(sum[j], pair_at(st.a[i], j));
        }
        Pack<int16_t, K> out;
        from_pairs<K>(out, sum);
        out.template store<VEC>((int16_t*)a.out[0] + o, n);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) prev[j] = L[j];
      if (t + A < len) load(ring[s], t + A);
    }
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

// Launch chain_kernel with K = the power of two >= max(2, ceil(dm / 32))
// and the vector specialization where every lane's K values are aligned
// (D % K == 0 and 16-byte aligned volumes), else the scalar one.  Returns
// cudaGetLastError().
template <int AHEAD, typename S, int NA, bool HSUM, bool TO_SCRATCH>
int launch_chains(const Chains& a, cudaStream_t s) {
  const int k0 = (a.dm + 31) / 32;
  const int k = k0 <= 2 ? 2 : k0 <= 4 ? 4 : 8;
  const uintptr_t ptrs = (uintptr_t)a.cost | (uintptr_t)a.hsum |
                         (uintptr_t)a.add[0] | (uintptr_t)a.add[1] |
                         (uintptr_t)a.out[0] | (uintptr_t)a.out[1];
  const bool vec = a.dm % k == 0 && ptrs % 16 == 0;
  const unsigned blocks = warp_blocks((size_t)a.n_chains * a.n_families);
#define SGM_CHAINS_K(KK)                                                   \
  case KK:                                                                 \
    if (vec)                                                               \
      chain_kernel<KK, AHEAD, true, S, NA, HSUM, TO_SCRATCH>               \
          <<<blocks, kWarps * 32, 0, s>>>(a);                              \
    else                                                                   \
      chain_kernel<KK, AHEAD, false, S, NA, HSUM, TO_SCRATCH>              \
          <<<blocks, kWarps * 32, 0, s>>>(a);                              \
    break;
  switch (k) {
    SGM_CHAINS_K(2)
    SGM_CHAINS_K(4)
    SGM_CHAINS_K(8)
  }
#undef SGM_CHAINS_K
  return (int)cudaGetLastError();
}

// launch_chains with the scratch type: uint8 where a single-path value
// (<= 64 + P2) fits, int16 otherwise (ops/sgm_kernel.scratch_dtype).
template <int AHEAD, int NA, bool HSUM, bool TO_SCRATCH>
int run_chains(const Chains& a, int scratch16, cudaStream_t s) {
  return scratch16
             ? launch_chains<AHEAD, int16_t, NA, HSUM, TO_SCRATCH>(a, s)
             : launch_chains<AHEAD, uint8_t, NA, HSUM, TO_SCRATCH>(a, s);
}

Chains chains_of(const void* cost, int h, int w, int dm, int p1, int p2,
                 int dy) {
  Chains a = {};
  a.cost = (const uint8_t*)cost;
  a.h = h;
  a.w = w;
  a.dm = dm;
  a.p1 = p1;
  a.p2 = p2;
  a.dy = dy;
  a.n_families = 1;
  return a;
}

}  // namespace

// 2d: cost (h, w, dm) uint8 -> out (h, w, dm) int16 = left->right +
// right->left.  Launch 1 writes left->right into `scratch` (h, w, dm) of
// the scratch type; launch 2 walks right->left and writes out = scratch +
// L once.
extern "C" int sgm_horizontal_launch(const void* cost, void* scratch,
                                     void* out, int h, int w, int dm, int p1,
                                     int p2, int scratch16, void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Chains a = chains_of(cost, h, w, dm, p1, p2, 0);
  a.n_chains = h;
  a.dx[0] = 1;
  a.out[0] = scratch;
  int rc = run_chains<kAhead2d, 0, false, true>(a, scratch16, s);
  if (rc != 0) return rc;
  a.dx[0] = -1;
  a.add[0] = scratch;
  a.out[0] = out;
  return run_chains<kAhead2d, 1, false, false>(a, scratch16, s);
}

// 2e: out = hsum + down (+ down-right + down-left when diag), int16.  With
// diag, launch 1 walks both diagonal families (2 x (w + h - 1) chains)
// into the scratch volumes dr and dl (h, w, dm) of the scratch type, and
// launch 2 walks down and writes out = hsum + dr + dl + L once.
extern "C" int sgm_partial_launch(const void* cost, const void* hsum,
                                  void* scratch_dr, void* scratch_dl,
                                  void* out, int h, int w, int dm, int p1,
                                  int p2, int diag, int scratch16,
                                  void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Chains a = chains_of(cost, h, w, dm, p1, p2, 1);
  if (diag) {
    a.n_chains = w + h - 1;
    a.n_families = 2;
    a.dx[0] = 1;
    a.dx[1] = -1;
    a.out[0] = scratch_dr;
    a.out[1] = scratch_dl;
    const int rc = run_chains<kAhead2e, 0, false, true>(a, scratch16, s);
    if (rc != 0) return rc;
    a.n_families = 1;
    a.add[0] = scratch_dr;
    a.add[1] = scratch_dl;
    a.out[1] = nullptr;
  }
  a.n_chains = w;
  a.dx[0] = 0;
  a.hsum = (const int16_t*)hsum;
  a.out[0] = out;
  return diag ? run_chains<kAhead2e, 2, true, false>(a, scratch16, s)
              : launch_chains<kAhead2e, uint8_t, 0, true, false>(a, s);
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
