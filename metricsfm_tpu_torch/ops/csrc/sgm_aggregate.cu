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
// chain_kernel carries every path family (2d, 2e, and the up pass of 2f
// and 2g), taking the chain's loads out of its dependent steps and cutting
// the volume passes:
//  * a ring of the next steps' inputs lives in registers (32 steps for
//    2d's 768 chains, 8 for the vertical stages' 1,024-3,582; half that at
//    D > 128), refilled as each step is done, so a step seldom waits on
//    memory;
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
//    L->R into scratch, then R->L writes scratch + L (604 MB at D = 128).
//    2e walks down, 2f and 2g up, through one launch helper
//    (vertical_paths, dy = +1 / -1): both diagonal families together
//    (2 x (w + h - 1) chains, two scratch volumes), then the vertical
//    family writes base + both + L once (~1.1 GB at D = 128).  Every
//    element has one writer per launch and launches run in stream order,
//    so there are no races and no atomics.
//
// 2f's WTA (wta_tile_kernel) runs after its up pass, over the 8-path total
// kept in device memory (int16).  A block stages one row's columns [x0,
// x0 + T + D - 1) in dynamic shared memory (T = 128 pixels at D <= 128: 64
// KB at D = 128), so the total leaves DRAM about once (201 MB at 768 x
// 1024 x 128; the halo of the next tile is read again, mostly from L2),
// and takes the nine maps of its T pixels from there, one warp a pixel:
//   left:  c0, best (ties -> smallest d), c1 (|d - best| > 1, capped at
//          16000 like the TPU kernel's masked fill), cm/cc/cp at
//          clip(best, 1, D-2) -1/0/+1;
//   right: c0, best, c1 over cost_r(x, d) = total(x + d, d), 30000 where
//          x + d >= W (integer only: it feeds the <= 1 px L/R check).
// c0 and best are one redux.sync a side over a key of value and d, c1 a
// second (wta_pixels).  tools/probe_sgm.py: the staging alone is about
// half of its time.
// 2h (sgm_wta_launch) is the left half alone over any (H, W, D) volume,
// int16, int32 or float32, with the c1 cap as an argument (30000 for an
// integer volume, 1e9 for a float one in ops/sgm.winner_takes_all); the
// TPU kernel's 16-channel packing, its 8000-valued D pads and the
// (8, 128) padding are gone: disparities >= D do not exist.  It reads the
// volume once (201 MB at 768 x 1024 x 128 int16, 0.060 ms at 3.35 TB/s)
// and streams it (wta_stream_kernel): a warp takes 32 pixels, one a step,
// each pixel's D values across its lanes (8 bytes a lane at D = 128
// int16), with the loads kWta2hRing bytes a lane ahead in registers.
// Every reduction is one redux.sync over the whole warp: c0 and best over
// a key of value and d for int16 (two for int32 / float32), c1 one more;
// cm / cc / cp come by shuffle from the lanes that hold them, and each
// map leaves as 32 consecutive words.  One pixel a warp, not the 16-byte
// loads of two pixels a warp: redux.sync gives one result a warp, and a
// per-half-warp member mask compiles to a serialized collective loop
// (tools/probe_sgm.py and the SASS of that design: 0.141-0.148 ms).  So
// the bytes bound it, with the per-pixel instructions beside them
// (tools/probe_sgm.py: loads only, warps a block, ring bytes).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;             // chains per block
constexpr int kC1Cap = 16000;
constexpr int kRightOutOfRange = 30000;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = vmin(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ---- every path family: chains whose loads run ahead of the dependent
// steps ----

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
// a step, so it loads 32 steps ahead, while the vertical stages (2e down,
// the up pass of 2f and 2g) have 1,024 to 3,582 chains and load 8 ahead
// (tools/probe_sgm.py times each).  At K = 8 the ring is half as deep, to
// keep its registers within bounds.
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
// ones a lane, K = 2, 4 or 8).  Chain numbering: rows for dy == 0,
// columns for dx == 0; for a diagonal, chains 0..w-1 start on the first
// row of the walk (column = chain) and chains w..w+h-2 on its first
// column.  A ring of ring_steps<K, AHEAD>() steps of inputs lives in
// registers: step t's slot is refilled with step t + A as soon as step t
// is done, so a step waits on memory only if the chain runs ahead of its
// loads.  The dependent chain of a step is the lane
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

// ---- 2f's WTA: row tiles of the total in shared memory ----

// Pixels of one row a block of wta_tile_kernel takes: kWtaTile at D <= 128,
// half that above, so that the staged (T + D - 1) x D int16 tile stays
// within the 227 KB a block may hold (64 KB at D = 128, 160 KB at D = 256).
constexpr int kWtaTile = 128;
constexpr int kWtaWarps = 8;   // a warp takes T / 8 pixels in turn
constexpr int wta_tile(int dm) {
  return dm <= 128 ? kWtaTile : kWtaTile / 2;
}
size_t wta_tile_bytes(int dm) {
  return (size_t)(wta_tile(dm) + dm - 1) * dm * sizeof(int16_t);
}

// The maps of a warp's pixels xw .. xw + np - 1 (< w) from the staged rows
// (row x at rows + (x - x0) * dm).  Lane l holds the int16 words j = l +
// 32k (k < NW) of a pixel's D values, disparities 2j and 2j + 1.  For an
// even D the left read of word j is one 32-bit load (32 lanes on 32
// consecutive words) and the right read of total(x + d, d) is at word
// (x - x0 + e) * D / 2 + j * (D + 1) for d = 2j + e: an odd lane stride, so
// each read touches 32 banks.  A value v at d is the key (v + 32768) * 256
// + d (one IMAD): the smallest key is the smallest v, ties to the smallest
// d, so c0 and best are one redux.sync a side and c1 a second.  Two pixels
// go through the loop together (their chains interleave); lane i keeps
// pixel i's keys and c1s, and the lanes store the nine maps at the end,
// np consecutive ints a map.  EDGE: some x + d reach w (the last tiles),
// where the right view reads 30000 instead.
template <int NW, bool VEC, bool EDGE>
__device__ __forceinline__ void wta_pixels(const int16_t* rows, int x0,
                                           int xw, int np, int w, int dm,
                                           int lane, int* maps, size_t plane,
                                           size_t pix0) {
  constexpr int E = 2 * NW;   // values a lane holds
  bool on[E];
  int off[E];                 // the right read's offset from the row
  unsigned kd[E];             // 32768 * 256 + d
#pragma unroll
  for (int k = 0; k < NW; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 2 * (lane + 32 * k) + e;
      on[2 * k + e] = d < dm;
      off[2 * k + e] = d * (dm + 1);
      kd[2 * k + e] = (32768u << 8) + (unsigned)d;
    }
  unsigned mkl = 0, mkr = 0;
  int mcl = 0, mcr = 0;
  for (int i0 = 0; i0 < np; i0 += 2) {
    unsigned kl[2], kr[2];
    int vl[2][E], vr[2][E];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int x = xw + i0 + q;   // x >= w: garbage, never stored
      const int16_t* row = rows + (x - x0) * dm;
      kl[q] = kr[q] = UINT_MAX;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if constexpr (VEC) {
          const unsigned pr =
              on[2 * k] ? ((const unsigned*)row)[lane + 32 * k] : 0u;
          vl[q][2 * k] = (int)(int16_t)(pr & 0xffffu);
          vl[q][2 * k + 1] = (int)pr >> 16;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 2 * k + e;
          if (on[u]) {
            if constexpr (!VEC) vl[q][u] = row[2 * (lane + 32 * k) + e];
            vr[q][u] = !EDGE || x + 2 * (lane + 32 * k) + e < w
                           ? (int)row[off[u]] : kRightOutOfRange;
            kl[q] = min(kl[q], (unsigned)(vl[q][u] * 256) + kd[u]);
            kr[q] = min(kr[q], (unsigned)(vr[q][u] * 256) + kd[u]);
          }
        }
      }
      kl[q] = __reduce_min_sync(kFull, kl[q]);
      kr[q] = __reduce_min_sync(kFull, kr[q]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int bl = (int)(kl[q] & 0xffu), br = (int)(kr[q] & 0xffu);
      int cl = kC1Cap, cr = kC1Cap;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const int tl = 2 * (lane + 32 * k) + 1 - bl;   // |d - best| > 1 for
        const int tr = 2 * (lane + 32 * k) + 1 - br;   // d = 2j + e: t + e
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 2 * k + e;
          if (on[u] && (unsigned)(tl + e) > 2u) cl = min(cl, vl[q][u]);
          if (on[u] && (unsigned)(tr + e) > 2u) cr = min(cr, vr[q][u]);
        }
      }
      cl = __reduce_min_sync(kFull, cl);
      cr = __reduce_min_sync(kFull, cr);
      const bool mine = lane == i0 + q;
      mkl = mine ? kl[q] : mkl;
      mkr = mine ? kr[q] : mkr;
      mcl = mine ? cl : mcl;
      mcr = mine ? cr : mcr;
    }
  }
  if (lane < np) {
    const int best = (int)(mkl & 0xffu);
    const int bm = min(max(best, 1), dm - 2);
    const int16_t* row = rows + (xw + lane - x0) * dm;
    const size_t pix = pix0 + lane;
    maps[pix] = (int)(mkl >> 8) - 32768;
    maps[plane + pix] = best;
    maps[2 * plane + pix] = mcl;
    maps[3 * plane + pix] = row[bm - 1];
    maps[4 * plane + pix] = row[bm];
    maps[5 * plane + pix] = row[bm + 1];
    maps[6 * plane + pix] = (int)(mkr >> 8) - 32768;
    maps[7 * plane + pix] = (int)(mkr & 0xffu);
    maps[8 * plane + pix] = mcr;
  }
}

// Block (blockIdx.x, y): pixels x0 .. x0 + T - 1 of row y, x0 =
// blockIdx.x * T.  The block copies total columns [x0, min(x0 + T + D - 1,
// w)) of the row into shared memory (16-byte copies with VEC: D % 8 == 0
// and an aligned volume), then each warp takes T / 8 pixels
// (wta_pixels).
template <int NW, bool VEC>
__global__ void __launch_bounds__(kWtaWarps * 32)
wta_tile_kernel(const int16_t* __restrict__ total, int h, int w, int dm,
                int tile, int* __restrict__ maps) {
  extern __shared__ __align__(16) int16_t rows[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile;
  const int x1 = min(x0 + tile + dm - 1, w);
  const int n = (x1 - x0) * dm;
  const int16_t* src = total + ((size_t)y * w + x0) * dm;
  if constexpr (VEC) {
    constexpr int U = 8;   // 16-byte loads in flight a thread
    const int n16 = n / 8;
    const uint4* s16 = (const uint4*)src;
    uint4* d16 = (uint4*)rows;
    for (int i0 = threadIdx.x; i0 < n16; i0 += U * blockDim.x) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n16) v[u] = s16[i];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n16) d16[i] = v[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) rows[i] = src[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int per_warp = tile / kWtaWarps;   // even, <= 32
  const int xw = x0 + (threadIdx.x >> 5) * per_warp;
  const int np = min(per_warp, w - xw);    // this warp's pixels
  if (np <= 0) return;
  const size_t plane = (size_t)h * w;
  const size_t pix0 = (size_t)y * w + xw;
  if (x0 + tile + dm - 1 <= w)
    wta_pixels<NW, VEC, false>(rows, x0, xw, np, w, dm, lane, maps, plane,
                               pix0);
  else
    wta_pixels<NW, VEC, true>(rows, x0, xw, np, w, dm, lane, maps, plane,
                              pix0);
}

// ---- 2h: the left WTA maps of any volume, streamed ----

constexpr int kWta2hWarps = 4;   // warps a block, 32 pixels a warp
constexpr int kWta2hRing = 32;   // bytes of loads a lane keeps in flight

// A value of the volume as an int that orders as the value does: int16
// and int32 as they are; a float's bits, -0.0 made +0.0 first (an integer
// test, which no build flag folds away) and the bits of a negative float
// xor 0x7fffffff.
__device__ __forceinline__ int order_key(int v) { return v; }
__device__ __forceinline__ int order_key(float f) {
  int b = __float_as_int(f);
  if (b == INT_MIN) b = 0;
  return b >= 0 ? b : b ^ INT_MAX;
}
__device__ __forceinline__ float key_value(int k, float) {
  return __int_as_float(k >= 0 ? k : k ^ INT_MAX);
}
__device__ __forceinline__ int key_value(int k, int) { return k; }

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t u) {
  if constexpr (std::is_same<T, float>::value)
    return __int_as_float((int)u);
  else
    return (T)u;
}
template <typename T>
__device__ __forceinline__ uint32_t to_bits(T v) {
  if constexpr (std::is_same<T, float>::value)
    return (uint32_t)__float_as_int(v);
  else
    return (uint32_t)(int)v;
}

template <int K, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (K > 0) {
    unroll<K - 1>(f);
    f(std::integral_constant<int, K - 1>());
  }
}

// The K values of T a lane holds of one pixel, disparities lane K .. lane
// K + K - 1: with VEC the raw bytes of one aligned vector load, else one
// value a word.  Values at d >= D hold the largest value of T (int16
// 0x7fff, int32 INT_MAX, float32 the bits 0x7fffffff, whose order key is
// INT_MAX): such a value never decides c0, best or c1, as its d is past
// every real one and c1 <= cap.
template <typename T, int K, bool VEC>
struct Lane {
  static constexpr int kBytes = K * (int)sizeof(T);
  static constexpr int kWords = VEC ? (kBytes + 3) / 4 : K;
  uint32_t w[kWords];
  template <int J>
  __device__ __forceinline__ T get() const {
    if constexpr (VEC && sizeof(T) == 2)
      return (T)(w[J >> 1] >> (16 * (J & 1)));
    else
      return from_bits<T>(w[J]);
  }
  // value j (runtime, < K)
  __device__ __forceinline__ T pick(int j) const {
    T r = get<0>();
    unroll<K>([&](auto J) {
      if (decltype(J)::value > 0 && j == decltype(J)::value)
        r = get<decltype(J)::value>();
    });
    return r;
  }
  __device__ __forceinline__ void fill() {
    const uint32_t top = sizeof(T) == 2 ? (VEC ? 0x7fff7fffu : 0x7fffu)
                                        : 0x7fffffffu;
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = top;
  }
  // this lane's values of the pixel at p (n = D - d0 of them are real)
  __device__ __forceinline__ void load(const T* p, int n) {
    if constexpr (VEC) {
      if (n <= 0) return;   // every value past D: the fill stays
      if constexpr (kBytes == 2) {
        w[0] = *(const uint16_t*)p;
      } else if constexpr (kBytes == 4) {
        w[0] = *(const uint32_t*)p;
      } else if constexpr (kBytes == 8) {
        const uint2 v = *(const uint2*)p;
        w[0] = v.x;
        w[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < kBytes / 16; ++i) {
          const uint4 v = ((const uint4*)p)[i];
          w[4 * i] = v.x;
          w[4 * i + 1] = v.y;
          w[4 * i + 2] = v.z;
          w[4 * i + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < n) w[j] = to_bits(p[j]);
    }
  }
};

// Steps of loads a lane keeps in flight: kWta2hRing bytes, 1 to 16 steps.
template <typename T, int K>
__host__ __device__ constexpr int wta2h_ahead() {
  const int a = kWta2hRing / (K * (int)sizeof(T));
  return a < 1 ? 1 : a > 16 ? 16 : a;
}

// 2h: warp w takes the 32 pixels 32 w .. 32 w + 31 of an (n, dm) volume of
// T, one pixel a step, its D values across the warp (K a lane, one vector
// load with VEC: D % K == 0 and an aligned volume; else K scalar loads).
// The loads run wta2h_ahead steps ahead in a register ring.  Each
// reduction is one redux.sync over the whole warp: for int16 c0 and best
// in one over the key (v + 32768) * 256 + d (one IMAD; the smallest key is
// the smallest v, ties to the smallest d); for int32 and float32 (whose
// value does not fit beside d) one over the order key and one over d
// where the key is c0; c1 one more over the values at |d - best| > 1,
// capped at cap.  best is then the same in every lane, so the lanes
// holding clip(best, 1, dm - 2) -1 / 0 / +1 are known to all: one shuffle
// each brings cm / cc / cp.  Lane t keeps step t's results, and at the end
// the lanes store each map as 32 consecutive words.  vals (5, n) of OutT:
// c0, c1, cm, cc, cp; best (n).
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kWta2hWarps * 32)
wta_stream_kernel(const T* __restrict__ vol, long long n, int dm, float cap,
                  typename std::conditional<std::is_same<T, float>::value,
                                            float, int>::type* __restrict__
                      vals,
                  int* __restrict__ best_out) {
  using OutT = typename std::conditional<std::is_same<T, float>::value,
                                         float, int>::type;
  using L = Lane<T, K, VEC>;
  constexpr int A = wta2h_ahead<T, K>();
  const int lane = threadIdx.x & 31;
  const long long base =
      ((long long)blockIdx.x * kWta2hWarps + (threadIdx.x >> 5)) * 32;
  if (base >= n) return;   // warp-uniform
  const int last = (int)min(32LL, n - base);   // pixels of this warp
  const int d0 = lane * K;
  const int real = dm - d0;                    // values of this lane < D
  const T* src = vol + base * dm + d0;
  const int cap_key = std::is_same<T, float>::value ? order_key(cap)
                                                    : (int)cap;

  L ring[A];
#pragma unroll
  for (int s = 0; s < A; ++s) ring[s].fill();
  auto fetch = [&](L& st, int t) {   // warp-uniform test
    if (t < last) st.load(src + (long long)t * dm, real);
  };

  int o_c0 = 0, o_best = 0, o_c1 = 0;   // pixel `lane`'s results (keys)
  OutT o_m = 0, o_c = 0, o_p = 0;
  auto step = [&](const L& st, int t) {
    const bool keeps = lane == t;
    int best;
    if constexpr (sizeof(T) == 2) {
      const unsigned kd = (32768u << 8) + (unsigned)d0;
      unsigned key = UINT_MAX;
      unroll<K>([&](auto J) {
        key = min(key, (unsigned)((int)st.template get<decltype(J)::value>()
                                  * 256) + kd + decltype(J)::value);
      });
      key = __reduce_min_sync(kFull, key);
      best = (int)(key & 0xffu);
      if (keeps) {
        o_c0 = (int)(key >> 8) - 32768;
        o_best = best;
      }
    } else {
      int m = INT_MAX;
      unroll<K>([&](auto J) {
        m = min(m, order_key(st.template get<decltype(J)::value>()));
      });
      const int c0 = __reduce_min_sync(kFull, m);
      int b = INT_MAX;
      unroll<K>([&](auto J) {
        if (order_key(st.template get<decltype(J)::value>()) == c0)
          b = min(b, d0 + decltype(J)::value);
      });
      best = __reduce_min_sync(kFull, b);
      if (keeps) {
        o_c0 = c0;
        o_best = best;
      }
    }
    int c1 = cap_key;
    unroll<K>([&](auto J) {
      if ((unsigned)(d0 + decltype(J)::value - best + 1) > 2u)
        c1 = min(c1, order_key(st.template get<decltype(J)::value>()));
    });
    c1 = __reduce_min_sync(kFull, c1);
    if (keeps) o_c1 = c1;
    // cm / cc / cp: disparity d is value d % K of lane d / K
    const int bm = min(max(best, 1), dm - 2);
    OutT vm, vc, vp;
    if constexpr (VEC && sizeof(T) == 2 && K >= 2) {
      // int16 pairs: bm - 1 .. bm + 1 lie in the two words (bm - 1) / 2
      // and the next, one shuffle each
      const int wa = (bm - 1) >> 1, wb = wa + 1;
      constexpr int WL = K / 2;   // words a lane
      auto word_at = [&](int wi) {
        uint32_t r = st.w[0];
        unroll<WL>([&](auto I) {
          if (decltype(I)::value > 0 && wi % WL == decltype(I)::value)
            r = st.w[decltype(I)::value];
        });
        return __shfl_sync(kFull, r, wi / WL);
      };
      const uint32_t a = word_at(wa), b = word_at(wb);
      const bool odd = (bm - 1) & 1;   // bm - 1 is a's high half
      auto half = [](uint32_t v, bool hi) {
        return hi ? (int)v >> 16 : (int)(int16_t)v;
      };
      vm = half(a, odd);
      vc = odd ? half(b, false) : half(a, true);
      vp = half(b, odd);
    } else {
      vm = __shfl_sync(kFull, (OutT)st.pick((bm - 1) % K), (bm - 1) / K);
      vc = __shfl_sync(kFull, (OutT)st.pick(bm % K), bm / K);
      vp = __shfl_sync(kFull, (OutT)st.pick((bm + 1) % K), (bm + 1) / K);
    }
    if (keeps) {
      o_m = vm;
      o_c = vc;
      o_p = vp;
    }
  };

#pragma unroll
  for (int s = 0; s < A; ++s) fetch(ring[s], s);
  for (int t0 = 0; t0 < 32; t0 += A) {
#pragma unroll
    for (int s = 0; s < A; ++s) {
      step(ring[s], t0 + s);
      fetch(ring[s], t0 + s + A);
    }
  }
  const long long pix = base + lane;
  if (lane < last) {
    vals[pix] = key_value(o_c0, OutT());
    vals[n + pix] = key_value(o_c1, OutT());
    vals[2 * n + pix] = o_m;
    vals[3 * n + pix] = o_c;
    vals[4 * n + pix] = o_p;
    best_out[pix] = o_best;
  }
}

// wta_stream_kernel with K = the power of two >= ceil(dm / 32) values a
// lane and the vector loads where D % K == 0 and the volume is aligned.
template <typename T>
int wta_stream(const void* vol, void* vals, void* best, long long n, int dm,
               float cap, cudaStream_t s) {
  const int k0 = (dm + 31) / 32;
  const int k = k0 <= 1 ? 1 : k0 <= 2 ? 2 : k0 <= 4 ? 4 : 8;
  const bool vec = dm % k == 0 && (uintptr_t)vol % 16 == 0;
  const unsigned blocks =
      (unsigned)((n + 32 * kWta2hWarps - 1) / (32 * kWta2hWarps));
  using OutT = typename std::conditional<std::is_same<T, float>::value,
                                         float, int>::type;
  const T* v = (const T*)vol;
  OutT* o = (OutT*)vals;
  int* b = (int*)best;
#define SGM_WTA2H(KK)                                                       \
  case KK:                                                                  \
    if (vec)                                                                \
      wta_stream_kernel<T, KK, true><<<blocks, kWta2hWarps * 32, 0, s>>>(   \
          v, n, dm, cap, o, b);                                             \
    else                                                                    \
      wta_stream_kernel<T, KK, false><<<blocks, kWta2hWarps * 32, 0, s>>>(  \
          v, n, dm, cap, o, b);                                             \
    break;
  switch (k) {
    SGM_WTA2H(1)
    SGM_WTA2H(2)
    SGM_WTA2H(4)
    SGM_WTA2H(8)
  }
#undef SGM_WTA2H
  return (int)cudaGetLastError();
}

unsigned warp_blocks(size_t n_warps) {
  return (unsigned)((n_warps + kWarps - 1) / kWarps);
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

// The vertical paths onto `base`, int16: 2e walks down (dy = +1), the up
// pass of 2f and 2g walks up (dy = -1).  out = base + the vertical family
// (+ both diagonal families when diag).  With diag, launch 1 walks both
// diagonal families (dx = +1 and -1, 2 x (w + h - 1) chains) into the
// scratch volumes sa and sb (h, w, dm) of the scratch type, and launch 2
// walks the vertical family and writes out = base + sa + sb + L once.
template <int AHEAD>
int vertical_paths(const void* cost, const void* base, void* sa, void* sb,
                   void* out, int h, int w, int dm, int p1, int p2, int diag,
                   int scratch16, int dy, cudaStream_t s) {
  Chains a = chains_of(cost, h, w, dm, p1, p2, dy);
  if (diag) {
    a.n_chains = w + h - 1;
    a.n_families = 2;
    a.dx[0] = 1;
    a.dx[1] = -1;
    a.out[0] = sa;
    a.out[1] = sb;
    const int rc = run_chains<AHEAD, 0, false, true>(a, scratch16, s);
    if (rc != 0) return rc;
    a.n_families = 1;
    a.add[0] = sa;
    a.add[1] = sb;
    a.out[1] = nullptr;
  }
  a.n_chains = w;
  a.dx[0] = 0;
  a.hsum = (const int16_t*)base;
  a.out[0] = out;
  return diag ? run_chains<AHEAD, 2, true, false>(a, scratch16, s)
              : launch_chains<AHEAD, uint8_t, 0, true, false>(a, s);
}

// wta_tile_kernel with NW = ceil(dm / 64) words a lane, its tile and its
// dynamic shared memory (above 48 KB only after cudaFuncSetAttribute).
template <int NW, bool VEC>
int wta_tiles_nw(const void* total, void* maps, int h, int w, int dm,
                 cudaStream_t s) {
  const int tile = wta_tile(dm);
  const size_t bytes = wta_tile_bytes(dm);
  const cudaError_t e = cudaFuncSetAttribute(
      wta_tile_kernel<NW, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((w + tile - 1) / tile), (unsigned)h);
  wta_tile_kernel<NW, VEC><<<grid, kWtaWarps * 32, bytes, s>>>(
      (const int16_t*)total, h, w, dm, tile, (int*)maps);
  return (int)cudaGetLastError();
}

int wta_tiles(const void* total, void* maps, int h, int w, int dm,
              cudaStream_t s) {
  if (h > 65535) return (int)cudaErrorInvalidValue;   // gridDim.y
  const bool vec = dm % 8 == 0 && (uintptr_t)total % 16 == 0;
#define SGM_WTA_NW(NN)                                                     \
  case NN:                                                                 \
    return vec ? wta_tiles_nw<NN, true>(total, maps, h, w, dm, s)          \
               : wta_tiles_nw<NN, false>(total, maps, h, w, dm, s);
  switch ((dm + 63) / 64) {
    SGM_WTA_NW(1)
    SGM_WTA_NW(2)
    SGM_WTA_NW(3)
    SGM_WTA_NW(4)
  }
#undef SGM_WTA_NW
  return (int)cudaErrorInvalidValue;
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

// 2e: out = hsum + down (+ down-right + down-left when diag), int16,
// through the scratch volumes dr and dl with diag (vertical_paths).
extern "C" int sgm_partial_launch(const void* cost, const void* hsum,
                                  void* scratch_dr, void* scratch_dl,
                                  void* out, int h, int w, int dm, int p1,
                                  int p2, int diag, int scratch16,
                                  void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  return vertical_paths<kAhead2e>(cost, hsum, scratch_dr, scratch_dl, out, h,
                                  w, dm, p1, p2, diag, scratch16, 1,
                                  (cudaStream_t)stream);
}

// 2g: total = partial + up (+ up-right + up-left when diag), the full
// 4/8-path sum (h, w, dm) int16, through the scratch volumes ur and ul
// with diag (vertical_paths).
extern "C" int sgm_total_launch(const void* cost, const void* partial,
                                void* scratch_ur, void* scratch_ul,
                                void* total, int h, int w, int dm, int p1,
                                int p2, int diag, int scratch16,
                                void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  return vertical_paths<kAhead2e>(cost, partial, scratch_ur, scratch_ul,
                                  total, h, w, dm, p1, p2, diag, scratch16,
                                  -1, (cudaStream_t)stream);
}

// 2f: the up pass of 2g into the int16 volume `total`, then the 9 WTA
// maps (9, h, w) int32 from row tiles of it (wta_tile_kernel).
extern "C" int sgm_total_wta_launch(const void* cost, const void* partial,
                                    void* scratch_ur, void* scratch_ul,
                                    void* total, void* maps, int h, int w,
                                    int dm, int p1, int p2, int diag,
                                    int scratch16, void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = vertical_paths<kAhead2e>(cost, partial, scratch_ur,
                                          scratch_ul, total, h, w, dm, p1,
                                          p2, diag, scratch16, -1, s);
  if (rc != 0) return rc;
  return wta_tiles(total, maps, h, w, dm, s);
}

// The pixels a block of 2f's WTA takes at this D; *bytes gets its dynamic
// shared memory.
extern "C" int sgm_total_wta_tile(int dm, int* bytes) {
  *bytes = (int)wta_tile_bytes(dm);
  return wta_tile(dm);
}

// 2h: the left WTA maps of a (h, w, dm) volume; dtype 0 = int16, 1 =
// int32 (vals int32), 2 = float32 (vals float32); c1 is capped at `cap`.
extern "C" int sgm_wta_launch(const void* vol, void* vals, void* best, int h,
                              int w, int dm, int dtype, float cap,
                              void* stream) {
  if (bad_shape(h, w, dm)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return wta_stream<int16_t>(vol, vals, best, n, dm, cap, s);
    case 1: return wta_stream<int32_t>(vol, vals, best, n, dm, cap, s);
    case 2: return wta_stream<float>(vol, vals, best, n, dm, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
