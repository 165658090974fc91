// Fixed-order segment sum for Hopper (sm_90a):
//   out[s, c] = sum of values[perm[i], c] for i in [off[s], off[s + 1])
//
// A port-only kernel: it replaces no TPU kernel.  It takes the place of
// the float sums the port used to scatter through atomics (index_add_,
// scatter_add_, index_put_(accumulate=True)): BA's camera, model and
// (point, camera) sums and its PCG matvec (ba/lm.py), k-means' cluster
// sums (ops/kmeans.py) and the Hough accumulator (ops/lines.py).  On the
// card those atomics land in whatever order the warps reach them, so two
// runs on the same inputs differed in the last bits, and BA's loose CG
// solves amplified that into visibly different poses.  The JAX package
// sums by one-hot contractions and XLA segment sums instead.
//
// What bounds it: bytes.  Each kept slot's K values and its perm entry
// are read once, off once, and the (S, K) output is written once; a value
// costs one f64 add, and 16.7 T f64 adds/s are far from binding.  The
// bins' lengths are the data's (a camera model shared by every image puts
// all of BA's observations in one bin; a k-means cell can hold 30 % of
// the descriptors), so the work must be split evenly whatever they are.
//
// Design: merge-path reduce-by-key.  The kept slots, in plan order, and
// the bins' ends form one merged sequence (bin s's end after its last
// slot, at off[s + 1] + s).  Block b takes the kChunk items
// [b kChunk, (b + 1) kChunk) of it, whose first bin and slot the plan
// holds (chunk_bin, made by make_plan with searchsorted), so every block
// has at most kChunk slots and kChunk bins whatever the skew.  A block
// loads its bins' offsets into shared memory, then:
//   * workers walk fixed runs of its slots in order (K <= 16: a thread a
//     run of 4 slots holding K accumulators, its rows' loads issued at
//     once; K > 16: a warp a run of 128 slots, lanes on columns, up to 128
//     columns a pass, 8 rows in flight), adding each bin's slots one
//     after another in double and writing every bin that starts and ends
//     inside the run; a run skips empty bins by binary search;
//   * a bin that crosses runs is finished by a segmented scan of the runs'
//     open sums in run order (shuffles keyed by a ballot of the runs that
//     start a bin, then warps in warp order), added in front of the run
//     that closes it;
//   * a bin that crosses blocks leaves a double partial per block in a
//     carry buffer (the block that holds its first slot writes `tail`,
//     every later one `head`).  The thread or warp that wrote a partial
//     fences it and takes a ticket (an integer atomicAdd on the counter of
//     the block that holds the bin's end); with fewer than kFewPartials
//     partials the one that takes the last ticket adds them in block
//     order, with more the whole last block does (each thread a
//     contiguous range in block order, the ranges by a fixed tree); it
//     rounds once, writes, and resets the counter to 0 for the next
//     launch.  No block waits on another;
//   * empty bins are written 0 by the block that holds their end.
// kChunk 1024 and the blocks an SM holds were chosen on the card
// (tools/probe_segsum.py): 512 is faster where lanes hold columns
// (k-means) and slower where threads hold rows (BA's K 3-9), which is
// most of the main path's launches.
// The integer ticket only elects who adds: the order of every double
// addition depends on off, the kept count and kChunk alone, never on the
// launch or on timing, and each output element is written by exactly one
// thread: no float atomics.  The sums are rounded to the values' type
// once, so a float result is (nearly always) the correctly rounded sum;
// the plain version (ops/segsum.py) adds in the values' type one slot
// after another, as index_add_ does on the CPU, so the two differ by the
// plain version's rounding.  One launch a sum, no zero-fill pass, no host
// read.
//
// values is read through perm (no gathered copy), row i at values + i * ld,
// so a column slice of a wider row-major tensor is read in place.  float
// (every BA and k-means sum) and double (the Hough accumulator, whose
// votes the port sums in double so its peaks keep their CPU parity).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;                 // merged items a block
constexpr int kRowRun = kChunk / kThreads;   // slots a thread walks (K <= 16)
constexpr int kColRun = kChunk / kWarps;     // slots a warp walks (K > 16)
constexpr int kColAhead = 8;                 // rows a lane loads ahead
constexpr int kRowMinBlocks = 3;             // blocks an SM holds at least
constexpr int kColMinBlocks = 3;             // (column mode: 4 at one tile,
                                             // 2 at four: registers)
constexpr int kFewPartials = 8;   // below: the partial's writer adds them
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHead = 1, kCarry = 2;  // the partials a thread or warp wrote

// A block's share of the merged sequence and where its sums go.
struct Share {
  long long b;      // block
  long long i0;     // first slot: perm[i0, i0 + n)
  int n;
  int s0;           // first bin (the head bin)
  int nb;           // bins s0 .. s0 + nb - 1 end here; s0 + nb is the carry bin
  bool open_front;  // bin s0 has slots in earlier blocks
  const int* s_off; // off[s0 ..] in shared memory
  int k;
};

// the first local slot of local bin j (j <= nb)
__device__ __forceinline__ int lo_of(const Share& sh, int j) {
  return j == 0 ? 0 : (int)(sh.s_off[j] - sh.i0);
}

// the largest local bin j in [a, nb] whose first slot is <= p: p's bin
// (lo_of(a) <= p); empty bins between are skipped by the search
__device__ __forceinline__ int bin_of(const Share& sh, int p, int a = 0) {
  int z = sh.nb;
  while (a < z) {
    const int mid = (a + z + 1) >> 1;
    if (lo_of(sh, mid) <= p) a = mid; else z = mid - 1;
  }
  return a;
}

// The block's slots and bins, from the plan's chunk_bin.
__device__ __forceinline__ void share_of(Share& sh, const int* chunk_bin,
                                         int n_bins, long long kept,
                                         long long nblocks, int k,
                                         const int* s_off) {
  sh.k = k;
  sh.s_off = s_off;
  sh.b = blockIdx.x;
  sh.s0 = chunk_bin[sh.b];
  sh.i0 = sh.b * kChunk - sh.s0;
  int s1;
  long long i1;
  if (sh.b + 1 < nblocks) {
    s1 = chunk_bin[sh.b + 1];
    i1 = (sh.b + 1) * kChunk - s1;
  } else {
    s1 = n_bins;
    i1 = kept;
  }
  sh.nb = s1 - sh.s0;
  sh.n = (int)(i1 - sh.i0);
}

// off[s0 ..] into shared memory: the block's bins and the carry bin's end
__device__ __forceinline__ void load_offsets(const Share& sh, const int* off,
                                             int n_bins, int* s_off) {
  const int s_hi = sh.s0 + sh.nb + 1 < n_bins ? sh.s0 + sh.nb + 1 : n_bins;
  for (int j = threadIdx.x; j <= s_hi - sh.s0; j += kThreads)
    s_off[j] = off[sh.s0 + j];
}

// Cross-block bins: which blocks hold a bin's partials (first .. last, the
// counter at last), for the head bin and the carry bin.
struct Cross {
  bool head, carry;
  long long head_first, head_last, carry_last;
};

__device__ __forceinline__ Cross cross_of(const Share& sh, int n_bins) {
  Cross x;
  const long long s0 = sh.s0;
  x.head = sh.open_front;
  x.head_first = (sh.s_off[0] + s0) / kChunk;
  x.head_last = sh.nb >= 1 ? sh.b : (sh.s_off[1] + s0) / kChunk;
  const long long s1 = s0 + sh.nb;
  x.carry = s1 < n_bins && lo_of(sh, sh.nb) < sh.n &&
            !(sh.nb == 0 && sh.open_front);
  x.carry_last = x.carry ? (sh.s_off[sh.nb + 1] + s1) / kChunk : 0;
  return x;
}

// The block's cross-block bins once this thread's partials are written
// (`wrote`): `few(bin, first, last)` adds one of fewer than kFewPartials
// partials in the thread or warp that wrote its partial here, `all(...)`
// one of more in the whole block, if this block takes its last ticket.
// Every thread of the block calls it.
template <typename Few, typename All>
__device__ __forceinline__ void settle(const Share& sh, const Cross& x,
                                       int wrote, int* tickets,
                                       int* s_elect, Few few, All all) {
  const long long s1 = (long long)sh.s0 + sh.nb;
  const bool few_head = x.head_last - x.head_first < kFewPartials;
  const bool few_carry = x.carry_last - sh.b < kFewPartials;
  if ((wrote & kHead) && few_head) few(sh.s0, x.head_first, x.head_last);
  if ((wrote & kCarry) && few_carry) few(s1, sh.b, x.carry_last);
  const bool big_head = x.head && !few_head;
  const bool big_carry = x.carry && !few_carry;
  if (!big_head && !big_carry) return;  // the same in every thread
  if (((wrote & kHead) && big_head) || ((wrote & kCarry) && big_carry))
    __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_elect[0] = big_head && atomicAdd(tickets + x.head_last, 1) ==
                                 (int)(x.head_last - x.head_first);
    s_elect[1] = big_carry &&
                 atomicAdd(tickets + x.carry_last, 1) ==
                     (int)(x.carry_last - sh.b);
  }
  __syncthreads();
  if (s_elect[0]) all(sh.s0, x.head_first, x.head_last);
  if (s_elect[1]) all(s1, sh.b, x.carry_last);
}

// Empty bins ending in the block read 0: element e = j k + c of the
// block's bins, stepped by kThreads without a division a step.  (Bin s0
// ending at the block's first slot is not empty: its partial here is 0.)
template <typename T>
__device__ __forceinline__ void zero_empty(const Share& sh, T* out) {
  const int k = sh.k;
  const int dj = kThreads / k, dc = kThreads % k;
  int j = threadIdx.x / k, c = threadIdx.x % k;
  while (j < sh.nb) {
    if (lo_of(sh, j) == lo_of(sh, j + 1) && !(j == 0 && sh.open_front))
      out[(long long)(sh.s0 + j) * k + c] = T(0);
    j += dj;
    c += dc;
    if (c >= k) {
      c -= k;
      ++j;
    }
  }
}

// A cross-block bin of fewer than kFewPartials partials: the thread (row
// mode) or warp (column mode) that wrote this block's partial fences it
// and takes the ticket; the last to arrive adds the partials in block
// order, writes and puts the counter back to 0.  No block-wide barrier.
template <typename T, int KP>
__device__ void ticket_row(const Share& sh, long long bin, long long first,
                           long long last, const double* head,
                           const double* tail, T* out, int* tickets) {
  int* ticket = tickets + last;
  __threadfence();
  if (atomicAdd(ticket, 1) != (int)(last - first)) return;
  __threadfence();
  double acc[KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) acc[c] = 0.0;
  for (long long i = first; i <= last; ++i) {
    const double* src = (i == first ? tail : head) + i * sh.k;
#pragma unroll
    for (int c = 0; c < KP; ++c)
      if (c < sh.k) acc[c] += __ldcg(src + c);
  }
#pragma unroll
  for (int c = 0; c < KP; ++c)
    if (c < sh.k) out[bin * sh.k + c] = (T)acc[c];
  *ticket = 0;
}

template <typename T, int TN>
__device__ void ticket_col(const Share& sh, long long bin, long long first,
                           long long last, const double* head,
                           const double* tail, T* out, int* tickets) {
  int* ticket = tickets + last;
  const int lane = threadIdx.x & 31;
  __threadfence();
  __syncwarp();
  int elected = 0;
  if (lane == 0) elected = atomicAdd(ticket, 1) == (int)(last - first);
  if (!__shfl_sync(kFull, elected, 0)) return;
  __threadfence();
  for (int c0 = 0; c0 < sh.k; c0 += 32 * TN) {
    double acc[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[t] = 0.0;
    for (long long i = first; i <= last; ++i) {
      const double* src = (i == first ? tail : head) + i * sh.k;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int c = c0 + 32 * t + lane;
        if (c < sh.k) acc[t] += __ldcg(src + c);
      }
    }
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int c = c0 + 32 * t + lane;
      if (c < sh.k) out[bin * sh.k + c] = (T)acc[t];
    }
  }
  if (lane == 0) *ticket = 0;
}

// Row mode (K <= 16): a thread owns kRowRun slots and KP >= K columns.
template <int KP>
struct Vec {
  double c[KP];
};

template <int KP>
__device__ __forceinline__ void zero(Vec<KP>& v) {
#pragma unroll
  for (int c = 0; c < KP; ++c) v.c[c] = 0.0;
}

// val is bin j's sum in this block: the output, or the head partial
template <typename T, int KP>
__device__ __forceinline__ bool finish_row(const Share& sh, int j,
                                           const Vec<KP>& val, T* out,
                                           double* head) {
  if (j == 0 && sh.open_front) {
#pragma unroll
    for (int c = 0; c < KP; ++c)
      if (c < sh.k) __stcg(head + sh.b * sh.k + c, val.c[c]);
    return true;
  }
  T* dst = out + (long long)(sh.s0 + j) * sh.k;
#pragma unroll
  for (int c = 0; c < KP; ++c)
    if (c < sh.k) dst[c] = (T)val.c[c];
  return false;
}

// val is the carry bin's sum in this block (its slots run past the end);
// returns which partial it is
template <int KP>
__device__ __forceinline__ int carry_row(const Share& sh, const Vec<KP>& val,
                                         double* head, double* tail) {
  const bool h = sh.nb == 0 && sh.open_front;
  double* dst = (h ? head : tail) + sh.b * sh.k;
#pragma unroll
  for (int c = 0; c < KP; ++c)
    if (c < sh.k) __stcg(dst + c, val.c[c]);
  return h ? kHead : kCarry;
}

// The elected block adds a cross-block bin's partials: thread t the
// contiguous range t of them in block order, then a fixed shuffle tree and
// the warps in warp order.
template <typename T, int KP>
__device__ void combine_rows(const Share& sh, long long bin, long long first,
                             long long last, const double* head,
                             const double* tail, T* out, int* tickets,
                             double (*s_w)[KP]) {
  __threadfence();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long P = last - first + 1;
  const long long q = (P + kThreads - 1) / kThreads;
  const long long a = first + tid * q;
  const long long z = a + q < last + 1 ? a + q : last + 1;
  Vec<KP> acc;
  zero(acc);
  for (long long i = a; i < z; ++i) {
    const double* src = (i == first ? tail : head) + i * sh.k;
#pragma unroll
    for (int c = 0; c < KP; ++c)
      if (c < sh.k) acc.c[c] += __ldcg(src + c);
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
#pragma unroll
    for (int c = 0; c < KP; ++c)
      acc.c[c] += __shfl_down_sync(kFull, acc.c[c], o);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < KP; ++c) s_w[warp][c] = acc.c[c];
  }
  __syncthreads();
  if (tid < KP && tid < sh.k) {
    double t = s_w[0][tid];
    for (int w = 1; w < kWarps; ++w) t += s_w[w][tid];
    out[bin * sh.k + tid] = (T)t;
  }
  if (tid == 0) tickets[last] = 0;
  __syncthreads();
}

template <typename T, int KP>
__global__ void __launch_bounds__(kThreads, kRowMinBlocks)
    segsum_rows(const T* __restrict__ values, long long ld, int k,
                const int* __restrict__ perm, const int* __restrict__ off,
                int n_bins, long long kept, long long nblocks,
                const int* __restrict__ chunk_bin, int* tickets,
                double* head, double* tail, T* __restrict__ out) {
  __shared__ int s_off[kChunk + 2];
  __shared__ double s_w[kWarps][KP];
  __shared__ double s_first[kThreads][KP];
  __shared__ int s_wf[kWarps];
  __shared__ int s_elect[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Share sh;
  share_of(sh, chunk_bin, n_bins, kept, nblocks, k, s_off);
  // this thread's rows, read before the barrier so their loads need not
  // wait for the block's offsets
  const int p0 = tid * kRowRun;
  const int p1 = p0 + kRowRun < sh.n ? p0 + kRowRun : sh.n;
  int rows[kRowRun];
#pragma unroll
  for (int u = 0; u < kRowRun; ++u)
    rows[u] = p0 + u < p1 ? __ldg(perm + sh.i0 + p0 + u) : 0;
  load_offsets(sh, off, n_bins, s_off);
  __syncthreads();
  sh.open_front = s_off[0] < sh.i0;

  // walk: this thread's run of slots, one bin after another; each slot's
  // bin is found while its row loads, the run's first bin (if it closes
  // here) waits in shared memory for the scan
  Vec<KP> acc;
  zero(acc);
  bool starts = true, closed_first = false, closes_back = false;
  int wrote = 0;
  int j = 0, first_j = 0;
  if (p0 < p1) {
    T v[kRowRun][KP];
#pragma unroll
    for (int u = 0; u < kRowRun; ++u) {
      if (p0 + u < p1) {
        const T* r = values + (long long)rows[u] * ld;
#pragma unroll
        for (int c = 0; c < KP; ++c) v[u][c] = c < k ? __ldg(r + c) : T(0);
      }
    }
    int jn[kRowRun];
    jn[0] = bin_of(sh, p0);
#pragma unroll
    for (int u = 1; u < kRowRun; ++u) {
      int jj = jn[u - 1];
      if (p0 + u < p1 && jj < sh.nb && lo_of(sh, jj + 1) <= p0 + u)
        jj = bin_of(sh, p0 + u, jj + 1);
      jn[u] = jj;
    }
    first_j = jn[0];
    starts = lo_of(sh, first_j) == p0;
#pragma unroll
    for (int u = 0; u < kRowRun; ++u) {
      if (p0 + u < p1) {
        if (u > 0 && jn[u] != jn[u - 1]) {
          if (!closed_first) {
#pragma unroll
            for (int c = 0; c < KP; ++c) s_first[tid][c] = acc.c[c];
            closed_first = true;
          } else {
            finish_row<T, KP>(sh, jn[u - 1], acc, out, head);
          }
          zero(acc);
        }
#pragma unroll
        for (int c = 0; c < KP; ++c) acc.c[c] += (double)v[u][c];
        j = jn[u];
      }
    }
    closes_back = j < sh.nb && lo_of(sh, j + 1) == p1;
  }

  // segmented exclusive scan of the runs' open sums, in run order: a lane
  // adds the lanes o below it while they lie in its segment (no run that
  // starts a bin in between), o = 1, 2, 4, 8, 16 (Kogge-Stone)
  const unsigned heads =
      __ballot_sync(kFull, p0 < p1 && (starts || closed_first));
  const unsigned below = heads & (kFull >> (31 - lane));
  const int seg = below ? 31 - __clz(below) : 0;
  const int pf = (heads & ((1u << lane) - 1u)) != 0;
  Vec<KP> pre;
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    double x = acc.c[c];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(kFull, x, o);
      if (lane - o >= seg) x = u + x;
    }
    pre.c[c] = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) pre.c[c] = 0.0;
    if (lane == 31) s_w[warp][c] = x;
  }
  if (lane == 31) s_wf[warp] = heads != 0;
  __syncthreads();
  if (!pf) {  // the open sum reaches into earlier warps: add them in order
    Vec<KP> wp;
    zero(wp);
    for (int w = 0; w < warp; ++w) {
      if (s_wf[w]) {
#pragma unroll
        for (int c = 0; c < KP; ++c) wp.c[c] = s_w[w][c];
      } else {
#pragma unroll
        for (int c = 0; c < KP; ++c) wp.c[c] = wp.c[c] + s_w[w][c];
      }
    }
#pragma unroll
    for (int c = 0; c < KP; ++c) pre.c[c] = wp.c[c] + pre.c[c];
  }

  // finish the run's first and last bins
  if (p0 < p1) {
    if (closed_first) {
      Vec<KP> first;
#pragma unroll
      for (int c = 0; c < KP; ++c)
        first.c[c] = starts ? s_first[tid][c] : pre.c[c] + s_first[tid][c];
      if (finish_row<T, KP>(sh, first_j, first, out, head)) wrote |= kHead;
    } else if (!starts) {
#pragma unroll
      for (int c = 0; c < KP; ++c) acc.c[c] = pre.c[c] + acc.c[c];
    }
    if (closes_back) {
      if (finish_row<T, KP>(sh, j, acc, out, head)) wrote |= kHead;
    } else if (p1 == sh.n) {
      wrote |= carry_row<KP>(sh, acc, head, tail);
    }
  }

  zero_empty(sh, out);

  // a 0 head partial for bin s0 ending at the block's first slot, then
  // the cross-block bins
  const Cross x = cross_of(sh, n_bins);
  if (tid == 0 && x.head && sh.nb >= 1 && lo_of(sh, 1) == 0) {
#pragma unroll
    for (int c = 0; c < KP; ++c)
      if (c < k) __stcg(head + sh.b * k + c, 0.0);
    wrote |= kHead;
  }
  settle(sh, x, wrote, tickets, s_elect,
         [&](long long bin, long long first, long long last) {
           ticket_row<T, KP>(sh, bin, first, last, head, tail, out, tickets);
         },
         [&](long long bin, long long first, long long last) {
           combine_rows<T, KP>(sh, bin, first, last, head, tail, out, tickets,
                               s_w);
         });
}

// Column mode (K > 16): a warp owns kColRun slots, its lanes columns
// c0 + 32 t + lane (t < TN) of a pass of 32 TN columns.
template <typename T, int TN>
__device__ __forceinline__ bool finish_col(const Share& sh, int j, int c0,
                                           const double (&val)[TN], T* out,
                                           double* head) {
  const int lane = threadIdx.x & 31;
  const bool part = j == 0 && sh.open_front;
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int c = c0 + 32 * t + lane;
    if (c < sh.k) {
      if (part) __stcg(head + sh.b * sh.k + c, val[t]);
      else out[(long long)(sh.s0 + j) * sh.k + c] = (T)val[t];
    }
  }
  return part;
}

template <typename T, int TN>
__device__ void combine_cols(const Share& sh, long long bin, long long first,
                             long long last, const double* head,
                             const double* tail, T* out, int* tickets,
                             double (*s_c)[32 * TN]) {
  __threadfence();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long P = last - first + 1;
  const long long q = (P + kWarps - 1) / kWarps;
  const long long a = first + warp * q;
  const long long z = a + q < last + 1 ? a + q : last + 1;
  for (int c0 = 0; c0 < sh.k; c0 += 32 * TN) {
    double acc[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[t] = 0.0;
    for (long long i = a; i < z; ++i) {
      const double* src = (i == first ? tail : head) + i * sh.k;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int c = c0 + 32 * t + lane;
        if (c < sh.k) acc[t] += __ldcg(src + c);
      }
    }
#pragma unroll
    for (int t = 0; t < TN; ++t) s_c[warp][32 * t + lane] = acc[t];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int c = c0 + 32 * t + lane;
        double s = s_c[0][32 * t + lane];
        for (int w = 1; w < kWarps; ++w) s += s_c[w][32 * t + lane];
        if (c < sh.k) out[bin * sh.k + c] = (T)s;
      }
    }
    __syncthreads();
  }
  if (tid == 0) tickets[last] = 0;
}

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, TN == 1   ? kColMinBlocks + 1
                                            : TN == 4 ? kColMinBlocks - 1
                                                      : kColMinBlocks)
    segsum_cols(const T* __restrict__ values, long long ld, int k,
                const int* __restrict__ perm, const int* __restrict__ off,
                int n_bins, long long kept, long long nblocks,
                const int* __restrict__ chunk_bin, int* tickets,
                double* head, double* tail, T* __restrict__ out) {
  __shared__ int s_perm[kChunk];
  __shared__ int s_off[kChunk + 2];
  __shared__ double s_c[kWarps][32 * TN];
  __shared__ int s_wf[kWarps];
  __shared__ int s_elect[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Share sh;
  share_of(sh, chunk_bin, n_bins, kept, nblocks, k, s_off);
  for (int p = tid; p < sh.n; p += kThreads) s_perm[p] = perm[sh.i0 + p];
  load_offsets(sh, off, n_bins, s_off);
  __syncthreads();
  sh.open_front = s_off[0] < sh.i0;

  const int p0 = warp * kColRun;
  const int p1 = p0 + kColRun < sh.n ? p0 + kColRun : sh.n;
  int wrote = 0;
  for (int c0 = 0; c0 < k; c0 += 32 * TN) {
    double acc[TN], first[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[t] = first[t] = 0.0;
    bool starts = true, closed_first = false, closes_back = false;
    int j = 0, first_j = 0;
    if (p0 < p1) {
      j = bin_of(sh, p0);
      first_j = j;
      starts = lo_of(sh, j) == p0;
      int p = p0;
      for (;;) {
        // bin j's slots in the run: [p, z), kColAhead rows in flight
        const int e = j < sh.nb ? lo_of(sh, j + 1) : p1;
        const int z = e < p1 ? e : p1;
        for (; p < z; p += kColAhead) {
          T v[kColAhead][TN];
#pragma unroll
          for (int u = 0; u < kColAhead; ++u) {
            if (p + u < z) {
              const T* r = values + (long long)s_perm[p + u] * ld;
#pragma unroll
              for (int t = 0; t < TN; ++t) {
                const int c = c0 + 32 * t + lane;
                v[u][t] = c < k ? __ldg(r + c) : T(0);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kColAhead; ++u)
            if (p + u < z)
#pragma unroll
              for (int t = 0; t < TN; ++t) acc[t] += (double)v[u][t];
        }
        p = z;
        if (p >= p1) break;
        // bin j ends at p, inside the run
        if (!closed_first) {
#pragma unroll
          for (int t = 0; t < TN; ++t) first[t] = acc[t];
          closed_first = true;
        } else {
          finish_col<T, TN>(sh, j, c0, acc, out, head);
        }
#pragma unroll
        for (int t = 0; t < TN; ++t) acc[t] = 0.0;
        j = bin_of(sh, p, j + 1);
      }
      closes_back = j < sh.nb && lo_of(sh, j + 1) == p1;
    }

    // the warps' open sums, added in warp order
    if (lane == 0) s_wf[warp] = p0 < p1 && (starts || closed_first);
#pragma unroll
    for (int t = 0; t < TN; ++t) s_c[warp][32 * t + lane] = acc[t];
    __syncthreads();
    if (p0 < p1) {
      if (!starts) {
        double pre[TN];
#pragma unroll
        for (int t = 0; t < TN; ++t) pre[t] = 0.0;
        for (int w = 0; w < warp; ++w) {
          if (s_wf[w]) {
#pragma unroll
            for (int t = 0; t < TN; ++t) pre[t] = s_c[w][32 * t + lane];
          } else {
#pragma unroll
            for (int t = 0; t < TN; ++t)
              pre[t] = pre[t] + s_c[w][32 * t + lane];
          }
        }
        if (closed_first) {
#pragma unroll
          for (int t = 0; t < TN; ++t) first[t] = pre[t] + first[t];
        } else {
#pragma unroll
          for (int t = 0; t < TN; ++t) acc[t] = pre[t] + acc[t];
        }
      }
      if (closed_first &&
          finish_col<T, TN>(sh, first_j, c0, first, out, head))
        wrote |= kHead;
      if (closes_back) {
        if (finish_col<T, TN>(sh, j, c0, acc, out, head)) wrote |= kHead;
      } else if (p1 == sh.n) {
        const bool h = sh.nb == 0 && sh.open_front;
        double* dst = (h ? head : tail) + sh.b * k;
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int c = c0 + 32 * t + lane;
          if (c < k) __stcg(dst + c, acc[t]);
        }
        wrote |= h ? kHead : kCarry;
      }
    }
    __syncthreads();
  }

  zero_empty(sh, out);

  const Cross x = cross_of(sh, n_bins);
  if (warp == 0 && x.head && sh.nb >= 1 && lo_of(sh, 1) == 0) {
    for (int c = lane; c < k; c += 32) __stcg(head + sh.b * k + c, 0.0);
    wrote |= kHead;
  }
  settle(sh, x, wrote, tickets, s_elect,
         [&](long long bin, long long first, long long last) {
           ticket_col<T, TN>(sh, bin, first, last, head, tail, out, tickets);
         },
         [&](long long bin, long long first, long long last) {
           combine_cols<T, TN>(sh, bin, first, last, head, tail, out, tickets,
                               s_c);
         });
}

struct Args {
  const void* values;
  long long ld;
  int k;
  const int* perm;
  const int* off;
  int n_bins;
  long long kept;
  long long nblocks;
  const int* chunk_bin;
  int* tickets;
  double* head;
  double* tail;
  void* out;
  cudaStream_t stream;
};

template <typename T, int KP>
cudaError_t rows(const Args& a) {
  segsum_rows<T, KP><<<(unsigned)a.nblocks, kThreads, 0, a.stream>>>(
      (const T*)a.values, a.ld, a.k, a.perm, a.off, a.n_bins, a.kept,
      a.nblocks, a.chunk_bin, a.tickets, a.head, a.tail, (T*)a.out);
  return cudaGetLastError();
}

template <typename T, int TN>
cudaError_t cols(const Args& a) {
  segsum_cols<T, TN><<<(unsigned)a.nblocks, kThreads, 0, a.stream>>>(
      (const T*)a.values, a.ld, a.k, a.perm, a.off, a.n_bins, a.kept,
      a.nblocks, a.chunk_bin, a.tickets, a.head, a.tail, (T*)a.out);
  return cudaGetLastError();
}

// K <= 16: a thread holds KP >= K columns (K 3, 6, 9 exactly); K > 16:
// passes of up to 4 tiles of 32 columns
template <typename T>
int dispatch(const void* values, long long ld, int k, const void* perm,
             const void* off, int n_bins, long long kept, int chunk,
             const void* chunk_bin, void* tickets, void* carry, void* out,
             void* stream) {
  if (k < 0 || n_bins < 0 || kept < 0 || ld < k || chunk != kChunk)
    return (int)cudaErrorInvalidValue;
  if (k == 0 || n_bins == 0) return 0;
  const long long nblocks = (kept + n_bins + kChunk - 1) / kChunk;
  if (nblocks > INT_MAX) return (int)cudaErrorInvalidValue;
  Args a{values, ld, k, (const int*)perm, (const int*)off, n_bins, kept,
         nblocks, (const int*)chunk_bin, (int*)tickets, (double*)carry,
         (double*)carry + nblocks * k, out, (cudaStream_t)stream};
  if (k <= 1) return (int)rows<T, 1>(a);
  if (k <= 3) return (int)rows<T, 3>(a);
  if (k <= 6) return (int)rows<T, 6>(a);
  if (k <= 9) return (int)rows<T, 9>(a);
  if (k <= 16) return (int)rows<T, 16>(a);
  if (k <= 32) return (int)cols<T, 1>(a);
  if (k <= 64) return (int)cols<T, 2>(a);
  if (k <= 96) return (int)cols<T, 3>(a);
  return (int)cols<T, 4>(a);
}

}  // namespace

// values (rows, ld) with k <= ld columns read; perm int32 slot -> row; off
// (n_bins + 1) int32 nondecreasing with off[n_bins] == kept; chunk_bin
// (>= nblocks + 1) int32, the bins ending before each block's first item;
// tickets (>= nblocks) int32, 0 on entry and on return; carry
// (2 nblocks k) double scratch; out (n_bins, k) of the values' type;
// nblocks = ceil((kept + n_bins) / chunk), chunk == kChunk.
extern "C" int segsum_f32_launch(const void* values, long long ld, int k,
                                 const void* perm, const void* off,
                                 int n_bins, long long kept, int chunk,
                                 const void* chunk_bin, void* tickets,
                                 void* carry, void* out, void* stream) {
  return dispatch<float>(values, ld, k, perm, off, n_bins, kept, chunk,
                         chunk_bin, tickets, carry, out, stream);
}

extern "C" int segsum_f64_launch(const void* values, long long ld, int k,
                                 const void* perm, const void* off,
                                 int n_bins, long long kept, int chunk,
                                 const void* chunk_bin, void* tickets,
                                 void* carry, void* out, void* stream) {
  return dispatch<double>(values, ld, k, perm, off, n_bins, kept, chunk,
                          chunk_bin, tickets, carry, out, stream);
}
