// Bundle adjustment's dense-Schur reduce for Hopper (sm_90a): from the
// linearize kernel's outputs (ops/csrc/ba_linearize.cu: r, J_pose, J_intr
// and J_pt of every (p, v) observation slot, already scaled by the track,
// mask and Huber weights), everything the dense path's segment sums and
// back-substitution need, in one launch (ba/lm.partial_camera_system):
//
//   per point p, a sum over its V slots in slot order (no atomics):
//     Hpp = sum J_pt^T J_pt and g_pt = sum J_pt^T r; Hpp_d = Hpp with
//     lam * max(diag, 1e-12) + 1e-12 added to its diagonal, the identity
//     where point_mut is 0; Hpp_inv = adj(Hpp_d) / det, |det| clamped at
//     1e-12 (ops/ba_reduce_slots.inv3x3); L = chol(Hpp_inv) (chol3x3);
//     y = Hpp_inv g_pt.  Written: Hpp_inv (P, 3, 3) and g_pt (P, 3).
//   per slot, with Jc = [J_pose | J_intr] (2 x 9):
//     W = Jc^T J_pt point_mut (9 x 3) and U = W L (9 x 3);
//     the camera row [J_pose^T J_pose (36) | J_pose^T J_intr (18) | rv[0:6]]
//     and the model row [J_intr^T J_intr (9) | rv[6:9]], where
//     rv = W y - Jc^T r, so that the right-hand side is the sum of rv.
//
// A port-only kernel: it replaces no TPU kernel.  The JAX package writes
// these products as einsums against one-hot operands
// (metricsfm_tpu/ba/lm.py:274-339), which XLA fuses.  In eager PyTorch the
// einsums of partial_camera_system ran as cuBLAS batched GEMMs and GEMVs
// over 2-row operands (6 x 6 results in 32 x 32 tiles) and _inv3x3 /
// _chol3x3 as ~80 elementwise launches over the points; this kernel takes
// the place of all of them on the card.  The plain version,
// ops/ba_reduce_slots.reduce_slots_plain, is that composition.
//
// What bounds it: bytes.  A slot reads 26 values and writes 126 (W 27,
// U 27, camera row 60, model row 12); a point reads point_mut and writes
// 12.  At the BA cell's 524,288 slots (32,768 points x V 16) in float32:
// 55 MB read and 266 MB written, 0.096 ms at 3.35 TB/s.  Its ~700 flops a
// slot are far from the card's rates.
//
// Design: a block takes NT / V whole points (one point for V > NT) and
// one thread a slot (for V > NT, slots t, t + NT, ...).  Each thread adds
// its slots' J_pt^T J_pt and J_pt^T r into 9 partials in shared memory;
// one thread a point adds its partials in slot order, then inverts,
// factors and writes the point (so a point's sums, and every value made
// from them, do not depend on the launch's shape beyond V).  Each slot's
// outputs are then written to shared memory at an odd row stride (no bank
// conflicts) and copied out by the whole block as contiguous runs, so
// every warp's store covers whole sectors.  A masked slot's inputs are
// zero (the linearize kernel writes them so), and so are its outputs.
// Float32 and float64 (the problem's own type); no fast-math intrinsics.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads a block: 256 in float32, 128 in float64, so that the staging
// buffer (27 values a thread) is 27 KB in either.
template <typename T>
struct Threads {
  static constexpr int value = sizeof(T) == 4 ? 256 : 128;
};

constexpr int kStageRow = 27;   // the staging buffer's values a thread
constexpr int kPoint = 10;      // a point in shared memory: L (6), y, pm

__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float mabs(float x) { return fabsf(x); }
__device__ __forceinline__ double mabs(double x) { return fabs(x); }

// max(x, lo) as torch.clamp(min=lo) gives it: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// Rows [0, cnt) of width R of the block's current run of slots, row q
// from thread q (where `has`), to dst (row-major, contiguous): in passes
// of PS rows, each thread writes its row to the staging buffer at the odd
// stride RP, then the block copies the pass's PS * R values out in order.
template <typename T, int NT, int R, typename F>
__device__ __forceinline__ void put_rows(T* __restrict__ dst, T* stage,
                                         int cnt, bool has, F value) {
  constexpr int RP = R | 1;
  constexpr int fit = NT * kStageRow / RP;
  constexpr int PS = fit >= NT ? NT : fit / 32 * 32;
  static_assert(PS > 0, "a staging pass holds no row");
  const int t = threadIdx.x;
  for (int p0 = 0; p0 < cnt; p0 += PS) {
    const int q = t - p0;
    if (has && q >= 0 && q < PS) {
#pragma unroll
      for (int k = 0; k < R; ++k) stage[q * RP + k] = value(k);
    }
    __syncthreads();
    const int m = min(PS, cnt - p0) * R;
    T* d = dst + (long long)p0 * R;
    for (int e = t; e < m; e += NT) d[e] = stage[(e / R) * RP + e % R];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(Threads<T>::value) ba_reduce_slots_kernel(
    const T* __restrict__ r_in, const T* __restrict__ jpo_in,
    const T* __restrict__ jin_in, const T* __restrict__ jpt_in,
    const T* __restrict__ point_mut, long long n_points, int views,
    int pts_per_block, T lam, T* __restrict__ hinv_out,
    T* __restrict__ gpt_out, T* __restrict__ w_out, T* __restrict__ u_out,
    T* __restrict__ cam_out, T* __restrict__ model_out) {
  constexpr int NT = Threads<T>::value;
  __shared__ T buf[NT * kStageRow];    // partials [9][NT], then staging
  __shared__ T pts[NT * kPoint];
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * pts_per_block;
  const long long left = n_points - p0;
  const int np = left < pts_per_block ? (int)left : pts_per_block;
  const int n = np * views;                  // the block's slots
  const long long slot0 = p0 * views;
  const T eps = T(1e-12);

  // ---- partials: J_pt^T J_pt (6 upper entries) and J_pt^T r ----
  T acc[9] = {};
  for (int s = t; s < n; s += NT) {
    const long long i = slot0 + s;
    T a[6], b[2];
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = __ldg(jpt_in + 6 * i + k);
    b[0] = __ldg(r_in + 2 * i);
    b[1] = __ldg(r_in + 2 * i + 1);
    int q = 0;
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int y = x; y < 3; ++y)
        acc[q++] += a[x] * a[y] + a[3 + x] * a[3 + y];
#pragma unroll
    for (int x = 0; x < 3; ++x) acc[6 + x] += a[x] * b[0] + a[3 + x] * b[1];
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) buf[q * NT + t] = acc[q];
  __syncthreads();

  // ---- one thread a point: sums in slot order, inverse, factor ----
  if (t < np) {
    const int npart = views <= NT ? views : NT;
    T s[9] = {};
    for (int k = 0; k < npart; ++k)
#pragma unroll
      for (int q = 0; q < 9; ++q) s[q] += buf[q * NT + t * npart + k];
    const long long p = p0 + t;
    const T pm = __ldg(point_mut + p);
    T H[3][3] = {{s[0], s[1], s[2]}, {s[1], s[3], s[4]}, {s[2], s[4], s[5]}};
#pragma unroll
    for (int d = 0; d < 3; ++d)
      H[d][d] = H[d][d] + (lam * clamp_min(H[d][d], eps) + eps);
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int y = 0; y < 3; ++y)
        H[x][y] = H[x][y] * pm + (x == y ? T(1) - pm : T(0));
    const T a = H[0][0], b = H[0][1], c = H[0][2];
    const T d = H[1][0], e = H[1][1], f = H[1][2];
    const T g = H[2][0], h = H[2][1], k = H[2][2];
    const T adj[9] = {e * k - f * h, c * h - b * k, b * f - c * e,
                      f * g - d * k, a * k - c * g, c * d - a * f,
                      d * h - e * g, b * g - a * h, a * e - b * d};
    T det = a * adj[0] + b * adj[3] + c * adj[6];
    det = mabs(det) < eps ? eps : det;
    T inv[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) inv[q] = adj[q] / det;
    const T gp[3] = {s[6], s[7], s[8]};
    // chol3x3 of the inverse, from its lower entries
    const T l11 = msqrt(clamp_min(inv[0], eps));
    const T l21 = inv[3] / l11;
    const T l31 = inv[6] / l11;
    const T l22 = msqrt(clamp_min(inv[4] - l21 * l21, eps));
    const T l32 = (inv[7] - l31 * l21) / l22;
    const T l33 = msqrt(clamp_min(inv[8] - l31 * l31 - l32 * l32, eps));
    T* P = pts + t * kPoint;
    P[0] = l11; P[1] = l21; P[2] = l22; P[3] = l31; P[4] = l32; P[5] = l33;
#pragma unroll
    for (int x = 0; x < 3; ++x)
      P[6 + x] = inv[3 * x] * gp[0] + inv[3 * x + 1] * gp[1] +
                 inv[3 * x + 2] * gp[2];
    P[9] = pm;
#pragma unroll
    for (int q = 0; q < 9; ++q) hinv_out[9 * p + q] = inv[q];
#pragma unroll
    for (int x = 0; x < 3; ++x) gpt_out[3 * p + x] = gp[x];
  }
  __syncthreads();

  // ---- per slot: W, U, the camera and model rows, staged out ----
  for (int c0 = 0; c0 < n; c0 += NT) {
    const int s = c0 + t;
    const bool has = s < n;
    const int cnt = min(NT, n - c0);
    T po[12] = {}, in[6] = {}, pt[6] = {}, rr[2] = {};
    T L[6] = {}, y[3] = {}, pm = T(0);
    if (has) {
      const long long i = slot0 + s;
#pragma unroll
      for (int k = 0; k < 12; ++k) po[k] = __ldg(jpo_in + 12 * i + k);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        in[k] = __ldg(jin_in + 6 * i + k);
        pt[k] = __ldg(jpt_in + 6 * i + k);
      }
      rr[0] = __ldg(r_in + 2 * i);
      rr[1] = __ldg(r_in + 2 * i + 1);
      const T* P = pts + (views <= NT ? s / views : 0) * kPoint;
#pragma unroll
      for (int k = 0; k < 6; ++k) L[k] = P[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) y[k] = P[6 + k];
      pm = P[9];
    }
    // Jc's column x, row 0 and row 1
    auto jc0 = [&](int x) { return x < 6 ? po[x] : in[x - 6]; };
    auto jc1 = [&](int x) { return x < 6 ? po[6 + x] : in[3 + x - 6]; };
    T W[27];
#pragma unroll
    for (int x = 0; x < 9; ++x)
#pragma unroll
      for (int z = 0; z < 3; ++z)
        W[3 * x + z] = (jc0(x) * pt[z] + jc1(x) * pt[3 + z]) * pm;
    T rv[9];
#pragma unroll
    for (int x = 0; x < 9; ++x)
      rv[x] = (W[3 * x] * y[0] + W[3 * x + 1] * y[1] + W[3 * x + 2] * y[2]) -
              (jc0(x) * rr[0] + jc1(x) * rr[1]);
    T* base;
    base = w_out + (slot0 + c0) * 27;
    put_rows<T, NT, 27>(base, buf, cnt, has, [&](int k) { return W[k]; });
    // U = W L, L lower: L = [[l11, 0, 0], [l21, l22, 0], [l31, l32, l33]]
    base = u_out + (slot0 + c0) * 27;
    put_rows<T, NT, 27>(base, buf, cnt, has, [&](int k) {
      const int x = k / 3, z = k % 3;
      const T* w = W + 3 * x;
      return z == 0 ? w[0] * L[0] + w[1] * L[1] + w[2] * L[3]
             : z == 1 ? w[1] * L[2] + w[2] * L[4]
                      : w[2] * L[5];
    });
    base = cam_out + (slot0 + c0) * 60;
    put_rows<T, NT, 60>(base, buf, cnt, has, [&](int k) {
      if (k < 36) {
        const int x = k / 6, z = k % 6;
        return po[x] * po[z] + po[6 + x] * po[6 + z];
      }
      if (k < 54) {
        const int x = (k - 36) / 3, z = (k - 36) % 3;
        return po[x] * in[z] + po[6 + x] * in[3 + z];
      }
      return rv[k - 54];
    });
    base = model_out + (slot0 + c0) * 12;
    put_rows<T, NT, 12>(base, buf, cnt, has, [&](int k) {
      if (k < 9) {
        const int x = k / 3, z = k % 3;
        return in[x] * in[z] + in[3 + x] * in[3 + z];
      }
      return rv[6 + k - 9];
    });
  }
}

template <typename T>
int launch(const void* r, const void* jpo, const void* jin, const void* jpt,
           const void* point_mut, long long n_points, int views, double lam,
           void* hinv, void* gpt, void* w, void* u, void* cam, void* model,
           void* stream) {
  constexpr int NT = Threads<T>::value;
  if (n_points == 0) return 0;
  if (n_points < 0 || views < 0) return (int)cudaErrorInvalidValue;
  const int per = views == 0 ? NT : views <= NT ? NT / views : 1;
  const long long blocks = (n_points + per - 1) / per;
  if (blocks > INT_MAX || n_points > LLONG_MAX / (views ? views : 1) / 60)
    return (int)cudaErrorInvalidValue;
  ba_reduce_slots_kernel<T><<<(unsigned)blocks, NT, 0,
                              (cudaStream_t)stream>>>(
      (const T*)r, (const T*)jpo, (const T*)jin, (const T*)jpt,
      (const T*)point_mut, n_points, views, per, (T)lam, (T*)hinv, (T*)gpt,
      (T*)w, (T*)u, (T*)cam, (T*)model);
  return (int)cudaGetLastError();
}

}  // namespace

// r (P, V, 2), jpo (P, V, 2, 6), jin (P, V, 2, 3), jpt (P, V, 2, 3) and
// point_mut (P,) of one type, every tensor contiguous; lam the LM damping
// (rounded to the type, as the plain version's product with a Python
// number is).  Writes hinv (P, 3, 3), gpt (P, 3), w and u (P, V, 9, 3),
// cam (P, V, 60) and model (P, V, 12), every slot's and point's entries.
extern "C" int ba_reduce_slots_f32_launch(
    const void* r, const void* jpo, const void* jin, const void* jpt,
    const void* point_mut, long long n_points, int views, double lam,
    void* hinv, void* gpt, void* w, void* u, void* cam, void* model,
    void* stream) {
  return launch<float>(r, jpo, jin, jpt, point_mut, n_points, views, lam,
                       hinv, gpt, w, u, cam, model, stream);
}

extern "C" int ba_reduce_slots_f64_launch(
    const void* r, const void* jpo, const void* jin, const void* jpt,
    const void* point_mut, long long n_points, int views, double lam,
    void* hinv, void* gpt, void* w, void* u, void* cam, void* model,
    void* stream) {
  return launch<double>(r, jpo, jin, jpt, point_mut, n_points, views, lam,
                        hinv, gpt, w, u, cam, model, stream);
}
