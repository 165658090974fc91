// Bundle adjustment's LM candidate and its robust cost for Hopper
// (sm_90a), in one launch (ba/lm.solve_lm's ba/lm/step):
//
//   back-substitution, per point p, its slots' sum in slot order (no
//     atomics): e = sum_v W[p, v]^T dc[p, v], where dc is the slot's
//     camera step [d_cam pose (6) | d_cam model (3)];
//     d_pt = -(Hpp_inv (g_pt + e)) point_mut
//     (ops/ba_candidate_cost.backsub);
//   the candidate: points + d_pt, poses + d_pose pose_mut and
//     intrs + d_intr intr_mut, written out; each slot forms its camera's
//     candidate pose and model in registers, with the same two roundings;
//   the residuals at the candidate, as ba/lm.compute_residuals gives them:
//     f (1 + r2 (k1 + k2 r2)) (x/z, y/z) - uv, scaled by sqrt(track_weight),
//     for every kept slot;
//   the cost: 0.5 sum rho(|r|^2), Huber rho (ba/lm.robust_cost), in
//     double and in a fixed order: each thread its slots in order, each
//     block by a fixed shuffle tree and its warps in order, and the last
//     block to take an integer ticket adds the blocks' partials in block
//     order, rounds once and puts the ticket back to 0 (as segsum.cu joins
//     its cross-block bins).  No float atomics: two launches on the same
//     inputs give the same bits.
// Without a step (the solve's initial cost) it evaluates the problem's
// own values: no back-substitution, nothing written but the cost.
//
// A port-only kernel: it replaces no TPU kernel.  The JAX package writes
// the back-substitution as einsums, the candidate as adds and the cost as
// a reduction (metricsfm_tpu/ba/lm.py), which XLA fuses.  In eager
// PyTorch the same composition dispatched some 280 small ops an LM
// iteration (its prior terms included), and the card waited on the host
// for all of them.  The plain version, ops/ba_candidate_cost.
// candidate_cost_plain, is that composition.
//
// What bounds it: bytes.  A kept slot reads W (27 values), its camera
// index, observation and mask; a masked slot its mask alone (its W is
// zero, as the reduce kernel writes it, and adds nothing to a finite
// step).  A point reads Hpp_inv, g_pt, the point, its weight and
// point_mut and writes its candidate.  At the BA cell's 32,768 points x
// V 16, 41 % kept, in float32: about 30 MB, 0.009 ms at 3.35 TB/s.  Its
// ~200 flops a kept slot (one sin and cos, three square roots) are far
// from the card's rates.
//
// Design: a block takes NT / V whole points (one point for V > NT) and a
// thread a slot (for V > NT, slots t, t + NT, ...), as ba_reduce_slots.cu
// does.  Each thread adds its slots' W^T dc into 3 partials in shared
// memory; one thread a point adds its partials in slot order, forms and
// writes the candidate point and leaves it in shared memory; then every
// thread projects its slots against it.  Float32 and float64 (the
// problem's own type); no fast-math intrinsics, no lower precision.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Whole points a block: NT / views (one for views > NT)
long long points_per_block(int views) {
  return views == 0 ? kThreads : views <= kThreads ? kThreads / views : 1;
}

long long blocks_for(long long n_points, int views) {
  const long long per = points_per_block(views);
  const long long b = (n_points + per - 1) / per;
  return b < 1 ? 1 : b;
}

__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ void msincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void msincos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float mabs(float x) { return fabsf(x); }
__device__ __forceinline__ double mabs(double x) { return fabs(x); }

// x + d m, rounded after the product and after the sum as the plain
// version's two ops are (no contraction into an FMA): the candidate a
// slot forms in registers is then bit for bit the one written out.
__device__ __forceinline__ float step_add(float x, float d, float m) {
  return __fadd_rn(x, __fmul_rn(d, m));
}
__device__ __forceinline__ double step_add(double x, double d, double m) {
  return __dadd_rn(x, __dmul_rn(d, m));
}

// The residual of one observation (ops/projection.reprojection_residual):
// rotate X by the angle-axis aa (ops/lie.rotate_point, its small-angle
// branch at theta^2 < 1e-8, theta = sqrt(theta^2 + 1e-16)), translate,
// project with the |z| < 1e-12 clamp and the radial model, subtract.
template <typename T>
__device__ __forceinline__ void residual(const T pose[6], const T intr[3],
                                         const T X[3], const T obs[2],
                                         T r[2]) {
  const T* a = pose;
  const T th2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
  T p[3];
  if (th2 < T(1e-8)) {
    p[0] = X[0] + (a[1] * X[2] - a[2] * X[1]);
    p[1] = X[1] + (a[2] * X[0] - a[0] * X[2]);
    p[2] = X[2] + (a[0] * X[1] - a[1] * X[0]);
  } else {
    const T th = msqrt(th2 + T(1e-16));
    T s, c;
    msincos(th, &s, &c);
    const T u[3] = {a[0] / th, a[1] / th, a[2] / th};
    const T uxX[3] = {u[1] * X[2] - u[2] * X[1], u[2] * X[0] - u[0] * X[2],
                      u[0] * X[1] - u[1] * X[0]};
    const T d = u[0] * X[0] + u[1] * X[1] + u[2] * X[2];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[k] = X[k] * c + uxX[k] * s + u[k] * d * (T(1) - c);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] += pose[3 + k];
  const T zs = mabs(p[2]) < T(1e-12) ? T(1e-12) : p[2];
  const T xn[2] = {p[0] / zs, p[1] / zs};
  const T r2 = xn[0] * xn[0] + xn[1] * xn[1];
  const T fac = T(1) + r2 * (intr[1] + intr[2] * r2);
  r[0] = intr[0] * (xn[0] * fac) - obs[0];
  r[1] = intr[0] * (xn[1] * fac) - obs[1];
}

// The block's sum of v in a fixed order (a shuffle tree, then the warps
// in warp order), in thread 0; `red` holds kWarps doubles.
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (t == 0) {
    s = red[0];
    for (int w = 1; w < kWarps; ++w) s += red[w];
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ba_candidate_cost_kernel(
    const T* __restrict__ poses, const T* __restrict__ intrs,
    const T* __restrict__ points, const long long* __restrict__ cam_model,
    const long long* __restrict__ track_cam, const T* __restrict__ uv,
    const T* __restrict__ weight, const uint8_t* __restrict__ mask,
    const T* __restrict__ d_cam, const T* __restrict__ w_in,
    const T* __restrict__ hinv, const T* __restrict__ gpt,
    const T* __restrict__ pose_mut, const T* __restrict__ intr_mut,
    const T* __restrict__ point_mut, long long n_points, int views,
    int n_cams, int n_models, int pts_per_block, T delta2, T two_delta,
    T* __restrict__ poses_out, T* __restrict__ intrs_out,
    T* __restrict__ points_out, T* __restrict__ cost_out,
    double* __restrict__ partials, int* __restrict__ ticket) {
  __shared__ T buf[3 * kThreads];    // back-substitution partials [3][NT]
  __shared__ T pts[3 * kThreads];    // the block's candidate points
  __shared__ double red[kWarps];
  __shared__ bool last;
  const int t = threadIdx.x;
  const bool step = d_cam != nullptr;
  const long long p0 = (long long)blockIdx.x * pts_per_block;
  const long long left = n_points - p0;
  const int np = left <= 0 ? 0
                 : left < pts_per_block ? (int)left : pts_per_block;
  const int n = np * views;                  // the block's slots
  const long long slot0 = p0 * views;
  const long long pose_end = 6LL * n_cams;

  // ---- the candidate cameras, written once across the grid ----
  if (step) {
    const long long total = pose_end + 3LL * n_models;
    for (long long i = (long long)blockIdx.x * kThreads + t; i < total;
         i += (long long)gridDim.x * kThreads) {
      if (i < pose_end)
        poses_out[i] = step_add(poses[i], d_cam[i], pose_mut[i / 6]);
      else
        intrs_out[i - pose_end] = step_add(
            intrs[i - pose_end], d_cam[i], intr_mut[(i - pose_end) / 3]);
    }
  }

  // ---- back-substitution partials: W^T dc of the kept slots ----
  if (step) {
    T acc[3] = {};
    for (int s = t; s < n; s += kThreads) {
      const long long i = slot0 + s;
      if (!__ldg(mask + i)) continue;
      const long long cam = __ldg(track_cam + i);
      const long long model = __ldg(cam_model + cam);
      T dc[9];
#pragma unroll
      for (int k = 0; k < 6; ++k) dc[k] = __ldg(d_cam + 6 * cam + k);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dc[6 + k] = __ldg(d_cam + pose_end + 3 * model + k);
      const T* w = w_in + 27 * i;
#pragma unroll
      for (int x = 0; x < 9; ++x)
#pragma unroll
        for (int z = 0; z < 3; ++z) acc[z] += __ldg(w + 3 * x + z) * dc[x];
    }
#pragma unroll
    for (int z = 0; z < 3; ++z) buf[z * kThreads + t] = acc[z];
    __syncthreads();
  }

  // ---- one thread a point: its sum in slot order, the candidate ----
  if (t < np) {
    const long long p = p0 + t;
    T X[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) X[k] = __ldg(points + 3 * p + k);
    if (step) {
      const int npart = views <= kThreads ? views : kThreads;
      T e[3] = {};
      for (int k = 0; k < npart; ++k)
#pragma unroll
        for (int z = 0; z < 3; ++z) e[z] += buf[z * kThreads + t * npart + k];
      T b[3];
#pragma unroll
      for (int z = 0; z < 3; ++z) b[z] = __ldg(gpt + 3 * p + z) + e[z];
      const T pm = __ldg(point_mut + p);
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const T* h = hinv + 9 * p + 3 * x;
        const T d = -(__ldg(h) * b[0] + __ldg(h + 1) * b[1] +
                      __ldg(h + 2) * b[2]);
        X[x] = step_add(X[x], d, pm);
        points_out[3 * p + x] = X[x];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) pts[3 * t + k] = X[k];
  }
  __syncthreads();

  // ---- the kept slots' residuals at the candidate, and rho ----
  double acc = 0.0;
  for (int s = t; s < n; s += kThreads) {
    const long long i = slot0 + s;
    if (!__ldg(mask + i)) continue;
    const long long cam = __ldg(track_cam + i);
    const long long model = __ldg(cam_model + cam);
    T pose[6], intr[3];
#pragma unroll
    for (int k = 0; k < 6; ++k) pose[k] = __ldg(poses + 6 * cam + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) intr[k] = __ldg(intrs + 3 * model + k);
    if (step) {
      const T pm = __ldg(pose_mut + cam), im = __ldg(intr_mut + model);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        pose[k] = step_add(pose[k], __ldg(d_cam + 6 * cam + k), pm);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        intr[k] = step_add(intr[k], __ldg(d_cam + pose_end + 3 * model + k),
                           im);
    }
    const long long p = i / views;
    const T* X = pts + 3 * (p - p0);
    const T obs[2] = {__ldg(uv + 2 * i), __ldg(uv + 2 * i + 1)};
    T r[2];
    residual(pose, intr, X, obs, r);
    const T w = msqrt(__ldg(weight + p));
    r[0] *= w;
    r[1] *= w;
    const T s2 = r[0] * r[0] + r[1] * r[1];
    const T rho = s2 <= delta2
                      ? s2
                      : two_delta * msqrt(s2 < T(1e-20) ? T(1e-20) : s2) -
                            delta2;
    acc += (double)rho;
  }

  // ---- the cost: block partials, joined by the last block in order ----
  const double bsum = block_sum(acc, red);
  if (t == 0) {
    partials[blockIdx.x] = bsum;
    __threadfence();
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nb = (int)gridDim.x;
  const int q = (nb + kThreads - 1) / kThreads;
  const int a = t * q;
  const int z = a + q < nb ? a + q : nb;
  double v = 0.0;
  for (int b = a; b < z; ++b) v += __ldcg(partials + b);
  __syncthreads();                  // red is reused
  const double total = block_sum(v, red);
  if (t == 0) {
    cost_out[0] = (T)(0.5 * total);
    *ticket = 0;
  }
}

template <typename T>
int launch(const void* poses, const void* intrs, const void* points,
           const void* cam_model, const void* track_cam, const void* uv,
           const void* weight, const void* mask, const void* d_cam,
           const void* w, const void* hinv, const void* gpt,
           const void* pose_mut, const void* intr_mut, const void* point_mut,
           long long n_points, int views, int n_cams, int n_models,
           double delta, void* poses_out, void* intrs_out, void* points_out,
           void* cost, void* partials, long long n_partials, void* ticket,
           void* stream) {
  if (n_points < 0 || views < 0 || n_cams < 0 || n_models < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = blocks_for(n_points, views);
  if (blocks > INT_MAX || blocks > n_partials ||
      n_points > LLONG_MAX / 27 / (views ? views : 1))
    return (int)cudaErrorInvalidValue;
  const int per = (int)points_per_block(views);
  ba_candidate_cost_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const T*)poses, (const T*)intrs, (const T*)points,
      (const long long*)cam_model, (const long long*)track_cam, (const T*)uv,
      (const T*)weight, (const uint8_t*)mask, (const T*)d_cam, (const T*)w,
      (const T*)hinv, (const T*)gpt, (const T*)pose_mut, (const T*)intr_mut,
      (const T*)point_mut, n_points, views, n_cams, n_models, per,
      (T)(delta * delta), (T)(2.0 * delta), (T*)poses_out, (T*)intrs_out,
      (T*)points_out, (T*)cost, (double*)partials, (int*)ticket);
  return (int)cudaGetLastError();
}

}  // namespace

// The blocks (and so the partials) a launch over n_points x views slots
// takes: NT / views whole points a block (one for views > NT), one block
// at least, which writes the cost of no slot, 0.
extern "C" long long candidate_cost_blocks(long long n_points, int views) {
  return blocks_for(n_points, views);
}

// poses (C, 6), intrs (M, 3), points (P, 3), uv (P, V, 2), weight (P,) of
// one type; cam_model (C,) and track_cam (P, V) int64; mask (P, V) bool
// (one byte a slot).  The step: d_cam (6C + 3M,), w (P, V, 9, 3), hinv
// (P, 3, 3), gpt (P, 3), pose_mut (C,), intr_mut (M,) and point_mut (P,)
// of the same type, or d_cam null for the cost alone (the others are then
// not read, nor poses_out, intrs_out and points_out written).  Every
// tensor contiguous.  Writes the candidate's poses_out, intrs_out and
// points_out, and cost (one value of the type).  partials: n_partials >=
// candidate_cost_blocks(P, V) doubles of scratch; ticket: one int, 0 at
// the launch and put back to 0 by it.  delta is the Huber threshold (its
// square and its double taken in double, then rounded, as the plain
// version's products with a Python number are).
extern "C" int ba_candidate_cost_f32_launch(
    const void* poses, const void* intrs, const void* points,
    const void* cam_model, const void* track_cam, const void* uv,
    const void* weight, const void* mask, const void* d_cam, const void* w,
    const void* hinv, const void* gpt, const void* pose_mut,
    const void* intr_mut, const void* point_mut, long long n_points,
    int views, int n_cams, int n_models, double delta, void* poses_out,
    void* intrs_out, void* points_out, void* cost, void* partials,
    long long n_partials, void* ticket, void* stream) {
  return launch<float>(poses, intrs, points, cam_model, track_cam, uv, weight,
                       mask, d_cam, w, hinv, gpt, pose_mut, intr_mut,
                       point_mut, n_points, views, n_cams, n_models, delta,
                       poses_out, intrs_out, points_out, cost, partials,
                       n_partials, ticket, stream);
}

extern "C" int ba_candidate_cost_f64_launch(
    const void* poses, const void* intrs, const void* points,
    const void* cam_model, const void* track_cam, const void* uv,
    const void* weight, const void* mask, const void* d_cam, const void* w,
    const void* hinv, const void* gpt, const void* pose_mut,
    const void* intr_mut, const void* point_mut, long long n_points,
    int views, int n_cams, int n_models, double delta, void* poses_out,
    void* intrs_out, void* points_out, void* cost, void* partials,
    long long n_partials, void* ticket, void* stream) {
  return launch<double>(poses, intrs, points, cam_model, track_cam, uv,
                        weight, mask, d_cam, w, hinv, gpt, pose_mut, intr_mut,
                        point_mut, n_points, views, n_cams, n_models, delta,
                        poses_out, intrs_out, points_out, cost, partials,
                        n_partials, ticket, stream);
}
