// Bundle adjustment's linearization for Hopper (sm_90a): for every
// observation slot (p, v) of a BA problem, the reprojection residual and
// its Jacobians in the pose [aa, t], the camera model [f, k1, k2] and the
// point, scaled by sqrt(track_weight[p]), the slot's mask and the Huber
// weight sqrt(rho'(s)) of the scaled residual (ba/lm.py, `_linearize`).
//
// A port-only kernel: it replaces no TPU kernel.  The JAX package
// linearizes with jax.vmap(jax.jacfwd) of the residual
// (metricsfm_tpu/ba/lm.py:85-107), which XLA fuses into a few loops.  In
// eager PyTorch the same vmap(jacfwd) composition dispatches some 290
// small ops an LM iteration, most of them 12-wide tangents of every
// intermediate, and the card waits on the host for all of them.  Here
// the derivatives are written out: they differentiate exactly the
// expressions the plain version evaluates (ops/lie.rotate_point with its
// small-angle branch at theta^2 < 1e-8 and theta = sqrt(theta^2 + 1e-16),
// ops/projection.project with its |z| < 1e-12 clamp, through which the
// derivative in z is zero, as jacfwd gives it), so one launch does the
// work of the whole composition.
//
// What bounds it: bytes.  A slot reads its camera index (8 B), mask
// (1 B) and observation (2 values), its point and track weight (shared by
// the V slots of a track), and its pose and camera model from tables of a
// few KB that stay in L1 and L2; it writes 26 values (r 2, J_pose 12,
// J_intr 6, J_pt 6: 104 B in float32).  Its ~400 flops (one sin and cos,
// three square roots) are far from the card's rates.
//
// Design: one thread a slot, 256 a block; no shared memory, no
// reductions, no atomics, so every run gives the same bits.  The outputs
// are written with the widest aligned vector stores each block's width
// allows (float4 / double2 where a slot's block is a multiple of 16 B,
// else 8 B), so a warp's stores cover contiguous memory.  A masked slot
// (padding, or an observation culled from the track) reads nothing but its
// mask and writes zeros: the same result as the plain version's product
// with the mask, without projecting a padding slot's camera (whose inf or
// NaN would survive that product as NaN).  Float32 and float64 (the
// problem's own type); no fast-math intrinsics, no lower precision.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// p = rotate_point(aa, X) + t, with dp/daa (3x3) and dp/dX (3x3), row k
// of each the derivatives of p[k] (ops/lie.rotate_point)
template <typename T>
__device__ __forceinline__ void transform(const T a[3], const T t[3],
                                          const T X[3], T p[3],
                                          T dp_da[3][3], T dp_dX[3][3]) {
  const T th2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
  if (th2 < T(1e-8)) {
    // X + aa x X: d/daa = -[X]x, d/dX = I + [aa]x
    p[0] = X[0] + (a[1] * X[2] - a[2] * X[1]);
    p[1] = X[1] + (a[2] * X[0] - a[0] * X[2]);
    p[2] = X[2] + (a[0] * X[1] - a[1] * X[0]);
    dp_da[0][0] = 0;     dp_da[0][1] = X[2];  dp_da[0][2] = -X[1];
    dp_da[1][0] = -X[2]; dp_da[1][1] = 0;     dp_da[1][2] = X[0];
    dp_da[2][0] = X[1];  dp_da[2][1] = -X[0]; dp_da[2][2] = 0;
    dp_dX[0][0] = 1;     dp_dX[0][1] = -a[2]; dp_dX[0][2] = a[1];
    dp_dX[1][0] = a[2];  dp_dX[1][1] = 1;     dp_dX[1][2] = -a[0];
    dp_dX[2][0] = -a[1]; dp_dX[2][1] = a[0];  dp_dX[2][2] = 1;
  } else {
    // X cos + (u x X) sin + u (u . X)(1 - cos), u = aa / theta
    const T th = msqrt(th2 + T(1e-16));
    T s, c;
    msincos(th, &s, &c);
    const T u[3] = {a[0] / th, a[1] / th, a[2] / th};
    const T uxX[3] = {u[1] * X[2] - u[2] * X[1], u[2] * X[0] - u[0] * X[2],
                      u[0] * X[1] - u[1] * X[0]};
    const T d = u[0] * X[0] + u[1] * X[1] + u[2] * X[2];
    const T omc = T(1) - c;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[k] = X[k] * c + uxX[k] * s + u[k] * d * omc;
    // column j: dtheta/da_j = u_j, du/da_j = (e_j - u u_j) / theta
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T g = u[j];
      T du[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        du[k] = ((k == j ? T(1) : T(0)) - u[k] * g) / th;
      const T duxX[3] = {du[1] * X[2] - du[2] * X[1],
                         du[2] * X[0] - du[0] * X[2],
                         du[0] * X[1] - du[1] * X[0]};
      const T dd = du[0] * X[0] + du[1] * X[1] + du[2] * X[2];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dp_da[k][j] = -X[k] * s * g + duxX[k] * s + uxX[k] * c * g +
                      du[k] * d * omc + u[k] * dd * omc + u[k] * d * s * g;
    }
    // d/dX = cos I + sin [u]x + (1 - cos) u u^T
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) dp_dX[k][j] = omc * u[k] * u[j];
    dp_dX[0][0] += c;        dp_dX[0][1] -= s * u[2]; dp_dX[0][2] += s * u[1];
    dp_dX[1][0] += s * u[2]; dp_dX[1][1] += c;        dp_dX[1][2] -= s * u[0];
    dp_dX[2][0] -= s * u[1]; dp_dX[2][1] += s * u[0]; dp_dX[2][2] += c;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] += t[k];
}

// One observed slot: r = f (1 + r2 (k1 + k2 r2)) (x/z, y/z) - uv and its
// Jacobians, then the track weight's and the Huber weight's scaling
// (ops/projection.project, ba/lm.robust_weights)
template <typename T>
__device__ __forceinline__ void linearize_slot(
    const T pose[6], const T intr[3], const T X[3], const T obs[2],
    T weight, T delta, T delta2, T r[2], T jpo[12], T jin[6], T jpt[6]) {
  T p[3], dp_da[3][3], dp_dX[3][3];
  transform(pose, pose + 3, X, p, dp_da, dp_dX);
  const T f = intr[0], k1 = intr[1], k2 = intr[2];
  const bool clamped = mabs(p[2]) < T(1e-12);
  const T zs = clamped ? T(1e-12) : p[2];
  const T xn[2] = {p[0] / zs, p[1] / zs};
  const T r2 = xn[0] * xn[0] + xn[1] * xn[1];
  const T fac = T(1) + r2 * (k1 + k2 * r2);
  // d(f xn fac)/dxn = f (fac I + q xn xn^T), q xn = dfac/dxn
  const T q = T(2) * (k1 + T(2) * k2 * r2);
  T A[2][3];   // d(projection)/dp
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T b0 = f * ((i == 0 ? fac : T(0)) + q * xn[i] * xn[0]);
    const T b1 = f * ((i == 1 ? fac : T(0)) + q * xn[i] * xn[1]);
    A[i][0] = b0 / zs;
    A[i][1] = b1 / zs;
    A[i][2] = clamped ? T(0) : -(b0 * xn[0] + b1 * xn[1]) / zs;
    r[i] = f * (xn[i] * fac) - obs[i];
    jin[3 * i + 0] = xn[i] * fac;
    jin[3 * i + 1] = f * xn[i] * r2;
    jin[3 * i + 2] = f * xn[i] * r2 * r2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      jpo[6 * i + j] = A[i][0] * dp_da[0][j] + A[i][1] * dp_da[1][j] +
                       A[i][2] * dp_da[2][j];
      jpo[6 * i + 3 + j] = A[i][j];
      jpt[3 * i + j] = A[i][0] * dp_dX[0][j] + A[i][1] * dp_dX[1][j] +
                       A[i][2] * dp_dX[2][j];
    }
  }
  // sqrt(track weight), then sqrt(rho'(s)) of the scaled residual: 1 at
  // s <= delta^2, else sqrt(delta / sqrt(max(s, 1e-20)))
  const T w = msqrt(weight);
  r[0] *= w;
  r[1] *= w;
  const T s2 = r[0] * r[0] + r[1] * r[1];
  const T rw = s2 <= delta2
                   ? T(1)
                   : msqrt(delta / msqrt(s2 < T(1e-20) ? T(1e-20) : s2));
  r[0] *= rw;
  r[1] *= rw;
#pragma unroll
  for (int k = 0; k < 12; ++k) jpo[k] = jpo[k] * w * rw;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    jin[k] = jin[k] * w * rw;
    jpt[k] = jpt[k] * w * rw;
  }
}

// n values from registers to dst: 16-byte stores where n values fill
// whole 16-byte words (dst is then 16-byte aligned: slot i's block starts
// at i n values), else 8-byte ones
template <typename T, int N>
__device__ __forceinline__ void store(T* dst, const T (&v)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < N; k += 4)
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < N; k += 2)
        *reinterpret_cast<double2*>(dst + k) = make_double2(v[k], v[k + 1]);
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      *reinterpret_cast<float2*>(dst + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = v[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ba_linearize_kernel(
    const T* __restrict__ poses, const T* __restrict__ intrs,
    const T* __restrict__ points, const long long* __restrict__ cam_model,
    const long long* __restrict__ track_cam, const T* __restrict__ uv,
    const T* __restrict__ weight, const uint8_t* __restrict__ mask,
    long long n, int views, T delta, T delta2, T* __restrict__ r_out,
    T* __restrict__ jpo_out, T* __restrict__ jin_out,
    T* __restrict__ jpt_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  T r[2] = {}, jpo[12] = {}, jin[6] = {}, jpt[6] = {};
  if (__ldg(mask + i)) {
    const long long pt = i / views;
    const long long cam = __ldg(track_cam + i);
    const long long model = __ldg(cam_model + cam);
    T pose[6], intr[3], X[3], obs[2];
#pragma unroll
    for (int k = 0; k < 6; ++k) pose[k] = __ldg(poses + 6 * cam + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      intr[k] = __ldg(intrs + 3 * model + k);
      X[k] = __ldg(points + 3 * pt + k);
    }
    obs[0] = __ldg(uv + 2 * i);
    obs[1] = __ldg(uv + 2 * i + 1);
    linearize_slot(pose, intr, X, obs, __ldg(weight + pt), delta, delta2, r,
                   jpo, jin, jpt);
  }
  store(r_out + 2 * i, r);
  store(jpo_out + 12 * i, jpo);
  store(jin_out + 6 * i, jin);
  store(jpt_out + 6 * i, jpt);
}

template <typename T>
int launch(const void* poses, const void* intrs, const void* points,
           const void* cam_model, const void* track_cam, const void* uv,
           const void* weight, const void* mask, long long n, int views,
           double delta, void* r, void* jpo, void* jin, void* jpt,
           void* stream) {
  if (n == 0) return 0;
  if (n < 0 || views <= 0 || n % views != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ba_linearize_kernel<T><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const T*)poses, (const T*)intrs, (const T*)points,
      (const long long*)cam_model, (const long long*)track_cam, (const T*)uv,
      (const T*)weight, (const uint8_t*)mask, n, views, (T)delta,
      (T)(delta * delta), (T*)r, (T*)jpo, (T*)jin, (T*)jpt);
  return (int)cudaGetLastError();
}

}  // namespace

// poses (C, 6), intrs (M, 3), points (P, 3), uv (P, V, 2), weight (P,) of
// one type; cam_model (C,) and track_cam (P, V) int64; mask (P, V) bool
// (one byte a slot); n = P V slots; every tensor contiguous.  Writes r
// (P, V, 2), jpo (P, V, 2, 6), jin (P, V, 2, 3), jpt (P, V, 2, 3), each
// Jacobian row-major by residual component.  delta is the Huber
// threshold (its square is taken in double, then rounded, as the plain
// version compares in the values' type).
extern "C" int ba_linearize_f32_launch(
    const void* poses, const void* intrs, const void* points,
    const void* cam_model, const void* track_cam, const void* uv,
    const void* weight, const void* mask, long long n, int views,
    double delta, void* r, void* jpo, void* jin, void* jpt, void* stream) {
  return launch<float>(poses, intrs, points, cam_model, track_cam, uv, weight,
                       mask, n, views, delta, r, jpo, jin, jpt, stream);
}

extern "C" int ba_linearize_f64_launch(
    const void* poses, const void* intrs, const void* points,
    const void* cam_model, const void* track_cam, const void* uv,
    const void* weight, const void* mask, long long n, int views,
    double delta, void* r, void* jpo, void* jin, void* jpt, void* stream) {
  return launch<double>(poses, intrs, points, cam_model, track_cam, uv,
                        weight, mask, n, views, delta, r, jpo, jin, jpt,
                        stream);
}
