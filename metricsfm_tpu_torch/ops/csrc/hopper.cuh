// Hopper (sm_90a) building blocks shared by the 2-NN matchers (knn2.cu,
// knn2_int8.cu): mbarriers, TMA tile loads, wgmma shared-memory
// descriptors and fences, and the host-side tensor-map encoder.
//
// Everything here is inline PTX or plain CUDA runtime: no CUTLASS and no
// libcuda link.  cuTensorMapEncodeTiled lives in libcuda; it is looked up
// at run time through the runtime's entry-point query, so the nvcc command
// needs no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.  The
// spin stays inside one asm block: a divergent exit (a trap) on the
// consumers' path would make the compiler serialize their wgmma.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Add `bytes` to the transaction count of the current phase (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive once and add `bytes` to the transaction count.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// ---- TMA ------------------------------------------------------------------

// Load the box at (col, row) of a 2-D tensor map into shared memory; the
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand stored with the
// 128-byte swizzle, as TMA writes it: rows of 128 bytes, 8-row atoms of
// 1024 bytes (the stride-byte offset).  The tile must be 1024-byte
// aligned; a k-step inside the 128-byte row adds its byte offset / 16.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator register across
// an asynchronous wgmma that writes it.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define HOPPER_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"
#define HOPPER_OP8(c, d, i)                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]),   \
      c(d[i + 6]), c(d[i + 7])
#define HOPPER_OP64(c, d)                                                     \
  HOPPER_OP8(c, d, 0), HOPPER_OP8(c, d, 8), HOPPER_OP8(c, d, 16),             \
      HOPPER_OP8(c, d, 24), HOPPER_OP8(c, d, 32), HOPPER_OP8(c, d, 40),       \
      HOPPER_OP8(c, d, 48), HOPPER_OP8(c, d, 56)

// d (64 rows x 128 cols, f32) {=, +=} A (64 x 16 bf16) . B (128 x 16 bf16)^T,
// both K-major in shared memory.  Accumulator layout per thread t of the
// warpgroup (warp w = t / 32, g = (t % 32) / 4, q = t % 4): d[4j + 2h + e]
// is row 16 w + g + 8 h, column 8 j + 2 q + e.
template <int ScaleD>
__device__ __forceinline__ void wgmma_bf16_m64n128k16(float (&d)[64],
                                                      uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_OP64("+f", d)
      : "l"(da), "l"(db), "n"(ScaleD));
}

// d (64 x 128, s32) {=, +=} A (64 x 32 s8) . B (128 x 32 s8)^T, both
// K-major in shared memory; the accumulator layout of the bf16 form.
template <int ScaleD>
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_D64
      ", %64, %65, p;\n}\n"
      : HOPPER_OP64("+r", d)
      : "l"(da), "l"(db), "n"(ScaleD));
}

// Hand registers from the producer warpgroup to the consumers (the whole
// warpgroup executes each; the counts must fit the block's allocation).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <typename T, int N>
__device__ __forceinline__ void acc_fence(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(d[i]);
}

// Run tiles 0 .. n_tiles-1 (n_tiles >= 1) through two accumulator sets a
// and b so that tile t+1's product runs while tile t is folded:
// issue(acc, t) waits for tile t's data and commits its wgmma group into
// acc; fold(acc, t) reads a finished accumulator.  Every path keeps the
// same groups in flight at each point (tile t in `a` at the loop head):
// where one path left a group pending that another had waited for, ptxas
// would serialize every wgmma of the kernel.
template <class Acc, class Issue, class Fold>
__device__ __forceinline__ void pipelined_tiles(int n_tiles, Acc& a, Acc& b,
                                                Issue&& issue, Fold&& fold) {
  issue(a, 0);
  int t = 0;
  for (; t + 2 < n_tiles; t += 2) {
    issue(b, t + 1);
    wgmma_wait<1>();
    acc_fence(a.d);
    fold(a, t);
    issue(a, t + 2);
    wgmma_wait<1>();
    acc_fence(b.d);
    fold(b, t + 1);
  }
  if (t + 1 < n_tiles) {
    issue(b, t + 1);
    wgmma_wait<1>();
    acc_fence(a.d);
    fold(a, t);
    wgmma_wait<0>();
    acc_fence(b.d);
    fold(b, t + 1);
  } else {
    wgmma_wait<0>();
    acc_fence(a.d);
    fold(a, t);
  }
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix of `elem`-byte elements as a 2-D tensor
// map with boxes of (box_rows, box_cols) and the 128-byte swizzle (box_cols
// * elem must be 128).  Rows past the end of the matrix read as zeros.
inline bool encode_rows(CUtensorMap* map, const void* base,
                        CUtensorMapDataType type, int elem, uint64_t rows,
                        uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
