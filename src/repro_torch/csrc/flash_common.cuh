// Device and host helpers shared by the two flash-attention kernels
// (csrc/flash_attn_tc.cu, bf16; csrc/flash_attn.cu, fp32): shared-memory
// addresses, mbarriers, TMA loads and tensor maps, wgmma fences and
// descriptors, the turn-taking barriers of two warpgroups, and the
// 128/64-byte swizzle that TMA writes and wgmma reads. Included by each
// kernel's source; every definition is internal to the including file.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (along the contiguous dim) of row r in an
// R-row tile laid out as [atom columns][R rows][W bytes] and swizzled as
// the hardware's Swizzle<log2(W/16), 4, 3>: bits 7.. of the offset XOR
// bits 4.. (every atom starts W * 8-byte aligned).
template <int W, int R>
__device__ __forceinline__ uint32_t swz_offset(int r, int c) {
  constexpr int per = W / 16;
  const uint32_t lin = (c / per) * (R * W) + r * W + (c % per) * 16;
  return lin ^ ((lin >> 3) & (W - 16));
}

// mbarrier: one a stage, completed by the bytes its TMA copies deliver
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// TMA: one box of a 4-d tensor map, (d, head, row, batch), into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Named barriers 1 and 2 hand the tensor cores back and forth between the
// two warpgroups: each waits for its turn (bar.sync of 256 threads: its own
// 128 plus the other warpgroup's 128 arrivals), issues its wgmmas and
// passes the turn on (bar.arrive), so one warpgroup's product runs while
// the other does its softmax.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
// keep the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units), layout type in bits 62-63 (1: 128-byte swizzle,
// 2: 64-byte; base offset 0: every atom starts aligned to its pattern).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// 2^x in one MUFU instruction; x <= 0 here, and a result below 2^-126
// flushes to 0, which the fp32 sums cannot see
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links libcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, rows, heads, D) of `elem` bytes as a 4-d map, (d, head, row, batch)
// innermost first, cut into boxes of one swizzle atom: box_cols x box_rows.
// Rows past `rows` arrive as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                     int elem, int B, int rows, int heads, int D, int box_cols,
                     int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * elem, (cuuint64_t)heads * D * elem,
                                 (cuuint64_t)rows * heads * D * elem};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
