// Shared by every kernel library of the port: the error-string entry point
// that the Python wrappers call when a launch returns an error code, the
// cp.async copies (global -> shared, asynchronous, sm_80+) that the
// pipelined kernels (gemm_tiles.cuh's gemm_tc, binary_matmul.cu,
// flash_attention.cu) stage their tiles with, and the TF32 tensor-core
// pieces of gemm_tc and flash_tc: round to TF32, and one m16n8k8 MMA.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace rt {

// 16 bytes from global `src` (16-byte aligned) to shared `dst`; when `ok`
// is false nothing is read and `dst` is zero-filled (src must still be a
// valid address).  Bypasses L1 (.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes, for rows that are not 16-byte aligned; zero-fill as above.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

// 4 bytes to shared `dst` of which the first `n` (0, 2 or 4) are read from
// global `src` (4-byte aligned) and the rest zero-filled: a pair of bf16
// values whose second lies past the end of its row.
__device__ __forceinline__ void cp_async4n(void* dst, const void* src,
                                           int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero (kernels/ref.py::tf32_rna), as the bits of an fp32 value
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// c += a (16 x 8, row) @ b (8 x 8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace rt
