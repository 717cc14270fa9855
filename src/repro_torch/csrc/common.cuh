// Shared by every kernel library of the port: the error-string entry point
// that the Python wrappers call when a launch returns an error code, and
// the cp.async copies (global -> shared, asynchronous, sm_80+) that the
// pipelined kernels (binary_matmul.cu, flash_attention.cu's split walk)
// stage their tiles with.
#pragma once
#include <cuda_runtime.h>

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace rt
