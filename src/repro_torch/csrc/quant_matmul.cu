// K2: int8 weight GEMM, y = x @ (qw * scale[None, :]).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul_pallas
// (_kernel at :25, pallas_call at :53): the int8 bucket of the packed
// weight store (repro_torch/kernels/ops.py::packed_mixed_matmul).
//
// Bound on an H100: at decode (M = 2) by the weight bytes, 1 byte per
// element read once; at prefill (M = 8320) by fp32 operations on CUDA
// cores (2 M K N at 67 TFLOP/s).  The design (gemm_tiles.cuh) gives each
// regime its own launch shape: a skinny weight-streaming pass with
// 128-byte coalesced rows for small M, and 128 x 128 register-blocked
// tiles for large M.  The int8 tile is converted to fp32 as it is staged
// into shared memory, and the scale multiplies the finished accumulator
// once, where the Pallas kernel applies it.
#include "gemm_tiles.cuh"

extern "C" int quant_matmul_f32(const void* x, const void* qw,
                                const void* scale, void* y, void* partial,
                                int M, int K, int N, int ksplit,
                                void* stream) {
  return rt::launch_gemm<8>(
      static_cast<const float*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<float*>(y),
      static_cast<float*>(partial), M, K, N, ksplit,
      static_cast<cudaStream_t>(stream));
}
