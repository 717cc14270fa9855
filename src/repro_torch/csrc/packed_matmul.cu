// K3: sub-byte packed weight GEMM, y = x @ (unpack(pw) * scale[None, :]),
// int4 (2 values a byte) or int2 (4 values a byte) packed along K.
//
// Replaces the TPU kernel
// repro/kernels/packed_matmul.py::packed_matmul_pallas (_kernel at :50,
// pallas_call at :89): the int2 and int4 buckets of the packed weight
// store (repro_torch/kernels/ops.py::packed_mixed_matmul).
//
// Bound on an H100: at decode (M = 2) by the packed weight bytes, 1/2 or
// 1/4 byte per element read once, which is the whole point of the store;
// at prefill (M = 8320) by fp32 operations on CUDA cores.  The design
// (gemm_tiles.cuh) reads only packed bytes from device memory and unpacks
// them with shift, mask and sign extension in registers, in exactly the
// field order of repro/kernels/pack.py::extract_fields; rows past the
// logical K are masked in the kernel instead of padding x (the reference
// wrapper pads x, repro/kernels/ops.py:61-62).
#include "gemm_tiles.cuh"

extern "C" int packed_matmul_f32(const void* x, const void* pw,
                                 const void* scale, void* y, void* partial,
                                 int M, int K, int N, int ksplit,
                                 int store_bits, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const int8_t* w = static_cast<const int8_t*>(pw);
  const float* s = static_cast<const float*>(scale);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (store_bits == 4)
    return rt::launch_gemm<4>(xf, w, s, yf, pf, M, K, N, ksplit, st);
  if (store_bits == 2)
    return rt::launch_gemm<2>(xf, w, s, yf, pf, M, K, N, ksplit, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
