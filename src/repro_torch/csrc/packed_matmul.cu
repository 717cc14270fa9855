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
// at prefill (M = 8320) and run()'s chunk steps (M = 2048) by the
// function's 2 M K N operations at the TF32 tensor-core peak of 495
// TFLOP/s (0.71 ms at 8320x2304x9216; the two passes of the route below
// need 1.43 ms).  The design (gemm_tiles.cuh) reads only packed bytes from
// device memory and unpacks them with shift, mask and sign extension in
// registers, in exactly the field order of
// repro/kernels/pack.py::extract_fields; fields past the logical K are
// masked in the kernel instead of padding x (the reference wrapper pads
// x, repro/kernels/ops.py:61-62).  For M <= 8 a skinny weight-streaming
// pass on CUDA cores; for larger M K2's gemm_tc, 128 x 128 tiles on TF32
// mma.sync with x split into hi and lo TF32 parts, the packed rows of a K
// step staged as bytes (PackedStage) and each field unpacked where the MMA
// fragment is built (int4 and int2 are exact in TF32, so two passes give
// fp32 accuracy); the scale multiplies the finished accumulator once,
// where the Pallas kernel applies it.
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
