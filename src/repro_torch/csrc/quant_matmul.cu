// K2: int8 weight GEMM, y = x @ (qw * scale[None, :]), x fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul_pallas
// (_kernel at :25, pallas_call at :53): the int8 bucket of the packed
// weight store (repro_torch/kernels/ops.py::packed_mixed_matmul).
//
// Bound on an H100: at decode (M = 2) by the weight bytes, 1 byte per
// element read once (6.3 us at 2304 x 9216); at prefill (M = 8320) and
// run()'s chunk steps (M = 2048) by the function's 2 M K N operations at
// the TF32 tensor-core peak of 495 TFLOP/s (0.71 ms at 8320x2304x9216; the
// two passes of the route below need 1.43 ms, and 2 M K N fp32 operations
// on CUDA cores 5.27 ms).  The design (gemm_tiles.cuh) gives each regime
// its own launch shape: for M <= 8 gemm_stream, one launch that streams
// the weight with 16-byte loads and sums its K splits across a thread-block
// cluster, and for larger M gemm_tc, 128 x 128 tiles on TF32 mma.sync with
// each x value split into hi and lo TF32 parts (int8 is exact in TF32, so
// two passes give fp32 accuracy, and one would not).  The int8 tile is
// staged as bytes and converted to float as the MMA fragment is built; the
// scale multiplies the finished accumulator once, where the Pallas kernel
// applies it.  An MoE expert stack runs as one launch for all its experts
// (the expert is blockIdx.z), in place of the reference's einsum over the
// dequantized stack; the route is chosen by the rows an expert holds.  Its
// grouped form (quant_matmul_grouped_fwd) takes only the rows routed to
// each expert, back to back, with their offsets, on the tensor cores.
#include "gemm_tiles.cuh"

// E experts of M rows each (E = 1: one GEMM): x (E, M, K), qw (E, K, N),
// scale (E, N), y (E, M, N), all contiguous.  splits: gemm_stream's K
// splits (M <= 8; ignored above).  x_type: 0 fp32, 1 bf16, x's and y's.
extern "C" int quant_matmul_fwd(const void* x, const void* qw,
                                const void* scale, void* y, int E, int M,
                                int K, int N, int splits, int x_type,
                                void* stream) {
  using bf16 = __nv_bfloat16;
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_type == 0)
    return rt::launch_gemm<8>(static_cast<const float*>(x), w, s,
                              static_cast<float*>(y), E, M, K, N, splits, st);
  if (x_type == 1)
    return rt::launch_gemm<8>(static_cast<const bf16*>(x), w, s,
                              static_cast<bf16*>(y), E, M, K, N, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// G groups of rows back to back: x (P, K), group e in rows [offsets[e],
// offsets[e + 1]) against expert e of qw (G, K, N) and scale (G, N), into
// y (P, N); offsets int32 (G + 1), on the card.  Rows outside every group
// are not written.  x_type as above.
extern "C" int quant_matmul_grouped_fwd(const void* x, const void* qw,
                                        const void* scale, void* y,
                                        const void* offsets, int G, int P,
                                        int K, int N, int x_type,
                                        void* stream) {
  using bf16 = __nv_bfloat16;
  const int8_t* w = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scale);
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_type == 0)
    return rt::launch_gemm_grouped<8>(static_cast<const float*>(x), w, s,
                                      static_cast<float*>(y), off, G, P, K,
                                      N, st);
  if (x_type == 1)
    return rt::launch_gemm_grouped<8>(static_cast<const bf16*>(x), w, s,
                                      static_cast<bf16*>(y), off, G, P, K,
                                      N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
