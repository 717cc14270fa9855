// B6: bit-plane matmul, y (M, N) = sum_p alpha[p, n] * (x @ B_p) with
// P <= 8 sign planes B_p in {-1, +1} stored (P, K, N) int8 and alpha (P, N)
// f32.
//
// Replaces the TPU kernel
// repro/kernels/binary_matmul.py::binary_matmul_pallas (_kernel at :20,
// pallas_call at :50): the deployment form of the binarized mode
// (repro/quant/binarize.py), here every conv (as an im2col product) and the
// fc of each BINARIZE evaluation of the AutoQ search on the CNN
// (repro_torch/models/cnn.py).
//
// Bound on an H100: by bytes where N is narrow (conv1 of CIF10, N = 32: the
// im2col rows of x dominate), else by the 2 M K N fp32 operations at
// 67 TFLOP/s.  The Pallas kernel runs one MXU product per plane (2 P M K N
// operations).  Here the planes are folded as the weight tile is staged
// (gemm_tiles.cuh, SignPlanes): W[k, n] = sum_p alpha[p, n] * B_p[k, n] is
// built in fp32 from each plane's int8 signs on their way into shared
// memory, as K3 unpacks int4, and one fp32 product follows on the shared
// 128 x 128 tiled GEMM.  Each plane tile is still read once, and the work
// drops to 2 M K N operations.  CUDA cores, no TF32, for the rtol 1e-4
// parity of K2 and K3; the sums run in another order than the plain
// version's per-plane products, so the two agree to a tolerance, not bit
// for bit.  Edges are masked in the kernel; nothing is padded.
#include "gemm_tiles.cuh"

extern "C" int binary_matmul_f32(const void* x, const void* planes,
                                 const void* alpha, void* y, int M, int K,
                                 int N, int P, void* stream) {
  if (P < 1 || P > rt::MAX_PLANES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  rt::SignPlanes w{static_cast<const int8_t*>(planes),
                   static_cast<const float*>(alpha), P, {}};
  return rt::launch_tiled(static_cast<const float*>(x), w,
                          static_cast<float*>(y), M, K, N,
                          static_cast<cudaStream_t>(stream));
}
