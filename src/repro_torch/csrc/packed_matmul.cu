// K3: sub-byte packed weight GEMM, y = x @ (unpack(pw) * scale[None, :]),
// int4 (2 values a byte) or int2 (4 values a byte) packed along K; x fp32
// or bf16.
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
// device memory and unpacks them with shifts, masks and a mantissa trick in
// registers, in exactly the field order of
// repro/kernels/pack.py::extract_fields; fields past the logical K are
// masked in the kernel instead of padding x (the reference wrapper pads
// x, repro/kernels/ops.py:61-62).  For M <= 8 K2's gemm_stream, one
// launch that streams the packed bytes (each field made an exact float by
// a byte permute into the mantissa of 2^23 and one add); for larger M
// K2's gemm_tc, 128 x 128 tiles on TF32 mma.sync with x split into hi and
// lo TF32 parts, the packed rows of a K step staged as bytes
// (PackedStage) and each field unpacked where the MMA fragment is built
// (int4 and int2 are exact in TF32, so two passes give fp32 accuracy);
// the scale multiplies the finished accumulator once, where the Pallas
// kernel applies it.  An MoE expert stack's int4 and int2 buckets run as
// one launch each for all the experts (the expert is blockIdx.z), or, in
// the grouped form (packed_matmul_grouped_fwd), over only the rows routed
// to each expert, back to back.  On the tensor-core route a whole mixed-QBN
// weight, its int8 bucket included, is one launch (packed_mixed_fwd:
// gemm_tc_mixed, each bucket's tiles in one grid, written in the policy's
// channel order).
#include "gemm_tiles.cuh"

// E experts of M rows each (E = 1: one GEMM): x (E, M, K), pw (E,
// ceil(K / F), N), scale (E, N), y (E, M, N), all contiguous.  splits:
// gemm_stream's K splits (M <= 8; ignored above).  x_type: 0 fp32, 1
// bf16, x's and y's.
template <int BITS>
int packed_fwd(const void* x, const int8_t* w, const float* s, void* y,
               int E, int M, int K, int N, int splits, int x_type,
               cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (x_type == 0)
    return rt::launch_gemm<BITS>(static_cast<const float*>(x), w, s,
                                 static_cast<float*>(y), E, M, K, N, splits,
                                 st);
  if (x_type == 1)
    return rt::launch_gemm<BITS>(static_cast<const bf16*>(x), w, s,
                                 static_cast<bf16*>(y), E, M, K, N, splits,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int packed_matmul_fwd(const void* x, const void* pw,
                                 const void* scale, void* y, int E, int M,
                                 int K, int N, int splits, int store_bits,
                                 int x_type, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(pw);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (store_bits == 4)
    return packed_fwd<4>(x, w, s, y, E, M, K, N, splits, x_type, st);
  if (store_bits == 2)
    return packed_fwd<2>(x, w, s, y, E, M, K, N, splits, x_type, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// G groups of rows back to back: x (P, K), group e in rows [offsets[e],
// offsets[e + 1]) against expert e of pw (G, ceil(K / F), N) and scale (G,
// N), into y (P, N); offsets int32 (G + 1), on the card.  Rows outside
// every group are not written.  x_type as above.
template <int BITS>
int packed_grouped(const void* x, const int8_t* w, const float* s, void* y,
                   const int* off, int G, int P, int K, int N, int x_type,
                   cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (x_type == 0)
    return rt::launch_gemm_grouped<BITS>(static_cast<const float*>(x), w, s,
                                         static_cast<float*>(y), off, G, P,
                                         K, N, st);
  if (x_type == 1)
    return rt::launch_gemm_grouped<BITS>(static_cast<const bf16*>(x), w, s,
                                         static_cast<bf16*>(y), off, G, P,
                                         K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int packed_matmul_grouped_fwd(const void* x, const void* pw,
                                         const void* scale, void* y,
                                         const void* offsets, int G, int P,
                                         int K, int N, int store_bits,
                                         int x_type, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(pw);
  const float* s = static_cast<const float*>(scale);
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (store_bits == 4)
    return packed_grouped<4>(x, w, s, y, off, G, P, K, N, x_type, st);
  if (store_bits == 2)
    return packed_grouped<2>(x, w, s, y, off, G, P, K, N, x_type, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A whole mixed-QBN PackedWeight in one tensor-core launch
// (gemm_tiles.cuh's gemm_tc_mixed): y (.., N) in the policy's channel
// order, pruned channels zero.  Part i of n_parts: stored weight w_i,
// scales s_i, output channels c_i (int64 on the card), width n_i, first
// column tile t_i and stage id st_i, as kernels/packed_matmul.py::
// mixed_table lays them out (unused parts: null and 0).  offsets null: x
// (E, M, K), y (E, M, N); else grouped, E groups of the P = M rows of x
// (P, K) with offsets int32 (E + 1) on the card, y (P, N), rows outside
// every group not written.  x_type as above.
extern "C" int packed_mixed_fwd(
    const void* x, void* y, const void* offsets, const void* w0,
    const void* s0, const void* c0, const void* w1, const void* s1,
    const void* c1, const void* w2, const void* s2, const void* c2,
    const void* w3, const void* s3, const void* c3, int n0, int t0, int st0,
    int n1, int t1, int st1, int n2, int t2, int st2, int n3, int t3,
    int st3, int n_parts, int E, int M, int K, int N, int x_type,
    void* stream) {
  using bf16 = __nv_bfloat16;
  auto part = [](const void* w, const void* s, const void* c, int n, int t,
                 int st) {
    return rt::MixedPart{static_cast<const int8_t*>(w),
                         static_cast<const float*>(s),
                         static_cast<const long long*>(c), n, t, st};
  };
  const rt::MixedPart parts[rt::MIXED_PARTS] = {
      part(w0, s0, c0, n0, t0, st0), part(w1, s1, c1, n1, t1, st1),
      part(w2, s2, c2, n2, t2, st2), part(w3, s3, c3, n3, t3, st3)};
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_type == 0)
    return rt::launch_gemm_mixed(static_cast<const float*>(x), parts, n_parts,
                                 static_cast<float*>(y), off, E, M, K, N, st);
  if (x_type == 1)
    return rt::launch_gemm_mixed(static_cast<const bf16*>(x), parts, n_parts,
                                 static_cast<bf16*>(y), off, E, M, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
