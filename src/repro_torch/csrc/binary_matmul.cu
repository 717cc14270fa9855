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
// Bound on an H100: by bytes where N is narrow (CIF10's conv0 and conv1,
// N = 32: the im2col rows of x, 604 MB at conv1, dominate), else by the
// 2 M K N fp32 operations at 67 TFLOP/s.  The Pallas kernel runs one MXU
// product per plane (2 P M K N operations); here the planes are folded
// first, W[k, n] = sum_p alpha[p, n] * B_p[k, n] (planes in order, fmaf,
// fp32), and one fp32 product over W follows: 2 M K N operations.
//
// Design:
//  * Fold once per call.  fold_planes writes W into a (Kp, Np) fp32
//    scratch that the wrapper allocates (Kp = K rounded up to 32, Np = N
//    rounded up to 128, zeros in the padding), and every block of the
//    product then reads W through L2.  The alternative, each block folding
//    its whole K x BN slab into shared memory, does not fit at conv5
//    (1152 x 128 x 4 B = 576 KB) and repeats the fold in every block row
//    (1024 of them at conv1); the scratch costs one small launch and
//    K x Np x 4 bytes (0.6 MB at conv5).  The padded scratch also makes
//    every W tile 16-byte aligned and in range, so its loads need no mask,
//    even at the fc's N = 10.
//  * A tile width that follows N: BN = 16, 32, 64 or 128, the smallest
//    that covers N (up to 128), so a narrow conv computes no masked
//    columns.  Each of the 256 threads holds an 8 x 4 register tile, so
//    narrow tiles cover more rows: BM = 512 at BN = 16, 256 at 32, 128 at
//    64, 64 at 128.  (On an H100, 8 x 4 with K steps of 32 beat 8 x 8
//    with steps of 16 at every CIF10 shape: 8 x 8 spills at 128 registers,
//    and two blocks an SM need both.)
//  * x is streamed asynchronously: x and W tiles of BK = 32 columns (16 at
//    BN = 16, whose 512-row tile would not leave room for two blocks an SM)
//    are staged with cp.async into two shared-memory buffers, so the copy
//    of tile t + 1 overlaps the FMAs on tile t.  Rows of x are 16-byte copies
//    where K % 4 == 0 and x is 16-byte aligned, else 4-byte copies (conv0:
//    K = 27, rows 108 B apart).  Rows and columns past the edge are
//    zero-filled by the copy or masked at the store; the caller's tensors
//    are never padded.
//  * CUDA cores, no TF32 (which keeps ~3 decimal digits and would break
//    the rtol 1e-4 parity of tests/test_packed.py).  Each output sums its
//    K products in order; the plain version sums per-plane products
//    instead, so the two agree to a tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_PLANES = 8;
constexpr int NT = 256;            // threads per block
constexpr int TM = 8, TN = 4;      // a thread's register tile
constexpr int KPAD = 32;           // scratch rows pad to this (every BK)
constexpr int WCOLS = 128;         // scratch columns pad to this (every BN)

template <int BN, int BK>
struct Shape {
  static constexpr int BKP = BK + 4;      // x row stride, 16-byte aligned
  static constexpr int CG = BN / TN;      // threads across the tile
  static constexpr int RG = NT / CG;      // threads down the tile
  static constexpr int BM = RG * TM;
  static constexpr size_t smem =
      sizeof(float) * 2 * ((size_t)BM * BKP + (size_t)BK * BN);
  static_assert(NT % CG == 0 && KPAD % BK == 0, "tile shape");
};

// W[k, n] = sum_p alpha[p, n] * B_p[k, n], planes in order, for k < K and
// n < N; 0 in the padding of the (Kp, ldw) scratch.
__global__ void fold_planes(const int8_t* __restrict__ planes,
                            const float* __restrict__ alpha,
                            float* __restrict__ w, int K, int N, int P,
                            int Kp, int ldw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Kp * ldw) return;
  const int k = static_cast<int>(i / ldw), n = static_cast<int>(i % ldw);
  float wv = 0.f;
  if (k < K && n < N) {
    const int8_t* src = planes + (size_t)k * N + n;
    const size_t plane = (size_t)K * N;
    for (int p = 0; p < P; ++p)
      wv = fmaf(alpha[(size_t)p * N + n], static_cast<float>(src[p * plane]),
                wv);
  }
  w[i] = wv;
}

template <int BN, int BK, bool VEC>
__global__ void __launch_bounds__(NT, 2)
bitplane_gemm(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int M, int K, int N, int ldw,
              int yvec) {
  using S = Shape<BN, BK>;
  constexpr int CG = S::CG, RG = S::RG, BM = S::BM, BKP = S::BKP;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [2][BM][BKP]
  float* Bs = As + 2 * BM * BKP;                 // [2][BK][BN]
  const int tid = threadIdx.x, tc = tid % CG, tr = tid / CG;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  auto stage = [&](int buf, int kt) {
    const int k0 = kt * BK;
    float* a = As + buf * BM * BKP;
    if (VEC) {
      constexpr int CPR = BK / 4;                // 16-byte chunks per row
#pragma unroll
      for (int it = 0; it < BM * CPR / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i / CPR, c = (i % CPR) * 4;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        rt::cp_async16(a + r * BKP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < BM * BK / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i / BK, c = i % BK;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        rt::cp_async4(a + r * BKP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    }
    float* b = Bs + buf * BK * BN;
    constexpr int BCH = BK * BN / 4;             // 16-byte chunks of W
#pragma unroll
    for (int it = 0; it < (BCH + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (i < BCH) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        rt::cp_async16(b + r * BN + c, w + (size_t)(k0 + r) * ldw + n0 + c,
                       true);
      }
    }
    rt::cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (nk > 0) stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, kt + 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    const float* a = As + (kt & 1) * BM * BKP + tr * BKP;
    const float* b = Bs + (kt & 1) * BK * BN + tc * 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + i * RG * BKP + k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const float4 t =
            *reinterpret_cast<const float4*>(b + (k4 + kq) * BN);
        const float bv[TN] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = kq == 0 ? av[i].x
                         : kq == 1 ? av[i].y
                         : kq == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr + i * RG;
    if (gm >= M) continue;
    float* yr = y + (size_t)gm * N;
    const int n = n0 + tc * TN;
    if (yvec && n + 3 < N) {
      *reinterpret_cast<float4*>(yr + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < N) yr[n + j] = acc[i][j];
    }
  }
}

template <int BN, int BK, bool VEC>
int launch(const float* x, const float* w, float* y, int M, int K, int N,
           int ldw, int yvec, cudaStream_t stream) {
  using S = Shape<BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      bitplane_gemm<BN, BK, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + S::BM - 1) / S::BM, (N + BN - 1) / BN);
  bitplane_gemm<BN, BK, VEC><<<grid, NT, S::smem, stream>>>(x, w, y, M, K, N,
                                                           ldw, yvec);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_for_n(const float* x, const float* w, float* y, int M, int K,
                 int N, int ldw, int yvec, cudaStream_t stream) {
  if (N <= 16) return launch<16, 16, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
  if (N <= 32) return launch<32, 32, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
  if (N <= 64) return launch<64, 32, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
  return launch<128, 32, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
}

}  // namespace

// `w_scratch` holds Kp x Np fp32 values (Kp = K rounded up to 32, Np = N
// rounded up to 128; kernels/binary_matmul.py allocates it).  Returns
// cudaGetLastError() right after the launches (the fold, then the product),
// or cudaErrorInvalidValue for P outside 1..8.
extern "C" int binary_matmul_f32(const void* x, const void* planes,
                                 const void* alpha, void* w_scratch, void* y,
                                 int M, int K, int N, int P, void* stream) {
  if (P < 1 || P > MAX_PLANES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = (K + KPAD - 1) / KPAD * KPAD;
  const int ldw = (N + WCOLS - 1) / WCOLS * WCOLS;
  float* w = static_cast<float*>(w_scratch);
  if (Kp > 0) {
    const size_t total = (size_t)Kp * ldw;
    fold_planes<<<(unsigned)((total + NT - 1) / NT), NT, 0, st>>>(
        static_cast<const int8_t*>(planes), static_cast<const float*>(alpha),
        w, K, N, P, Kp, ldw);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const int yvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch_for_n<true>(xf, w, yf, M, K, N, ldw, yvec, st)
             : launch_for_n<false>(xf, w, yf, M, K, N, ldw, yvec, st);
}
