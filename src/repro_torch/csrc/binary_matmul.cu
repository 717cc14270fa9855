// B6: bit-plane matmul, y (M, N) = sum_p alpha[p, n] * (x @ B_p) with
// P <= 8 sign planes B_p in {-1, +1} stored (P, K, N) int8 and alpha (P, N)
// f32.  x and y are fp32 (binary_matmul_f32) or bf16 (binary_matmul_bf16:
// the sum in fp32, y rounded once to nearest even), as the Pallas kernel
// writes x's dtype.
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
//    where a row is a whole number of them and x is 16-byte aligned (K % 4
//    == 0 in fp32, K % 8 == 0 in bf16), else 4-byte copies in fp32 and
//    plain 2-byte loads in bf16 (conv0: K = 27, rows 108 or 54 B apart; a
//    54-byte row starts on a 2-byte boundary, below cp.async's 4).  Rows
//    and columns past the edge are zero-filled by the copy or masked at
//    the store; the caller's tensors are never padded.
//  * A bf16 x is staged as stored (half the copies of fp32), then each
//    landed tile is widened once into an fp32 tile that the FMA loop reads
//    as it reads an fp32 x, so no value is converted by each of the CG
//    threads that read it.  bf16 is exact in fp32, so the products and
//    sums are fp32's, and only y is rounded, once.  Each staged x row is
//    padded by 16 bytes (4 fp32 or 8 bf16 values), which keeps 16-byte
//    copies aligned.
//  * CUDA cores, no TF32 (which keeps ~3 decimal digits and would break
//    the rtol 1e-4 parity of tests/test_packed.py).  Each output sums its
//    K products in order; the plain version sums per-plane products
//    instead, so the two agree to a tolerance, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_PLANES = 8;
constexpr int NT = 256;            // threads per block
constexpr int TM = 8, TN = 4;      // a thread's register tile
constexpr int KPAD = 32;           // scratch rows pad to this (every BK)
constexpr int WCOLS = 128;         // scratch columns pad to this (every BN)

template <typename XT, int BN, int BK>
struct Shape {
  static constexpr int EPC = 16 / (int)sizeof(XT);  // x values a 16-B copy
  static constexpr int BKP = BK + EPC;    // x row stride, 16-byte aligned
  static constexpr int CG = BN / TN;      // threads across the tile
  static constexpr int RG = NT / CG;      // threads down the tile
  static constexpr int BM = RG * TM;
  // a bf16 x tile is widened once into an fp32 tile (row stride AST)
  // that the FMA loop reads; an fp32 tile is read where it landed
  static constexpr bool WIDEN = sizeof(XT) != sizeof(float);
  static constexpr int AST = WIDEN ? BK + 4 : BKP;
  static constexpr size_t smem =
      2 * ((size_t)BM * BKP * sizeof(XT) + sizeof(float) * (size_t)BK * BN) +
      (WIDEN ? sizeof(float) * (size_t)BM * AST : 0);
  static_assert(NT % CG == 0 && KPAD % BK == 0 && BK % EPC == 0 &&
                    BM * (BK / EPC) % NT == 0 && BM * BK % NT == 0 &&
                    BM * BK / 4 % NT == 0,
                "tile shape");
};

// 4 consecutive bf16 values of a shared-memory row, widened to fp32
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4 outputs to y (p 16-byte aligned in fp32, 8-byte in bf16)
__device__ __forceinline__ void store4(float* p, const float (&v)[TN]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[TN]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename XT, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(NT, 2)
bitplane_gemm(const XT* __restrict__ x, const float* __restrict__ w,
              XT* __restrict__ y, int M, int K, int N, int ldw, int yvec) {
  using S = Shape<XT, BN, BK>;
  constexpr int CG = S::CG, RG = S::RG, BM = S::BM, BKP = S::BKP;
  constexpr int AST = S::AST;
  extern __shared__ float4 smem4[];
  XT* As = reinterpret_cast<XT*>(smem4);                     // [2][BM][BKP]
  float* Bs = reinterpret_cast<float*>(As + 2 * BM * BKP);   // [2][BK][BN]
  float* Af = Bs + 2 * BK * BN;                  // [BM][AST], WIDEN only
  const int tid = threadIdx.x, tc = tid % CG, tr = tid / CG;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  auto stage = [&](int buf, int kt) {
    const int k0 = kt * BK;
    XT* a = As + buf * BM * BKP;
    if constexpr (VEC) {
      constexpr int EPC = S::EPC, CPR = BK / EPC;   // 16-byte chunks a row
#pragma unroll
      for (int it = 0; it < BM * CPR / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i / CPR, c = (i % CPR) * EPC;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        rt::cp_async16(a + r * BKP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    } else if constexpr (sizeof(XT) == 4) {
#pragma unroll 4
      for (int it = 0; it < BM * BK / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i / BK, c = i % BK;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        rt::cp_async4(a + r * BKP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    } else {
      // 2-byte values: plain loads, a group in flight at a time, then
      // stored (the barrier after the wait below orders them for readers)
      constexpr int ITS = BM * BK / NT, G = ITS < 16 ? ITS : 16;
      static_assert(ITS % G == 0, "load groups");
#pragma unroll
      for (int g0 = 0; g0 < ITS; g0 += G) {
        XT v[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int i = tid + (g0 + j) * NT;
          const int gm = m0 + i / BK, gk = k0 + i % BK;
          v[j] = gm < M && gk < K ? x[(size_t)gm * K + gk]
                                  : __float2bfloat16_rn(0.f);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int i = tid + (g0 + j) * NT;
          a[(i / BK) * BKP + i % BK] = v[j];
        }
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
    const float* a;
    if constexpr (S::WIDEN) {
      // each x value widened once here, not by each of the CG threads
      // that read it below
      const XT* src = As + (kt & 1) * BM * BKP;
#pragma unroll
      for (int it = 0; it < BM * BK / 4 / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        *reinterpret_cast<float4*>(Af + r * AST + c) =
            load4f(src + r * BKP + c);
      }
      __syncthreads();
      a = Af + tr * AST;
    } else {
      a = As + (kt & 1) * BM * BKP + tr * BKP;
    }
    const float* b = Bs + (kt & 1) * BK * BN + tc * 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + i * RG * AST + k4);
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
    XT* yr = y + (size_t)gm * N;
    const int n = n0 + tc * TN;
    if (yvec && n + 3 < N) {
      store4(yr + n, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < N) store1(yr + n + j, acc[i][j]);
    }
  }
}

template <typename XT, int BN, int BK, bool VEC>
int launch(const XT* x, const float* w, XT* y, int M, int K, int N, int ldw,
           int yvec, cudaStream_t stream) {
  using S = Shape<XT, BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      bitplane_gemm<XT, BN, BK, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + S::BM - 1) / S::BM, (N + BN - 1) / BN);
  bitplane_gemm<XT, BN, BK, VEC><<<grid, NT, S::smem, stream>>>(
      x, w, y, M, K, N, ldw, yvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, bool VEC>
int launch_for_n(const XT* x, const float* w, XT* y, int M, int K, int N,
                 int ldw, int yvec, cudaStream_t stream) {
  if (N <= 16)
    return launch<XT, 16, 16, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
  if (N <= 32)
    return launch<XT, 32, 32, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
  if (N <= 64)
    return launch<XT, 64, 32, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
  return launch<XT, 128, 32, VEC>(x, w, y, M, K, N, ldw, yvec, stream);
}

// The fold, then the product, on `stream`.
template <typename XT>
int run(const void* x, const void* planes, const void* alpha,
        void* w_scratch, void* y, int M, int K, int N, int P,
        void* stream) {
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
  const XT* xt = static_cast<const XT*>(x);
  XT* yt = static_cast<XT*>(y);
  constexpr int EPC = Shape<XT, 16, 16>::EPC;
  const int yvec = N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (4 * sizeof(XT)) == 0;
  const bool vec = K % EPC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch_for_n<XT, true>(xt, w, yt, M, K, N, ldw, yvec, st)
             : launch_for_n<XT, false>(xt, w, yt, M, K, N, ldw, yvec, st);
}

}  // namespace

// `w_scratch` holds Kp x Np fp32 values (Kp = K rounded up to 32, Np = N
// rounded up to 128; kernels/binary_matmul.py allocates it).  x and y are
// fp32 (f32) or bf16 (bf16); planes int8, alpha fp32 in both.  Returns
// cudaGetLastError() right after the launches (the fold, then the product),
// or cudaErrorInvalidValue for P outside 1..8.
extern "C" int binary_matmul_f32(const void* x, const void* planes,
                                 const void* alpha, void* w_scratch, void* y,
                                 int M, int K, int N, int P, void* stream) {
  return run<float>(x, planes, alpha, w_scratch, y, M, K, N, P, stream);
}

extern "C" int binary_matmul_bf16(const void* x, const void* planes,
                                  const void* alpha, void* w_scratch,
                                  void* y, int M, int K, int N, int P,
                                  void* stream) {
  return run<__nv_bfloat16>(x, planes, alpha, w_scratch, y, M, K, N, P,
                            stream);
}
