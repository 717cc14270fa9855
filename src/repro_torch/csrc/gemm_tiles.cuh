// The GEMM shared by quant_matmul.cu (int8, BITS = 8) and packed_matmul.cu
// (int4 / int2, BITS = 4 / 2): y (M, N) = x (M, K) @ W, with W staged into
// fp32 tile by tile from its stored form by a weight source (PackedRows
// below).  B6 (binary_matmul.cu) has its own pipelined product.
//
// PackedRows: w is stored (ceil(K / F), N) int8 with F = 8 / BITS values of
// one column per byte, packed along K as repro/kernels/pack.py lays them
// out: field i of packed row r is K row r * F + i, lowest-order field
// first, two's complement (field() below is pack.extract_fields on the
// card).  For BITS = 8 this is the plain (K, N) int8 matrix; W is
// w * scale[None, :].  Rows past the logical K are masked here, so the
// caller pads nothing.
//
// Numerics: products and sums in fp32 on CUDA cores (no TF32 tensor cores,
// which keep ~3 decimal digits and would break the rtol 1e-4 parity of
// tests/test_packed.py); the per-channel scale multiplies the finished
// accumulator once, the placement of the Pallas kernels.
//
// Two launch shapes:
//  * gemm_tiled, for M > SKINNY_M (prefill): 128 x 128 output tiles, 256
//    threads with 8 x 8 outputs each, K in steps of 8 through shared
//    memory; the weight source converts its stored form into fp32 as the
//    tile is staged.  Bound by operations at prefill sizes.
//  * gemm_skinny, for M <= SKINNY_M (decode, the last-token logits): bound
//    by the weight bytes, so each warp reads 128 contiguous bytes per
//    packed row (4 columns a thread), warps split the rows, and when the
//    columns alone give too few blocks the rows are also split across
//    blocks (ksplit) into fp32 partials that gemm_reduce sums in a fixed
//    order (deterministic, no atomics).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace rt {

constexpr int SKINNY_M = 8;

template <int BITS>
__device__ __forceinline__ float field(int byte, int i) {
  constexpr int mask = (1 << BITS) - 1;
  const int m = (byte >> (BITS * i)) & mask;
  return static_cast<float>(m - ((m >> (BITS - 1)) << BITS));
}

// ---------------------------------------------------------------- tiled
constexpr int TBM = 128, TBN = 128, TBK = 8, TT = 16;  // TT x TT threads
typedef float WTile[TBK][TBN];

// Weight source of the packed store: int8 / int4 / int2 packed along K,
// one scale per column applied to the finished accumulator.
template <int BITS>
struct PackedRows {
  static constexpr int F = 8 / BITS;
  static_assert(TBK % F == 0, "a K step must hold whole packed rows");
  const int8_t* w;
  const float* scale;

  __device__ void begin(int, int, int) {}
  __device__ void stage(WTile& Bs, int k0, int n0, int K, int N,
                        int tid) const {
    const int Kp = (K + F - 1) / F;
    for (int i = tid; i < (TBK / F) * TBN; i += TT * TT) {
      const int pr = i / TBN, c = i % TBN;
      const int grow = k0 / F + pr, gn = n0 + c;
      const int byte = (grow < Kp && gn < N) ? w[(size_t)grow * N + gn] : 0;
#pragma unroll
      for (int f = 0; f < F; ++f)
        Bs[pr * F + f][c] = (grow * F + f < K) ? field<BITS>(byte, f) : 0.f;
    }
  }
  __device__ float col_scale(int n) const { return scale[n]; }
};

template <class W>
__global__ void __launch_bounds__(TT * TT)
gemm_tiled(const float* __restrict__ x, W wsrc, float* __restrict__ y,
           int M, int K, int N) {
  __shared__ float As[TBM][TBK + 1];
  __shared__ float Bs[TBK][TBN];
  const int tid = threadIdx.x;
  const int tr = tid / TT, tc = tid % TT;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  W w = wsrc;
  w.begin(tid, n0, N);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TBK) {
    for (int i = tid; i < TBM * TBK; i += TT * TT) {
      const int r = i / TBK, c = i % TBK;
      const int gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    w.stage(Bs, k0, n0, K, N, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[tr + TT * i][kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tc + TT * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gn = n0 + tc + TT * j;
    if (gn >= N) continue;
    const float s = w.col_scale(gn);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + tr + TT * i;
      if (gm < M) y[(size_t)gm * N + gn] = acc[i][j] * s;
    }
  }
}

// Launch gemm_tiled over weight source `w` on `stream`; returns
// cudaGetLastError() right after the launch.
template <class W>
int launch_tiled(const float* x, const W& w, float* y, int M, int K, int N,
                 cudaStream_t stream) {
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  gemm_tiled<W><<<grid, TT * TT, 0, stream>>>(x, w, y, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- skinny
constexpr int SW = 8;            // warps per block, splitting packed rows
constexpr int SCOLS = 32 * 4;    // columns per block

// out = partial + split * M * N when ksplit > 1 (unscaled), else y (scaled)
template <int BITS>
__global__ void __launch_bounds__(32 * SW)
gemm_skinny(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out,
            int M, int K, int N, int rows_per_split, int ksplit, int vec) {
  constexpr int F = 8 / BITS;
  __shared__ float red[SW][SKINNY_M][SCOLS];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int n0 = blockIdx.x * SCOLS + lane * 4;
  const int Kp = (K + F - 1) / F;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(Kp, r_begin + rows_per_split);
  float acc[SKINNY_M][4];
#pragma unroll
  for (int m = 0; m < SKINNY_M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

#pragma unroll 2
  for (int pr = r_begin + wy; pr < r_end; pr += SW) {
    int b[4] = {0, 0, 0, 0};
    const int8_t* row = w + (size_t)pr * N;
    if (vec && n0 + 3 < N) {
      const char4 v = *reinterpret_cast<const char4*>(row + n0);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = (n0 + c < N) ? row[n0 + c] : 0;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int k = pr * F + f;
      if (k >= K) break;
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = field<BITS>(b[c], f);
#pragma unroll
      for (int m = 0; m < SKINNY_M; ++m) {
        if (m >= M) break;
        const float xv = x[(size_t)m * K + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SKINNY_M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[wy][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  const int tid = wy * 32 + lane;
  for (int i = tid; i < M * SCOLS; i += 32 * SW) {
    const int m = i / SCOLS, c = i % SCOLS;
    const int gn = blockIdx.x * SCOLS + c;
    if (gn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < SW; ++q) s += red[q][m][c];
    if (ksplit == 1)
      out[(size_t)m * N + gn] = s * scale[gn];
    else
      out[((size_t)blockIdx.y * M + m) * N + gn] = s;
  }
}

// y[m, n] = scale[n] * sum over splits of partial[split, m, n], in order
__global__ void gemm_reduce(const float* __restrict__ partial,
                            const float* __restrict__ scale,
                            float* __restrict__ y, int M, int N, int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  float s = 0.f;
  for (int q = 0; q < ksplit; ++q) s += partial[(size_t)q * M * N + i];
  y[i] = s * scale[i % N];
}

// Launch on `stream`; returns cudaGetLastError() right after the launches.
// `partial` holds ksplit * M * N floats when ksplit > 1 (else unused).
template <int BITS>
int launch_gemm(const float* x, const int8_t* w, const float* scale, float* y,
                float* partial, int M, int K, int N, int ksplit,
                cudaStream_t stream) {
  constexpr int F = 8 / BITS;
  if (M > SKINNY_M)
    return launch_tiled(x, PackedRows<BITS>{w, scale}, y, M, K, N, stream);
  const int Kp = (K + F - 1) / F;
  const int rows_per_split = (Kp + ksplit - 1) / ksplit;
  const int vec = (N % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  dim3 grid((N + SCOLS - 1) / SCOLS, ksplit);
  gemm_skinny<BITS><<<grid, dim3(32, SW), 0, stream>>>(
      x, w, scale, ksplit == 1 ? y : partial, M, K, N, rows_per_split, ksplit,
      vec);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || ksplit == 1) return err;
  const size_t total = (size_t)M * N;
  gemm_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, scale, y, M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
