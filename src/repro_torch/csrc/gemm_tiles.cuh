// The GEMM shared by quant_matmul.cu (int8, BITS = 8) and packed_matmul.cu
// (int4 / int2, BITS = 4 / 2): y (M, N) = x (M, K) @ W, W = w * scale[None,
// :], with W read from its stored form by a weight source.  B6
// (binary_matmul.cu) has its own pipelined product.
//
// w is stored (ceil(K / F), N) int8 with F = 8 / BITS values of one column
// per byte, packed along K as repro/kernels/pack.py lays them out: field i
// of packed row r is K row r * F + i, lowest-order field first, two's
// complement (field() below and PackedStage::at are pack.extract_fields
// on the card).  For BITS = 8 this is the plain (K, N) int8 matrix.  Rows
// past the logical K are masked here, so the caller pads nothing.
//
// Two launch shapes:
//  * gemm_tc, for M > SKINNY_M (prefill, run()'s chunk steps): TF32 tensor
//    cores (mma.sync m16n8k8) at fp32 accuracy; see its section below.
//    The weight source stages the stored bytes and converts each value to
//    float as the B fragment is built: Int8Stage for K2, PackedStage for
//    K3 (int8, int4 and int2 values are all exact in TF32).  Bound by the
//    function's 2 M K N operations at the TF32 peak of 495 TFLOP/s (0.71
//    ms at 8320x2304x9216); its two passes make the route's own floor
//    twice that (1.43 ms).
//  * gemm_skinny, for M <= SKINNY_M (decode, the last-token logits): bound
//    by the weight bytes, so each warp reads 128 contiguous bytes per
//    packed row (4 columns a thread), warps split the rows, and when the
//    columns alone give too few blocks the rows are also split across
//    blocks (ksplit) into fp32 partials that gemm_reduce sums in a fixed
//    order (deterministic, no atomics).  Products and sums in fp32.
// Every shape applies the per-channel scale to the finished fp32
// accumulator once, where the Pallas kernels apply it.
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

// ---------------------------------------------------------- tensor cores
// gemm_tc: y = (x @ w) * scale on TF32 tensor cores at fp32 accuracy.
//
// Numerics.  TF32 keeps 10 mantissa bits, so every int8, int4 and int2
// weight (|w| <= 127 < 2048) is exact in it and only x loses bits.  Each x value is split
// in registers at fragment load, hi = rna_tf32(x), lo = rna_tf32(x - hi),
// and two MMAs (hi, then lo, against the same weight fragment) go into one
// fp32 accumulator: x @ w to ~2^-22 of x, against ~2^-11 for one pass.
// One pass fails the reference tolerance (rtol = atol = 1e-4,
// tests/test_packed.py) at K = 9216: emulated on the CPU with x ~ N(0, 1)
// and scales as chip_smoke.py draws them, 1xTF32 ends 5.7e-4 from the
// reference at 64x9216x128 (5.3x over) and 2xTF32 1.3e-7 (fp32 sgemm:
// 1.2e-6); kernels/ref.py::quant_matmul_tf32x2_ref states the emulation.
// The MMA's own fp32 accumulation truncates (rounds toward zero) where it
// adds into its accumulator, a bias that grows with the number of adds: on
// the H100, chaining all 2 K / 8 MMAs into one accumulator ended 1.7e-4
// from the reference at K = 9216.  So each K step's 8 MMAs go into a
// zeroed step accumulator that is then added, with an ordinary
// round-to-nearest fp32 add, into the running sum (a CPU emulation,
// tests/test_torch_split_tf32.py, gives 1.5e-4 chained and 1.6e-6 so).
// The scale multiplies the finished sum once, in fp32.
//
// Design: 128 x 128 block tiles, 256 threads as 4 x 2 warps of 32 x 64
// (2 x 8 m16n8 tiles each; 64 running sums and 64 step accumulators a
// thread, so one block an SM), K steps of 32 through a 3-stage cp.async
// ring.
// x is staged as fp32 with 16-byte copies (4-byte copies with zero-fill
// where K % 4 or x's alignment forbid them), rows padded to 36 floats so
// that the fragment loads hit 32 distinct banks.  The weight is staged as
// its stored bytes (a quarter of fp32's shared memory), rows padded by 16
// bytes against bank conflicts, and each value converted to float while
// the B fragment is built: exact, no cvt to TF32 needed.  Ragged M, N and
// K are zero-filled or masked in the kernel; the caller pads nothing.
// wgmma (the asynchronous warpgroup MMA, the only way to the card's full
// tensor-core rate) waits for a later change: for TF32 it takes both
// operands K-major from shared memory, which here means staging a
// transposed weight.
constexpr int CBM = 128, CBN = 128, CBK = 32, CST = 3;  // tile, K step, ring
constexpr int CNT = 256;                                 // threads
constexpr int CAP = CBK + 4;          // staged x row stride, floats

// Weight source of gemm_tc: int8 (K, N) rows staged as bytes.  VEC: 16-byte
// cp.async copies (N % 16 == 0 and w 16-byte aligned), else byte loads.
template <bool VEC>
struct Int8Stage {
  static constexpr int F = 1;              // values per stored byte
  static constexpr int RS = CBN + 16;      // bytes per staged K row
  static constexpr int BYTES = CBK * RS;   // bytes per stage
  static_assert(CBK * CBN / 16 == CNT, "one 16-byte copy per thread");
  const int8_t* w;
  const float* scale;

  __device__ void stage(int8_t* dst, int k0, int n0, int K, int N,
                        int tid) const {
    if (VEC) {
      const int r = tid / (CBN / 16), c = (tid % (CBN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(dst + r * RS + c, ok ? w + (size_t)gk * N + gn : w, ok);
    } else {
      for (int i = tid; i < CBK * CBN; i += CNT) {
        const int r = i / CBN, c = i % CBN;
        const int gk = k0 + r, gn = n0 + c;
        dst[r * RS + c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0;
      }
    }
  }
  // W at (k, n) of a staged tile, as a float (exact in TF32)
  __device__ __forceinline__ float at(const int8_t* src, int k, int n) const {
    return static_cast<float>(src[k * RS + n]);
  }
  __device__ float col_scale(int n) const { return scale[n]; }
};

// Weight source of gemm_tc for K3: int4 / int2 fields packed along K, a K
// step's CBK / F packed rows staged as bytes (16 rows of int4, 8 of int2)
// and unpacked with field() where the B fragment is built.  VEC: 16-byte
// cp.async copies (N % 16 == 0 and w 16-byte aligned), else byte loads.
template <int BITS, bool VEC>
struct PackedStage {
  static constexpr int F = 8 / BITS;
  static constexpr int PR = CBK / F;       // packed rows per K step
  static constexpr int RS = CBN + 16;      // bytes per staged packed row
  static constexpr int BYTES = PR * RS;    // bytes per stage
  static_assert(CBK % F == 0 && PR * CBN / 16 <= CNT,
                "a K step holds whole packed rows, one copy a thread");
  const int8_t* w;
  const float* scale;

  __device__ void stage(int8_t* dst, int k0, int n0, int K, int N,
                        int tid) const {
    const int Kp = (K + F - 1) / F, r0 = k0 / F;
    if (VEC) {
      if (tid < PR * CBN / 16) {
        const int r = tid / (CBN / 16), c = (tid % (CBN / 16)) * 16;
        const int gr = r0 + r, gn = n0 + c;
        const bool ok = gr < Kp && gn < N;
        cp_async16(dst + r * RS + c, ok ? w + (size_t)gr * N + gn : w, ok);
      }
    } else {
      for (int i = tid; i < PR * CBN; i += CNT) {
        const int r = i / CBN, c = i % CBN;
        const int gr = r0 + r, gn = n0 + c;
        dst[r * RS + c] = (gr < Kp && gn < N) ? w[(size_t)gr * N + gn] : 0;
      }
    }
  }
  // The last K step's packed row that holds the logical K's last field
  // (kmax = K - k0 < CBK, kmax % F != 0): its fields at or past K, e.g.
  // one int4 field at K = 1001, are set to zero in the staged tile, so that
  // they add exact zeros whatever x holds there (rows wholly past K were
  // zero-filled when staged).
  __device__ void mask_tail(int8_t* dst, int kmax, int tid) const {
    const int pr = kmax / F, keep = (1 << (BITS * (kmax % F))) - 1;
    for (int c = tid; c < CBN; c += CNT)
      dst[pr * RS + c] = static_cast<int8_t>(dst[pr * RS + c] & keep);
  }
  // Field k % F of packed row k / F at column n, as a float, exact (int4
  // and int2 are exact in TF32): the field's bits, their sign bit flipped,
  // become the low mantissa bits of 2^23, and one FMA scales and re-centres
  // them (no integer-to-float conversion).  At a fragment's k (a multiple
  // of 8 plus t4 or t4 + 4) the field index is t4 % F, so the masks are
  // the same for every value a thread loads.
  __device__ __forceinline__ float at(const int8_t* src, int k, int n) const {
    constexpr int MASK = (1 << BITS) - 1;
    const int off = BITS * (k % F);
    const int u = (static_cast<int>(src[(k / F) * RS + n]) & (MASK << off)) ^
                  ((1 << (off + BITS - 1)) | 0x4B000000);
    return fmaf(__int_as_float(u), __int_as_float((127 - off) << 23),
                -static_cast<float>((1 << (23 - off)) + (1 << (BITS - 1))));
  }
  __device__ float col_scale(int n) const { return scale[n]; }
};

// VA: x rows in 16-byte copies (K % 4 == 0, x 16-byte aligned).
template <class W, bool VA>
__global__ void __launch_bounds__(CNT, 1)
gemm_tc(const float* __restrict__ x, W wsrc, float* __restrict__ y, int M,
        int K, int N) {
  extern __shared__ float4 tc_smem[];
  float* As = reinterpret_cast<float*>(tc_smem);               // [CST][CBM][CAP]
  int8_t* Bs = reinterpret_cast<int8_t*>(As + CST * CBM * CAP);  // [CST][BYTES]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;
  const int m0 = blockIdx.y * CBM, n0 = blockIdx.x * CBN;
  const int nk = (K + CBK - 1) / CBK;
  const W w = wsrc;

  auto stage = [&](int slot, int kt) {
    const int k0 = kt * CBK;
    float* a = As + slot * CBM * CAP;
    if (VA) {
      constexpr int CPR = CBK / 4;           // 16-byte chunks per row
#pragma unroll
      for (int it = 0; it < CBM * CPR / CNT; ++it) {
        const int i = tid + it * CNT;
        const int r = i / CPR, c = (i % CPR) * 4;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async16(a + r * CAP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < CBM * CBK / CNT; ++it) {
        const int i = tid + it * CNT;
        const int r = i / CBK, c = i % CBK;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async4(a + r * CAP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    }
    w.stage(Bs + slot * W::BYTES, k0, n0, K, N, tid);
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < CST - 1; ++st) {
    if (st < nk)
      stage(st, st);
    else
      cp_async_commit();                   // keep the group count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<CST - 2>();              // step kt's tiles have landed
    __syncthreads();                       // and step kt - 1's reads ended
    if constexpr (W::F > 1) {              // Int8Stage zero-fills past K
      if (K - kt * CBK < CBK && (K - kt * CBK) % W::F != 0) {
        w.mask_tail(Bs + (kt % CST) * W::BYTES, K - kt * CBK, tid);
        __syncthreads();                   // (the same for the whole block)
      }
    }
    const int pf = kt + CST - 1;
    if (pf < nk)
      stage(pf % CST, pf);
    else
      cp_async_commit();
    const float* a = As + (kt % CST) * CBM * CAP;
    const int8_t* bsm = Bs + (kt % CST) * W::BYTES;
    float part[2][8][4];                   // this K step's accumulator
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CBK; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        const float v[4] = {a[r * CAP + kk + t4], a[(r + 8) * CAP + kk + t4],
                            a[r * CAP + kk + t4 + 4],
                            a[(r + 8) * CAP + kk + t4 + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[i][e] = tf32_rna(v[e]);
          alo[i][e] = tf32_rna(v[e] - __uint_as_float(ahi[i][e]));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = wn + j * 8 + g;
        const uint32_t b0 = __float_as_uint(w.at(bsm, kk + t4, n));
        const uint32_t b1 = __float_as_uint(w.at(bsm, kk + t4 + 4, n));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(part[i][j], ahi[i], b0, b1);
          mma_tf32(part[i][j], alo[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gn = n0 + wn + j * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = gn + (e & 1);
      if (n >= N) continue;
      const float sc = w.col_scale(n);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        if (m < M) y[(size_t)m * N + n] = acc[i][j][e] * sc;
      }
    }
  }
}

// Launch gemm_tc over weight source `w` on `stream`; returns the first
// CUDA error of the setup or the launch.
template <class W>
int launch_tc(const float* x, const W& w, float* y, int M, int K, int N,
              cudaStream_t stream) {
  const size_t smem = CST * (sizeof(float) * CBM * CAP + W::BYTES);
  const bool va = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kern = va ? gemm_tc<W, true> : gemm_tc<W, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + CBN - 1) / CBN, (M + CBM - 1) / CBM);
  kern<<<grid, CNT, smem, stream>>>(x, w, y, M, K, N);
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
  if (M > SKINNY_M) {
    const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if constexpr (BITS == 8) {
      if (vec)
        return launch_tc(x, Int8Stage<true>{w, scale}, y, M, K, N, stream);
      return launch_tc(x, Int8Stage<false>{w, scale}, y, M, K, N, stream);
    } else {
      if (vec)
        return launch_tc(x, PackedStage<BITS, true>{w, scale}, y, M, K, N,
                         stream);
      return launch_tc(x, PackedStage<BITS, false>{w, scale}, y, M, K, N,
                       stream);
    }
  }
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
