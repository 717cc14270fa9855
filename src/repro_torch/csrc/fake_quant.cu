// B5: per-channel quantize-dequantize of x (M, N) with per-column scale,
// levels and bits (N,) f32:
//   y = 0                                   where bits <= 0.5 (pruned)
//       x                                   where bits >= full_bits
//       (full_bits: quant/linear_quant.py::FULL_BITS, from the wrapper)
//       clip(rint(x / scale), -lv, lv) * scale   otherwise,
// computed in fp32.  x and y are fp32 (fake_quant_f32) or bf16
// (fake_quant_bf16: x widened exactly, y rounded once to nearest even).
//
// Replaces the TPU kernel repro/kernels/fake_quant.py::fake_quant_pallas
// (_kernel at :19, pallas_call at :40): the weight fake-quant of every
// QUANT evaluation of the AutoQ search (repro_torch/core/evaluate.py), where
// the per-channel amax reduction stays outside, as the Pallas kernel's
// docstring has it.  The Pallas kernel takes x of either type and writes
// x's type; so does this one.
//
// Bound on an H100 by bytes: x is read once and y written once (8 bytes an
// element in fp32, 4 in bf16), a handful of operations each.  The design
// streams rows with 16-byte loads along N (4 fp32 or 8 bf16 columns a
// thread, 32 threads across: 128 or 256 columns a block) and keeps each
// thread's columns of scale, levels and bits in registers for every row
// it visits; a block walks rows with a stride, so the grid stays at about
// 2048 blocks whatever M is.  Ragged N (CIF10's fc, N = 10) or a
// misaligned pointer falls back to scalar loads of the same columns.
//
// Bit for bit the plain version (repro_torch/kernels/ref.py::
// fake_quant_ref, which upcasts, computes and casts back): rintf rounds
// half to even as torch.round does, x / s is the IEEE division (this
// library is built without --use_fast_math, so nvcc keeps
// -prec-div=true), clip then scale are single roundings, and a bf16 y is
// the one rounding of that fp32 value (__float2bfloat16_rn, as .to()).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int FQ_TX = 32, FQ_TY = 8;      // threads: columns x rows
constexpr int FQ_MAX_BLOCKS = 2048;

// columns a thread: one 16-byte load of T
template <typename T>
constexpr int FQ_CPT = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float fq(float x, float s, float lv, float b,
                                    float full) {
  if (b <= 0.5f) return 0.f;
  if (b >= full) return x;
  return fminf(fmaxf(rintf(x / s), -lv), lv) * s;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(FQ_TX * FQ_TY)
fake_quant_rows(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ levels,
                const float* __restrict__ bits, T* __restrict__ y, int M,
                int N, float full) {
  constexpr int CPT = FQ_CPT<T>;
  const int c0 = blockIdx.x * (CPT * FQ_TX) + threadIdx.x * CPT;
  if (c0 >= N) return;
  float s[CPT], lv[CPT], b[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const bool in = c0 + j < N;
    s[j] = in ? scale[c0 + j] : 1.f;
    lv[j] = in ? levels[c0 + j] : 1.f;
    b[j] = in ? bits[c0 + j] : 0.f;
  }
  for (int r = blockIdx.y * FQ_TY + threadIdx.y; r < M;
       r += gridDim.y * FQ_TY) {
    const size_t off = (size_t)r * N + c0;
    if constexpr (VEC) {
      alignas(16) T in[CPT], out[CPT];
      *reinterpret_cast<uint4*>(in) =
          *reinterpret_cast<const uint4*>(x + off);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        narrow(&out[j], fq(widen(in[j]), s[j], lv[j], b[j], full));
      *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<uint4*>(out);
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (c0 + j < N)
          narrow(&y[off + j], fq(widen(x[off + j]), s[j], lv[j], b[j], full));
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* levels,
           const void* bits, void* y, int M, int N, float full_bits,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  constexpr int CPT = FQ_CPT<T>, COLS = CPT * FQ_TX;
  const int gx = (N + COLS - 1) / COLS;
  const int rows = (M + FQ_TY - 1) / FQ_TY;
  int gy = FQ_MAX_BLOCKS / gx;
  gy = gy < 1 ? 1 : (gy > rows ? rows : gy);
  gy = gy > 65535 ? 65535 : gy;
  const bool vec = N % CPT == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(gx, gy), block(FQ_TX, FQ_TY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* sf = static_cast<const float*>(scale);
  const float* lf = static_cast<const float*>(levels);
  const float* bf = static_cast<const float*>(bits);
  T* yt = static_cast<T*>(y);
  if (vec)
    fake_quant_rows<T, true><<<grid, block, 0, st>>>(xt, sf, lf, bf, yt, M,
                                                     N, full_bits);
  else
    fake_quant_rows<T, false><<<grid, block, 0, st>>>(xt, sf, lf, bf, yt, M,
                                                      N, full_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() right after the
// launch.  x and y are fp32 (f32) or bf16 (bf16); scale, levels and bits
// are fp32 in both.
extern "C" int fake_quant_f32(const void* x, const void* scale,
                              const void* levels, const void* bits, void* y,
                              int M, int N, float full_bits, void* stream) {
  return launch<float>(x, scale, levels, bits, y, M, N, full_bits, stream);
}

extern "C" int fake_quant_bf16(const void* x, const void* scale,
                               const void* levels, const void* bits, void* y,
                               int M, int N, float full_bits, void* stream) {
  return launch<__nv_bfloat16>(x, scale, levels, bits, y, M, N, full_bits,
                               stream);
}
