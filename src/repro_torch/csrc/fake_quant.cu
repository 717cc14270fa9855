// B5: per-channel quantize-dequantize of x (M, N) f32 with per-column
// scale, levels and bits (N,):
//   y = 0                                   where bits <= 0.5 (pruned)
//       x                                   where bits >= full_bits
//       (full_bits: quant/linear_quant.py::FULL_BITS, from the wrapper)
//       clip(rint(x / scale), -lv, lv) * scale   otherwise.
//
// Replaces the TPU kernel repro/kernels/fake_quant.py::fake_quant_pallas
// (_kernel at :19, pallas_call at :40): the weight fake-quant of every
// QUANT evaluation of the AutoQ search (repro_torch/core/evaluate.py), where
// the per-channel amax reduction stays outside, as the Pallas kernel's
// docstring has it.
//
// Bound on an H100 by bytes: x is read once and y written once (8 bytes an
// element), a handful of operations each.  The design streams rows with
// 16-byte loads along N (4 columns a thread, 32 x 4 = 128 columns a
// block) and keeps each thread's 4 columns of scale, levels and bits in
// registers for every row it visits; a block walks rows with a stride, so
// the grid stays at about 2048 blocks whatever M is.  Ragged N falls back
// to scalar loads of the same 4 columns.
//
// Bit for bit the plain version (repro_torch/kernels/ref.py::
// fake_quant_ref): rintf rounds half to even as torch.round does, x / s is
// the IEEE division (this library is built without --use_fast_math, so
// nvcc keeps -prec-div=true), and clip then scale are single roundings.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int FQ_TX = 32, FQ_TY = 8;      // threads: columns x rows
constexpr int FQ_COLS = 4 * FQ_TX;        // columns a block
constexpr int FQ_MAX_BLOCKS = 2048;

__device__ __forceinline__ float fq(float x, float s, float lv, float b,
                                    float full) {
  if (b <= 0.5f) return 0.f;
  if (b >= full) return x;
  return fminf(fmaxf(rintf(x / s), -lv), lv) * s;
}

template <bool VEC>
__global__ void __launch_bounds__(FQ_TX * FQ_TY)
fake_quant_rows(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ levels,
                const float* __restrict__ bits, float* __restrict__ y, int M,
                int N, float full) {
  const int c0 = blockIdx.x * FQ_COLS + threadIdx.x * 4;
  if (c0 >= N) return;
  float s[4], lv[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = c0 + j < N;
    s[j] = in ? scale[c0 + j] : 1.f;
    lv[j] = in ? levels[c0 + j] : 1.f;
    b[j] = in ? bits[c0 + j] : 0.f;
  }
  for (int r = blockIdx.y * FQ_TY + threadIdx.y; r < M;
       r += gridDim.y * FQ_TY) {
    const size_t off = (size_t)r * N + c0;
    if (VEC) {
      float4 v = *reinterpret_cast<const float4*>(x + off);
      v.x = fq(v.x, s[0], lv[0], b[0], full);
      v.y = fq(v.y, s[1], lv[1], b[1], full);
      v.z = fq(v.z, s[2], lv[2], b[2], full);
      v.w = fq(v.w, s[3], lv[3], b[3], full);
      *reinterpret_cast<float4*>(y + off) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < N) y[off + j] = fq(x[off + j], s[j], lv[j], b[j], full);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
extern "C" int fake_quant_f32(const void* x, const void* scale,
                              const void* levels, const void* bits, void* y,
                              int M, int N, float full_bits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int gx = (N + FQ_COLS - 1) / FQ_COLS;
  const int rows = (M + FQ_TY - 1) / FQ_TY;
  int gy = FQ_MAX_BLOCKS / gx;
  gy = gy < 1 ? 1 : (gy > rows ? rows : gy);
  gy = gy > 65535 ? 65535 : gy;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(gx, gy), block(FQ_TX, FQ_TY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  const float* lf = static_cast<const float*>(levels);
  const float* bf = static_cast<const float*>(bits);
  float* yf = static_cast<float*>(y);
  if (vec)
    fake_quant_rows<true><<<grid, block, 0, st>>>(xf, sf, lf, bf, yf, M, N,
                                                  full_bits);
  else
    fake_quant_rows<false><<<grid, block, 0, st>>>(xf, sf, lf, bf, yf, M, N,
                                                   full_bits);
  return static_cast<int>(cudaGetLastError());
}
