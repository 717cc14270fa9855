// K1: flash-attention forward over a dense KV (prefill and dense-cache
// decode), GQA, causal / sliding-window masking from positions alone, an
// optional tanh softcap, and an fp32 online softmax.
//
// Replaces the TPU kernel repro/kernels/attention.py::flash_attention
// (_flash_kernel at :124, pallas_call at :181).  Layouts are the
// reference's: q (B, Sq, Hq, D), k / v (B, Skv, Hkv, D), q_pos (B, Sq),
// kv_pos (B, Skv) int32, o (B, Sq, Hq, D), all fp32 and contiguous.
//
// Bound on an H100: prefill by fp32 operations (4 D flops per attended
// (query head, key) pair, on CUDA cores: no TF32, whose ~3 decimal digits
// would break the reference tolerance rtol 2e-4 / atol 2e-5); decode
// (Sq = 1) by the bytes of the K/V cache, read once per kv head.
//
// Design:
//  * One block per (q tile, kv head, batch row).  The block holds all
//    G = Hq / Hkv query heads of its kv head for BQ = 32 / G positions, 32
//    query rows in all, so every K/V tile is read once per kv head, as in
//    _flash_kernel.  A loop over KV tiles of 32 rows inside the block takes
//    the place of the TPU's sequential grid axis; m, l and the output
//    accumulator stay in registers for the block's lifetime.
//  * Masking is purely positional (sentinel, causal kp <= qp, window
//    kp > qp - W); the softcap cap * tanh(s / cap) comes before the mask.
//    A tile in which no key can be attended by any query row of the block
//    is skipped before it is loaded.  Skipping is exact: such a tile leaves
//    m, l and acc bit for bit unchanged in the update below.  Causal
//    prefill reads about half the tiles, decode skips the sentinel tail.
//  * The tile update, its numerics and the shared-memory layout (~100 KB
//    at D = 256, set above 48 KB with cudaFuncSetAttribute) are in
//    attn_tile.cuh, shared with the paged kernel K4.
//
// Known weakness: decode at B = 2 on gemma2-2b launches B * Hkv = 8 blocks
// on 132 SMs, each walking the whole cache.  Splitting the KV walk across
// blocks (split-KV) is later work.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace attn;

__global__ void __launch_bounds__(NT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ qpos,
          const int* __restrict__ kvpos, float* __restrict__ o, int Sq,
          int Skv, int Hq, int Hkv, int D, int G, int BQ, int causal,
          int window, float cap, float scale) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, D);
  __shared__ int kps[BKV];
  __shared__ int qps[ROWS];
  __shared__ int qlo, qhi, tile_live;

  const int tid = threadIdx.x;
  const int r = tid / TPR, l8 = tid % TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int qi = r / G, head = h * G + r % G;
  const bool row_ok = r < BQ * G && q0 + qi < Sq;
  load_q(q, qpos, t.Qs, qps, qlo, qhi, b, h, q0, Sq, Hq, D, G, BQ, scale,
         /*skip_sent=*/false);

  float m_i = -INFINITY, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    __syncthreads();
    if (tid == 0) tile_live = 0;
    __syncthreads();
    if (tid < BKV) {
      const int kk = kv0 + tid;
      const int kp = kk < Skv ? kvpos[(size_t)b * Skv + kk] : SENT;
      kps[tid] = kp;
      // some query row of the block may attend kp: checked against the
      // block's highest position (causal) and lowest (window)
      if (kp != SENT && (!causal || kp <= qhi) &&
          (window <= 0 || (long long)kp > (long long)qlo - window))
        tile_live = 1;
    }
    __syncthreads();
    if (!tile_live) continue;

    const int D4 = D / 4;
    for (int i = tid; i < BKV * D4; i += NT) {
      const int j = i / D4, d = (i % D4) * 4;
      const int kk = kv0 + j;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kk < Skv) {
        const size_t off = (((size_t)b * Skv + kk) * Hkv + h) * D + d;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      tile_store(t, j, d, D, kv, vv);
    }
    __syncthreads();

    tile_update(t, kps, qps[r], r, l8, D, causal, window, cap, m_i, l_i,
                acc);
  }

  if (row_ok)
    write_row(o + (((size_t)b * Sq + q0 + qi) * Hq + head) * D, l8, D, l_i,
              acc);
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap.  Returns cudaGetLastError()
// right after the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, void* o, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int D,
                                   int causal, int window, float cap,
                                   float scale, void* stream) {
  if (D % TPR != 0 || D % 4 != 0 || D > DMAX || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv, BQ = ROWS / G;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, Hkv, B);
  flash_fwd<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(o), Sq, Skv, Hq,
      Hkv, D, G, BQ, causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}
