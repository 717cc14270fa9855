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
//  * 8 threads own a query row: each holds 4 of the tile's 32 scores and
//    D / 8 accumulator columns, so the row max and sum are 3 shuffles.
//  * Masking is purely positional (sentinel, causal kp <= qp, window
//    kp > qp - W); the softcap cap * tanh(s / cap) comes before the mask.
//    A tile in which no key can be attended by any query row of the block
//    is skipped before it is loaded.  Skipping is exact: such a tile leaves
//    m, l and acc bit for bit unchanged in the update below.  Causal
//    prefill reads about half the tiles, decode skips the sentinel tail.
//  * Numerics follow _online_update (attention.py:96-115): m_safe = m if
//    finite else 0, alpha = 0 while m is -inf, the final divide by
//    max(l, 1e-30), so an all-masked row returns exact zeros.
//  * Shared memory: Q (32 x D), K (32 x D), V (32 x D) and P (32 x 32) in
//    fp32, ~100 KB at D = 256 (rows padded by one float against bank
//    conflicts), set above 48 KB with cudaFuncSetAttribute.
//
// Known weakness: decode at B = 2 on gemma2-2b launches B * Hkv = 8 blocks
// on 132 SMs, each walking the whole cache.  Splitting the KV walk across
// blocks (split-KV) is later work.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int ROWS = 32;           // query rows (position x head) per block
constexpr int TPR = NT / ROWS;     // threads per row
constexpr int BKV = 32;            // kv rows per tile
constexpr int SPT = BKV / TPR;     // scores per thread
constexpr int DMAX = 256;
constexpr int DPT = DMAX / TPR;    // accumulator columns per thread (max)
constexpr int SENT = INT_MAX;      // POS_SENTINEL: never attended

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)ROWS * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
          (size_t)ROWS * (BKV + 1));
}

__device__ __forceinline__ bool attendable(int kp, int qp, int causal,
                                           int window) {
  return kp != SENT && (!causal || kp <= qp) &&
         (window <= 0 || (long long)kp > (long long)qp - window);
}

__global__ void __launch_bounds__(NT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ qpos,
          const int* __restrict__ kvpos, float* __restrict__ o, int Sq,
          int Skv, int Hq, int Hkv, int D, int G, int BQ, int causal,
          int window, float cap, float scale) {
  extern __shared__ float smem[];
  const int DS = D + 1;
  float* Qs = smem;                    // ROWS x DS, pre-scaled
  float* Ks = Qs + ROWS * DS;          // BKV x DS
  float* Vs = Ks + BKV * DS;           // BKV x D
  float* Ps = Vs + BKV * D;            // ROWS x (BKV + 1)
  __shared__ int kps[BKV];
  __shared__ int qps[ROWS];
  __shared__ int qlo, qhi, tile_live;

  const int tid = threadIdx.x;
  const int r = tid / TPR, l8 = tid % TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int rows = BQ * G;
  const int qi = r / G, head = h * G + r % G;
  const bool row_ok = r < rows && q0 + qi < Sq;
  const int nd = D / TPR;

  for (int i = tid; i < ROWS * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int qq = rr / G;
    float val = 0.f;
    if (rr < rows && q0 + qq < Sq)
      val = q[(((size_t)b * Sq + q0 + qq) * Hq + h * G + rr % G) * D + d] *
            scale;
    Qs[rr * DS + d] = val;
  }
  if (tid < ROWS) {
    const int qq = tid / G;
    qps[tid] = (tid < rows && q0 + qq < Sq) ? qpos[(size_t)b * Sq + q0 + qq]
                                            : 0;
  }
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int qq = 0; qq < BQ && q0 + qq < Sq; ++qq) {
      const int p = qpos[(size_t)b * Sq + q0 + qq];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    qlo = lo;
    qhi = hi;
  }

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
      float* kd = Ks + j * DS + d;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      float* vd = Vs + j * D + d;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * DS + d];
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        s[i] = fmaf(qv, Ks[(l8 + TPR * i) * DS + d], s[i]);
    }
    const int qp = qps[r];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      float sv = s[i];
      if (cap > 0.f) sv = cap * tanhf(sv / cap);
      s[i] = attendable(kps[l8 + TPR * i], qp, causal, window) ? sv
                                                              : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_i, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const float p = expf(s[i] - m_safe);
      Ps[r * (BKV + 1) + l8 + TPR * i] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float alpha = isfinite(m_i) ? expf(m_i - m_safe) : 0.f;
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (j < nd) acc[j] *= alpha;
    for (int c = 0; c < BKV; ++c) {
      const float pc = Ps[r * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (j < nd) acc[j] = fmaf(pc, Vs[c * D + l8 + TPR * j], acc[j]);
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l_i, 1e-30f);
    float* orow = o + (((size_t)b * Sq + q0 + qi) * Hq + head) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (j < nd) orow[l8 + TPR * j] = acc[j] / denom;
  }
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
