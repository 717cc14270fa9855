// Shared by the attention kernels K1 (flash_attention.cu) and K4
// (paged_attention.cu): the block shape, the shared-memory layout, the
// staging of the block's query rows, the positional mask, the store of a
// K/V tile, and one online-softmax update of a block's 32 query rows over
// a 32-row K/V tile held in shared memory.  Each kernel keeps only its own
// walk over K/V and its own K/V source.
//
// A block has 256 threads; 8 threads own a query row (position x head):
// each holds 4 of the tile's 32 scores and D / 8 accumulator columns, so
// the row max and sum are 3 shuffles.  Numerics follow the reference's
// _online_update (repro/kernels/attention.py:96-115): m_safe = m if finite
// else 0, alpha = 0 while m is -inf, so a tile that no row can attend
// leaves m, l and acc bit for bit unchanged (the kernels skip such tiles
// before loading them), and the final divide by max(l, 1e-30) turns an
// all-masked row into exact zeros.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace attn {

constexpr int NT = 256;            // threads per block
constexpr int ROWS = 32;           // query rows (position x head) per block
constexpr int TPR = NT / ROWS;     // threads per row
constexpr int BKV = 32;            // kv rows per tile
constexpr int SPT = BKV / TPR;     // scores per thread
constexpr int DMAX = 256;
constexpr int DPT = DMAX / TPR;    // accumulator columns per thread (max)
constexpr int SENT = INT_MAX;      // POS_SENTINEL: never attended

// Dynamic shared memory of a block: Q (ROWS x D+1, pre-scaled), K
// (BKV x D+1), V (BKV x D) and P (ROWS x BKV+1) in fp32, ~100 KB at
// D = 256 (rows padded by one float against bank conflicts).
inline size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)ROWS * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
          (size_t)ROWS * (BKV + 1));
}

struct Tiles {
  float* Qs;   // ROWS x (D + 1), pre-scaled
  float* Ks;   // BKV x (D + 1)
  float* Vs;   // BKV x D
  float* Ps;   // ROWS x (BKV + 1)
};

__device__ __forceinline__ Tiles carve(float* smem, int D) {
  Tiles t;
  t.Qs = smem;
  t.Ks = t.Qs + ROWS * (D + 1);
  t.Vs = t.Ks + BKV * (D + 1);
  t.Ps = t.Vs + BKV * D;
  return t;
}

// Stages the block's query rows: the G heads of kv head h at positions
// q0 .. q0 + BQ - 1 of batch row b (q is (B, Sq, Hq, D), q_pos (B, Sq)),
// pre-scaled into Qs, with zeros for rows past the tile or past Sq; their
// positions into qps (0 for those rows).  qlo / qhi get the lowest and
// highest position of the sub-tile, sentinels left out when skip_sent
// (qlo > qhi when nothing is left).  Ends with __syncthreads.
__device__ __forceinline__ void load_q(const float* q, const int* qpos,
                                       float* Qs, int* qps, int& qlo,
                                       int& qhi, int b, int h, int q0, int Sq,
                                       int Hq, int D, int G, int BQ,
                                       float scale, bool skip_sent) {
  const int tid = threadIdx.x;
  const int DS = D + 1;
  const int rows = BQ * G;
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
      if (skip_sent && p == SENT) continue;
      lo = min(lo, p);
      hi = max(hi, p);
    }
    qlo = lo;
    qhi = hi;
  }
  __syncthreads();
}

// Stores columns d .. d + 3 of tile slot j: kv into Ks, vv into Vs.
__device__ __forceinline__ void tile_store(const Tiles& t, int j, int d,
                                           int D, float4 kv, float4 vv) {
  float* kd = t.Ks + j * (D + 1) + d;
  kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
  float* vd = t.Vs + j * D + d;
  vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
}

__device__ __forceinline__ bool attendable(int kp, int qp, int causal,
                                           int window) {
  return kp != SENT && (!causal || kp <= qp) &&
         (window <= 0 || (long long)kp > (long long)qp - window);
}

// One online-softmax step of query row r (position qp) over the tile in
// Ks / Vs, whose slots carry positions kps.  Thread l8 of the row's 8
// holds scores l8 + 8 i and accumulator columns l8 + 8 j.  The softcap
// cap * tanh(s / cap) comes before the mask.
__device__ __forceinline__ void tile_update(
    const Tiles& t, const int* kps, int qp, int r, int l8, int D,
    int causal, int window, float cap, float& m_i, float& l_i,
    float (&acc)[DPT]) {
  const float* Qs = t.Qs;
  const float* Ks = t.Ks;
  const float* Vs = t.Vs;
  float* Ps = t.Ps;
  const int DS = D + 1;
  const int nd = D / TPR;
  float s[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) s[i] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float qv = Qs[r * DS + d];
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      s[i] = fmaf(qv, Ks[(l8 + TPR * i) * DS + d], s[i]);
  }
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

// The block's result for row r: acc / max(l, 1e-30) into orow[0..D).
__device__ __forceinline__ void write_row(float* orow, int l8, int D,
                                          float l_i,
                                          const float (&acc)[DPT]) {
  const int nd = D / TPR;
  const float denom = fmaxf(l_i, 1e-30f);
#pragma unroll
  for (int j = 0; j < DPT; ++j)
    if (j < nd) orow[l8 + TPR * j] = acc[j] / denom;
}

}  // namespace attn
