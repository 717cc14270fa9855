// Shared by the CUDA-core attention walks of K1 (flash_attention.cu's
// split-KV decode) and K4 (paged_attention.cu): the block shape, the
// shared-memory layout, the staging of the block's query rows, the
// positional mask, the store of a K/V tile, and one online-softmax update
// of a block's 32 query rows over a 32-row K/V tile held in shared memory
// (K1's prefill, flash_tc, runs on the tensor cores with its own
// layout).  Each kernel keeps only its own walk over K/V and its own K/V
// source.  Then the two halves of a split-KV
// decode: the write of a split's unnormalised row state (write_partial)
// and the fixed-order merge of the splits (combine_cols).  Last,
// decode_update: the online-softmax update of a decode block, which holds
// only its R <= 32 real query rows and shares their work among all 256
// threads (K4's split walk; K1's split walk still runs tile_update).
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

// ------------------------------------------------------------ split-KV
// A split-KV walk runs one block per (split, kv head, batch row), each over
// its own run of KV tiles, then a second pass merges the splits.  The
// partials are fp32, (B, Hq, NS, Sq) for m and for l and (B, Hq, NS, Sq, D)
// for acc; only real rows are written.

// Row (b, head, split s, position qi) of the (B, Hq, NS, Sq) partials.
__device__ __forceinline__ size_t partial_row(int b, int head, int s, int qi,
                                              int Hq, int NS, int Sq) {
  return (((size_t)b * Hq + head) * NS + s) * Sq + qi;
}

// Row r's state after its split: m and l (by the row's thread l8 == 0)
// and the unnormalised accumulator columns l8 + 8 j.
__device__ __forceinline__ void write_partial(float* pm, float* pl,
                                              float* pacc, size_t row,
                                              int l8, int D, float m_i,
                                              float l_i,
                                              const float (&acc)[DPT]) {
  if (l8 == 0) {
    pm[row] = m_i;
    pl[row] = l_i;
  }
  float* a = pacc + row * D;
  const int nd = D / TPR;
#pragma unroll
  for (int j = 0; j < DPT; ++j)
    if (j < nd) a[l8 + TPR * j] = acc[j];
}

// Columns d .. d + 3 of one output row from its NS partials (split s at
// row0 + s * stride), merged in split order with no atomics, so the result
// is the same on every run: m = max_s m_s, m_safe = m if finite else 0
// (the reference's _online_update rule), e_s = exp(m_s - m_safe), and
// o = sum_s e_s acc_s / max(sum_s e_s l_s, 1e-30).  A split that attended
// nothing (m_s = -inf, l_s = 0, acc_s = 0) has e_s = 0 and adds exactly
// nothing; a row that attended nothing comes out as exact zeros, as
// write_row gives.
__device__ __forceinline__ float4 combine_cols(const float* pm,
                                               const float* pl,
                                               const float* pacc,
                                               size_t row0, size_t stride,
                                               int NS, int D, int d) {
  float m = -INFINITY;
  for (int s = 0; s < NS; ++s) m = fmaxf(m, pm[row0 + s * stride]);
  const float m_safe = isfinite(m) ? m : 0.f;
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < NS; ++s) {
    const size_t row = row0 + s * stride;
    const float e = expf(pm[row] - m_safe);
    const float4 a = *reinterpret_cast<const float4*>(pacc + row * D + d);
    l += e * pl[row];
    o.x += e * a.x;
    o.y += e * a.y;
    o.z += e * a.z;
    o.w += e * a.w;
  }
  const float denom = fmaxf(l, 1e-30f);
  return make_float4(o.x / denom, o.y / denom, o.z / denom, o.w / denom);
}

// ------------------------------------------------------------- decode
// One online-softmax update of a decode block's R <= ROWS query rows over
// one BKV-slot tile, with all NT threads at work whatever R is (at
// gemma2-2b decode R = G = 2: tile_update would leave 7 of 8 warps idle
// and give each live thread ~2,000 dependent FMAs a tile; here each thread
// makes 64 for the scores and 64 for P V).  Numerics are tile_update's (the reference's
// _online_update): softcap before the mask, m_safe, alpha = 0 while m is
// -inf, so a tile that no row can attend leaves the state unchanged; the
// final divide by max(l, 1e-30) is the merge's (combine_cols).
//
// Qs: R x D pre-scaled queries (row stride D); kv: the tile, read through
// kv.k4(j, d) (K[j][d..d+3]) and kv.v(c, d) (V[c][d]), each element
// dequantized where it is read; kps: the tile's positions; qps: the rows'
// positions.  Ss (R x BKV), ms, ls, as (R) are shared memory: scores then
// probabilities, and each row's m, l and last alpha.  acc[u] holds output
// element i = tid + NT u of the R x D accumulator (row i / D, column
// i % D).  Three phases, with a barrier after each of the first two:
//  1. scores: thread (j = tid / 8, l8 = tid % 8) keeps chunks l8 + 8 i of
//     K row j in registers and, for each row, dots them with the query's
//     chunks; 3 shuffles sum the 8 partials (a quarter-warp reads one
//     128-byte run of K and of Q: no bank conflicts, no padding).
//  2. softmax: warp w takes rows w, w + 8, ..., a lane per slot: max and
//     sum by shuffles, p into Ss, and (lane 0) m, l and alpha.
//  3. P V: each thread rescales its accumulator elements by their row's
//     alpha and adds the tile's BKV products (a warp reads 32 consecutive
//     columns of one V row).
template <class KV>
__device__ __forceinline__ void decode_update(
    const float* Qs, const KV& kv, const int* kps, const int* qps,
    float* Ss, float* ms, float* ls, float* as, int R, int D, int causal,
    int window, float cap, float (&acc)[DPT]) {
  const int tid = threadIdx.x;
  const int D4 = D / 4;
  {
    const int j = tid / TPR, l8 = tid % TPR;
    const int kp = kps[j];
    float4 kr[DMAX / 4 / TPR];
#pragma unroll
    for (int i = 0; i < DMAX / 4 / TPR; ++i)
      if (l8 + TPR * i < D4) kr[i] = kv.k4(j, 4 * (l8 + TPR * i));
    for (int r = 0; r < R; ++r) {
      const float* qr = Qs + r * D;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DMAX / 4 / TPR; ++i) {
        if (l8 + TPR * i < D4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qr + 4 * (l8 + TPR * i));
          s = fmaf(qv.x, kr[i].x, s);
          s = fmaf(qv.y, kr[i].y, s);
          s = fmaf(qv.z, kr[i].z, s);
          s = fmaf(qv.w, kr[i].w, s);
        }
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (l8 == 0) {
        if (cap > 0.f) s = cap * tanhf(s / cap);
        Ss[r * BKV + j] =
            attendable(kp, qps[r], causal, window) ? s : -INFINITY;
      }
    }
  }
  __syncthreads();
  {
    const int lane = tid % 32;
    for (int r = tid / 32; r < R; r += NT / 32) {
      const float s = Ss[r * BKV + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = expf(s - m_safe);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      Ss[r * BKV + lane] = p;
      if (lane == 0) {
        const float alpha = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
        ls[r] = ls[r] * alpha + psum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < DPT; ++u) {
    const int i = tid + NT * u;
    if (i < R * D) {
      const int r = i / D, d = i - r * D;
      const float* pr = Ss + r * BKV;
      float a = acc[u] * as[r];
#pragma unroll 8
      for (int c = 0; c < BKV; ++c) a = fmaf(pr[c], kv.v(c, d), a);
      acc[u] = a;
    }
  }
}

}  // namespace attn
