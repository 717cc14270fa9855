// K1: flash-attention forward over a dense KV (prefill and dense-cache
// decode), GQA, causal / sliding-window masking from positions alone, an
// optional tanh softcap, and an fp32 online softmax.
//
// Replaces the TPU kernel repro/kernels/attention.py::flash_attention
// (_flash_kernel at :124, pallas_call at :181).  Layouts are the
// reference's: q (B, Sq, Hq, D), k / v (B, Skv, Hkv, D), q_pos (B, Sq),
// kv_pos (B, Skv) int32, o (B, Sq, Hq, D), all fp32 and contiguous.
//
// Bound on an H100: prefill by its operations, 4 D flops per attended
// (query head, key) pair, at the TF32 tensor-core peak of 495 TFLOP/s
// (0.29 ms at gemma2-2b's 2 x 4160 prefill); the three TF32 passes of the
// route below make its own floor three times that (0.86 ms).  Decode
// (Sq = 1) by the bytes of the K/V cache, read once per kv head.
//
// Design:
//  * Prefill, flash_tc: the scores and P V on TF32 tensor cores (mma.sync
//    m16n8k8) at fp32 accuracy.  One TF32 pass keeps ~3 decimal digits and
//    fails the reference tolerance (rtol 2e-4 / atol 2e-5) at D = 256, so
//    both operands of both products are split in registers as their
//    fragments are built, hi = rna(v), lo = rna(v - hi), and each product
//    is hi.hi + hi.lo + lo.hi (kernels/ref.py::attention_tf32x3_ref states
//    the arithmetic; tests/test_torch_tc_attention.py holds it to the
//    reference and shows one pass failing).  A score's 96 MMAs chain in
//    the MMA's accumulator (its truncating adds move a score by ~1e-5 at
//    D = 256, an order inside the tolerance after the softmax); each 16 x 8
//    output tile's 12 MMAs of a KV tile go into a zeroed accumulator that
//    one round-to-nearest add puts into the rescaled running output.
//    - One block per (q tile, kv head, batch row) holds all G query heads
//      of its kv head for BQ = 128 / G positions, 128 query rows (64
//      positions at gemma2-2b's G = 2), so every K/V tile is read once per
//      kv head and four times less often than with 32 rows.  8 warps of 16
//      rows; a warp's 16 x D output (128 floats a thread at D = 256) and
//      its m and l stay in registers for the block's lifetime.
//    - Shared memory: the pre-scaled Q rows in fp32 (split when each
//      fragment is built), one 32-row K tile and one V tile, rows padded
//      to D + 4 floats so that every fragment load hits 32 distinct banks:
//      195 KB at D = 256, one block an SM.  A full double buffer of K and
//      V (another 64 KB) does not fit beside a 128-row Q, so K and V take
//      turns: V(t) is copied (cp.async) while S(t) = Q K(t)^T runs, and
//      K(t + 1) while P(t) V(t) runs.
//    - P never leaves the registers: the score accumulator's layout is the
//      A fragment's once the K index of each 8-row step of P V is permuted
//      (logical t4 -> row 2 t4, t4 + 4 -> row 2 t4 + 1, the V fragments
//      reading the same rows).
//    - Masking is purely positional (sentinel, causal kp <= qp, window
//      kp > qp - W) on the fp32 scores, after the softcap
//      cap * tanh(s / cap).  A tile in which no key can be attended by any
//      query row of the block is skipped before it is loaded.  Skipping is
//      exact: such a tile would leave m, l and acc unchanged.  Causal
//      prefill reads about half the tiles.
//    - The online softmax is the reference's _online_update (m_safe, alpha
//      = 0 while m is -inf; the final divide by max(l, 1e-30) turns an
//      all-masked row into exact zeros), every sum in a fixed order: two
//      calls give the same bits.
//  * Split-KV decode.  Where one q tile of 32 rows (BQ = 32 / G positions)
//    holds every query position and the single walk's grid (Hkv * B
//    blocks: 8 at gemma2-2b decode with B = 2) would leave most of the 132
//    SMs idle, the wrapper asks for NS > 1 splits
//    (kernels/attention.py::decode_splits): flash_split runs one block per
//    (split, kv head, batch row), each over its own run of whole 32-row KV
//    tiles, and writes its rows' unnormalised (m, l, acc) into fp32
//    partials the wrapper allocates; split_combine merges them in split
//    order (attn_tile.cuh: write_partial, combine_cols).  At gemma2-2b
//    decode NS = 33: 264 blocks of 4 tiles each.  The split walk
//    double-buffers its K/V tiles with cp.async, so the copy of the next
//    live tile overlaps tile_update (attn_tile.cuh, fp32 FMAs on CUDA
//    cores, shared with K4's chunk walk) on the current one (K in 4-byte
//    copies, since its rows are padded to D + 1 floats against bank
//    conflicts; V in 16-byte copies); the positions of the next tile are
//    read, and the tile skipped if no row can attend it, while the current
//    copy is in flight.  The block keeps the 32-row query tile, of which
//    only G = 2 rows are real at gemma2-2b decode; a warp that holds no
//    real row (7 of the 8 there) skips tile_update.  The walk is then
//    bound by the live warp's tile_update, one tile after another (PERF.md
//    section 6).  Every other call (prefill, the LM evaluator's 4 x 128
//    forward, decode on a grid that fills the card) runs flash_tc.  The
//    two walks sum in other orders, so they agree to the reference
//    tolerance, not bit for bit; each gives the same bits on every run.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace attn;

// ------------------------------------------------------ prefill: flash_tc
constexpr int TNT = 256;              // threads: 8 warps of 16 query rows
constexpr int TROWS = 128;            // query rows (position x head) a block
constexpr int TDN = DMAX / 8;         // m16n8 output tiles of a row (max)

// Dynamic shared memory of flash_tc: the block's pre-scaled Q rows, one K
// tile and one V tile, fp32 rows of D + 4 floats (199,680 bytes at D = 256).
inline size_t tc_smem_bytes(int D) {
  return sizeof(float) * (size_t)(TROWS + 2 * BKV) * (D + 4);
}

// hi and lo TF32 parts of v: hi = rna(v), lo = rna(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rt::tf32_rna(v);
  lo = rt::tf32_rna(v - __uint_as_float(hi));
}

// One block per (q tile of BQ = TROWS / G positions, kv head, batch row),
// on a 1-d grid that starts with the last q tile of every (kv head, batch
// row): under a causal mask the later tiles walk the most K/V tiles, and
// dispatching them first keeps the last wave short.  DT: the head dim
// fixed at compile time (gemma2-2b's 256), or 0 for any D (a multiple of 8
// up to DMAX, read at run time).  A fixed D takes the branch off every
// output tile of P V, so the tiles' MMA chains can overlap.
template <int DT>
__global__ void __launch_bounds__(TNT, 1)
flash_tc(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const int* __restrict__ qpos,
         const int* __restrict__ kvpos, float* __restrict__ o, int B, int Sq,
         int Skv, int Hq, int Hkv, int D_, int G, int BQ, int causal,
         int window, float cap, float scale) {
  extern __shared__ float4 tc_smem[];
  const int D = DT > 0 ? DT : D_;
  const int DS = D + 4;
  float* Qs = reinterpret_cast<float*>(tc_smem);   // [TROWS][DS]
  float* Ks = Qs + TROWS * DS;                      // [BKV][DS]
  float* Vs = Ks + BKV * DS;                        // [BKV][DS]
  __shared__ int kps[2][BKV];
  __shared__ int qps[TROWS];
  __shared__ int qlo, qhi;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int hb = blockIdx.x % (Hkv * B);
  const int h = hb % Hkv, b = hb / Hkv;
  const int n_qt = gridDim.x / (Hkv * B);
  const int q0 = (n_qt - 1 - (int)blockIdx.x / (Hkv * B)) * BQ;
  const int rows = BQ * G, nd = D / 8, D4 = D / 4;

  // the block's query rows, pre-scaled; rows past the tile or Sq are zero
  for (int i = tid; i < TROWS * D4; i += TNT) {
    const int rr = i / D4, d = (i % D4) * 4, qq = rr / G;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < rows && q0 + qq < Sq) {
      val = *reinterpret_cast<const float4*>(
          q + (((size_t)b * Sq + q0 + qq) * Hq + h * G + rr % G) * D + d);
      val = make_float4(val.x * scale, val.y * scale, val.z * scale,
                        val.w * scale);
    }
    *reinterpret_cast<float4*>(Qs + rr * DS + d) = val;
  }
  if (tid < TROWS) {
    const int qq = tid / G;
    qps[tid] = (tid < rows && q0 + qq < Sq)
                   ? qpos[(size_t)b * Sq + q0 + qq] : 0;
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
  __syncthreads();

  const int n_tiles = (Skv + BKV - 1) / BKV;
  // From tile t on, the first tile that some query row of the block may
  // attend, its positions left in kps[u]; n_tiles if there is none.
  auto next_live = [&](int t, int u) {
    for (; t < n_tiles; ++t) {
      int live = 0;
      if (tid < BKV) {
        const int kk = t * BKV + tid;
        const int kp = kk < Skv ? kvpos[(size_t)b * Skv + kk] : SENT;
        kps[u][tid] = kp;
        live = kp != SENT && (!causal || kp <= qhi) &&
               (window <= 0 || (long long)kp > (long long)qlo - window);
      }
      if (__syncthreads_or(live)) break;
    }
    return t;
  };
  // Starts the copy of tile t of `src` (k or v) into `dst`, rows past Skv
  // zero-filled, as one cp.async group.
  auto start_copy = [&](const float* src, float* dst, int t) {
    const int kv0 = t * BKV;
    for (int i = tid; i < BKV * D4; i += TNT) {
      const int j = i / D4, d = (i % D4) * 4;
      const bool ok = kv0 + j < Skv;
      const size_t off = (((size_t)b * Skv + kv0 + j) * Hkv + h) * D + d;
      rt::cp_async16(dst + j * DS + d, ok ? src + off : src, ok);
    }
    rt::cp_async_commit();
  };

  // thread state: rows r0 and r0 + 8 of the block (rows g, g + 8 of the
  // warp's 16), output columns 8 jn + 2 t4 + {0, 1}
  const int r0 = warp * 16 + g;
  const float* qa = Qs + r0 * DS;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[TDN][4];
#pragma unroll
  for (int jn = 0; jn < TDN; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;

  int cur = next_live(0, 0), u = 0;
  if (cur < n_tiles) start_copy(k, Ks, cur);
  while (cur < n_tiles) {
    start_copy(v, Vs, cur);          // Vs is free: the last P V has ended
    const int nxt = next_live(cur + 1, u ^ 1);
    rt::cp_async_wait<1>();          // K(cur) has landed
    __syncthreads();

    // S = Q K^T, 16 x 32 per warp, three TF32 passes chained in the MMA's
    // accumulator (tests/test_torch_tc_attention.py: enough at D = 256)
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(qa[kk + t4], ah[0], al[0]);
      split_tf32(qa[8 * DS + kk + t4], ah[1], al[1]);
      split_tf32(qa[kk + t4 + 4], ah[2], al[2]);
      split_tf32(qa[8 * DS + kk + t4 + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* kr = Ks + (j * 8 + g) * DS + kk;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kr[t4], bh0, bl0);
        split_tf32(kr[t4 + 4], bh1, bl1);
        rt::mma_tf32(s[j], ah, bh0, bh1);
        rt::mma_tf32(s[j], ah, bl0, bl1);
        rt::mma_tf32(s[j], al, bh0, bh1);
      }
    }

    // softcap, mask, online softmax (the reference's _online_update)
    const int qp[2] = {qps[r0], qps[r0 + 8]};
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[j][e];
        if (cap > 0.f) sv = cap * tanhf(sv / cap);
        const int kp = kps[u][j * 8 + 2 * t4 + (e & 1)];
        sv = attendable(kp, qp[e >> 1], causal, window) ? sv : -INFINITY;
        s[j][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i]);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      alpha[i] = isfinite(m_i[i]) ? expf(m_i[i] - m_safe) : 0.f;
      m_i[i] = m_new;
      mx[i] = m_safe;
    }
    float psum[2] = {0.f, 0.f};
    // P as the A fragments of the P V product, hi and lo: with the K index
    // of each 8-row step permuted (logical t4 -> row 2 t4, t4 + 4 -> row
    // 2 t4 + 1; the V fragments below read the same rows), the score
    // accumulator's layout is the A fragment's, so P never leaves the
    // registers
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[j][e] - mx[e >> 1]);
        psum[e >> 1] += p[e];
      }
      split_tf32(p[0], ph[j][0], pl[j][0]);
      split_tf32(p[2], ph[j][1], pl[j][1]);
      split_tf32(p[1], ph[j][2], pl[j][2]);
      split_tf32(p[3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_i[i] = l_i[i] * alpha[i] + psum[i];
    }

    __syncthreads();                 // every warp has read Ks
    if (nxt < n_tiles) {
      start_copy(k, Ks, nxt);
      rt::cp_async_wait<1>();        // V(cur) has landed
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();

    // O = O * alpha + P V: each 16 x 8 output tile's three passes over the
    // tile's 32 rows go into a zeroed accumulator, then one round-to-
    // nearest add into the rescaled running output
#pragma unroll
    for (int jn = 0; jn < TDN; ++jn) {
      if (jn < nd) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        const float* vc = Vs + jn * 8 + g;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vc[(ks * 8 + 2 * t4) * DS], bh0, bl0);
          split_tf32(vc[(ks * 8 + 2 * t4 + 1) * DS], bh1, bl1);
          rt::mma_tf32(part, ph[ks], bh0, bh1);
          rt::mma_tf32(part, ph[ks], bl0, bl1);
          rt::mma_tf32(part, pl[ks], bh0, bh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[jn][e] = __fadd_rn(__fmul_rn(acc[jn][e], alpha[e >> 1]),
                                 part[e]);
      }
    }
    __syncthreads();                 // every warp has read Vs
    cur = nxt;
    u ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i, qq = r / G;
    if (r >= rows || q0 + qq >= Sq) continue;
    float* orow =
        o + (((size_t)b * Sq + q0 + qq) * Hq + h * G + r % G) * D + 2 * t4;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int jn = 0; jn < TDN; ++jn)
      if (jn < nd)
        *reinterpret_cast<float2*>(orow + jn * 8) =
            make_float2(acc[jn][2 * i] / denom, acc[jn][2 * i + 1] / denom);
  }
}

// Shared memory of the split walk: Q, two K tiles (rows of D + 1), two V
// tiles and P, ~165 KB at D = 256.
inline size_t split_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)ROWS * (D + 1) + 2 * (size_t)BKV * (D + 1) +
          2 * (size_t)BKV * D + (size_t)ROWS * (BKV + 1));
}

// One block per (split s, kv head, batch row), the block's query tile at
// q0 = 0 (Sq <= BQ); split s walks KV tiles [s * tps, (s + 1) * tps).
__global__ void __launch_bounds__(NT)
flash_split(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ qpos,
            const int* __restrict__ kvpos, float* __restrict__ pm,
            float* __restrict__ pl, float* __restrict__ pacc, int Sq,
            int Skv, int Hq, int Hkv, int D, int G, int BQ, int causal,
            int window, float cap, float scale, int NS, int tps) {
  extern __shared__ float smem[];
  const int DS = D + 1;
  float* Qs = smem;
  float* Ks0 = Qs + ROWS * DS;                 // [2][BKV][D + 1]
  float* Vs0 = Ks0 + 2 * BKV * DS;             // [2][BKV][D]
  float* Ps = Vs0 + 2 * BKV * D;
  __shared__ int kps[2][BKV];
  __shared__ int qps[ROWS];
  __shared__ int qlo, qhi;

  const int tid = threadIdx.x;
  const int r = tid / TPR, l8 = tid % TPR;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int qi = r / G, head = h * G + r % G;
  const bool row_ok = r < BQ * G && qi < Sq;
  // the warp's 32 / TPR rows hold a real one (rows past Sq * G are empty)
  const bool warp_live = (tid / 32) * (32 / TPR) < Sq * G;
  load_q(q, qpos, Qs, qps, qlo, qhi, b, h, 0, Sq, Hq, D, G, BQ, scale,
         /*skip_sent=*/false);
  const int n_tiles = (Skv + BKV - 1) / BKV;
  const int t_end = min(n_tiles, (s + 1) * tps);

  // From tile t on, the first tile that some query row of the block may
  // attend (as flash_tc's skip test), its positions left in kps[u];
  // t_end if there is none.
  auto next_live = [&](int t, int u) {
    for (; t < t_end; ++t) {
      int live = 0;
      if (tid < BKV) {
        const int kk = t * BKV + tid;
        const int kp = kk < Skv ? kvpos[(size_t)b * Skv + kk] : SENT;
        kps[u][tid] = kp;
        live = kp != SENT && (!causal || kp <= qhi) &&
               (window <= 0 || (long long)kp > (long long)qlo - window);
      }
      if (__syncthreads_or(live)) break;
    }
    return t;
  };
  // Starts the copy of tile t into buffer u (rows past Skv zero-filled).
  auto start_copy = [&](int t, int u) {
    float* Ks = Ks0 + u * BKV * DS;
    float* Vs = Vs0 + u * BKV * D;
    const int kv0 = t * BKV;
    for (int i = tid; i < BKV * D; i += NT) {
      const int j = i / D, d = i % D;
      const bool ok = kv0 + j < Skv;
      const size_t off = (((size_t)b * Skv + kv0 + j) * Hkv + h) * D + d;
      rt::cp_async4(Ks + j * DS + d, ok ? k + off : k, ok);
    }
    const int D4 = D / 4;
    for (int i = tid; i < BKV * D4; i += NT) {
      const int j = i / D4, d = (i % D4) * 4;
      const bool ok = kv0 + j < Skv;
      const size_t off = (((size_t)b * Skv + kv0 + j) * Hkv + h) * D + d;
      rt::cp_async16(Vs + j * D + d, ok ? v + off : v, ok);
    }
    rt::cp_async_commit();
  };

  float m_i = -INFINITY, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  int cur = next_live(s * tps, 0), u = 0;
  if (cur < t_end) start_copy(cur, 0);
  while (cur < t_end) {
    const int nxt = next_live(cur + 1, u ^ 1);
    if (nxt < t_end) {
      start_copy(nxt, u ^ 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const Tiles t{Qs, Ks0 + u * BKV * DS, Vs0 + u * BKV * D, Ps};
      tile_update(t, kps[u], qps[r], r, l8, D, causal, window, cap, m_i,
                  l_i, acc);
    }
    __syncthreads();
    cur = nxt;
    u ^= 1;
  }

  if (row_ok)
    write_partial(pm, pl, pacc, partial_row(b, head, s, qi, Hq, NS, Sq), l8,
                  D, m_i, l_i, acc);
}

// One block per (position, q head, batch row), 4 columns a thread.
__global__ void split_combine(const float* __restrict__ pm,
                              const float* __restrict__ pl,
                              const float* __restrict__ pacc,
                              float* __restrict__ o, int Sq, int Hq, int D,
                              int NS) {
  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x * 4;
  if (d >= D) return;
  const float4 val = combine_cols(
      pm, pl, pacc, partial_row(b, head, 0, qi, Hq, NS, Sq), Sq, NS, D, d);
  *reinterpret_cast<float4*>(o + (((size_t)b * Sq + qi) * Hq + head) * D +
                             d) = val;
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap.  n_splits <= 1 runs the
// tensor-core walk (flash_tc); n_splits > 1 needs Sq <= 32 / G and runs the
// split walk, with `ml` holding 2 x B Hq n_splits Sq floats (m, then l) and
// `pacc` B Hq n_splits Sq D floats.  Returns cudaGetLastError() right after
// the launches.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, void* o, void* ml,
                                   void* pacc, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int causal, int window,
                                   int n_splits, float cap, float scale,
                                   void* stream) {
  if (D % TPR != 0 || D % 4 != 0 || D > DMAX || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv, BQ = ROWS / G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* of = static_cast<float*>(o);
  if (n_splits <= 1) {
    if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int BQT = TROWS / G;
    const size_t smem = tc_smem_bytes(D);
    auto kern = D == DMAX ? flash_tc<DMAX> : flash_tc<0>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned grid = (unsigned)((Sq + BQT - 1) / BQT) * Hkv * B;
    kern<<<grid, TNT, smem, st>>>(qf, kf, vf, qp, kp, of, B, Sq, Skv, Hq,
                                  Hkv, D, G, BQT, causal, window, cap, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_tiles = (Skv + BKV - 1) / BKV;
  if (Sq > BQ || n_splits > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tps = (n_tiles + n_splits - 1) / n_splits;
  float* pm = static_cast<float*>(ml);
  float* pl = pm + (size_t)B * Hq * n_splits * Sq;
  float* pa = static_cast<float*>(pacc);
  const size_t smem = split_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_split<<<dim3(n_splits, Hkv, B), NT, smem, st>>>(
      qf, kf, vf, qp, kp, pm, pl, pa, Sq, Skv, Hq, Hkv, D, G, BQ, causal,
      window, cap, scale, n_splits, tps);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  split_combine<<<dim3(Sq, Hq, B), (D + 3) / 4, 0, st>>>(pm, pl, pa, of, Sq,
                                                          Hq, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}
