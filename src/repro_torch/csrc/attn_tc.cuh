// The tensor-core attention walk shared by K1's prefill
// (flash_attention.cu) and K4's chunk steps (paged_attention.cu): attn_tc,
// templated on where its K/V rows come from (DenseSlots: K1's rows;
// PagedSlots: K4's logical slots behind a block table) and on their type
// (fp32, bf16, or int8 pages with per-(slot, head) scales: KvType in
// attn_tile.cuh), writing either the
// normalised output or, for a walk split across blocks, each split's
// unnormalised (m, l, acc) for the fixed-order merge of attn_tile.cuh
// (combine_cols).
//
// Numerics: the scores and P V on TF32 tensor cores (mma.sync m16n8k8) at
// fp32 accuracy.  One TF32 pass keeps ~3 decimal digits and fails the
// reference tolerance (rtol 2e-4 / atol 2e-5) at D = 256, so both operands
// of both products are split in registers as their fragments are built,
// hi = rna(v), lo = rna(v - hi), and each product is hi.hi + hi.lo + lo.hi
// (kernels/ref.py::einsum_tf32x3 states the arithmetic;
// attention_tf32x3_ref and paged_attention_split_ref(mm=einsum_tf32x3)
// the walks; tests/test_torch_tc_attention.py and test_torch_tc_paged.py
// hold them to the reference and show one pass failing).  A score's 96
// MMAs chain in the MMA's accumulator (its truncating adds move a score by
// ~1e-5 at D = 256, an order inside the tolerance after the softmax); each
// 16 x 8 output tile's 12 MMAs of a KV tile go into a zeroed accumulator
// that one round-to-nearest add puts into the rescaled running output.
//
// Design:
//  * One block per (q tile, split, kv head, batch row) holds all G query
//    heads of its kv head for BQ = 128 / G positions, 128 query rows (64
//    positions at gemma2-2b's G = 2), so every K/V tile is read once per
//    kv head and q tile.  8 warps of 16 rows; a warp's 16 x D output (128
//    floats a thread at D = 256) and its m and l stay in registers for the
//    block's lifetime.  The 1-d grid starts with the last q tile of every
//    (split, kv head, row): under a causal mask the later tiles walk the
//    most K/V tiles, and dispatching them first keeps the last wave short.
//  * Shared memory: the pre-scaled Q rows in fp32 (split when each
//    fragment is built), one 32-row K tile and one V tile, rows padded to
//    D + 4 floats so that every fragment load hits 32 distinct banks: 195
//    KB at D = 256, one block an SM.  A double buffer of K and V does not
//    fit beside a 128-row Q, so K and V take turns: V(t) is copied
//    (cp.async, 16 bytes at a time) while S(t) = Q K(t)^T runs, and K(t + 1)
//    while P(t) V(t) runs.  bf16 and int8 rows are copied as they are
//    stored into one staging area (16 KB at D = 256 for bf16, 8 KB for
//    int8, with int8's scales) and, once landed, converted into the fp32
//    tile: bf16 exactly (its hi TF32 part is exact and its lo part zero,
//    so the three passes spend one on zeros: a two-pass variant is later
//    work), int8 with the single fp32 multiply by the (slot, head) scale
//    that the plain version makes.  With one staging area the order is:
//    K(t) converted, then V(t)'s copy started while S(t) runs; V(t)
//    converted, then K(t + 1)'s copy started while P(t) V(t) runs (two
//    staging areas would not fit beside the fp32 tiles at D = 256 for
//    bf16).
//  * P never leaves the registers: the score accumulator's layout is the
//    A fragment's once the K index of each 8-row step of P V is permuted
//    (logical t4 -> row 2 t4, t4 + 4 -> row 2 t4 + 1, the V fragments
//    reading the same rows).
//  * The walk is over slots s_base + 32 t for tiles t in [t0, t1), which
//    the K/V source computes (range()).  DenseSlots walks every row of K1's
//    cache.  PagedSlots walks K4's live slots, computed on the device from
//    the positions: from the page that holds the window's oldest position
//    for the row's lowest real (non-sentinel) position to the page of its
//    highest (logical block i holds positions i ps .. i ps + ps - 1 or the
//    sentinel, so nothing past it is attendable); cut into NS runs of
//    whole tiles counted from that first slot; and cut again to the
//    q tile's own live slots.  The page ids and positions of 256 slots
//    (8 tiles) are read at a time, a slot a thread, into shared memory.
//  * Masking is purely positional (sentinel, causal kp <= qp, window
//    kp > qp - W) on the fp32 scores, after the softcap
//    cap * tanh(s / cap).  A tile in which no key can be attended by any
//    query row of the block is skipped before it is loaded; skipping is
//    exact (such a tile would leave m, l and acc unchanged).  Causal
//    prefill reads about half the tiles.
//  * The online softmax is the reference's _online_update (m_safe, alpha
//    = 0 while m is -inf; the final divide by max(l, 1e-30) turns an
//    all-masked row, and a q tile without a real position, into exact
//    zeros), every sum in a fixed order: two calls give the same bits.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "common.cuh"

namespace attn {

constexpr int TNT = 256;              // threads: 8 warps of 16 query rows
constexpr int TROWS = 128;            // query rows (position x head) a block
constexpr int TDN = DMAX / 8;         // m16n8 output tiles of a row (max)

// Dynamic shared memory of attn_tc: the block's pre-scaled Q rows, one K
// tile and one V tile, fp32 rows of D + 4 floats (199,680 bytes at D =
// 256), and for bf16 or int8 rows the staging area of one tile as stored
// (216,064 bytes in all at D = 256 for bf16).
inline size_t tc_smem_bytes(int D, int kt) {
  return sizeof(float) * (size_t)(TROWS + 2 * BKV) * (D + 4) +
         (kt != KV_F32 ? (size_t)BKV * D * kv_bytes(kt) : 0);
}

// hi and lo TF32 parts of v: hi = rna(v), lo = rna(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rt::tf32_rna(v);
  lo = rt::tf32_rna(v - __uint_as_float(hi));
}

// What every attn_tc launch takes besides its K/V source.  k / v: K1's
// (B, Skv, Hkv, D) rows or K4's (P, ps, Hkv, D) pages, fp32, bf16 or int8
// (with kscale / vscale, one float per (slot, head)); the K/V row of
// (slot, kv head h) is flat * Hkv + h, flat from the source's meta().
// vec: bf16 / int8 rows staged in 16-byte copies (D times the element
// size a multiple of 16, and k, v 16-byte aligned), else 4-byte copies.
// NS == 1 writes o (B, Sq, Hq, D); NS > 1 writes each split's (m, l) into
// pm / pl and its acc into pacc (attn_tile.cuh: partial_row).  q and o
// are of the walk's query type QT (fp32 or bf16).
struct TcArgs {
  const void* q;
  const int* qpos;
  const void* k;
  const void* v;
  const float* kscale;
  const float* vscale;
  void* o;
  float* pm;
  float* pl;
  float* pacc;
  int B, Sq, Hq, Hkv, D, G, BQ, NS, causal, window, vec;
  float cap, scale;
};

// The walk of a block: slots s_base + 32 t for t in [t0, t1); slots at or
// past s_lim are empty.
struct Walk {
  int s_base, s_lim, t0, t1;
};

// K1: the rows of a dense cache, kv_pos (B, Skv).  Every tile is walked
// (a ring cache's positions need not be ordered); dead tiles are skipped.
struct DenseSlots {
  const int* kvpos;
  int Skv;
  static constexpr bool ROW_RANGE = false;   // needs the row's positions

  __device__ Walk range(int, int, int, int, int, int, int, int) const {
    return Walk{0, Skv, 0, (Skv + BKV - 1) / BKV};
  }
  // position and flat row of slot sl of batch row b (SENT if empty)
  __device__ void meta(int b, int sl, int s_lim, int& p, int& flat) const {
    flat = 0;
    p = SENT;
    if (sl < s_lim) {
      flat = b * Skv + sl;
      p = kvpos[flat];
    }
  }
};

// K4: logical slot s of batch row b lives in page block_tables[b, s / ps]
// at offset s % ps; pos (P, ps) holds each slot's position.
struct PagedSlots {
  const int* pos;
  const int* bt;
  int P, ps, nb;
  static constexpr bool ROW_RANGE = true;

  // The live slots [first page of the window of lo, end of hi's page) of
  // real positions lo .. hi, as slot numbers; begin == end when lo > hi.
  __device__ void live(int lo, int hi, int window, int& begin,
                       int& end) const {
    begin = end = 0;
    if (lo > hi) return;
    int first = window > 0 ? max(0, lo - (window - 1)) / ps : 0;
    first = min(first, nb - 1);
    begin = first * ps;
    end = min(nb, hi / ps + 1) * ps;
  }
  // rlo / rhi: the row's real positions; qlo / qhi: the q tile's; split s
  // of NS takes tiles [s per, (s + 1) per) of the row's range, per =
  // ceil(tiles / NS) (kernels/ref.py::paged_split_slots), cut to the q
  // tile's live slots.
  __device__ Walk range(int rlo, int rhi, int qlo, int qhi, int s, int NS,
                        int window, int) const {
    int rb, re, qb, qe;
    live(rlo, rhi, window, rb, re);
    live(qlo, qhi, window, qb, qe);
    const int n_t = (re - rb + BKV - 1) / BKV;
    const int per = (n_t + NS - 1) / NS;
    Walk w{rb, re, min(n_t, s * per), min(n_t, (s + 1) * per)};
    if (qb >= qe) {
      w.t1 = w.t0;
    } else {
      w.t0 = max(w.t0, (qb - rb) / BKV);
      w.t1 = min(w.t1, (qe - rb + BKV - 1) / BKV);
    }
    return w;
  }
  __device__ void meta(int b, int sl, int s_lim, int& p, int& flat) const {
    flat = 0;
    p = SENT;
    if (sl < s_lim) {
      const int page = bt[(size_t)b * nb + sl / ps];
      if (page >= 0 && page < P) {
        flat = page * ps + sl % ps;
        p = pos[flat];
      }
    }
  }
};

// The lowest and highest real (non-sentinel) position of qp[0 .. n), in
// every thread (lo > hi when there is none).  red: 2 x TNT / 32 ints of
// shared memory.  Ends with __syncthreads.
__device__ __forceinline__ void real_range(const int* qp, int n, int* red,
                                           int& lo, int& hi) {
  const int tid = threadIdx.x;
  int l = INT_MAX, h = INT_MIN;
  for (int i = tid; i < n; i += TNT) {
    const int p = qp[i];
    if (p == SENT) continue;
    l = min(l, p);
    h = max(h, p);
  }
  l = __reduce_min_sync(0xffffffffu, l);
  h = __reduce_max_sync(0xffffffffu, h);
  if (tid % 32 == 0) {
    red[tid / 32] = l;
    red[TNT / 32 + tid / 32] = h;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int w = 0; w < TNT / 32; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[TNT / 32 + w]);
  }
  __syncthreads();
}

// One block per (q tile of BQ = TROWS / G positions, split, kv head, batch
// row) on a 1-d grid, the last q tiles first.  DT: the head dim fixed at
// compile time (gemma2-2b's 256), or 0 for any D (a multiple of 8 up to
// DMAX, read at run time: granite-moe's 64); a fixed D takes the branch
// off every output tile of P V, so the tiles' MMA chains can overlap.  KT:
// the K/V element type (KvType).  QT: the query and output type (float or
// __nv_bfloat16; q staged in fp32, the output rounded once).
template <class Slots, int KT, int DT, class QT>
__global__ void __launch_bounds__(TNT, 1)
attn_tc(const TcArgs a, const Slots src) {
  extern __shared__ float4 tc_smem[];
  const int D = DT > 0 ? DT : a.D;
  const int DS = D + 4;
  float* Qs = reinterpret_cast<float*>(tc_smem);   // [TROWS][DS]
  float* Ks = Qs + TROWS * DS;                      // [BKV][DS]
  float* Vs = Ks + BKV * DS;                        // [BKV][DS]
  constexpr bool STAGED = KT != KV_F32;
  constexpr int ES = kv_bytes(KT);
  // bf16 / int8: one tile's rows as stored, [BKV][D * ES] bytes
  unsigned char* ST = reinterpret_cast<unsigned char*>(Vs + BKV * DS);
  __shared__ int kps[2][BKV], kfl[2][BKV];   // a tile's positions, rows
  __shared__ int mpos[TNT], mfl[TNT];        // 8 tiles' from tile mt0 on
  __shared__ float ksc[BKV], vsc[BKV];       // int8: the staged scales
  __shared__ int qps[TROWS];
  __shared__ int red[2 * TNT / 32];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int Hkv = a.Hkv, G = a.G, BQ = a.BQ, Sq = a.Sq, NS = a.NS;
  const int hb = blockIdx.x % (Hkv * a.B);
  const int h = hb % Hkv, b = hb / Hkv;
  const int rest = blockIdx.x / (Hkv * a.B);
  const int s = rest % NS;
  const int n_qt = gridDim.x / (Hkv * a.B * NS);
  const int q0 = (n_qt - 1 - rest / NS) * BQ;
  const int rows = BQ * G, nd = D / 8, D4 = D / 4;
  const int* qrow = a.qpos + (size_t)b * Sq;
  const QT* qg = static_cast<const QT*>(a.q);

  // the block's query rows, upcast, then pre-scaled; rows past the tile or
  // Sq are zero
  for (int i = tid; i < TROWS * D4; i += TNT) {
    const int rr = i / D4, d = (i % D4) * 4, qq = rr / G;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < rows && q0 + qq < Sq) {
      val = load4(
          qg + (((size_t)b * Sq + q0 + qq) * a.Hq + h * G + rr % G) * D + d);
      val = make_float4(val.x * a.scale, val.y * a.scale, val.z * a.scale,
                        val.w * a.scale);
    }
    *reinterpret_cast<float4*>(Qs + rr * DS + d) = val;
  }
  if (tid < TROWS) {
    const int qq = tid / G;
    qps[tid] = (tid < rows && q0 + qq < Sq) ? qrow[q0 + qq] : 0;
  }
  int qlo, qhi, rlo = INT_MAX, rhi = INT_MIN;
  real_range(qrow + q0, min(BQ, Sq - q0), red, qlo, qhi);
  if (Slots::ROW_RANGE) real_range(qrow, Sq, red, rlo, rhi);
  const Walk wk = src.range(rlo, rhi, qlo, qhi, s, NS, a.window, b);

  // The positions and rows of the TNT slots from tile t on, a slot a
  // thread, so the walk reads the table once per 8 tiles.
  int mt0 = -TNT;
  auto load_meta = [&](int t) {
    int p, flat;
    src.meta(b, wk.s_base + t * BKV + tid, wk.s_lim, p, flat);
    mpos[tid] = p;
    mfl[tid] = flat;
    mt0 = t;
    __syncthreads();
  };
  // From tile t on, the first tile that some query row of the block may
  // attend, its positions and rows left in buffer u; t1 if there is none.
  auto next_live = [&](int t, int u) {
    for (; t < wk.t1; ++t) {
      if (t >= mt0 + TNT / BKV) load_meta(t);
      int live = 0;
      if (tid < BKV) {
        const int i = (t - mt0) * BKV + tid;
        const int kp = mpos[i];
        kps[u][tid] = kp;
        kfl[u][tid] = mfl[i];
        live = kp != SENT && (!a.causal || kp <= qhi) &&
               (a.window <= 0 || (long long)kp > (long long)qlo - a.window);
      }
      if (__syncthreads_or(live)) break;
    }
    return t;
  };
  // Starts the copy of the tile in buffer u of `src_` (k or v) as one
  // cp.async group: fp32 rows straight into `dst`, bf16 / int8 rows into
  // ST (int8's scales into `sc`); empty slots zero-filled.
  auto start_copy = [&](const void* src_, const float* scl, float* dst,
                        float* sc, int u) {
    if (STAGED) {
      const unsigned char* sb = static_cast<const unsigned char*>(src_);
      const int RB = D * ES;                 // bytes of a row
      const int CH = a.vec ? 16 : 4, C = RB / CH;
      for (int i = tid; i < BKV * C; i += TNT) {
        const int j = i / C, c = (i % C) * CH;
        const bool ok = kps[u][j] != SENT;
        const size_t off = ((size_t)kfl[u][j] * Hkv + h) * RB + c;
        if (a.vec)
          rt::cp_async16(ST + j * RB + c, ok ? sb + off : sb, ok);
        else
          rt::cp_async4(ST + j * RB + c, ok ? sb + off : sb, ok);
      }
      if (KT == KV_I8 && tid < BKV) {
        const bool ok = kps[u][tid] != SENT;
        const size_t row = (size_t)kfl[u][tid] * Hkv + h;
        rt::cp_async4(sc + tid, ok ? scl + row : scl, ok);
      }
    } else {
      const float* sf = static_cast<const float*>(src_);
      for (int i = tid; i < BKV * D4; i += TNT) {
        const int j = i / D4, d = (i % D4) * 4;
        const bool ok = kps[u][j] != SENT;
        const size_t off = ((size_t)kfl[u][j] * Hkv + h) * D + d;
        rt::cp_async16(dst + j * DS + d, ok ? sf + off : sf, ok);
      }
    }
    rt::cp_async_commit();
  };
  // bf16 / int8: the tile landed in ST into the fp32 `dst` (bf16
  // exactly; int8 times its scales, one fp32 product an element), then a
  // barrier: ST is free again.
  auto convert = [&](const float* sc, float* dst) {
    for (int i = tid; i < BKV * D4; i += TNT) {
      const int j = i / D4, d = (i % D4) * 4;
      float4 val;
      if (KT == KV_I8) {
        const char4 c = *reinterpret_cast<const char4*>(ST + j * D + d);
        const float f = sc[j];
        val = make_float4((float)c.x * f, (float)c.y * f, (float)c.z * f,
                          (float)c.w * f);
      } else {
        val = bf16x4(ST + (j * D + d) * 2);
      }
      *reinterpret_cast<float4*>(dst + j * DS + d) = val;
    }
    __syncthreads();
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

  int cur = next_live(wk.t0, 0), u = 0;
  if (cur < wk.t1) start_copy(a.k, a.kscale, Ks, ksc, 0);
  while (cur < wk.t1) {
    int nxt;
    if (STAGED) {
      rt::cp_async_wait<0>();        // K(cur) has landed in ST
      __syncthreads();
      convert(ksc, Ks);              // Ks is free: the last S has ended
      start_copy(a.v, a.vscale, Vs, vsc, u);
      nxt = next_live(cur + 1, u ^ 1);
    } else {
      // Vs is free: the last P V has ended
      start_copy(a.v, a.vscale, Vs, vsc, u);
      nxt = next_live(cur + 1, u ^ 1);
      rt::cp_async_wait<1>();        // K(cur) has landed
      __syncthreads();
    }

    // S = Q K^T, 16 x 32 per warp, three TF32 passes chained in the MMA's
    // accumulator (tests/test_torch_tc_attention.py: enough at D = 256)
    float sc4[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc4[j][e] = 0.f;
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
        rt::mma_tf32(sc4[j], ah, bh0, bh1);
        rt::mma_tf32(sc4[j], ah, bl0, bl1);
        rt::mma_tf32(sc4[j], al, bh0, bh1);
      }
    }

    // softcap, mask, online softmax (the reference's _online_update)
    const int qp[2] = {qps[r0], qps[r0 + 8]};
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = sc4[j][e];
        if (a.cap > 0.f) sv = a.cap * tanhf(sv / a.cap);
        const int kp = kps[u][j * 8 + 2 * t4 + (e & 1)];
        sv = attendable(kp, qp[e >> 1], a.causal, a.window) ? sv : -INFINITY;
        sc4[j][e] = sv;
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
        p[e] = expf(sc4[j][e] - mx[e >> 1]);
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
    if (STAGED) {
      rt::cp_async_wait<0>();        // V(cur) has landed in ST
      __syncthreads();
      convert(vsc, Vs);
      if (nxt < wk.t1) start_copy(a.k, a.kscale, Ks, ksc, u ^ 1);
    } else {
      if (nxt < wk.t1) {
        start_copy(a.k, a.kscale, Ks, ksc, u ^ 1);
        rt::cp_async_wait<1>();      // V(cur) has landed
      } else {
        rt::cp_async_wait<0>();
      }
      __syncthreads();
    }

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
    const int head = h * G + r % G;
    if (NS == 1) {
      QT* orow = static_cast<QT*>(a.o) +
                 (((size_t)b * Sq + q0 + qq) * a.Hq + head) * D + 2 * t4;
      const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
      for (int jn = 0; jn < TDN; ++jn)
        if (jn < nd)
          store2(orow + jn * 8, acc[jn][2 * i] / denom,
                 acc[jn][2 * i + 1] / denom);
    } else {
      // the split's unnormalised state: (m, l), then acc
      const size_t prow = partial_row(b, head, s, q0 + qq, a.Hq, NS, Sq);
      if (t4 == 0) {
        a.pm[prow] = m_i[i];
        a.pl[prow] = l_i[i];
      }
      float* arow = a.pacc + prow * D + 2 * t4;
#pragma unroll
      for (int jn = 0; jn < TDN; ++jn)
        if (jn < nd)
          *reinterpret_cast<float2*>(arow + jn * 8) =
              make_float2(acc[jn][2 * i], acc[jn][2 * i + 1]);
    }
  }
}

// Launch attn_tc over `src` with K/V elements of type KT and queries and
// outputs of type QT on `stream`: grid n_qt * NS * Hkv * B blocks;
// returns the first CUDA error of the setup or the launch.
template <class Slots, int KT, class QT>
int launch_tc(const TcArgs& a, const Slots& src, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(a.D, KT);
  auto kern = a.D == DMAX ? attn_tc<Slots, KT, DMAX, QT>
                          : attn_tc<Slots, KT, 0, QT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      (unsigned)((a.Sq + a.BQ - 1) / a.BQ) * a.NS * a.Hkv * a.B;
  kern<<<grid, TNT, smem, stream>>>(a, src);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
