// K4: causal GQA attention for q tiles of k left-aligned tokens per
// sequence over the paged KV pool (chunked-prefill chunks, decode tokens at
// k = 1), with sliding-window, softcap and sentinel masks and fp32 or int8
// pages.
//
// Replaces the TPU kernel repro/kernels/attention.py::paged_prefill_attention
// (_paged_kernel at :206, pallas_call at :347; paged_decode_attention at
// :357 is its k = 1 wrapper).  Layouts are the reference's: q (B, k, Hq, D)
// fp32; k / v pages (P, ps, Hkv, D) fp32 or int8; pos pages (P, ps) int32;
// block tables (B, nb) int32; q_pos (B, k) int32, real tokens in columns
// 0..c-1 in ascending order and POS_SENTINEL after; int8 pools add
// per-(slot, head) scale pages (P, ps, Hkv) fp32; o (B, k, Hq, D) fp32.
//
// Bound on an H100: a prompt chunk by fp32 operations (4 D flops per
// attended (query head, key) pair, on CUDA cores, as K1); a decode token by
// the bytes of the pages its walk reads, once per kv head.
//
// Design:
//  * One block per (q sub-tile, kv head, row).  As in K1 the block holds
//    all G = Hq / Hkv query heads of its kv head for BQ = 32 / G positions,
//    so every page is read once per kv head and sub-tile; a 512-token chunk
//    at G = 2 is 32 sub-tiles, the split that K1 makes of Sq.  m, l and the
//    accumulator stay in registers (attn_tile.cuh) while a loop inside the
//    block walks the row's block table, in place of the TPU's grid axis
//    over blocks with its scalar-prefetched table.
//  * The walk is over logical slots, 32 per tile whatever the page size:
//    slot s lives in page block_tables[row, s / ps] at offset s % ps, and
//    the block reads each page id from the table in global memory.  It
//    starts at the page that holds the window's oldest position for the
//    sub-tile's lowest real position (the reference takes column 0, which
//    left alignment makes the row's lowest; per sub-tile is the same or
//    later), and it stops after the page that holds the sub-tile's highest
//    real position: logical block i holds positions i*ps .. i*ps+ps-1 or
//    the sentinel, so nothing past it is attendable.  Inside the walk a
//    tile that no real query row can attend is skipped before its K/V are
//    loaded, which leaves m, l and acc bit for bit unchanged.
//  * Masks: sentinel slots, causal by each row's own position, the window,
//    and the tanh softcap before the mask.  A sub-tile without a real
//    position walks nothing and writes exact zeros (max(l, 1e-30)).
//  * int8 pages are dequantized into shared memory on load, each element
//    times its (slot, head) scale: the same single fp32 multiply as the
//    plain version's gather-then-dequantize.
//  * No atomics: every output element is written by one thread after a
//    walk in a fixed order, so results are deterministic.
//
// Known weakness: decode launches R * Hkv blocks (16 at 4 rows on
// gemma2-2b) on 132 SMs, each walking its row's whole table, and uses
// G of the block's 32 query rows.  Split-KV is later work.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace attn;

template <bool QUANT>
__global__ void __launch_bounds__(NT)
paged_fwd(const float* __restrict__ q, const void* __restrict__ kpages,
          const void* __restrict__ vpages, const int* __restrict__ pos,
          const int* __restrict__ bt, const int* __restrict__ qpos,
          const float* __restrict__ kscale, const float* __restrict__ vscale,
          float* __restrict__ o, int k, int P, int ps, int Hq, int Hkv, int D,
          int nb, int G, int BQ, int window, float cap, float scale) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, D);
  __shared__ int kps[BKV];
  __shared__ long long kslot[BKV];     // flat (page, slot) of each tile slot
  __shared__ int qps[ROWS];
  __shared__ int qlo, qhi, tile_live;

  const int tid = threadIdx.x;
  const int r = tid / TPR, l8 = tid % TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int qi = r / G, head = h * G + r % G;
  const bool row_ok = r < BQ * G && q0 + qi < k;
  // qlo / qhi: the sub-tile's real (non-sentinel) positions
  load_q(q, qpos, t.Qs, qps, qlo, qhi, b, h, q0, k, Hq, D, G, BQ, scale,
         /*skip_sent=*/true);

  float m_i = -INFINITY, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  long long s_begin = 0, s_end = 0;    // logical slots to walk
  if (qlo <= qhi) {
    long long first = 0;
    if (window > 0)
      first = max(0LL, (long long)qlo - (window - 1)) / ps;
    first = min(first, (long long)nb - 1);
    s_begin = first * ps;
    s_end = (long long)min(nb, qhi / ps + 1) * ps;
  }
  const int* btrow = bt + (size_t)b * nb;
  const int8_t* k8 = static_cast<const int8_t*>(kpages);
  const int8_t* v8 = static_cast<const int8_t*>(vpages);
  const float* kf = static_cast<const float*>(kpages);
  const float* vf = static_cast<const float*>(vpages);

  for (long long s0 = s_begin; s0 < s_end; s0 += BKV) {
    __syncthreads();
    if (tid == 0) tile_live = 0;
    __syncthreads();
    if (tid < BKV) {
      const long long sl = s0 + tid;
      int kp = SENT;
      long long flat = 0;
      if (sl < s_end) {
        const int page = btrow[sl / ps];
        if (page >= 0 && page < P) {
          flat = (long long)page * ps + sl % ps;
          kp = pos[flat];
        }
      }
      kps[tid] = kp;
      kslot[tid] = flat;
      // some real query row of the sub-tile may attend kp
      if (kp != SENT && kp <= qhi &&
          (window <= 0 || (long long)kp > (long long)qlo - window))
        tile_live = 1;
    }
    __syncthreads();
    if (!tile_live) continue;

    const int D4 = D / 4;
    for (int i = tid; i < BKV * D4; i += NT) {
      const int j = i / D4, d = (i % D4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kps[j] != SENT) {
        const size_t row = (size_t)kslot[j] * Hkv + h;
        const size_t off = row * D + d;
        if (QUANT) {
          const char4 kc = *reinterpret_cast<const char4*>(k8 + off);
          const char4 vc = *reinterpret_cast<const char4*>(v8 + off);
          const float ks = kscale[row], vs = vscale[row];
          kv = make_float4((float)kc.x * ks, (float)kc.y * ks,
                           (float)kc.z * ks, (float)kc.w * ks);
          vv = make_float4((float)vc.x * vs, (float)vc.y * vs,
                           (float)vc.z * vs, (float)vc.w * vs);
        } else {
          kv = *reinterpret_cast<const float4*>(kf + off);
          vv = *reinterpret_cast<const float4*>(vf + off);
        }
      }
      tile_store(t, j, d, D, kv, vv);
    }
    __syncthreads();

    tile_update(t, kps, qps[r], r, l8, D, /*causal=*/1, window, cap, m_i,
                l_i, acc);
  }

  if (row_ok)
    write_row(o + (((size_t)b * k + q0 + qi) * Hq + head) * D, l8, D, l_i,
              acc);
}

template <bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* pos,
           const void* bt, const void* qpos, const void* ks, const void* vs,
           void* o, int B, int k, int P, int ps, int Hq, int Hkv, int D,
           int nb, int window, float cap, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv, BQ = ROWS / G;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_fwd<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((k + BQ - 1) / BQ, Hkv, B);
  paged_fwd<QUANT><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), kp, vp, static_cast<const int*>(pos),
      static_cast<const int*>(bt), static_cast<const int*>(qpos),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<float*>(o), k, P, ps, Hq, Hkv, D, nb, G, BQ, window, cap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// quant != 0: int8 pages with scale pages k_scale / v_scale; otherwise fp32
// pages and the scale pointers are ignored.  window <= 0: no window;
// cap <= 0: no softcap.  Returns cudaGetLastError() right after the launch.
extern "C" int paged_attention_f32(const void* q, const void* k_pages,
                                   const void* v_pages, const void* pos_pages,
                                   const void* block_tables,
                                   const void* q_pos, const void* k_scale,
                                   const void* v_scale, void* o, int B, int k,
                                   int P, int ps, int Hq, int Hkv, int D,
                                   int nb, int quant, int window, float cap,
                                   float scale, void* stream) {
  if (D % TPR != 0 || D % 4 != 0 || D > DMAX || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS || ps < 1 || nb < 1 ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return quant ? launch<true>(q, k_pages, v_pages, pos_pages, block_tables,
                              q_pos, k_scale, v_scale, o, B, k, P, ps, Hq,
                              Hkv, D, nb, window, cap, scale, st)
               : launch<false>(q, k_pages, v_pages, pos_pages, block_tables,
                               q_pos, k_scale, v_scale, o, B, k, P, ps, Hq,
                               Hkv, D, nb, window, cap, scale, st);
}
