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
// Two launch shapes: paged_fwd below for prompt chunks (and any call the
// split rule leaves to one walk), and for decode the split-KV walk
// paged_split + paged_combine (further down).
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
// Known weakness of paged_fwd: a block holds 32 query rows and shares
// tile_update's work 8 threads a row, so a sub-tile with few real rows
// leaves most warps idle; decode therefore runs the split walk below.
// Chunk steps (k = 512) fill every row and keep paged_fwd.
//
// ---- Decode: split-KV walk (paged_split, paged_combine).
// Where one q sub-tile holds every query column (k <= 32 / G: every decode
// step) and the single walk's R * Hkv blocks (16 at 4 rows on gemma2-2b)
// are fewer than the SMs, the wrapper asks for NS > 1 splits
// (kernels/attention.py::paged_decode_splits, from shapes alone: 15 at
// run()'s decode steps, 240 blocks).
//  * One block per (split, kv head, row).  It computes the row's live slot
//    range on the device as paged_fwd does, cuts it into NS runs of whole
//    32-slot tiles (tiles counted from the range's first slot) and walks
//    its own run, so a short row among long ones also spreads over all its
//    splits.  A split that receives no tile writes m = -inf, l = 0, acc =
//    0, which the merge adds as exact nothing; an idle lane (all sentinel)
//    walks nothing in any split and comes out as exact zeros.
//  * The block holds only its R = k G query rows (G = 2 at gemma2-2b), and
//    decode_update (attn_tile.cuh) shares their scores and accumulator
//    columns among all 256 threads.
//  * K/V tiles are double-buffered with cp.async: while tile t is copied,
//    the block finds the next tile's page ids and positions and passes
//    over dead tiles, then starts that tile's copy before it updates on
//    tile t.  The ids and positions are read from the table 256 slots at
//    a time (a slot a thread) into shared memory, so a tile costs no
//    dependent global round trip of its own.  fp32 pages are copied 16 bytes at a time into unpadded rows
//    (decode_update's reads need none); int8 pages are staged as bytes
//    (rows padded by 32 bytes against bank conflicts) with their
//    (slot, head) scales, and each element is multiplied by its scale
//    where decode_update reads it: the same single fp32 product as
//    paged_fwd's dequantize-on-load.  A slot lives in page
//    block_tables[row, s / ps] at offset s % ps, so with 16-slot pages a
//    tile spans two table entries.
//  * paged_combine merges the splits in split order with no atomics
//    (attn_tile.cuh: combine_cols), so a call gives the same bits every
//    time; it sums in another order than paged_fwd, so the two agree to
//    the reference tolerance, not bit for bit.  Shared memory: ~140 KB at
//    D = 256 for fp32 pages (one block an SM), ~48 KB for int8.
//  * What bounds it on an H100: decode_update more than the copies.  In a
//    probe on the card, the walk without its copies took most of the full
//    walk's time, and a ring of three tiles (two copies in flight) took
//    the same time as two; the update is a chain of short phases with a
//    barrier after each, on one block an SM for fp32 pages.
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

// ------------------------------------------------------- split walk
constexpr int KPAD8 = 32;   // int8 row padding, bytes

// A staged tile as decode_update reads it: fp32 rows of D floats.
struct F32Tile {
  const float* K;
  const float* V;
  int D;
  __device__ __forceinline__ float4 k4(int j, int d) const {
    return *reinterpret_cast<const float4*>(K + j * D + d);
  }
  __device__ __forceinline__ float v(int c, int d) const {
    return V[c * D + d];
  }
};

// int8 rows of D bytes (stride RS) and their (slot, head) scales.
struct I8Tile {
  const int8_t* K;
  const int8_t* V;
  const float* ks;
  const float* vs;
  int RS;
  __device__ __forceinline__ float4 k4(int j, int d) const {
    const char4 c = *reinterpret_cast<const char4*>(K + j * RS + d);
    const float s = ks[j];
    return make_float4((float)c.x * s, (float)c.y * s, (float)c.z * s,
                       (float)c.w * s);
  }
  __device__ __forceinline__ float v(int c, int d) const {
    return (float)V[c * RS + d] * vs[c];
  }
};

// Bytes of one staged K or V tile.
__host__ __device__ inline size_t split_tile_bytes(int D, bool quant) {
  return quant ? (size_t)BKV * (D + KPAD8) : sizeof(float) * BKV * D;
}

// Dynamic shared memory of the split walk: Q (R x D, pre-scaled), then two
// K and two V tiles.
inline size_t split_smem_bytes(int R, int D, bool quant) {
  return sizeof(float) * (size_t)R * D + 4 * split_tile_bytes(D, quant);
}

// One block per (split s, kv head h, row b).  VEC: int8 rows in 16-byte
// copies (D % 16 == 0 and 16-byte aligned pages), else 4-byte copies.
template <bool QUANT, bool VEC>
__global__ void __launch_bounds__(NT)
paged_split(const float* __restrict__ q, const void* __restrict__ kpages,
            const void* __restrict__ vpages, const int* __restrict__ pos,
            const int* __restrict__ bt, const int* __restrict__ qpos,
            const float* __restrict__ kscale,
            const float* __restrict__ vscale, float* __restrict__ pm,
            float* __restrict__ pl, float* __restrict__ pacc, int k, int P,
            int ps, int Hq, int Hkv, int D, int nb, int G, int window,
            float cap, float scale, int NS) {
  extern __shared__ float4 smem4[];
  const int R = k * G;
  float* Qs = reinterpret_cast<float*>(smem4);
  unsigned char* tiles = reinterpret_cast<unsigned char*>(Qs + R * D);
  const size_t tb = split_tile_bytes(D, QUANT);
  __shared__ int kps[2][BKV];
  __shared__ long long kslot[2][BKV];   // flat (page, slot) of each slot
  __shared__ float ksc[2][BKV], vsc[2][BKV];
  __shared__ int mpos[NT];              // positions and flat slots of the
  __shared__ long long mslot[NT];       // NT / BKV tiles from tile mt0 on
  __shared__ int qps[ROWS];
  __shared__ float Ss[ROWS * BKV];
  __shared__ float ms[ROWS], ls[ROWS], as[ROWS];
  __shared__ int qlo, qhi;

  const int tid = threadIdx.x;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D;
    Qs[i] = q[(((size_t)b * k + r / G) * Hq + h * G + r % G) * D + d] *
            scale;
  }
  if (tid < R) {
    qps[tid] = qpos[(size_t)b * k + tid / G];
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  if (tid == 0) {            // the row's real (non-sentinel) positions
    int lo = INT_MAX, hi = INT_MIN;
    for (int c = 0; c < k; ++c) {
      const int p = qpos[(size_t)b * k + c];
      if (p == SENT) continue;
      lo = min(lo, p);
      hi = max(hi, p);
    }
    qlo = lo;
    qhi = hi;
  }
  __syncthreads();

  long long s_begin = 0, s_end = 0;    // the row's live logical slots
  if (qlo <= qhi) {
    long long first = 0;
    if (window > 0)
      first = max(0LL, (long long)qlo - (window - 1)) / ps;
    first = min(first, (long long)nb - 1);
    s_begin = first * ps;
    s_end = (long long)min(nb, qhi / ps + 1) * ps;
  }
  const int n_t = (int)((s_end - s_begin + BKV - 1) / BKV);
  const int per = (n_t + NS - 1) / NS;
  const int t_end = min(n_t, (s + 1) * per);
  const int* btrow = bt + (size_t)b * nb;
  const int8_t* k8 = static_cast<const int8_t*>(kpages);
  const int8_t* v8 = static_cast<const int8_t*>(vpages);
  const float* kf = static_cast<const float*>(kpages);
  const float* vf = static_cast<const float*>(vpages);

  // The page ids and positions of NT slots (NT / BKV tiles) from tile t
  // on, one slot a thread, so the walk reads the table in one round trip
  // per NT slots instead of one per tile.
  int mt0 = -NT;
  auto load_meta = [&](int t) {
    const long long sl = s_begin + (long long)t * BKV + tid;
    int kp = SENT;
    long long flat = 0;
    if (sl < s_end) {
      const int page = btrow[sl / ps];
      if (page >= 0 && page < P) {
        flat = (long long)page * ps + sl % ps;
        kp = pos[flat];
      }
    }
    mpos[tid] = kp;
    mslot[tid] = flat;
    mt0 = t;
    __syncthreads();
  };
  // From tile t on, the first tile that some real query row may attend
  // (paged_fwd's skip test), its positions and slots left in buffer u;
  // t_end if there is none.
  auto next_live = [&](int t, int u) {
    for (; t < t_end; ++t) {
      if (t >= mt0 + NT / BKV) load_meta(t);
      int live = 0;
      if (tid < BKV) {
        const int i = (t - mt0) * BKV + tid;
        const int kp = mpos[i];
        kps[u][tid] = kp;
        kslot[u][tid] = mslot[i];
        live = kp != SENT && kp <= qhi &&
               (window <= 0 || (long long)kp > (long long)qlo - window);
      }
      if (__syncthreads_or(live)) break;
    }
    return t;
  };
  // Starts the copy of the tile whose slots are in buffer u (sentinel slots
  // zero-filled, scales included).
  auto start_copy = [&](int u) {
    unsigned char* Kb = tiles + u * tb;
    unsigned char* Vb = tiles + (2 + u) * tb;
    if (QUANT) {
      const int RS = D + KPAD8;
      constexpr int CH = VEC ? 16 : 4;
      const int C = D / CH;
      for (int i = tid; i < BKV * C; i += NT) {
        const int j = i / C, d = (i - j * C) * CH;
        const bool ok = kps[u][j] != SENT;
        const size_t off = ((size_t)kslot[u][j] * Hkv + h) * D + d;
        if (VEC) {
          rt::cp_async16(Kb + j * RS + d, ok ? k8 + off : k8, ok);
          rt::cp_async16(Vb + j * RS + d, ok ? v8 + off : v8, ok);
        } else {
          rt::cp_async4(Kb + j * RS + d, ok ? k8 + off : k8, ok);
          rt::cp_async4(Vb + j * RS + d, ok ? v8 + off : v8, ok);
        }
      }
      if (tid < BKV) {
        const bool ok = kps[u][tid] != SENT;
        const size_t row = (size_t)kslot[u][tid] * Hkv + h;
        rt::cp_async4(&ksc[u][tid], ok ? kscale + row : kscale, ok);
        rt::cp_async4(&vsc[u][tid], ok ? vscale + row : vscale, ok);
      }
    } else {
      float* Kt = reinterpret_cast<float*>(Kb);
      float* Vt = reinterpret_cast<float*>(Vb);
      const int D4 = D / 4;
      for (int i = tid; i < BKV * D4; i += NT) {
        const int j = i / D4, d = (i - j * D4) * 4;
        const bool ok = kps[u][j] != SENT;
        const size_t off = ((size_t)kslot[u][j] * Hkv + h) * D + d;
        rt::cp_async16(Kt + j * D + d, ok ? kf + off : kf, ok);
        rt::cp_async16(Vt + j * D + d, ok ? vf + off : vf, ok);
      }
    }
    rt::cp_async_commit();
  };

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  int cur = next_live(min(n_t, s * per), 0), u = 0;
  if (cur < t_end) start_copy(0);
  while (cur < t_end) {
    const int nxt = next_live(cur + 1, u ^ 1);
    if (nxt < t_end) {
      start_copy(u ^ 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* Kb = tiles + u * tb;
    const unsigned char* Vb = tiles + (2 + u) * tb;
    if (QUANT) {
      const I8Tile kv{reinterpret_cast<const int8_t*>(Kb),
                      reinterpret_cast<const int8_t*>(Vb), ksc[u], vsc[u],
                      D + KPAD8};
      decode_update(Qs, kv, kps[u], qps, Ss, ms, ls, as, R, D, /*causal=*/1,
                    window, cap, acc);
    } else {
      const F32Tile kv{reinterpret_cast<const float*>(Kb),
                       reinterpret_cast<const float*>(Vb), D};
      decode_update(Qs, kv, kps[u], qps, Ss, ms, ls, as, R, D, /*causal=*/1,
                    window, cap, acc);
    }
    __syncthreads();
    cur = nxt;
    u ^= 1;
  }

  // the split's unnormalised state of each row: (m, l), then acc
  if (tid < R) {
    const size_t row =
        partial_row(b, h * G + tid % G, s, tid / G, Hq, NS, k);
    pm[row] = ms[tid];
    pl[row] = ls[tid];
  }
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int i = tid + NT * j;
    if (i < R * D) {
      const int r = i / D, d = i - r * D;
      pacc[partial_row(b, h * G + r % G, s, r / G, Hq, NS, k) * D + d] =
          acc[j];
    }
  }
}

// One block per (column, q head, row), 4 output columns a thread.
__global__ void paged_combine(const float* __restrict__ pm,
                              const float* __restrict__ pl,
                              const float* __restrict__ pacc,
                              float* __restrict__ o, int k, int Hq, int D,
                              int NS) {
  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x * 4;
  if (d >= D) return;
  const float4 val = combine_cols(
      pm, pl, pacc, partial_row(b, head, 0, qi, Hq, NS, k), k, NS, D, d);
  *reinterpret_cast<float4*>(o + (((size_t)b * k + qi) * Hq + head) * D +
                             d) = val;
}

template <bool QUANT, bool VEC>
int launch_split(const void* q, const void* kp, const void* vp,
                 const void* pos, const void* bt, const void* qpos,
                 const void* ks, const void* vs, void* o, void* ml,
                 void* pacc, int B, int k, int P, int ps, int Hq, int Hkv,
                 int D, int nb, int window, int NS, float cap, float scale,
                 cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = split_smem_bytes(k * G, D, QUANT);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split<QUANT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pm = static_cast<float*>(ml);
  float* pl = pm + (size_t)B * Hq * NS * k;
  float* pa = static_cast<float*>(pacc);
  paged_split<QUANT, VEC><<<dim3(NS, Hkv, B), NT, smem, stream>>>(
      static_cast<const float*>(q), kp, vp, static_cast<const int*>(pos),
      static_cast<const int*>(bt), static_cast<const int*>(qpos),
      static_cast<const float*>(ks), static_cast<const float*>(vs), pm, pl,
      pa, k, P, ps, Hq, Hkv, D, nb, G, window, cap, scale, NS);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  paged_combine<<<dim3(k, Hq, B), (D + 3) / 4, 0, stream>>>(
      pm, pl, pa, static_cast<float*>(o), k, Hq, D, NS);
  return static_cast<int>(cudaGetLastError());
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
// cap <= 0: no softcap.  n_splits <= 1 runs the single walk (paged_fwd);
// n_splits > 1 needs k <= 32 / G and runs the split walk, with `ml`
// holding 2 x B Hq n_splits k floats (m, then l) and `pacc` B Hq n_splits k
// D floats.  Returns cudaGetLastError() right after the launches.
extern "C" int paged_attention_f32(const void* q, const void* k_pages,
                                   const void* v_pages, const void* pos_pages,
                                   const void* block_tables,
                                   const void* q_pos, const void* k_scale,
                                   const void* v_scale, void* o, void* ml,
                                   void* pacc, int B, int k, int P, int ps,
                                   int Hq, int Hkv, int D, int nb, int quant,
                                   int window, int n_splits, float cap,
                                   float scale, void* stream) {
  if (D % TPR != 0 || D % 4 != 0 || D > DMAX || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS || ps < 1 || nb < 1 ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_splits > 1) {
    if (k * (Hq / Hkv) > ROWS || ml == nullptr || pacc == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (!quant)
      return launch_split<false, false>(
          q, k_pages, v_pages, pos_pages, block_tables, q_pos, k_scale,
          v_scale, o, ml, pacc, B, k, P, ps, Hq, Hkv, D, nb, window,
          n_splits, cap, scale, st);
    const bool vec = D % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
    return vec ? launch_split<true, true>(
                     q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                     k_scale, v_scale, o, ml, pacc, B, k, P, ps, Hq, Hkv, D,
                     nb, window, n_splits, cap, scale, st)
               : launch_split<true, false>(
                     q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                     k_scale, v_scale, o, ml, pacc, B, k, P, ps, Hq, Hkv, D,
                     nb, window, n_splits, cap, scale, st);
  }
  return quant ? launch<true>(q, k_pages, v_pages, pos_pages, block_tables,
                              q_pos, k_scale, v_scale, o, B, k, P, ps, Hq,
                              Hkv, D, nb, window, cap, scale, st)
               : launch<false>(q, k_pages, v_pages, pos_pages, block_tables,
                               q_pos, k_scale, v_scale, o, B, k, P, ps, Hq,
                               Hkv, D, nb, window, cap, scale, st);
}
