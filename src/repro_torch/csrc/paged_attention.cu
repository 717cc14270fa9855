// K4: causal GQA attention for q tiles of k left-aligned tokens per
// sequence over the paged KV pool (chunked-prefill chunks, decode tokens at
// k = 1), with sliding-window, softcap and sentinel masks and fp32, bf16
// or int8 pages.
//
// Replaces the TPU kernel repro/kernels/attention.py::paged_prefill_attention
// (_paged_kernel at :206, pallas_call at :347; paged_decode_attention at
// :357 is its k = 1 wrapper).  Layouts are the reference's: q (B, k, Hq, D)
// fp32 or bf16 (staged in fp32, upcast first and then scaled, as the
// reference's kernel does; o is written once in q's dtype from the fp32
// merge or accumulator); k / v pages (P, ps, Hkv, D) fp32, bf16 or int8 (KvType,
// attn_tile.cuh; bf16 converted to fp32 exactly as it is staged, as the
// reference upcasts in its kernel); pos pages (P, ps) int32;
// block tables (B, nb) int32; q_pos (B, k) int32, real tokens in columns
// 0..c-1 in ascending order and POS_SENTINEL after; int8 pools add
// per-(slot, head) scale pages (P, ps, Hkv) fp32; o (B, k, Hq, D) of q's
// type.
//
// Bound on an H100: a prompt chunk by its operations (4 D flops per
// attended (query head, key) pair) at the TF32 tensor-core peak, as K1's
// prefill (its three TF32 passes make the route's floor three times
// that); a decode token by the bytes of the pages its walk reads, once per
// kv head.
//
// Two launch shapes, both walking the row's block table inside the block
// in place of the TPU's grid axis over blocks with its scalar-prefetched
// table; kernels/attention.py::paged_walk picks one from shapes alone (the
// decode walk for q tiles of k <= 32 / G columns, whatever the batch):
//  * Chunk steps: attn_tc over PagedSlots (attn_tc.cuh, K1's prefill walk with K4's K/V
//    source).  128 query rows a block (64 positions x G = 2 heads of one
//    kv head), scores and P V on TF32 mma.sync in three passes (fp32
//    accuracy), the live slot range computed on the device, int8 pages
//    dequantized in shared memory once they land.  The walk is also split
//    across blocks (kernels/attention.py::paged_chunk_splits, from shapes
//    alone): at run()'s chunk shape (4 rows x 512, 4224 slots) the single
//    walk's 8 x 4 x 4 = 128 blocks are one wave in which the q tiles of a
//    long row's late chunk (~130 tiles each) set the time; 8 splits give
//    1024 blocks of at most ~17 tiles.  Each split writes its unnormalised
//    (m, l, acc); paged_combine merges them in split order.
//    kernels/ref.py::paged_attention_split_ref(mm=einsum_tf32x3) states
//    what it computes.
//  * Decode: the split-KV walk paged_split + paged_combine, below.
// Masks: sentinel slots, causal by each row's own position, the window,
// and the tanh softcap before the mask; an idle lane (all sentinel) walks
// nothing and comes out as exact zeros.  No atomics: every output element
// is written by one thread after walks and merges in a fixed order, so
// two calls give the same bits.
//
// ---- Decode: split-KV walk (paged_split, paged_combine).
// Every call whose q tile holds at most 32 / G columns (every decode step)
// runs this walk.  Where its R * Hkv blocks (16 at 4 rows on gemma2-2b)
// are fewer than the SMs, the wrapper asks for NS > 1 splits
// (kernels/attention.py::paged_decode_splits, from shapes alone: 15 at
// run()'s decode steps, 240 blocks); a batch whose blocks fill the card
// alone (B Hkv >= SMs: 33 or more slots on gemma2-2b) runs NS = 1, still
// through the partials and the merge, a few microseconds of one extra
// launch.
//  * One block per (split, kv head, row).  It computes the row's live slot
//    range on the device as attn_tc's PagedSlots does (from the window's
//    first page for the row's lowest real position to the page of its
//    highest), cuts it into NS runs of whole 32-slot tiles (tiles counted
//    from the range's first slot) and walks its own run, so a short row
//    among long ones also spreads over all its splits.  A split that
//    receives no tile writes m = -inf, l = 0, acc = 0, which the merge
//    adds as exact nothing; an idle lane (all sentinel) walks nothing in
//    any split and comes out as exact zeros.
//  * The block holds only its R = k G query rows (G = 2 at gemma2-2b), and
//    decode_update (attn_tile.cuh) shares their scores and accumulator
//    columns among all 256 threads.
//  * K/V tiles are double-buffered with cp.async: while tile t is copied,
//    the block finds the next tile's page ids and positions and passes
//    over dead tiles, then starts that tile's copy before it updates on
//    tile t.  The ids and positions are read from the table 256 slots at
//    a time (a slot a thread) into shared memory, so a tile costs no
//    dependent global round trip of its own.  fp32 pages are copied 16
//    bytes at a time into unpadded rows (decode_update's reads need
//    none); int8 pages are staged as bytes (rows padded by 32 bytes
//    against bank conflicts) with their (slot, head) scales, and each
//    element is multiplied by its scale where decode_update reads it: the
//    same single fp32 product as the plain version's
//    gather-then-dequantize; bf16 pages are staged as stored (rows padded
//    by 64 bytes, so that the 8-byte reads of a half-warp's two K rows
//    fall on distinct banks) and converted where decode_update reads them.  A slot lives in page
//    block_tables[row, s / ps] at offset s % ps, so with 16-slot pages a
//    tile spans two table entries.
//  * paged_combine merges the splits in split order with no atomics
//    (attn_tile.cuh: combine_cols), so a call gives the same bits every
//    time; it sums in another order than the tensor-core walk, so the two
//    agree to the reference tolerance, not bit for bit.  Shared memory:
//    ~140 KB at D = 256 for fp32 pages (one block an SM), ~48 KB for int8.
//  * What bounds it on an H100: decode_update more than the copies.  In a
//    probe on the card, the walk without its copies took most of the full
//    walk's time, and a ring of three tiles (two copies in flight) took
//    the same time as two; the update is a chain of short phases with a
//    barrier after each, on one block an SM for fp32 pages.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_tc.cuh"
#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace attn;

// ------------------------------------------------------- split walk
constexpr int KPAD8 = 32;   // int8 row padding, bytes
constexpr int KPAD16 = 64;  // bf16 row padding, bytes

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

// bf16 rows of 2 D bytes (stride RS), converted where they are read.
struct Bf16Tile {
  const unsigned char* K;
  const unsigned char* V;
  int RS;
  __device__ __forceinline__ float4 k4(int j, int d) const {
    return bf16x4(K + j * RS + 2 * d);
  }
  __device__ __forceinline__ float v(int c, int d) const {
    return __uint_as_float(
        static_cast<uint32_t>(
            *reinterpret_cast<const unsigned short*>(V + c * RS + 2 * d))
        << 16);
  }
};

// Bytes of one staged K or V row, and of a tile, for element type kt.
__host__ __device__ inline int split_row_bytes(int D, int kt) {
  return kt == KV_F32 ? 4 * D : (kt == KV_BF16 ? 2 * D + KPAD16 : D + KPAD8);
}
__host__ __device__ inline size_t split_tile_bytes(int D, int kt) {
  return (size_t)BKV * split_row_bytes(D, kt);
}

// Dynamic shared memory of the split walk: Q (R x D, pre-scaled), then two
// K and two V tiles.
inline size_t split_smem_bytes(int R, int D, int kt) {
  return sizeof(float) * (size_t)R * D + 4 * split_tile_bytes(D, kt);
}

// One block per (split s, kv head h, row b).  KT: the pages' KvType.  VEC:
// bf16 / int8 rows in 16-byte copies (2 D or D a multiple of 16 and
// 16-byte aligned pages), else 4-byte copies.  QT: the query type.
template <int KT, bool VEC, class QT>
__global__ void __launch_bounds__(NT)
paged_split(const QT* __restrict__ q, const void* __restrict__ kpages,
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
  const size_t tb = split_tile_bytes(D, KT);
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
    Qs[i] = to_f32(q[(((size_t)b * k + r / G) * Hq + h * G + r % G) * D +
                     d]) *
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
  const unsigned char* k8 = static_cast<const unsigned char*>(kpages);
  const unsigned char* v8 = static_cast<const unsigned char*>(vpages);
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
  // (attn_tc's skip test), its positions and slots left in buffer u;
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
    if (KT != KV_F32) {
      const int RS = split_row_bytes(D, KT);
      const int RB = D * kv_bytes(KT);     // bytes of a stored row
      constexpr int CH = VEC ? 16 : 4;
      const int C = RB / CH;
      for (int i = tid; i < BKV * C; i += NT) {
        const int j = i / C, d = (i - j * C) * CH;
        const bool ok = kps[u][j] != SENT;
        const size_t off = ((size_t)kslot[u][j] * Hkv + h) * RB + d;
        if (VEC) {
          rt::cp_async16(Kb + j * RS + d, ok ? k8 + off : k8, ok);
          rt::cp_async16(Vb + j * RS + d, ok ? v8 + off : v8, ok);
        } else {
          rt::cp_async4(Kb + j * RS + d, ok ? k8 + off : k8, ok);
          rt::cp_async4(Vb + j * RS + d, ok ? v8 + off : v8, ok);
        }
      }
      if (KT == KV_I8 && tid < BKV) {
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
    if (KT == KV_I8) {
      const I8Tile kv{reinterpret_cast<const int8_t*>(Kb),
                      reinterpret_cast<const int8_t*>(Vb), ksc[u], vsc[u],
                      D + KPAD8};
      decode_update(Qs, kv, kps[u], qps, Ss, ms, ls, as, R, D, /*causal=*/1,
                    window, cap, acc);
    } else if (KT == KV_BF16) {
      const Bf16Tile kv{Kb, Vb, 2 * D + KPAD16};
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

// One block per (column, q head, row), 4 output columns a thread; o of
// the query type QT.
template <class QT>
__global__ void paged_combine(const float* __restrict__ pm,
                              const float* __restrict__ pl,
                              const float* __restrict__ pacc,
                              QT* __restrict__ o, int k, int Hq, int D,
                              int NS) {
  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x * 4;
  if (d >= D) return;
  const float4 val = combine_cols(
      pm, pl, pacc, partial_row(b, head, 0, qi, Hq, NS, k), k, NS, D, d);
  store4(o + (((size_t)b * k + qi) * Hq + head) * D + d, val);
}

template <int KT, bool VEC, class QT>
int launch_split(const void* q, const void* kp, const void* vp,
                 const void* pos, const void* bt, const void* qpos,
                 const void* ks, const void* vs, void* o, void* ml,
                 void* pacc, int B, int k, int P, int ps, int Hq, int Hkv,
                 int D, int nb, int window, int NS, float cap, float scale,
                 cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = split_smem_bytes(k * G, D, KT);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split<KT, VEC, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pm = static_cast<float*>(ml);
  float* pl = pm + (size_t)B * Hq * NS * k;
  float* pa = static_cast<float*>(pacc);
  paged_split<KT, VEC, QT><<<dim3(NS, Hkv, B), NT, smem, stream>>>(
      static_cast<const QT*>(q), kp, vp, static_cast<const int*>(pos),
      static_cast<const int*>(bt), static_cast<const int*>(qpos),
      static_cast<const float*>(ks), static_cast<const float*>(vs), pm, pl,
      pa, k, P, ps, Hq, Hkv, D, nb, G, window, cap, scale, NS);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  paged_combine<QT><<<dim3(k, Hq, B), (D + 3) / 4, 0, stream>>>(
      pm, pl, pa, static_cast<QT*>(o), k, Hq, D, NS);
  return static_cast<int>(cudaGetLastError());
}

// paged_attention_fwd with q and o of type QT; the arguments are checked.
template <class QT>
int paged_fwd(const void* q, const void* k_pages, const void* v_pages,
              const void* pos_pages, const void* block_tables,
              const void* q_pos, const void* k_scale, const void* v_scale,
              void* o, void* ml, void* pacc, int B, int k, int P, int ps,
              int Hq, int Hkv, int D, int nb, int kv_type, int window, int tc,
              int n_splits, float cap, float scale, cudaStream_t st) {
  const int G = Hq / Hkv;
  // bf16 / int8 rows in 16-byte copies where a row is whole 16-byte
  // chunks and the pages are 16-byte aligned
  const bool vec = (D * kv_bytes(kv_type)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
#define PAGED_SPLIT(KT, VEC)                                                \
  launch_split<KT, VEC, QT>(q, k_pages, v_pages, pos_pages, block_tables,   \
                            q_pos, k_scale, v_scale, o, ml, pacc, B, k, P,  \
                            ps, Hq, Hkv, D, nb, window, n_splits, cap,      \
                            scale, st)
  if (!tc) {
    if (kv_type == KV_F32) return PAGED_SPLIT(KV_F32, false);
    if (kv_type == KV_BF16)
      return vec ? PAGED_SPLIT(KV_BF16, true) : PAGED_SPLIT(KV_BF16, false);
    return vec ? PAGED_SPLIT(KV_I8, true) : PAGED_SPLIT(KV_I8, false);
  }
#undef PAGED_SPLIT
  float* pm = static_cast<float*>(ml);
  float* pl = pm ? pm + (size_t)B * Hq * n_splits * k : nullptr;
  float* pa = static_cast<float*>(pacc);
  const TcArgs a{q, static_cast<const int*>(q_pos), k_pages, v_pages,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), o, pm, pl, pa, B, k, Hq,
                 Hkv, D, G, TROWS / G, n_splits, /*causal=*/1, window,
                 vec ? 1 : 0, cap, scale};
  const PagedSlots src{static_cast<const int*>(pos_pages),
                       static_cast<const int*>(block_tables), P, ps, nb};
  const int e =
      kv_type == KV_I8    ? launch_tc<PagedSlots, KV_I8, QT>(a, src, st)
      : kv_type == KV_BF16 ? launch_tc<PagedSlots, KV_BF16, QT>(a, src, st)
                           : launch_tc<PagedSlots, KV_F32, QT>(a, src, st);
  if (e != 0 || n_splits == 1) return e;
  paged_combine<QT><<<dim3(k, Hq, B), (D + 3) / 4, 0, st>>>(
      pm, pl, pa, static_cast<QT*>(o), k, Hq, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_type: the pages' KvType; KV_I8 pages come with scale pages k_scale /
// v_scale (ignored for the others).  q_type: Q_F32 or Q_BF16 (q and o of
// that type).  window <= 0: no window; cap <= 0: no softcap.  tc == 0
// runs the decode walk (paged_split + paged_combine, also at n_splits =
// 1), which takes q tiles of k <= 32 / G columns only; tc != 0 runs the
// tensor-core walk (attn_tc over PagedSlots) with n_splits splits, merged
// by paged_combine when n_splits > 1.  kernels/attention.py::paged_walk
// picks both.  Where the call merges, `ml` holds 2 x B Hq n_splits k
// floats (m, then l) and `pacc` B Hq n_splits k D floats.  Returns
// cudaGetLastError() right after the launches.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* pos_pages,
                                   const void* block_tables,
                                   const void* q_pos, const void* k_scale,
                                   const void* v_scale, void* o, void* ml,
                                   void* pacc, int B, int k, int P, int ps,
                                   int Hq, int Hkv, int D, int nb,
                                   int kv_type, int q_type, int window,
                                   int tc, int n_splits, float cap,
                                   float scale, void* stream) {
  const bool merged = !tc || n_splits > 1;
  if (D % 8 != 0 || D > DMAX || Hq % Hkv != 0 || Hq / Hkv > ROWS ||
      ps < 1 || nb < 1 || n_splits < 1 ||
      (kv_type != KV_F32 && kv_type != KV_BF16 && kv_type != KV_I8) ||
      (q_type != Q_F32 && q_type != Q_BF16) ||
      (!tc && k * (Hq / Hkv) > ROWS) ||
      (kv_type == KV_I8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (merged && (ml == nullptr || pacc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_type == Q_BF16)
    return paged_fwd<__nv_bfloat16>(
        q, k_pages, v_pages, pos_pages, block_tables, q_pos, k_scale,
        v_scale, o, ml, pacc, B, k, P, ps, Hq, Hkv, D, nb, kv_type, window,
        tc, n_splits, cap, scale, st);
  return paged_fwd<float>(q, k_pages, v_pages, pos_pages, block_tables,
                          q_pos, k_scale, v_scale, o, ml, pacc, B, k, P, ps,
                          Hq, Hkv, D, nb, kv_type, window, tc, n_splits, cap,
                          scale, st);
}
