// K1: flash-attention forward over a dense KV (prefill and dense-cache
// decode), GQA, causal / sliding-window masking from positions alone, an
// optional tanh softcap, and an fp32 online softmax.
//
// Replaces the TPU kernel repro/kernels/attention.py::flash_attention
// (_flash_kernel at :124, pallas_call at :181).  Layouts are the
// reference's: q (B, Sq, Hq, D), k / v (B, Skv, Hkv, D), q_pos (B, Sq),
// kv_pos (B, Skv) int32, o (B, Sq, Hq, D), all contiguous; q and o fp32
// or bf16, one type (the reference's kernel upcasts q, scales it in fp32
// and writes o in q.dtype: the walks stage q in fp32, upcast first and
// then scaled, and round the output once from the fp32 accumulator), k
// and v fp32 or bf16 (a bf16 cache, converted to fp32 as its tiles are
// staged: the reference upcasts in its kernel the same way).  A bf16 q is
// exact in TF32, so the tensor-core walk's split of it has a zero lo part.
//
// Bound on an H100: prefill by its operations, 4 D flops per attended
// (query head, key) pair, at the TF32 tensor-core peak of 495 TFLOP/s
// (0.29 ms at gemma2-2b's 2 x 4160 prefill); the three TF32 passes of the
// route below make its own floor three times that (0.86 ms).  Decode
// (Sq = 1) by the bytes of the K/V cache, read once per kv head.
//
// Design:
//  * Prefill: attn_tc over DenseSlots (attn_tc.cuh, shared with K4's
//    chunk steps): the scores and P V on TF32 tensor cores (mma.sync
//    m16n8k8) with both operands of both products split into hi and lo
//    parts, three passes (fp32 accuracy; kernels/ref.py::
//    attention_tf32x3_ref states the arithmetic), 128 query rows a block
//    (all G heads of a kv head), P kept in registers, K and V tiles taking
//    turns in shared memory beside the fp32 Q, dead tiles skipped before
//    they are loaded.  Every call that does not split runs it (prefill,
//    the LM evaluator's 4 x 128 forward, decode on a grid that fills the
//    card).
//  * Split-KV decode.  Where one q tile of 32 rows (BQ = 32 / G positions)
//    holds every query position and the single walk's grid (Hkv * B
//    blocks: 8 at gemma2-2b decode with B = 2) would leave most of the 132
//    SMs idle, the wrapper asks for NS > 1 splits
//    (kernels/attention.py::decode_splits): flash_split runs one block per
//    (split, kv head, batch row), each over its own run of whole 32-row KV
//    tiles, and writes its rows' unnormalised (m, l, acc) into fp32
//    partials the wrapper allocates; split_combine merges them in split
//    order (attn_tile.cuh: write_partial, combine_cols).  At gemma2-2b
//    decode NS = 33: 264 blocks of 4 tiles each.  A bf16 cache's tiles are
//    copied as they are stored into a double-buffered staging area and
//    converted into one fp32 K and one fp32 V tile once they land.  The split walk
//    double-buffers its K/V tiles with cp.async, so the copy of the next
//    live tile overlaps tile_update (attn_tile.cuh, fp32 FMAs on CUDA
//    cores) on the current one (K in 4-byte copies, since its rows are
//    padded to D + 1 floats against bank conflicts; V in 16-byte copies);
//    the positions of the next tile are read, and the tile skipped if no
//    row can attend it, while the current copy is in flight.  The block
//    keeps the 32-row query tile, of which only G = 2 rows are real at
//    gemma2-2b decode; a warp that holds no real row (7 of the 8 there)
//    skips tile_update.  The walk is then bound by the live warp's
//    tile_update, one tile after another (PERF.md section 6).  The two
//    walks sum in other orders, so they agree to the reference tolerance,
//    not bit for bit; each gives the same bits on every run.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_tc.cuh"
#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace attn;

// fp32 K/V tiles the split walk holds: two (the copies land in them) for
// fp32, one for bf16 (converted from the staging area).
__host__ __device__ constexpr int split_bufs(int kt) {
  return kt == KV_F32 ? 2 : 1;
}

// Shared memory of the split walk: Q, the K tiles (rows of D + 1), the V
// tiles and P, ~165 KB at D = 256 for fp32; for bf16 one fp32 K and V
// tile and two K and two V tiles as stored, ~168 KB.
inline size_t split_smem_bytes(int D, int kt) {
  const int nb = split_bufs(kt);
  return sizeof(float) *
             ((size_t)ROWS * (D + 1) + nb * (size_t)BKV * (D + 1) +
              nb * (size_t)BKV * D + (size_t)ROWS * (BKV + 1)) +
         (kt == KV_F32 ? 0 : 4 * (size_t)BKV * D * kv_bytes(kt));
}

// One block per (split s, kv head, batch row), the block's query tile at
// q0 = 0 (Sq <= BQ); split s walks KV tiles [s * tps, (s + 1) * tps).  KT:
// KV_F32 or KV_BF16; QT: the query type.
template <int KT, class QT>
__global__ void __launch_bounds__(NT)
flash_split(const QT* __restrict__ q, const void* __restrict__ k,
            const void* __restrict__ v, const int* __restrict__ qpos,
            const int* __restrict__ kvpos, float* __restrict__ pm,
            float* __restrict__ pl, float* __restrict__ pacc, int Sq,
            int Skv, int Hq, int Hkv, int D, int G, int BQ, int causal,
            int window, float cap, float scale, int NS, int tps) {
  extern __shared__ float smem[];
  constexpr int NB = split_bufs(KT);
  const int DS = D + 1;
  float* Qs = smem;
  float* Ks0 = Qs + ROWS * DS;                 // [NB][BKV][D + 1]
  float* Vs0 = Ks0 + NB * BKV * DS;            // [NB][BKV][D]
  float* Ps = Vs0 + NB * BKV * D;
  // bf16: [2][K, V][BKV][D] as stored
  unsigned char* raw = reinterpret_cast<unsigned char*>(Ps + ROWS * (BKV + 1));
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const unsigned char* kb = static_cast<const unsigned char*>(k);
  const unsigned char* vb = static_cast<const unsigned char*>(v);
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
  load_q(q, qpos, Qs, qps, qlo, qhi, b, h, 0, Sq, Hq, D, G, BQ, scale);
  const int n_tiles = (Skv + BKV - 1) / BKV;
  const int t_end = min(n_tiles, (s + 1) * tps);

  // From tile t on, the first tile that some query row of the block may
  // attend (as attn_tc's skip test), its positions left in kps[u];
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
  // Starts the copy of tile t into buffer u (rows past Skv zero-filled):
  // fp32 rows into the fp32 tiles, bf16 rows into the staging area.
  auto start_copy = [&](int t, int u) {
    const int kv0 = t * BKV;
    if (KT == KV_BF16) {
      const int RB = 2 * D, C = RB / 16;     // 16-byte chunks of a row
      unsigned char* kr = raw + (size_t)(2 * u) * BKV * RB;
      unsigned char* vr = kr + (size_t)BKV * RB;
      for (int i = tid; i < BKV * C; i += NT) {
        const int j = i / C, c = (i % C) * 16;
        const bool ok = kv0 + j < Skv;
        const size_t off =
            (((size_t)b * Skv + kv0 + j) * Hkv + h) * RB + c;
        rt::cp_async16(kr + j * RB + c, ok ? kb + off : kb, ok);
        rt::cp_async16(vr + j * RB + c, ok ? vb + off : vb, ok);
      }
      rt::cp_async_commit();
      return;
    }
    float* Ks = Ks0 + u * BKV * DS;
    float* Vs = Vs0 + u * BKV * D;
    for (int i = tid; i < BKV * D; i += NT) {
      const int j = i / D, d = i % D;
      const bool ok = kv0 + j < Skv;
      const size_t off = (((size_t)b * Skv + kv0 + j) * Hkv + h) * D + d;
      rt::cp_async4(Ks + j * DS + d, ok ? kf + off : kf, ok);
    }
    const int D4 = D / 4;
    for (int i = tid; i < BKV * D4; i += NT) {
      const int j = i / D4, d = (i % D4) * 4;
      const bool ok = kv0 + j < Skv;
      const size_t off = (((size_t)b * Skv + kv0 + j) * Hkv + h) * D + d;
      rt::cp_async16(Vs + j * D + d, ok ? vf + off : vf, ok);
    }
    rt::cp_async_commit();
  };
  // bf16: the landed tile of buffer u into the fp32 K (rows of D + 1) and
  // V tiles, then a barrier.
  auto convert = [&](int u) {
    const int RB = 2 * D, D4 = D / 4;
    const unsigned char* kr = raw + (size_t)(2 * u) * BKV * RB;
    const unsigned char* vr = kr + (size_t)BKV * RB;
    for (int i = tid; i < BKV * D4; i += NT) {
      const int j = i / D4, d = (i % D4) * 4;
      const float4 kv4 = bf16x4(kr + j * RB + 2 * d);
      float* kd = Ks0 + j * DS + d;
      kd[0] = kv4.x;
      kd[1] = kv4.y;
      kd[2] = kv4.z;
      kd[3] = kv4.w;
      *reinterpret_cast<float4*>(Vs0 + j * D + d) =
          bf16x4(vr + j * RB + 2 * d);
    }
    __syncthreads();
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
    if (KT == KV_BF16) convert(u);
    if (warp_live) {
      const int ub = KT == KV_BF16 ? 0 : u;
      const Tiles t{Qs, Ks0 + ub * BKV * DS, Vs0 + ub * BKV * D, Ps};
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

// One block per (position, q head, batch row), 4 columns a thread; o of
// the query type QT.
template <class QT>
__global__ void split_combine(const float* __restrict__ pm,
                              const float* __restrict__ pl,
                              const float* __restrict__ pacc,
                              QT* __restrict__ o, int Sq, int Hq, int D,
                              int NS) {
  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x * 4;
  if (d >= D) return;
  const float4 val = combine_cols(
      pm, pl, pacc, partial_row(b, head, 0, qi, Hq, NS, Sq), Sq, NS, D, d);
  store4(o + (((size_t)b * Sq + qi) * Hq + head) * D + d, val);
}

}  // namespace

namespace {

template <int KT, class QT>
int launch_split(const QT* qf, const void* k, const void* v,
                 const int* qp, const int* kp, QT* of, void* ml,
                 void* pacc, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                 int G, int BQ, int causal, int window, int n_splits,
                 float cap, float scale, cudaStream_t st) {
  const int n_tiles = (Skv + BKV - 1) / BKV;
  const int tps = (n_tiles + n_splits - 1) / n_splits;
  float* pm = static_cast<float*>(ml);
  float* pl = pm + (size_t)B * Hq * n_splits * Sq;
  float* pa = static_cast<float*>(pacc);
  const size_t smem = split_smem_bytes(D, KT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_split<KT, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_split<KT, QT><<<dim3(n_splits, Hkv, B), NT, smem, st>>>(
      qf, k, v, qp, kp, pm, pl, pa, Sq, Skv, Hq, Hkv, D, G, BQ, causal,
      window, cap, scale, n_splits, tps);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  split_combine<QT><<<dim3(Sq, Hq, B), (D + 3) / 4, 0, st>>>(
      pm, pl, pa, of, Sq, Hq, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// flash_attention_fwd with q and o of type QT.
template <class QT>
int flash_fwd(const void* q, const void* k, const void* v, const void* q_pos,
              const void* kv_pos, void* o, void* ml, void* pacc, int B,
              int Sq, int Skv, int Hq, int Hkv, int D, int kv_type,
              int causal, int window, int n_splits, float cap, float scale,
              cudaStream_t st) {
  const int G = Hq / Hkv, BQ = ROWS / G;
  const QT* qf = static_cast<const QT*>(q);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  QT* of = static_cast<QT*>(o);
  if (n_splits <= 1) {
    if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    // bf16 rows staged in 16-byte copies (2 D bytes a row, D % 8 == 0;
    // the wrapper requires 16-byte aligned k and v)
    TcArgs a{qf, qp, k, v, nullptr, nullptr, of, nullptr, nullptr,
             nullptr, B, Sq, Hq, Hkv, D, G, TROWS / G, 1, causal, window, 1,
             cap, scale};
    if (kv_type == KV_BF16)
      return launch_tc<DenseSlots, KV_BF16, QT>(a, DenseSlots{kp, Skv}, st);
    return launch_tc<DenseSlots, KV_F32, QT>(a, DenseSlots{kp, Skv}, st);
  }
  const int n_tiles = (Skv + BKV - 1) / BKV;
  if (Sq > BQ || n_splits > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_type == KV_BF16)
    return launch_split<KV_BF16, QT>(qf, k, v, qp, kp, of, ml, pacc, B, Sq,
                                     Skv, Hq, Hkv, D, G, BQ, causal, window,
                                     n_splits, cap, scale, st);
  return launch_split<KV_F32, QT>(qf, k, v, qp, kp, of, ml, pacc, B, Sq, Skv,
                                  Hq, Hkv, D, G, BQ, causal, window,
                                  n_splits, cap, scale, st);
}

}  // namespace

// kv_type: KV_F32 or KV_BF16 (k and v of that type); q_type: Q_F32 or
// Q_BF16 (q and o of that type).  window <= 0: no window; cap <= 0: no
// softcap.  n_splits <= 1 runs the tensor-core walk (attn_tc over
// DenseSlots); n_splits > 1 needs Sq <= 32 / G and runs the split walk,
// with `ml` holding 2 x B Hq n_splits Sq floats (m, then l) and `pacc` B
// Hq n_splits Sq D floats.  Returns cudaGetLastError() right after the
// launches.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, void* o, void* ml,
                                   void* pacc, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int kv_type, int q_type,
                                   int causal, int window, int n_splits,
                                   float cap, float scale, void* stream) {
  if (D % TPR != 0 || D % 4 != 0 || D > DMAX || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS || (kv_type != KV_F32 && kv_type != KV_BF16) ||
      (q_type != Q_F32 && q_type != Q_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_type == Q_BF16)
    return flash_fwd<__nv_bfloat16>(q, k, v, q_pos, kv_pos, o, ml, pacc, B,
                                    Sq, Skv, Hq, Hkv, D, kv_type, causal,
                                    window, n_splits, cap, scale, st);
  return flash_fwd<float>(q, k, v, q_pos, kv_pos, o, ml, pacc, B, Sq, Skv,
                          Hq, Hkv, D, kv_type, causal, window, n_splits, cap,
                          scale, st);
}
