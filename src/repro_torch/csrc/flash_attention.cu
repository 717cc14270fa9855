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
//    decode NS = 33: 264 blocks of 4 tiles each.  The split walk
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
// tensor-core walk (attn_tc over DenseSlots); n_splits > 1 needs Sq <= 32
// / G and runs the split walk, with `ml` holding 2 x B Hq n_splits Sq
// floats (m, then l) and `pacc` B Hq n_splits Sq D floats.  Returns
// cudaGetLastError() right after the launches.
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
    TcArgs a{qf, qp, kf, vf, nullptr, nullptr, of, nullptr, nullptr,
             nullptr, B, Sq, Hq, Hkv, D, G, TROWS / G, 1, causal, window, 0,
             cap, scale};
    return launch_tc<DenseSlots, false>(a, DenseSlots{kp, Skv}, st);
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
