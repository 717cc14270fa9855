// The GEMM shared by quant_matmul.cu (int8, BITS = 8) and packed_matmul.cu
// (int4 / int2, BITS = 4 / 2): y (M, N) = x (M, K) @ W, W = w * scale[None,
// :], with W read from its stored form.  B6 (binary_matmul.cu) has its own
// pipelined product.
//
// w is stored (ceil(K / F), N) int8 with F = 8 / BITS values of one column
// per byte, packed along K as repro/kernels/pack.py lays them out: field i
// of packed row r is K row r * F + i, lowest-order field first, two's
// complement (PackedStage::at and unpack4 below are pack.extract_fields on
// the card).  For BITS = 8 this is the plain (K, N) int8 matrix.  Fields
// past the logical K are masked here, so the caller pads nothing.
//
// Two launch shapes, one launch per call either way (and gemm_tc_mixed,
// below, one gemm_tc launch for every bucket of a PackedWeight):
//  * gemm_tc, for M > SKINNY_M (prefill, run()'s chunk steps): TF32 tensor
//    cores (mma.sync m16n8k8) at fp32 accuracy; see its section below.
//    The weight source stages the stored bytes and converts each value to
//    float as the B fragment is built: Int8Stage for K2, PackedStage for
//    K3 (int8, int4 and int2 values are all exact in TF32).  Bound by the
//    function's 2 M K N operations at the TF32 peak of 495 TFLOP/s (0.71
//    ms at 8320x2304x9216); its two passes make the route's own floor
//    twice that (1.43 ms).
//  * gemm_stream, for M <= SKINNY_M (decode, the last-token logits): bound
//    by the weight bytes; 16-byte loads, four in flight a thread, x staged
//    once in shared memory, M a template parameter, and the K splits of a
//    column tile summed inside the launch across a thread-block cluster
//    (see its section below).  Products and sums in fp32 on CUDA cores.
// Every shape applies the per-channel scale to the finished fp32
// accumulator once, where the Pallas kernels apply it, and sums in a fixed
// order: two calls give the same bits.
//
// Element types: x and y are both fp32 or both bf16 (XT), as the Pallas
// kernels take x in the model's dtype, accumulate in fp32 and write x's
// dtype.  A bf16 x is exact in fp32 and in TF32: gemm_tc stages it as
// stored and builds its fragments with the lo pass dropped (it would be
// exact zeros), gemm_stream stages it in pairs of values (cp.async moves
// at least 4 bytes); every product, sum and the scale stay fp32, and a
// bf16 y is rounded once, to nearest even, where it is written.  The fp32
// instantiations are the fp32 code as it was.
//
// Expert batching: an MoE layer's E experts contract their own (C, K)
// dispatch rows with their own weight in one launch (the reference's
// einsum "ecd,edf->ecf").  Both shapes take the expert as blockIdx.z and
// per-expert strides (Strides) for x, the stored weight, the scales and y;
// a plain GEMM is the batch of one.  The route is chosen by the per-expert
// row count M, and gemm_stream's cluster stays within one expert (cluster
// dims 1 x S x 1).  Grouped (gemm_tc_grouped): a dropless MoE's (E, C, K)
// buffer is mostly rows that no pair was routed to, so the dispatch can
// instead hand over only the routed pairs, sorted by expert, as one (P,
// K) x with each expert's first row (offsets); each block finds its
// expert and row tile from them, and computes it as gemm_tc does.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace rt {

namespace cg = cooperative_groups;

constexpr int SKINNY_M = 8;

// A finished fp32 value into y: as it is, or rounded to the nearest bf16.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Elements between consecutive experts of each operand: x (M K), the
// stored weight (ceil(K / F) N bytes), the scales (N) and y (M N) for
// contiguous (E, ...) stacks.
struct Strides {
  size_t x, w, s, y;
};

// ---------------------------------------------------------- tensor cores
// gemm_tc: y = (x @ w) * scale on TF32 tensor cores at fp32 accuracy.
//
// Numerics.  TF32 keeps 10 mantissa bits, so every int8, int4 and int2
// weight (|w| <= 127 < 2048) is exact in it and only x loses bits.  Each x value is split
// in registers at fragment load, hi = rna_tf32(x), lo = rna_tf32(x - hi),
// and two MMAs (hi, then lo, against the same weight fragment) go into one
// fp32 accumulator: x @ w to ~2^-22 of x, against ~2^-11 for one pass.
// One pass fails the reference tolerance (rtol = atol = 1e-4,
// tests/test_packed.py) at K = 9216: emulated on the CPU with x ~ N(0, 1)
// and scales as chip_smoke.py draws them, 1xTF32 ends 5.7e-4 from the
// reference at 64x9216x128 (5.3x over) and 2xTF32 1.3e-7 (fp32 sgemm:
// 1.2e-6); kernels/ref.py::quant_matmul_tf32x2_ref states the emulation.
// The MMA's own fp32 accumulation truncates (rounds toward zero) where it
// adds into its accumulator, a bias that grows with the number of adds: on
// the H100, chaining all 2 K / 8 MMAs into one accumulator ended 1.7e-4
// from the reference at K = 9216.  So each K step's 8 MMAs go into a
// zeroed step accumulator that is then added, with an ordinary
// round-to-nearest fp32 add, into the running sum (a CPU emulation,
// tests/test_torch_split_tf32.py, gives 1.5e-4 chained and 1.6e-6 so).
// The scale multiplies the finished sum once, in fp32.
//
// Design: 128 x 128 block tiles, 256 threads as 4 x 2 warps of 32 x 64
// (2 x 8 m16n8 tiles each; 64 running sums and 64 step accumulators a
// thread, so one block an SM), K steps of 32 through a 3-stage cp.async
// ring.
// x is staged as fp32 with 16-byte copies (4-byte copies with zero-fill
// where K % 4 or x's alignment forbid them), rows padded to 36 floats so
// that the fragment loads hit 32 distinct banks.  The weight is staged as
// its stored bytes (a quarter of fp32's shared memory), rows padded by 16
// bytes against bank conflicts, and each value converted to float while
// the B fragment is built: exact, no cvt to TF32 needed.  Ragged M, N and
// K are zero-filled or masked in the kernel; the caller pads nothing.
// wgmma (the asynchronous warpgroup MMA, the only way to the card's full
// tensor-core rate) waits for a later change: for TF32 it takes both
// operands K-major from shared memory, which here means staging a
// transposed weight.
constexpr int CBM = 128, CBN = 128, CBK = 32, CST = 3;  // tile, K step, ring
constexpr int CNT = 256;                                 // threads
constexpr int CAP = CBK + 4;          // staged x row stride, floats
// bf16 x rows staged as stored: 80-byte rows, so that the fragment loads
// (rows g, columns t4) fall on 16 distinct pairs of banks
constexpr int CAPB = CBK + 8;

// Staged x row stride of gemm_tc, elements of XT.
template <class XT>
__host__ __device__ constexpr int x_cap() {
  return sizeof(XT) == 4 ? CAP : CAPB;
}

// Weight source of gemm_tc: int8 (K, N) rows staged as bytes.  VEC: 16-byte
// cp.async copies (N % 16 == 0 and w 16-byte aligned), else byte loads,
// read-only global loads (__ldg) whatever the compiler can tell of w's
// address space: gemm_tc_mixed picks w from its MixedTable at run time.
template <bool VEC>
struct Int8Stage {
  static constexpr int F = 1;              // values per stored byte
  static constexpr int RS = CBN + 16;      // bytes per staged K row
  static constexpr int BYTES = CBK * RS;   // bytes per stage
  static_assert(CBK * CBN / 16 == CNT, "one 16-byte copy per thread");
  const int8_t* w;
  const float* scale;

  __device__ void stage(int8_t* dst, int k0, int n0, int K, int N,
                        int tid) const {
    if (VEC) {
      const int r = tid / (CBN / 16), c = (tid % (CBN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(dst + r * RS + c, ok ? w + (size_t)gk * N + gn : w, ok);
    } else {
      for (int i = tid; i < CBK * CBN; i += CNT) {
        const int r = i / CBN, c = i % CBN;
        const int gk = k0 + r, gn = n0 + c;
        dst[r * RS + c] = (gk < K && gn < N) ? __ldg(w + (size_t)gk * N + gn)
                                             : 0;
      }
    }
  }
  // W at (k, n) of a staged tile, as a float (exact in TF32)
  __device__ __forceinline__ float at(const int8_t* src, int k, int n) const {
    return static_cast<float>(src[k * RS + n]);
  }
  __device__ float col_scale(int n) const { return scale[n]; }
};

// Weight source of gemm_tc for K3: int4 / int2 fields packed along K, a K
// step's CBK / F packed rows staged as bytes (16 rows of int4, 8 of int2)
// and unpacked by at() where the B fragment is built.  VEC: 16-byte
// cp.async copies (N % 16 == 0 and w 16-byte aligned), else read-only byte
// loads, as Int8Stage's.
template <int BITS, bool VEC>
struct PackedStage {
  static constexpr int F = 8 / BITS;
  static constexpr int PR = CBK / F;       // packed rows per K step
  static constexpr int RS = CBN + 16;      // bytes per staged packed row
  static constexpr int BYTES = PR * RS;    // bytes per stage
  static_assert(CBK % F == 0 && PR * CBN / 16 <= CNT,
                "a K step holds whole packed rows, one copy a thread");
  const int8_t* w;
  const float* scale;

  __device__ void stage(int8_t* dst, int k0, int n0, int K, int N,
                        int tid) const {
    const int Kp = (K + F - 1) / F, r0 = k0 / F;
    if (VEC) {
      if (tid < PR * CBN / 16) {
        const int r = tid / (CBN / 16), c = (tid % (CBN / 16)) * 16;
        const int gr = r0 + r, gn = n0 + c;
        const bool ok = gr < Kp && gn < N;
        cp_async16(dst + r * RS + c, ok ? w + (size_t)gr * N + gn : w, ok);
      }
    } else {
      for (int i = tid; i < PR * CBN; i += CNT) {
        const int r = i / CBN, c = i % CBN;
        const int gr = r0 + r, gn = n0 + c;
        dst[r * RS + c] =
            (gr < Kp && gn < N) ? __ldg(w + (size_t)gr * N + gn) : 0;
      }
    }
  }
  // The last K step's packed row that holds the logical K's last field
  // (kmax = K - k0 < CBK, kmax % F != 0): its fields at or past K, e.g.
  // one int4 field at K = 1001, are set to zero in the staged tile, so that
  // they add exact zeros whatever x holds there (rows wholly past K were
  // zero-filled when staged).
  __device__ void mask_tail(int8_t* dst, int kmax, int tid) const {
    const int pr = kmax / F, keep = (1 << (BITS * (kmax % F))) - 1;
    for (int c = tid; c < CBN; c += CNT)
      dst[pr * RS + c] = static_cast<int8_t>(dst[pr * RS + c] & keep);
  }
  // Field k % F of packed row k / F at column n, as a float, exact (int4
  // and int2 are exact in TF32): the field's bits, their sign bit flipped,
  // become the low mantissa bits of 2^23, and one FMA scales and re-centres
  // them (no integer-to-float conversion).  At a fragment's k (a multiple
  // of 8 plus t4 or t4 + 4) the field index is t4 % F, so the masks are
  // the same for every value a thread loads.
  __device__ __forceinline__ float at(const int8_t* src, int k, int n) const {
    constexpr int MASK = (1 << BITS) - 1;
    const int off = BITS * (k % F);
    const int u = (static_cast<int>(src[(k / F) * RS + n]) & (MASK << off)) ^
                  ((1 << (off + BITS - 1)) | 0x4B000000);
    return fmaf(__int_as_float(u), __int_as_float((127 - off) << 23),
                -static_cast<float>((1 << (23 - off)) + (1 << (BITS - 1))));
  }
  __device__ float col_scale(int n) const { return scale[n]; }
};

// Dynamic shared memory of gemm_tc's ring: CST stages of x rows and weight
// bytes.
template <class W, class XT>
__host__ __device__ constexpr size_t tc_ring_bytes() {
  return CST * (sizeof(XT) * CBM * x_cap<XT>() + W::BYTES);
}

// Where gemm_tc_tile writes column n of its weight: into rows of `ld`
// elements of y, at column n itself (Cols) or at the policy's output
// channel col[n] (ChannelCols: one bucket of a PackedWeight, written in
// channel order by gemm_tc_mixed).
template <class XT>
struct Cols {
  XT* y;
  int ld;
  __device__ __forceinline__ XT* column(int n) const { return y + n; }
};
template <class XT>
struct ChannelCols {
  XT* y;
  int ld;
  const long long* col;
  __device__ __forceinline__ XT* column(int n) const { return y + col[n]; }
};

// One CBM x CBN tile of gemm_tc, rows m0.. and columns n0.., of an operand
// of M rows: x (M, K), the output map `out` (Cols, ChannelCols) and the
// weight source already point at the tile's expert.  The caller's whole
// block calls it, with the ring as its dynamic shared memory.  VA: x rows
// in 16-byte copies (K a multiple of 16 bytes of XT, x 16-byte aligned).
// XT: x's and y's element type (float or __nv_bfloat16).
template <class W, bool VA, class XT, class Out>
__device__ __forceinline__ void gemm_tc_tile(const XT* __restrict__ x, W w,
                                             Out out, int M, int K, int N,
                                             int m0, int n0) {
  constexpr bool XB = sizeof(XT) == 2;     // bf16 x
  constexpr int XC = x_cap<XT>();
  extern __shared__ float4 tc_smem[];
  XT* As = reinterpret_cast<XT*>(tc_smem);                     // [CST][CBM][XC]
  int8_t* Bs = reinterpret_cast<int8_t*>(As + CST * CBM * XC);   // [CST][BYTES]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;
  const int nk = (K + CBK - 1) / CBK;

  auto stage = [&](int slot, int kt) {
    const int k0 = kt * CBK;
    XT* a = As + slot * CBM * XC;
    if constexpr (XB) {
      if (VA) {
        constexpr int CPR = CBK / 8;         // 16-byte chunks per row
#pragma unroll
        for (int it = 0; it < CBM * CPR / CNT; ++it) {
          const int i = tid + it * CNT;
          const int r = i / CPR, c = (i % CPR) * 8;
          const int gm = m0 + r, gk = k0 + c;
          const bool ok = gm < M && gk < K;
          cp_async16(a + r * XC + c, ok ? x + (size_t)gm * K + gk : x, ok);
        }
      } else {                               // element by element, at once
        for (int it = 0; it < CBM * CBK / CNT; ++it) {
          const int i = tid + it * CNT;
          const int r = i / CBK, c = i % CBK;
          const int gm = m0 + r, gk = k0 + c;
          a[r * XC + c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk]
                                             : __float2bfloat16_rn(0.f);
        }
      }
    } else if (VA) {
      constexpr int CPR = CBK / 4;           // 16-byte chunks per row
#pragma unroll
      for (int it = 0; it < CBM * CPR / CNT; ++it) {
        const int i = tid + it * CNT;
        const int r = i / CPR, c = (i % CPR) * 4;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async16(a + r * CAP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < CBM * CBK / CNT; ++it) {
        const int i = tid + it * CNT;
        const int r = i / CBK, c = i % CBK;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async4(a + r * CAP + c, ok ? x + (size_t)gm * K + gk : x, ok);
      }
    }
    w.stage(Bs + slot * W::BYTES, k0, n0, K, N, tid);
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < CST - 1; ++st) {
    if (st < nk)
      stage(st, st);
    else
      cp_async_commit();                   // keep the group count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<CST - 2>();              // step kt's tiles have landed
    __syncthreads();                       // and step kt - 1's reads ended
    if constexpr (W::F > 1) {              // Int8Stage zero-fills past K
      if (K - kt * CBK < CBK && (K - kt * CBK) % W::F != 0) {
        w.mask_tail(Bs + (kt % CST) * W::BYTES, K - kt * CBK, tid);
        __syncthreads();                   // (the same for the whole block)
      }
    }
    const int pf = kt + CST - 1;
    if (pf < nk)
      stage(pf % CST, pf);
    else
      cp_async_commit();
    const XT* a = As + (kt % CST) * CBM * XC;
    const int8_t* bsm = Bs + (kt % CST) * W::BYTES;
    float part[2][8][4];                   // this K step's accumulator
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CBK; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        if constexpr (XB) {                  // exact in TF32: no lo part
          ahi[i][0] = __float_as_uint(__bfloat162float(a[r * XC + kk + t4]));
          ahi[i][1] =
              __float_as_uint(__bfloat162float(a[(r + 8) * XC + kk + t4]));
          ahi[i][2] =
              __float_as_uint(__bfloat162float(a[r * XC + kk + t4 + 4]));
          ahi[i][3] = __float_as_uint(
              __bfloat162float(a[(r + 8) * XC + kk + t4 + 4]));
        } else {
          const float v[4] = {a[r * CAP + kk + t4],
                              a[(r + 8) * CAP + kk + t4],
                              a[r * CAP + kk + t4 + 4],
                              a[(r + 8) * CAP + kk + t4 + 4]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[i][e] = tf32_rna(v[e]);
            alo[i][e] = tf32_rna(v[e] - __uint_as_float(ahi[i][e]));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = wn + j * 8 + g;
        const uint32_t b0 = __float_as_uint(w.at(bsm, kk + t4, n));
        const uint32_t b1 = __float_as_uint(w.at(bsm, kk + t4 + 4, n));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(part[i][j], ahi[i], b0, b1);
          if constexpr (!XB) mma_tf32(part[i][j], alo[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gn = n0 + wn + j * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = gn + (e & 1);
      if (n >= N) continue;
      const float sc = w.col_scale(n);
      XT* yc = out.column(n);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        if (m < M) put(yc + (size_t)m * out.ld, acc[i][j][e] * sc);
      }
    }
  }
}

// gemm_tc over E experts of M rows each: the expert is blockIdx.z.
template <class W, bool VA, class XT>
__global__ void __launch_bounds__(CNT, 1)
gemm_tc(const XT* __restrict__ x, W wsrc, XT* __restrict__ y, int M,
        int K, int N, Strides bs) {
  W w = wsrc;                              // this block's expert
  w.w += blockIdx.z * bs.w;
  w.scale += blockIdx.z * bs.s;
  gemm_tc_tile<W, VA, XT>(x + blockIdx.z * bs.x, w,
                          Cols<XT>{y + blockIdx.z * bs.y, N}, M, K, N,
                          blockIdx.y * CBM, blockIdx.x * CBN);
}

// The group and row tile of gemm_tc_grouped's block blockIdx.y, from the G
// + 1 offsets (copied into `so`, shared memory, by the whole block): group
// e is rows [a, b) of x, the tile starts at row t * CBM of the group.
// Offsets are clamped to [0, P] and each group's end to its start, so no
// offsets make a block touch a row outside x or y.  Returns false past the
// last tile (the same for the whole block).
__device__ __forceinline__ bool group_tile(const int* __restrict__ off,
                                           int* so, int G, int P, int& e,
                                           int& a, int& b, int& t) {
  for (int i = threadIdx.x; i <= G; i += CNT) so[i] = off[i];
  __syncthreads();
  t = blockIdx.y;
  for (e = 0; e < G; ++e) {
    a = min(max(so[e], 0), P);
    b = min(max(so[e + 1], a), P);
    const int tiles = (b - a + CBM - 1) / CBM;
    if (t < tiles) return true;
    t -= tiles;
  }
  return false;
}

// gemm_tc over G groups of rows of one (P, K) x, back to back: group e is
// rows [off[e], off[e + 1]) of x and of y (P, N), against expert e's
// weight (strides bs.w, bs.s).  blockIdx.y counts the groups' row tiles in
// group order, ceil(rows / CBM) a group, each tile starting at its group's
// first row, so a row sits in its tile where the (E, M, K) layout of
// gemm_tc puts it and gets the same bits.  The block copies the offsets
// into shared memory past the ring and every thread walks them to its
// tile (group_tile); a block past the last tile exits.  Rows outside every
// group are not written.
template <class W, bool VA, class XT>
__global__ void __launch_bounds__(CNT, 1)
gemm_tc_grouped(const XT* __restrict__ x, W wsrc, XT* __restrict__ y,
                const int* __restrict__ off, int G, int P, int K, int N,
                Strides bs) {
  extern __shared__ float4 tc_smem[];
  int* so = reinterpret_cast<int*>(reinterpret_cast<char*>(tc_smem) +
                                   tc_ring_bytes<W, XT>());
  int e, a, b, t;
  if (!group_tile(off, so, G, P, e, a, b, t)) return;
  W w = wsrc;
  w.w += e * bs.w;
  w.scale += e * bs.s;
  gemm_tc_tile<W, VA, XT>(x + (size_t)a * K, w,
                          Cols<XT>{y + (size_t)a * N, N}, b - a, K, N,
                          t * CBM, blockIdx.x * CBN);
}

// ------------------------------------------------- one launch per weight
// gemm_tc_mixed: y = x @ dequant(W) for a whole mixed-QBN PackedWeight in
// one launch (kernels/ops.py::packed_mixed_matmul on the tensor-core
// route), in place of one gemm_tc launch per bucket, a zero fill and a
// scatter of each bucket's columns into the policy's channel order.
//
// The grid's blockIdx.x covers the column tiles of every part of the
// weight laid end to end: each int2, int4 and int8 bucket and the pruned
// channels, in the order of the MixedTable that the host builds
// (kernels/packed_matmul.py::mixed_table).  A block finds its part by its
// first tile (tile0), then computes its tile exactly as gemm_tc does, with
// the part's own weight source: the stage id picks one of the kernel's
// template stage types S (Int8Stage<VEC>, PackedStage<4, VEC>,
// PackedStage<2, VEC>, VEC chosen per bucket as with_stage chooses it), so
// the K order, the hi / lo split, the step accumulators and the scale are
// gemm_tc's and every output value has the bits of the per-bucket launch.
// Its epilogue writes column n of the part to output channel col[n]
// (ChannelCols); a pruned part (stage 0) writes zeros to its channels.  So
// y needs no zero fill and no scatter.  One kernel serves the dense call,
// the expert stack and the grouped form: blockIdx.y walks the row tiles of
// uniform groups or, grouped, of the offsets' groups.
constexpr int MIXED_PARTS = 4;   // pruned, int2, int4, int8

// One part of a MixedTable: a bucket's stored weight (E or G experts of
// ceil(K / F) x n bytes) and scales (n a expert), its output channels
// (int64, on the card), its width, its first column tile and its stage id
// (0: pruned, zeros; i > 0: the kernel's i-th stage type).
struct MixedPart {
  const int8_t* w;
  const float* scale;
  const long long* col;
  int n, tile0, stage;
};

// The parts of one weight, passed by value as a kernel argument.
struct MixedTable {
  MixedPart p[MIXED_PARTS];
  int parts;
};

// The part that holds column tile `tile` (the last whose tile0 is at or
// below it; parts lie end to end from tile 0).
__device__ __forceinline__ MixedPart part_of(const MixedTable& t, int tile) {
  MixedPart p = t.p[0];
#pragma unroll
  for (int i = 1; i < MIXED_PARTS; ++i)
    if (i < t.parts && t.p[i].tile0 <= tile) p = t.p[i];
  return p;
}

// Zeros to rows m0.. and columns n0.. of a pruned part's tile.
template <class XT>
__device__ void zero_tile(const ChannelCols<XT>& out, int M, int N, int m0,
                          int n0) {
  for (int i = threadIdx.x; i < CBM * CBN; i += CNT) {
    const int m = m0 + i / CBN, n = n0 + i % CBN;
    if (m < M && n < N) put(out.column(n) + (size_t)m * out.ld, 0.f);
  }
}

// gemm_tc_tile with stage type number `id` (from 0) of S0, Rest...:
// expert z of part p.
template <bool VA, class XT, class S0, class... Rest>
__device__ __forceinline__ void mixed_tile(int id, const MixedPart& p,
                                           size_t z, const XT* x,
                                           const ChannelCols<XT>& out, int M,
                                           int K, int m0, int n0) {
  if (id == 0) {
    const size_t rows = (K + S0::F - 1) / S0::F;
    gemm_tc_tile<S0, VA, XT>(x, S0{p.w + z * rows * p.n, p.scale + z * p.n},
                             out, M, K, p.n, m0, n0);
  } else if constexpr (sizeof...(Rest) > 0) {
    mixed_tile<VA, XT, Rest...>(id - 1, p, z, x, out, M, K, m0, n0);
  }
}

// Dynamic shared memory of gemm_tc_mixed's ring: the largest stage's.
template <class XT, class... S>
__host__ __device__ constexpr size_t mixed_ring_bytes() {
  size_t most = 0;
  ((most = tc_ring_bytes<S, XT>() > most ? tc_ring_bytes<S, XT>() : most),
   ...);
  return most;
}

// G groups of rows of x and of y (.., ld) back to back, against expert e
// of every part for group e, its row tiles in blockIdx.y.  off null: each
// group M rows (x (G M, K): an expert stack, or one GEMM for G = 1), group
// e's tile t at blockIdx.y = e tiles + t.  Else the groups of the P = M
// rows by the G + 1 offsets, walked as gemm_tc_grouped walks them
// (group_tile); rows outside every group are not written.  Either way a
// row sits in its tile where the (G, M, K) layout of gemm_tc puts it.
template <bool VA, class XT, class... S>
__global__ void __launch_bounds__(CNT, 1)
gemm_tc_mixed(const XT* __restrict__ x, const MixedTable tab,
              XT* __restrict__ y, const int* __restrict__ off, int G, int M,
              int K, int ld) {
  int e, a, b, t;
  if (off == nullptr) {
    const int tiles = (M + CBM - 1) / CBM;
    e = blockIdx.y / tiles;
    t = blockIdx.y - e * tiles;
    a = e * M;
    b = a + M;
  } else {
    extern __shared__ float4 tc_smem[];
    int* so = reinterpret_cast<int*>(reinterpret_cast<char*>(tc_smem) +
                                     mixed_ring_bytes<XT, S...>());
    if (!group_tile(off, so, G, M, e, a, b, t)) return;
  }
  const MixedPart p = part_of(tab, blockIdx.x);
  const ChannelCols<XT> out{y + (size_t)a * ld, ld, p.col};
  const int n0 = (blockIdx.x - p.tile0) * CBN;
  if (p.stage == 0)
    zero_tile(out, b - a, p.n, t * CBM, n0);
  else
    mixed_tile<VA, XT, S...>(p.stage - 1, p, e, x + (size_t)a * K, out,
                             b - a, K, t * CBM, n0);
}

// The kernel `kern` with `smem` bytes of dynamic shared memory on a grid
// on `stream`; returns the first CUDA error of the setup or the launch.
template <class Kern, class... Args>
int launch_with_smem(Kern kern, size_t smem, dim3 grid, cudaStream_t stream,
                     Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, CNT, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// x rows in 16-byte copies: K a multiple of 16 bytes of XT, x 16-byte
// aligned (gemm_tc's VA)
template <class XT>
bool x_vec(const XT* x, int K) {
  return (K * sizeof(XT)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Launch gemm_tc over weight source `w` for E experts on `stream`;
// returns the first CUDA error of the setup or the launch.
template <class W, class XT>
int launch_tc(const XT* x, const W& w, XT* y, int E, int M, int K, int N,
              const Strides& bs, cudaStream_t stream) {
  auto kern = x_vec(x, K) ? gemm_tc<W, true, XT> : gemm_tc<W, false, XT>;
  dim3 grid((N + CBN - 1) / CBN, (M + CBM - 1) / CBM, E);
  return launch_with_smem(kern, tc_ring_bytes<W, XT>(), grid, stream, x, w,
                          y, M, K, N, bs);
}

// Launch gemm_tc_grouped over weight source `w` for G groups of the P rows
// of x on `stream`: ceil(P / CBM) + G row tiles bound the groups' tiles
// (each group wastes less than one).  Returns the first CUDA error of the
// setup or the launch.
template <class W, class XT>
int launch_tc_grouped(const XT* x, const W& w, XT* y, const int* off, int G,
                      int P, int K, int N, const Strides& bs,
                      cudaStream_t stream) {
  const long tiles = (P + CBM - 1) / CBM + (long)G;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = x_vec(x, K) ? gemm_tc_grouped<W, true, XT>
                          : gemm_tc_grouped<W, false, XT>;
  dim3 grid((N + CBN - 1) / CBN, (unsigned)tiles, 1);
  return launch_with_smem(kern, tc_ring_bytes<W, XT>() + sizeof(int) * (G + 1),
                          grid, stream, x, w, y, off, G, P, K, N, bs);
}

// Calls f(source) with gemm_tc's weight source of BITS-wide values (K2's
// Int8Stage, K3's PackedStage), 16-byte copies where N and w's alignment
// allow them; returns what f returns.
template <int BITS, class F>
int with_stage(const int8_t* w, const float* scale, int N, F&& f) {
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if constexpr (BITS == 8) {
    if (vec) return f(Int8Stage<true>{w, scale});
    return f(Int8Stage<false>{w, scale});
  } else {
    if (vec) return f(PackedStage<BITS, true>{w, scale});
    return f(PackedStage<BITS, false>{w, scale});
  }
}

// The stage types of gemm_tc_mixed: stage id i > 0 is the (i - 1)-th, in
// the order of kernels/packed_matmul.py::MIXED_STAGES.
template <class... S>
struct StageList {
  static constexpr int size = sizeof...(S);
};
using MixedStages =
    StageList<Int8Stage<true>, Int8Stage<false>, PackedStage<4, true>,
              PackedStage<4, false>, PackedStage<2, true>,
              PackedStage<2, false>>;

// Launch gemm_tc_mixed over `tiles` column tiles on `stream`: off null,
// E experts of M rows; else the G + 1 = E + 1 offsets of the P = M rows.
// Returns the first CUDA error of the setup or the launch.
template <class XT, class... S>
int launch_mixed(StageList<S...>, const XT* x, const MixedTable& tab,
                 int tiles, XT* y, const int* off, int E, int M, int K,
                 int ld, cudaStream_t stream) {
  const long m_tiles = (M + CBM - 1) / CBM;
  const long row_tiles = off ? m_tiles + E : m_tiles * E;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = x_vec(x, K) ? gemm_tc_mixed<true, XT, S...>
                          : gemm_tc_mixed<false, XT, S...>;
  const size_t smem =
      mixed_ring_bytes<XT, S...>() + (off ? sizeof(int) * (E + 1) : 0);
  return launch_with_smem(kern, smem, dim3(tiles, (unsigned)row_tiles, 1),
                          stream, x, tab, y, off, E, M, K, ld);
}

// One gemm_tc_mixed launch for a whole PackedWeight of N output channels:
// `parts` (n_parts of them) as the host's MixedTable lays them out, checked
// here: tiles end to end from 0, widths summing to N, stage ids in range.
// x (E, M, K) and y (E, M, N), or grouped (off non-null, G = E groups): x
// (P, K) and y (P, N) with P = M.  Returns the first CUDA error of the
// setup or the launch.
template <class XT>
int launch_gemm_mixed(const XT* x, const MixedPart* parts, int n_parts,
                      XT* y, const int* off, int E, int M, int K, int N,
                      cudaStream_t stream) {
  constexpr int STAGES = MixedStages::size;
  if (n_parts < 1 || n_parts > MIXED_PARTS || E < 1 || M < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MixedTable tab{};
  int tiles = 0, cols = 0;
  for (int i = 0; i < n_parts; ++i) {
    const MixedPart& p = parts[i];
    if (p.n < 1 || p.tile0 != tiles || p.stage < 0 || p.stage > STAGES ||
        p.col == nullptr ||
        (p.stage > 0 && (p.w == nullptr || p.scale == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    tab.p[i] = p;
    tiles += (p.n + CBN - 1) / CBN;
    cols += p.n;
  }
  tab.parts = n_parts;
  if (cols != N) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mixed(MixedStages{}, x, tab, tiles, y, off, E, M, K, N,
                      stream);
}

// --------------------------------------------------------------- skinny
// gemm_stream: y = (x @ W) * scale for M <= SKINNY_M rows, in one launch
// that streams W from device memory once.
//
// Bound: the weight bytes (Kp x N, Kp = ceil(K / F) packed rows) at the
// card's 3.35 TB/s; x and y are a few KB.  Keeping HBM busy takes ~20-30
// KB of loads in flight per SM (bandwidth x ~1 us latency / 132 SMs).
// Design:
//  * A block of 256 threads owns 128 columns: 8 column lanes of 16 columns
//    by 32 row lanes.  A thread reads 16 columns of a packed row per load
//    (one 16-byte ld.global.nc where N % 16 == 0 and w is 16-byte aligned;
//    4-byte loads where N % 4 == 0; bytes otherwise), so a warp reads four
//    whole 128-byte rows per instruction.
//  * The block walks its packed rows in chunks of 128 (4 rows a row lane):
//    the loads of chunk c + 1 are issued into registers before chunk c is
//    computed, so each thread keeps 4 loads (64 bytes) in flight, ~32 KB
//    an SM at two blocks an SM.
//  * x is staged in shared memory once per chunk (cp.async into a
//    two-slot ring, laid out [k][m] so that a packed row's F x M values are
//    one vector read, a broadcast across the 8 column lanes), zero-filled
//    for rows m >= M and for fields at or past K, so the fields past K of
//    the last packed row add exact zeros whatever they hold.  A bf16 x is
//    staged as it is stored, in 4-byte pairs of consecutive k laid out
//    [k / 2][m] (load_xb picks a pair's half), from the even k at or
//    below the chunk's first; the wrapper requires an even K and a 4-byte
//    aligned x.
//  * M is a template parameter (1, 2, 4, 8; the wrapper's M rounded up):
//    the accumulators (M x 16 a thread) and the reduction storage are
//    sized by it.
//  * Each stored value becomes an exact float without an integer-to-float
//    conversion: its field, sign bit flipped, is byte-permuted into the
//    mantissa of 2^23 and one add re-centres it (unpack4).  Products and
//    sums in fp32 on CUDA cores: at M = 2 a byte costs ~4 instructions
//    against ~14 bytes an SM and cycle at full bandwidth, inside the issue
//    rate for int8 and int4.
//  * Split K in one launch: when the columns alone give too few blocks,
//    the packed rows are cut into S <= 8 runs (kernels/quant_matmul.py::
//    skinny_splits, from shapes alone; skinny_cut states the cut) and the
//    S blocks of a column tile form one thread-block cluster.  Each block
//    sums its rows, its row lanes (two shuffles) and its warps (in warp
//    order) into shared memory; rank 0 then adds the S blocks' sums from
//    distributed shared memory in rank order, multiplies by the scale and
//    writes y.  No atomics and no partials in device memory: every sum runs
//    in a fixed order, so two calls give the same bits.
constexpr int SNT = 256;             // threads a block
constexpr int SCL = 8;               // column lanes, 16 columns each
constexpr int SCOLS = 16 * SCL;      // columns a block
constexpr int SRL = SNT / SCL;       // row lanes
constexpr int SU = 4;                // packed rows a row lane takes a chunk
constexpr int SXR = SRL * SU;        // packed rows a chunk
constexpr int SMAX_SPLIT = 8;        // blocks a cluster (the portable limit)

// The F fields of each of the 4 bytes of `wd` (4 columns of one packed
// row) as exact floats: v[f][c] is field f (K row r * F + f) of column c.
template <int BITS>
__device__ __forceinline__ void unpack4(uint32_t wd,
                                        float (&v)[8 / BITS][4]) {
  constexpr int F = 8 / BITS;
  constexpr uint32_t MASK = ((1u << BITS) - 1) * 0x01010101u;
  constexpr uint32_t SIGN = (1u << (BITS - 1)) * 0x01010101u;
  constexpr float OFF = 8388608.f + (1 << (BITS - 1));   // 2^23 + bias
#pragma unroll
  for (int f = 0; f < F; ++f) {
    // each byte now holds its field plus 2^(BITS-1), in 0 .. 2^BITS - 1
    const uint32_t u = ((wd >> (BITS * f)) & MASK) ^ SIGN;
#pragma unroll
    for (int c = 0; c < 4; ++c)    // 0x4B0000uu is the float 2^23 + uu
      v[f][c] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | c)) -
                OFF;
  }
}

// 16 bytes (columns n0 .. n0 + 15) of one packed row, zeros where `ok` is
// false or past N, read VW bytes at a time.
template <int VW>
__device__ __forceinline__ void load16(const int8_t* row, bool ok, int n0,
                                       int N, uint32_t (&wd)[4]) {
  if (VW == 16) {
    int4 v = make_int4(0, 0, 0, 0);
    if (ok && n0 < N) v = __ldg(reinterpret_cast<const int4*>(row + n0));
    wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
  } else if (VW == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wd[q] = (ok && n0 + 4 * q < N)
                  ? __ldg(reinterpret_cast<const unsigned*>(row + n0 + 4 * q))
                  : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + 4 * q + c;
        if (ok && n < N)
          b |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + n)))
               << (8 * c);
      }
      wd[q] = b;
    }
  }
}

// M values of a bf16 x at one K row k, staged [k / 2][m] as pairs of
// consecutive k: p points at the row's M pairs, `half` is k % 2.
template <int M>
__device__ __forceinline__ void load_xb(const uint32_t* p, int half,
                                        float (&xv)[M]) {
  uint32_t w[M];
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int m = 0; m < M; m += 4) {
      const uint4 t = *reinterpret_cast<const uint4*>(p + m);
      w[m] = t.x; w[m + 1] = t.y; w[m + 2] = t.z; w[m + 3] = t.w;
    }
  } else if constexpr (M == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x; w[1] = t.y;
  } else {
    w[0] = p[0];
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    xv[m] = __uint_as_float(half ? (w[m] & 0xffff0000u) : (w[m] << 16));
}

// M values of x at one K row, staged [k][m]
template <int M>
__device__ __forceinline__ void load_x(const float* p, float (&xv)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int m = 0; m < M; m += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + m);
      xv[m] = t.x; xv[m + 1] = t.y; xv[m + 2] = t.z; xv[m + 3] = t.w;
    }
  } else if constexpr (M == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    xv[0] = t.x; xv[1] = t.y;
  } else {
    xv[0] = p[0];
  }
}

// bf16 x pairs a ring slot holds for each row m: a chunk's SXR F values
// and one more, for a chunk that starts at an odd k.
template <int BITS>
__host__ __device__ constexpr int x_pairs() {
  return SXR * (8 / BITS) / 2 + 1;
}

// Dynamic shared memory of gemm_stream: the x ring (2 x SXR F x M floats,
// or 2 x x_pairs x M pairs of bf16), reused after the walk for the warps'
// sums (8 x M x SCOLS floats).
template <int BITS, int M, class XT>
constexpr size_t stream_smem_bytes() {
  constexpr size_t ring = sizeof(XT) == 4
                              ? sizeof(float) * 2 * SXR * (8 / BITS) * M
                              : sizeof(uint32_t) * 2 * x_pairs<BITS>() * M;
  constexpr size_t red = sizeof(float) * (SNT / 32) * M * SCOLS;
  return ring > red ? ring : red;
}

// One block per (column tile, K split, expert); the S = gridDim.y splits
// of a column tile form one cluster, within one expert (blockIdx.z).  Two
// blocks an SM (128 registers) except at M = 8 and for byte loads (VW =
// 1), which would spill there.  Mr: x's real rows (<= M); per: packed rows
// a split (the last split's run is cut at Kp).  XT: x's and y's
// element type.
template <int BITS, int M, int VW, class XT>
__global__ void __launch_bounds__(SNT, M <= 4 && VW > 1 ? 2 : 1)
gemm_stream(const XT* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, XT* __restrict__ y, int Mr,
            int K, int N, int per, Strides bs) {
  constexpr int F = 8 / BITS;
  constexpr int XK = SXR * F;               // K rows of x a chunk
  constexpr bool XB = sizeof(XT) == 2;      // bf16 x
  constexpr int XP = x_pairs<BITS>();
  x += blockIdx.z * bs.x;                   // this block's expert
  w += blockIdx.z * bs.w;
  scale += blockIdx.z * bs.s;
  y += blockIdx.z * bs.y;
  extern __shared__ float4 stream_smem[];
  float* xs = reinterpret_cast<float*>(stream_smem);   // [2][XK][M]
  uint32_t* xw = reinterpret_cast<uint32_t*>(stream_smem);  // bf16 [2][XP][M]
  __shared__ float bsum[M * SCOLS];         // the block's sums, [m][col]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cl = lane % SCL;                           // column lane
  const int rl = warp * (32 / SCL) + lane / SCL;       // row lane
  const int n0 = blockIdx.x * SCOLS + cl * 16;
  const int Kp = (K + F - 1) / F;
  const int rb = blockIdx.y * per, re = min(Kp, rb + per);
  const int nch = re > rb ? (re - rb + SXR - 1) / SXR : 0;
  // bf16: a chunk's first k (rb + c SXR) F is odd when rb F is: its pairs
  // then start one k lower
  const int xoff = (rb * F) & 1;

  // x at K rows (rb + c SXR) F .. + XK into ring slot c % 2, zero past the
  // split's rows, past K and for rows m >= Mr
  auto stage_x = [&](int c) {
    const int k0 = (rb + c * SXR) * F, kend = min(K, re * F);
    if constexpr (XB) {
      const int k0a = k0 - xoff;
      uint32_t* dst = xw + (c & 1) * XP * M;
      for (int i = tid; i < XP * M; i += SNT) {
        const int gk = k0a + 2 * (i / M), m = i % M;
        const int n = m < Mr && gk < kend ? (gk + 1 < kend ? 4 : 2) : 0;
        rt::cp_async4n(dst + i, n ? x + (size_t)m * K + gk : x, n);
      }
    } else {
      float* dst = xs + (c & 1) * XK * M;
      for (int i = tid; i < XK * M; i += SNT) {
        const int gk = k0 + i / M, m = i % M;
        const bool ok = m < Mr && gk < kend;
        rt::cp_async4(dst + i, ok ? x + (size_t)m * K + gk : x, ok);
      }
    }
    rt::cp_async_commit();
  };
  auto load_w = [&](int c, uint32_t (&wd)[SU][4]) {
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int r = rb + c * SXR + u * SRL + rl;
      load16<VW>(w + (size_t)min(r, Kp - 1) * N, r < re, n0, N, wd[u]);
    }
  };

  float acc[M][16];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
  uint32_t wc[SU][4], wn[SU][4];
  if (nch > 0) {
    load_w(0, wc);
    stage_x(0);
  }
  for (int c = 0; c < nch; ++c) {
    rt::cp_async_wait<0>();
    __syncthreads();      // chunk c's x has landed; chunk c - 1 is done
    if (c + 1 < nch) {
      load_w(c + 1, wn);
      stage_x(c + 1);
    }
    const float* xb = xs + (c & 1) * XK * M;
    const uint32_t* xbw = xw + (c & 1) * XP * M;
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const float* xr = xb + (u * SRL + rl) * F * M;
      const int kr = (u * SRL + rl) * F + xoff;   // bf16: the row's k - k0a
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[F][4];
        unpack4<BITS>(wc[u][q], v);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float xv[M];
          if constexpr (XB)
            load_xb<M>(xbw + ((kr + f) >> 1) * M, (kr + f) & 1, xv);
          else
            load_x<M>(xr + f * M, xv);
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][4 * q + e] = fmaf(xv[m], v[f][e], acc[m][4 * q + e]);
        }
      }
    }
    if (c + 1 < nch) {
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) wc[u][q] = wn[u][q];
    }
  }

  // the warp's 4 row lanes (lanes cl, cl + 8, cl + 16, cl + 24): every
  // lane ends with the same bits, (a + b) + (c + d) in either order
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 8);
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    }
  __syncthreads();                          // the ring is free: reuse it
  float* red = xs;                          // [warp][m][col]
  if (lane < SCL) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(red + (warp * M + m) * SCOLS + cl * 16 +
                                   j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                        acc[m][j + 3]);
  }
  __syncthreads();
  for (int i = tid; i < M * SCOLS; i += SNT) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < SNT / 32; ++q) s += red[q * M * SCOLS + i];
    bsum[i] = s;
  }
  // rank 0 of the cluster adds the splits' sums in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int S = gridDim.y;                // the cluster's blocks
    for (int i = tid; i < M * SCOLS; i += SNT) {
      const int m = i / SCOLS, n = blockIdx.x * SCOLS + i % SCOLS;
      if (m >= Mr || n >= N) continue;
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += cluster.map_shared_rank(bsum, r)[i];
      put(y + (size_t)m * N + n, s * scale[n]);
    }
  }
  cluster.sync();                           // peers stay until rank 0 read
}

template <int BITS, int M, int VW, class XT>
int launch_stream(const XT* x, const int8_t* w, const float* scale, XT* y,
                  int E, int Mr, int K, int N, int splits,
                  const Strides& bs, cudaStream_t stream) {
  constexpr int F = 8 / BITS;
  const int Kp = (K + F - 1) / F;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + SCOLS - 1) / SCOLS, splits, E);
  cfg.blockDim = dim3(SNT, 1, 1);
  cfg.dynamicSmemBytes = stream_smem_bytes<BITS, M, XT>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, gemm_stream<BITS, M, VW, XT>, x, w, scale,
                         y, Mr, K, N, (Kp + splits - 1) / splits, bs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// gemm_stream at M rounded up to 1, 2, 4 or 8, loads as wide as N and w's
// alignment allow
template <int BITS, int M, class XT>
int launch_stream_m(const XT* x, const int8_t* w, const float* scale, XT* y,
                    int E, int Mr, int K, int N, int splits,
                    const Strides& bs, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w);
  if (N % 16 == 0 && a % 16 == 0)
    return launch_stream<BITS, M, 16>(x, w, scale, y, E, Mr, K, N, splits,
                                      bs, stream);
  if (N % 4 == 0 && a % 4 == 0)
    return launch_stream<BITS, M, 4>(x, w, scale, y, E, Mr, K, N, splits,
                                     bs, stream);
  return launch_stream<BITS, M, 1>(x, w, scale, y, E, Mr, K, N, splits, bs,
                                   stream);
}

// One launch on `stream` for E experts of M rows each (contiguous (E, M,
// K) x, (E, ceil(K / F), N) w, (E, N) scales, (E, M, N) y; E = 1 for a
// plain GEMM): gemm_tc for M > SKINNY_M, else gemm_stream with `splits` K
// splits (1 .. SMAX_SPLIT); returns the first CUDA error of the setup or
// the launch.  XT: x's and y's element type; a bf16 x on
// gemm_stream needs an even K and a 4-byte aligned x.
template <int BITS, class XT>
int launch_gemm(const XT* x, const int8_t* w, const float* scale, XT* y,
                int E, int M, int K, int N, int splits,
                cudaStream_t stream) {
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (sizeof(XT) == 2 && M <= SKINNY_M &&
      (K % 2 != 0 || reinterpret_cast<uintptr_t>(x) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int F = 8 / BITS;
  const Strides bs{(size_t)M * K, (size_t)((K + F - 1) / F) * N, (size_t)N,
                   (size_t)M * N};
  if (M > SKINNY_M)
    return with_stage<BITS>(w, scale, N, [&](const auto& ws) {
      return launch_tc(x, ws, y, E, M, K, N, bs, stream);
    });
  if (splits < 1 || splits > SMAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 1)
    return launch_stream_m<BITS, 1>(x, w, scale, y, E, M, K, N, splits, bs,
                                    stream);
  if (M <= 2)
    return launch_stream_m<BITS, 2>(x, w, scale, y, E, M, K, N, splits, bs,
                                    stream);
  if (M <= 4)
    return launch_stream_m<BITS, 4>(x, w, scale, y, E, M, K, N, splits, bs,
                                    stream);
  return launch_stream_m<BITS, 8>(x, w, scale, y, E, M, K, N, splits, bs,
                                  stream);
}

// One gemm_tc_grouped launch on `stream` for G groups of the P rows of x
// (P, K), group e being rows [off[e], off[e + 1]) against expert e of the
// (G, ceil(K / F), N) w and (G, N) scales, into y (P, N); `off` is G + 1
// int32 on the card.  The tensor-core route whatever a group's rows: the
// caller groups rows where the (E, M, K) layout's M is above SKINNY_M.
// Returns the first CUDA error of the setup or the launch.
template <int BITS, class XT>
int launch_gemm_grouped(const XT* x, const int8_t* w, const float* scale,
                        XT* y, const int* off, int G, int P, int K, int N,
                        cudaStream_t stream) {
  if (G < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int F = 8 / BITS;
  const Strides bs{0, (size_t)((K + F - 1) / F) * N, (size_t)N, 0};
  return with_stage<BITS>(w, scale, N, [&](const auto& ws) {
    return launch_tc_grouped(x, ws, y, off, G, P, K, N, bs, stream);
  });
}

}  // namespace rt
