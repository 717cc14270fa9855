"""Plain PyTorch versions of the GEMM and fake-quant kernels (port of
``repro/kernels/ref.py``), and plain statements of what the card's
kernels compute where their arithmetic differs from the reference's: the
split-KV decode walks of K1 (:func:`attention_split_ref`) and K4
(:func:`paged_attention_split_ref`), K1's three-pass TF32 prefill walk
(:func:`attention_tf32x3_ref`), and the two-pass TF32 product of K2 and
K3 (:func:`quant_matmul_tf32x2_ref`, on K3's unpacked weight).

The wrappers in ``quant_matmul.py`` / ``packed_matmul.py`` /
``binary_matmul.py`` / ``fake_quant.py`` run these for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.  The
GEMM versions scale the weight *before* the dot, as the reference oracle
does, while the kernels scale the finished accumulator (or fold the sign
planes into one weight), so the two agree to allclose and not bit for bit
(ROADMAP.md section C).  :func:`fake_quant_ref` and its kernel agree bit
for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.pack import unpack_sub8
from repro_torch.quant.linear_quant import FULL_BITS


def quant_matmul_ref(x: torch.Tensor, qw: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x: (M, K) f32; qw: (K, N) int8; scale: (N,) f32 per out channel."""
    w = qw.to(torch.float32) * scale[None, :].to(torch.float32)
    return (x.to(torch.float32) @ w).to(x.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds; returned as f32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def quant_matmul_tf32x2_ref(x: torch.Tensor, qw: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """K2's and K3's numerics on the tensor cores (csrc/gemm_tiles.cuh:
    gemm_tc): x split into ``hi = tf32_rna(x)`` and ``lo = tf32_rna(x -
    hi)``, each part times the integer weight (int8, or K3's unpacked int4
    / int2: exact in TF32, and the products fit f32), sums in f32, then
    the per-channel scale.  Tests only; no card path runs it."""
    xf, w = x.to(torch.float32), qw.to(torch.float32)
    hi = tf32_rna(xf)
    return (hi @ w + tf32_rna(xf - hi) @ w) * scale[None, :].to(torch.float32)


def packed_matmul_ref(x: torch.Tensor, pw: torch.Tensor, scale: torch.Tensor,
                      store_bits: int) -> torch.Tensor:
    """Unpack (kernels.pack format) then :func:`quant_matmul_ref`.
    x: (M, K); pw: (ceil(K/f), N) int8 packed along K; scale: (N,) f32."""
    q = unpack_sub8(pw, store_bits, k=x.shape[1], axis=0)
    return quant_matmul_ref(x, q, scale)


def binary_matmul_ref(x: torch.Tensor, planes: torch.Tensor,
                      alpha: torch.Tensor) -> torch.Tensor:
    """Bit-plane matmul: y = sum_p alpha_p * (x @ B_p).
    x: (M, K); planes: (P, K, N) int8 in {-1, +1}; alpha: (P, N) f32."""
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], planes.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for p in range(planes.shape[0]):
        acc = acc + (xf @ planes[p].to(torch.float32)) * \
            alpha[p][None, :].to(torch.float32)
    return acc.to(x.dtype)


def fake_quant_ref(x: torch.Tensor, scale: torch.Tensor,
                   levels: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-channel quantize-dequantize with precomputed scales.
    x: (M, N); scale, levels, bits: (N,).  bits <= 0.5 prunes; bits >=
    quant.linear_quant.FULL_BITS passes through."""
    xf = x.to(torch.float32)
    s = scale[None, :].to(torch.float32)
    lv = levels[None, :].to(torch.float32)
    b = bits[None, :].to(torch.float32)
    q = torch.clamp(torch.round(xf / s), -lv, lv) * s
    out = torch.where(b <= 0.5, torch.zeros_like(q),
                      torch.where(b >= FULL_BITS, xf, q))
    return out.to(x.dtype)


def _split_walk(qf, k, v, q_pos, kv_pos, runs, *, window, attn_cap,
                causal, mm=torch.einsum):
    """Each split's online softmax over its slot run ``[a, b)``, 32 slots a
    tile, by the reference's update rule, then the merge in split order:
    m = max_s m_s, e_s = exp(m_s - m_safe), o = sum_s e_s acc_s /
    max(sum_s e_s l_s, 1e-30).  qf: (B, Sq, Hkv, G, D) pre-scaled f32;
    k, v: (B, S, Hkv, D) f32; returns (B, Sq, Hkv, G, D).  ``mm`` computes
    the two products of a tile (an einsum, or :func:`einsum_tf32x3`).  A
    tile's P V is a fresh sum added to the rescaled accumulator."""
    from repro_torch.kernels.attention import BKV
    from repro_torch.models.layers import NEG_INF, _mask_scores, softcap
    B, Sq, Hkv, G, D = qf.shape
    parts = []
    for a, b in runs:
        m = torch.full((B, Hkv, G, Sq), NEG_INF, device=qf.device)
        l = torch.zeros((B, Hkv, G, Sq), device=qf.device)
        acc = torch.zeros((B, Sq, Hkv, G, D), device=qf.device)
        for t0 in range(a, b, BKV):
            sl = slice(t0, min(t0 + BKV, b))
            s = mm("bqhgd,bkhd->bhgqk", qf, k[:, sl])
            s = _mask_scores(softcap(s, attn_cap), q_pos, kv_pos[:, sl],
                             causal=causal, window=window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                torch.zeros_like(m))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + mm(
                "bhgqk,bkhd->bqhgd", p, v[:, sl])
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    l = torch.zeros_like(m)
    o = torch.zeros_like(parts[0][2])
    for m_s, l_s, acc_s in parts:
        e = torch.exp(m_s - m_safe)
        l = l + e * l_s
        o = o + e.permute(0, 3, 1, 2)[..., None] * acc_s
    return o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]


def attention_split_ref(q, k, v, *, q_pos, kv_pos, window=None,
                        attn_cap=None, n_splits=1, causal=True):
    """What K1's split walk and its merge compute
    (csrc/flash_attention.cu: flash_split, split_combine): the KV tiles of
    32 rows are cut into ``n_splits`` runs (``attention.split_tiles``);
    each run keeps its own online softmax over its tiles, by the
    reference's update rule; then the runs are merged in order
    (:func:`_split_walk`).  Layouts as ``layers.attention_ref``.  Tests and
    ``chip_smoke.py`` hold the kernel to it; no card path runs it."""
    from repro_torch.kernels.attention import BKV, split_tiles
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(D))).reshape(
        B, Sq, Hkv, Hq // Hkv, D)
    runs = [(t0 * BKV, min(Skv, t1 * BKV))
            for t0, t1 in split_tiles(Skv, n_splits)]
    o = _split_walk(qf, k.to(torch.float32), v.to(torch.float32), q_pos,
                    kv_pos, runs, window=window, attn_cap=attn_cap,
                    causal=causal)
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def einsum_tf32x3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` in three TF32 passes, as the tensor cores
    compute it with both operands split: ``hi = tf32_rna(v)``,
    ``lo = tf32_rna(v - hi)``, then ``hi.hi + hi.lo + lo.hi`` (each
    product of two TF32 values is exact in f32; lo.lo, ~2^-22 of the
    product, is dropped)."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)) + \
        torch.einsum(eq, al, bh)


def attention_tf32x3_ref(q, k, v, *, q_pos, kv_pos, window=None,
                         attn_cap=None, causal=True):
    """What K1's tensor-core prefill walk computes
    (csrc/flash_attention.cu: flash_tc): the reference's online softmax
    over KV tiles of 32 rows, with both products of a tile in three TF32
    passes (:func:`einsum_tf32x3`): the scores ``S = q k^T`` on the
    pre-scaled q, then the softcap and the mask on the f32 scores, and
    ``P V`` with P and V both split, a fresh sum added (round to nearest)
    to the rescaled running output.  Layouts as ``layers.attention_ref``.
    Tests and ``chip_smoke.py`` hold the kernel to it; no card path runs
    it."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(D))).reshape(
        B, Sq, Hkv, Hq // Hkv, D)
    o = _split_walk(qf, k.to(torch.float32), v.to(torch.float32), q_pos,
                    kv_pos, [(0, Skv)], window=window, attn_cap=attn_cap,
                    causal=causal, mm=einsum_tf32x3)
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def paged_live_slots(q_pos_row, window, ps: int, nb: int):
    """The logical slots ``[s_begin, s_end)`` that K4 walks for one row
    (``csrc/paged_attention.cu``): from the page of the window's oldest
    position for the row's lowest real position to the end of the page of
    its highest; (0, 0) for an idle lane (no real position)."""
    from repro_torch.kernels.attention import POS_SENTINEL
    real = [int(p) for p in q_pos_row if int(p) != POS_SENTINEL]
    if not real:
        return 0, 0
    lo, hi = min(real), max(real)
    first = max(0, lo - (window - 1)) // ps if window else 0
    first = min(first, nb - 1)
    return first * ps, min(nb, hi // ps + 1) * ps


def paged_split_slots(s_begin: int, s_end: int, n_splits: int):
    """The slot runs ``[a, b)`` of each split of one row, as the kernel cuts
    them: the row's range in 32-slot tiles from ``s_begin``,
    ``ceil(tiles / n_splits)`` tiles a split; later splits may be empty
    (a == b)."""
    from repro_torch.kernels.attention import BKV
    n_t = -(-(s_end - s_begin) // BKV)
    per = -(-n_t // n_splits)
    return [(min(s_end, s_begin + s * per * BKV),
             min(s_end, s_begin + (s + 1) * per * BKV))
            for s in range(n_splits)]


def paged_attention_split_ref(q, k_pages, v_pages, pos_pages, block_tables,
                              *, q_pos, window=None, attn_cap=None,
                              k_scale_pages=None, v_scale_pages=None,
                              n_splits=1):
    """What K4's split walk and its merge compute
    (csrc/paged_attention.cu: paged_split, paged_combine): each row's live
    logical slots (:func:`paged_live_slots`: from the window's first
    page for its lowest real position to the page of its highest) are cut
    into ``n_splits`` runs of whole 32-slot tiles
    (:func:`paged_split_slots`), each run keeps its own online
    softmax, and the runs are merged in order (:func:`_split_walk`).  int8
    pools are dequantized element by element (one f32 product).  An idle
    lane walks nothing and comes out as exact zeros.  Layouts as
    ``layers.paged_attention_ref``.  Tests and ``chip_smoke.py`` hold the
    kernel to it; no card path runs it."""
    from repro_torch.models.layers import paged_gather
    B, kq, Hq, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    k = paged_gather(k_pages, block_tables).to(torch.float32)
    v = paged_gather(v_pages, block_tables).to(torch.float32)
    if k_scale_pages is not None:
        k = k * paged_gather(k_scale_pages, block_tables)[..., None]
        v = v * paged_gather(v_scale_pages, block_tables)[..., None]
    kv_pos = paged_gather(pos_pages, block_tables)
    q_pos = q_pos.reshape(B, kq)
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(D))).reshape(
        B, kq, Hkv, Hq // Hkv, D)
    rows = []
    for b in range(B):
        s0, s1 = paged_live_slots(q_pos[b].tolist(), window, ps, nb)
        r = slice(b, b + 1)
        rows.append(_split_walk(
            qf[r], k[r], v[r], q_pos[r], kv_pos[r],
            paged_split_slots(s0, s1, n_splits), window=window,
            attn_cap=attn_cap, causal=True))
    return torch.cat(rows).reshape(B, kq, Hq, D).to(q.dtype)
