"""Plain PyTorch versions of the GEMM and fake-quant kernels (port of
``repro/kernels/ref.py``), and the plain statement of K1's split-KV
decode (:func:`attention_split_ref`).

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


def attention_split_ref(q, k, v, *, q_pos, kv_pos, window=None,
                        attn_cap=None, n_splits=1, causal=True):
    """What K1's split walk and its merge compute
    (csrc/flash_attention.cu: flash_split, split_combine): the KV tiles of
    32 rows are cut into ``n_splits`` runs (``attention.split_tiles``);
    each run keeps its own online softmax over its tiles, by the
    reference's update rule; then the runs are merged in order,
    m = max_s m_s, e_s = exp(m_s - m_safe), o = sum_s e_s acc_s /
    max(sum_s e_s l_s, 1e-30).  Layouts as ``layers.attention_ref``.
    Tests and ``chip_smoke.py`` hold the kernel to it; no card path runs
    it."""
    from repro_torch.kernels.attention import BKV, split_tiles
    from repro_torch.models.layers import NEG_INF, _mask_scores, softcap
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, Hkv, G, D)
    parts = []
    for t0, t1 in split_tiles(Skv, n_splits):
        m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, Sq), device=q.device)
        acc = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
        for t in range(t0, t1):
            sl = slice(t * BKV, (t + 1) * BKV)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                             k[:, sl].to(torch.float32))
            s = _mask_scores(softcap(s, attn_cap), q_pos, kv_pos[:, sl],
                             causal=causal, window=window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                torch.zeros_like(m))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bhgqk,bkhd->bqhgd", p, v[:, sl].to(torch.float32))
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
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
