"""Core LM layers (port of ``repro/models/layers.py``, the attention and
dense-FFN parts): RMSNorm, RoPE, softcap, per-token activation fake-quant,
GQA attention over a dense KV or the paged pool, SwiGLU, and the
``linear`` that routes a weight to its store's contraction.

Attention dispatches on ``impl``: ``"ref"`` is the chunked running-softmax
scan (:func:`attention_ref`, the oracle; :func:`paged_attention_ref`
gathers the pool's pages first), ``"cuda"`` the flash kernel K1 or the
paged kernel K4 (``kernels/attention.py``), in place of the reference's
``"pallas"``.
The reference's sharding helpers ``wcol`` / ``wrow`` / ``constrain`` have
no meaning on one card; with the reference's ``deq`` they become
:func:`linear`, which contracts a packed weight without materializing it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.pack import PackedWeight
from repro_torch.quant.linear_quant import FULL_BITS, fake_quant_per_token

NEG_INF = float("-inf")
POS_SENTINEL = torch.iinfo(torch.int32).max


# --------------------------------------------------------------------- basics
def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` over the last axis of x.  A PackedWeight goes to
    ``ops.packed_mixed_matmul`` (one K2/K3 launch per bucket on the card);
    a dense weight is a plain matmul."""
    if isinstance(w, PackedWeight):
        from repro_torch.kernels.ops import packed_mixed_matmul
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return packed_mixed_matmul(x2, w).reshape(x.shape[:-1] + (w.n,))
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, D); pos: (B, S) int32."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = pos.to(torch.float32)[..., None] * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def maybe_quant_act(x: torch.Tensor, bits) -> torch.Tensor:
    """Per-token activation fake-quant; ``bits`` None disables and a bit
    width at or above FULL_BITS passes through."""
    if bits is None or float(bits) >= FULL_BITS:
        return x
    return fake_quant_per_token(x, float(bits))


# ------------------------------------------------------------------ attention
ATTN_IMPLS = ("ref", "cuda")


def _check_impl(impl):
    impl = impl or "ref"
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; "
                         f"expected one of {ATTN_IMPLS}")
    return impl


def attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
              attn_cap=None, chunk=1024, impl=None):
    """GQA attention dispatcher: ``impl="ref"`` (default) or ``"cuda"``
    (kernel K1).  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); q_pos (B, Sq)
    and kv_pos (B, Skv) int32.  ``chunk`` applies to the ref path only."""
    impl = _check_impl(impl)
    if impl == "cuda":
        from repro_torch.kernels.attention import flash_attention
        return flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               causal=causal, window=window,
                               attn_cap=attn_cap)
    return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                         window=window, attn_cap=attn_cap, chunk=chunk)


def _mask_scores(s, q_pos, kv_pos, *, causal, window):
    """s: (B, Hkv, G, Sq, Ck); q_pos (B, Sq); kv_pos (B, Ck)."""
    qp = q_pos[:, None, None, :, None].to(torch.int64)
    kp = kv_pos[:, None, None, None, :].to(torch.int64)
    mask = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def attention_ref(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
                  attn_cap=None, chunk=1024):
    """GQA attention with a running-softmax scan over KV chunks of
    ``chunk`` rows: the plain version of kernel K1 and the oracle."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, Hkv, G, D)

    def score(kc, kvp):  # kc: (B, Ck, Hkv, D) -> (B, Hkv, G, Sq, Ck)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.to(torch.float32))
        s = softcap(s, attn_cap)
        return _mask_scores(s, q_pos, kvp, causal=causal, window=window)

    def finish(o, l):   # o (B, Sq, Hkv, G, D); l (B, Hkv, G, Sq)
        o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        return o.reshape(B, Sq, Hq, D).to(q.dtype)

    if Skv <= chunk:
        s = score(k, kv_pos)
        m = s.amax(dim=-1, keepdim=True)
        msafe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - msafe)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
        return finish(o, p.sum(dim=-1))

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = score(kc, kv_pos[:, c0:c0 + chunk])              # (B,Hkv,G,Sq,Ck)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bqhgd", p, vc.to(torch.float32))
        o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    return finish(o, l)


# ----------------------------------------------------- paged-KV attention
def paged_gather(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Gather per-sequence KV through block tables.

    pages: (P, page_size, ...) physical pool; block_tables: (B, nb) int
    physical page ids in logical block order.  Returns (B, nb*page_size,
    ...): each sequence's pages flattened back into logical position order.
    Unmapped blocks point at the trash page (id 0), whose slots carry
    sentinel positions, so the attention mask rejects them."""
    g = pages[block_tables.long()]                       # (B, nb, ps, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_attention(q, k_pages, v_pages, pos_pages, block_tables, *, q_pos,
                    window=None, attn_cap=None,
                    k_scale_pages=None, v_scale_pages=None, impl=None):
    """Causal attention over the paged KV pool, for decode tokens and prompt
    chunks alike: ``impl="ref"`` (default) or ``"cuda"`` (kernel K4).

    q: (B, Sq, Hq, D); ``*_pages``: (P, page_size, Hkv, D), ``pos_pages``
    (P, page_size) int32; block_tables: (B, nb); q_pos: (B, Sq) int32, real
    columns left-aligned and the rest sentinel.  int8 pools carry
    per-(slot, head) ``*_scale_pages`` (P, page_size, Hkv) f32."""
    impl = _check_impl(impl)
    if impl == "cuda":
        from repro_torch.kernels.attention import paged_prefill_attention
        return paged_prefill_attention(
            q, k_pages, v_pages, pos_pages, block_tables, q_pos=q_pos,
            window=window, attn_cap=attn_cap, k_scale_pages=k_scale_pages,
            v_scale_pages=v_scale_pages)
    return paged_attention_ref(
        q, k_pages, v_pages, pos_pages, block_tables, q_pos=q_pos,
        window=window, attn_cap=attn_cap,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)


def paged_attention_ref(q, k_pages, v_pages, pos_pages, block_tables, *,
                        q_pos, window=None, attn_cap=None,
                        k_scale_pages=None, v_scale_pages=None):
    """Plain version of kernel K4 and the oracle: gather each sequence's
    pages into logical order (dequantizing int8 pools), then one
    single-shot :func:`attention_ref` over the whole gathered window."""
    k = paged_gather(k_pages, block_tables)
    v = paged_gather(v_pages, block_tables)
    kv_pos = paged_gather(pos_pages, block_tables)
    if k_scale_pages is not None:
        ks = paged_gather(k_scale_pages, block_tables)
        vs = paged_gather(v_scale_pages, block_tables)
        k = k.to(torch.float32) * ks[..., None]
        v = v.to(torch.float32) * vs[..., None]
    return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                         window=window, attn_cap=attn_cap, chunk=k.shape[1])


# ----------------------------------------------------------------------- FFN
def swiglu(x, p, act_bits=None):
    """p: {wg: (d, ff), wu: (d, ff), wd: (ff, d)}."""
    x = maybe_quant_act(x, act_bits)
    h = F.silu(linear(x, p["wg"])) * linear(x, p["wu"])
    return linear(h, p["wd"])
