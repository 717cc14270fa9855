"""Core LM layers (port of ``repro/models/layers.py``, the attention and
FFN parts): RMSNorm, RoPE, softcap, per-token activation fake-quant,
GQA attention over a dense KV or the paged pool, SwiGLU, the
capacity-based top-k MoE FFN, and the ``linear`` / ``expert_linear``
that route a weight to its store's contraction.

Attention dispatches on ``impl``: ``"ref"`` is the chunked running-softmax
scan (:func:`attention_ref`, the oracle; :func:`paged_attention_ref`
gathers the pool's pages first), ``"cuda"`` the flash kernel K1 or the
paged kernel K4 (``kernels/attention.py``), in place of the reference's
``"pallas"``.
The reference's sharding helpers ``wcol`` / ``wrow`` / ``constrain`` have
no meaning on one card; with the reference's ``deq`` they become
:func:`linear` and :func:`expert_linear`, which contract a stored weight
(a PackedWeight, or the uniform int8 store's ``{"q", "s"}``) without
materializing it.  The port has no mesh, so ``moe_ffn(local_dispatch=True)``
is the plain dispatch, as the reference's is without a mesh.
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
def is_int8_leaf(w) -> bool:
    """A leaf of the uniform int8 store (``LM.quantize_params_int8``):
    ``{"q": int8 (..., K, N), "s": f32 (..., 1, N)}``."""
    return isinstance(w, dict) and "q" in w


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` over the last axis of x.  A PackedWeight goes to
    ``ops.packed_mixed_matmul`` (one K2/K3 launch per bucket on the card),
    an int8-store leaf to K2 with its per-channel scale (nothing
    dequantizes the weight); a dense weight is a plain matmul."""
    if isinstance(w, PackedWeight):
        from repro_torch.kernels.ops import packed_mixed_matmul
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return packed_mixed_matmul(x2, w).reshape(x.shape[:-1] + (w.n,))
    if is_int8_leaf(w):
        from repro_torch.kernels.quant_matmul import quant_matmul
        q = w["q"]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return quant_matmul(x2, q, w["s"].reshape(-1)).reshape(
            x.shape[:-1] + (q.shape[-1],))
    return x @ w


def expert_linear(x: torch.Tensor, w) -> torch.Tensor:
    """Each expert's rows times its own weight: x (E, C, K) against an
    (E, K, N) stack -> (E, C, N), the reference's ``"ecd,edf->ecf"``.  A
    PackedWeight stack and an int8-store stack take one batched K2 / K3
    launch per bucket for all E experts; a dense stack is a plain batched
    matmul (the reference computes it outside any Pallas kernel)."""
    x = x.contiguous()
    if isinstance(w, PackedWeight):
        from repro_torch.kernels.ops import packed_mixed_matmul
        return packed_mixed_matmul(x, w)
    if is_int8_leaf(w):
        from repro_torch.kernels.quant_matmul import quant_matmul
        q = w["q"]
        return quant_matmul(x, q, w["s"].reshape(q.shape[0], q.shape[-1]))
    return torch.bmm(x, w)


def _select_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


class _RowGather(torch.autograd.Function):
    """``table.index_select(0, idx)`` (any ``idx`` shape) whose backward is
    deterministic: the rows of repeated indices are summed by PyTorch's
    sort-based ``index_put_`` (stable sort, each row's terms added in
    index order), with deterministic algorithms switched on for that one
    call.  ``index_select``'s own CUDA backward sums them with atomics,
    in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return _select_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        was = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            gt = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
            gt.index_put_((idx,), g, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn)
        return gt, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (int64, any shape) of ``table``: a plain
    ``index_select``, whose gradient, when one is taken, is summed
    deterministically (:class:`_RowGather`), so two training runs from
    one seed give the same bits on the card.  The embedding lookup and
    the MoE dispatch and gather take their rows through it."""
    if table.requires_grad and torch.is_grad_enabled():
        return _RowGather.apply(table, idx)
    return _select_rows(table, idx)


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or wider: the reference's ``astype(float32)`` on the
    model's fp32 and bf16 tensors, while an fp64 tensor stays fp64, so an
    fp64 evaluation of a forward (a check's noise floor) is fp64
    throughout."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = at_least_f32(x)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + at_least_f32(w))).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, D); pos: (B, S) int32."""
    half = x.shape[-1] // 2
    ft = torch.promote_types(x.dtype, torch.float32)
    freqs = torch.pow(theta, -torch.arange(half, dtype=ft,
                                           device=x.device) / half)
    ang = pos.to(ft)[..., None] * freqs                       # (B, S, half)
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
    ``chunk`` rows: the plain version of kernel K1 and the oracle.  It
    computes in fp32, or in fp64 on fp64 inputs (a check's noise floor)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    ft = torch.promote_types(q.dtype, torch.float32)
    qf = (q.to(ft) * scale).reshape(B, Sq, Hkv, G, D)

    def score(kc, kvp):  # kc: (B, Ck, Hkv, D) -> (B, Hkv, G, Sq, Ck)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.to(ft))
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
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(ft))
        return finish(o, p.sum(dim=-1))

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=ft, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=ft, device=q.device)
    o = torch.zeros((B, Sq, Hkv, G, D), dtype=ft, device=q.device)
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
        pv = torch.einsum("bhgqk,bkhd->bqhgd", p, vc.to(ft))
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


# ----------------------------------------------------------------------- MoE
# profiler ranges of the MoE dispatch and gather (plain PyTorch kernels)
MOE_DISPATCH, MOE_GATHER = "moe_dispatch", "moe_gather"


def _n_phys(w) -> int:
    """Leading (physical expert) extent of an expert stack of any store."""
    if isinstance(w, PackedWeight):
        return w.parts[0][0].shape[0]
    return (w["q"] if is_int8_leaf(w) else w).shape[0]


def moe_capacity(T: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Rows a dispatch buffer holds per expert: T when ``capacity_factor
    <= 0`` (nothing dropped), else ``min(T, max(8, ceil(T K / E cf)))``."""
    if capacity_factor <= 0:
        return T
    return min(T, max(8, int(math.ceil(T * top_k / n_experts *
                                        capacity_factor))))


def moe_route(probs: torch.Tensor, top_k: int):
    """Each token's ``top_k`` experts and their renormalized gates from
    router probs (T, E): ``lax.top_k``'s choice, ties to the lower expert
    index (a stable descending sort; ``torch.topk`` promises no order
    among equal values), gates divided by ``max(sum, 1e-9)``.  Returns
    (gate_v (T, K) f32, gate_i (T, K) int64)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_v, gate_i = order.values[:, :top_k], order.indices[:, :top_k]
    return gate_v / torch.clamp(gate_v.sum(-1, keepdim=True), min=1e-9), \
        gate_i


def _position_in_expert(eidx: torch.Tensor, n_phys: int) -> torch.Tensor:
    """Each (token, slot) pair's position among the pairs routed to its
    expert, in token-major order: the reference's ``cumsum(one_hot) - 1``
    read at the pair's expert.  Computed as the pair's rank in a stable
    sort by expert less the rank of its expert's first pair (a cumsum
    down the (T*K, E) one-hot runs its columns one after another on the
    card: ~5 ms a layer at a 2 x 2048 prefill)."""
    n = eidx.shape[0]
    sorted_e, order = torch.sort(eidx, stable=True)
    first = torch.searchsorted(sorted_e, torch.arange(
        n_phys, device=eidx.device, dtype=sorted_e.dtype))
    rank = torch.empty_like(order).index_copy_(
        0, order, torch.arange(n, device=eidx.device))
    return rank - first[eidx]


def moe_ffn(x, p, *, n_experts, top_k, capacity_factor=1.25, act_bits=None,
            local_dispatch=False):
    """Capacity-based top-k MoE with index dispatch.  x: (..., d);
    p: {router (d, E), wg / wu (E_phys, d, ff), wd (E_phys, ff, d)} in any
    weight store.  Returns (out like x, router probs (T, E)).  Tokens
    beyond an expert's capacity are dropped (their residual path alone
    remains); ``capacity_factor <= 0`` drops nothing.  ``local_dispatch``
    splits the dispatch per data shard under a mesh in the reference; the
    port runs on one card without a mesh, where the reference takes the
    plain path too."""
    return _moe_ffn_impl(x, p, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor, act_bits=act_bits)


def _moe_ffn_impl(x, p, *, n_experts, top_k, capacity_factor, act_bits):
    """The reference's ``_moe_ffn_impl`` step for step: router logits in the
    model dtype and softmax in f32; top-k with ties to the lower expert (a
    stable descending sort, as ``lax.top_k``); gates renormalized by
    ``max(sum, 1e-9)``; position in expert as the reference's cumsum over
    the (token, slot) pairs in token-major order gives it
    (:func:`_position_in_expert`); pairs at or past capacity dropped.
    The dispatch buffer (E_phys, C, d) is a gather of the activation-
    quantized tokens: each kept pair writes its token id once into its
    (expert, position) cell (an index copy, no atomics: the card stays
    deterministic), empty cells read a zero row.  SwiGLU runs per expert
    through :func:`expert_linear`, and each pair gathers its expert's
    output row back, weighted by its gate, summed over the K slots.  Both
    row gathers go through :func:`gather_rows`, whose backward sums
    repeated rows deterministically.
    The dispatch (router softmax to the filled buffer) and the gather run
    inside the profiler ranges ``MOE_DISPATCH`` and ``MOE_GATHER``, which
    a profile reads to split their device time from the rest."""
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    E, K = n_experts, top_k
    E_phys = _n_phys(p["wg"])          # >= E when experts are padded (EP)
    C = moe_capacity(T, E, K, capacity_factor)
    dev = x.device

    logits = at_least_f32(linear(xt, p["router"]))
    with torch.profiler.record_function(MOE_DISPATCH):
        probs = torch.softmax(logits, dim=-1)                  # (T, E)
        gate_v, gate_i = moe_route(probs, K)                   # (T, K)

        eidx = gate_i.reshape(-1)                              # (T*K,)
        pos = _position_in_expert(eidx, E_phys)
        keep = pos < C
        trash = E_phys * C                      # the zero row / dropped cell
        cell = torch.where(keep, eidx * C + pos, torch.full_like(pos, trash))

        xq = maybe_quant_act(xt, act_bits)
        xpad = torch.cat([xq, xq.new_zeros((1, d))])           # row T: zeros
        src = torch.full((trash + 1,), T, dtype=torch.int64, device=dev)
        tok = torch.arange(T * K, device=dev) // K             # pair -> token
        src.index_copy_(0, cell, tok)    # kept cells are written once each
        buf = gather_rows(xpad, src[:trash]).reshape(E_phys, C, d)

    h = F.silu(expert_linear(buf, p["wg"])) * expert_linear(buf, p["wu"])
    out_buf = expert_linear(h, p["wd"])                        # (E_phys, C, d)

    with torch.profiler.record_function(MOE_GATHER):
        opad = torch.cat([out_buf.reshape(trash, d),
                          out_buf.new_zeros((1, d))])
        gathered = gather_rows(opad, cell)                     # (T*K, d)
        weighted = gathered * gate_v.reshape(-1)[:, None].to(gathered.dtype)
        out = weighted.reshape(T, K, d).sum(dim=1)
    return out.reshape(orig_shape), probs


def moe_aux_loss(probs, gate_i, n_experts):
    """Switch-style load-balance loss from router probs + top-1
    assignment."""
    frac_tokens = (gate_i[:, :1].long() == torch.arange(
        n_experts, device=probs.device)).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)
