"""Core LM layers (port of ``repro/models/layers.py``, the attention and
FFN parts): RMSNorm, RoPE, softcap, per-token activation fake-quant,
GQA attention over a dense KV or the paged pool, SwiGLU, the
capacity-based top-k MoE FFN, the ``linear`` / ``expert_linear``
that route a weight to its store's contraction, and the
:class:`StepLayout` of a paged serving step: its grid, its tables and
slots, and the rows its row-wise layers compute.

Attention dispatches on ``impl``: ``"ref"`` is the chunked running-softmax
scan (:func:`attention_ref`, the oracle; :func:`paged_attention_ref`
gathers the pool's pages first), ``"cuda"`` the flash kernel K1 or the
paged kernel K4 (``kernels/attention.py``), in place of the reference's
``"pallas"``.
The reference's ``wcol`` / ``wrow`` / ``deq`` become :func:`linear` (its
``role`` is the weight's sharding role, ``"w_col"`` or ``"w_row"``) and
:func:`expert_linear`, which contract a stored weight (a PackedWeight, or
the uniform int8 store's ``{"q", "s"}``) without materializing it.
Under a mesh (``sharding.ctx.sharding_rules``, DTensor arguments) the
same functions run sharded: DTensor shards the plain ops, and the
kernels K1 and K2 run on each rank's local shards
(:func:`_local_attention`, :func:`_sharded_quant_matmul`);
``moe_ffn(local_dispatch=True)`` splits the dispatch into one group per
DP shard, as the reference's.  Without a mesh every path is the
unsharded one.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import backend, spans
from repro_torch.kernels.pack import PackedWeight
from repro_torch.quant.linear_quant import FULL_BITS, fake_quant_per_token
from repro_torch.sharding import ctx

NEG_INF = float("-inf")
POS_SENTINEL = torch.iinfo(torch.int32).max


# --------------------------------------------------------------------- basics
def is_int8_leaf(w) -> bool:
    """A leaf of the uniform int8 store (``LM.quantize_params_int8``):
    ``{"q": int8 (..., K, N), "s": f32 (..., 1, N)}``."""
    return isinstance(w, dict) and "q" in w


def linear(x: torch.Tensor, w, role: Optional[str] = "w_col"
           ) -> torch.Tensor:
    """``x @ w`` over the last axis of x.  A PackedWeight goes to
    ``ops.packed_mixed_matmul`` (on the card one launch for the whole
    store at more than 8 rows, else one K2/K3 launch per bucket),
    an int8-store leaf to K2 with its per-channel scale (nothing
    dequantizes the weight); a dense weight is a plain matmul.  The
    result has the reference's dtype for ``x @ deq(w)``: the promotion of
    x's and the dequantized weight's (bf16 for bf16 x against a bf16 or
    bf16-packed weight, fp32 against the int8 store's fp32 scales).

    ``role`` is the weight's sharding role at use, the reference's
    ``wcol`` / ``wrow``: ``"w_col"`` (column-parallel, the default),
    ``"w_row"`` (row-parallel: wo, wd, w_out) or None (the router).  Under
    a mesh whose rules name the role (``weight_gather``) a dense DTensor
    weight is constrained to its spec before the product; an int8-store
    DTensor leaf is contracted shard by shard on K2
    (:func:`_sharded_quant_matmul`)."""
    if isinstance(w, PackedWeight):
        from repro_torch.kernels.ops import packed_mixed_matmul
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return packed_mixed_matmul(x2, w).reshape(x.shape[:-1] + (w.n,))
    if is_int8_leaf(w):
        if ctx.is_dtensor(x) or ctx.is_dtensor(w["q"]):
            return _sharded_quant_matmul(x, w, batched=False)
        from repro_torch.kernels.quant_matmul import quant_matmul
        q = w["q"]
        x2 = _int8_x(x, w).reshape(-1, x.shape[-1]).contiguous()
        return quant_matmul(x2, q, w["s"].reshape(-1)).reshape(
            x.shape[:-1] + (q.shape[-1],))
    return x @ (w if role is None else ctx.constrain(w, role))


def expert_linear(x: torch.Tensor, w) -> torch.Tensor:
    """Each expert's rows times its own weight: x (E, C, K) against an
    (E, K, N) stack -> (E, C, N), the reference's ``"ecd,edf->ecf"``.  A
    PackedWeight stack and an int8-store stack take K2 / K3 launches for
    all E experts at once (``ops.packed_mixed_matmul``); a dense stack is
    a plain batched matmul (the reference computes it outside any Pallas
    kernel)."""
    if is_int8_leaf(w) and (ctx.is_dtensor(x) or ctx.is_dtensor(w["q"])):
        return _sharded_quant_matmul(x, w, batched=True)
    x = x.contiguous()
    if isinstance(w, PackedWeight):
        from repro_torch.kernels.ops import packed_mixed_matmul
        return packed_mixed_matmul(x, w)
    if is_int8_leaf(w):
        from repro_torch.kernels.quant_matmul import quant_matmul
        q = w["q"]
        return quant_matmul(_int8_x(x, w), q,
                            w["s"].reshape(q.shape[0], q.shape[-1]))
    return torch.bmm(x, w)


def grouped_expert_linear(x: torch.Tensor, w, offsets: torch.Tensor,
                          cap: int) -> torch.Tensor:
    """:func:`expert_linear` over the rows routed to each expert alone:
    x (P, K) holds expert e's rows in ``offsets[e]:offsets[e + 1]``
    (``offsets`` (E + 1,) int32 on x's device), at most ``cap`` of them,
    against an (E, K, N) stack that K2 / K3 contract as it is (a
    PackedWeight without a bf16 ``full`` bucket, or an int8-store leaf)
    -> (P, N), grouped launches (one for a whole PackedWeight,
    ``packed_matmul.mixed_matmul``).  Each row gets the bits it
    gets in :func:`expert_linear`'s (E, cap, K) layout; rows outside every
    group are unspecified."""
    x = x.contiguous()
    if isinstance(w, PackedWeight):
        from repro_torch.kernels.ops import packed_mixed_matmul
        return packed_mixed_matmul(x, w, offsets, cap)
    from repro_torch.kernels.quant_matmul import quant_matmul_grouped
    q = w["q"]
    return quant_matmul_grouped(_int8_x(x, w), q,
                                w["s"].reshape(q.shape[0], q.shape[-1]),
                                offsets, cap)


def _int8_x(x, w) -> torch.Tensor:
    """``x`` in the result dtype against an int8-store leaf, which K2
    writes in x's dtype: the reference dequantizes the leaf as ``q * s``
    in the scales' dtype (fp32) and promotes (an exact upcast of a bf16
    x)."""
    return x.to(torch.promote_types(x.dtype, w["s"].dtype))


def _sharded_quant_matmul(x, w, batched: bool):
    """K2 under a mesh: ``x`` (..., K) against an int8-store leaf
    ``{"q": (K, N), "s": (1, N)}`` (``batched``: x (E, C, K) against
    (E, K, N) / (E, 1, N)), any of them DTensors.  The contraction dim is
    gathered on both sides; on every other mesh dim the product keeps
    x's row shard, else q's column shard (and the scales' matching
    chunk), else nothing; a ``batched`` expert dim sharded on either side
    is sharded on both.  K2 then runs on the local shards
    (``to_local()``: the kernel takes no DTensor) and the result is
    wrapped back, so the kernel still runs under a mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    q, s = w["q"], w["s"]
    mesh = next(t for t in (x, q, s) if ctx.is_dtensor(t)).device_mesh
    x, q, s = (ctx.replicated(t, mesh) for t in (x, q, s))
    tx, tq, ts, to = [], [], [], []
    for px, pq in zip(x.placements, q.placements):
        xd = px.dim if isinstance(px, Shard) and px.dim < x.ndim - 1 \
            else None
        qd = pq.dim if isinstance(pq, Shard) and pq.dim != q.ndim - 2 \
            else None
        if batched and 0 in (xd, qd):              # the expert dim
            pick = (Shard(0), Shard(0), Shard(0), Shard(0))
        elif xd is not None:                       # x's rows
            pick = (Shard(xd), Replicate(), Replicate(), Shard(xd))
        elif qd is not None:                       # q's columns
            pick = (Replicate(), Shard(q.ndim - 1), Shard(s.ndim - 1),
                    Shard(x.ndim - 1))
        else:
            pick = (Replicate(),) * 4
        for lst, p in zip((tx, tq, ts, to), pick):
            lst.append(p)
    xl = x.redistribute(mesh, tx).to_local()
    ql = q.redistribute(mesh, tq).to_local()
    sl = s.redistribute(mesh, ts).to_local()
    from repro_torch.kernels.quant_matmul import quant_matmul
    xl = xl.to(torch.promote_types(xl.dtype, sl.dtype))
    if batched:
        yl = quant_matmul(xl.contiguous(), ql,
                          sl.reshape(ql.shape[0], ql.shape[-1]))
    else:
        yl = quant_matmul(xl.reshape(-1, xl.shape[-1]).contiguous(), ql,
                          sl.reshape(-1)).reshape(
            xl.shape[:-1] + (ql.shape[-1],))
    shape = tuple(x.shape[:-1]) + (q.shape[-1],)
    return DTensor.from_local(yl, mesh, to, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def split_heads(t: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """(..., H * hd) -> (..., H, hd).  Under a mesh, a last dim split into
    more shards than H divides is gathered first (``ctx.unshard``):
    DTensor has no strategy that splits such a shard."""
    if n_heads % ctx.shards_on(t, -1):
        t = ctx.unshard(t, [-1])
    return t.reshape(t.shape[:-1] + (n_heads, hd))


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) -> (..., H * hd).  Under a mesh with an axis that H
    does not divide, the result's last dim is pinned replicated
    (``ctx.pin_unsharded``): the gradient that a row-parallel weight
    hands back is sharded there, and the backward of this merge could not
    split it into heads."""
    out = t.reshape(t.shape[:-2] + (t.shape[-2] * t.shape[-1],))
    return ctx.pin_unsharded(out, -1, t.shape[-2])


class StepLayout(NamedTuple):
    """One paged step over the pool (``LM.model_step``,
    ``LM.decode_step_paged``): an (R, w) grid, row r at positions
    ``pos[r]`` (int32, ``POS_SENTINEL`` on padded cells) through block
    table ``tables[r]``, its recurrent state at slot ``slot_map[r]`` (None
    in paged decode).  The row-wise layers compute ``cells`` ((B,) int64
    flat grid indices, ascending) as (B, 1, ·) rows, each through its
    table ``row_tables``; K4 and mamba's conv and scan take the grid.
    ``cells`` None computes the whole grid as it is: scatter and gather
    give their input back and a listed column's logits row is itself.
    ``real``: the grid's real cells, a host count for the spans (None:
    not counted).  Host arrays from :meth:`LM.step_layout`, tensors after
    :meth:`upload`; :meth:`of` builds one from tensors."""
    pos: Any
    tables: Any = None
    slot_map: Any = None
    cells: Any = None
    real: Optional[int] = None
    row_tables: Any = None

    @classmethod
    def of(cls, pos, tables=None, slot_map=None, cells=None, real=None):
        row_tables = tables
        if cells is not None:
            cells = cells.long()
            if tables is not None:
                row_tables = tables.index_select(0, cells // pos.shape[1])
        return cls(pos.to(torch.int32), tables, None if slot_map is None
                   else slot_map.long(), cells, real, row_tables)

    def upload(self, device) -> "StepLayout":
        device = torch.device(device)
        return StepLayout.of(*(None if a is None else backend.upload(
            a, device) for a in self[:4]), real=self.real)

    @property
    def n_rows(self) -> int:
        R, w = self.pos.shape
        return R * w if self.cells is None else int(self.cells.shape[0])

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The (R, w, ...) grid -> the computed rows."""
        if self.cells is None:
            return t
        return t.reshape((-1,) + t.shape[2:]).index_select(
            0, self.cells)[:, None]

    def scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The computed rows -> the (R, w, ...) grid, zeros elsewhere."""
        if self.cells is None:
            return t
        tail = t.shape[2:]
        g = t.new_zeros((self.pos.numel(),) + tail)
        g.index_copy_(0, self.cells, t.reshape((-1,) + tail))
        return g.reshape(self.pos.shape + tail)

    def logit_rows(self, x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """The rows ``x`` at each grid row's listed columns ``cols`` ((R,)
        or (R, C)) -> (R, C, d); a row with no real cell reads a
        neighbour: nothing samples it."""
        cols = cols.long().reshape(cols.shape[0], -1)
        if self.cells is None:
            return torch.gather(x, 1, cols[..., None].expand(
                -1, -1, x.shape[-1]))
        flat = cols + torch.arange(cols.shape[0], device=cols.device)[
            :, None] * self.pos.shape[1]
        rows = torch.searchsorted(self.cells, flat).clamp_(
            max=self.cells.shape[0] - 1)
        return x[:, 0][rows]


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
    the MoE dispatch and gather take their rows through it.  A DTensor
    table (under a mesh) that is replicated, with replicated indices,
    takes this same gather on its local tensor (so a 1x1 mesh gives the
    unsharded bits); any other takes ``F.embedding``, which DTensor
    shards (a row-sharded table by a masked lookup, whose partial sums
    are reduced at once: ``ctx.settle``)."""
    if ctx.is_dtensor(table):
        from torch.distributed.tensor import DTensor, Replicate
        if all(isinstance(p, Replicate) for p in table.placements) and (
                not ctx.is_dtensor(idx) or all(
                    isinstance(p, Replicate) for p in idx.placements)):
            idx_l = idx.to_local() if ctx.is_dtensor(idx) else idx
            return DTensor.from_local(
                gather_rows(table.to_local(), idx_l), table.device_mesh,
                table.placements, run_check=False)
        return ctx.settle(F.embedding(idx, table))
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
    if any(ctx.is_dtensor(t) for t in (q, k, v)):
        return _local_attention(q, k, v, q_pos, kv_pos, impl, dict(
            causal=causal, window=window, attn_cap=attn_cap, chunk=chunk))
    if impl == "cuda":
        from repro_torch.kernels.attention import flash_attention
        return flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               causal=causal, window=window,
                               attn_cap=attn_cap)
    return attention_ref(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                         window=window, attn_cap=attn_cap, chunk=chunk)


def _local_attention(q, k, v, q_pos, kv_pos, impl, kw):
    """:func:`attention` under a mesh, on each rank's local shards: every
    mesh dim that shards q's batch shards q, k, v and both positions'
    batch; one that shards q's heads, where the kv heads divide, shards
    q's, k's and v's heads (GQA groups stay whole); any other sharding of
    the operands is gathered first (a KV sequence sharded over "model",
    say).  Attention is independent per (batch row, head), so the local
    results are the global one's shards.  K1 thus runs on local tensors
    (``impl="cuda"``: the kernel takes no DTensor), and DTensor does not
    have to search strategies for the 5-d einsums of the plain version,
    which takes minutes on a 3-d mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = next(t for t in (q, k, v) if ctx.is_dtensor(t)).device_mesh
    q, k, v, q_pos, kv_pos = (ctx.replicated(t, mesh)
                              for t in (q, k, v, q_pos, kv_pos))
    pq, pkv, ppos = [], [], []
    for size, p in zip(mesh.mesh.shape, q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            pick = (Shard(0), Shard(0), Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and k.shape[2] % size == 0:
            pick = (Shard(2), Shard(2), Replicate())
        else:
            pick = (Replicate(),) * 3
        for lst, x in zip((pq, pkv, ppos), pick):
            lst.append(x)
    ql = q.redistribute(mesh, pq).to_local()
    kl, vl = (t.redistribute(mesh, pkv).to_local() for t in (k, v))
    qpl, kpl = (t.redistribute(mesh, ppos).to_local() for t in (q_pos, kv_pos))
    if impl == "cuda":
        from repro_torch.kernels.attention import flash_attention
        kw = {key: kw[key] for key in ("causal", "window", "attn_cap")}
        out = flash_attention(ql, kl, vl, q_pos=qpl, kv_pos=kpl, **kw)
    else:
        out = attention_ref(ql, kl, vl, q_pos=qpl, kv_pos=kpl, **kw)
    return DTensor.from_local(out, mesh, pq, run_check=False, shape=q.shape,
                              stride=_contiguous_stride(tuple(q.shape)))


def _mask_scores(s, q_pos, kv_pos, *, causal, window):
    """s: (B, Hkv, G, Sq, Ck); q_pos (B, Sq); kv_pos (B, Ck)."""
    qp = q_pos[:, None, None, :, None].to(torch.int64)
    kp = kv_pos[:, None, None, None, :].to(torch.int64)
    mask = None
    if causal:
        mask = kp <= qp
    if window is not None:
        inside = kp > qp - window
        mask = inside if mask is None else mask & inside
    if mask is None:
        return s
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
    return linear(h, p["wd"], role="w_row")


# ----------------------------------------------------------------------- MoE
# spans (``repro_torch.spans``) of the MoE FFN, and of its dispatch and
# gather (plain PyTorch kernels) inside it
MOE, MOE_DISPATCH, MOE_GATHER = "moe", "moe_dispatch", "moe_gather"


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


def _expert_sort(eidx: torch.Tensor, n_phys: int):
    """The stable sort of the (token, slot) pairs by expert: ``order``
    (the pairs in expert order), ``first`` (n_phys + 1: each expert's
    first index in it, then the pair count) and ``rank`` (each pair's
    index in it)."""
    n = eidx.shape[0]
    sorted_e, order = torch.sort(eidx, stable=True)
    first = torch.searchsorted(sorted_e, torch.arange(
        n_phys + 1, device=eidx.device, dtype=sorted_e.dtype))
    rank = torch.empty_like(order).index_copy_(
        0, order, torch.arange(n, device=eidx.device))
    return order, first, rank


def _position_in_expert(eidx: torch.Tensor, n_phys: int) -> torch.Tensor:
    """Each (token, slot) pair's position among the pairs routed to its
    expert, in token-major order: the reference's ``cumsum(one_hot) - 1``
    read at the pair's expert.  Computed as the pair's rank in a stable
    sort by expert less the rank of its expert's first pair (a cumsum
    down the (T*K, E) one-hot runs its columns one after another on the
    card: ~5 ms a layer at a 2 x 2048 prefill)."""
    _, first, rank = _expert_sort(eidx, n_phys)
    return rank - first[eidx]


def moe_ffn(x, p, *, n_experts, top_k, capacity_factor=1.25, act_bits=None,
            local_dispatch=False):
    """Capacity-based top-k MoE with index dispatch.  x: (..., d);
    p: {router (d, E), wg / wu (E_phys, d, ff), wd (E_phys, ff, d)} in any
    weight store.  Returns (out like x, router probs (T, E)).  Tokens
    beyond an expert's capacity are dropped (their residual path alone
    remains); ``capacity_factor <= 0`` drops nothing.

    ``local_dispatch`` under a mesh (``ctx.current_mesh()``) with
    G = pod * data > 1 and T % G == 0 splits the tokens into G groups of
    T / G, pinned as ``"moe_group"``, and dispatches each group with its
    own capacity, as the reference's vmap over groups does.  Without a
    mesh, or when G does not divide T, it is the plain dispatch."""
    mesh = ctx.current_mesh() if local_dispatch else None
    if mesh is not None:
        axes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        G = axes.get("pod", 1) * axes.get("data", 1)
        T = math.prod(x.shape[:-1])
        if G > 1 and T % G == 0:
            d = x.shape[-1]
            xg = ctx.constrain(x.reshape(G, T // G, d), "moe_group")
            out, probs = _moe_ffn_impl(
                xg, p, n_experts=n_experts, top_k=top_k,
                capacity_factor=capacity_factor, act_bits=act_bits, groups=G)
            out = ctx.constrain(out, "moe_group")
            return out.reshape(x.shape), probs
    return _moe_ffn_impl(x, p, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor, act_bits=act_bits)


def _leaf_tensors(w):
    """The tensors of one weight in any store."""
    if isinstance(w, PackedWeight):
        return [t for part in w.parts for t in part]
    return list(w.values()) if is_int8_leaf(w) else [w]


def _grouped_applies(xt, p, C: int, groups: int) -> bool:
    """Whether the experts run grouped (:func:`_moe_grouped`), from what
    the call can observe: one group; the capacity layout's rows an expert
    C above ``SKINNY_M``, where its expert GEMMs take the tensor cores (at
    or below it they stream the weights once, whatever the rows); every
    expert stack one that K2 / K3 contract as it is (an int8-store leaf,
    or a PackedWeight without a bf16 ``full`` bucket); and no DTensor.
    Otherwise the capacity layout (:func:`_moe_capacity`)."""
    from repro_torch.kernels.quant_matmul import SKINNY_M
    stacks = [p[k] for k in ("wg", "wu", "wd")]
    return groups == 1 and C > SKINNY_M and all(
        is_int8_leaf(w) or (isinstance(w, PackedWeight) and all(
            name != "full" for name, _ in w.buckets)) for w in stacks) \
        and not any(ctx.is_dtensor(t) for t in
                    [xt] + [t for w in stacks for t in _leaf_tensors(w)])


def _moe_ffn_impl(x, p, *, n_experts, top_k, capacity_factor, act_bits,
                  groups: int = 1):
    """The reference's ``_moe_ffn_impl`` step for step: router logits in the
    model dtype and softmax in f32; top-k with ties to the lower expert (a
    stable descending sort, as ``lax.top_k``); gates renormalized by
    ``max(sum, 1e-9)``; position in expert as the reference's cumsum over
    the (token, slot) pairs in token-major order gives it
    (:func:`_position_in_expert`); pairs at or past capacity dropped;
    SwiGLU per expert, and each kept pair's expert output weighted by its
    gate and summed over the K slots.  The experts run in one of two
    layouts, chosen by :func:`_grouped_applies` from the call alone:
    :func:`_moe_capacity`, the reference's (E_phys, C, d) buffer, or
    :func:`_moe_grouped`, the kept pairs alone sorted by expert; a kept
    pair gets the same bits from both.
    ``groups`` > 1 (``moe_ffn``'s local dispatch): x is (G, T / G, d), and
    each group has its own capacity (:func:`_moe_capacity`).
    Spans (``repro_torch.spans``, recorded while a profiler runs): ``moe``
    from the router to the end of the gather, with the counts ``pairs``
    (T x K, the routed pairs) and ``rows``, the rows that the expert GEMMs
    compute: T x K grouped, E_phys x groups x C in the capacity layout.
    It opens no ``record_function`` (no reader uses its range); inside it
    ``moe_dispatch`` (router softmax to the filled buffer) and
    ``moe_gather``, which a profile reads to split their device time from
    the rest."""
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    K = top_k
    E_phys = _n_phys(p["wg"])          # >= E when experts are padded (EP)
    C = moe_capacity(T // groups, n_experts, K, capacity_factor)
    grouped = _grouped_applies(xt, p, C, groups)

    with spans.span(MOE, annotate=False, pairs=T * K,
                    rows=T * K if grouped else E_phys * groups * C):
        logits = at_least_f32(linear(xt, p["router"], role=None))
        if grouped:
            out, probs = _moe_grouped(xt, logits, p, top_k=K, capacity=C,
                                      act_bits=act_bits)
        else:
            out, probs = _moe_capacity(xt, logits, p, top_k=K, capacity=C,
                                       act_bits=act_bits, groups=groups)
    return out.reshape(orig_shape), probs


def _route_pairs(logits, top_k: int):
    """Router probs (T, E) in f32, and each (token, slot) pair's gate and
    expert in token-major order, (T*K,) each (on DTensors the experts are
    gathered to every rank: DTensor has no strategy for the sort-based
    positions, and the index math runs replicated)."""
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = moe_route(probs, top_k)
    eidx = gate_i.reshape(-1)
    if ctx.is_dtensor(eidx):
        eidx = eidx.full_tensor()
    return probs, gate_v.reshape(-1), eidx


def _combine(gathered, gate_v, T: int, K: int, d: int):
    """Each pair's expert output row (T*K, d) weighted by its gate, summed
    over the K slots -> (T, d)."""
    weighted = gathered * gate_v[:, None].to(gathered.dtype)
    return weighted.reshape(T, K, d).sum(dim=1)


def _moe_capacity(xt, logits, p, *, top_k, capacity, act_bits, groups=1):
    """The experts in the reference's capacity layout: the dispatch buffer
    (E_phys, C, d) is a gather of the activation-quantized tokens, each
    kept pair writing its token id once into its (expert, position) cell
    (an index copy, no atomics: the card stays deterministic), empty cells
    reading a zero row; SwiGLU per expert through :func:`expert_linear`;
    each pair gathers its expert's output row back (dropped pairs a zero
    row).  Both row gathers go through :func:`gather_rows`, whose backward
    sums repeated rows deterministically.  ``groups`` > 1: x holds G
    groups of T / G tokens, each with its own capacity and its own cells,
    (group, expert) taking the place of the expert in the sort; the
    experts run every group's rows in one call, (E_phys, G * C, d).
    Returns (out (T, d), probs)."""
    T, d = xt.shape
    K, C = top_k, capacity
    E_phys = _n_phys(p["wg"])
    dev = xt.device
    with spans.span(MOE_DISPATCH):
        probs, gate_v, eidx = _route_pairs(logits, K)
        if groups > 1:                        # (group, expert) of each pair
            eidx = eidx + torch.arange(T * K, device=dev) // (
                T // groups * K) * E_phys
        pos = _position_in_expert(eidx, groups * E_phys)
        keep = pos < C
        trash = groups * E_phys * C             # the zero row / dropped cell
        cell = torch.where(keep, eidx * C + pos,
                           torch.full_like(pos, trash))

        xq = maybe_quant_act(xt, act_bits)
        xpad = torch.cat([xq, xq.new_zeros((1, d))])           # row T: zeros
        src = torch.full((trash + 1,), T, dtype=torch.int64, device=dev)
        tok = torch.arange(T * K, device=dev) // K             # pair -> token
        src.index_copy_(0, cell, tok)      # kept cells are written once each
        buf = gather_rows(xpad, src[:trash])
        if groups > 1:
            buf = buf.reshape(groups, E_phys, C, d).transpose(0, 1)
        # the buffer's gradient comes back sharded over (expert, row)
        # from the expert GEMMs; gathered on both dims it flattens back
        # on every torch release (some refuse a sharded dim 1)
        buf = ctx.unshard(buf.reshape(E_phys, groups * C, d), [0, 1],
                          force=True)

    h = F.silu(expert_linear(buf, p["wg"])) * expert_linear(buf, p["wu"])
    out_buf = expert_linear(h, p["wd"])                  # (E_phys, G * C, d)

    with spans.span(MOE_GATHER):
        if groups > 1:
            out_buf = out_buf.reshape(E_phys, groups, C, d).transpose(0, 1)
        out_buf = ctx.unshard_uneven(out_buf)         # E_phys % shards, say
        opad = torch.cat([out_buf.reshape(trash, d),
                          out_buf.new_zeros((1, d))])
        return _combine(gather_rows(opad, cell), gate_v, T, K, d), probs


def _moe_grouped(xt, logits, p, *, top_k, capacity, act_bits):
    """The experts over the kept pairs alone (one group, K2 / K3 stacks,
    no DTensor: :func:`_grouped_applies`): the pairs' tokens gathered in
    the stable sort by expert (:func:`_expert_sort`) into a (T*K, d)
    buffer, expert e's kept pairs in rows ``offsets[e]:offsets[e + 1]`` in
    the order of their positions, so a pair's row in its group is its
    capacity cell's row in its expert; SwiGLU on the grouped launches
    (:func:`grouped_expert_linear`); each pair gathers its row back.
    Dropless (C >= T: no expert can be routed more than T pairs), a pair's
    row is its rank in the sort.  Otherwise the pairs at or past an
    expert's capacity are left out of its rows, the rows past the last
    offset read a zero token and are never contracted, and a dropped pair
    reads zero in place of its expert's output.  Returns (out (T, d),
    probs)."""
    T, d = xt.shape
    K, C = top_k, capacity
    P = T * K
    E_phys = _n_phys(p["wg"])
    dev = xt.device
    with spans.span(MOE_DISPATCH):
        probs, gate_v, eidx = _route_pairs(logits, K)
        order, first, rank = _expert_sort(eidx, E_phys)
        xq = maybe_quant_act(xt, act_bits)
        if C >= T:
            offsets, row = first, rank
            buf = gather_rows(xq, order // K)
        else:
            kept = torch.clamp(first[1:] - first[:-1], max=C)
            offsets = F.pad(torch.cumsum(kept, 0), (1, 0))
            pos = rank - first[eidx]
            keep = pos < C
            row = torch.where(keep, offsets[eidx] + pos,
                              torch.full_like(pos, P))
            src = torch.full((P + 1,), T, dtype=torch.int64, device=dev)
            src.index_copy_(0, row, torch.arange(P, device=dev) // K)
            buf = gather_rows(torch.cat([xq, xq.new_zeros((1, d))]),
                              src[:P])
        offsets = offsets.to(torch.int32)

    h = F.silu(grouped_expert_linear(buf, p["wg"], offsets, C)) * \
        grouped_expert_linear(buf, p["wu"], offsets, C)
    y = grouped_expert_linear(h, p["wd"], offsets, C)             # (P, d)

    with spans.span(MOE_GATHER):
        if C >= T:
            gathered = gather_rows(y, row)
        else:
            gathered = torch.where(keep[:, None], gather_rows(
                y, torch.clamp(row, max=P - 1)), 0)
        return _combine(gathered, gate_v, T, K, d), probs


def moe_aux_loss(probs, gate_i, n_experts):
    """Switch-style load-balance loss from router probs + top-1
    assignment."""
    frac_tokens = (gate_i[:, :1].long() == torch.arange(
        n_experts, device=probs.device)).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)
