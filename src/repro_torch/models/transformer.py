"""Config-driven decoder LM: self- and cross-attention and Mamba2 (SSD)
blocks with dense or MoE FFNs (port of ``repro/models/transformer.py``).

Covers GQA attention with RoPE (or none: ``rope_theta=None``), the
sliding window and the softcaps,
cross-attention over image embeddings (``cross_attn`` blocks: no RoPE,
every query attends every image token), Mamba2 blocks (``models/ssm.py``),
dense SwiGLU and capacity-based top-k MoE FFNs (with a shared SwiGLU
expert beside the routed ones where ``moe.shared_d_ff`` is set), the
muP scalars of ``api.HybridLMConfig`` (granitemoehybrid), the audio front end
(``frontend="audio_stub"``: frame embeddings ``batch["embeds"]`` in place
of tokens, no embedding table), ``prefill`` and ``decode_step`` over the
dense cache (K/V in bf16 by default, fp32, or int8 with per-(position,
head) scales; a mamba block's recurrent ``"state"``; a cross block's
``"memory"``, the image K/V written whole at prefill), and
``decode_step_paged`` and ``model_step`` over the paged pool
(``init_paged_cache``; ``model_step`` takes attention's pages and mamba's
per-slot recurrent state side by side, where the reference's takes
all-paged patterns only; cross-attention's memory it refuses), and the
training loss (``loss``, with per-repeat
rematerialisation and the MoE load-balance term).
Weights may arrive in the uniform int8 store
(:meth:`LM.quantize_params_int8`: ``{"q", "s"}`` leaves) or the packed
store (``quant.apply.apply_policy_packed``).  Parameters keep the
reference's pytree: ``{"blocks": tuple per pattern position of
dicts of (n_repeat, ...) stacked tensors, "final_norm", "unembed",
"embed"}`` (a mamba block's weights in its ``"mamba"`` sub-dict; no
``"embed"`` for the audio front end).  A
Python loop over the stacked repeats takes the place of
``lax.scan``; its depth is the params' own, so the speculative draft's
prefix view (``draft_prefix_params``) runs through the same entry points.

Unlike the reference, caches are updated **in place**: every entry point
writes into the tensors of the cache or pool it is given and returns that
same object, so a 26-layer cache is never copied per token.

KV-cache convention: unwritten slots carry position ``POS_SENTINEL`` (int32
max), which the attention masks reject; ``local_attn`` blocks keep a ring
buffer of ``window`` slots.  In the paged pool, page ``TRASH_PAGE`` is
never allocated: sentinel lanes write there.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import backend, spans
from repro_torch.kernels.pack import PackedWeight
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.api import BlockDef, LMConfig
from repro_torch.models.layers import (POS_SENTINEL, StepLayout,
                                       at_least_f32, attention, gather_rows,
                                       is_int8_leaf, linear, maybe_quant_act,
                                       merge_heads, moe_ffn, paged_attention,
                                       rmsnorm, rope, softcap, split_heads,
                                       swiglu)
from repro_torch.quant.linear_quant import FULL_BITS
from repro_torch.quant.policy import LayerInfo, QuantizableGraph
from repro_torch.sharding.ctx import constrain, settle

# leaves that quantize_params_int8 stores as {"q", "s"} (the reference's
# set, mamba's included)
MATMUL_LEAVES = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd",
                           "router", "w_xz", "w_bc", "w_dt", "w_out",
                           "embed", "unembed"})


# physical page 0 of every paged pool is the never-allocated trash page
# (serve/paged_kv.py owns the lifecycle; defined here because the paged
# write below routes sentinel lanes to it)
TRASH_PAGE = 0


def compact_rows(n_real: int) -> int:
    """The rung of the token-budget step's ladder (``LM.step_layout``)
    that holds ``n_real`` real cells: the least multiple of K2 / K3's
    128-row tile (``csrc/gemm_tiles.cuh`` ``CBM``) up to 1024, then of 512
    (14 shapes at 16 x 256).  Every rung is over ``SKINNY_M``, so a
    compacted product takes the tensor-core route that the whole grid's
    takes."""
    n = max(int(n_real), 1)
    return -(-n // 128) * 128 if n <= 1024 else -(-n // 512) * 512


# ----------------------------------------------------- quantized KV caching
def _kv_quant(x):
    """(B, S, Hkv, hd) -> (int8 values, f32 scale (B, S, Hkv))."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _kv_dtype(dtype: torch.dtype, kv_bits: Optional[int]) -> torch.dtype:
    """K/V element type of a cache: int8 for ``kv_bits=8`` (which wins over
    ``dtype``, as in the reference), else ``dtype`` (bf16 or fp32: what
    the attention kernels read)."""
    if kv_bits not in (None, 8):
        raise ValueError(f"unsupported kv_bits {kv_bits!r}")
    if kv_bits == 8:
        return torch.int8
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported cache dtype {dtype}: bf16 or fp32")
    return dtype


def _kv_deq(cache, key):
    kq = cache[key]
    if kq.dtype == torch.int8:
        return kq.to(torch.float32) * cache[key + "_s"][..., None]
    return kq


def _kv_write(cache, k, v, pos, slot: int):
    """Write (k, v, pos) into the cache window starting at ``slot``, in
    place, quantizing per (position, head) when the cache stores int8."""
    S = k.shape[1]
    for key, val in (("k", k), ("v", v)):
        if cache[key].dtype == torch.int8:
            q, s = _kv_quant(val)
            cache[key][:, slot:slot + S] = q
            cache[key + "_s"][:, slot:slot + S] = s
        else:
            cache[key][:, slot:slot + S] = val.to(cache[key].dtype)
    cache["pos"][:, slot:slot + S] = pos


def _kv_store_full(cache, k, v):
    """Cross-attention memory: overwrite the whole (fixed-length) cache in
    place, quantizing per (position, head) when it stores int8."""
    for key, val in (("k", k), ("v", v)):
        if cache[key].dtype == torch.int8:
            q, s = _kv_quant(val)
            cache[key].copy_(q)
            cache[key + "_s"].copy_(s)
        else:
            cache[key].copy_(val)


def _kv_write_paged(cache, k, v, wp, block_tables):
    """Write (k, v, wp) through the block tables into the pool, in place.
    k, v: (B, S, Hkv, hd); wp: (B, S) int32 positions; block_tables
    (B, nb).  Sentinel lanes (idle decode slots, chunk padding) go to the
    trash page *explicitly*: an active row's clipped block index would
    land in one of its own pages and corrupt a live KV slot."""
    ps = cache["k"].shape[1]
    nb = block_tables.shape[1]
    blk = torch.clamp(wp // ps, max=nb - 1).long()
    phys = torch.gather(block_tables.long(), 1, blk)
    phys = torch.where(wp == POS_SENTINEL, TRASH_PAGE, phys)
    fp, fs = phys.reshape(-1), (wp % ps).reshape(-1).long()
    for key, val in (("k", k), ("v", v)):
        val = val.reshape((-1,) + val.shape[2:])
        if cache[key].dtype == torch.int8:
            q, s = _kv_quant(val)
            cache[key][fp, fs] = q
            cache[key + "_s"][fp, fs] = s
        else:
            cache[key][fp, fs] = val.to(cache[key].dtype)
    cache["pos"][fp, fs] = wp.reshape(-1).to(torch.int32)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the 2-d matmuls (the weight
    products; ``layers.linear`` is ``aten.mm``), recompute the rest, as
    JAX's ``dots_with_no_batch_dims_saveable``."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _slice_leaf(v, key):
    """``v[key]`` of one stacked leaf: a tensor, a PackedWeight (``int``
    key: :meth:`PackedWeight.take`; slice: :meth:`PackedWeight.prefix`),
    an int8-store ``{"q", "s"}`` pair, or a dict of such (a mamba block's
    ``"mamba"`` weights or cache entry), leaf by leaf (views, no copy)."""
    if isinstance(v, PackedWeight):
        return v.take(key) if isinstance(key, int) else v.prefix(key.stop)
    if is_int8_leaf(v):
        return {"q": v["q"][key], "s": v["s"][key]}
    if isinstance(v, dict):
        return {k: _slice_leaf(x, key) for k, x in v.items()}
    return v[key]


def _repeat(tree: Dict[str, Any], r: int) -> Dict[str, Any]:
    """Repeat ``r`` of a dict of stacked leaves (views)."""
    return {k: _slice_leaf(v, r) for k, v in tree.items()}


class LM:
    """Stateless model object: config + init / forward functions."""

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        # the port-only fields of api.HybridLMConfig / SharedMoECfg, at
        # their neutral values for every other preset
        self._emb_mult = getattr(cfg, "embedding_multiplier", 1.0)
        self._res_mult = getattr(cfg, "residual_multiplier", 1.0)
        am = getattr(cfg, "attention_multiplier", None)
        # K1 / K4 scale scores by 1 / sqrt(hd): q pre-scaled by am sqrt(hd)
        self._q_scale = None if am is None else am * math.sqrt(cfg.hdim)
        self._logit_div = getattr(cfg, "logits_scaling", 1.0)
        self._shared_ff = getattr(cfg.moe, "shared_d_ff", 0)

    # ------------------------------------------------------------------ init
    def init(self, generator=0, device: backend.DeviceLike = None,
             dtype: torch.dtype = torch.float32):
        """Random parameters from the reference's distributions
        (``normal / sqrt(fan_in)``, zero norms).  ``generator`` is a
        ``torch.Generator`` on ``device`` or an int seed.  The numbers
        differ from ``jax.random``'s; tests that compare the packages carry
        the reference's parameters across with ``interop.params_from_numpy``.
        Every leaf is drawn in fp32 and then cast to ``dtype`` (fp32 or
        bf16), norms included, as the reference's ``init(rng, dtype)``.
        Runs on the card unless ``device`` says otherwise; on the ``meta``
        device it allocates nothing (shapes for the dry run,
        ``launch/specs.py``)."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported parameter dtype {dtype}: "
                             "torch.float32 or torch.bfloat16")
        device = backend.resolve_device(device)
        cfg = self.cfg
        if device.type == "meta":
            g = None
        elif isinstance(generator, torch.Generator):
            g = generator
        else:
            g = backend.make_generator(generator, device)
        R, d, hd = cfg.n_repeat, cfg.d_model, cfg.hdim

        def lin(fan_in, *shape):
            return torch.randn(shape, generator=g, device=device,
                               dtype=torch.float32) / math.sqrt(fan_in)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        blocks = []
        for bdef in cfg.pattern:
            p = {"norm": zeros(R, d)}
            if bdef.kind in ("attn", "local_attn", "cross_attn"):
                p.update(wq=lin(d, R, d, cfg.n_heads * hd),
                         wk=lin(d, R, d, cfg.n_kv_heads * hd),
                         wv=lin(d, R, d, cfg.n_kv_heads * hd),
                         wo=lin(cfg.n_heads * hd, R, cfg.n_heads * hd, d))
            elif bdef.kind == "mamba":
                p["mamba"] = ssm_mod.init_mamba_params(
                    lambda fan_in, *s: lin(fan_in, R, *s),
                    lambda *s: zeros(R, *s), d, cfg.ssm)
            else:
                raise ValueError(bdef.kind)
            if bdef.has_ffn and bdef.use_moe:
                m = cfg.moe
                ep = m.n_experts_phys
                p.update(ffn_norm=zeros(R, d),
                         router=lin(d, R, d, m.n_experts),
                         wg=lin(d, R, ep, d, m.d_ff),
                         wu=lin(d, R, ep, d, m.d_ff),
                         wd=lin(m.d_ff, R, ep, m.d_ff, d))
                if self._shared_ff:
                    sf = self._shared_ff
                    p["shared"] = {"wg": lin(d, R, d, sf),
                                   "wu": lin(d, R, d, sf),
                                   "wd": lin(sf, R, sf, d)}
            elif bdef.has_ffn:
                p.update(ffn_norm=zeros(R, d), wg=lin(d, R, d, cfg.d_ff),
                         wu=lin(d, R, d, cfg.d_ff),
                         wd=lin(cfg.d_ff, R, cfg.d_ff, d))
            blocks.append(p)
        params = {"blocks": tuple(blocks), "final_norm": zeros(d),
                  "unembed": lin(d, d, cfg.vocab_padded)}
        if cfg.frontend != "audio_stub":
            params["embed"] = lin(d, cfg.vocab_padded, d)
        if dtype == torch.float32:
            return params

        def cast(node):
            if isinstance(node, dict):
                return {k: cast(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return tuple(cast(v) for v in node)
            return node.to(dtype)
        return cast(params)

    # ---------------------------------------------------------------- blocks
    def _cross_block(self, bp, x, *, q_pos, mode, cache, img_embeds,
                     act_bits=None, attn_impl=None):
        """Cross-attention + residual: the queries attend every image
        token, non-causal and without RoPE (every key at position 0, as in
        the reference).  Outside decode, K / V come from ``img_embeds``
        (B, n_img, d) and are attended as computed (in fp32; the reference
        does not round them through the cache's dtype here), and a given
        ``cache`` (the ``"memory"`` entry) is written whole, in place; at
        decode they are read from the cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
        h = maybe_quant_act(rmsnorm(x, bp["norm"], cfg.norm_eps), act_bits)
        q = split_heads(linear(h, bp["wq"]), Hq, hd)
        if mode == "decode":
            k, v = _kv_deq(cache, "k"), _kv_deq(cache, "v")
        else:
            Si = img_embeds.shape[1]
            k = split_heads(linear(img_embeds, bp["wk"]), Hkv, hd)
            v = split_heads(linear(img_embeds, bp["wv"]), Hkv, hd)
            if cache is not None:
                _kv_store_full(cache, k, v)
        kv_pos = torch.zeros(k.shape[:2], dtype=torch.int32, device=k.device)
        chunk = k.shape[1] if S == 1 else 1024
        out = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=False,
                        attn_cap=cfg.attn_softcap, chunk=chunk,
                        impl=attn_impl)
        return x + self._branch(linear(merge_heads(out), bp["wo"],
                                       role="w_row"))

    def _branch(self, out):
        """A residual branch's output, times ``residual_multiplier``."""
        return out if self._res_mult == 1.0 else out * self._res_mult

    def _attn_block(self, bp, bdef: BlockDef, x, *, q_pos, mode, cache,
                    write_pos=None, act_bits=None, attn_impl=None,
                    layout=None):
        """Self-attention + residual over the dense cache, or, given
        ``layout`` (a paged step's :class:`layers.StepLayout`, x its rows),
        over the paged pool: each row's tokens are written through its own
        table, then the queries go to K4 on the layout's grid, causal by
        each token's own position, and come back to the rows."""
        cfg = self.cfg
        B, S, _ = x.shape
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
        h = rmsnorm(x, bp["norm"], cfg.norm_eps)
        h = maybe_quant_act(h, act_bits)
        window = cfg.window if bdef.kind == "local_attn" else None
        q = split_heads(linear(h, bp["wq"]), Hq, hd)
        k = split_heads(linear(h, bp["wk"]), Hkv, hd)
        if cfg.rope_theta is None:                       # NoPE
            q, k = q.contiguous(), k.contiguous()
        else:
            q, k = rope(q, q_pos, cfg.rope_theta), rope(k, q_pos,
                                                        cfg.rope_theta)
        if self._q_scale is not None:
            q = q * self._q_scale
        v = split_heads(linear(h, bp["wv"]), Hkv, hd).contiguous()
        kv_pos = q_pos
        if layout is not None:
            _kv_write_paged(cache, k, v, q_pos, layout.row_tables)
            out = layout.gather(paged_attention(
                layout.scatter(q), cache["k"], cache["v"], cache["pos"],
                layout.tables, q_pos=layout.pos, window=window,
                attn_cap=cfg.attn_softcap, k_scale_pages=cache.get("k_s"),
                v_scale_pages=cache.get("v_s"), impl=attn_impl))
            return x + self._branch(linear(merge_heads(out), bp["wo"],
                                           role="w_row"))
        if cache is not None:
            W = cache["k"].shape[1]
            if mode == "decode":
                slot = write_pos % W if bdef.kind == "local_attn" \
                    else write_pos
                _kv_write(cache, k, v, q_pos, slot)
                k, v = _kv_deq(cache, "k"), _kv_deq(cache, "v")
                kv_pos = cache["pos"]
            else:  # prefill: write the last W positions, ring-aligned
                kw, vw, pw = k, v, q_pos
                if W < S:
                    # position p sits at ring slot p % W, so decode's write
                    # at write_pos % W evicts exactly the oldest position
                    sh = (S - W) % W
                    kw = torch.roll(k[:, -W:], sh, dims=1)
                    vw = torch.roll(v[:, -W:], sh, dims=1)
                    pw = torch.roll(q_pos[:, -W:], sh, dims=1)
                _kv_write(cache, kw, vw, pw, 0)
                if cache["k"].dtype == torch.int8:
                    # prompt tokens attend the int8 round trip of the
                    # in-flight K/V: the values decode reads back
                    kq, ks = _kv_quant(k)
                    k = kq.to(torch.float32) * ks[..., None]
                    vq, vs = _kv_quant(v)
                    v = vq.to(torch.float32) * vs[..., None]
                elif cache["k"].dtype != k.dtype:
                    # a narrow float cache (bf16): attend its round trip,
                    # the values the chunked paged path reads back, so
                    # run() == generate() whatever the cache dtype
                    k = k.to(cache["k"].dtype).to(k.dtype)
                    v = v.to(cache["v"].dtype).to(v.dtype)
        chunk = k.shape[1] if S == 1 else 1024
        out = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                        window=window, attn_cap=cfg.attn_softcap, chunk=chunk,
                        impl=attn_impl)
        return x + self._branch(linear(merge_heads(out), bp["wo"],
                                       role="w_row"))

    def _ffn(self, bp, bdef: BlockDef, x, act_bits=None):
        """FFN + residual.  Returns (x, aux): the MoE load-balance term
        ``E * sum(mean(probs)^2)`` of the reference's ``_ffn``, or None for
        a dense FFN.  A shared expert's SwiGLU adds to the routed
        experts' output."""
        cfg = self.cfg
        h = rmsnorm(x, bp["ffn_norm"], cfg.norm_eps)
        if bdef.use_moe:
            m = cfg.moe
            out, probs = moe_ffn(h, bp, n_experts=m.n_experts, top_k=m.top_k,
                                 capacity_factor=m.capacity_factor,
                                 act_bits=act_bits,
                                 local_dispatch=m.local_dispatch)
            if self._shared_ff:
                out = out + swiglu(h, bp["shared"], act_bits=act_bits)
            frac = probs.mean(dim=0)
            return x + self._branch(out), m.n_experts * torch.sum(frac * frac)
        return x + self._branch(swiglu(h, bp, act_bits=act_bits)), None

    def _mamba_block(self, bp, x, *, mode, cache, act_bits=None,
                     widen_conv=None, layout=None):
        """Mamba2 block + residual: the full forward (``cache`` None), a
        prefill that fills ``cache``, one decode step (``mode`` "decode")
        over it, or, given a ``layout`` with a slot map (a token-budget
        step, x its rows), ``ssm.mamba_step``: grid row r reads slot
        ``slot_map[r]``'s state and window and writes them back there.
        A layout without one (paged decode) takes the decode step over
        every lane of the batch; idle lanes update state that nothing
        reads.  The cache's planes are written in place: the prefill's
        state and its conv window cast to the planes' dtypes, as the
        reference casts them; a decode or token-budget step's window in
        the type it comes back in (``ssm.mamba_decode_step``), as the
        reference's decode returns it: where that is wider than the conv
        plane (a bf16 plane under fp32 activations), ``widen_conv(dtype)``
        widens the stacked plane first and gives this repeat's view of
        it.

        The span ``mamba`` (not annotated) encloses the block, with the
        counts ``rows`` (the rows x columns the scan computes: a layout's
        whole grid, R x w) and ``tokens`` (the real tokens among them whose
        state it advances: every row without a layout, the layout's
        ``real`` where the caller gives it; paged decode's idle lanes only
        the device knows, so it gives none)."""
        cfg = self.cfg
        B, S = x.shape[:2]
        rows, real, slots = (B * S, B * S, None) if layout is None else (
            layout.pos.numel(), layout.real, layout.slot_map)
        counts = {"rows": rows} if real is None else {"rows": rows,
                                                      "tokens": int(real)}
        with spans.span(ssm_mod.MAMBA, annotate=False, **counts):
            h = maybe_quant_act(rmsnorm(x, bp["norm"], cfg.norm_eps),
                                act_bits)
            if slots is not None:
                own = {key: cache[key].index_select(0, slots)
                       for key in ("state", "conv")}
                out, new = ssm_mod.mamba_step(bp["mamba"], h, own, layout,
                                              cfg.ssm, cfg.d_model)
            elif mode == "decode":
                out, new = ssm_mod.mamba_decode_step(bp["mamba"], h, cache,
                                                     cfg.ssm, cfg.d_model)
            else:
                out, new = ssm_mod.mamba_forward(bp["mamba"], h, cfg.ssm,
                                                 cfg.d_model)
            if cache is not None:
                if mode == "decode" and \
                        new["conv"].dtype != cache["conv"].dtype:
                    cache = widen_conv(new["conv"].dtype)
                for key in ("state", "conv"):
                    if slots is None:
                        cache[key].copy_(new[key])
                    else:
                        cache[key].index_copy_(0, slots,
                                               new[key].to(cache[key].dtype))
        return x + self._branch(out)

    def _apply_block(self, bp, bdef: BlockDef, x, *, q_pos, mode, cache,
                     write_pos=None, act_bits=None, attn_impl=None,
                     img_embeds=None, widen_conv=None, layout=None):
        """One block; returns (x, aux) (aux None without an MoE FFN).  A
        cross block reads its dense per-slot ``"memory"`` entry even in a
        paged step (``layout``), as the reference's."""
        if bdef.kind == "mamba":
            x = self._mamba_block(bp, x, mode=mode, cache=cache,
                                  act_bits=act_bits, widen_conv=widen_conv,
                                  layout=layout)
        elif bdef.kind == "cross_attn":
            x = self._cross_block(bp, x, q_pos=q_pos, mode=mode, cache=cache,
                                  img_embeds=img_embeds, act_bits=act_bits,
                                  attn_impl=attn_impl)
        else:
            x = self._attn_block(bp, bdef, x, q_pos=q_pos, mode=mode,
                                 cache=cache, write_pos=write_pos,
                                 act_bits=act_bits, attn_impl=attn_impl,
                                 layout=layout)
        if bdef.has_ffn:
            return self._ffn(bp, bdef, x, act_bits=act_bits)
        return x, None

    def _stack(self, params, x, cache, act_bits, remat=False, **kw):
        """Run every block: loop over the params' repeats (``n_repeat``, or
        a draft prefix's depth), then pattern positions.  ``cache`` None
        runs without one (the full-sequence forward).  ``remat`` (that
        forward only) checkpoints each repeat: True saves nothing inside
        it, ``"dots"`` saves its matmul outputs.  Returns (x, aux): the
        sum of the MoE blocks' load-balance terms, 0.0 without any.

        A decode step widens a mamba entry's conv plane where the window
        comes back wider than it (once, in place of the entry's plane: the
        reference's decode returns the window in the type the cached one
        and the new token promote to, fp32 on an fp32 model or cache, so a
        bf16 plane there holds only the prefill's rounded window and every
        later entry stays fp32; a bf16 model's bf16 plane stays bf16)."""
        cfg = self.cfg

        def widen(entry, r, dtype):
            entry["conv"] = entry["conv"].to(dtype)
            return _repeat(entry, r)

        def one_repeat(x, r):
            aux = []
            for p_idx, bdef in enumerate(cfg.pattern):
                ab = None if act_bits is None else float(act_bits[r][p_idx])
                entry = None if cache is None else cache[p_idx]
                x, a = self._apply_block(
                    _repeat(params["blocks"][p_idx], r), bdef, x,
                    cache=None if entry is None else _repeat(entry, r),
                    act_bits=ab, widen_conv=functools.partial(widen, entry, r),
                    **kw)
                x = constrain(x, "hidden")
                if a is not None:
                    aux.append(a)
            return x, aux

        ctx = {}
        if remat == "dots":
            ctx["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        total = 0.0
        for r in range(params["blocks"][0]["norm"].shape[0]):
            x, aux = checkpoint(one_repeat, x, r, use_reentrant=False,
                                **ctx) if remat else one_repeat(x, r)
            for a in aux:
                total = total + a
        return x, total

    # --------------------------------------------------------------- helpers
    def _embed(self, params, batch):
        """The stack's input: ``batch["embeds"]`` (B, S, d) for the audio
        front end, else the embedding rows of ``batch["tokens"]``."""
        if self.cfg.frontend == "audio_stub":
            return constrain(batch["embeds"], "hidden")
        return constrain(self._embed_tokens(params, batch["tokens"].long()),
                         "hidden")

    def _embed_tokens(self, params, tokens):
        """Embedding rows of ``tokens``: an int8-store embedding is a row
        gather times the row scale (plain PyTorch: the reference runs no
        kernel there); a dense one a lookup through
        :func:`layers.gather_rows` (deterministic backward)."""
        emb = params["embed"]
        if is_int8_leaf(emb):
            x = emb["q"][tokens].to(emb["s"].dtype) * emb["s"][tokens]
        else:
            x = gather_rows(emb, tokens)
        return x if self._emb_mult == 1.0 else x * self._emb_mult

    def logits_of(self, params, x):
        cfg = self.cfg
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        lg = constrain(linear(x, params["unembed"]), "logits")
        if self._logit_div != 1.0:
            lg = lg / self._logit_div
        lg = softcap(lg, cfg.logit_softcap)
        if cfg.vocab_padded != cfg.vocab:   # mask padded vocab entries
            valid = torch.arange(cfg.vocab_padded, device=lg.device) < cfg.vocab
            lg = torch.where(valid, lg, torch.full_like(lg, -1e30))
        return lg

    # ------------------------------------------------- int8 serving weights
    def quantize_params_int8(self, params):
        """Deployment transform of the reference: every matmul weight ->
        ``{"q": int8, "s": f32}``.  Scales are per output channel (last
        axis), reduced over the contraction axis (``ndim - 2``), so a
        stacked leaf keeps its leading (repeat, expert) dims in both; the
        embedding gets per-row scales.  Norms and other leaves stay as
        they are.  The forward contracts the stored bytes on K2
        (``layers.linear``, ``layers.expert_linear``) and gathers the
        embedding's rows times their scale."""

        def one(name, w):
            if name not in MATMUL_LEAVES or not isinstance(w, torch.Tensor) \
                    or w.ndim < 2 or w.dtype == torch.int8:
                return w
            red = 1 if name == "embed" else w.ndim - 2
            wf = w.to(torch.float32)
            amax = wf.abs().amax(dim=red, keepdim=True)
            s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
            return {"q": q, "s": s.to(torch.float32)}

        def walk(node, name=None):
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(walk(v) for v in node)
            return one(name, node)

        return walk(params)

    def apply(self, params, batch, act_bits=None, attn_impl=None,
              remat=False):
        """Full-sequence forward of ``batch["tokens"]`` (B, S) (or
        ``batch["embeds"]`` (B, S, d) for the audio front end; cross blocks
        attend ``batch["img_embeds"]`` (B, n_img, d)), causal, no cache.
        Returns (logits (B, S, V), aux_loss): the MoE blocks'
        load-balance terms summed, 0.0 for dense FFNs, as the reference's
        ``apply``.  act_bits: optional
        (n_repeat, len(pattern)) activation QBNs on the host; attn_impl:
        layers.ATTN_IMPLS; remat: False, True or ``"dots"``
        (:meth:`_stack`).  Differentiable: the gradients of the embedding
        and of the MoE dispatch and gather are summed deterministically
        (:func:`layers.gather_rows`)."""
        x = self._embed(params, batch)
        B, S, _ = x.shape
        q_pos = torch.arange(S, dtype=torch.int32,
                             device=x.device).repeat(B, 1)
        x, aux = self._stack(params, x, None, act_bits, remat=remat,
                             q_pos=q_pos, mode="train", attn_impl=attn_impl,
                             img_embeds=batch.get("img_embeds"))
        return self.logits_of(params, x), aux

    def loss(self, params, batch, act_bits=None, remat=False):
        """Mean next-token NLL over the positions with ``labels >= 0``,
        plus ``0.01 * aux``, as the reference's ``loss``.  Attention runs
        the plain version (``attn_impl`` "ref", the reference's own choice
        for its loss: neither package has an attention backward)."""
        logits, aux = self.apply(params, batch, act_bits=act_bits,
                                 remat=remat)
        labels = batch["labels"].long()
        lf = at_least_f32(logits)
        lse = torch.logsumexp(lf, dim=-1)
        gold = settle(torch.gather(lf, -1, torch.clamp(labels, min=0)[
            ..., None]))[..., 0]
        mask = (labels >= 0).to(lf.dtype)
        nll = torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(),
                                                           min=1.0)
        return nll + 0.01 * aux

    # ---------------------------------------------------------------- caches
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   kv_bits: Optional[int] = None,
                   device: backend.DeviceLike = None):
        """Per-pattern-position cache dicts with leading dim n_repeat:
        ``k``/``v`` (R, B, W, Hkv, hd) in ``dtype`` (the reference's
        default, bf16; or fp32), ``pos`` (R, B, W) int32 starting at the
        sentinel, and with ``kv_bits=8`` (which wins over ``dtype``) int8
        K/V plus ``k_s``/``v_s`` (R, B, W, Hkv) f32 scales.  ``W`` is
        ``max_len``, or the window for ``local_attn`` blocks.  A mamba
        block's entry is its recurrent state (``ssm.init_mamba_cache``:
        ``state`` fp32, ``conv`` in ``dtype``); a cross block's the image
        memory, ``k``/``v`` (R, B, n_img_tokens, Hkv, hd) in the K/V type
        (with the scales under ``kv_bits=8``) and no ``pos``.  Runs on the
        card unless ``device`` says otherwise."""
        device = backend.resolve_device(device)
        cfg = self.cfg
        kv_dt = _kv_dtype(dtype, kv_bits)
        R, Hkv, hd = cfg.n_repeat, cfg.n_kv_heads, cfg.hdim
        caches = []
        for bdef in cfg.pattern:
            if bdef.kind == "mamba":
                caches.append(ssm_mod.init_mamba_cache(
                    batch, cfg.d_model, cfg.ssm, dtype, (R,), device))
                continue
            if bdef.kind == "cross_attn":
                W = cfg.n_img_tokens
            elif bdef.kind != "local_attn" or cfg.window is None:
                W = max_len
            else:
                W = min(max_len, cfg.window)
            one = {
                "k": torch.zeros((R, batch, W, Hkv, hd), dtype=kv_dt,
                                 device=device),
                "v": torch.zeros((R, batch, W, Hkv, hd), dtype=kv_dt,
                                 device=device),
            }
            if bdef.kind != "cross_attn":
                one["pos"] = torch.full((R, batch, W), POS_SENTINEL,
                                        dtype=torch.int32, device=device)
            if kv_bits == 8:
                one["k_s"] = torch.ones((R, batch, W, Hkv),
                                        dtype=torch.float32, device=device)
                one["v_s"] = torch.ones((R, batch, W, Hkv),
                                        dtype=torch.float32, device=device)
            caches.append(one)
        return tuple(caches)

    def init_paged_cache(self, n_slots: int, num_pages: int, page_size: int,
                         dtype: torch.dtype = torch.bfloat16,
                         kv_bits: Optional[int] = None,
                         n_repeat: Optional[int] = None,
                         device: backend.DeviceLike = None):
        """Paged decode cache for the continuous-batching engine, per
        pattern position, keyed by ``cfg.cache_kinds()``: a ``"paged"``
        (attention) entry is a pool of ``k``/``v``
        (R, P, page_size, Hkv, hd) in ``dtype`` (bf16 by default, as the
        reference's; or fp32), or int8 with ``kv_bits=8`` plus
        ``k_s``/``v_s`` (R, P, page_size, Hkv) f32 per-(slot, head)
        scales, and ``pos`` (R, P, page_size) int32 starting at the
        sentinel, page 0 the trash page; a ``"state"`` (mamba) entry is
        the dense recurrent state with batch axis ``n_slots`` (one lane
        per scheduler slot), as :meth:`init_cache` builds it; a
        ``"memory"`` (cross) entry the dense image memory ``k``/``v``
        (R, n_slots, n_img_tokens, Hkv, hd) in ``dtype`` whatever
        ``kv_bits`` is, as the reference's (``paged_kv.write_prefill``
        therefore refuses an int8 dense memory).
        ``n_repeat`` overrides the stack depth.  Runs on the card unless
        ``device`` says otherwise."""
        device = backend.resolve_device(device)
        cfg = self.cfg
        R = cfg.n_repeat if n_repeat is None else n_repeat
        if not 1 <= R <= cfg.n_repeat:
            raise ValueError(f"n_repeat override {R} outside 1.."
                             f"{cfg.n_repeat}")
        kv_dt = _kv_dtype(dtype, kv_bits)
        shape = (R, num_pages, page_size, cfg.n_kv_heads, cfg.hdim)
        caches = []
        for bdef in cfg.pattern:
            if bdef.kind == "mamba":
                caches.append(ssm_mod.init_mamba_cache(
                    n_slots, cfg.d_model, cfg.ssm, dtype, (R,), device))
                continue
            if bdef.kind == "cross_attn":
                mem = (R, n_slots, cfg.n_img_tokens, cfg.n_kv_heads,
                       cfg.hdim)
                mem_dt = _kv_dtype(dtype, None)
                caches.append({key: torch.zeros(mem, dtype=mem_dt,
                                                device=device)
                               for key in ("k", "v")})
                continue
            one = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
                   "v": torch.zeros(shape, dtype=kv_dt, device=device),
                   "pos": torch.full(shape[:3], POS_SENTINEL,
                                     dtype=torch.int32, device=device)}
            if kv_bits == 8:
                one["k_s"] = torch.ones(shape[:4], dtype=torch.float32,
                                        device=device)
                one["v_s"] = torch.ones(shape[:4], dtype=torch.float32,
                                        device=device)
            caches.append(one)
        return tuple(caches)

    # -------------------------------------------------- draft-prefix view
    def draft_prefix_params(self, params, draft_layers: int):
        """Shallow self-draft view: the first ``draft_layers`` pattern
        repeats of ``params``, sharing embed, final_norm and unembed, as the
        reference's.  Every stacked leaf of ``params["blocks"]`` is sliced
        ``[:draft_layers]`` (a ``PackedWeight`` through
        :meth:`PackedWeight.prefix`, an int8-store leaf both halves):
        views, no copy.  The entry points run
        it against a cache stacked to the same depth
        (``init_paged_cache(n_repeat=draft_layers)``); with
        ``draft_layers == n_repeat`` the draft is the target."""
        if not 1 <= draft_layers <= self.cfg.n_repeat:
            raise ValueError(
                f"draft_layers={draft_layers} outside 1..{self.cfg.n_repeat}"
                f" (cfg.n_repeat)")
        blocks = tuple({k: _slice_leaf(v, slice(0, draft_layers))
                        for k, v in bp.items()} for bp in params["blocks"])
        return {**params, "blocks": blocks}

    # ------------------------------------------------------------ prefill
    def prefill(self, params, batch, cache, act_bits=None, attn_impl=None):
        """Run the prompt ``batch["tokens"]`` (B, S) (``batch["embeds"]``
        for the audio front end; cross blocks take ``batch["img_embeds"]``
        and write their memory), fill ``cache`` in place, return
        (last-token logits (B, 1, V), cache).  act_bits: optional
        (n_repeat, len(pattern)) activation QBNs; attn_impl:
        layers.ATTN_IMPLS."""
        x = self._embed(params, batch)
        B, S, _ = x.shape
        q_pos = torch.arange(S, dtype=torch.int32,
                             device=x.device).repeat(B, 1)
        x, _ = self._stack(params, x, cache, act_bits, q_pos=q_pos,
                           mode="prefill", attn_impl=attn_impl,
                           img_embeds=batch.get("img_embeds"))
        return self.logits_of(params, x[:, -1:, :]), cache

    # ------------------------------------------------------------- decode
    def decode_step(self, params, tokens, cache, pos: int, act_bits=None,
                    attn_impl=None):
        """One decode step.  tokens: (B, 1) int (for the audio front end,
        (B, 1, d) frame embeddings); pos: the int position the tokens
        occupy.  Updates ``cache`` in place; returns (logits (B, 1, V),
        cache)."""
        x = tokens if self.cfg.frontend == "audio_stub" else \
            self._embed_tokens(params, tokens.long())
        x = constrain(x, "hidden")
        B = x.shape[0]
        q_pos = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
        x, _ = self._stack(params, x, cache, act_bits, q_pos=q_pos,
                           mode="decode", write_pos=int(pos),
                           attn_impl=attn_impl)
        return self.logits_of(params, x), cache

    # ------------------------------------------------------ paged decode
    def decode_step_paged(self, params, tokens, cache, block_tables, pos,
                          act_bits=None, attn_impl=None):
        """One decode step over the paged pool at per-sequence positions.
        tokens: (B, 1) int; block_tables: (B, nb) int32; pos: (B,) int32,
        the position each sequence's token occupies (``POS_SENTINEL`` for
        idle lanes, whose writes land in the trash page).  Updates the
        pool in place; returns (logits (B, 1, V), cache)."""
        x = constrain(self._embed_tokens(params, tokens.long()), "hidden")
        layout = StepLayout.of(pos[:, None], block_tables)
        x, _ = self._stack(params, x, cache, act_bits, q_pos=layout.pos,
                           mode="decode", layout=layout, attn_impl=attn_impl)
        return self.logits_of(params, x), cache

    # ------------------------------------------- unified token-budget step
    def step_layout(self, positions: np.ndarray, slot_map: np.ndarray,
                    tables: np.ndarray) -> StepLayout:
        """The :class:`layers.StepLayout` of an (R, w) token-budget step on
        the host, for :meth:`model_step`: ``positions`` (int32,
        ``POS_SENTINEL`` on padded cells), ``slot_map`` (R,) the rows'
        slots, ``tables`` (n_slots, nb) the slots' block tables; ``real``
        counts the real cells.  Its cells: every real cell, then the first
        sentinel cells up to the rung of :func:`compact_rows` that holds
        them; the whole grid where that rung is not below R x w, and for a
        capacity-limited MoE, whose padded tokens count toward capacity in
        the reference."""
        pos = np.asarray(positions)
        keep = pos.reshape(-1) != POS_SENTINEL
        n = int(keep.sum())
        rows = compact_rows(n)
        m = self.cfg.moe
        capped = m is not None and m.capacity_factor > 0 and any(
            b.has_ffn and b.use_moe for b in self.cfg.pattern)
        cells = None
        if rows < keep.size and not capped:
            keep[np.flatnonzero(~keep)[:rows - n]] = True
            cells = np.flatnonzero(keep).astype(np.int64)
        slots = np.asarray(slot_map, np.int64)
        return StepLayout(pos, np.asarray(tables)[slots], slots, cells, n)

    def model_step(self, params, tokens, layout, cache, logit_cols,
                   act_bits=None, attn_impl=None):
        """One token-budget step: prompt chunks and decode tokens together.

        Row r of the (R, k) grid of ``layout`` (:meth:`step_layout`'s,
        uploaded) carries slot ``slot_map[r]``'s tokens this step: a
        prompt chunk of up to k tokens, one decode token, or nothing; real
        tokens are left-aligned in ascending position order and padded
        columns carry ``POS_SENTINEL``.  K/V go straight into block-table
        pages (in place); a mamba block's ``"state"`` entry is read and
        written back at slot ``slot_map[r]`` (in place), its scan
        advancing over the row's real tokens alone, from zeros where the
        row's first column is position 0 (``ssm.mamba_step``).
        tokens: (R, k) int; logit_cols: (R,) -- each row's last real
        column, returns (R, 1, V) -- or (R, C), one logits row per listed
        column, returns (R, C, V).  Every row-wise operation (the
        embedding, norms, projections, RoPE, mamba's gate, the router, the
        experts, the residual adds) runs on the layout's rows, its cells
        or its whole grid.  On the CPU a real cell gets the same bits
        either way; on the card K2 / K3 do too, while cuBLAS's dense
        products (the router, mamba's ``w_dt``) round otherwise at another
        row count.

        Returns (logits, cache).  The pattern's cache kinds must be
        ``"paged"`` or ``"state"``: a cross-attention ``"memory"`` entry,
        which the reference's all-paged step refuses too, raises."""
        kinds = self.cfg.cache_kinds()
        if any(kd not in ("paged", "state") for kd in kinds):
            raise ValueError(
                "model_step takes all-paged patterns and recurrent state "
                f"beside them; got cache kinds {kinds} -- a cross-attention "
                "memory is written at prefill: drive LM.prefill / "
                "decode_step_paged")
        x = self._embed_tokens(params, layout.gather(tokens).long())
        x, _ = self._stack(params, constrain(x, "hidden"), cache, act_bits,
                           q_pos=layout.gather(layout.pos), mode="decode",
                           layout=layout, attn_impl=attn_impl)
        return self.logits_of(params, layout.logit_rows(x, logit_cols)), cache

    # -------------------------------------------------- activation QBNs
    def block_act_bits(self, graph: QuantizableGraph, values,
                       default: float = None) -> np.ndarray:
        """Collapse per-graph-site activation QBNs onto the per-(repeat,
        pattern position) hook, as the reference does: the first site of
        position ``p`` (its ``wq``) wins, positions without a site get
        ``default`` (FULL_BITS pass-through).  Returns an
        (n_repeat, len(pattern)) float32 array."""
        if default is None:
            default = float(FULL_BITS)
        site_pos = [int(l.name[1:].split(".")[0])
                    if l.name.startswith("p") else -1 for l in graph.layers]
        row = []
        for p in range(len(self.cfg.pattern)):
            cand = [v for sp, v in zip(site_pos, values) if sp == p]
            row.append(float(cand[0]) if cand else float(default))
        return np.tile(np.asarray(row, np.float32)[None, :],
                       (self.cfg.n_repeat, 1))

    # ------------------------------------------------------- quant graph
    def graph(self, seq_len: int, batch: int,
              max_groups: int = 64) -> QuantizableGraph:
        """Quantizable-layer graph (weights of every matmul site), one
        LayerInfo per (pattern position, site) shared across the repeat
        stack, as in the reference."""
        cfg = self.cfg
        R = cfg.n_repeat
        toks = seq_len * batch
        layers = []

        def add(name, path, c_in, c_out, macs, numel, axis, kind="linear"):
            layers.append(LayerInfo(
                name=name, kind=kind, c_in=c_in, c_out=c_out, k=1, stride=1,
                macs=float(macs), numel=int(numel), param_path=path,
                channel_axis=axis, n_groups=min(max_groups, c_out)))

        d, hd = cfg.d_model, cfg.hdim
        for p_idx, bdef in enumerate(cfg.pattern):
            pre, nm = ("blocks", p_idx), f"p{p_idx}"
            if bdef.kind in ("attn", "local_attn", "cross_attn"):
                qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
                add(f"{nm}.wq", pre + ("wq",), d, qd, R * toks * d * qd,
                    R * d * qd, -1)
                kv_toks = cfg.n_img_tokens * batch \
                    if bdef.kind == "cross_attn" else toks
                add(f"{nm}.wk", pre + ("wk",), d, kvd, R * kv_toks * d * kvd,
                    R * d * kvd, -1)
                add(f"{nm}.wv", pre + ("wv",), d, kvd, R * kv_toks * d * kvd,
                    R * d * kvd, -1)
                add(f"{nm}.wo", pre + ("wo",), qd, d, R * toks * qd * d,
                    R * qd * d, -1)
            elif bdef.kind == "mamba":
                s = cfg.ssm
                di = s.d_inner(d)
                add(f"{nm}.w_xz", pre + ("mamba", "w_xz"), d, 2 * di,
                    R * toks * d * 2 * di, R * d * 2 * di, -1)
                add(f"{nm}.w_bc", pre + ("mamba", "w_bc"), d, 2 * s.d_state,
                    R * toks * d * 2 * s.d_state, R * d * 2 * s.d_state, -1)
                add(f"{nm}.w_out", pre + ("mamba", "w_out"), di, d,
                    R * toks * di * d, R * di * d, -1)
            else:
                raise ValueError(bdef.kind)
            if bdef.has_ffn and bdef.use_moe:
                m = cfg.moe
                eff_toks = toks * m.top_k / m.n_experts
                for site, cin, cout in (("wg", d, m.d_ff), ("wu", d, m.d_ff),
                                        ("wd", m.d_ff, d)):
                    add(f"{nm}.{site}", pre + (site,), cin, cout,
                        R * m.n_experts * eff_toks * cin * cout,
                        R * m.n_experts * cin * cout, -1, kind="expert")
                sf = self._shared_ff
                for site, cin, cout in (("wg", d, sf), ("wu", d, sf),
                                        ("wd", sf, d)) if sf else ():
                    add(f"{nm}.shared.{site}", pre + ("shared", site), cin,
                        cout, R * toks * cin * cout, R * cin * cout, -1)
            elif bdef.has_ffn:
                add(f"{nm}.wg", pre + ("wg",), d, cfg.d_ff,
                    R * toks * d * cfg.d_ff, R * d * cfg.d_ff, -1)
                add(f"{nm}.wu", pre + ("wu",), d, cfg.d_ff,
                    R * toks * d * cfg.d_ff, R * d * cfg.d_ff, -1)
                add(f"{nm}.wd", pre + ("wd",), cfg.d_ff, d,
                    R * toks * cfg.d_ff * d, R * cfg.d_ff * d, -1)
        add("unembed", ("unembed",), d, cfg.vocab_padded,
            toks * d * cfg.vocab_padded, d * cfg.vocab_padded, -1,
            kind="unembed")
        return QuantizableGraph(layers=layers)
