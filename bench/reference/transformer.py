"""Plain PyTorch reference of a decoder LM of attention blocks with a dense
or a mixture-of-experts SwiGLU FFN, as repro_torch defines the model.

One block a layer: ``x += Wo attn(rope(Wq h), rope(Wk h), Wv h)`` with
``h = q8(rmsnorm(x))``, then ``x += ffn(rmsnorm(x))``.  RMSNorm scales by
``1 + w``.  RoPE rotates the two halves of each head.  Attention is causal
GQA in fp32.  The MoE FFN routes each token by a softmax over the router's
logits (taken on the unquantized ``h``) to its top-k experts: ties go to
the lower expert, the gates are renormalized to sum to one, and no token is
dropped (``capacity_factor`` 0, the configurations' routing).  Each expert
runs SwiGLU on the quantized ``h``.  Logits of the padded vocabulary
entries are -1e30.  ``q8`` is the per-token activation quantizer of
``quant.quant_act``.

Departures from the published models, which the program shares: no
embedding, attention, residual or logit multipliers, untied embeddings,
the program's RMSNorm epsilon.

It computes the whole sequence at once, with no cache, no batching and no
kernel; it imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.reference.quant import quant_act


def layout(d: Dict) -> List[Tuple[tuple, tuple, str, int]]:
    """Every parameter leaf: (path, shape, init, fan_in), in the order the
    weights are drawn.  ``init`` is ``normal`` (N(0, 1) / sqrt(fan_in)),
    ``zeros`` or ``ones``."""
    R, dm, hd = d["n_layers"], d["d_model"], d["head_dim"]
    qd, kvd, V = d["n_heads"] * hd, d["n_kv_heads"] * hd, d["vocab_padded"]
    b = ("blocks", 0)
    out = [(b + ("norm",), (R, dm), "zeros", 0),
           (b + ("wq",), (R, dm, qd), "normal", dm),
           (b + ("wk",), (R, dm, kvd), "normal", dm),
           (b + ("wv",), (R, dm, kvd), "normal", dm),
           (b + ("wo",), (R, qd, dm), "normal", qd),
           (b + ("ffn_norm",), (R, dm), "zeros", 0)]
    f = d["ffn"]
    if f["kind"] == "moe":
        E, ff = f["n_experts"], f["d_ff"]
        out += [(b + ("router",), (R, dm, E), "normal", dm),
                (b + ("wg",), (R, E, dm, ff), "normal", dm),
                (b + ("wu",), (R, E, dm, ff), "normal", dm),
                (b + ("wd",), (R, E, ff, dm), "normal", ff)]
    else:
        ff = f["d_ff"]
        out += [(b + ("wg",), (R, dm, ff), "normal", dm),
                (b + ("wu",), (R, dm, ff), "normal", dm),
                (b + ("wd",), (R, ff, dm), "normal", ff)]
    out += [(("final_norm",), (dm,), "zeros", 0),
            (("unembed",), (dm, V), "normal", dm),
            (("embed",), (V, dm), "normal", dm)]
    return out


def sites(d: Dict) -> List[Tuple[str, tuple, int]]:
    """The policy's sites: (name, leaf path, output channels)."""
    hd = d["head_dim"]
    qd, kvd = d["n_heads"] * hd, d["n_kv_heads"] * hd
    ff, dm = d["ffn"]["d_ff"], d["d_model"]
    b = ("blocks", 0)
    return [("p0.wq", b + ("wq",), qd), ("p0.wk", b + ("wk",), kvd),
            ("p0.wv", b + ("wv",), kvd), ("p0.wo", b + ("wo",), dm),
            ("p0.wg", b + ("wg",), ff), ("p0.wu", b + ("wu",), ff),
            ("p0.wd", b + ("wd",), dm),
            ("unembed", ("unembed",), d["vocab_padded"])]


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x, pos, theta):
    """x (S, H, D), pos (S,) int."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, block: int = 512):
    """Causal GQA over one sequence: q (S, Hq, D), k / v (S, Hkv, D)."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(S, Hkv, G, D) / math.sqrt(D)
    out = torch.empty_like(qg)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        s = torch.einsum("qhgd,shd->hgqs", qg[q0:q1], k[:q1])
        mask = torch.arange(q1, device=q.device)[None, :] > \
            torch.arange(q0, q1, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[q0:q1] = torch.einsum("hgqs,shd->qhgd", p, v[:q1])
    return out.reshape(S, Hq, D)


def moe(h, hq, router, wg, wu, wd, top_k):
    """Dropless top-k MoE of one layer: h (T, d) routes, hq feeds the
    experts; wg / wu (E, d, ff), wd (E, ff, d)."""
    probs = torch.softmax(h @ router, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, gi = order.values[:, :top_k], order.indices[:, :top_k]
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
    out = torch.zeros_like(h)
    for e in range(router.shape[1]):
        rows, slot = torch.nonzero(gi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = hq[rows]
        y = (F.silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e]
        out.index_add_(0, rows, y * gv[rows, slot][:, None])
    return out


@torch.no_grad()
def logits(weights, d: Dict, tokens: torch.Tensor, act_bits,
           rows: Sequence[int]) -> torch.Tensor:
    """fp32 logits (len(rows), vocab_padded) at positions ``rows`` of the
    sequence ``tokens`` (S,) int64, on ``weights``' device.  ``weights``
    holds the dequantized weights in :func:`layout`'s tree."""
    blk = weights["blocks"][0]
    eps, hd = d["norm_eps"], d["head_dim"]
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = weights["embed"][tokens]
    f = d["ffn"]
    for r in range(d["n_layers"]):
        h = quant_act(rmsnorm(x, blk["norm"][r], eps), act_bits)
        q = rope((h @ blk["wq"][r]).reshape(S, d["n_heads"], hd), pos,
                 d["rope_theta"])
        k = rope((h @ blk["wk"][r]).reshape(S, d["n_kv_heads"], hd), pos,
                 d["rope_theta"])
        v = (h @ blk["wv"][r]).reshape(S, d["n_kv_heads"], hd)
        x = x + attention(q, k, v).reshape(S, -1) @ blk["wo"][r]
        h = rmsnorm(x, blk["ffn_norm"][r], eps)
        hq = quant_act(h, act_bits)
        if f["kind"] == "moe":
            x = x + moe(h, hq, blk["router"][r], blk["wg"][r], blk["wu"][r],
                        blk["wd"][r], f["top_k"])
        else:
            x = x + (F.silu(hq @ blk["wg"][r]) * (hq @ blk["wu"][r])) \
                @ blk["wd"][r]
    idx = torch.as_tensor(list(rows), device=x.device, dtype=torch.long)
    lg = rmsnorm(x[idx], weights["final_norm"], eps) @ weights["unembed"]
    lg[:, d["vocab"]:] = -1e30
    return lg
