"""Plain PyTorch reference of granite-4.0-h (``granitemoehybrid``): Mamba-2
and attention layers, each followed by a mixture of experts beside a
shared expert, as IBM publishes the model.

The layers repeat a period (``dims["pattern"]``, ``mamba`` or ``attention``
at each place).  Each layer:

* ``h = q8(rmsnorm(x))``, then the mixer, and ``x += r * mixer(h)``;
* Mamba-2: ``[xi, z] = h W_xz``, ``[B, C] = h W_bc``, ``dt = softplus(h
  W_dt + dt_bias)``; the depthwise causal conv (``d_conv`` taps, with a
  bias) over x, B and C together, then SiLU over all three; ``A =
  -exp(A_log)``; per head the state ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t
  B_t^T`` and ``y_t = S_t C_t + D x_t``, one B / C group; out ``W_out
  rmsnorm(y * silu(z))``;
* attention: causal GQA without positional encoding (NoPE), scores times
  ``attention_multiplier`` (in place of 1 / sqrt(head_dim));
* then ``h = rmsnorm(x)`` and ``x += r * (moe(h) + shared(q8(h)))``: the
  router's logits taken on the unquantized ``h``, its top-k, gates the
  softmax over those k logits (Granite's ``TopKGating``), every routed pair
  kept (dropless), each expert a SwiGLU on the quantized ``h``; the shared
  expert a SwiGLU of its own width on every token.

The embedding times ``embedding_multiplier``, ``r`` the
``residual_multiplier``, the logits divided by ``logits_scaling``.  RMSNorm
scales by ``1 + w``.  ``q8`` is the per-token activation quantizer of
``quant.quant_act``.  The scan is evaluated exactly, in blocks
(``mamba2.ssd``).

Departures from the published model, which the program shares: untied
embedding and unembedding (the same work); random weights (A_log and
dt_bias zero, D one, norms zero) in place of trained ones.

It computes the whole sequence at once, in fp32, with no cache, no
batching and no kernel; it imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.reference.mamba2 import ssd
from bench.reference.quant import quant_act
from bench.reference.transformer import rmsnorm


def _widths(d: Dict):
    s = d["ssm"]
    di = s["expand"] * d["d_model"]
    return di, di // s["head_dim"], s["head_dim"], s["d_state"]


def _mixer_leaves(d: Dict, kind: str, b: tuple, R: int):
    dm, hd = d["d_model"], d["head_dim"]
    if kind == "attention":
        qd, kvd = d["n_heads"] * hd, d["n_kv_heads"] * hd
        return [(b + ("wq",), (R, dm, qd), "normal", dm),
                (b + ("wk",), (R, dm, kvd), "normal", dm),
                (b + ("wv",), (R, dm, kvd), "normal", dm),
                (b + ("wo",), (R, qd, dm), "normal", qd)]
    di, H, _, N = _widths(d)
    K = d["ssm"]["d_conv"]
    m = b + ("mamba",)
    return [(m + ("w_xz",), (R, dm, 2 * di), "normal", dm),
            (m + ("w_bc",), (R, dm, 2 * N), "normal", dm),
            (m + ("w_dt",), (R, dm, H), "normal", dm),
            (m + ("dt_bias",), (R, H), "zeros", 0),
            (m + ("A_log",), (R, H), "zeros", 0),
            (m + ("D",), (R, H), "ones", 0),
            (m + ("conv_w",), (R, K, di + 2 * N), "normal", K),
            (m + ("conv_b",), (R, di + 2 * N), "zeros", 0),
            (m + ("norm_w",), (R, di), "zeros", 0),
            (m + ("w_out",), (R, di, dm), "normal", di)]


def layout(d: Dict) -> List[Tuple[tuple, tuple, str, int]]:
    """Every parameter leaf: (path, shape, init, fan_in), in draw order.
    Place p of the period is ``("blocks", p, ...)``, each leaf stacked over
    the period's repeats."""
    R = d["n_layers"] // len(d["pattern"])
    dm, V = d["d_model"], d["vocab_padded"]
    f = d["moe"]
    E, ff, sf = f["n_experts"], f["d_ff"], f["shared_d_ff"]
    out = []
    for p, kind in enumerate(d["pattern"]):
        b = ("blocks", p)
        out += [(b + ("norm",), (R, dm), "zeros", 0)]
        out += _mixer_leaves(d, kind, b, R)
        out += [(b + ("ffn_norm",), (R, dm), "zeros", 0),
                (b + ("router",), (R, dm, E), "normal", dm),
                (b + ("wg",), (R, E, dm, ff), "normal", dm),
                (b + ("wu",), (R, E, dm, ff), "normal", dm),
                (b + ("wd",), (R, E, ff, dm), "normal", ff),
                (b + ("shared", "wg"), (R, dm, sf), "normal", dm),
                (b + ("shared", "wu"), (R, dm, sf), "normal", dm),
                (b + ("shared", "wd"), (R, sf, dm), "normal", sf)]
    return out + [(("final_norm",), (dm,), "zeros", 0),
                  (("unembed",), (dm, V), "normal", dm),
                  (("embed",), (V, dm), "normal", dm)]


def sites(d: Dict) -> List[Tuple[str, tuple, int]]:
    """The policy's sites: (name, leaf path, output channels)."""
    dm, hd = d["d_model"], d["head_dim"]
    di, _, _, N = _widths(d)
    f = d["moe"]
    out = []
    for p, kind in enumerate(d["pattern"]):
        b, nm = ("blocks", p), f"p{p}"
        if kind == "attention":
            qd, kvd = d["n_heads"] * hd, d["n_kv_heads"] * hd
            out += [(f"{nm}.wq", b + ("wq",), qd),
                    (f"{nm}.wk", b + ("wk",), kvd),
                    (f"{nm}.wv", b + ("wv",), kvd),
                    (f"{nm}.wo", b + ("wo",), dm)]
        else:
            m = b + ("mamba",)
            out += [(f"{nm}.w_xz", m + ("w_xz",), 2 * di),
                    (f"{nm}.w_bc", m + ("w_bc",), 2 * N),
                    (f"{nm}.w_out", m + ("w_out",), dm)]
        out += [(f"{nm}.wg", b + ("wg",), f["d_ff"]),
                (f"{nm}.wu", b + ("wu",), f["d_ff"]),
                (f"{nm}.wd", b + ("wd",), dm),
                (f"{nm}.shared.wg", b + ("shared", "wg"), f["shared_d_ff"]),
                (f"{nm}.shared.wu", b + ("shared", "wu"), f["shared_d_ff"]),
                (f"{nm}.shared.wd", b + ("shared", "wd"), dm)]
    return out + [("unembed", ("unembed",), d["vocab_padded"])]


def attention(q, k, v, scale: float, block: int = 512):
    """Causal GQA over one sequence, no positional encoding: q (S, Hq, D),
    k / v (S, Hkv, D), scores times ``scale``."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(S, Hkv, Hq // Hkv, D) * scale
    out = torch.empty_like(qg)
    for q0 in range(0, S, block):
        q1 = min(q0 + block, S)
        s = torch.einsum("qhgd,shd->hgqs", qg[q0:q1], k[:q1])
        mask = torch.arange(q1, device=q.device)[None, :] > \
            torch.arange(q0, q1, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        out[q0:q1] = torch.einsum("hgqs,shd->qhgd", p, v[:q1])
    return out.reshape(S, Hq, D)


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def granite_gates(logits: torch.Tensor, top_k: int):
    """Granite's top-k gating: the k largest router logits, and the softmax
    over them.  Returns (gates (T, K), experts (T, K))."""
    top_v, top_i = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(top_v, dim=-1), top_i


def moe(h, hq, router, wg, wu, wd, top_k):
    """Dropless top-k MoE of one layer: h (T, d) routes, hq feeds the
    experts; wg / wu (E, d, ff), wd (E, ff, d)."""
    gv, gi = granite_gates(h @ router, top_k)
    out = torch.zeros_like(h)
    for e in range(router.shape[1]):
        rows, slot = torch.nonzero(gi == e, as_tuple=True)
        if rows.numel():
            y = swiglu(hq[rows], wg[e], wu[e], wd[e])
            out.index_add_(0, rows, y * gv[rows, slot][:, None])
    return out


def mamba(m: Dict, r: int, h, d: Dict):
    """The Mamba-2 mixer of repeat ``r`` over h (S, d_model)."""
    di, H, P, N = _widths(d)
    K = d["ssm"]["d_conv"]
    S = h.shape[0]
    xz = h @ m["w_xz"][r]
    z = xz[:, di:]
    xbc = torch.cat([xz[:, :di], h @ m["w_bc"][r]], dim=1)
    xp = torch.cat([xbc.new_zeros((K - 1, xbc.shape[1])), xbc])
    xbc = F.silu(sum(xp[i:i + S] * m["conv_w"][r][i] for i in range(K)) +
                 m["conv_b"][r])
    xh = xbc[:, :di].reshape(S, H, P)
    B, C = xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(h @ m["w_dt"][r] + m["dt_bias"][r])
    A = -torch.exp(m["A_log"][r])
    y = ssd(xh, B, C, dt, A) + m["D"][r][:, None] * xh
    y = rmsnorm(y.reshape(S, di) * F.silu(z), m["norm_w"][r], 1e-5)
    return y @ m["w_out"][r]


@torch.no_grad()
def logits(weights, d: Dict, tokens: torch.Tensor, act_bits,
           rows: Sequence[int]) -> torch.Tensor:
    """fp32 logits (len(rows), vocab_padded) at positions ``rows`` of
    ``tokens`` (S,) int64, on ``weights``' device; ``weights`` dequantized,
    in :func:`layout`'s tree."""
    eps, hd = d["norm_eps"], d["head_dim"]
    mup, f = d["mup"], d["moe"]
    res = mup["residual_multiplier"]
    S = tokens.shape[0]
    x = weights["embed"][tokens] * mup["embedding_multiplier"]
    for r in range(d["n_layers"] // len(d["pattern"])):
        for p, kind in enumerate(d["pattern"]):
            blk = weights["blocks"][p]
            h = quant_act(rmsnorm(x, blk["norm"][r], eps), act_bits)
            if kind == "attention":
                q = (h @ blk["wq"][r]).reshape(S, d["n_heads"], hd)
                k = (h @ blk["wk"][r]).reshape(S, d["n_kv_heads"], hd)
                v = (h @ blk["wv"][r]).reshape(S, d["n_kv_heads"], hd)
                o = attention(q, k, v, mup["attention_multiplier"])
                x = x + res * (o.reshape(S, -1) @ blk["wo"][r])
            else:
                x = x + res * mamba(blk["mamba"], r, h, d)
            h = rmsnorm(x, blk["ffn_norm"][r], eps)
            hq = quant_act(h, act_bits)
            sh = blk["shared"]
            x = x + res * (moe(h, hq, blk["router"][r], blk["wg"][r],
                               blk["wu"][r], blk["wd"][r], f["top_k"]) +
                           swiglu(hq, sh["wg"][r], sh["wu"][r], sh["wd"][r]))
    idx = torch.as_tensor(list(rows), device=x.device, dtype=torch.long)
    lg = rmsnorm(x[idx], weights["final_norm"], eps) @ weights["unembed"]
    lg = lg / mup["logits_scaling"]
    lg[:, d["vocab"]:] = -1e30
    return lg
