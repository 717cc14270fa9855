"""Plain PyTorch reference of a Mamba2 (SSD) decoder LM, as repro_torch
defines the model.

Each layer: ``h = q8(rmsnorm(x))``; ``[xi, z] = h W_xz``; ``xi =
silu(causal depthwise conv(xi) + b)``; ``[B, C] = h W_bc``; ``dt =
softplus(h W_dt + dt_bias)``; ``A = -exp(A_log)``; per head the state
``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T`` and ``y_t = S_t C_t + D x_t``;
``x += W_out rmsnorm(y * silu(z))``.  One B/C group, the conv on x only.
RMSNorm scales by ``1 + w``.  ``q8`` is ``quant.quant_act``.

The scan is evaluated exactly, in blocks of ``CHUNK`` positions: inside a
block as the masked quadratic form, all blocks at once, across blocks
through the carried state (a shorter block than the program's).  The whole sequence runs at
once, with no cache, no batching and no kernel; it imports nothing of the
program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.reference.quant import quant_act
from bench.reference.transformer import rmsnorm

CHUNK = 128


def _shapes(d: Dict):
    di = d["expand"] * d["d_model"]
    return di, di // d["head_dim"], d["head_dim"], d["d_state"]


def layout(d: Dict) -> List[Tuple[tuple, tuple, str, int]]:
    """Every parameter leaf: (path, shape, init, fan_in), in draw order;
    ``D`` starts at one, ``A_log`` and ``dt_bias`` at zero (A = -1)."""
    R, dm, V, K = d["n_layers"], d["d_model"], d["vocab_padded"], d["d_conv"]
    di, H, _, N = _shapes(d)
    m = ("blocks", 0, "mamba")
    return [(("blocks", 0, "norm"), (R, dm), "zeros", 0),
            (m + ("w_xz",), (R, dm, 2 * di), "normal", dm),
            (m + ("w_bc",), (R, dm, 2 * N), "normal", dm),
            (m + ("w_dt",), (R, dm, H), "normal", dm),
            (m + ("dt_bias",), (R, H), "zeros", 0),
            (m + ("A_log",), (R, H), "zeros", 0),
            (m + ("D",), (R, H), "ones", 0),
            (m + ("conv_w",), (R, K, di), "normal", K),
            (m + ("conv_b",), (R, di), "zeros", 0),
            (m + ("norm_w",), (R, di), "zeros", 0),
            (m + ("w_out",), (R, di, dm), "normal", di),
            (("final_norm",), (dm,), "zeros", 0),
            (("unembed",), (dm, V), "normal", dm),
            (("embed",), (V, dm), "normal", dm)]


def sites(d: Dict) -> List[Tuple[str, tuple, int]]:
    di, _, _, N = _shapes(d)
    m = ("blocks", 0, "mamba")
    return [("p0.w_xz", m + ("w_xz",), 2 * di),
            ("p0.w_bc", m + ("w_bc",), 2 * N),
            ("p0.w_out", m + ("w_out",), d["d_model"]),
            ("unembed", ("unembed",), d["vocab_padded"])]


def ssd(x, B, C, dt, A):
    """x (S, H, P), B / C (S, N), dt (S, H), A (H,): y (S, H, P).  Blocks
    of ``CHUNK`` positions (the tail padded with dt = 0, which neither
    decays nor updates the state): each block's own contribution at once
    for all blocks, then the state carried from block to block."""
    S, H, P = x.shape
    N = B.shape[1]
    pad = (-S) % CHUNK
    if pad:
        x, B, C, dt = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                       for t in (x, B, C, dt))
    nc = x.shape[0] // CHUNK
    xc = x.reshape(nc, CHUNK, H, P)
    bc, cc = B.reshape(nc, CHUNK, N), C.reshape(nc, CHUNK, N)
    dc = dt.reshape(nc, CHUNK, H)
    lc = torch.cumsum(dc * A, dim=1)                          # (c, t, H)
    rel = lc[:, :, None, :] - lc[:, None, :, :]               # (c, t, s, H)
    tri = torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                     device=x.device).tril()
    rel = rel.masked_fill(~tri[None, :, :, None], float("-inf"))
    w = torch.exp(rel) * torch.einsum("ctn,csn->cts", cc, bc)[..., None] \
        * dc[:, None, :, :]
    y = torch.einsum("ctsh,cshp->cthp", w, xc)
    # each block's own addition to the state at its end
    dec = torch.exp(lc[:, -1:, :] - lc) * dc                  # (c, s, H)
    upd = torch.einsum("cshp,csn->chpn", dec[..., None] * xc, bc)
    last = torch.exp(lc[:, -1, :])                            # (c, H)
    state = x.new_zeros((H, P, N))
    before = []
    for c in range(nc):
        before.append(state)
        state = state * last[c][:, None, None] + upd[c]
    st = torch.stack(before)                                  # (c, H, P, N)
    y = y + torch.exp(lc)[..., None] * torch.einsum("ctn,chpn->cthp", cc, st)
    return y.reshape(nc * CHUNK, H, P)[:S]


@torch.no_grad()
def logits(weights, d: Dict, tokens: torch.Tensor, act_bits,
           rows: Sequence[int]) -> torch.Tensor:
    """fp32 logits (len(rows), vocab_padded) at positions ``rows`` of
    ``tokens`` (S,) int64; ``weights`` dequantized, in :func:`layout`'s
    tree."""
    blk = weights["blocks"][0]
    m = blk["mamba"]
    eps = d["norm_eps"]
    di, H, P, N = _shapes(d)
    K = d["d_conv"]
    S = tokens.shape[0]
    x = weights["embed"][tokens]
    for r in range(d["n_layers"]):
        h = quant_act(rmsnorm(x, blk["norm"][r], eps), act_bits)
        xz = h @ m["w_xz"][r]
        xi, z = xz[:, :di], xz[:, di:]
        xp = torch.cat([xi.new_zeros((K - 1, di)), xi])
        conv = sum(xp[i:i + S] * m["conv_w"][r][i] for i in range(K))
        xi = F.silu(conv + m["conv_b"][r])
        bc = h @ m["w_bc"][r]
        dt = F.softplus(h @ m["w_dt"][r] + m["dt_bias"][r])
        A = -torch.exp(m["A_log"][r])
        xh = xi.reshape(S, H, P)
        y = ssd(xh, bc[:, :N], bc[:, N:], dt, A) + m["D"][r][:, None] * xh
        y = rmsnorm(y.reshape(S, di) * F.silu(z), m["norm_w"][r], 1e-5)
        x = x + y @ m["w_out"][r]
    idx = torch.as_tensor(list(rows), device=x.device, dtype=torch.long)
    lg = rmsnorm(x[idx], weights["final_norm"], eps) @ weights["unembed"]
    lg[:, d["vocab"]:] = -1e30
    return lg

