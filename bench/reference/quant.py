"""Plain PyTorch dequantization of a kernel-wise policy, for the references.

A weight's output channel with QBN ``b`` lies on the symmetric grid
{-(2^(b-1)-1), ..., 2^(b-1)-1} times ``amax / (2^(b-1)-1)``, where ``amax``
is the channel's largest magnitude over every other axis of the stored
tensor (the repeat stack and the experts included).  QBN 0 prunes the
channel; rounding is half to even.  Activations are quantized the same way
per token, over the last axis.

Imports nothing of the program: the grid is worked out again here from the
raw weights and the policy's bits.
"""
from __future__ import annotations

import numpy as np
import torch

FULL_BITS = 24          # a QBN at or above this passes the value through


def channel_bits(group_bits, c_out: int) -> np.ndarray:
    """Per-channel QBNs of a site from its per-group QBNs: each group covers
    ``ceil(c_out / n_groups)`` consecutive channels, the last one fewer."""
    g = np.asarray(group_bits, np.float32)
    reps = int(np.ceil(c_out / g.size))
    return np.repeat(g, reps)[:c_out]


def _levels(bits: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.pow(2.0, bits - 1.0) - 1.0, min=1.0)


@torch.no_grad()
def dequantize_(w: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
    """Quantize-dequantize fp32 ``w`` (..., K, N) in place, channel n at
    QBN ``bits[n]``.  Returns ``w``."""
    b = torch.as_tensor(np.rint(bits), dtype=torch.float32, device=w.device)
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    lv = _levels(b)
    scale = torch.where(amax > 0, amax / lv, torch.ones_like(amax))
    keep = (b > 0.5).to(w.dtype)
    full = b >= FULL_BITS
    if bool(full.any()):
        raise ValueError("a pass-through channel is not a benchmark policy")
    # one leading index at a time keeps the temporaries small
    flat = w.reshape(-1, w.shape[-2], w.shape[-1])
    for i in range(flat.shape[0]):
        blk = flat[i]
        blk.div_(scale).round_()
        blk.copy_(torch.maximum(torch.minimum(blk, lv), -lv))
        blk.mul_(scale * keep)
    return w


def quant_act(x: torch.Tensor, bits) -> torch.Tensor:
    """Per-token (last axis) quantize-dequantize of fp32 ``x``; ``bits``
    None or at or above FULL_BITS passes ``x`` through."""
    if bits is None or float(bits) >= FULL_BITS:
        return x
    b = torch.tensor(float(bits), dtype=torch.float32, device=x.device)
    lv = _levels(b)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / lv, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -lv, lv) * scale
    return q if float(bits) > 0.5 else torch.zeros_like(x)
