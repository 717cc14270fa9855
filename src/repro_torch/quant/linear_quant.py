"""Linear (uniform, symmetric) quantization with per-channel bit-widths.

Port of ``repro/quant/linear_quant.py``.  A weight output channel with QBN
``b`` maps onto the integer grid {-(2^(b-1)-1), ..., 2^(b-1)-1} with a
per-channel scale ``s = amax / (2^(b-1)-1)``; ``b <= 0.5`` prunes the
channel and ``b >= FULL_BITS`` passes it through.  Every step is the same
f32 operation as in the reference (``torch.round`` rounds half to even, as
``jnp.round`` does), so the results are bitwise equal to it.

:func:`fake_quant_weight` is the same per-channel quantizer with its
elementwise pass on kernel B5, and :func:`ste_fake_quant` puts it under
a straight-through gradient for QAT.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fake_quant import fake_quant_channels
# bit-widths at or above this behave as full precision (f32 mantissa)
from repro_torch.kernels.ref import FULL_BITS


def _levels(bits: torch.Tensor) -> torch.Tensor:
    """Number of positive quantization levels for signed symmetric quant."""
    return torch.clamp(torch.pow(2.0, bits - 1.0) - 1.0, min=1.0)


def channel_scale(amax: torch.Tensor, bits: torch.Tensor):
    """The grid of each channel: ``(scale, levels)`` for its ``amax`` and
    QBN, ``scale = amax / levels`` (1 for an all-zero channel)."""
    lv = _levels(bits)
    return torch.where(amax > 0, amax / lv, torch.ones_like(amax)), lv


def _quant_dequant(xf, amax, b):
    scale, lv = channel_scale(amax, b)
    q = torch.clamp(torch.round(xf / scale), -lv, lv) * scale
    return torch.where(b <= 0.5, torch.zeros_like(q),
                       torch.where(b >= FULL_BITS, xf, q))


def fake_quant(x: torch.Tensor, bits, axis: int | None = None) -> torch.Tensor:
    """Quantize-dequantize ``x`` at ``bits`` (scalar or per-channel vector).

    ``axis`` is the channel axis of a per-channel ``bits`` vector (None:
    one scale for the whole tensor)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    b = torch.as_tensor(bits, dtype=torch.float32, device=x.device)
    if axis is None:
        amax = xf.abs().amax()
    else:
        axis = axis % xf.ndim
        red = tuple(d for d in range(xf.ndim) if d != axis)
        amax = xf.abs().amax(dim=red, keepdim=True)
        if b.ndim > 0:
            shape = [1] * xf.ndim
            shape[axis] = xf.shape[axis]
            b = b.reshape(shape)
    return _quant_dequant(xf, amax, b).to(dtype)


def fake_quant_per_channel(w: torch.Tensor, bits_per_channel,
                           axis: int = -1) -> torch.Tensor:
    """Per-output-channel fake quantization (the paper's weight quantizer)."""
    return fake_quant(w, bits_per_channel, axis=axis)


def fake_quant_weight(w: torch.Tensor, bits: torch.Tensor,
                      axis: int = -1) -> torch.Tensor:
    """:func:`fake_quant_per_channel` with the elementwise pass on kernel
    B5 (``kernels.fake_quant.fake_quant_channels``): the channel-last 2-d
    view, amax over its rows, then :func:`channel_scale` in fp32 (for a
    bf16 ``w`` too, as the reference's ``fake_quant``).  ``bits`` is the
    (n_channels,) f32 tensor on ``w``'s device.  The result is in ``w``'s
    dtype, bit for bit :func:`fake_quant_per_channel`; CPU tensors take
    B5's plain version."""
    axis = axis % w.ndim
    wl = w if axis == w.ndim - 1 else torch.movedim(w, axis, -1)
    w2 = wl.reshape(-1, wl.shape[-1]).contiguous()
    amax = w2.abs().amax(dim=0).to(torch.float32)
    scale, lv = channel_scale(amax, bits)
    out = fake_quant_channels(w2, scale, lv, bits).reshape(wl.shape)
    return out if axis == w.ndim - 1 else torch.movedim(out, -1, axis)


class _SteFakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, axis):
        return fake_quant_weight(x, bits, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ste_fake_quant(x: torch.Tensor, bits: torch.Tensor, axis: int
                   ) -> torch.Tensor:
    """Fake quant with a straight-through gradient estimator (the QAT
    forward): :func:`fake_quant_weight` forward, identity backward (the
    gradient passes unchanged, in its own dtype)."""
    return _SteFakeQuant.apply(x, bits, axis)


def fake_quant_per_token(x: torch.Tensor, bits) -> torch.Tensor:
    """Row-wise fake quantization: one dynamic scale per leading-index row,
    amax over the last axis, so a token's result does not depend on what
    else shares the batch.  ``bits`` is a scalar; <= 0.5 prunes and
    >= FULL_BITS passes through, as in :func:`fake_quant`."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # filled on the device: a host scalar copied to the card would sync it
    # at every block of every serving step
    b = torch.full((), float(bits), dtype=torch.float32, device=x.device)
    return _quant_dequant(xf, amax, b).to(dtype)


def quant_pack_int8(w: torch.Tensor, bits, axis: int = -1):
    """Quantize ``w`` to a stored int8 form with per-channel f32 scales:
    channels with QBN in [1, 8] round to int8 on their own grid, QBN 0
    stores zeros, and QBNs above 8 clamp to 8.  Returns ``(q int8, scale,
    eff_bits)``, ``scale`` and ``eff_bits`` shaped to broadcast against
    ``q`` along ``axis`` (the reference's layout)."""
    w = w.to(torch.float32)
    axis = axis % w.ndim
    red = tuple(d for d in range(w.ndim) if d != axis)
    amax = w.abs().amax(dim=red, keepdim=True)
    b = torch.as_tensor(bits, dtype=torch.float32, device=w.device)
    if b.ndim > 0:
        shape = [1] * w.ndim
        shape[axis] = w.shape[axis]
        b = b.reshape(shape)
    b = torch.clamp(b, 0.0, 8.0)
    scale, lv = channel_scale(amax, b)
    q = torch.clamp(torch.round(w / scale), -lv, lv)
    q = torch.where(b <= 0.5, torch.zeros_like(q), q)
    return q.to(torch.int8), scale.to(torch.float32), b


def dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant_pack_int8`: ``q * scale`` in f32."""
    return q.to(torch.float32) * scale


def _bucket_ids(bits: np.ndarray) -> np.ndarray:
    """Vectorised ``kernels.pack.bucket_of_bits``: the index into
    ``pack.BUCKETS`` of every channel's storage bucket."""
    b = np.rint(np.asarray(bits, np.float64))
    return np.select([b <= 0, b <= 2, b <= 4, b <= 8], [0, 1, 2, 3], 4)


def quant_pack_sub8(w: torch.Tensor, bits, axis: int = -1):
    """Quantize ``w (..., K, N)`` into the bucketed sub-byte store.

    Each output channel is routed by its QBN into ``pruned`` (no storage),
    ``int2`` / ``int4`` (packed along K), ``int8`` or ``full`` (bf16).  Each
    channel quantizes on its own grid with ``amax`` reduced over **all**
    leading dims, the repeat stack included, exactly as the reference does,
    so a ``b <= 8`` bucket dequantizes to the fake-quant numerics.  Bucket
    membership is computed with numpy over all channels at once (the
    unembed has 256000 of them).  Returns a
    :class:`repro_torch.kernels.pack.PackedWeight`.
    """
    from repro_torch.kernels.pack import (BUCKETS, STORE_BITS, PackedWeight,
                                          pack_sub8)
    if w.ndim < 2:
        raise ValueError(f"packed store needs a (..., K, N) weight, got "
                         f"{tuple(w.shape)}")
    if axis % w.ndim != w.ndim - 1:
        raise ValueError("packed layout requires output channels on the "
                         "last axis")
    n, k = w.shape[-1], w.shape[-2]
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=tuple(range(w.ndim - 1)))          # (n,)
    b = np.rint(np.broadcast_to(np.asarray(bits, np.float32), (n,))
                ).astype(np.int64)
    ids = _bucket_ids(b)
    parts, buckets = [], []
    for bid, name in enumerate(BUCKETS):
        idx = np.flatnonzero(ids == bid)
        if idx.size == 0:
            continue
        buckets.append((name, tuple(idx.tolist())))
        if name == "pruned":
            # zero-width sentinel keeps the leading (stack) dims observable
            parts.append((torch.zeros(w.shape[:-2] + (k, 0), dtype=torch.int8,
                                      device=w.device),))
            continue
        idx_t = torch.as_tensor(idx, device=w.device)
        cols = wf.index_select(-1, idx_t)
        if name == "full":
            parts.append((cols.to(torch.bfloat16),))
            continue
        sc, lv = channel_scale(amax.index_select(0, idx_t), torch.as_tensor(
            b[idx], dtype=torch.float32, device=w.device))
        q = torch.clamp(torch.round(cols / sc), -lv, lv).to(torch.int32)
        data = q.to(torch.int8) if name == "int8" else \
            pack_sub8(q, STORE_BITS[name], axis=-2)
        scale = sc.expand(w.shape[:-2] + (idx.size,)).contiguous()
        parts.append((data, scale))
    return PackedWeight(parts=tuple(parts), k=k, n=n, buckets=tuple(buckets),
                        out_dtype=str(w.dtype).replace("torch.", ""))
