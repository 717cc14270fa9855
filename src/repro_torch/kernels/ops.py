"""Public kernel entry points (port of ``repro/kernels/ops.py``).

:func:`packed_mixed_matmul` is the serving contraction a searched
mixed-QBN policy compiles to.  On the tensor-core route (more than
``SKINNY_M`` rows, or grouped) a store without a bf16 ``full`` bucket is
one launch (``packed_matmul.mixed_matmul``) that computes every bucket and
writes the policy's channel order, pruned channels zero.  Otherwise: one
launch per non-empty bucket (K3 for int2 / int4, K2 for int8, each on x as
it is, fp32 or bf16), a plain matmul for the bf16 ``full`` bucket,
implicit zeros for pruned channels, and the per-bucket outputs scattered
back into the policy's channel order.  An MoE expert stack takes the same
launches, each for all its experts at once, over a capacity buffer or,
grouped, over the rows routed to each expert alone.  The reference pads
every operand to its block grid here; the CUDA kernels mask their ragged
edges themselves, so nothing is padded: :func:`binary_matmul` (B6) and
:func:`fake_quant_channels` (B5) are their kernels' wrappers as they are.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.binary_matmul import binary_matmul
from repro_torch.kernels.fake_quant import fake_quant_channels
from repro_torch.kernels.pack import STORE_BITS, PackedWeight
from repro_torch.kernels.packed_matmul import (mixed_applies, mixed_matmul,
                                               packed_matmul,
                                               packed_matmul_grouped)
from repro_torch.kernels.quant_matmul import (grouped_ref, quant_matmul,
                                              quant_matmul_grouped)

__all__ = ["quant_matmul", "packed_matmul", "quant_matmul_grouped",
           "packed_matmul_grouped", "packed_mixed_matmul", "bucket_matmul",
           "binary_matmul", "fake_quant_channels"]


def packed_mixed_matmul(x: torch.Tensor, w: PackedWeight,
                        offsets: Optional[torch.Tensor] = None,
                        cap: Optional[int] = None) -> torch.Tensor:
    """y = x @ dequant(w) for a 2-d PackedWeight, x (M, K) f32 or bf16; or
    for an expert stack, x (E, C, K) and a PackedWeight with leading dim
    E, whose experts share one bucket split of the columns (bits are per
    output channel), for all E experts at once.  With ``offsets`` (E + 1,
    int32, on x's device) the stack's call is grouped: x (P, K) holds each
    expert's rows back to back, expert e in rows ``offsets[e]:offsets[e +
    1]``, at most ``cap`` of them; a store with a bf16 ``full`` bucket has
    no grouped launch and is refused.

    On the card, where ``packed_matmul.mixed_applies`` holds (the
    tensor-core route, no ``full`` bucket), the call is one launch for the
    whole store (``mixed_matmul``).  Otherwise each bucket takes one
    launch (``quant_matmul`` / ``packed_matmul``, or their grouped forms),
    written into the channel order by one ``index_copy_`` along the last
    axis.  Both give each output value the same bits.

    The result has the reference's dtype for ``x @ deq(w)``,
    ``promote(x.dtype, w.out_dtype)``: bf16 for a bf16 x against a store
    packed from bf16 weights.  On the card x is cast to that dtype (an
    exact upcast where it differs), K2 and K3 write it, and the bf16
    ``full`` bucket is a plain product in it.  The plain contraction of such a result (CPU tensors) is the
    reference's: the weight dequantized to the store's ``out_dtype``
    first (``PackedWeight.dequant``), then one product accumulated in fp32
    and rounded once; an fp32 result takes the kernels' plain versions
    bucket by bucket."""
    K = x.shape[-1]
    if K != w.k:
        raise ValueError(f"x has K={K}, weight has K={w.k}")
    grouped = offsets is not None
    if grouped and any(name == "full" for name, _ in w.buckets):
        raise ValueError("a grouped call takes int8 / int4 / int2 buckets "
                         "only: this store has a bf16 full bucket")
    od = torch.promote_types(x.dtype, getattr(torch, w.out_dtype))
    if od != torch.float32 and x.device.type == "cpu":
        def plain(xb):
            return (xb.to(torch.float32) @
                    w.dequant().to(torch.float32)).to(od)
        return grouped_ref(plain, x, offsets, cap) if grouped else plain(x)
    x = x.to(od)
    if x.device.type == "cuda" and mixed_applies(w, x.shape[-2], grouped):
        return mixed_matmul(x, w, offsets)
    return bucket_matmul(x, w, offsets, cap)


def bucket_matmul(x: torch.Tensor, w: PackedWeight,
                  offsets: Optional[torch.Tensor] = None,
                  cap: Optional[int] = None) -> torch.Tensor:
    """:func:`packed_mixed_matmul`'s per-bucket path, x already in the
    result's dtype: a zero fill, one K2 / K3 call per bucket (their plain
    versions on CPU tensors), a plain product for a bf16 ``full`` bucket,
    and one ``index_copy_`` per bucket into the channel order."""
    grouped = offsets is not None
    out = torch.zeros(x.shape[:-1] + (w.n,), dtype=x.dtype, device=x.device)
    for (name, _), part in zip(w.buckets, w.parts):
        if name == "pruned":
            continue
        if name == "full":
            y = x @ part[0].to(x.dtype)
        elif name == "int8":
            y = quant_matmul_grouped(x, part[0], part[1], offsets, cap) \
                if grouped else quant_matmul(x, part[0], part[1])
        elif grouped:
            y = packed_matmul_grouped(x, part[0], part[1], offsets, cap,
                                      store_bits=STORE_BITS[name])
        else:
            y = packed_matmul(x, part[0], part[1],
                              store_bits=STORE_BITS[name])
        out.index_copy_(x.ndim - 1, w.index(name), y)
    return out
