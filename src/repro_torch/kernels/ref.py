"""Plain PyTorch versions of the GEMM and fake-quant kernels (port of
``repro/kernels/ref.py``).

The wrappers in ``quant_matmul.py`` / ``packed_matmul.py`` /
``binary_matmul.py`` / ``fake_quant.py`` run these for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.  The
GEMM versions scale the weight *before* the dot, as the reference oracle
does, while the kernels scale the finished accumulator (or fold the sign
planes into one weight), so the two agree to allclose and not bit for bit
(ROADMAP.md section C).  :func:`fake_quant_ref` and its kernel agree bit
for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pack import unpack_sub8
from repro_torch.quant.linear_quant import FULL_BITS


def quant_matmul_ref(x: torch.Tensor, qw: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x: (M, K) f32; qw: (K, N) int8; scale: (N,) f32 per out channel."""
    w = qw.to(torch.float32) * scale[None, :].to(torch.float32)
    return (x.to(torch.float32) @ w).to(x.dtype)


def packed_matmul_ref(x: torch.Tensor, pw: torch.Tensor, scale: torch.Tensor,
                      store_bits: int) -> torch.Tensor:
    """Unpack (kernels.pack format) then :func:`quant_matmul_ref`.
    x: (M, K); pw: (ceil(K/f), N) int8 packed along K; scale: (N,) f32."""
    q = unpack_sub8(pw, store_bits, k=x.shape[1], axis=0)
    return quant_matmul_ref(x, q, scale)


def binary_matmul_ref(x: torch.Tensor, planes: torch.Tensor,
                      alpha: torch.Tensor) -> torch.Tensor:
    """Bit-plane matmul: y = sum_p alpha_p * (x @ B_p).
    x: (M, K); planes: (P, K, N) int8 in {-1, +1}; alpha: (P, N) f32."""
    xf = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], planes.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for p in range(planes.shape[0]):
        acc = acc + (xf @ planes[p].to(torch.float32)) * \
            alpha[p][None, :].to(torch.float32)
    return acc.to(x.dtype)


def fake_quant_ref(x: torch.Tensor, scale: torch.Tensor,
                   levels: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-channel quantize-dequantize with precomputed scales.
    x: (M, N); scale, levels, bits: (N,).  bits <= 0.5 prunes; bits >=
    quant.linear_quant.FULL_BITS passes through."""
    xf = x.to(torch.float32)
    s = scale[None, :].to(torch.float32)
    lv = levels[None, :].to(torch.float32)
    b = bits[None, :].to(torch.float32)
    q = torch.clamp(torch.round(xf / s), -lv, lv) * s
    out = torch.where(b <= 0.5, torch.zeros_like(q),
                      torch.where(b >= FULL_BITS, xf, q))
    return out.to(x.dtype)
