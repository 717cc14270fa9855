"""Plain PyTorch versions of the GEMM kernels (port of ``repro/kernels/ref.py``).

The wrappers in ``quant_matmul.py`` / ``packed_matmul.py`` run these for
CPU tensors; ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  They scale the weight *before* the dot, as the reference oracle
does, while the kernels scale the finished accumulator, so the two agree
to allclose and not bit for bit (ROADMAP.md section C).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pack import unpack_sub8


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
