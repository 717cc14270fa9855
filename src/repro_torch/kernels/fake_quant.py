"""Kernel B5: per-channel quantize-dequantize of ``x (M, N)`` with
precomputed per-column ``scale``, ``levels`` and ``bits``.

Port of ``repro/kernels/fake_quant.py::fake_quant_pallas`` as a CUDA C++
kernel (``csrc/fake_quant.cu``, entry points ``fake_quant_f32`` and
``fake_quant_bf16``: x and y fp32 or bf16, computed in fp32), bit for bit
its plain version (``ref.fake_quant_ref``).  The search's QUANT evaluators
(``core/evaluate.py``) and QAT's straight-through quantizer
(``quant.linear_quant.ste_fake_quant``) fake-quantize every searched
weight through it, by way of ``quant.linear_quant.fake_quant_weight``.
The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; there is no fallback between them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import FULL_BITS

COUNT = build.LaunchCount("fake_quant")


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    symbol = {torch.float32: "fake_quant_f32",
              torch.bfloat16: "fake_quant_bf16"}[dtype]
    return build.bind("fake_quant", symbol, 5, 2, tail=(ctypes.c_float,))


def fake_quant_channels(x: torch.Tensor, scale: torch.Tensor,
                        levels: torch.Tensor, bits: torch.Tensor
                        ) -> torch.Tensor:
    """x (M, N) f32 or bf16; scale / levels / bits (N,) f32 -> (M, N) in
    x's dtype, computed in fp32 and rounded once (the reference kernel's
    contract).  bits <= 0.5 prunes a column, bits >= ``ref.FULL_BITS``
    (handed to the kernel at every launch) passes it through."""
    build.refuse_dtensor("fake_quant_channels", x, scale, levels, bits)
    if isinstance(x, torch.Tensor) and x.dtype not in (torch.float32,
                                                       torch.bfloat16):
        raise ValueError(f"x: the fake-quant kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    build.expect(x, "x", x.dtype, 2, x.device)
    for t, what in ((scale, "scale"), (levels, "levels"), (bits, "bits")):
        build.expect(t, what, torch.float32, 1, x.device)
        if t.shape[0] != x.shape[1]:
            raise ValueError(f"{what} has {t.shape[0]} entries for "
                             f"{x.shape[1]} columns")
    if x.device.type == "cpu":
        return ref.fake_quant_ref(x, scale, levels, bits)
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant_channels: no kernel for {x.device}")
    M, N = x.shape
    y = torch.empty_like(x)
    if M == 0 or N == 0:
        return y
    err = build.launch(_fn(x.dtype), x, x.data_ptr(), scale.data_ptr(),
                       levels.data_ptr(), bits.data_ptr(), y.data_ptr(), M, N,
                       float(FULL_BITS))
    COUNT.launches += 1
    build.check(build.load(COUNT.name), err, COUNT.name)
    return y
