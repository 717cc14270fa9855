"""Kernel B5: per-channel quantize-dequantize of ``x (M, N)`` with
precomputed per-column ``scale``, ``levels`` and ``bits``.

Port of ``repro/kernels/fake_quant.py::fake_quant_pallas`` as a CUDA C++
kernel (``csrc/fake_quant.cu``), bit for bit its plain version
(``ref.fake_quant_ref``).  The search's QUANT evaluators
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
def _fn():
    return build.bind("fake_quant", "fake_quant_f32", 5, 2,
                      tail=(ctypes.c_float,))


def fake_quant_channels(x: torch.Tensor, scale: torch.Tensor,
                        levels: torch.Tensor, bits: torch.Tensor
                        ) -> torch.Tensor:
    """x (M, N) f32; scale / levels / bits (N,) f32 -> (M, N) f32.  bits
    <= 0.5 prunes a column, bits >= ``ref.FULL_BITS`` (handed to
    the kernel at every launch) passes it through."""
    build.refuse_dtensor("fake_quant_channels", x, scale, levels, bits)
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        raise NotImplementedError("bf16 inputs to the fake-quant kernel are "
                                  "not ported yet: ROADMAP.md B5")
    build.expect(x, "x", torch.float32, 2, x.device)
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
    err = build.launch(_fn(), x, x.data_ptr(), scale.data_ptr(),
                       levels.data_ptr(), bits.data_ptr(), y.data_ptr(), M, N,
                       float(FULL_BITS))
    COUNT.launches += 1
    build.check(build.load(COUNT.name), err, COUNT.name)
    return y
