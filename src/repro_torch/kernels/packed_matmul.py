"""Kernel K3: sub-byte packed weight GEMM,
``y = x @ (unpack(pw) * scale[None, :])`` for int4 or int2 packed along K.

Port of ``repro/kernels/packed_matmul.py::packed_matmul_pallas`` as a CUDA
C++ kernel (``csrc/packed_matmul.cu``, shared GEMM in
``csrc/gemm_tiles.cuh``): it reads only packed bytes and unpacks them in
registers, on TF32 tensor cores for M > 8 as K2 does
(``quant_matmul.route``).  The wrapper runs the plain version (``ref.packed_matmul_ref``)
for CPU tensors and the kernel for CUDA tensors; there is no fallback
between them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pack import SUB8_FACTORS
from repro_torch.kernels.quant_matmul import check_gemm, launch_gemm

COUNT = build.LaunchCount("packed_matmul")


@functools.lru_cache(maxsize=None)
def _fn():
    return build.bind("packed_matmul", "packed_matmul_f32", 5, 5)


def packed_matmul(x: torch.Tensor, pw: torch.Tensor, scale: torch.Tensor, *,
                  store_bits: int) -> torch.Tensor:
    """x (M, K) f32; pw (ceil(K/f), N) int8 with f = 8 / store_bits;
    scale (N,) f32 -> (M, N) f32."""
    if store_bits not in SUB8_FACTORS:
        raise ValueError(f"store_bits must be 2 or 4, got {store_bits}")
    f = SUB8_FACTORS[store_bits]
    check_gemm(x, pw, scale, rows=-(-x.shape[1] // f))
    if x.device.type == "cpu":
        return ref.packed_matmul_ref(x, pw, scale, store_bits)
    if x.device.type != "cuda":
        raise ValueError(f"packed_matmul: no kernel for {x.device}")
    return launch_gemm(_fn(), COUNT, x, pw, scale, pw.shape[0], store_bits)
