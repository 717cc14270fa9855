"""Kernel K3: sub-byte packed weight GEMM,
``y = x @ (unpack(pw) * scale[None, :])`` for int4 or int2 packed along K.

Port of ``repro/kernels/packed_matmul.py::packed_matmul_pallas`` as a CUDA
C++ kernel (``csrc/packed_matmul.cu``, shared GEMM in
``csrc/gemm_tiles.cuh``): it reads only packed bytes and unpacks them in
registers, on TF32 tensor cores for M > 8 as K2 does
(``quant_matmul.route``), and over groups of rows with their offsets
(:func:`packed_matmul_grouped`) as K2's :func:`quant_matmul_grouped`.  The
wrappers run the plain version (``ref.packed_matmul_ref``) for CPU tensors
and the kernel for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pack import SUB8_FACTORS
from repro_torch.kernels.quant_matmul import (check_gemm, check_grouped,
                                              grouped_ref, launch_gemm,
                                              launch_grouped)

COUNT = build.LaunchCount("packed_matmul")


@functools.lru_cache(maxsize=None)
def _fn():
    return build.bind("packed_matmul", "packed_matmul_fwd", 4, 7)


@functools.lru_cache(maxsize=None)
def _grouped_fn():
    return build.bind("packed_matmul", "packed_matmul_grouped_fwd", 5, 6)


def _factor(store_bits: int) -> int:
    if store_bits not in SUB8_FACTORS:
        raise ValueError(f"store_bits must be 2 or 4, got {store_bits}")
    return SUB8_FACTORS[store_bits]


def packed_matmul(x: torch.Tensor, pw: torch.Tensor, scale: torch.Tensor, *,
                  store_bits: int) -> torch.Tensor:
    """x (M, K) f32 or bf16; pw (ceil(K/f), N) int8 with f = 8 /
    store_bits; scale (N,) f32 -> (M, N) in x's dtype; or an expert
    stack, a leading E on all three, in one launch."""
    build.refuse_dtensor("packed_matmul", x, pw, scale)
    check_gemm(x, pw, scale, rows=-(-x.shape[-1] // _factor(store_bits)))
    if x.device.type == "cpu":
        return ref.packed_matmul_ref(x, pw, scale, store_bits)
    if x.device.type != "cuda":
        raise ValueError(f"packed_matmul: no kernel for {x.device}")
    return launch_gemm(_fn(), COUNT, x, pw, scale, pw.shape[-2], store_bits)


def packed_matmul_grouped(x: torch.Tensor, pw: torch.Tensor,
                          scale: torch.Tensor, offsets: torch.Tensor,
                          cap: int, *, store_bits: int) -> torch.Tensor:
    """G groups of rows back to back, each against its own expert: x (P,
    K) f32 or bf16, group e in rows ``offsets[e]:offsets[e + 1]``; pw (G,
    ceil(K/f), N) int8; scale (G, N) f32; offsets (G + 1,) int32 on x's
    device; ``cap`` the most rows a group holds -> (P, N) in x's dtype, in
    one tensor-core launch, as ``quant_matmul.quant_matmul_grouped``."""
    build.refuse_dtensor("packed_matmul", x, pw, scale, offsets)
    check_grouped(x, pw, scale, offsets,
                  rows=-(-x.shape[-1] // _factor(store_bits)), cap=cap)
    if x.device.type == "cpu":
        return grouped_ref(
            lambda xb, w, s: ref.packed_matmul_ref(xb, w, s, store_bits),
            x, offsets, cap, pw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"packed_matmul: no kernel for {x.device}")
    return launch_grouped(_grouped_fn(), COUNT, x, pw, scale, offsets,
                          store_bits)
