"""Kernel B6: bit-plane matmul ``y = sum_p alpha[p, n] * (x @ B_p)`` over
``P <= 8`` sign planes ``B_p`` in {-1, +1}.

Port of ``repro/kernels/binary_matmul.py::binary_matmul_pallas`` as a CUDA
C++ kernel (``csrc/binary_matmul.cu``, entry points ``binary_matmul_f32``
and ``binary_matmul_bf16``: x and y fp32 or bf16, summed in fp32): the
planes are folded once per call into an fp32 weight scratch that this
wrapper allocates, then one pipelined product follows, its tile width
chosen from N.  The binarized CNN evaluator
(``core/evaluate.py``) computes every conv (im2col) and the fc through it.
The wrapper runs the plain version (``ref.binary_matmul_ref``) for CPU
tensors and the kernel for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

COUNT = build.LaunchCount("binary_matmul")
MAX_PLANES = 8      # csrc/binary_matmul.cu: MAX_PLANES
SCRATCH_K, SCRATCH_N = 32, 128   # csrc/binary_matmul.cu: KPAD, WCOLS


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    symbol = {torch.float32: "binary_matmul_f32",
              torch.bfloat16: "binary_matmul_bf16"}[dtype]
    return build.bind("binary_matmul", symbol, 5, 4)


def binary_matmul(x: torch.Tensor, planes: torch.Tensor,
                  alpha: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 or bf16; planes (P, K, N) int8 signs; alpha (P, N) f32
    -> (M, N) in x's dtype, summed in fp32 and rounded once (the reference
    kernel's contract)."""
    build.refuse_dtensor("binary_matmul", x, planes, alpha)
    if isinstance(x, torch.Tensor) and x.dtype not in (torch.float32,
                                                       torch.bfloat16):
        raise ValueError(f"x: the bit-plane kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    build.expect(x, "x", x.dtype, 2, x.device)
    build.expect(planes, "planes", torch.int8, 3, x.device)
    build.expect(alpha, "alpha", torch.float32, 2, x.device)
    P, K, N = planes.shape
    if x.shape[1] != K or tuple(alpha.shape) != (P, N):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)}, alpha {tuple(alpha.shape)}")
    if not 1 <= P <= MAX_PLANES:
        raise ValueError(f"{P} planes; the kernel takes 1 to {MAX_PLANES}")
    if x.device.type == "cpu":
        return ref.binary_matmul_ref(x, planes, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"binary_matmul: no kernel for {x.device}")
    M = x.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    # the folded weight, padded to whole K steps and 128 columns
    w = torch.empty((-(-K // SCRATCH_K) * SCRATCH_K,
                     -(-N // SCRATCH_N) * SCRATCH_N), dtype=torch.float32,
                    device=x.device)
    err = build.launch(_fn(x.dtype), x, x.data_ptr(), planes.data_ptr(),
                       alpha.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N,
                       P)
    COUNT.launches += 1
    build.check(build.load(COUNT.name), err, COUNT.name)
    return y
