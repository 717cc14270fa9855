"""Kernel K2: int8 weight GEMM, ``y = x @ (qw * scale[None, :])``.

Port of ``repro/kernels/quant_matmul.py::quant_matmul_pallas`` as a CUDA
C++ kernel (``csrc/quant_matmul.cu``, shared GEMM in
``csrc/gemm_tiles.cuh``): for M > ``SKINNY_M`` on TF32 tensor cores with
x split into two TF32 parts (fp32 accuracy; :func:`route` names it, and
``ref.quant_matmul_tf32x2_ref`` states its numerics), else a skinny
weight-streaming pass on CUDA cores.  K3 (``packed_matmul.py``) shares
the rule, the launch shapes and :func:`launch_gemm`.  The wrapper runs the plain version
(``ref.quant_matmul_ref``) for CPU tensors and the kernel for CUDA
tensors; there is no fallback between them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

COUNT = build.LaunchCount("quant_matmul")
SKINNY_M = 8      # csrc/gemm_tiles.cuh: M at or below this streams weights


@functools.lru_cache(maxsize=None)
def _fn():
    return build.bind("quant_matmul", "quant_matmul_f32", 5, 4)


def route(M: int, bits: int = 8) -> str:
    """The launch shape that ``launch_gemm``'s kernel takes for M rows of a
    ``bits``-wide weight (8 for K2; 4 or 2 for K3, the same rule):
    ``skinny`` (weight streaming on CUDA cores) for M <= SKINNY_M, else
    ``tc_2xtf32`` (gemm_tc: TF32 tensor cores, x split into two passes;
    int8, int4 and int2 weights are exact in TF32)."""
    return "skinny" if M <= SKINNY_M else "tc_2xtf32"


def ksplit(M: int, rows: int, N: int, device: torch.device) -> int:
    """Packed rows split across blocks for a skinny (small-M) launch, so
    that a narrow N still puts about two blocks on every SM."""
    if M > SKINNY_M:
        return 1
    col_blocks = -(-N // 128)
    return max(1, min(-(-2 * build.sm_count(device) // col_blocks),
                      rows // 64))


def check_gemm(x, w, scale, rows: int):
    """Validate a GEMM call; ``rows`` is the stored K extent of ``w``."""
    build.expect(x, "x", torch.float32, 2, x.device)
    build.expect(w, "weight", torch.int8, 2, x.device)
    build.expect(scale, "scale", torch.float32, 1, x.device)
    if w.shape[0] != rows or scale.shape[0] != w.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, weight "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}")


def launch_gemm(fn, count, x, w, scale, rows, *extra):
    """Allocate, launch ``fn`` on the current stream, count, check."""
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return y
    split = ksplit(M, rows, N, x.device)
    partial = torch.empty((split, M, N), dtype=torch.float32,
                          device=x.device) if split > 1 else y
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), M, K, N, split, *extra,
                 build.stream_of(x))
    count.launches += 1
    build.check(build.load(count.name), err, count.name)
    return y


def quant_matmul(x: torch.Tensor, qw: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32; qw (K, N) int8; scale (N,) f32 -> (M, N) f32."""
    check_gemm(x, qw, scale, rows=x.shape[1])
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, qw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    return launch_gemm(_fn(), COUNT, x, qw, scale, x.shape[1])
