"""Kernel K2: int8 weight GEMM, ``y = x @ (qw * scale[None, :])``.

Port of ``repro/kernels/quant_matmul.py::quant_matmul_pallas`` as a CUDA
C++ kernel (``csrc/quant_matmul.cu``, shared GEMM in
``csrc/gemm_tiles.cuh``): for M > ``SKINNY_M`` on TF32 tensor cores with
x split into two TF32 parts (fp32 accuracy; :func:`route` names it, and
``ref.quant_matmul_tf32x2_ref`` states its numerics), else one
weight-streaming launch on CUDA cores whose K splits are summed inside
the launch (:func:`skinny_splits`; :func:`skinny_cut` states the cut).
K3 (``packed_matmul.py``) shares the rule, the launch shapes and
:func:`launch_gemm`.  An MoE expert stack (x (E, C, K), weight (E, K, N),
scale (E, N)) is one launch for all E experts, routed by the rows ``C``
an expert holds.  :func:`quant_matmul_grouped` takes the rows of each
expert back to back with their offsets instead, on the tensor cores (a
dropless MoE routes each expert a fraction of the C rows its capacity
buffer holds).  The wrappers run the plain version
(``ref.quant_matmul_ref``) for CPU tensors and the kernel for CUDA
tensors; there is no fallback between them.

x is fp32 or bf16, as the reference kernel's, and the output is in x's
dtype (:data:`X_TYPES`).  The kernels accumulate and scale in fp32
either way and round a bf16 output once.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

COUNT = build.LaunchCount("quant_matmul")
SKINNY_M = 8          # csrc/gemm_tiles.cuh: M at or below this streams W
SKINNY_COLS = 128     # gemm_stream: columns a block
SKINNY_CHUNK = 128    # gemm_stream: packed rows a block takes at a time
MAX_SPLITS = 8        # gemm_stream: blocks of a cluster (portable limit)
# element types of x (and y) the kernels take (csrc/quant_matmul.cu: x_type)
X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    return build.bind("quant_matmul", "quant_matmul_fwd", 4, 6)


@functools.lru_cache(maxsize=None)
def _grouped_fn():
    return build.bind("quant_matmul", "quant_matmul_grouped_fwd", 5, 5)


def route(M: int, bits: int = 8, x_dtype=torch.float32) -> str:
    """The launch shape that ``launch_gemm``'s kernel takes for M rows of a
    ``bits``-wide weight (8 for K2; 4 or 2 for K3, the same rule):
    ``skinny`` (weight streaming on CUDA cores) for M <= SKINNY_M, else
    ``tc_2xtf32`` (gemm_tc: TF32 tensor cores, x split into two passes;
    int8, int4 and int2 weights are exact in TF32), or ``tc_1xtf32`` for
    a bf16 x, which is exact in TF32 too (one pass)."""
    if M <= SKINNY_M:
        return "skinny"
    return "tc_1xtf32" if x_dtype == torch.bfloat16 else "tc_2xtf32"


def skinny_splits(rows: int, N: int, n_sm: int, batch: int = 1) -> int:
    """K splits of a skinny (M <= SKINNY_M) launch of ``rows`` packed rows
    by N columns (for each of ``batch`` experts) on a card of ``n_sm``
    SMs, from shapes alone.

    The S splits of a 128-column tile run as one thread-block cluster and
    are summed inside the launch, so S is at most ``MAX_SPLITS``.  Two
    blocks fit an SM (registers), so the splits fill up to two blocks per
    SM and round down: a grid just over that would start a second, nearly
    empty wave.  Each split keeps at least one 128-row chunk (fewer rows
    would cost more in its prologue and the cluster's sum than they save).
    N wide enough to fill the card alone (the unembedding), or an expert
    stack whose column tiles do, takes 1."""
    col_tiles = -(-N // SKINNY_COLS) * batch
    return max(1, min(MAX_SPLITS, (2 * n_sm) // col_tiles,
                      -(-rows // SKINNY_CHUNK)))


def skinny_cut(rows: int, splits: int):
    """The packed rows ``[a, b)`` of each K split, as gemm_stream cuts them:
    ``ceil(rows / splits)`` a split, the last one short."""
    per = -(-rows // splits)
    return [(min(rows, s * per), min(rows, (s + 1) * per))
            for s in range(splits)]


def check_gemm(x, w, scale, rows: int) -> None:
    """Validate a GEMM call, plain (x (M, K), w (rows, N), scale (N,)) or
    expert-batched (a leading E on all three); ``rows`` is the stored K
    extent of ``w``."""
    nd = x.ndim
    if nd not in (2, 3):
        raise ValueError(f"x: expected (M, K) or (E, M, K), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in X_TYPES:
        raise ValueError(f"x: expected float32 or bfloat16, got {x.dtype}")
    build.expect(x, "x", x.dtype, nd, x.device)
    build.expect(w, "weight", torch.int8, nd, x.device)
    build.expect(scale, "scale", torch.float32, nd - 1, x.device)
    if (w.shape[-2] != rows or scale.shape[-1] != w.shape[-1]
            or x.shape[:-2] != w.shape[:-2]
            or scale.shape[:-1] != w.shape[:-2]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, weight "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}")


def launch_gemm(fn, count, x, w, scale, rows, *extra):
    """Allocate y in x's dtype, launch ``fn`` on the current stream
    (one launch for all experts of a batched call), count, check."""
    M, K = x.shape[-2:]
    N = w.shape[-1]
    E = x.shape[0] if x.ndim == 3 else 1
    y = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    shape = route(M, x_dtype=x.dtype)
    skinny = shape == "skinny"
    if skinny and x.dtype == torch.bfloat16 and (K % 2 or x.data_ptr() % 4):
        raise ValueError("bf16 x on the streaming route needs an even K "
                         "and 4-byte aligned data (it is staged in pairs)")
    splits = skinny_splits(rows, N, build.sm_count(x.device), E) \
        if skinny else 1
    err = build.launch(fn, x, x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                       y.data_ptr(), E, M, K, N, splits, *extra,
                       X_TYPES[x.dtype])
    count.add(shape)
    build.check(build.load(count.name), err, count.name)
    return y


def quant_matmul(x: torch.Tensor, qw: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 or bf16; qw (K, N) int8; scale (N,) f32 -> (M, N) in
    x's dtype; or an expert stack, x (E, C, K), qw
    (E, K, N), scale (E, N) -> (E, C, N), in one launch."""
    build.refuse_dtensor("quant_matmul", x, qw, scale)
    check_gemm(x, qw, scale, rows=x.shape[-1])
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, qw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    return launch_gemm(_fn(), COUNT, x, qw, scale, x.shape[-1])


def check_grouped(x, w, scale, offsets, rows: int, cap: int) -> None:
    """Validate a grouped GEMM call: x (P, K), w (G, rows, N), scale (G,
    N), offsets int32 (G + 1,) on x's device.  For CPU tensors the offsets'
    values too: non-decreasing from at least 0, the last at most P, no
    group over ``cap`` rows.  On the card they are not read (that would
    wait for the device); the kernel clamps them into x's rows."""
    if x.ndim != 2:
        raise ValueError(f"x: expected (P, K), got {tuple(x.shape)}")
    if x.dtype not in X_TYPES:
        raise ValueError(f"x: expected float32 or bfloat16, got {x.dtype}")
    build.expect(x, "x", x.dtype, 2, x.device)
    build.expect(w, "weight", torch.int8, 3, x.device)
    build.expect(scale, "scale", torch.float32, 2, x.device)
    build.expect(offsets, "offsets", torch.int32, 1, x.device)
    G, N = w.shape[0], w.shape[-1]
    if w.shape[1] != rows or tuple(scale.shape) != (G, N):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, weight "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}")
    if offsets.shape[0] != G + 1:
        raise ValueError(f"offsets: expected {G + 1} (groups + 1), got "
                         f"{offsets.shape[0]}")
    if x.device.type == "cpu":
        off = offsets.tolist()
        sizes = [b - a for a, b in zip(off, off[1:])]
        if off[0] < 0 or min(sizes) < 0 or off[-1] > x.shape[0]:
            raise ValueError(f"offsets: must rise from >= 0 to <= "
                             f"{x.shape[0]} rows, got {off}")
        if max(sizes) > cap:
            raise ValueError(f"offsets: a group of {max(sizes)} rows, over "
                             f"cap {cap}")


def grouped_ref(plain, x, offsets, cap: int, *weights) -> torch.Tensor:
    """The plain version of a grouped GEMM: each group's rows laid out as
    the expert-batched plain version's batch (G, cap, K), in order from
    the group's first row, zeros below them; ``plain(batch, *weights)``
    called once; each group's rows read back.  The batch is the (E, C, K)
    capacity layout's, so every row gets that call's bits (a CPU matmul's
    bits depend on its shape).  Rows outside every group are zeros."""
    off = offsets.tolist()
    batch = x.new_zeros((len(off) - 1, cap, x.shape[1]))
    for e, (a, b) in enumerate(zip(off, off[1:])):
        batch[e, :b - a] = x[a:b]
    yb = plain(batch, *weights)
    y = yb.new_zeros((x.shape[0], yb.shape[-1]))
    for e, (a, b) in enumerate(zip(off, off[1:])):
        y[a:b] = yb[e, :b - a]
    return y


def launch_grouped(fn, count, x, w, scale, offsets, *extra):
    """Allocate y (P, N) in x's dtype, launch ``fn`` for every group on
    the current stream (one launch), count it under the tensor-core route
    a bf16 or fp32 x takes, check."""
    P, K = x.shape
    G, N = w.shape[0], w.shape[-1]
    y = torch.empty((P, N), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    err = build.launch(fn, x, x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                       y.data_ptr(), offsets.data_ptr(), G, P, K, N, *extra,
                       X_TYPES[x.dtype])
    count.add("grouped_" + route(SKINNY_M + 1, x_dtype=x.dtype))
    build.check(build.load(count.name), err, count.name)
    return y


def quant_matmul_grouped(x: torch.Tensor, qw: torch.Tensor,
                         scale: torch.Tensor, offsets: torch.Tensor,
                         cap: int) -> torch.Tensor:
    """G groups of rows back to back, each against its own expert: x (P,
    K) f32 or bf16, group e in rows ``offsets[e]:offsets[e + 1]``; qw (G,
    K, N) int8; scale (G, N) f32; offsets (G + 1,) int32 on x's device;
    ``cap`` the most rows a group holds (the capacity layout's C) -> (P,
    N) in x's dtype, in one tensor-core launch.  Each row gets the bits
    that :func:`quant_matmul` gives it in an (E, C, K) stack with C over
    ``SKINNY_M``; rows outside every group are left as they are on the
    card (uninitialised) and zero on the CPU."""
    build.refuse_dtensor("quant_matmul", x, qw, scale, offsets)
    check_grouped(x, qw, scale, offsets, rows=x.shape[-1], cap=cap)
    if x.device.type == "cpu":
        return grouped_ref(ref.quant_matmul_ref, x, offsets, cap, qw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    return launch_grouped(_grouped_fn(), COUNT, x, qw, scale, offsets)
