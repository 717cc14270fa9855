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

:func:`mixed_matmul` is the tensor-core launch of a whole mixed-QBN
PackedWeight, its int8 bucket included: one grid over the column tiles of
every bucket (:func:`mixed_table`), each block with its bucket's weight
source, written straight into the policy's channel order.  It has no
plain version of its own: on CPU tensors ``ops.packed_mixed_matmul``
stays bucket by bucket.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pack import STORE_BITS, SUB8_FACTORS, PackedWeight
from repro_torch.kernels.quant_matmul import (SKINNY_M, X_TYPES, check_gemm,
                                              check_grouped, grouped_ref,
                                              launch_gemm, launch_grouped,
                                              route)

COUNT = build.LaunchCount("packed_matmul")
# csrc/gemm_tiles.cuh's MixedStages in order, as (bits, VEC): a part's
# stage id is 1 + its position here; id 0 writes a pruned part's zeros
MIXED_STAGES = ((8, True), (8, False), (4, True), (4, False), (2, True),
                (2, False))
MIXED_PARTS = 4       # gemm_tiles.cuh: pruned, int2, int4, int8
TILE_N = 128          # gemm_tc's column tile (CBN)
_ORDER = ("int8", "int4", "int2", "pruned")     # a mixed launch's parts


@functools.lru_cache(maxsize=None)
def _fn():
    return build.bind("packed_matmul", "packed_matmul_fwd", 4, 7)


@functools.lru_cache(maxsize=None)
def _grouped_fn():
    return build.bind("packed_matmul", "packed_matmul_grouped_fwd", 5, 6)


@functools.lru_cache(maxsize=None)
def _mixed_fn():
    return build.bind("packed_matmul", "packed_mixed_fwd",
                      3 + 3 * MIXED_PARTS, 3 * MIXED_PARTS + 6)


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


@dataclasses.dataclass(frozen=True)
class MixedPart:
    """One part of a :func:`mixed_table`: bucket ``name`` (``bucket``-th of
    the store's buckets) of ``n`` output channels, the column tiles
    ``[tile0, tile0 + tiles)`` of the launch's grid, and its stage id."""
    name: str
    bucket: int
    n: int
    tile0: int
    tiles: int
    stage: int


def stage_id(name: str, data: torch.Tensor) -> int:
    """The stage id of a bucket whose stored weight is ``data`` (..., rows,
    n): 0 for pruned channels (zeros), else 1 + the position in
    MIXED_STAGES of its bits and VEC, the 16-byte copies that
    ``gemm_tiles.cuh::with_stage`` picks where n % 16 == 0 and the data is
    16-byte aligned."""
    if name == "pruned":
        return 0
    vec = data.shape[-1] % 16 == 0 and data.data_ptr() % 16 == 0
    return 1 + MIXED_STAGES.index((STORE_BITS[name], vec))


def mixed_table(w: PackedWeight) -> List[MixedPart]:
    """The parts of ``w`` as one mixed launch (csrc/gemm_tiles.cuh::
    gemm_tc_mixed) covers them: its int8, int4 and int2 buckets, then its
    pruned channels, each in ceil(n / TILE_N) column tiles laid end to end
    from tile 0.  The blocks start in that order, the costliest stage's
    first (more bytes staged a K step), so that a grid of several waves
    ends on its cheap tiles.  A block of tile t computes the part whose
    tiles hold t with that part's stage, and writes its column c to output
    channel ``w.index(name)[c]``; the parts' channels cover the store's
    once.  A bf16 ``full`` bucket has no stage: refused."""
    if any(name == "full" for name, _ in w.buckets):
        raise ValueError("a mixed launch takes int8 / int4 / int2 / pruned "
                         "buckets only: this store has a bf16 full bucket")
    parts, tile = [], 0
    for i in sorted(range(len(w.buckets)),
                    key=lambda i: _ORDER.index(w.buckets[i][0])):
        name, idx = w.buckets[i]
        if not idx:
            continue
        tiles = -(-len(idx) // TILE_N)
        parts.append(MixedPart(name, i, len(idx), tile, tiles,
                               stage_id(name, w.parts[i][0])))
        tile += tiles
    return parts


def mixed_applies(w: PackedWeight, rows: int, grouped: bool) -> bool:
    """Whether ``ops.packed_mixed_matmul`` on the card takes one mixed
    launch for ``w``: its product is on the tensor-core route (grouped, or
    ``rows`` a call or an expert over SKINNY_M) and the store has no bf16
    ``full`` bucket.  Else one K2 / K3 launch a bucket."""
    return (grouped or rows > SKINNY_M) and \
        all(name != "full" for name, _ in w.buckets)


def mixed_matmul(x: torch.Tensor, w: PackedWeight,
                 offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ dequant(w)`` for a whole PackedWeight in one tensor-core
    launch on the card, the output in the policy's channel order and zero
    on pruned channels: x (M, K) f32 or bf16 (the result's dtype); an
    expert stack's x (E, C, K) against a store with leading dim E; or,
    with ``offsets`` ((E + 1,) int32 on x's device), grouped: x (P, K),
    expert e's rows ``offsets[e]:offsets[e + 1]``, rows outside every group
    unspecified.  Each value has the bits that the bucket's own K2 / K3
    launch gives it (``ops.packed_mixed_matmul`` decides the route,
    :func:`mixed_applies`).  Counted once in :data:`COUNT` as
    ``mixed_<route>`` (``grouped_mixed_<route>``)."""
    build.refuse_dtensor("packed_matmul", x, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"packed_matmul: no mixed launch for {x.device}")
    if x.dtype not in X_TYPES:
        raise ValueError(f"x: expected float32 or bfloat16, got {x.dtype}")
    grouped = offsets is not None
    lead = tuple(w.parts[0][0].shape[:-2])
    if grouped:
        if x.ndim != 2 or len(lead) != 1:
            raise ValueError(f"grouped: x (P, K) against an (E, K, N) stack, "
                             f"got x {tuple(x.shape)}, stack {lead}")
        build.expect(offsets, "offsets", torch.int32, 1, x.device)
        if offsets.shape[0] != lead[0] + 1:
            raise ValueError(f"offsets: expected {lead[0] + 1} (groups + 1),"
                             f" got {offsets.shape[0]}")
    elif x.ndim != 2 + len(lead) or tuple(x.shape[:-2]) != lead:
        raise ValueError(f"x {tuple(x.shape)} against a stack of {lead}")
    build.expect(x, "x", x.dtype, x.ndim, x.device)
    M, K = x.shape[-2:]
    if K != w.k:
        raise ValueError(f"x has K={K}, weight has K={w.k}")
    y = torch.empty(x.shape[:-1] + (w.n,), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    table = mixed_table(w)
    ptrs, ints = [], []
    for p in table:
        col = w.index(p.name)
        build.expect(col, "channel index", torch.int64, 1, x.device)
        if p.stage == 0:
            ptrs += [None, None, col.data_ptr()]
        else:
            data, scale = w.parts[p.bucket]
            rows = K if p.name == "int8" else \
                -(-K // _factor(STORE_BITS[p.name]))
            build.expect(data, p.name, torch.int8, len(lead) + 2, x.device)
            build.expect(scale, "scale", torch.float32, len(lead) + 1,
                         x.device)
            if tuple(data.shape) != lead + (rows, p.n) or \
                    tuple(scale.shape) != lead + (p.n,):
                raise ValueError(f"{p.name}: stored {tuple(data.shape)}, "
                                 f"scale {tuple(scale.shape)}")
            ptrs += [data.data_ptr(), scale.data_ptr(), col.data_ptr()]
        ints += [p.n, p.tile0, p.stage]
    pad = MIXED_PARTS - len(table)
    err = build.launch(_mixed_fn(), x, x.data_ptr(), y.data_ptr(),
                       offsets.data_ptr() if grouped else None,
                       *ptrs, *[None] * (3 * pad), *ints, *[0] * (3 * pad),
                       len(table), lead[0] if lead else 1, M, K, w.n,
                       X_TYPES[x.dtype])
    COUNT.add(("grouped_" if grouped else "") + "mixed_" +
              route(SKINNY_M + 1 if grouped else M, x_dtype=x.dtype))
    build.check(build.load(COUNT.name), err, COUNT.name)
    return y
