"""Carry the reference package's parameters into the port, and back.

The reference hands its parameters over as numpy arrays
(``jax.tree.map(np.asarray, params)``), which keeps its ``PackedWeight``
nodes with numpy parts.  :func:`params_from_numpy` rebuilds the same tree
with torch tensors on ``device``; a packed node is recognised by its
attributes (``parts``, ``buckets``, ``k``, ``n``, ``out_dtype``), so this
module imports nothing of the reference.  Any tree of the same shape
carries over the same way, an AdamW state (int8 ``q``, f32 ``s``, int32
``t`` leaves) included, and so does the uniform int8 store's
``{"q", "s"}`` leaves (``quantize_params_int8``).  :func:`params_to_numpy`
is the inverse.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import backend
from repro_torch.kernels.pack import PackedWeight

_PACKED_ATTRS = ("parts", "buckets", "k", "n", "out_dtype")


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """One numpy array as a tensor on ``device``; bfloat16 (ml_dtypes)
    travels as its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Any, device: backend.DeviceLike = None) -> Any:
    """A reference parameter tree of numpy arrays -> the port's tree on
    ``device`` (the card when None): dicts, tuples and lists keep their
    structure, packed nodes become :class:`PackedWeight`."""
    device = backend.resolve_device(device)

    def conv(node):
        if all(hasattr(node, a) for a in _PACKED_ATTRS):
            parts = tuple(tuple(tensor_from_numpy(a, device) for a in part)
                          for part in node.parts)
            buckets = tuple((name, tuple(int(i) for i in idx))
                            for name, idx in node.buckets)
            return PackedWeight(parts=parts, k=int(node.k), n=int(node.n),
                                buckets=buckets, out_dtype=str(node.out_dtype))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(conv(v) for v in node)
        return tensor_from_numpy(node, device)

    return conv(tree)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a host numpy array; bfloat16 becomes ml_dtypes'
    bfloat16 (the reference's numpy dtype), bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy` for trees of tensors (a
    trained params or optimizer tree): numpy arrays, dicts, tuples and
    lists kept."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tensor_to_numpy(tree)
