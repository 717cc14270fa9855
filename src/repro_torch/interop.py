"""Carry the reference package's parameters into the port.

The reference hands its parameters over as numpy arrays
(``jax.tree.map(np.asarray, params)``), which keeps its ``PackedWeight``
nodes with numpy parts.  :func:`params_from_numpy` rebuilds the same tree
with torch tensors on ``device``; a packed node is recognised by its
attributes (``parts``, ``buckets``, ``k``, ``n``, ``out_dtype``), so this
module imports nothing of the reference.
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
