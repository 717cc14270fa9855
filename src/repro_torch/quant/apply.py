"""Apply a QuantPolicy to a parameter tree (port of ``repro/quant/apply.py``,
linear quantization only).

``apply_policy_to_params`` fake-quantizes every searched weight (f32
tensors on the search-time grid); ``apply_policy_packed`` turns every
searched weight into a bucketed sub-byte :class:`PackedWeight`.  Stacked
(n_repeat, K, N) weights quantize with scales reduced over the stack, as in
the reference.  Binarized policies (``QuantMode.BINARIZE``) are not ported
yet (ROADMAP.md A8).
"""
from __future__ import annotations

from typing import Any

from repro_torch.quant.linear_quant import (fake_quant_per_channel,
                                            quant_pack_sub8)
from repro_torch.quant.policy import QuantMode, QuantPolicy, QuantizableGraph


def _get_path(tree: Any, path):
    node = tree
    for key in path:
        node = node[key]
    return node


def _set_path(tree: Any, path, value):
    """Return a copy of ``tree`` with ``tree[path] = value`` (nested dicts
    and tuples; leaves not on the path are shared, not copied)."""
    if not path:
        return value
    key = path[0]
    if isinstance(tree, (tuple, list)):
        items = list(tree)
        items[key] = _set_path(tree[key], path[1:], value)
        return type(tree)(items)
    new = dict(tree)
    new[key] = _set_path(tree[key], path[1:], value)
    return new


def _require_quant(policy: QuantPolicy):
    if policy.mode != QuantMode.QUANT:
        raise NotImplementedError(
            "binarized policies (QuantMode.BINARIZE) are not ported yet: "
            "ROADMAP.md A8")


def apply_policy_to_params(params: Any, graph: QuantizableGraph,
                           policy: QuantPolicy) -> Any:
    """New params tree with every searched weight fake-quantized."""
    _require_quant(policy)
    out = params
    for layer in graph.layers:
        w = _get_path(params, layer.param_path)
        bits = policy.expand_weight_bits(layer)
        out = _set_path(out, layer.param_path,
                        fake_quant_per_channel(w, bits,
                                               axis=layer.channel_axis))
    return out


def apply_policy_packed(params: Any, graph: QuantizableGraph,
                        policy: QuantPolicy) -> Any:
    """New params tree with every searched weight in the packed store:
    QBN <= 4 bit-packed along K, 5..8 int8, > 8 bf16, 0 pruned."""
    _require_quant(policy)
    out = params
    for layer in graph.layers:
        w = _get_path(params, layer.param_path)
        if layer.channel_axis % w.ndim != w.ndim - 1:
            raise ValueError(f"{layer.name}: packed store needs output "
                             "channels last")
        out = _set_path(out, layer.param_path,
                        quant_pack_sub8(w, policy.expand_weight_bits(layer)))
    return out
