"""Apply a QuantPolicy to a parameter tree (port of ``repro/quant/apply.py``).

``apply_policy_to_params`` fake-quantizes (QUANT) or fake-binarizes
(BINARIZE) every searched weight into f32 tensors on the search-time grid;
``apply_policy_packed`` turns every searched weight of a QUANT policy into
a bucketed sub-byte :class:`PackedWeight`; ``quantize_activation`` is the
per-tensor activation hook and ``policy_metrics`` a policy's NetScore
ingredients.  Stacked (n_repeat, K, N)
weights and MoE expert stacks (n_repeat, E, K, N) quantize with one bit
width per output channel, shared by every repeat and expert, and scales
reduced over the stack, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.quant.binarize import fake_binarize_per_channel
from repro_torch.quant.linear_quant import (fake_quant,
                                            fake_quant_per_channel,
                                            quant_pack_sub8)
from repro_torch.quant.policy import QuantMode, QuantPolicy, QuantizableGraph


def get_path(tree: Any, path):
    """``tree[path[0]][path[1]]...`` (a layer's ``param_path``)."""
    node = tree
    for key in path:
        node = node[key]
    return node


def set_path(tree: Any, path, value):
    """Return a copy of ``tree`` with ``tree[path] = value`` (nested dicts
    and tuples; leaves not on the path are shared, not copied)."""
    if not path:
        return value
    key = path[0]
    if isinstance(tree, (tuple, list)):
        items = list(tree)
        items[key] = set_path(tree[key], path[1:], value)
        return type(tree)(items)
    new = dict(tree)
    new[key] = set_path(tree[key], path[1:], value)
    return new


def apply_policy_to_params(params: Any, graph: QuantizableGraph,
                           policy: QuantPolicy) -> Any:
    """New params tree with every searched weight fake-quantized (QUANT)
    or fake-binarized (BINARIZE)."""
    out = params
    for layer in graph.layers:
        w = get_path(params, layer.param_path)
        bits = policy.expand_weight_bits(layer)
        axis = layer.channel_axis
        if policy.mode == QuantMode.QUANT:
            qw = fake_quant_per_channel(w, bits, axis=axis)
        else:
            qw = fake_binarize_per_channel(w, bits, axis=axis).to(w.dtype)
        out = set_path(out, layer.param_path, qw)
    return out


def apply_policy_packed(params: Any, graph: QuantizableGraph,
                        policy: QuantPolicy) -> Any:
    """New params tree with every searched weight in the packed store:
    QBN <= 4 bit-packed along K, 5..8 int8, > 8 bf16, 0 pruned."""
    if policy.mode != QuantMode.QUANT:
        raise ValueError("the packed store implements linear quantization "
                         "(QBN) only")
    out = params
    for layer in graph.layers:
        w = get_path(params, layer.param_path)
        if layer.channel_axis % w.ndim != w.ndim - 1:
            raise ValueError(f"{layer.name}: packed store needs output "
                             "channels last")
        out = set_path(out, layer.param_path,
                        quant_pack_sub8(w, policy.expand_weight_bits(layer)))
    return out


def quantize_activation(x: torch.Tensor, quant_ctx: Dict[str, Any] | None,
                        name: str) -> torch.Tensor:
    """Activation fake-quant hook: ``quant_ctx`` maps a layer name to its
    activation bits; a missing name or a None ctx leaves ``x`` at full
    precision.  Per-tensor (the paper gives one QBN to all activation
    channels of an FC layer)."""
    if quant_ctx is None:
        return x
    bits = quant_ctx.get(name)
    if bits is None:
        return x
    return fake_quant(x, bits, axis=None)


def policy_metrics(graph: QuantizableGraph, policy: QuantPolicy,
                   full_bits: float = 32.0) -> Dict[str, float]:
    """NetScore ingredients for a policy: p(N), m(N) and reduction ratios."""
    logic_full = graph.total_macs * full_bits * full_bits
    logic = policy.logic_ops(graph)
    size_full = graph.total_numel * full_bits
    size = policy.model_size_bits(graph)
    return {
        "avg_weight_bits": policy.avg_weight_bits(graph),
        "avg_act_bits": policy.avg_act_bits(graph),
        "logic_ops": logic,
        "logic_ratio": logic / max(logic_full, 1.0),
        "model_bits": size,
        "size_ratio": size / max(size_full, 1.0),
        "p": policy.avg_weight_bits(graph) / full_bits,
        "m": logic,
    }
