"""Policy evaluators: QuantPolicy -> validation accuracy (%) (port of
``repro/core/evaluate.py``).

The reference jits one evaluation program and feeds it bit vectors as
traced values.  Here an evaluation runs eagerly on the device of the
params it was given, with one host-to-device upload of the policy's bit
vectors (``backend.upload``) and one host sync, when the accuracy is
read.  Weights are quantized through the kernels written for it:

* QUANT: every searched weight is fake-quantized by kernel B5
  (``quant.linear_quant.fake_quant_weight``: B5 on the weight's
  channel-last 2-d view, with the per-channel amax, levels and scale
  computed outside the kernel): bit for bit ``fake_quant_per_channel``.
* BINARIZE, CNN: every searched weight goes to the model in plane form
  (``quant.binarize.fake_binarize_planes``), so its conv (im2col) or fc
  product runs on kernel B6 (``kernels.ops.binary_matmul``).  The LM
  evaluator keeps the dense ``fake_binarize_per_channel`` weight, as the
  reference does.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core.ddpg import tree_leaves
from repro_torch.models.cnn import conv_rows
from repro_torch.quant.apply import get_path, set_path
from repro_torch.quant.binarize import (fake_binarize_per_channel,
                                        fake_binarize_planes)
from repro_torch.quant.linear_quant import fake_quant_weight
from repro_torch.quant.policy import QuantMode, QuantPolicy, QuantizableGraph


def _plane_form(node: dict, key, w, layer, bits) -> dict:
    """The layer's params dict with weight ``key`` replaced by its plane
    form (rows in ``F.unfold`` order for a conv).  The planes are cut from
    the weight in its own layout, as the dense form is, and only then
    reordered into rows."""
    if layer.channel_axis % w.ndim != w.ndim - 1:
        raise ValueError(f"{layer.name}: the plane form needs output "
                         f"channels on the last axis")
    planes, alpha = fake_binarize_planes(w, bits)
    if layer.kind == "conv":
        planes = conv_rows(planes)
    out = {k: v for k, v in node.items() if k != key}
    out.update(planes=planes, alpha=alpha)
    return out


def _quantize_params(params, graph: QuantizableGraph,
                     wbits_list: List[torch.Tensor], mode: QuantMode,
                     planes: bool = False):
    """New params with every searched weight quantized under its
    per-channel bits; ``planes`` hands binarized weights over in plane
    form (a CNN's layers only)."""
    out = params
    for layer, bits in zip(graph.layers, wbits_list):
        path = layer.param_path
        w = get_path(params, path)
        if mode == QuantMode.QUANT:
            out = set_path(out, path,
                            fake_quant_weight(w, bits, layer.channel_axis))
        elif planes:
            out = set_path(out, path[:-1], _plane_form(
                get_path(out, path[:-1]), path[-1], w, layer, bits))
        else:
            out = set_path(out, path, fake_binarize_per_channel(
                w, bits, axis=layer.channel_axis).to(w.dtype))
    return out


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def upload_bits(policy: QuantPolicy, graph: QuantizableGraph,
                device: torch.device):
    """Per-layer weight-bit vectors and the activation bits, uploaded in
    one copy each: (list of (n_channels,) f32 tensors, (n_layers,) f32)."""
    wb = [np.asarray(policy.expand_weight_bits(l), np.float32)
          for l in graph.layers]
    flat = backend.upload(np.concatenate(wb), device)
    ab = backend.upload(np.asarray([policy.act_bits[l.name]
                                    for l in graph.layers], np.float32),
                        device)
    return list(torch.split(flat, [len(w) for w in wb])), ab


def as_given(a):
    """A batch array in the dtype it was given, as the reference's
    ``jnp.asarray`` keeps it (float64 narrowed to float32, as JAX does
    without x64): a bf16 CNN is evaluated on a bf16 batch, never
    upcast."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def make_cnn_evaluator(model, params, graph: QuantizableGraph, val_batch,
                       mode: QuantMode = QuantMode.QUANT
                       ) -> Callable[[QuantPolicy], float]:
    device = _device_of(params)
    names = [l.name for l in graph.layers]
    xb = {k: backend.upload(as_given(val_batch[k]), device)
          for k in ("x", "y")}

    def evaluator(policy: QuantPolicy) -> float:
        wb, ab = upload_bits(policy, graph, device)
        with torch.no_grad():
            qp = _quantize_params(params, graph, wb, mode,
                                  planes=mode == QuantMode.BINARIZE)
            acc = model.accuracy(qp, xb, act_bits=dict(zip(names, ab)))
            return float(acc * 100.0)

    return evaluator


def lm_logits(model, qparams, graph: QuantizableGraph, policy: QuantPolicy,
              batch, attn_impl: str = "cuda") -> torch.Tensor:
    """The LM forward of a quantized params tree under ``policy``'s
    activation QBNs.  The forward takes one scalar per (repeat, pattern
    position) block; graph sites of block p share p's activation QBN
    (``LM.block_act_bits``, the same collapse the serving engine uses).
    Those scalars stay on the host and are filled on the device per block,
    as in serving."""
    act = model.block_act_bits(
        graph, [policy.act_bits[l.name] for l in graph.layers])
    logits, _ = model.apply(qparams, batch, act_bits=act,
                            attn_impl=attn_impl)
    return logits


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Share (%) of labelled positions (label >= 0) whose argmax logit is
    the label, as a 0-d tensor on the logits' device."""
    labels = labels.long()
    mask = labels >= 0
    hits = ((torch.argmax(logits, -1) == labels) & mask).sum()
    return hits / torch.clamp(mask.sum(), min=1) * 100.0


def make_lm_evaluator(model, params, graph: QuantizableGraph, val_batch,
                      mode: QuantMode = QuantMode.QUANT
                      ) -> Callable[[QuantPolicy], float]:
    """Token-prediction accuracy (%) of the quantized LM on a fixed batch
    (:func:`lm_logits`, then :func:`token_accuracy`).  Attention runs on
    kernel K1 (its plain version on the CPU)."""
    device = _device_of(params)
    vb = {k: backend.upload(as_given(v), device)
          for k, v in val_batch.items()}

    def evaluator(policy: QuantPolicy) -> float:
        wb, _ = upload_bits(policy, graph, device)
        with torch.no_grad():
            qp = _quantize_params(params, graph, wb, mode)
            logits = lm_logits(model, qp, graph, policy, vb)
            return float(token_accuracy(logits, vb["labels"]))

    return evaluator
