"""Quantization-aware fine-tuning of the best-explored policy (port of
``repro/train/qat.py``; paper: "After the network quantization and
binarization policy search is done, the best-explored model is fine-tuned
to obtain the best inference accuracy").

Weights pass through the straight-through fake quantizer
(``quant.linear_quant.ste_fake_quant``: kernel B5 on the card) at the
policy's per-channel bit-widths every forward; activations quantize at
the policy's per-layer bits, with the plain quantizer's own gradient, as
in the reference.  Gradients flow to the latent full-precision weights.
The policy's bits go to the device once, when the loss is made.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch import backend
from repro_torch.core.ddpg import tree_leaves
from repro_torch.core.evaluate import upload_bits
from repro_torch.optim import AdamW
from repro_torch.quant.apply import get_path, set_path
from repro_torch.quant.linear_quant import ste_fake_quant
from repro_torch.quant.policy import QuantPolicy, QuantizableGraph
from repro_torch.train.loop import upload_batch, value_and_grad


def make_qat_loss(model, graph: QuantizableGraph, policy: QuantPolicy,
                  base_loss_kwargs: Dict | None = None,
                  device: backend.DeviceLike = None) -> Callable:
    """``loss(params, batch)`` of the model under ``policy``, its bits on
    ``device`` (the card when None)."""
    wbits, ab = upload_bits(policy, graph, backend.resolve_device(device))
    act_ctx = dict(zip((l.name for l in graph.layers), ab))
    kw = base_loss_kwargs or {}

    def loss(params, batch):
        qp = params
        for layer, bits in zip(graph.layers, wbits):
            w = get_path(params, layer.param_path)
            qp = set_path(qp, layer.param_path,
                          ste_fake_quant(w, bits, layer.channel_axis))
        return model.loss(qp, batch, act_bits=act_ctx, **kw)

    return loss


def qat_finetune(model, params, graph, policy, data_fn, steps: int = 50,
                 lr: float = 3e-4):
    """Returns fine-tuned params (latent fp weights), on the params'
    device."""
    device = tree_leaves(params)[0].device
    loss_fn = make_qat_loss(model, graph, policy, device=device)
    opt = AdamW(lr=lr, grad_clip=1.0)
    state = opt.init(params)
    for i in range(steps):
        batch = upload_batch(data_fn(i), device)
        _, g = value_and_grad(loss_fn, params, batch)
        params, state, _ = opt.update(params, g, state)
    return params
