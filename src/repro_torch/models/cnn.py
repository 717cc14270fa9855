"""The paper's own CNN family (CIF10-7CNN and friends), port of
``repro/models/cnn.py``.

A conv stack with per-output-channel quantization hooks and the
QuantizableGraph extractor the agent searches over (one LayerInfo per
conv / fc layer, group_size = 1: the paper's per-channel regime).  The
public layouts are the reference's: NHWC inputs, HWIO conv weights,
``{"conv<i>": {"w", "b"}, "fc": {"w", "b"}}`` params.  Inside, a conv is
``F.conv2d`` on permuted views (a library op here, as ``lax.conv`` is
there) and the VALID 2x2 max pool is ``F.max_pool2d``.

A layer whose params carry ``{"planes", "alpha", "b"}`` in place of
``{"w", "b"}`` (a binarized weight in plane form,
``quant.binarize.fake_binarize_planes`` of its weight, a conv's planes
in :func:`conv_rows` order) computes its
product through the bit-plane kernel B6 (``kernels.ops.binary_matmul``):
a conv through an im2col (:func:`im2col`: zero padding, then one strided
copy; rows ordered (cin, kh, kw), as ``F.unfold``'s), the fc directly.
Parameters and activations are fp32 or bf16 (``init(dtype=)``): a bf16
model takes a bf16 batch, and every conv, pool and product stays in bf16
(B6 sums in fp32 and writes bf16), as the reference's bf16 CNN does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import backend
from repro_torch.kernels.ops import binary_matmul
from repro_torch.quant.linear_quant import fake_quant
from repro_torch.quant.policy import LayerInfo, QuantizableGraph


def _quant_act(x, bits):
    """Per-tensor activation fake-quant: the paper's CNN regime (one
    dynamic scale per layer activation), as in the reference."""
    if bits is None:
        return x
    return fake_quant(x, bits, axis=None)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    img_size: int = 32
    in_channels: int = 3
    channels: Tuple[int, ...] = (32, 32, 64, 64, 128, 128, 128)  # 7 convs
    pool_after: Tuple[int, ...] = (1, 3, 5)   # maxpool after these conv idxs
    n_classes: int = 10
    kernel: int = 3


CIF10 = CNNConfig(name="cif10_7cnn")
CIF10_TINY = CNNConfig(name="cif10_tiny", img_size=16,
                       channels=(16, 16, 32, 32), pool_after=(1, 3))


def conv_rows(w: torch.Tensor) -> torch.Tensor:
    """An HWIO conv weight as the (cin * kh * kw, cout) matrix whose rows
    follow ``F.unfold``'s patch order (c, kh, kw); leading axes (a stack
    of sign planes) are kept."""
    kh, kw, cin, cout = w.shape[-4:]
    return w.movedim(-2, -4).reshape(*w.shape[:-4], cin * kh * kw, cout)


def im2col(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """The (B * H * W, C * kernel * kernel) patch rows of NHWC ``x`` for a
    SAME, stride-1 conv, each row in (c, kh, kw) order: the rows of
    ``F.unfold(x.permute(0, 3, 1, 2), kernel, padding=kernel // 2)``
    transposed, bit for bit.  A pad, then one copy of a strided window view
    (``F.unfold`` on the card runs one kernel per image)."""
    B, H, W, C = x.shape
    p = kernel // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    win = xp.unfold(1, kernel, 1).unfold(2, kernel, 1)   # (B, H, W, C, kh, kw)
    return win.reshape(B * H * W, C * kernel * kernel)


def _conv(x, p, kernel):
    """SAME 3x3 stride-1 conv of NHWC ``x`` with a dense HWIO weight or a
    plane-form one; returns NHWC before the bias."""
    if "w" in p:
        y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                     padding=kernel // 2)
        return y.permute(0, 2, 3, 1)
    B, H, W, _ = x.shape
    return binary_matmul(im2col(x, kernel), p["planes"],
                         p["alpha"]).reshape(B, H, W, -1)


def _dense(x, p):
    if "w" in p:
        return x @ p["w"]
    return binary_matmul(x.contiguous(), p["planes"], p["alpha"])


class CNN:
    def __init__(self, cfg: CNNConfig):
        self.cfg = cfg

    def init(self, generator=0, device: backend.DeviceLike = None,
             dtype: torch.dtype = torch.float32):
        """Random parameters from the reference's distributions (conv
        ``normal * sqrt(2 / fan_in)``, fc ``normal * sqrt(1 / cin)``, zero
        biases), drawn and scaled in fp32 and then cast to ``dtype`` (fp32
        or bf16), biases too, as the reference's ``init(rng, dtype)``.
        ``generator`` is a ``torch.Generator`` on ``device`` or an int
        seed; the numbers differ from ``jax.random``'s.  Runs on the card
        unless ``device`` says otherwise."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported parameter dtype {dtype}: "
                             "torch.float32 or torch.bfloat16")
        device = backend.resolve_device(device)
        cfg = self.cfg
        g = generator if isinstance(generator, torch.Generator) else \
            backend.make_generator(generator, device)

        def normal(*shape):
            return torch.randn(shape, generator=g, device=device,
                               dtype=torch.float32)

        params = {}
        cin = cfg.in_channels
        for i, cout in enumerate(cfg.channels):
            fan_in = cfg.kernel * cfg.kernel * cin
            params[f"conv{i}"] = {
                "w": (normal(cfg.kernel, cfg.kernel, cin, cout) *
                      math.sqrt(2.0 / fan_in)).to(dtype),
                "b": torch.zeros(cout, device=device, dtype=dtype)}
            cin = cout
        params["fc"] = {"w": (normal(cin, cfg.n_classes) *
                              math.sqrt(1.0 / cin)).to(dtype),
                        "b": torch.zeros(cfg.n_classes, device=device,
                                         dtype=dtype)}
        return params

    def apply(self, params, x, act_bits=None):
        """x: (B, H, W, C).  act_bits: None or dict layer name -> scalar
        (a float or a 0-d tensor on x's device)."""
        cfg = self.cfg

        def ab(name):
            return None if act_bits is None else act_bits.get(name)

        for i in range(len(cfg.channels)):
            x = _quant_act(x, ab(f"conv{i}"))
            p = params[f"conv{i}"]
            x = torch.relu(_conv(x, p, cfg.kernel) + p["b"])
            if i in cfg.pool_after:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        x = x.mean(dim=(1, 2))                       # global average pool
        x = _quant_act(x, ab("fc"))
        return _dense(x, params["fc"]) + params["fc"]["b"]

    def loss(self, params, batch, act_bits=None):
        logits = self.apply(params, batch["x"], act_bits=act_bits)
        labels = batch["y"].long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return torch.mean(lse - gold)

    def accuracy(self, params, batch, act_bits=None):
        logits = self.apply(params, batch["x"], act_bits=act_bits)
        return torch.mean((torch.argmax(logits, -1) ==
                           batch["y"].long()).to(torch.float32))

    def graph(self) -> QuantizableGraph:
        """Per-channel (group_size=1) quantizable graph with MAC counts."""
        cfg = self.cfg
        layers = []
        hw = cfg.img_size
        cin = cfg.in_channels
        for i, cout in enumerate(cfg.channels):
            macs = hw * hw * cfg.kernel * cfg.kernel * cin * cout
            layers.append(LayerInfo(
                name=f"conv{i}", kind="conv", c_in=cin, c_out=cout,
                k=cfg.kernel, stride=1, macs=float(macs),
                numel=cfg.kernel * cfg.kernel * cin * cout,
                param_path=(f"conv{i}", "w"), channel_axis=3, n_groups=cout))
            if i in cfg.pool_after:
                hw //= 2
            cin = cout
        layers.append(LayerInfo(
            name="fc", kind="linear", c_in=cin, c_out=cfg.n_classes, k=1,
            stride=1, macs=float(cin * cfg.n_classes),
            numel=cin * cfg.n_classes, param_path=("fc", "w"),
            channel_axis=1, n_groups=cfg.n_classes))
        return QuantizableGraph(layers=layers)
