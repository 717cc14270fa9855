# Copied from src/repro/quant/policy.py unchanged.
"""Quantization policy containers and the quantizable-layer graph.

A :class:`QuantizableGraph` is the model-agnostic view the AutoQ agent works
on: an ordered list of quantizable layers, each with channel counts, MAC
counts and a path into the parameter pytree.  A :class:`QuantPolicy` assigns a
bit-width vector (one entry per *channel group*) to every layer's weights and
a scalar bit-width to every layer's activations -- exactly the paper's action
space (the paper itself collapses activation channels per FC layer; all LM
layers are FC-like, so activations carry one QBN per layer).

Channel *groups*: the paper's CNNs have at most a few thousand channels per
layer; LM layers can have 24k+.  Groups of contiguous channels share a QBN so
the episode length stays O(1k) for billion-parameter models.  ``group_size=1``
recovers the paper's exact per-channel regime (used for the CNN repro).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


class QuantMode(enum.Enum):
    QUANT = "quant"          # linear fixed point (QBN)
    BINARIZE = "binarize"    # multi-bit binary codes (BBN)


class Granularity(enum.Enum):
    NETWORK = "network"      # one QBN for the whole net      (X-N in the paper)
    LAYER = "layer"          # one QBN per layer              (X-L)
    CHANNEL = "channel"      # one QBN per output-chan group  (X-C, the paper)


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """One quantizable layer (conv / linear / expert matrix)."""
    name: str
    kind: str                 # "conv" | "linear" | "expert" | "unembed"
    c_in: int
    c_out: int
    k: int                    # spatial kernel size (1 for linear)
    stride: int               # conv stride (1 for linear)
    macs: float               # MACs for one forward pass at the reference shape
    numel: int                # weight element count
    param_path: Tuple[Any, ...]   # keys into the params pytree
    channel_axis: int         # output-channel axis of the weight tensor
    n_groups: int             # number of channel groups (actions for this layer)

    @property
    def group_size(self) -> int:
        return max(1, self.c_out // self.n_groups)


@dataclasses.dataclass
class QuantizableGraph:
    """Ordered quantizable layers + totals; built per model by extractors."""
    layers: List[LayerInfo]

    @property
    def total_macs(self) -> float:
        return float(sum(l.macs for l in self.layers))

    @property
    def total_numel(self) -> int:
        return int(sum(l.numel for l in self.layers))

    @property
    def total_groups(self) -> int:
        return int(sum(l.n_groups for l in self.layers))

    def layer(self, name: str) -> LayerInfo:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)


@dataclasses.dataclass
class QuantPolicy:
    """Bit assignment for a whole network.

    weight_bits[name] is a float/int vector of length layer.n_groups (expanded
    to per-channel at application time); act_bits[name] is a scalar.
    """
    mode: QuantMode
    weight_bits: Dict[str, np.ndarray]
    act_bits: Dict[str, float]

    # ------------------------------------------------------------------ ctors
    @staticmethod
    def uniform(graph: QuantizableGraph, bits: float,
                mode: QuantMode = QuantMode.QUANT,
                act_bits: float | None = None) -> "QuantPolicy":
        act = bits if act_bits is None else act_bits
        return QuantPolicy(
            mode=mode,
            weight_bits={l.name: np.full(l.n_groups, float(bits)) for l in graph.layers},
            act_bits={l.name: float(act) for l in graph.layers},
        )

    @staticmethod
    def per_layer(graph: QuantizableGraph, wbits: Sequence[float],
                  abits: Sequence[float],
                  mode: QuantMode = QuantMode.QUANT) -> "QuantPolicy":
        assert len(wbits) == len(graph.layers) == len(abits)
        return QuantPolicy(
            mode=mode,
            weight_bits={l.name: np.full(l.n_groups, float(b))
                         for l, b in zip(graph.layers, wbits)},
            act_bits={l.name: float(a) for l, a in zip(graph.layers, abits)},
        )

    def copy(self) -> "QuantPolicy":
        return QuantPolicy(
            mode=self.mode,
            weight_bits={k: v.copy() for k, v in self.weight_bits.items()},
            act_bits=dict(self.act_bits),
        )

    # ------------------------------------------------------------- aggregates
    def avg_weight_bits(self, graph: QuantizableGraph) -> float:
        """Element-weighted mean weight QBN/BBN across the network."""
        num = den = 0.0
        for l in graph.layers:
            per_group_numel = l.numel / l.n_groups
            num += float(np.sum(self.weight_bits[l.name])) * per_group_numel
            den += l.numel
        return num / max(den, 1.0)

    def avg_act_bits(self, graph: QuantizableGraph) -> float:
        """MAC-weighted mean activation QBN/BBN (matches paper reporting)."""
        num = sum(self.act_bits[l.name] * l.macs for l in graph.layers)
        return float(num / max(graph.total_macs, 1.0))

    def logic_ops(self, graph: QuantizableGraph) -> float:
        """m(N): AND (quant) / XNOR (binarize) ops for one inference.

        A MAC between a qw-bit weight and a qa-bit activation costs qw*qa
        bit-level logic ops (serial-parallel multiplier [Gnanasekaran 1985] for
        quantization; bit-plane XNOR count for binarization) -- the paper's
        logic_t accounting.
        """
        total = 0.0
        for l in graph.layers:
            mean_wbits = float(np.mean(self.weight_bits[l.name]))
            total += l.macs * mean_wbits * self.act_bits[l.name]
        return total

    def model_size_bits(self, graph: QuantizableGraph) -> float:
        """Stored weight bits (p(N)*32*numel in paper terms)."""
        total = 0.0
        for l in graph.layers:
            per_group_numel = l.numel / l.n_groups
            total += float(np.sum(self.weight_bits[l.name])) * per_group_numel
        return total

    def expand_weight_bits(self, layer: LayerInfo) -> np.ndarray:
        """Per-group vector -> per-channel vector of length c_out."""
        g = self.weight_bits[layer.name]
        reps = int(np.ceil(layer.c_out / layer.n_groups))
        return np.repeat(np.asarray(g, np.float32), reps)[: layer.c_out]
