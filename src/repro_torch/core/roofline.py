# TPURoofline, storage_bytes_per_elem and mxu_rate are copied from
# src/repro/core/roofline.py (numpy only) with imports renamed, so that
# RewardCfg(kind="roofline") gives the reference's rewards; H100Roofline
# is the port's own target.
"""Lightweight roofline models (paper section 3: "AutoQB adopts a
lightweight Roofline model to take the latency and energy of a specific
hardware platform into consideration").

The paper fits linear latency/energy models for an FPGA.  Each model here
maps a quantization policy to {compute time, memory time} per layer and
takes the roofline max:

* :class:`TPURoofline` -- the reference's TPU v5e model: storage packs to
  int4/int8/bf16; MXU rate doubles at int8 but does not improve further
  below 8 bits.
* :class:`H100Roofline` -- the port's NVIDIA H100 model, with the same
  interface and the same per-layer formula, its constants and buckets
  taken from the port's own routes (the packed store and the GEMM route
  of ``kernels.quant_matmul``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.quant_matmul import SKINNY_M
from repro_torch.quant.linear_quant import _bucket_ids
from repro_torch.quant.policy import QuantPolicy, QuantizableGraph

# TPU v5e per-chip constants (assignment-provided).
PEAK_BF16 = 197e12          # FLOP/s
PEAK_INT8 = 394e12          # OP/s (2x bf16)
HBM_BW = 819e9              # B/s
ICI_BW = 50e9               # B/s per link
ENERGY_PJ_PER_MAC_BF16 = 1.3
ENERGY_PJ_PER_MAC_INT8 = 0.4
ENERGY_PJ_PER_BYTE_HBM = 15.0


def storage_bytes_per_elem(bits: np.ndarray) -> np.ndarray:
    """Packed storage bucket: <=4 -> int4 (0.5 B), <=8 -> int8, else bf16."""
    return np.where(bits <= 0.5, 0.0,
                    np.where(bits <= 4, 0.5,
                             np.where(bits <= 8, 1.0, 2.0)))


def mxu_rate(bits: np.ndarray) -> np.ndarray:
    """Effective MXU rate for a channel quantized at `bits`."""
    return np.where(bits <= 8, PEAK_INT8, PEAK_BF16)


@dataclasses.dataclass(frozen=True)
class TPURoofline:
    chips: int = 1
    act_bytes: float = 2.0       # activations stay bf16 unless quantized <=8

    def _layer_terms(self, layer, wbits: np.ndarray, abits: float):
        frac_alive = float(np.mean(wbits > 0.5))
        macs = layer.macs * frac_alive / self.chips
        rate = float(np.mean(mxu_rate(np.maximum(wbits, 1e-3))))
        if abits > 8:             # both operands must be <=8 for int8 MXU
            rate = PEAK_BF16
        t_compute = 2.0 * macs / rate
        w_bytes = float(np.mean(storage_bytes_per_elem(wbits))) * layer.numel \
            / self.chips
        a_bytes = (1.0 if abits <= 8 else 2.0) * \
            (layer.macs / max(layer.c_out, 1)) / self.chips  # input reuse proxy
        t_mem = (w_bytes + a_bytes) / HBM_BW
        return t_compute, t_mem, macs, w_bytes + a_bytes

    def latency(self, graph: QuantizableGraph, policy: QuantPolicy) -> float:
        total = 0.0
        for layer in graph.layers:
            wb = policy.expand_weight_bits(layer)
            tc, tm, _, _ = self._layer_terms(layer, wb, policy.act_bits[layer.name])
            total += max(tc, tm)
        return total

    def latency_full(self, graph: QuantizableGraph) -> float:
        total = 0.0
        for layer in graph.layers:
            wb = np.full(layer.c_out, 16.0)
            tc, tm, _, _ = self._layer_terms(layer, wb, 16.0)
            total += max(tc, tm)
        return total

    def energy(self, graph: QuantizableGraph, policy: QuantPolicy) -> float:
        total = 0.0
        for layer in graph.layers:
            wb = policy.expand_weight_bits(layer)
            abits = policy.act_bits[layer.name]
            frac_alive = float(np.mean(wb > 0.5))
            macs = layer.macs * frac_alive
            pj_mac = ENERGY_PJ_PER_MAC_INT8 if (
                float(np.mean(wb)) <= 8 and abits <= 8) \
                else ENERGY_PJ_PER_MAC_BF16
            w_bytes = float(np.mean(storage_bytes_per_elem(wb))) * layer.numel
            total += macs * pj_mac + w_bytes * ENERGY_PJ_PER_BYTE_HBM
        return total * 1e-12      # joules

    def throughput_fps(self, graph: QuantizableGraph,
                       policy: QuantPolicy) -> float:
        return 1.0 / max(self.latency(graph, policy), 1e-12)


# ------------------------------------------------------------------- H100
# NVIDIA H100 SXM data sheet (dense rates, 700 W): the port's one
# statement of them (launch/roofline.py and chip_smoke.py read these)
H100_HBM_BW = 3.35e12       # B/s, HBM3
H100_FP32 = 67e12           # FLOP/s, CUDA cores
H100_TF32 = 495e12          # FLOP/s, tensor cores
H100_BF16 = 989e12          # FLOP/s, tensor cores
# passes of gemm_tc, the port's tensor-core GEMM route (x split hi / lo)
H100_TC_PASSES = 2
# bytes per weight element of each packed-store bucket (kernels/pack.py
# BUCKETS, quant/linear_quant.py _bucket_ids): pruned, int2, int4, int8,
# and bf16 for QBNs above 8
H100_BUCKET_BYTES = np.array([0.0, 0.25, 0.5, 1.0, 2.0])
H100_ACT_BYTES = 4.0        # activations stay fp32 in the port


def h100_storage_bytes_per_elem(bits: np.ndarray) -> np.ndarray:
    """Bytes of each channel's element in the port's packed store."""
    return H100_BUCKET_BYTES[_bucket_ids(bits)]


def h100_rate(rows: float) -> float:
    """Compute rate of a GEMM of ``rows`` rows on the port's route
    (``kernels.quant_matmul.route``): fp32 CUDA cores when it streams the
    weight (``rows <= SKINNY_M``), else the TF32 tensor cores over
    ``H100_TC_PASSES`` passes.  Neither route runs faster below 8 bits."""
    return H100_FP32 if rows <= SKINNY_M else H100_TF32 / H100_TC_PASSES


@dataclasses.dataclass(frozen=True)
class H100Roofline:
    """The port's roofline for one NVIDIA H100: per layer max(compute,
    memory), as :class:`TPURoofline`.  A layer's rows are ``macs /
    numel`` (tokens of an LM site, output positions of a conv); weight
    bytes follow the packed store's buckets and activations take 4 bytes.
    ``power_w`` is the card's power limit (``nvidia-smi``'s
    ``power.limit``): :meth:`energy` is that power over :meth:`latency`,
    an upper bound of the energy, not a measurement."""
    power_w: float = 700.0

    def _layer_terms(self, layer, wbits: np.ndarray):
        macs = layer.macs * float(np.mean(wbits > 0.5))
        rows = layer.macs / max(layer.numel, 1)
        t_compute = 2.0 * macs / h100_rate(rows)
        w_bytes = float(np.mean(h100_storage_bytes_per_elem(wbits))) * \
            layer.numel
        a_bytes = H100_ACT_BYTES * layer.macs / max(layer.c_out, 1)
        return t_compute, (w_bytes + a_bytes) / H100_HBM_BW

    def latency(self, graph: QuantizableGraph, policy: QuantPolicy) -> float:
        return sum(max(self._layer_terms(l, policy.expand_weight_bits(l)))
                   for l in graph.layers)

    def latency_full(self, graph: QuantizableGraph) -> float:
        """Every channel above 8 bits: the store's bf16 bucket."""
        return sum(max(self._layer_terms(l, np.full(l.c_out, 32.0)))
                   for l in graph.layers)

    def energy(self, graph: QuantizableGraph, policy: QuantPolicy) -> float:
        return self.power_w * self.latency(graph, policy)     # joules

    def throughput_fps(self, graph: QuantizableGraph,
                       policy: QuantPolicy) -> float:
        return 1.0 / max(self.latency(graph, policy), 1e-12)
