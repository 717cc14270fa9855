"""Quantization substrate of the port: linear per-channel quantization,
policy containers (a copy of ``repro.quant.policy``), policy application,
the activation hook and a policy's metrics."""
from repro_torch.quant.apply import (apply_policy_packed,
                                     apply_policy_to_params, policy_metrics,
                                     quantize_activation)
from repro_torch.quant.linear_quant import (FULL_BITS, dequant_int8,
                                            fake_quant,
                                            fake_quant_per_channel,
                                            fake_quant_per_token,
                                            quant_pack_int8, quant_pack_sub8)
from repro_torch.quant.policy import (Granularity, LayerInfo, QuantMode,
                                      QuantizableGraph, QuantPolicy)

__all__ = ["FULL_BITS", "fake_quant", "fake_quant_per_channel",
           "fake_quant_per_token", "quant_pack_int8", "dequant_int8",
           "quant_pack_sub8", "Granularity",
           "LayerInfo", "QuantMode", "QuantizableGraph", "QuantPolicy",
           "apply_policy_to_params", "apply_policy_packed",
           "quantize_activation", "policy_metrics"]
