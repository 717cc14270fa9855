"""Registry of the architectures the port serves so far.

A copy of ``repro.configs.registry`` cut to the families the port runs:
dense and MoE attention, Mamba2 (SSD) and the jamba hybrid; each config
module is a copy of its reference counterpart.  Families not yet ported
raise from :func:`get`, naming the ROADMAP item that adds them.
"""
from __future__ import annotations

from repro_torch.configs import (gemma2_2b, granite_moe_3b_a800m,
                                 internlm2_20b, jamba_1_5_large_398b,
                                 llama4_scout_17b_a16e, mamba2_780m,
                                 phi4_mini_3_8b, starcoder2_7b)
from repro_torch.configs.base import ArchSpec

_MODULES = (jamba_1_5_large_398b, internlm2_20b, phi4_mini_3_8b,
            starcoder2_7b, gemma2_2b, granite_moe_3b_a800m,
            llama4_scout_17b_a16e, mamba2_780m)

ARCHS = {m.SPEC.arch_id: m.SPEC for m in _MODULES}

# reference architectures whose block kinds (cross-attention, audio front
# end) the port does not run yet
NOT_PORTED = {
    "llama-3.2-vision-90b": "ROADMAP.md A10 (cross-attention memory cache)",
    "musicgen-large": "ROADMAP.md A10 (audio_stub front end)",
}


def get(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported yet: {NOT_PORTED[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
