"""Registry of the architectures the port serves.  ``ARCHS`` is a copy of
``repro.configs.registry``, every config module a copy of its reference
counterpart; ``PORT_ONLY`` holds the presets the reference lacks
(granite-4.0-h-small), which :func:`get` finds too."""
from __future__ import annotations

from repro_torch.configs import (gemma2_2b, granite_4_0_h_small,
                                 granite_moe_3b_a800m,
                                 internlm2_20b, jamba_1_5_large_398b,
                                 llama4_scout_17b_a16e, llama_3_2_vision_90b,
                                 mamba2_780m, musicgen_large, phi4_mini_3_8b,
                                 starcoder2_7b)
from repro_torch.configs.base import ArchSpec

_MODULES = (jamba_1_5_large_398b, internlm2_20b, phi4_mini_3_8b,
            starcoder2_7b, gemma2_2b, musicgen_large, granite_moe_3b_a800m,
            llama4_scout_17b_a16e, llama_3_2_vision_90b, mamba2_780m)

ARCHS = {m.SPEC.arch_id: m.SPEC for m in _MODULES}

PORT_ONLY = {m.SPEC.arch_id: m.SPEC for m in (granite_4_0_h_small,)}


def get(arch_id: str) -> ArchSpec:
    known = {**ARCHS, **PORT_ONLY}
    if arch_id not in known:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(known)}")
    return known[arch_id]
