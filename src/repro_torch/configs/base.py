# Copied from src/repro/configs/base.py; imports renamed.
"""Shared helpers for per-architecture config modules."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.api import BlockDef


def dense(kind: str = "attn", moe: bool = False, ffn: bool = True) -> BlockDef:
    return BlockDef(kind=kind, use_moe=moe, has_ffn=ffn)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One assigned architecture: production config + reduced smoke config."""
    arch_id: str
    config: "LMConfig"               # full production dims (dry-run only)
    smoke: "LMConfig"                # tiny same-family config (CPU tests)
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: Optional[str] = None


def spec(arch_id, config, smoke, family, skip_long=True) -> ArchSpec:
    """skip_long=True marks pure full-attention archs: long_500k decode would
    need a full 500k KV cache in every layer (no sub-quadratic path)."""
    skips = ("long_500k",) if skip_long else ()
    reason = ("pure full-attention architecture: 500k decode state is a "
              "full KV cache in every layer (no sub-quadratic path)"
              if skip_long else None)
    return ArchSpec(arch_id, config, smoke, family, skips, reason)
