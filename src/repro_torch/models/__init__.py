"""Decoder LMs of the port (dense-attention families)."""
from repro_torch.models.api import BlockDef, LMConfig
from repro_torch.models.transformer import LM

__all__ = ["BlockDef", "LMConfig", "LM"]
