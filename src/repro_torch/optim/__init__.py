"""Optimizers of the port (port of ``repro/optim``): functional AdamW with
fp32 or 8-bit moments, and the cosine warmup schedule."""
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["AdamW", "cosine_warmup"]
