"""Learning-rate schedules (port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, base_lr: float, warmup: int = 100,
                  total: int = 10_000, min_frac: float = 0.1):
    """Linear warmup, then cosine decay to ``min_frac * base_lr``.  ``step``
    is an int or a tensor; the result is an f32 tensor on its device."""
    step = torch.as_tensor(step, dtype=torch.float32,
                           device=step.device if isinstance(
                               step, torch.Tensor) else None)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
