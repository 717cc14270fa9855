"""Device policy of the port: where entry points run, and fp32 numerics.

The reference picks its kernel mode from the platform it finds
(``repro/kernels/ops.py:19-20`` and ``repro/kernels/attention.py:64-65``:
compiled Pallas on a TPU, interpret mode elsewhere).  The port does not
guess.  Its entry points (``LM.init``, ``LM.init_cache``, ``ServeEngine``)
run on ``cuda`` unless the caller passes ``device="cpu"``; without a card
and without that opt-in they raise instead of carrying on on the CPU.

Importing this module turns TF32 off for matmuls and cuDNN, process-wide.
The reference computes in full fp32 (``ServeEngine(cache_dtype=float32)``),
and TF32 keeps about three decimal digits, which would break the parity
tolerances (rtol 1e-4 for the GEMMs, 2e-4 for attention).

It also makes cuDNN deterministic (``cudnn.deterministic = True``, its
algorithm autotuner off), process-wide.  The search trains its CNN
substrate and evaluates policies through cuDNN's convolutions
(``models/cnn.py``); left to itself, cuDNN's conv backward picks
algorithms that sum in a different order from run to run, so two runs
from one seed train different substrates and search different policies.
The reference pins bit-reproducible training
(``tests/test_trainer_fault.py``: a resumed run equals the uninterrupted
one), and the port holds itself to the same.  The serving path runs no
cuDNN op.  ``torch.use_deterministic_algorithms`` is not set: it raises
on any op without a deterministic kernel, which would turn a serving
call into an error.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False

DeviceLike = Union[str, torch.device, None]


def require_cuda() -> torch.device:
    """The card, or an error that names the CPU opt-in."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as given, or the card when it is None; a CUDA device
    that is not there raises as the default does."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
    return device


def upload(a, device: torch.device) -> torch.Tensor:
    """A host (numpy) array as a tensor of the same dtype on ``device``.
    To the card it goes through pinned memory without blocking: a plain
    host-to-device copy synchronises the stream, which would stall a
    pipelined step loop behind the kernels already queued."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def make_generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (CPU or CUDA)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
