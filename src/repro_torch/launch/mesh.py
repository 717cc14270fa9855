"""Production and host meshes (port of ``repro/launch/mesh.py``) as
``torch.distributed`` DeviceMeshes.

Functions, not module-level constants: importing this module starts no
process group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import backend


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's shapes: a (16, 16) ``("data", "model")`` mesh (256
    H100s, one pod), or (2, 16, 16) ``("pod", "data", "model")`` (512).
    "data" carries FSDP + batch DP (+ EP for MoE), "model" TP, "pod" pure
    DP.  The default process group must already span 256 / 512 ranks (a
    real job, or the dry run's ``fake`` group with ``device_type="cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device: backend.DeviceLike = None):
    """A 1x1 ``("data", "model")`` mesh over this process: on the card
    (NCCL) unless ``device="cpu"`` (gloo).  Starts a one-rank default
    group (in-memory store, no port) when there is none; an existing
    default group must have one rank."""
    device = backend.resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("make_host_mesh needs a one-rank default group; "
                         f"this one has {dist.get_world_size()}")
    return init_device_mesh(device.type, (1, 1),
                            mesh_dim_names=("data", "model"))
