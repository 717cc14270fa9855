"""Architecture configs (copies of ``repro.configs``: the dense, MoE, SSM,
hybrid, audio and vision families).

``get(arch_id)`` returns an :class:`ArchSpec` with the full production
config and a reduced smoke config of the same family.
"""
from repro_torch.configs.registry import ARCHS, ArchSpec, get

__all__ = ["ARCHS", "ArchSpec", "get"]
