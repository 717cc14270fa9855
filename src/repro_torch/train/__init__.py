"""Training substrate of the port (port of ``repro/train``): loop,
checkpointing, fault tolerance, QAT."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import Trainer, TrainConfig

__all__ = ["CheckpointManager", "Trainer", "TrainConfig"]
