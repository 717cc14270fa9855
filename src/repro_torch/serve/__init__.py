"""Serving of the port: :class:`ServeEngine` (``generate`` over the dense
cache) and :class:`ServeStats`."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.stats import ServeStats

__all__ = ["ServeEngine", "ServeStats"]
