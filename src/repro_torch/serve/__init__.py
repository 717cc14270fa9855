"""Serving of the port: :class:`ServeEngine` (``generate`` over the dense
cache; ``run`` / ``serve``, continuous batching over the paged pool), the
open-loop :class:`FrontEnd`, the :class:`Scheduler` and its page
bookkeeping, the :class:`StepLoop` back-end and :class:`ServeStats`."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import FrontEnd
from repro_torch.serve.paged_kv import (PageAllocator, PagesExhausted,
                                        pages_needed)
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.stats import ServeStats
from repro_torch.serve.step_loop import StepLoop

__all__ = ["ServeEngine", "ServeStats", "FrontEnd", "Request", "Scheduler",
           "StepLoop", "PageAllocator", "PagesExhausted", "pages_needed"]
