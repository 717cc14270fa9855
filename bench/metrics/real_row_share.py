"""real_row_share: the rows the serving steps' model calls needed (prompt-
chunk tokens, decode lanes, speculative verify columns: the ``real_rows``
count) as a share of the rows they computed (R x w: ``rows``), summed over
the program's ``step`` spans (``repro_torch.spans``) that start in the
traced window's first phase.  Layer: scheduler (``serve/scheduler.py::
plan_step``, ``serve/step_loop.py``)."""
from bench.harness.program_spans import count_sums
from bench.harness.readings import share


def read(r):
    ph = r.phase("device")
    if ph is None:
        return None
    return share(*count_sums(ph, "step", "real_rows", "rows"))
