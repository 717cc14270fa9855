"""The port's span recorder: named host intervals with counts, on while a
profiler runs.

``with span(name, **counts) as c:`` marks a stretch of host code.  While
no ``torch.profiler`` session runs (whatever its activities) a span costs
one flag read: it enters no ``record_function`` and records nothing, and
``c`` is None.  While one runs, a span opens
``torch.profiler.record_function(name)``, so it shows in the profiler's
trace under its name, and appends ``(name, t0_ns, t1_ns, parent, counts)``
to an in-memory list; ``c`` is the record's ``counts`` dict, which the
body may fill once it knows them.  ``t0_ns`` / ``t1_ns`` are stamped with
``time.time_ns()`` just outside the ``record_function``, the clock of the
profiler's events, so they compare directly with the device kernels'
starts.  ``parent`` is the index in :func:`records` of the innermost span
open when this one opened, -1 for none.  Counts come from host values
(plans, shapes): a span adds no host sync.

``annotate=False`` records a span without its ``record_function``, at a
fraction of its cost.  A span that encloses a model call takes it: a
caller may stop one profiler there and start the next (a traced benchmark
changes its phases at model calls), and a ``record_function`` begun under
one profiler and ended under the next writes into the first one's freed
buffers (on torch 2.13 the process then crashes, or its heap is corrupt).
A span opened many times a step whose range no reader uses takes it too.

The list holds at most ``CAP`` records; what the cap turns away is counted
(:func:`dropped`).  Nothing is written to disk.  Spans nest on one
thread: the serving loop's, which runs the model.

The spans (the metric that reads each: ``bench/metrics/``):

* ``step`` (``serve/step_loop.py``, not annotated), counts ``rows`` (R x
  w, the rows the model call computes) and ``real_rows`` (prompt-chunk
  tokens, decode lanes and speculative verify columns):
  ``real_row_share``, ``idle_host_share`` (and, by its length, the source
  in the program for ``step_ms``, which reads the harness's call log
  today); its children ``step.plan``, ``step.upload``, ``step.launch``
  (not annotated), ``step.sample``, ``step.wait`` (``idle_host_share``
  leaves it out) and ``step.emit``;
* ``moe`` (``models/layers.py::_moe_ffn_impl``, not annotated), counts
  ``pairs`` (T x K) and ``rows`` (the rows the expert GEMMs compute: T x K
  when they run grouped over the routed pairs, E_phys x groups x C in the
  capacity layout): ``expert_pair_share``; its children ``moe_dispatch``
  and ``moe_gather``: ``moe_ms_per_step``;
* ``mamba`` (``models/transformer.py::LM._mamba_block``, not annotated),
  counts ``rows`` (the rows x columns the block's scan computes) and
  ``tokens`` (the real tokens whose state it advances, where the host
  knows them): ``ssd_row_share``; its child ``ssd_chunk_scan``
  (``models/ssm.py``): ``ssd_scan_share``, ``ssd_roofline``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "records", "clear", "dropped", "CAP"]

CAP = 1 << 18

_records: List[list] = []
_open: List[int] = []                  # indices of the open spans
_dropped = 0


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, annotate: bool, counts: Dict[str, int]):
        self.rec = [name, 0, 0, -1, counts]
        self.rf = torch.profiler.record_function(name) if annotate else None

    def __enter__(self) -> Dict[str, int]:
        global _dropped
        rec = self.rec
        rec[3] = _open[-1] if _open else -1
        if len(_records) < CAP:
            _open.append(len(_records))
            _records.append(rec)
        else:
            _open.append(-1)
            _dropped += 1
        rec[1] = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return rec[4]

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec[2] = time.time_ns()
        _open.pop()
        return False


def span(name: str, *, annotate: bool = True, **counts: int):
    """A context manager that records ``name`` while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, annotate, counts)


def records() -> List[Tuple[str, int, int, int, Dict[str, int]]]:
    """Every recorded span, in the order they opened: (name, t0_ns,
    t1_ns, parent, counts); a span still open has t1_ns 0."""
    return [tuple(r) for r in _records]


def dropped() -> int:
    """Spans the cap turned away since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Forget every record (call with no span open)."""
    global _dropped
    _records.clear()
    _dropped = 0
