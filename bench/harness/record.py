"""What a driver records of a window, on the host: every request's sizes,
submission time and output tokens with the time each became visible, and
every call into the model with its shape.  The per-layer metric readers
and the correctness check read this and nothing of the program's state."""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Req:
    prompt: np.ndarray
    n_new: int
    submit_t: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    stamps: List[float] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.n_new


class WindowClosed(Exception):
    """Raised from a stream callback to stop the program's serving loop
    once the window has closed."""


@dataclasses.dataclass
class Record:
    t0: float = 0.0
    t_end: float = 0.0
    reqs: Dict[int, Req] = dataclasses.field(default_factory=dict)
    # (time, entry, rows, width): one per call into the model
    calls: List[Tuple[float, str, int, int]] = dataclasses.field(
        default_factory=list)
    # monolithic runs: (start, end, decode tokens, decode steps) of each
    # batch
    batches: List[Tuple[float, float, int, int]] = dataclasses.field(
        default_factory=list)
    chunk_tokens: Optional[int] = None
    # a driver's hook, called before each model call (it may open the
    # window there)
    on_call: Optional[Callable[[], None]] = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def counted(self):
        """(tokens, seconds) of ``output_tok_s``: every token visible
        before the window closed, over the time from the window's start to
        the last of them (a step's tokens become visible together, so the
        window ends with the last step that completed in it)."""
        stamps = [t for r in self.reqs.values() for t in r.stamps
                  if self.t0 <= t < self.t_end]
        return (len(stamps), max(stamps) - self.t0) if stamps else (0, 0.0)

    def add(self, rid: int, prompt, n_new: int, t: float) -> None:
        self.reqs[rid] = Req(np.asarray(prompt), int(n_new), t)

    def on_token(self, rid: int, index: int, token: int,
                 deadline: float) -> float:
        """Record a token made visible now; past ``deadline`` record
        nothing and raise :class:`WindowClosed`."""
        t = time.perf_counter()
        if t >= deadline:
            raise WindowClosed
        r = self.reqs[rid]
        if index != len(r.tokens):
            raise RuntimeError(f"request {rid}: token {index} arrived after "
                               f"{len(r.tokens)} tokens")
        r.tokens.append(int(token))
        r.stamps.append(t)
        return t

    def calls_between(self, a: float, b: float, entries=None) -> int:
        return sum(a <= t < b and (entries is None or e in entries)
                   for t, e, _, _ in self.calls)


def watch_calls(engine, record: Record, tracer) -> None:
    """Wrap the engine's model entry points so that each call is logged
    with its time and shape (read on the host, no device sync), and the
    driver's hook and the tracer may act before it."""
    def wrap(entry, fn):
        @functools.wraps(fn)
        def logged(*a, **kw):
            if entry == "prefill":
                rows, width = a[1]["tokens"].shape
            else:
                rows, width = a[1].shape[:2]
            if record.on_call is not None:
                record.on_call()
            now = time.perf_counter()
            tracer.tick(now)
            record.calls.append((now, entry, int(rows), int(width)))
            return fn(*a, **kw)
        return logged
    for attr, entry in (("_model_step", "model_step"), ("_prefill", "prefill"),
                        ("_decode_paged", "decode_step_paged")):
        setattr(engine, attr, wrap(entry, getattr(engine, attr)))
