# Copied from src/repro/serve/frontend.py; only the imports and
# cross-references name the port's modules.
"""Open-loop serving front-end: arrivals, streaming, SLO shedding.

The front-end is the *open* half of the serving split (docs/serving.md):
requests may arrive while the step loop runs, not just before it.  It
owns everything about a request that exists outside a scheduler slot --

* the **arrival queue**: :meth:`FrontEnd.submit` timestamps a request
  (``at`` schedules a future arrival; the Poisson bench pre-schedules a
  whole trace) and :meth:`FrontEnd.pump` releases everything whose
  arrival time has come into the scheduler's admission queue, in arrival
  order, each step;
* **per-token streaming**: an ``on_token(rid, index, token)`` callback
  registered at submit time fires as each token becomes host-visible, in
  token order (the overlapped back-end syncs a step's tokens one step
  late, so "host-visible" trails "sampled" by one step -- the stream
  order is unchanged);
* **SLO-aware shedding**: with ``queue_slo_s`` set, a request still in
  the admission queue past its deadline is dropped
  (:meth:`~repro_torch.serve.scheduler.Scheduler.drop_queued`) instead of
  serving a first token nobody is waiting for anymore; ``max_queue``
  bounds the backlog at submit time.  Only never-admitted requests are
  shed -- an admitted request owns pages and possibly emitted tokens,
  and tearing a live stream would violate the bit-parity contract for
  everything it batched with.

The clock is injectable (``clock`` / ``sleep``) so arrival-dependent
behaviour is deterministic under test: a virtual clock steps time
forward exactly when the test says so.  Submission is thread-safe --- a
live client may :meth:`submit` from another thread while
:meth:`~repro_torch.serve.step_loop.StepLoop.run` drains the queue.

The front-end never touches device state and never samples: it is pure
host bookkeeping feeding :class:`~repro_torch.serve.scheduler.Scheduler`
(admission) and fed by :class:`~repro_torch.serve.step_loop.StepLoop`
(token retirement).  ``ServeEngine.run()`` is exactly this wiring with
every request submitted up front -- the closed loop is a degenerate
open loop.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["FrontEnd", "as_request"]

OnToken = Callable[[int, int, int], None]     # (rid, index, token)


def as_request(rid: int, r) -> Request:
    """Normalize a submission into a :class:`Request`.

    Accepts a Request (rid is overwritten), a ``{"tokens", "n_new",
    "temperature"?, "seed"?}`` dict, or a ``(tokens, n_new)`` tuple.
    """
    if isinstance(r, Request):
        return dataclasses.replace(r, rid=rid)
    if isinstance(r, dict):
        return Request(rid=rid, tokens=r["tokens"], n_new=r["n_new"],
                       temperature=r.get("temperature", 0.0),
                       seed=r.get("seed", 0))
    tokens, n_new = r
    return Request(rid=rid, tokens=tokens, n_new=n_new)


class FrontEnd:
    """Arrival queue + stream registry for one open-loop serving session.

    clock/sleep: time source and idle wait (defaults
    ``time.monotonic`` / ``time.sleep``); tests inject a virtual pair.
    queue_slo_s: drop a request still unadmitted this long after
    arrival (None: never shed).  max_queue: reject submissions while
    this many requests are waiting (scheduled + queued, unadmitted).
    """

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 queue_slo_s: Optional[float] = None,
                 max_queue: Optional[int] = None):
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self.queue_slo_s = queue_slo_s
        self.max_queue = max_queue
        self._lock = threading.Lock()
        # (arrival time, submit seq, request) -- seq keeps same-instant
        # arrivals in submit order, so closed-loop admission FIFO (and
        # with it slot assignment, and with it bit-parity) is preserved
        self._arrivals: List[Any] = []
        self._seq = 0
        self._next_rid = 0
        self._on_token: Dict[int, OnToken] = {}
        self._waiting: Dict[int, Request] = {}   # released, not yet admitted
        self.arrival_s: Dict[int, float] = {}
        self.shed: List[int] = []
        self.n_submitted = 0

    # -------------------------------------------------------------- clients
    def now(self) -> float:
        return self._clock()

    def submit(self, r, *, at: Optional[float] = None,
               on_token: Optional[OnToken] = None) -> Request:
        """Register one request, arriving now (default) or at ``at``.

        Returns the normalized :class:`Request` (its ``rid`` identifies
        the stream everywhere: outputs, stats, callbacks).  A request a
        full ``max_queue`` backlog rejects is recorded in :attr:`shed`
        immediately and never reaches the scheduler.
        """
        with self._lock:
            req = r if isinstance(r, Request) and r.rid == self._next_rid \
                else as_request(self._next_rid, r)
            self._next_rid += 1
            self.n_submitted += 1
            t = self._clock() if at is None else float(at)
            self.arrival_s[req.rid] = t
            backlog = len(self._arrivals) + len(self._waiting)
            if self.max_queue is not None and backlog >= self.max_queue:
                self.shed.append(req.rid)
                return req
            if on_token is not None:
                self._on_token[req.rid] = on_token
            heapq.heappush(self._arrivals, (t, self._seq, req))
            self._seq += 1
        return req

    # ------------------------------------------------------------ step loop
    @property
    def n_scheduled(self) -> int:
        """Submitted arrivals not yet released to the scheduler."""
        with self._lock:
            return len(self._arrivals)

    def next_arrival(self) -> Optional[float]:
        with self._lock:
            return self._arrivals[0][0] if self._arrivals else None

    def pump(self, sched: Scheduler):
        """Release due arrivals into the scheduler; shed overdue waiters.

        Called by the step loop once per iteration (and while idling
        between arrivals).  Returns ``(now, released)``: the current
        clock reading -- the step's one timestamp for every latency
        measurement -- and the requests released this call (the loop
        validates them against engine limits before they can admit).
        """
        now = self._clock()
        released: List[Request] = []
        with self._lock:
            while self._arrivals and self._arrivals[0][0] <= now:
                _, _, req = heapq.heappop(self._arrivals)
                sched.submit(req)
                self._waiting[req.rid] = req
                released.append(req)
        if self.queue_slo_s is not None:
            overdue = [rid for rid, req in self._waiting.items()
                       if now - self.arrival_s[rid] > self.queue_slo_s]
            for rid in overdue:
                if sched.drop_queued(rid):
                    del self._waiting[rid]
                    self._on_token.pop(rid, None)
                    self.shed.append(rid)
        return now, released

    def note_admitted(self, rid: int) -> None:
        """A waiter reached a slot: it is no longer sheddable.  (A later
        preemption requeues it inside the scheduler only -- it stays
        off the shed candidate list, by design: its service started.)"""
        self._waiting.pop(rid, None)

    def emit(self, rid: int, index: int, token: int) -> None:
        """Fire the stream callback for one host-visible token."""
        cb = self._on_token.get(rid)
        if cb is not None:
            cb(rid, index, token)

    def wait(self, now: float, cap: float = 0.01) -> None:
        """Idle until the next scheduled arrival (bounded naps, so live
        submissions from other threads are noticed promptly)."""
        nxt = self.next_arrival()
        dt = cap if nxt is None else max(min(nxt - now, cap), 0.0)
        if dt > 0:
            self._sleep(dt)
