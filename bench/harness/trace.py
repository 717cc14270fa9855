"""The traced run's profiler, in two phases, and the reduction of its events.

Phase ``device`` (the window's first half) records the card's activity
alone, so the host runs as it does untraced: busy time, kernel times by
group, launches and the rooflines come from it.  Phase ``ranges`` (the
next quarter) also records the host's operators, which the program's
profiler ranges (``moe_dispatch``, ``moe_gather``, ``ssd_chunk_scan``)
need, and which name what the host was doing in the device's idle gaps;
tracing the host slows it, so the phase is kept short, and the rest of the
window runs untraced.  The phases change at model calls (``tick``).
Nothing is written to disk: events stay in memory until the run reads
them.
"""
from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple


class Phase:
    def __init__(self, name: str):
        self.name = name
        self.t_start = 0.0              # perf_counter seconds
        self.ns_start = 0               # the profiler's clock
        self.t_end: Optional[float] = None
        self.ns_end: Optional[int] = None
        self.prof = None
        # reduced after the run
        self.kernels: List[Tuple[int, int, str]] = []     # start, dur, name
        self.ranges: Dict[str, List[Tuple[int, int]]] = {}
        self.host: List[Tuple[int, int, str]] = []        # main thread ops

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


class Tracer:
    """Profiles a window in phases, changed by ``tick`` at model calls."""

    def __init__(self, enabled: bool, on_card: bool):
        self.enabled = enabled
        self.on_card = on_card
        self.phases: List[Phase] = []
        self.seconds = 0.0
        # seconds the switch between phases held the window up (stopping a
        # profiler reads its buffers); a driver's deadline moves by as much
        self.paused = 0.0

    def _start(self, name: str, host: bool) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if self.on_card else []
        if host or not self.on_card:
            acts.append(ProfilerActivity.CPU)
        ph = Phase(name)
        ph.prof = profile(activities=acts)
        ph.prof.start()
        ph.t_start, ph.ns_start = time.perf_counter(), time.time_ns()
        self.phases.append(ph)

    def warm(self) -> None:
        """Start and stop the profiler once (set-up): its first start
        initialises the tracing library, which takes seconds."""
        if self.enabled:
            self._start("warm", host=True)
            self._stop_current()
            self.phases.clear()

    def start(self, seconds: float) -> None:
        """Open the first phase; the window starts after it."""
        if self.enabled:
            self._start("device", host=False)
            self.seconds = seconds

    def tick(self, now: float) -> None:
        """At a model call: end the first phase after half of the window's
        seconds, the second after another quarter."""
        if not self.enabled or not self.phases:
            return
        ph = self.phases[-1]
        if ph.t_end is not None:
            return
        if ph.name == "device" and now >= ph.t_start + self.seconds / 2:
            t = time.perf_counter()
            self._stop_current()
            self._start("ranges", host=True)
            self.paused += time.perf_counter() - t
        elif ph.name == "ranges" and now >= ph.t_start + self.seconds / 4:
            t = time.perf_counter()
            self._stop_current()
            self.paused += time.perf_counter() - t

    def _stop_current(self) -> None:
        ph = self.phases[-1]
        if ph.t_end is None:
            if self.on_card:
                import torch
                torch.cuda.synchronize()
            ph.t_end, ph.ns_end = time.perf_counter(), time.time_ns()
            ph.prof.stop()

    def stop(self) -> None:
        if self.enabled and self.phases:
            self._stop_current()

    def reduce(self, range_names) -> None:
        """Read every phase's events into plain tuples, clipped to the
        phase, and drop the profiler objects."""
        from torch.autograd import DeviceType
        for ph in self.phases:
            lo, hi = ph.ns_start, ph.ns_end
            for e in ph.prof.profiler.kineto_results.events():
                if e.is_async():
                    continue
                s, d = e.start_ns(), e.duration_ns()
                if s + d < lo or s > hi:
                    continue
                on_dev = e.device_type() == DeviceType.CUDA
                if e.is_user_annotation():
                    # CPU rehearsal: the host's ranges stand in
                    if (on_dev or not self.on_card) and \
                            e.name() in range_names:
                        ph.ranges.setdefault(e.name(), []).append((s, s + d))
                    continue
                if on_dev:
                    ph.kernels.append((s, d, e.name()))
                elif not self.on_card:
                    # CPU rehearsal: host operators stand in for kernels
                    ph.kernels.append((s, d, e.name()))
                    ph.host.append((s, d, e.name()))
                else:
                    ph.host.append((s, d, e.name()))
            ph.kernels.sort()
            ph.host.sort()
            ph.prof = None


def busy_ns(kernels: List[Tuple[int, int, str]]) -> int:
    """Time in which at least one kernel ran (the union of intervals)."""
    total, cur_s, cur_e = 0, None, None
    for s, d, _ in kernels:
        e = s + d
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def group_ns(kernels, patterns: List[str]) -> Tuple[int, int]:
    """Device ns and launches of the kernels whose names match any of the
    regular expressions ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    ns = n = 0
    for _, d, name in kernels:
        if any(r.search(name) for r in rx):
            ns += d
            n += 1
    return ns, n


def range_ns(ph: Phase, name: str) -> int:
    """Device ns of the kernels that started inside the profiler range
    ``name`` (on one stream these are exactly the range's own)."""
    starts = [k[0] for k in ph.kernels]
    total = 0
    for a, b in ph.ranges.get(name, []):
        for i in range(bisect.bisect_left(starts, a),
                       bisect.bisect_left(starts, b)):
            total += ph.kernels[i][1]
    return total


def top_ops(kernels, n: int = 10) -> List[List]:
    acc: Dict[str, int] = {}
    for _, d, name in kernels:
        acc[name] = acc.get(name, 0) + d
    rows = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in rows]


def idle_gaps(ph: Phase, n: int = 10) -> List[List]:
    """The ``n`` longest gaps with no kernel running, each named by the
    innermost host operator that spans the gap's middle."""
    gaps = []
    end = None
    for s, d, _ in ph.kernels:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = s + d if end is None else max(end, s + d)
    gaps.sort(reverse=True)
    out = []
    for length, a, b in gaps[:n]:
        mid = (a + b) // 2
        best = None
        for s, d, name in ph.host:
            if s > mid:
                break
            if s + d >= mid and (best is None or d < best[0]):
                best = (d, name)
        out.append([f"host: {best[1][:100]}" if best else "host: untraced",
                    length / 1e9])
    return out
