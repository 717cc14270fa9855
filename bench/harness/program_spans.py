"""The program's spans (``repro_torch.spans``) in a traced window's phase,
and the interval arithmetic that lays them over the card's kernels.

A span is ``(name, t0_ns, t1_ns, parent, counts)`` on the clock of the
profiler's events, so it compares directly with ``Phase.ns_start`` /
``ns_end`` and the kernels' starts.  A program without the recorder
gives no spans, and a reader then returns None.  :func:`idle_by_span`
splits a phase's idle time by the innermost span that holds it
(``scripts/span_split.py`` prints it for a traced run).
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

Interval = Tuple[int, int]


def in_phase(ph) -> List[Tuple[int, tuple]]:
    """(index, span) of every closed span that starts inside phase
    ``ph``; the index is the span's in the recorder, which ``parent``
    refers to."""
    try:
        from repro_torch import spans
    except ImportError:
        return []
    lo, hi = ph.ns_start, ph.ns_end
    return [(i, s) for i, s in enumerate(spans.records())
            if lo <= s[1] <= hi and s[2]]


def count_sums(ph, name: str, *keys: str) -> List[int]:
    """The sums of the counts ``keys`` over the spans ``name`` in ``ph``."""
    found = [s[4] for _, s in in_phase(ph) if s[0] == name]
    return [sum(c.get(k, 0) for c in found) for k in keys]


# ----------------------------------------------------------- intervals
def merged(iv: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time; empty ones
    dropped."""
    out: List[Interval] = []
    for a, b in sorted(iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def subtract(x: List[Interval], y: List[Interval]) -> List[Interval]:
    """x minus y, both merged."""
    out: List[Interval] = []
    j = 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        cur, k = a, j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > cur:
                out.append((cur, y[k][0]))
            cur = max(cur, y[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def overlap_ns(x: List[Interval], y: List[Interval]) -> int:
    """Time in both x and y (merged); y searched, so x may be short."""
    ends = [b for _, b in y]
    total = 0
    for a, b in x:
        k = bisect.bisect_right(ends, a)
        while k < len(y) and y[k][0] < b:
            total += min(b, y[k][1]) - max(a, y[k][0])
            k += 1
    return total


def length(x: List[Interval]) -> int:
    return sum(b - a for a, b in x)


# ----------------------------------------------------------- the card
def idle(ph) -> List[Interval]:
    """The stretches of phase ``ph`` in which no kernel ran."""
    lo, hi = ph.ns_start, ph.ns_end
    busy = merged((max(s, lo), min(s + d, hi)) for s, d, _ in ph.kernels)
    return subtract([(lo, hi)], busy)


def host_step(spans) -> List[Interval]:
    """Where the host was inside a ``step`` span but outside its
    ``step.wait``: the host's own step work."""
    steps = merged((s[1], s[2]) for _, s in spans if s[0] == "step")
    waits = merged((s[1], s[2]) for _, s in spans if s[0] == "step.wait")
    return subtract(steps, waits)


def idle_host_ns(ph, spans) -> int:
    """Idle time of ``ph`` that the host's own step work left."""
    return overlap_ns(host_step(spans), idle(ph))


def idle_by_span(ph, spans) -> Dict[str, int]:
    """Idle ns of ``ph`` by the innermost span that holds it; ``""`` is
    the idle time outside every span."""
    gaps = idle(ph)
    kids: Dict[int, List[Interval]] = {}
    for _, s in spans:
        kids.setdefault(s[3], []).append((s[1], s[2]))
    out: Dict[str, int] = {}
    for i, s in spans:
        own = subtract([(s[1], s[2])], merged(kids.get(i, [])))
        out[s[0]] = out.get(s[0], 0) + overlap_ns(own, gaps)
    every = merged((s[1], s[2]) for _, s in spans)
    out[""] = length(gaps) - overlap_ns(every, gaps)
    return out
