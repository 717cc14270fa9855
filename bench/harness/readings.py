"""What the per-layer metric readers read: the record of a traced window,
split into the tracer's two phases, with the work that each phase's served
tokens needed.  A reader (``bench/metrics/<name>.py``) is a function
``read(r: Readings) -> float | None``; None leaves the metric out."""
from __future__ import annotations

from typing import Dict, Optional

from bench.harness import trace
from bench.harness.common import kernel_groups


class Readings:
    def __init__(self, cfg: Dict, record, tracer, widths, work_module):
        self.cfg = cfg
        self.record = record
        self.phases = {ph.name: ph for ph in tracer.phases}
        self.widths = widths
        self._work = work_module
        self._cache: Dict = {}

    # ------------------------------------------------------------ phases
    def phase(self, name: str):
        return self.phases.get(name)

    def bounds(self, name: str):
        ph = self.phases[name]
        return ph.t_start, ph.t_end

    def model_calls(self, name: str, entries=None) -> int:
        a, b = self.bounds(name)
        return self.record.calls_between(a, b, entries)

    @property
    def served(self) -> bool:
        """Tokens stamped one by one (the serving loop), not per batch."""
        return not self.record.batches

    # ------------------------------------------------------------ summary
    def summary(self, name: str) -> Dict:
        """The phase's served work: prompts whose prefill completed in it,
        decode tokens, and model calls by shape."""
        key = ("summary", name)
        if key in self._cache:
            return self._cache[key]
        a, b = self.bounds(name)
        rec = self.record
        s: Dict = {"prefill_lens": [], "decode_pos": [], "decode_tokens": 0,
                   "chunk": rec.chunk_tokens}
        for r in rec.reqs.values():
            P = r.prompt.size
            for i, t in enumerate(r.stamps):
                if not a <= t < b:
                    continue
                if i == 0:
                    s["prefill_lens"].append(P)
                else:
                    s["decode_pos"].append(P + i - 1)
        calls = [(e, w) for t, e, _, w in rec.calls if a <= t < b]
        s["chunk_calls"] = sum(e == "model_step" and w > 1 for e, w in calls)
        s["decode_calls"] = sum((e == "model_step" and w == 1) or
                                e == "decode_step_paged" for e, w in calls)
        s["prefill_calls"] = sum(e == "prefill" for e, _ in calls)
        if rec.batches:
            # a monolithic run stamps its tokens when the batch returns:
            # the phase's work is read from its calls, each decode step
            # at its batch's mean lanes (ServeStats)
            s["prefill_lens"] = [w for t, e, _, w in rec.calls
                                 if a <= t < b and e == "prefill"]
            s["decode_tokens"] = 0.0
            for t, e, _, _ in rec.calls:
                if a <= t < b and e == "decode_step_paged":
                    for t0, t1, dtok, steps in rec.batches:
                        if t0 <= t < t1 and steps:
                            s["decode_tokens"] += dtok / steps
        else:
            s["decode_tokens"] = len(s["decode_pos"])
        self._cache[key] = s
        return s

    def work(self, name: str) -> Dict:
        key = ("work", name)
        if key not in self._cache:
            self._cache[key] = self._work.phase(self.cfg["dims"], self.widths,
                                                self.summary(name))
        return self._cache[key]

    # ------------------------------------------------------------ device
    def group_s(self, name: str, group: str) -> float:
        ph = self.phases[name]
        ns, _ = trace.group_ns(ph.kernels, kernel_groups()[group]["patterns"])
        return ns / 1e9

    def busy_s(self, name: str) -> float:
        return trace.busy_ns(self.phases[name].kernels) / 1e9

    def range_s(self, name: str, rng: str) -> float:
        return trace.range_ns(self.phases[name], rng) / 1e9


def share(num: float, den: float) -> Optional[float]:
    """100 num / den, or None where there is nothing to read."""
    if den <= 0 or num <= 0:
        return None
    return 100.0 * num / den

