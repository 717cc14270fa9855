# Copied from src/repro/serve/stats.py unchanged.
"""Serving statistics: the measurable contract of ``ServeEngine``.

:class:`ServeStats` is the one record both execution models fill in
(``generate`` partially, ``run`` fully).  It separates three economies:

* **throughput** -- ``tokens_out`` / ``prefill_s`` / ``decode_s``, with
  ``prefill_tokens`` excluding first tokens (and chunk-riding decode
  tokens) from the steady-state ``decode_tok_per_s`` rate;
* **latency** -- per-request ``ttft_steps`` / ``ttft_s`` (1-based index of
  the model call whose logits produced the first token -- the same
  convention in chunked and monolithic modes, so step-based TTFT compares
  across them) and ``ttft_percentiles()``; open-loop serving adds
  ``queue_wait_s`` (arrival -> first admission), ``e2e_s`` (arrival ->
  last token) and the aggregate inter-token gap list ``itl_s``, each with
  a percentile view (``queue_wait_percentiles`` / ``e2e_percentiles`` /
  ``itl_percentiles``).  All wall-clock latency is measured against the
  front-end's clock and a request's *arrival* time -- for the closed-loop
  ``run()`` every request arrives at loop start, so ``ttft_s`` keeps its
  historical "seconds since run() began" meaning;
* **speculation** -- per-request accepted-token histograms
  (``accepted_hist``), ``draft_proposed`` / ``draft_accepted`` (rejected
  draft tokens are counted here and *nowhere else*: they never touch
  ``tokens_out``, TTFT, or the decode rate), ``acceptance_rate`` and
  ``spec_tokens_per_step`` -- the multi-token-decode win
  (docs/speculative.md has the math these feed).

Host-side plain data: no jax arrays, picklable, safe to compare across
runs.  ``serve/engine.py`` re-exports it for backward compatibility.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def _percentiles(vals, qs) -> Dict[int, float]:
    """Percentile dict over a value collection (empty dict when empty)."""
    vals = sorted(vals)
    if not vals:
        return {}
    arr = np.asarray(vals)
    return {q: float(np.percentile(arr, q)) for q in qs}


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0
    # tokens excluded from the decode rate: first tokens (sampled off prompt
    # logits) and, in chunked mode, decode tokens riding chunk-carrying
    # steps (whose time is accounted as prefill)
    prefill_tokens: int = 0
    steps: int = 0                  # engine steps (run(): batched steps)
    n_requests: int = 0
    mode: str = ""                  # run(): "chunked" | "monolithic"
    # prompt-token accounting by prefill style (how each prompt token was
    # pushed through the model): budgeted chunks vs batch-1 monolithic
    chunk_prefill_tokens: int = 0
    mono_prefill_tokens: int = 0
    # per-request time-to-first-token, keyed by request id: the 1-based
    # index of the model call whose logits produced the first token
    # (chunked: the step that completed the prompt; monolithic: the
    # admission prefill, counted as if it were the next step -- same
    # convention, so step-based TTFT compares across modes), and
    # wall-clock seconds since run() started
    ttft_steps: Dict[int, int] = dataclasses.field(default_factory=dict)
    ttft_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    # ---- open-loop latency (arrival-relative; front-end clock) ----
    # arrival -> first slot admission (a requeued prefill keeps its first
    # admission stamp: queue wait measures time to first service)
    queue_wait_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    e2e_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    # aggregate inter-token gaps across requests (time between consecutive
    # tokens *of the same stream* becoming host-visible)
    itl_s: List[float] = dataclasses.field(default_factory=list)
    shed: List[int] = dataclasses.field(default_factory=list)
    overlapped: bool = False        # chunked: pipelined dispatch active
    requeues: int = 0               # chunked: prefills preempted + requeued
    reclaimed_pages: int = 0        # out-of-window pages returned mid-run
    peak_pages: int = 0             # high-water mark of pool pages in use
    # ---- speculative decode (run(speculative=True)) ----
    spec_steps: int = 0             # verify steps with >= 1 speculating lane
    spec_lane_steps: int = 0        # per-lane verify events (lane x step)
    spec_tokens_out: int = 0        # tokens emitted by speculating lanes
    draft_proposed: int = 0         # draft tokens fed into verify chunks
    draft_accepted: int = 0         # of those, accepted into the stream
    # per-request histogram: rid -> {accepted draft count: # verify steps};
    # a lane that emits a+1 tokens in one verify step accepted a drafts
    accepted_hist: Dict[int, Dict[int, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def decode_tok_per_s(self) -> float:
        # tokens and time of prefill / chunk-carrying steps are excluded on
        # both sides, so this is the steady-state decode-batch rate
        return ((self.tokens_out - self.prefill_tokens) / self.decode_s
                if self.decode_s else 0.0)

    @property
    def acceptance_rate(self) -> float:
        """Accepted fraction of proposed draft tokens (0.0 when not
        speculating).  With a draft that bit-agrees with the target
        (draft == model) this is 1.0 -- the sanity ceiling the bench's
        ``--smoke`` gate pins."""
        return (self.draft_accepted / self.draft_proposed
                if self.draft_proposed else 0.0)

    @property
    def spec_tokens_per_step(self) -> float:
        """Emitted tokens per lane per verify step (the multi-token decode
        win; plain decode is 1.0 by construction, the ceiling is
        ``draft_k + 1`` -- every draft accepted plus the free
        continuation token)."""
        return (self.spec_tokens_out / self.spec_lane_steps
                if self.spec_lane_steps else 0.0)

    def record_acceptance(self, rid: int, proposed: int,
                          accepted: int) -> None:
        """Fold one lane's verify-step outcome into the speculation stats
        (``accepted`` drafts matched, so ``accepted + 1`` tokens were
        emitted -- the corrected/continuation token rides for free)."""
        self.spec_lane_steps += 1
        self.draft_proposed += proposed
        self.draft_accepted += accepted
        self.spec_tokens_out += accepted + 1
        hist = self.accepted_hist.setdefault(rid, {})
        hist[accepted] = hist.get(accepted, 0) + 1

    @property
    def n_shed(self) -> int:
        """Requests dropped before first admission (open-loop SLO)."""
        return len(self.shed)

    def ttft_percentiles(self, qs=(50, 99)) -> Dict[int, float]:
        """Percentiles of per-request TTFT seconds (empty dict if unset)."""
        return _percentiles(self.ttft_s.values(), qs)

    def queue_wait_percentiles(self, qs=(50, 99)) -> Dict[int, float]:
        """Percentiles of per-request queue wait (arrival -> admission)."""
        return _percentiles(self.queue_wait_s.values(), qs)

    def e2e_percentiles(self, qs=(50, 99)) -> Dict[int, float]:
        """Percentiles of per-request end-to-end latency (arrival -> last
        token host-visible)."""
        return _percentiles(self.e2e_s.values(), qs)

    def itl_percentiles(self, qs=(50, 99)) -> Dict[int, float]:
        """Percentiles of the aggregate inter-token gap population."""
        return _percentiles(self.itl_s, qs)
