"""Overlapped token-budget step loop: the serving back-end (port of
``repro/serve/step_loop.py``, speculative branch included).

Each step plans a fixed-shape batch (``Scheduler.plan_step``), runs one
``LM.model_step`` over it and samples every lane on the device.  Host and
device overlap as in the reference:

* **sample on the device** -- greedy lanes take the first maximum, a
  sampled lane draws from its own ``torch.Generator`` (seeded with the
  request's seed at admission), so only the (R,) token vector ever crosses
  to the host;
* **plan value-free** -- ``plan_step`` depends on token counts and
  positions only, so step t+1 is planned while step t's tokens are still on
  the device; the host records a ``PENDING`` placeholder for each;
* **feed back on the device** -- a decode lane's column-0 input for step
  t+1 is scattered in from step t's device-resident token vector
  (``tok_in[rows_d, 0] = last_tok[rows_d]``), so the model always sees the
  exact sampled token;
* **retire one step late** -- with ``overlap=True`` the host dispatches
  step t+1, then waits on a CUDA event recorded after step t's token
  vector was copied, without blocking, into pinned memory; it backfills
  the ``PENDING`` slots, fires stream callbacks in token order and stamps
  latency.  ``overlap=False`` retires each step at once.  Both produce the
  same streams bit for bit.

JAX's asynchronous dispatch becomes PyTorch's: kernels are queued on the
current stream and nothing inside a step waits for them.  A step must hold
no host sync (``.item()``, ``int(t)``, ``nonzero``, boolean-mask indexing,
``.cpu()``, a blocking host-to-device copy): any of them would quietly
make the loop synchronous.  Host arrays reach the card through
``backend.upload`` (pinned, non-blocking).

Speculative decode rides the same class but steps synchronously
(``overlap`` is ignored): acceptance needs token *values*, so each verify
step reads its (R, k + 1) candidate tokens back at once.  A step with a
chunk or a speculating lane runs at width ``max(chunk, k + 1)``, a pure
decode step at width 1: still two ``model_step`` shapes.  A verify step
makes two host syncs: the draft's proposal stack and the verify tokens.

Spans (``repro_torch.spans``, recorded while a profiler runs): each step
is a ``step`` span with the counts ``rows`` (R x w, the rows the model
call computes) and ``real_rows`` (the plan's prompt-chunk tokens, decode
lanes and speculative verify columns).  Its children: ``step.plan`` (admission, ``plan_step``, the page scrub),
``step.upload``, ``step.launch`` (the ``_model_step`` call: the host's
enqueue of the model's kernels), ``step.sample`` (sampling and the
bookkeeping of ``_finish_plain`` / ``_finish_spec``), ``step.wait`` (the
wait for a step's token vector) and ``step.emit`` (the stream callbacks).
A speculative step's ``step.wait`` and ``step.emit`` sit inside its
``step.sample``; a retirement outside any step (idle, loop exit) records
``step.wait`` and ``step.emit`` with no parent.  ``step`` and
``step.launch`` enclose a model call, so they open no ``record_function``
(``spans``' docstring says why).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend, spans
from repro_torch.serve import paged_kv
from repro_torch.serve.frontend import FrontEnd
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.stats import ServeStats

__all__ = ["StepLoop", "PENDING"]

# placeholder for a sampled-but-not-yet-synced token in host bookkeeping
# (scheduler ``out`` lists and the output streams); never fed to the model
# -- dispatch overrides decode feedback with the device-resident value
PENDING = -1


class StepLoop:
    """One serving session's back-end: drives a :class:`Scheduler` fed by
    a :class:`FrontEnd` until both are drained.

    Built by ``ServeEngine.serve`` (and through it by ``run``); owns the
    paged pool, the per-slot generators and temperatures, and the
    per-request output streams.  ``spec`` is the draft state of a
    speculative session (``ServeEngine._make_draft``), or None.
    """

    def __init__(self, engine, frontend: FrontEnd, sched: Scheduler, cache,
                 kinds, stats: ServeStats, *, num_pages: int, page_size: int,
                 chunk: int, budget: int, reclaim: Optional[int] = None,
                 spec: Optional[Dict[str, Any]] = None, overlap: bool = True):
        self.eng = engine
        self.fe = frontend
        self.sched = sched
        self.cache = cache
        self.kinds = kinds
        self.stats = stats
        self.num_pages = num_pages
        self.page_size = page_size
        self.chunk = chunk
        self.budget = budget
        self.reclaim = reclaim
        self.spec = spec
        self.overlap = bool(overlap) and spec is None
        self.device = engine.device
        n = sched.n_slots
        self.outputs: Dict[int, List[int]] = {}
        # per-slot sampling state, set at admission (a requeued request
        # re-seeds identically: it emitted nothing, so drew nothing)
        self._temps = np.zeros((n,), np.float32)
        self._gens: Dict[int, torch.Generator] = {}
        self._last_tok = torch.zeros((n,), dtype=torch.int64,
                                     device=self.device)
        # in-flight retirement record: ((host tokens, event), emit rows)
        self._inflight: Optional[Tuple[tuple, List[tuple]]] = None
        self._last_t: Dict[int, float] = {}   # rid -> last host-visible time

    # ------------------------------------------------------------ the loop
    def run(self) -> None:
        """Drain the front-end and scheduler: pump arrivals, step, idle
        between future arrivals.  Ends when no request is scheduled,
        queued, or running."""
        try:
            while True:
                now, released = self.fe.pump(self.sched)
                for req in released:
                    self.eng.check_fits(req)
                if not self.sched.has_work:
                    if self.fe.n_scheduled == 0:
                        break
                    self._retire()        # flush streams before idling
                    self.fe.wait(now)
                    continue
                self.step(now)
        finally:
            self._retire()

    def step(self, now: float) -> None:
        """One engine step: admit, plan, dispatch, sample, account, inside
        the span ``step`` and its children (module docstring)."""
        with spans.span("step", annotate=False) as counts:
            self._step(now, counts)

    def _step(self, now: float, counts) -> None:
        eng, sched, stats, spec = self.eng, self.sched, self.stats, self.spec
        k = spec["k"] if spec else 0
        W = max(self.chunk, k + 1) if spec else self.chunk
        with spans.span("step.plan"):
            if self.reclaim is not None:
                stats.reclaimed_pages += len(
                    sched.reclaim_out_of_window(self.reclaim))
            # ---- admission: a request joins when its first chunk fits
            fresh = []
            while (adm := sched.try_admit_chunked(self.chunk)) is not None:
                req, slot, pages = adm
                fresh += pages
                self._admit(req, slot, now)
            if not sched.running_slots():
                raise paged_kv.PagesExhausted(
                    "queued request cannot ever be admitted: pool of "
                    f"{self.num_pages} pages (page_size={self.page_size}) "
                    "is too small for its first chunk + decode headroom")
            t0 = self.fe.now()
            plan = sched.plan_step(self.chunk, self.budget, draft_k=k)
            stats.requeues += len(plan["requeued"])
            # a request admitted above may have been preempted inside this
            # very plan_step: its admission pages are back on the free
            # list, so drop the stale aliases from the scrub set
            drop = set(plan["freed"])
            fresh = [p for p in fresh if p not in drop]
            # scrub unconditionally: admission pages must be sentinel-clean
            # before any later step writes chunks into them.  The draft
            # cache shares the block tables, so it scrubs the same pages.
            paged_kv.scrub_pages(self.cache, self.kinds,
                                 fresh + plan["fresh"])
            if spec:
                paged_kv.scrub_pages(spec["cache"], self.kinds,
                                     fresh + plan["fresh"])
        if not plan["sample"] and not plan["chunked"]:
            return                  # every planned slot was preempted
        # pure-decode steps run the (R, 1) column slice: two shapes per run
        spec_lanes = {i: c for i, c in plan["spec"].items() if c > 1}
        w = W if (plan["chunked"] or spec_lanes) else 1
        tokens = plan["tokens"]
        if counts is not None:
            counts.update(
                rows=tokens.shape[0] * w,
                real_rows=sum(plan["chunked"].values()) + sum(
                    plan["spec"].get(i, 1) for i in plan["decode"]))
        if spec and (plan["chunked"] or plan["spec"]):
            # the draft pass fills each speculating lane's verify columns
            drafts = eng._draft_propose(spec, plan, sched, spec_lanes,
                                        W if plan["chunked"] else 2)
            for i, cols in spec_lanes.items():
                tokens[i, 1:cols] = drafts[i][:cols - 1]
        dev = self.device
        with spans.span("step.upload"):
            tok_in = backend.upload(tokens[:, :w].astype(np.int64), dev)
            if spec is None and plan["decode"]:
                # decode feedback stays exact: the host holds PENDING, the
                # device value is authoritative (spec mode records values)
                rows_d = backend.upload(np.asarray(plan["decode"], np.int64),
                                        dev)
                tok_in[rows_d, 0] = self._last_tok[rows_d]
            pos = backend.upload(plan["positions"][:, :w], dev)
            slot_map = backend.upload(plan["slot_map"], dev)
            tables = backend.upload(sched.tables.as_array(), dev)
            logit_cols = backend.upload(plan["logit_cols"], dev)
        with spans.span("step.launch", annotate=False):
            logits, self.cache = eng._model_step(
                eng.params, tok_in, pos, slot_map, self.cache, tables,
                logit_cols, eng.act_bits, attn_impl=eng.attn_impl)
        stats.chunk_prefill_tokens += sum(plan["chunked"].values())
        retire = None
        with spans.span("step.sample"):
            # a sampled lane draws its verify columns (decode lanes) or its
            # one token (a chunk that ends its prompt)
            toks, states = eng._sample_span(
                logits, {i: (self._gens[i], float(self._temps[i]),
                             plan["spec"].get(i, 1))
                         for i in plan["sample"] if self._temps[i] > 0})
            if spec:
                emitted_step = self._finish_spec(plan, spec_lanes, tokens,
                                                 toks, states)
            else:
                emitted_step, retire = self._finish_plain(plan, toks[:, 0])
        if retire is not None:
            self._retire_record(retire)
        dt = self.fe.now() - t0
        # chunk-carrying steps are prefill-side: their time and their
        # sampled tokens leave the decode rate
        if plan["chunked"]:
            stats.prefill_s += dt
            stats.prefill_tokens += emitted_step
        else:
            stats.decode_s += dt
        stats.steps += 1
        stats.peak_pages = max(stats.peak_pages,
                               self.num_pages - 1 - sched.allocator.n_free)

    # ---------------------------------------------------------- inner steps
    def _admit(self, req: Request, slot: int, now: float) -> None:
        rid = req.rid
        if rid not in self.stats.queue_wait_s:
            arrival = self.fe.arrival_s.get(rid)
            if arrival is not None:
                self.stats.queue_wait_s[rid] = now - arrival
        self.fe.note_admitted(rid)
        self._temps[slot] = req.temperature
        self._gens.pop(slot, None)
        if req.temperature > 0:
            self._gens[slot] = backend.make_generator(req.seed, self.device)

    def _finish_plain(self, plan, toks):
        """Value-free advance: record PENDING placeholders and start the
        token vector's copy to the host.  Returns (tokens emitted, the
        record to retire now): the previous step's (pipelined, None on the
        first step) or this one's (synchronous)."""
        sched, stats = self.sched, self.stats
        rows = []
        for i in plan["sample"]:
            s = sched.slot(i)
            rid = s.req.rid
            out = self.outputs.setdefault(rid, [])
            idx = len(out)
            out.append(PENDING)
            first = not s.out
            if first:
                stats.ttft_steps[rid] = stats.steps + 1
                done = sched.record_first(i, PENDING)
            else:
                done = sched.record(i, PENDING)
            rows.append((i, rid, idx, first, done))
            stats.tokens_out += 1
        self._last_tok = toks
        pending = (self._to_host(toks), rows)
        if self.overlap:
            pending, self._inflight = self._inflight, pending
        return len(rows), pending

    def _finish_spec(self, plan, spec_lanes, tokens, toks, states) -> int:
        """Synchronous accept / rollback of a speculative step: walk each
        lane's candidate span on the host, keep the longest draft / sample
        agreement prefix plus the corrected token.  Every emitted token
        comes from the logits row and the generator state plain decode
        would use (a sampled lane rewinds to its emitted count), so
        acceptance changes speed, never output.  The read of the tokens is
        the span ``step.wait``, and the stream callbacks, fired in token
        order once every lane is walked, ``step.emit``."""
        sched, stats, spec = self.sched, self.stats, self.spec
        with spans.span("step.wait"):
            vals = toks.cpu().numpy()         # (R, C): one transfer
        now = self.fe.now()
        emits = []                            # (rid, idx, tok, first, done)
        emitted_step = 0
        for i in plan["sample"]:
            s = sched.slot(i)
            rid = s.req.rid
            out = self.outputs.setdefault(rid, [])
            if not s.out:                     # the request's first token
                tok = int(vals[i, 0])
                out.append(tok)
                stats.tokens_out += 1
                emitted_step += 1
                stats.ttft_steps[rid] = stats.steps + 1
                done = sched.record_first(i, tok)
                emits.append((rid, len(out) - 1, tok, True, done))
                continue
            cols = plan["spec"].get(i, 1)
            emitted = []
            for j in range(cols):
                tok = int(vals[i, j])
                emitted.append(tok)
                if j + 1 >= cols or tokens[i, j + 1] != tok:
                    break
            if len(emitted) < len(states.get(i, ())):
                self._gens[i].set_state(states[i][len(emitted)])
            if cols > 1:
                stats.record_acceptance(rid, cols - 1, len(emitted) - 1)
            done = False
            for tok in emitted:
                out.append(tok)
                stats.tokens_out += 1
                done = sched.record(i, tok)
                emits.append((rid, len(out) - 1, tok, False, done))
            emitted_step += len(emitted)
            if done:
                spec["frontier"].pop(i, None)  # slot may be re-admitted
            elif cols > 1:
                # pages past the acceptance point backed only rejected
                # draft positions: return them now; the draft write cursor
                # clamps back too
                sched.rollback_speculation(i)
                f = spec["frontier"]
                f[i] = min(f.get(i, s.pos), s.pos)
        if spec_lanes:
            stats.spec_steps += 1
        with spans.span("step.emit"):
            for rid, idx, tok, first, done in emits:
                self._emit(rid, idx, tok, now, first, done)
        return emitted_step

    def _to_host(self, toks: torch.Tensor):
        """Start the (R,) token vector's copy to the host: into pinned
        memory without blocking, with an event to wait on (on the card);
        the tensor itself on the CPU."""
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    # ----------------------------------------------------------- retirement
    def _retire(self) -> None:
        """Retire the in-flight step, if any (loop exit / idle / error)."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._retire_record(prev)

    def _retire_record(self, pending) -> None:
        """Wait for one step's token vector -- the only blocking point per
        step -- and make its tokens host-visible: backfill PENDING output
        slots, fire stream callbacks, stamp latency."""
        (host, done), rows = pending
        with spans.span("step.wait"):
            if done is not None:
                done.synchronize()
        vals = host.numpy()
        now = self.fe.now()
        with spans.span("step.emit"):
            for slot, rid, idx, first, fin in rows:
                tok = int(vals[slot])
                self.outputs[rid][idx] = tok
                self._emit(rid, idx, tok, now, first, fin)

    def _emit(self, rid: int, idx: int, tok: int, now: float, first: bool,
              done: bool) -> None:
        """One token became host-visible: latency stats + stream callback."""
        stats = self.stats
        arrival = self.fe.arrival_s.get(rid)
        if first:
            if arrival is not None:
                stats.ttft_s[rid] = now - arrival
        else:
            prev_t = self._last_t.get(rid)
            if prev_t is not None:
                stats.itl_s.append(now - prev_t)
        self._last_t[rid] = now
        if done:
            if arrival is not None:
                stats.e2e_s[rid] = now - arrival
            self._last_t.pop(rid, None)
        self.fe.emit(rid, idx, tok)
