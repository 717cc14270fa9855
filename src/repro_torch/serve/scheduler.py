# Copied from src/repro/serve/scheduler.py; the import of paged_kv names
# the port's module, and the docstring says which patterns chunk here.
"""Continuous-batching request scheduler for the paged serving engine.

Iteration-level (Orca-style) scheduling: the batch is a fixed array of
*slots*; at every engine step, finished sequences leave their slot and
free their pages, and queued requests are admitted into free slots -- new
work joins the batch between steps instead of waiting for the whole batch
to drain.  Two admission styles share the slot table:

* **chunked** (:meth:`try_admit_chunked` + :meth:`plan_step`, the engine
  default): a request is admitted when its *first prompt chunk* fits, and
  the prompt is fed chunk by chunk through the engine's unified
  ``model_step`` under a per-step token budget -- decode lanes take 1
  token each first (or a ``draft_k + 1``-column *speculative verify span*
  when the engine runs multi-token decode; over-speculated tail pages are
  returned post-step by :meth:`rollback_speculation`), the remainder funds
  prompt chunks.  A prefilling sequence whose pages cannot grow is
  preempted and *requeued* (it has emitted nothing, so a restart replays
  the identical stream).
* **monolithic** (:meth:`try_admit` + :meth:`batch`): the legacy path --
  the whole prompt's pages up front, one batch-1 prefill per request.
  In the port, attention and mamba patterns chunk either way (a mamba
  slot's recurrent state rides ``model_step``); the reference's engine
  serves mamba patterns monolithically only.

State machine per request::

    submit() -> QUEUED --admit--> RUNNING: prefilling --> RUNNING: decoding
                  ^                  | (chunked only)          |
                  |                  '--requeue (preempted)    v
                  '-- stays queued if no free slot /       FINISHED
                      not enough free pages

Page lifecycle (the scheduler is the only allocator client): pages are
allocated at admission (first chunk / whole prompt) and as write positions
cross page boundaries (:meth:`plan_step` / :meth:`ensure_pages`); freed at
finish, at requeue, and -- for all-sliding-window patterns -- as soon as a
page falls wholly behind every future attention window
(:meth:`reclaim_out_of_window`).  Exhaustion mid-growth raises
:class:`~.paged_kv.PagesExhausted` only when no prefilling sequence is
left to preempt.

The scheduler is pure host-side bookkeeping (numpy block tables, Python
free-list): it never touches device arrays.  The engine owns jit'd model
calls and asks the scheduler for the batch arrays each step.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.paged_kv import (POS_SENTINEL, BlockTables, PageAllocator,
                                  PagesExhausted, pages_needed)


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens + decode budget."""
    rid: int
    tokens: np.ndarray            # (S,) int32 prompt
    n_new: int                    # tokens to generate (>= 1)
    temperature: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.n_new < 1:
            raise ValueError(f"request {self.rid}: n_new must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.size)


@dataclasses.dataclass
class _Slot:
    """Decode-batch slot state for one RUNNING request."""
    req: Request
    pos: int                      # next write position (= tokens seen so far)
    out: List[int]                # emitted tokens
    seq: int = 0                  # admission order stamp (requeue keeps FIFO)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.req.n_new

    @property
    def prefilling(self) -> bool:
        """Chunked admission: prompt tokens still to be fed.  (Monolithic
        admission binds at ``pos == prompt_len``, so it is never True.)"""
        return self.pos < self.req.prompt_len


_RESERVED = object()      # slot handed out by try_admit, awaiting bind()


class Scheduler:
    """Admission queue + slot table + page bookkeeping."""

    def __init__(self, n_slots: int, page_size: int, blocks_per_seq: int,
                 allocator: PageAllocator):
        self.n_slots = n_slots
        self.page_size = page_size
        self.allocator = allocator
        self.tables = BlockTables(n_slots, blocks_per_seq)
        self._queue: Deque[Request] = deque()
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        self.n_finished = 0
        self._admit_seq = 0       # admissions so far (stamps _Slot.seq)

    # ------------------------------------------------------------- queries
    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def n_running(self) -> int:
        return len(self.running_slots())

    def running_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots)
                if isinstance(s, _Slot)]

    def slot(self, i: int) -> _Slot:
        s = self._slots[i]
        assert isinstance(s, _Slot), f"slot {i} is not running"
        return s

    # ----------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def drop_queued(self, rid: int) -> bool:
        """Remove a still-queued request (open-loop SLO shedding).

        Only requests that never reached a slot can be dropped -- once
        admitted a request owns pages and (possibly) emitted tokens, and
        shedding it would tear a stream mid-flight.  Returns True iff the
        request was found in the queue and removed."""
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                return True
        return False

    def try_admit(self) -> Optional[Tuple[Request, int, List[int]]]:
        """Admit the queue head if a slot and enough pages are free.

        Returns (request, slot index, prompt pages in logical order), with
        the pages already allocated and mapped, or None if the head must
        wait (FIFO: later, smaller requests never jump the queue -- keeps
        admission starvation-free).  The caller prefills the request,
        scrubs + fills the pages, then calls :meth:`bind`.
        """
        if not self._queue:
            return None
        free_slot = next((i for i, s in enumerate(self._slots) if s is None),
                         None)
        if free_slot is None:
            return None
        req = self._queue[0]
        need = pages_needed(req.prompt_len, self.page_size)
        # positions ever written: 0 .. prompt+n_new-2 (the final emitted
        # token is never fed back), so this is the request's lifetime total
        total = pages_needed(req.prompt_len + req.n_new - 1, self.page_size)
        if self.allocator.n_free < min(need + 1, total):
            return None                          # wait: decode headroom
        self._queue.popleft()
        pages = self.allocator.alloc(need)
        self.tables.append(free_slot, pages)
        self._slots[free_slot] = _RESERVED     # until bind(); never batched
        return req, free_slot, pages

    def bind(self, slot: int, req: Request, first_token: int) -> bool:
        """Install a prefilled request into its slot with its first emitted
        token (sampled from the prefill logits).  Returns True if the
        request is already finished (n_new == 1)."""
        s = _Slot(req=req, pos=req.prompt_len, out=[int(first_token)])
        self._slots[slot] = s
        if s.done:
            self._release(slot)
            return True
        return False

    # --------------------------------------------------- chunked admission
    def try_admit_chunked(self, chunk: int
                          ) -> Optional[Tuple[Request, int, List[int]]]:
        """Admit the queue head when its *first chunk* fits.

        Unlike :meth:`try_admit`, admission requires pages for only
        ``min(chunk, prompt_len)`` positions (plus the usual one-page
        headroom, capped at the request's lifetime total) -- a long prompt
        no longer waits for its whole page run to be free.  The slot is
        installed RUNNING immediately with a chunk cursor at position 0;
        the step loop (:meth:`plan_step`) feeds the prompt chunk by chunk
        and samples the first token when the cursor reaches the prompt end.
        Returns (request, slot, first-chunk pages to scrub) or None.
        """
        if not self._queue:
            return None
        free_slot = next((i for i, s in enumerate(self._slots) if s is None),
                         None)
        if free_slot is None:
            return None
        req = self._queue[0]
        need = pages_needed(min(chunk, req.prompt_len), self.page_size)
        total = pages_needed(req.prompt_len + req.n_new - 1, self.page_size)
        if self.allocator.n_free < min(need + 1, total):
            return None                          # wait: chunk + headroom
        self._queue.popleft()
        pages = self.allocator.alloc(need)
        self.tables.append(free_slot, pages)
        self._slots[free_slot] = _Slot(req=req, pos=0, out=[],
                                       seq=self._admit_seq)
        self._admit_seq += 1
        return req, free_slot, pages

    def plan_step(self, chunk: int, token_budget: int,
                  draft_k: int = 0) -> Dict[str, object]:
        """Build one fixed-shape token-budget batch (the *step plan*).

        Every decode-ready slot contributes its feedback token first
        (decode is never starved); with ``draft_k > 0`` each decode lane is
        additionally planned as a **speculative span** of up to
        ``draft_k + 1`` verify columns (feedback + ``draft_k`` draft
        tokens, capped at the request's remaining ``n_new`` and charged in
        full against the budget -- a lane the budget or the pool cannot
        back degrades toward plain 1-token decode, never below it).  The
        remaining budget funds prompt-chunk tokens for prefilling slots in
        slot order, up to ``chunk`` per slot per step (partial chunks are
        fine -- padded columns carry sentinel positions).  Newly needed
        pages are allocated here; if a *chunk* cannot be backed, the
        youngest prefilling slot is requeued (pages freed, request back at
        the queue head -- it has emitted nothing, so a later restart
        reproduces its stream) rather than failing the whole workload; if
        a *decode* token cannot be backed, prefilling slots are requeued
        to free pages first and only then does
        :class:`~.paged_kv.PagesExhausted` propagate (nothing left to
        preempt: the pool is smaller than the running set's worst case).
        Draft columns past the first never preempt anyone -- speculation
        is best-effort, and its tail pages are returned post-step by
        :meth:`rollback_speculation`.

        Returns the **plan dict** -- the engine<->scheduler step contract
        (pinned in docs/serving.md; every key, every step, both consumers):

        ``"tokens"``, ``"positions"`` : (n_slots, W) int32 device-ready
            arrays, ``W = chunk`` (or ``max(chunk, draft_k + 1)`` when
            speculating).  Real tokens left-aligned per row; padding
            carries ``POS_SENTINEL`` positions.  Draft columns (1..span-1
            of a speculating row) are *placeholders* the engine fills
            after the draft pass -- the plan fixes their positions only.
            A decode row's column 0 carries the *host view* of the lane's
            last sampled token, which a pipelined engine may not have
            synced yet (the overlapped step loop records a ``PENDING``
            placeholder and substitutes the exact device-resident token
            at dispatch).  The plan itself is **one-step-stale tolerant**
            by construction: chunk planning, page growth, and preemption
            depend only on token *counts* and positions, never on token
            values, so a stale (or placeholder) feedback value changes
            nothing but the bits the engine overrides anyway.
        ``"slot_map"`` : (n_slots,) int32 row -> scheduler slot (identity
            here; the contract allows compaction).
        ``"logit_cols"`` : (n_slots,) int32 -- each row's last real
            column, whose logits the sampler reads; with ``draft_k > 0``
            shaped (n_slots, draft_k + 1), one column per verify position
            (padded by repeating the last) -- ``model_step``'s 2-D form.
        ``"sample"`` : slots emitting >= 1 token this step -- every decode
            lane, plus each prefilling slot whose chunk reaches its prompt
            end this step (its first token; TTFT).
        ``"decode"`` : the decode-lane subset of ``"sample"`` (slots whose
            column-0 token is *feedback*, i.e. exactly the rows whose
            input an overlapped engine must source from the previous
            step's device-resident sample).
        ``"spec"`` : slot -> planned verify-span width (1..draft_k+1) for
            decode lanes when ``draft_k > 0``, else ``{}``.  Width 1 means
            the lane degraded to plain decode (no draft pass for it).
        ``"chunked"`` : slot -> prompt-chunk tokens fed this step (the
            step is *chunk-carrying* iff non-empty: its wall time and
            sampled tokens are accounted prefill-side).
        ``"fresh"`` : pages allocated this step, still owned by a live
            slot -- the engine must scrub them (sentinel ``pos``) before
            the model call touches the pool.
        ``"freed"`` : pages free-listed by preemptions this step -- the
            engine must drop stale aliases of them (e.g. this step's
            admission pages) from its own scrub set; they may already be
            re-allocated under a new owner in ``"fresh"``.
        ``"requeued"`` : request ids sent back to the queue head (their
            slots vacated; FIFO order preserved).
        """
        n = self.n_slots
        W = chunk if draft_k == 0 else max(chunk, draft_k + 1)
        tokens = np.zeros((n, W), np.int32)
        positions = np.full((n, W), POS_SENTINEL, np.int32)
        logit_cols = np.zeros((n,) if draft_k == 0 else (n, draft_k + 1),
                              np.int32)
        sample: List[int] = []
        fresh: List[int] = []
        freed: List[int] = []
        preempted: List[_Slot] = []
        chunked: Dict[int, int] = {}
        spec: Dict[int, int] = {}
        budget = token_budget

        # decode lanes are never preempted, so this snapshot is stable even
        # while prefilling slots are being vacated to back them
        decode_lanes = [i for i in self.running_slots()
                        if not self._slots[i].prefilling]
        lane_cols: Dict[int, int] = {}
        # draft-tail pages granted this step, per lane: (first col using
        # the page, page id) -- the shed pool for mandatory allocations
        lane_tail: Dict[int, List[Tuple[int, int]]] = {}

        def shed_draft_page() -> bool:
            """Give back the newest draft-tail page of the widest planned
            span: speculation is best-effort, a feedback token is not.
            Plain decode must never fail where it would have succeeded
            without speculation."""
            cand = [(c, i) for i, c in lane_cols.items() if lane_tail.get(i)]
            if not cand:
                return False
            _, i = max(cand)
            j, page = lane_tail[i].pop()
            trunc = self.tables.truncate_to(i, self.tables.n_blocks(i) - 1)
            assert trunc == [page], (trunc, page)
            fresh.remove(page)
            self.allocator.free([page])
            lane_cols[i] = j          # span now ends where that block began
            return True

        for d_idx, i in enumerate(decode_lanes):  # decode lanes first
            s = self._slots[i]
            remaining = s.req.n_new - len(s.out)
            later = len(decode_lanes) - d_idx - 1   # their 1-token floor
            span = 1 if draft_k == 0 else \
                max(1, min(draft_k + 1, remaining, budget - later))
            cols = 0
            for j in range(span):
                if j == 0:
                    # the feedback token is mandatory: preempt prefilling
                    # slots, then shed other lanes' draft tails, or raise
                    while True:
                        try:
                            fresh += self._ensure_block(i, s.pos)
                            break
                        except PagesExhausted:
                            victim = self._youngest_prefilling()
                            if victim is not None:
                                v, pages = self._preempt(victim)
                                preempted.append(v)
                                freed += pages
                            elif not shed_draft_page():
                                raise
                else:
                    try:                  # draft columns are best-effort
                        got = self._ensure_block(i, s.pos + j)
                    except PagesExhausted:
                        break             # degrade the span, keep the lane
                    fresh += got
                    if got:
                        lane_tail.setdefault(i, []).append((j, got[0]))
                cols += 1
            lane_cols[i] = cols
            budget -= cols
        # array fill second: a lane's span may have shrunk after its pass
        # (shed_draft_page), so widths are only final here
        for i in decode_lanes:
            s = self._slots[i]
            cols = lane_cols[i]
            tokens[i, 0] = s.out[-1]
            positions[i, :cols] = np.arange(s.pos, s.pos + cols,
                                            dtype=np.int32)
            if draft_k > 0:
                logit_cols[i] = np.minimum(np.arange(draft_k + 1), cols - 1)
                spec[i] = cols
            sample.append(i)

        for i in self.running_slots():           # then prompt chunks
            s = self._slots[i]
            if not isinstance(s, _Slot) or not s.prefilling:
                continue
            c = min(chunk, s.req.prompt_len - s.pos, max(budget, 0))
            if c <= 0:
                continue                         # idle this step (budget)
            added: List[int] = []                # this slot's new pages only
            try:
                for p in range(s.pos, s.pos + c):
                    added += self._ensure_block(i, p)
            except PagesExhausted:
                if all(not (isinstance(o, _Slot) and o is not s)
                       for o in self._slots):
                    raise                        # alone and cannot grow
                # _preempt frees `added` back to the allocator; keeping the
                # pages out of `fresh` stops the engine scrubbing free-listed
                # (possibly re-allocated) pages
                v, pages = self._preempt(i)
                preempted.append(v)
                freed += pages
                continue
            fresh += added
            tokens[i, :c] = s.req.tokens[s.pos:s.pos + c]
            positions[i, :c] = np.arange(s.pos, s.pos + c, dtype=np.int32)
            chunked[i] = c
            s.pos += c
            budget -= c
            if not s.prefilling:                 # chunk reached prompt end
                logit_cols[i] = c - 1            # 2-D: whole row (one col)
                sample.append(i)
        # re-insert preempted requests youngest-admission first, so the
        # oldest ends up at the queue front: FIFO order survives even a
        # multi-preemption step
        for s in sorted(preempted, key=lambda s: s.seq, reverse=True):
            self._queue.appendleft(s.req)
        return {"tokens": tokens, "positions": positions,
                "slot_map": np.arange(n, dtype=np.int32),
                "logit_cols": logit_cols, "sample": sample,
                "decode": decode_lanes, "spec": spec,
                "chunked": chunked, "fresh": fresh, "freed": freed,
                "requeued": [s.req.rid for s in preempted]}

    def record_first(self, slot: int, token: int) -> bool:
        """Record a chunk-completed slot's first token (sampled from this
        step's logits at the prompt's last position).  The cursor stays at
        ``prompt_len`` -- exactly :meth:`bind`'s contract -- so the next
        step decodes from there.  Returns True when n_new == 1 (done)."""
        s = self.slot(slot)
        assert not s.out and not s.prefilling
        s.out.append(int(token))
        if s.done:
            self._release(slot)
            return True
        return False

    def rollback_speculation(self, slot: int) -> List[int]:
        """Return a lane's over-speculated tail pages to the pool.

        Called by the engine after a verify step's acceptance landed and
        :meth:`record` advanced the cursor: blocks past
        ``pages_needed(pos, page_size)`` backed only rejected draft
        positions, so the table is truncated
        (:meth:`~.paged_kv.BlockTables.truncate_to`) and their pages
        freed.  Post-rollback occupancy is *exactly* what plain decode
        would hold at the same position -- the no-leak invariant the
        speculative property suite pins (tests/test_speculative.py).
        Stale K/V inside kept pages needs no scrub: its positions exceed
        the cursor, so the causal mask rejects it until the stream
        overwrites it in place.  Returns the freed pages."""
        s = self.slot(slot)
        freed = self.tables.truncate_to(
            slot, pages_needed(s.pos, self.page_size))
        if freed:
            self.allocator.free(freed)
        return freed

    def _ensure_block(self, slot: int, pos: int) -> List[int]:
        """Back write position ``pos`` of ``slot`` with a page (may alloc)."""
        if pos // self.page_size >= self.tables.n_blocks(slot):
            page = self.allocator.alloc(1)
            self.tables.append(slot, page)
            return page
        return []

    def _youngest_prefilling(self) -> Optional[int]:
        """Prefilling slot with the least progress (cheapest to restart)."""
        cand = [(self.slot(i).pos, i) for i in self.running_slots()
                if self.slot(i).prefilling]
        return min(cand)[1] if cand else None

    def _preempt(self, slot: int) -> Tuple[_Slot, List[int]]:
        """Preempt a prefilling slot: free its pages, vacate the slot.

        Only legal mid-prefill (no tokens emitted yet), so the restart
        replays the prompt from scratch and the emitted stream is
        unchanged.  The caller re-inserts the request at the queue front in
        admission (seq) order -- everything preempted was admitted before
        anything still queued, so FIFO order is kept.  Returns the slot
        state and the pages freed, so the planner can report free-listed
        pages (the engine must not scrub them under a stale alias)."""
        s = self.slot(slot)
        assert not s.out, "requeue after tokens were emitted would drop them"
        pages = self.tables.release(slot)
        self.allocator.free(pages)
        self._slots[slot] = None
        return s, pages

    def reclaim_out_of_window(self, window: int) -> List[int]:
        """Return pages wholly behind every future attention window.

        For all-sliding-window patterns the next query position of slot
        ``i`` is ``pos``; it (and every later one) attends positions
        ``> pos - window`` only, so logical blocks entirely below
        ``(pos - window + 1)`` are dead.  They go back to the free list at
        the step boundary -- the paged kernel never fetched them anyway
        (its ``first`` re-basing uses the same arithmetic).  Pool occupancy
        becomes O(window) per sequence instead of O(generated length).
        """
        freed: List[int] = []
        for i in self.running_slots():
            s = self.slot(i)
            first_live = max(0, s.pos - window + 1) // self.page_size
            freed += self.tables.free_prefix(i, first_live)
        if freed:
            self.allocator.free(freed)
        return freed

    # -------------------------------------------------------------- decode
    def ensure_pages(self) -> List[int]:
        """Back every running sequence's next write position with a page.

        Returns the newly allocated pages (caller must scrub their ``pos``
        before the decode step).  Raises PagesExhausted if the pool cannot
        grow a running sequence -- admission headroom makes this unreachable
        unless the pool is smaller than one sequence's worst case."""
        fresh: List[int] = []
        for i in self.running_slots():
            s = self.slot(i)
            if s.pos // self.page_size >= self.tables.n_blocks(i):
                page = self.allocator.alloc(1)
                self.tables.append(i, page)
                fresh.extend(page)
        return fresh

    def batch(self) -> Dict[str, np.ndarray]:
        """Fixed-shape decode batch arrays.

        Idle slots carry token 0, an all-trash block-table row, and --
        load-bearing -- ``pos = POS_SENTINEL``: their lanes still execute
        the KV write, and the sentinel both routes it to the trash page
        (block index clips into the all-trash row) and makes the written
        entry unattendable (the causal mask rejects sentinel positions).
        An idle lane must never write a *real* position anywhere, or active
        sequences gathering their own unmapped (trash) blocks would see a
        fake valid KV entry."""
        tokens = np.zeros((self.n_slots, 1), np.int32)
        pos = np.full((self.n_slots,), POS_SENTINEL, np.int32)
        for i in self.running_slots():
            s = self.slot(i)
            tokens[i, 0] = s.out[-1]
            pos[i] = s.pos
        return {"tokens": tokens, "pos": pos,
                "block_tables": self.tables.as_array()}

    def record(self, slot: int, token: int) -> bool:
        """Record one decoded token; returns True (and releases the slot's
        pages) when the request just finished."""
        s = self.slot(slot)
        s.out.append(int(token))
        s.pos += 1
        if s.done:
            self._release(slot)
            return True
        return False

    # ------------------------------------------------------------- release
    def _release(self, slot: int) -> None:
        self.allocator.free(self.tables.release(slot))
        self._slots[slot] = None
        self.n_finished += 1
