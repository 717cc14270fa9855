"""Paged KV cache: fixed-size pages, per-sequence block tables, a free-list
(port of ``repro/serve/paged_kv.py``).

The continuous-batching engine (``ServeEngine.run``) stores K/V in a pool
of fixed-size pages shared by all in-flight sequences.  Each sequence owns
a *block table* -- logical block ``i`` (positions ``i*page_size ..
(i+1)*page_size - 1``) maps to a physical page id -- and pages are
allocated from / returned to a free-list as requests start, grow and
finish.  :func:`pages_needed`, :class:`PageAllocator`,
:class:`PagesExhausted` and :class:`BlockTables` are host-side numpy
bookkeeping, copied from the reference unchanged; :func:`scrub_pages` and
:func:`write_prefill` work on the pool's tensors, **in place**.

Invariants the rest of the stack relies on:

* **Page 0 is the trash page** (``TRASH_PAGE``): never handed out;
  unmapped block-table entries point at it, and only sentinel lanes write
  into it, so its position plane stays all-sentinel.
* **Position-sentinel scrubbing**: a page's ``pos`` slots are reset to
  ``POS_SENTINEL`` when it is allocated (:func:`scrub_pages`); K/V bytes
  of a previous owner may persist, unreachable behind the causal mask.
* **Layout** (``LM.init_paged_cache``): per pattern position ``{"k", "v":
  (R, P, page_size, Hkv, hd), "pos": (R, P, page_size)}`` (plus
  ``"k_s", "v_s"`` scale pages for int8 pools); all repeats write the same
  positions, so one block table serves every layer.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import backend
# the model's sentinel conventions are the single source of truth: the
# scheduler's idle-lane writes, the pool's scrub value and the allocator's
# reserved page must equal what the attention mask rejects and the paged
# write routes to
from repro_torch.models.transformer import POS_SENTINEL, TRASH_PAGE


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` KV positions."""
    return -(-max(n_tokens, 0) // page_size)


class PageAllocator:
    """Free-list allocator over physical page ids ``1 .. num_pages-1``.

    Page 0 (``TRASH_PAGE``) is reserved and never allocated.  ``alloc`` is
    all-or-nothing: it raises :class:`PagesExhausted` rather than returning a
    partial set, so callers either get a usable block run or can keep the
    request queued (admission backpressure).
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagesExhausted(
                f"requested {n} pages, {len(self._free)} free of "
                f"{self.num_pages - 1} allocatable")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"bad page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


class PagesExhausted(RuntimeError):
    """Raised when the KV pool cannot back a required allocation."""


class BlockTables:
    """Per-slot logical-block -> physical-page maps, as one int32 array.

    Row ``s`` is slot ``s``'s table; unmapped blocks point at ``TRASH_PAGE``.
    The array view (:meth:`as_array`) is what ``decode_step_paged`` indexes
    with ``pos // page_size`` on device.
    """

    def __init__(self, n_slots: int, blocks_per_seq: int):
        self.blocks_per_seq = blocks_per_seq
        self._table = np.full((n_slots, blocks_per_seq), TRASH_PAGE, np.int32)
        self._held: Dict[int, List[int]] = {s: [] for s in range(n_slots)}

    def held(self, slot: int) -> List[int]:
        """Per-logical-block entries for ``slot``: physical page ids, with
        ``TRASH_PAGE`` placeholders where a leading block was reclaimed
        (:meth:`free_prefix`) -- logical indices never shift."""
        return list(self._held[slot])

    def n_live(self, slot: int) -> int:
        """Physical pages actually held (excludes reclaimed placeholders)."""
        return sum(1 for p in self._held[slot] if p != TRASH_PAGE)

    def n_blocks(self, slot: int) -> int:
        return len(self._held[slot])

    def append(self, slot: int, pages: Sequence[int]) -> None:
        """Map ``pages`` to the next logical blocks of ``slot``."""
        start = len(self._held[slot])
        if start + len(pages) > self.blocks_per_seq:
            raise ValueError(
                f"slot {slot}: {start}+{len(pages)} blocks exceeds "
                f"blocks_per_seq={self.blocks_per_seq}")
        for i, p in enumerate(pages):
            self._table[slot, start + i] = p
        self._held[slot].extend(pages)

    def free_prefix(self, slot: int, upto: int) -> List[int]:
        """Unmap still-held pages of logical blocks ``[0, upto)``.

        Out-of-window reclamation for sliding-window sequences: the freed
        entries become ``TRASH_PAGE`` placeholders in both the table row and
        the held list, so later blocks keep their logical indices (block
        ``i`` must always mean positions ``i*page_size ..``) and gathers of
        the reclaimed range read the all-sentinel trash page.  Returns the
        freed physical pages (caller returns them to the allocator).
        """
        held = self._held[slot]
        freed = []
        for b in range(min(upto, len(held))):
            if held[b] != TRASH_PAGE:
                freed.append(held[b])
                held[b] = TRASH_PAGE
                self._table[slot, b] = TRASH_PAGE
        return freed

    def truncate_to(self, slot: int, n_blocks: int) -> List[int]:
        """Unmap logical blocks ``>= n_blocks`` of ``slot``; return their
        still-held physical pages (caller frees them).

        Speculative-decode rollback: a verify step grows pages out to the
        full draft span up front; after acceptance lands at position
        ``pos``, the scheduler truncates the table back to
        ``pages_needed(pos, page_size)`` blocks -- exactly the blocks
        plain decode would hold at that position -- so over-speculated
        pages return to the pool the same step they were rejected.  The
        tail is the mirror of :meth:`free_prefix`'s head: dropped entries
        shrink the held list (growth re-appends from ``n_blocks``), while
        any reclaimed ``TRASH_PAGE`` placeholders inside the kept prefix
        stay put.  The truncated table entries go back to ``TRASH_PAGE``,
        so gathers of the rolled-back range read the all-sentinel trash
        page; K/V bytes of *kept* pages past ``pos`` are left as-is --
        they carry positions ``> pos`` that the causal mask rejects until
        the stream overwrites them (the rollback invariant,
        docs/speculative.md).
        """
        held = self._held[slot]
        if n_blocks < 0:
            raise ValueError(f"n_blocks must be >= 0, got {n_blocks}")
        freed = [p for p in held[n_blocks:] if p != TRASH_PAGE]
        for b in range(n_blocks, len(held)):
            self._table[slot, b] = TRASH_PAGE
        del held[n_blocks:]
        return freed

    def release(self, slot: int) -> List[int]:
        """Unmap and return the slot's pages (caller frees them; reclaimed
        placeholder blocks are skipped -- their pages were freed already)."""
        pages = [p for p in self._held[slot] if p != TRASH_PAGE]
        self._held[slot] = []
        self._table[slot, :] = TRASH_PAGE
        return pages

    def as_array(self) -> np.ndarray:
        return self._table.copy()


# --------------------------------------------------------- pool operations
def scrub_pages(paged_cache, kinds: Sequence[str], pages: Sequence[int]):
    """Reset ``pos`` of freshly allocated pages to the sentinel, in place.

    Must run between a page leaving the free-list and any attention that
    could see it; K/V bytes are left as they are (masked by the sentinel
    positions).  Returns ``paged_cache``."""
    if not pages:
        return paged_cache
    idx = None
    for kind, entry in zip(kinds, paged_cache):
        if kind == "paged":
            if idx is None:
                idx = backend.upload(np.asarray(list(pages), np.int64),
                                     entry["pos"].device)
            entry["pos"].index_fill_(1, idx, POS_SENTINEL)   # no host copy
    return paged_cache


def write_prefill(paged_cache, dense_cache, kinds: Sequence[str], slot: int,
                  blocks: Sequence[int], page_size: int):
    """Scatter one request's freshly prefilled batch-1 dense cache into the
    pool, in place.  ``blocks`` are the slot's physical pages in logical
    order (covering the prompt, already scrubbed).  The scatter is driven
    by the dense cache's own ``pos`` plane, so a ring-buffer
    (sliding-window) cache copies exactly the positions it kept; every
    plane of the entry (k / v, ``pos``, int8 scale pages) copies the same
    way.  Reads the positions on the host (a device sync: this is the
    monolithic path).  A ``"state"`` (mamba) entry copies whole, every
    plane, into batch lane ``slot``, and a ``"memory"`` (cross-attention)
    entry its ``k`` and ``v`` whole into lane ``slot``.  A memory entry
    holds K/V in the pool's float type whatever ``kv_bits`` is (as the
    reference's ``init_paged_cache``), so an int8 dense memory (a
    ``kv_bits=8`` prefill) is refused: the reference copies its int8
    codes without their scales.  Returns ``paged_cache``."""
    for kind, pre in zip(kinds, dense_cache):
        if kind == "memory" and (pre["k"].dtype == torch.int8 or
                                 "k_s" in pre):
            raise ValueError(
                "write_prefill: a cross-attention memory entry stores K/V in "
                "the pool's float type whatever kv_bits is; an int8 "
                "(kv_bits=8) dense prefill would land as raw int8 codes "
                "without their scales -- prefill the memory in float")
    blocks_np = np.asarray(list(blocks), np.int64)
    for kind, pool, pre in zip(kinds, paged_cache, dense_cache):
        if kind in ("state", "memory"):
            for key in pool:
                pool[key][:, slot] = pre[key][:, 0].to(pool[key].dtype)
            continue
        pos = pre["pos"][0, 0].cpu().numpy()             # same across R
        j = np.nonzero(pos != POS_SENTINEL)[0]
        p = pos[j].astype(np.int64)
        dev = pool["pos"].device
        phys = torch.as_tensor(blocks_np[p // page_size], device=dev)
        pslot = torch.as_tensor(p % page_size, device=dev)
        jj = torch.as_tensor(j, device=dev)
        # pool planes are (R, P, ps, ...) and dense planes (R, 1, S, ...)
        # with matching trailing dims: one scatter form covers them all
        for key in pool:
            pool[key][:, phys, pslot] = pre[key][:, 0, jj].to(pool[key].dtype)
    return paged_cache
