"""Serving engine (port of ``repro/serve/engine.py``): batch-at-a-time
``generate`` over the dense KV cache, and continuous batching over the
paged pool through ``run`` and ``serve``.

The engine deploys a searched :class:`QuantPolicy` at load time into one of
two weight stores:

* ``weight_store="fake"`` -- fake-quantized f32 tensors (search-time
  numerics, full-size footprint); their matmuls are plain ``x @ w``;
* ``weight_store="packed"`` -- the bucketed sub-byte store
  (``quant.apply.apply_policy_packed``), whose matmuls run one CUDA kernel
  per bucket on the card (K3 for int2 / int4, K2 for int8; an MoE expert
  stack one launch per bucket for all its experts).

Params that arrive already in the uniform int8 store
(``LM.quantize_params_int8``) are served as they are, every matmul on K2,
as the reference's engine serves them.  The KV cache and pool hold
``cache_dtype`` (fp32 by default, or bf16) or, with ``kv_bits=8``, int8.

Attention runs on the CUDA kernels by default (``attn_impl="cuda"``: K1
over the dense cache, K4 over the paged pool); ``attn_impl="ref"`` is the
escape hatch to the plain versions.  The engine runs on the card unless
constructed with ``device="cpu"``.

``run`` is the closed-loop client of ``serve``: it submits every request
to a :class:`FrontEnd` at once and drains it through the overlapped
token-budget :class:`StepLoop` (``prefill="chunked"``), or runs the
monolithic prefill-then-decode state machine (``prefill="monolithic"``:
one batch-1 ``prefill`` per admitted request scattered into the pool, then
``decode_step_paged``).  ``run(speculative=True)`` adds multi-token
decode on top of the chunked loop, as the reference's does: a draft pass
proposes ``draft_k`` tokens per decoding lane, one verify ``model_step``
scores each lane's whole span past its current position, and
over-speculated pages roll back the same step; the emitted streams are
the plain streams, bit for bit, for any draft.

Sampling: greedy takes the first maximum (exact); a sampled request draws
from its own ``torch.Generator`` seeded with its seed, one draw per
emitted token, so its stream in ``run`` is the one a single-request
``generate(seed=...)`` gives.  A verify span draws column by column and
rewinds the generator to its emitted count, so rejected columns consume
no randomness.
"""
from __future__ import annotations

import collections
import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import backend
from repro_torch.kernels.pack import PackedWeight
from repro_torch.models.layers import ATTN_IMPLS, is_int8_leaf
from repro_torch.models.transformer import LM
from repro_torch.quant.apply import apply_policy_packed, apply_policy_to_params
from repro_torch.quant.linear_quant import FULL_BITS
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve import paged_kv
from repro_torch.serve.frontend import FrontEnd, as_request
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.stats import ServeStats
from repro_torch.serve.step_loop import StepLoop

__all__ = ["ServeEngine", "ServeStats", "sample_tokens"]

def _leaves(tree):
    """Weight leaves: tensors, PackedWeights and int8-store pairs."""
    if is_int8_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def sample_tokens(last: torch.Tensor, temperature: float,
                  gen: torch.Generator) -> torch.Tensor:
    """One token per row of ``last`` (B, V) f32, drawn at ``temperature``
    from ``gen``: what ``torch.multinomial(softmax(last / T), 1)`` draws
    (the argmax of p / q with q ~ Exp(1) from ``gen``), written out because
    ``multinomial`` checks its input on the host, which syncs the device.
    Returns (B,) int64."""
    probs = torch.softmax(last / temperature, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=gen)
    return torch.argmax(probs / q, dim=-1)


class ServeEngine:
    def __init__(self, model: LM, params, policy: Optional[QuantPolicy] = None,
                 graph=None, max_len: int = 512,
                 weight_store: str = "fake", attn_impl: str = "cuda",
                 kv_bits: Optional[int] = None, serve_act_bits: bool = True,
                 cache_dtype: torch.dtype = torch.float32,
                 device: backend.DeviceLike = None):
        """As the reference's engine, with ``attn_impl`` in
        ``("cuda", "ref")``, a KV cache in ``cache_dtype`` (fp32 or bf16;
        ``kv_bits=8`` stores int8 instead) for the dense cache, the paged
        pool, the monolithic path's prefill cache and the speculative
        draft's pool, and an explicit ``device`` (the card when None;
        ``params`` must already live there)."""
        self.device = backend.resolve_device(device)
        if weight_store not in ("fake", "packed"):
            raise ValueError(f"unknown weight_store {weight_store!r}")
        if weight_store == "packed" and policy is None:
            raise ValueError("weight_store='packed' requires a policy "
                             "(without one the engine would silently serve "
                             "dense full-precision weights)")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; "
                             f"expected one of {ATTN_IMPLS}")
        if kv_bits not in (None, 8):
            raise ValueError(f"unsupported kv_bits {kv_bits!r}: only 8 "
                             "(int8 + per-(position, head) scales) is "
                             "implemented; None serves full-precision KV")
        self.model = model
        self.max_len = max_len
        self.weight_store = weight_store
        self.attn_impl = attn_impl
        self.kv_bits = kv_bits
        if cache_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported cache_dtype {cache_dtype}: "
                             "torch.float32 or torch.bfloat16")
        self.cache_dtype = cache_dtype
        self.act_bits = None
        if policy is not None:
            graph = graph or model.graph(seq_len=1, batch=1)
            if weight_store == "packed":
                params = apply_policy_packed(params, graph, policy)
            else:
                params = apply_policy_to_params(params, graph, policy)
            if serve_act_bits:
                self.act_bits = model.block_act_bits(
                    graph, [policy.act_bits.get(l.name, float(FULL_BITS))
                            for l in graph.layers])
        self.params = params
        # a packed store's bucket indices go up now: made on a first step,
        # the copy would stall the overlapped loop
        for leaf in _leaves(params):
            if isinstance(leaf, PackedWeight):
                for name, _ in leaf.buckets:
                    leaf.index(name)
        # distinct input shapes seen per entry point: the port's analogue
        # of the reference's jit-variant counter.  The chunked loop keeps
        # trace_counts["model_step"] at <= 2 whatever the prompt lengths.
        self.trace_counts: Dict[str, int] = collections.Counter()
        self.call_counts: Dict[str, int] = collections.Counter()
        self._shapes: Dict[str, set] = collections.defaultdict(set)
        self._prefill = self._counted("prefill", model.prefill)
        self._decode = self._counted("decode_step", model.decode_step)
        self._decode_paged = self._counted("decode_step_paged",
                                           model.decode_step_paged)
        self._model_step = self._counted("model_step", model.model_step)
        # the speculative draft runs the same unified step under its own
        # counters: call 1 of each draft pass, and each (R, 1) step of its
        # autoregressive tail
        self._draft_step = self._counted("draft_step", model.model_step)
        self._draft_tail = self._counted("draft_tail", model.model_step)

    def _counted(self, name, fn):
        """``fn`` counting its calls (``call_counts``) and its distinct
        input shapes (``trace_counts``)."""
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            key = tuple(tuple(x.shape) for x in a
                        if isinstance(x, torch.Tensor))
            key += tuple(tuple(x["tokens"].shape) for x in a
                         if isinstance(x, dict) and "tokens" in x)
            if key not in self._shapes[name]:
                self._shapes[name].add(key)
                self.trace_counts[name] += 1
            self.call_counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    @staticmethod
    def _sample_span(logits: torch.Tensor, lanes):
        """Every row's candidate tokens from logits (R, C, V), on the
        device.  Greedy rows take each column's first maximum.  A sampled
        row ``i`` in ``lanes`` (row -> (generator, temperature, columns))
        draws its first ``columns`` columns in order, each exactly the
        (1, V) draw :func:`sample_tokens` makes for one plain token.
        Returns (toks (R, C) int64, states): ``states[i][m]`` is row i's
        generator state before its draw m, so a caller that emits m < columns
        tokens rewinds with ``set_state`` and rejected columns consume no
        randomness.  Generator states live on the host (a CUDA generator's
        is its seed and Philox offset): saving and restoring them does not
        touch the device."""
        toks = torch.argmax(logits, dim=-1)
        states = {}
        for i, (gen, temp, cols) in lanes.items():
            states[i] = []
            for j in range(cols):
                states[i].append(gen.get_state())
                toks[i, j] = sample_tokens(
                    logits[i, j:j + 1].to(torch.float32), temp, gen)[0]
        return toks, states

    def weight_hbm_bytes(self) -> Dict[str, int]:
        """Stored weight bytes by leaf kind: ``packed`` (PackedWeight
        buffers + scales), ``int8`` (the uniform int8 store's ``{"q", "s"}``
        leaves), ``dense`` (everything else) and ``total``."""
        out = {"packed": 0, "int8": 0, "dense": 0}
        for leaf in _leaves(self.params):
            if isinstance(leaf, PackedWeight):
                out["packed"] += leaf.hbm_bytes()
            elif isinstance(leaf, dict):
                out["int8"] += sum(t.numel() * t.element_size()
                                   for t in leaf.values())
            else:
                out["dense"] += leaf.numel() * leaf.element_size()
        out["total"] = out["packed"] + out["int8"] + out["dense"]
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, tokens: np.ndarray, n_new: int,
                 temperature: float = 0.0, seed: int = 0) -> Dict[str, Any]:
        """tokens: (B, S_prompt) int.  Greedy (T=0) or sampled decode.

        Returns ``tokens`` (B, n_new) int32, ``stats``, and for checking
        against other engines ``prefill_logits`` (B, V) (on the engine's
        device) and ``top2_gap`` (n_new, B): the gap between the two
        largest logits each token was chosen from.

        Greedy decoding is exact: ``torch.argmax`` takes the first maximum,
        as ``jnp.argmax`` does.  Sampling draws from a ``torch.Generator``
        seeded with ``seed`` (:func:`sample_tokens`); it cannot reproduce
        the reference's threefry stream, so sampled outputs agree with it
        in distribution only.
        """
        B, S = tokens.shape
        if S + n_new > self.max_len:
            raise ValueError(f"prompt {S} + n_new {n_new} exceeds max_len "
                             f"{self.max_len}")
        model, dev = self.model, self.device
        cache = model.init_cache(B, self.max_len, dtype=self.cache_dtype,
                                 kv_bits=self.kv_bits, device=dev)
        stats = ServeStats(n_requests=B)
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=dev)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, {"tokens": toks}, cache,
                                      self.act_bits, attn_impl=self.attn_impl)
        self._sync()
        stats.prefill_s = time.perf_counter() - t0
        prefill_logits = logits[:, -1]

        gen = backend.make_generator(seed, dev) if temperature > 0 else None
        out, gaps = [], []
        t0 = time.perf_counter()
        for i in range(n_new):
            last = logits[:, -1].to(torch.float32)
            top2 = torch.topk(last, 2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            if temperature > 0:
                cur = sample_tokens(last, temperature, gen)
            else:
                cur = torch.argmax(last, dim=-1)
            cur = cur[:, None]
            out.append(cur)
            logits, cache = self._decode(self.params, cur, cache, S + i,
                                         self.act_bits,
                                         attn_impl=self.attn_impl)
        self._sync()
        stats.decode_s = time.perf_counter() - t0
        stats.tokens_out = B * n_new
        stats.steps = n_new
        return {
            "tokens": torch.cat(out, 1).to(torch.int32).cpu().numpy()
            if out else np.zeros((B, 0), np.int32),
            "stats": stats,
            "prefill_logits": prefill_logits,
            "top2_gap": torch.stack(gaps).cpu().numpy() if gaps
            else np.zeros((0, B), np.float32),
        }


    # --------------------------------------------------- continuous batching
    def run(self, requests: Sequence[Union[Request, Dict[str, Any], tuple]],
            *, page_size: int = 16, max_slots: int = 8,
            num_pages: Optional[int] = None, prefill: Optional[str] = None,
            chunk_tokens: Optional[int] = None,
            token_budget: Optional[int] = None, speculative: bool = False,
            draft_k: int = 4, draft_policy: str = "prefix",
            draft_layers: Optional[int] = None,
            draft_act_bits: Optional[float] = None,
            overlap: bool = True) -> Dict[str, Any]:
        """Serve a workload of mixed-length requests with continuous
        batching over the paged pool, as the reference's ``run``.

        requests: each a :class:`Request`, a ``{"tokens", "n_new",
        "temperature"?, "seed"?}`` dict, or a ``(tokens, n_new)`` tuple
        with a 1-D prompt.  ``prefill="chunked"`` (the default when every
        cache kind is ``"paged"``) submits them all to a
        :class:`FrontEnd` and drains :meth:`serve`: one
        ``model_step`` per step, every in-flight sequence contributing up
        to ``chunk_tokens`` (default ``page_size``) prompt tokens or one
        decode token under ``token_budget`` real tokens (default
        ``max_slots + chunk_tokens - 1``, at least ``max_slots``).
        ``overlap`` selects the pipelined step loop; both settings give the
        same streams.  ``prefill="monolithic"`` prefills each admitted
        request alone (K1), scatters it into the pool and decodes the
        batch through ``decode_step_paged``; it is the default, and the
        only mode, for patterns with recurrent (mamba) ``"state"``
        entries, which cannot take a chunk: forcing ``"chunked"`` or
        ``speculative=True`` on them raises before any model call, as in
        the reference.  ``num_pages`` defaults to ``max_slots``
        sequences at ``max_len`` plus the trash page; a
        smaller pool throttles admission and requeues prefills that cannot
        grow.

        ``speculative=True`` (chunked only) decodes up to ``draft_k + 1``
        tokens a lane a step: the ``draft_policy`` draft proposes
        ``draft_k`` tokens (``"prefix"``: the first ``draft_layers``
        repeats, default ``n_repeat // 2``; ``"lowbit"``: the whole model
        at activation QBN ``draft_act_bits``, default 4, over an int8
        draft pool), one verify step scores them and the longest agreeing
        prefix plus the corrected token is emitted.  Steps run
        synchronously; the default budget becomes ``max_slots * (draft_k
        + 1) + chunk_tokens - 1``.

        Each request's stream is the one ``generate`` gives it alone with
        its seed.  Returns ``{"outputs": [np.ndarray per request, submit
        order], "stats": ServeStats}``."""
        reqs = [as_request(i, r) for i, r in enumerate(requests)]
        kinds = self.model.cfg.cache_kinds()
        chunkable = all(kd == "paged" for kd in kinds)
        if prefill is None:
            prefill = "chunked" if chunkable else "monolithic"
        if prefill not in ("chunked", "monolithic"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if prefill == "chunked" and not chunkable:
            raise ValueError(
                f"prefill='chunked' needs all-paged cache kinds, got "
                f"{kinds}: recurrent/memory blocks cannot chunk -- use "
                "prefill='monolithic'")
        if speculative:
            # fail fast, before any model call
            if not chunkable:
                raise ValueError(
                    f"speculative=True needs all-paged cache kinds, got "
                    f"{kinds}: recurrent/memory blocks cannot run the "
                    "multi-token verify chunk -- serve hybrid patterns "
                    "non-speculatively through prefill='monolithic'")
            if prefill == "monolithic":
                raise ValueError(
                    "speculative=True runs through the chunked model_step "
                    "loop; prefill='monolithic' cannot carry verify spans "
                    "-- drop speculative=True or use prefill='chunked'")
            self._validate_draft_args(draft_k, draft_policy, draft_layers,
                                      draft_act_bits)
        if prefill == "chunked":
            fe = FrontEnd()
            for r in reqs:
                fe.submit(r)
            res = self.serve(fe, page_size=page_size, max_slots=max_slots,
                             num_pages=num_pages, chunk_tokens=chunk_tokens,
                             token_budget=token_budget,
                             speculative=speculative, draft_k=draft_k,
                             draft_policy=draft_policy,
                             draft_layers=draft_layers,
                             draft_act_bits=draft_act_bits, overlap=overlap)
            return {"outputs": [res["outputs"][r.rid] for r in reqs],
                    "stats": res["stats"]}
        for r in reqs:
            self.check_fits(r)
        cache, sched, num_pages = self._session(page_size, max_slots,
                                                num_pages)
        for r in reqs:
            sched.submit(r)
        outputs: Dict[int, List[int]] = {r.rid: [] for r in reqs}
        stats = ServeStats(n_requests=len(reqs), mode=prefill)
        self._run_monolithic(sched, cache, kinds, outputs, stats, num_pages,
                             page_size, self._reclaim_window(kinds))
        return {"outputs": [np.asarray(outputs[r.rid], np.int32)
                            for r in reqs],
                "stats": stats}

    def serve(self, frontend: FrontEnd, *, page_size: int = 16,
              max_slots: int = 8, num_pages: Optional[int] = None,
              chunk_tokens: Optional[int] = None,
              token_budget: Optional[int] = None, speculative: bool = False,
              draft_k: int = 4, draft_policy: str = "prefix",
              draft_layers: Optional[int] = None,
              draft_act_bits: Optional[float] = None,
              overlap: bool = True) -> Dict[str, Any]:
        """Open-loop serving: drain a :class:`FrontEnd` of timestamped
        arrivals through the overlapped :class:`StepLoop`.  Requests may
        arrive while the loop runs (``frontend.submit(..., at=t)`` or from
        another thread); each iteration pumps due arrivals (shedding
        SLO-overdue waiters), admits what fits and runs one
        ``model_step``.  ``speculative=True`` rides the same loop
        synchronously (acceptance needs token values).  The knobs are
        :meth:`run`'s.  Returns ``{"outputs": {rid: np.ndarray}, "stats":
        ServeStats, "shed": [rid, ...]}``; shed requests have empty
        streams.  Chunked only: a pattern whose cache kinds are not all
        ``"paged"`` raises, as in the reference (it serves through
        ``run(prefill="monolithic")``)."""
        kinds = self.model.cfg.cache_kinds()
        if not all(kd == "paged" for kd in kinds):
            raise ValueError(
                f"open-loop serving needs all-paged cache kinds, got "
                f"{kinds}: recurrent/memory blocks cannot chunk -- serve "
                "hybrid patterns through run(prefill='monolithic')")
        if speculative:
            self._validate_draft_args(draft_k, draft_policy, draft_layers,
                                      draft_act_bits)
        chunk = chunk_tokens if chunk_tokens is not None else page_size
        if token_budget is not None:
            budget = token_budget
        elif speculative:
            # room for every lane's full verify span plus one chunk
            budget = max_slots * (draft_k + 1) + chunk - 1
        else:
            budget = max_slots + chunk - 1
        if chunk < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk}")
        if budget < max_slots:
            raise ValueError(
                f"token_budget={budget} < max_slots={max_slots}: every "
                "decode lane needs a token each step (decode is never "
                "deferred); raise the budget or shrink the batch")
        cache, sched, num_pages = self._session(page_size, max_slots,
                                                num_pages)
        spec = self._make_draft(
            max_slots, num_pages, page_size, draft_k, draft_policy,
            draft_layers, draft_act_bits) if speculative else None
        stats = ServeStats(mode="chunked",
                           overlapped=bool(overlap) and not speculative)
        loop = StepLoop(self, frontend, sched, cache, kinds, stats,
                        num_pages=num_pages, page_size=page_size,
                        chunk=chunk, budget=budget,
                        reclaim=self._reclaim_window(kinds), spec=spec,
                        overlap=overlap)
        loop.run()
        stats.n_requests = frontend.n_submitted
        stats.shed = list(frontend.shed)
        outputs = {rid: np.asarray(toks, np.int32)
                   for rid, toks in loop.outputs.items()}
        for rid in frontend.shed:
            outputs.setdefault(rid, np.zeros((0,), np.int32))
        return {"outputs": outputs, "stats": stats,
                "shed": list(frontend.shed)}

    def check_fits(self, req: Request) -> None:
        """Raise unless ``req``'s prompt and decode fit ``max_len``."""
        if req.prompt_len + req.n_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: {req.prompt_len}+{req.n_new} tokens "
                f"exceeds max_len={self.max_len}")

    def _session(self, page_size: int, max_slots: int,
                 num_pages: Optional[int]):
        """A fresh paged pool and its scheduler; ``num_pages`` defaults to
        ``max_slots`` sequences at ``max_len`` plus the trash page.
        Returns (cache, scheduler, num_pages)."""
        blocks_per_seq = paged_kv.pages_needed(self.max_len, page_size)
        if num_pages is None:
            num_pages = max_slots * blocks_per_seq + 1      # +1: trash page
        cache = self.model.init_paged_cache(max_slots, num_pages, page_size,
                                            dtype=self.cache_dtype,
                                            kv_bits=self.kv_bits,
                                            device=self.device)
        sched = Scheduler(max_slots, page_size, blocks_per_seq,
                          paged_kv.PageAllocator(num_pages))
        return cache, sched, num_pages

    def _reclaim_window(self, kinds) -> Optional[int]:
        # out-of-window reclamation is sound only when *every* block of the
        # pattern attends through the same sliding window (a single global
        # block needs the whole history; one block table serves all layers)
        cfg = self.model.cfg
        return cfg.window if (all(kd == "paged" for kd in kinds) and
                              cfg.window is not None and
                              all(b.kind == "local_attn"
                                  for b in cfg.pattern)) else None

    @staticmethod
    def _validate_draft_args(draft_k, draft_policy, draft_layers,
                             draft_act_bits) -> None:
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        if draft_policy not in ("prefix", "lowbit"):
            raise ValueError(f"unknown draft_policy {draft_policy!r}; "
                             "expected 'prefix' or 'lowbit'")
        if draft_layers is not None and draft_policy != "prefix":
            raise ValueError("draft_layers applies to "
                             "draft_policy='prefix' only")
        if draft_act_bits is not None and draft_policy != "lowbit":
            raise ValueError("draft_act_bits applies to "
                             "draft_policy='lowbit' only (the prefix "
                             "draft serves the target's own act QBNs)")

    # ------------------------------------------------- speculative drafting
    def _make_draft(self, max_slots, num_pages, page_size, draft_k,
                    draft_policy, draft_layers, draft_act_bits):
        """The draft pass state of one speculative session: another view
        of the same engine, proposing through the same ``model_step``
        against its own paged cache, which shares the scheduler's block
        tables (same positions and page ids: rollback and scrub cover
        both).

        * ``"prefix"``: the first ``draft_layers`` repeats of the served
          params (``LM.draft_prefix_params``, no extra weights), the
          target's activation QBNs of those repeats, a cache stacked to
          the prefix depth with the engine's ``kv_bits``.
          ``draft_layers == n_repeat`` makes the draft the target.
        * ``"lowbit"``: the whole model at ``draft_act_bits`` activation
          QBNs everywhere, over an int8 draft cache.
        """
        model, cfg = self.model, self.model.cfg
        if draft_policy == "prefix":
            d = draft_layers if draft_layers is not None \
                else max(1, cfg.n_repeat // 2)
            params = model.draft_prefix_params(self.params, d)
            act = None if self.act_bits is None else self.act_bits[:d]
            dcache = model.init_paged_cache(
                max_slots, num_pages, page_size, dtype=self.cache_dtype,
                kv_bits=self.kv_bits, n_repeat=d, device=self.device)
        else:                                     # "lowbit"
            params = self.params
            act = np.full((cfg.n_repeat, len(cfg.pattern)),
                          4.0 if draft_act_bits is None
                          else float(draft_act_bits), np.float32)
            dcache = model.init_paged_cache(
                max_slots, num_pages, page_size, dtype=self.cache_dtype,
                kv_bits=8, device=self.device)
        return {"params": params, "cache": dcache, "act": act, "k": draft_k,
                "frontier": {}}

    def _draft_propose(self, spec, plan, sched, spec_lanes, w1):
        """Run the draft pass of one step; returns slot -> draft tokens
        (numpy, writable).

        Call 1 (``draft_step``, width ``w1``: the chunk width, or 2 on
        chunkless steps) carries three kinds of rows: prompt-chunk rows,
        which keep the draft cache's prompt K/V warm; every decode row's
        feedback token, preceded by a one-token catch-up when the previous
        verify step accepted its whole span (the last draft was proposed
        but never fed back: ``spec["frontier"]`` is each lane's draft
        write cursor, clamped back after a rejection, since everything
        past the acceptance point is rejected-token K/V that the stream
        overwrites in place); and each speculating row's last real column,
        whose logits propose its first draft token.  The tail proposes
        ``d_2 .. d_k``: ``k - 1`` (R, 1) ``draft_tail`` steps, each
        feeding every lane's previous proposal from the device at the
        next position; a lane whose span has ended writes at sentinel
        positions, into the trash page.  Proposals are greedy (the draft
        is a guess, the verify sampler the ground truth), and the whole
        proposal stack reaches the host in one transfer."""
        dev = self.device
        n = plan["tokens"].shape[0]
        tables = backend.upload(sched.tables.as_array(), dev)
        slot_map = backend.upload(plan["slot_map"], dev)
        frontier = spec["frontier"]
        dtok = np.zeros((n, w1), np.int64)
        dpos = np.full((n, w1), paged_kv.POS_SENTINEL, np.int32)
        lcols = np.zeros((n,), np.int32)
        for i, c in plan["chunked"].items():      # mirror prompt chunks
            dtok[i, :c] = plan["tokens"][i, :c]
            dpos[i, :c] = plan["positions"][i, :c]
            lcols[i] = c - 1
        for i in plan["spec"]:                    # decode rows (any span)
            s = sched.slot(i)
            catch = min(s.pos - frontier.get(i, s.pos), 1)
            if catch:                             # re-feed the accepted
                dtok[i, 0] = s.out[s.pos - 1 - s.req.prompt_len]
                dpos[i, 0] = s.pos - 1            # last draft of last span
            dtok[i, catch] = s.out[-1]
            dpos[i, catch] = s.pos
            lcols[i] = catch
        logits, spec["cache"] = self._draft_step(
            spec["params"], backend.upload(dtok, dev),
            backend.upload(dpos, dev), slot_map, spec["cache"], tables,
            backend.upload(lcols, dev), spec["act"],
            attn_impl=self.attn_impl)
        for i, cols in plan["spec"].items():      # draft write cursors
            frontier[i] = sched.slot(i).pos + max(cols - 1, 1)
        if not spec_lanes:
            return {}
        tok = torch.argmax(logits[:, -1], dim=-1)
        props = [tok]
        if max(spec_lanes.values()) > 2:
            # always k - 1 steps (one tail shape); a lane proposes while its
            # verify span still has columns (spans >= m + 2 at step m)
            spans = np.zeros((n,), np.int32)
            pos0 = np.zeros((n,), np.int32)
            for i, cols in spec_lanes.items():
                spans[i] = cols
                pos0[i] = sched.slot(i).pos
            spans, pos0 = backend.upload(spans, dev), backend.upload(pos0,
                                                                     dev)
            zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
            for m in range(1, spec["k"]):
                active = spans >= m + 2
                pos = torch.where(active, pos0 + m,
                                  torch.full_like(pos0,
                                                  paged_kv.POS_SENTINEL))
                logits, spec["cache"] = self._draft_tail(
                    spec["params"], tok[:, None], pos[:, None], slot_map,
                    spec["cache"], tables, zeros, spec["act"],
                    attn_impl=self.attn_impl)
                prop = torch.argmax(logits[:, -1], dim=-1)
                tok = torch.where(active, prop, tok)
                props.append(prop)
        all_props = torch.stack(props).cpu().numpy()   # one transfer
        return {i: all_props[:cols - 1, i].copy()
                for i, cols in spec_lanes.items()}

    def _run_monolithic(self, sched, cache, kinds, outputs, stats,
                        num_pages, page_size, reclaim):
        """Prefill-then-decode state machine (the chunked loop's TTFT
        baseline).  Synchronous: each admission and each decode step reads
        its tokens back before the next."""
        t_run = time.perf_counter()
        temps = np.zeros((sched.n_slots,), np.float32)
        gens: Dict[int, torch.Generator] = {}
        while sched.has_work:
            # ---- admission: prefill queued requests into free slots/pages
            admitted = 0
            while (adm := sched.try_admit()) is not None:
                admitted += 1
                req, slot, pages = adm
                t0 = time.perf_counter()
                logits, dense = self._prefill_one(req, page_size)
                paged_kv.scrub_pages(cache, kinds, pages)
                paged_kv.write_prefill(cache, dense, kinds, slot, pages,
                                       page_size)
                temps[slot] = req.temperature
                gens.pop(slot, None)
                lanes = {}
                if req.temperature > 0:
                    gens[slot] = backend.make_generator(req.seed,
                                                        self.device)
                    lanes = {0: (gens[slot], req.temperature, 1)}
                tok = int(self._sample_span(logits, lanes)[0][0, 0])
                stats.prefill_s += time.perf_counter() - t0
                outputs[req.rid].append(tok)
                stats.tokens_out += 1
                stats.prefill_tokens += 1
                stats.mono_prefill_tokens += req.prompt_len
                stats.ttft_steps[req.rid] = stats.steps + 1
                stats.ttft_s[req.rid] = time.perf_counter() - t_run
                sched.bind(slot, req, tok)
            stats.peak_pages = max(stats.peak_pages,
                                   num_pages - 1 - sched.allocator.n_free)

            running = sched.running_slots()
            if not running:
                if sched.has_work and not admitted:
                    raise paged_kv.PagesExhausted(
                        "queued request cannot ever be admitted: pool of "
                        f"{num_pages} pages (page_size={page_size}) is too "
                        "small for its prompt + decode headroom")
                continue                    # everything admitted finished

            # ---- one batched decode step over all in-flight sequences
            if reclaim is not None:
                stats.reclaimed_pages += len(
                    sched.reclaim_out_of_window(reclaim))
            t0 = time.perf_counter()
            paged_kv.scrub_pages(cache, kinds, sched.ensure_pages())
            b = sched.batch()
            dev = self.device
            logits, cache = self._decode_paged(
                self.params, backend.upload(b["tokens"].astype(np.int64), dev),
                cache, backend.upload(b["block_tables"], dev),
                backend.upload(b["pos"], dev), self.act_bits,
                attn_impl=self.attn_impl)
            toks, _ = self._sample_span(
                logits, {i: (gens[i], float(temps[i]), 1)
                         for i in running if temps[i] > 0})
            vals = toks.cpu().numpy()       # one transfer for the batch
            for i in running:
                req = sched.slot(i).req
                tok = int(vals[i, 0])
                outputs[req.rid].append(tok)
                stats.tokens_out += 1
                sched.record(i, tok)
            stats.decode_s += time.perf_counter() - t0
            stats.steps += 1

    def _prefill_one(self, req: Request, page_size: int):
        """Batch-1 prefill into a dense cache sized to whole pages (the
        cache length only pads the KV store: prefill logits come from the
        in-flight K/V)."""
        L = paged_kv.pages_needed(req.prompt_len, page_size) * page_size
        dense = self.model.init_cache(1, L, dtype=self.cache_dtype,
                                      kv_bits=self.kv_bits,
                                      device=self.device)
        toks = torch.as_tensor(req.tokens[None].astype(np.int64),
                               device=self.device)
        return self._prefill(self.params, {"tokens": toks}, dense,
                             self.act_bits, attn_impl=self.attn_impl)
