"""Serving engine: batch-at-a-time ``generate`` over the dense KV cache
(port of ``repro/serve/engine.py``, its ``__init__``, ``weight_hbm_bytes``
and ``generate``).

The engine deploys a searched :class:`QuantPolicy` at load time into one of
two weight stores:

* ``weight_store="fake"`` -- fake-quantized f32 tensors (search-time
  numerics, full-size footprint); their matmuls are plain ``x @ w``;
* ``weight_store="packed"`` -- the bucketed sub-byte store
  (``quant.apply.apply_policy_packed``), whose matmuls run one CUDA kernel
  per bucket on the card (K3 for int2 / int4, K2 for int8).

Attention runs on the flash kernel K1 by default (``attn_impl="cuda"``);
``attn_impl="ref"`` is the escape hatch to the plain chunked scan.  The
engine runs on the card unless constructed with ``device="cpu"``.

``run`` / ``serve`` (continuous batching over the paged pool) are the next
slice of the port (ROADMAP.md A5).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import backend
from repro_torch.kernels.pack import PackedWeight
from repro_torch.models.layers import ATTN_IMPLS
from repro_torch.models.transformer import LM
from repro_torch.quant.apply import apply_policy_packed, apply_policy_to_params
from repro_torch.quant.linear_quant import FULL_BITS
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve.stats import ServeStats

__all__ = ["ServeEngine", "ServeStats"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class ServeEngine:
    def __init__(self, model: LM, params, policy: Optional[QuantPolicy] = None,
                 graph=None, max_len: int = 512,
                 weight_store: str = "fake", attn_impl: str = "cuda",
                 kv_bits: Optional[int] = None, serve_act_bits: bool = True,
                 device: backend.DeviceLike = None):
        """As the reference's engine, with ``attn_impl`` in
        ``("cuda", "ref")``, an fp32 KV cache (``kv_bits=None``) or int8
        (``kv_bits=8``), and an explicit ``device`` (the card when None;
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

    def weight_hbm_bytes(self) -> Dict[str, int]:
        """Stored weight bytes by leaf kind: ``packed`` (PackedWeight
        buffers + scales), ``int8`` (always 0: the port has no uniform int8
        store yet), ``dense`` (everything else) and ``total``."""
        out = {"packed": 0, "int8": 0, "dense": 0}
        for leaf in _leaves(self.params):
            if isinstance(leaf, PackedWeight):
                out["packed"] += leaf.hbm_bytes()
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
        seeded with ``seed``; it cannot reproduce the reference's threefry
        stream, so sampled outputs agree with it in distribution only.
        """
        B, S = tokens.shape
        if S + n_new > self.max_len:
            raise ValueError(f"prompt {S} + n_new {n_new} exceeds max_len "
                             f"{self.max_len}")
        model, dev = self.model, self.device
        cache = model.init_cache(B, self.max_len, kv_bits=self.kv_bits,
                                 device=dev)
        stats = ServeStats(n_requests=B)
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=dev)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(self.params, {"tokens": toks}, cache,
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
                probs = torch.softmax(last / temperature, dim=-1)
                cur = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                cur = torch.argmax(last, dim=-1)
            cur = cur[:, None]
            out.append(cur)
            logits, cache = model.decode_step(self.params, cur, cache, S + i,
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

    def run(self, *a, **kw):
        raise NotImplementedError(
            "ServeEngine.run (continuous batching over the paged pool) is "
            "the next slice of the port: ROADMAP.md A5")

    def serve(self, *a, **kw):
        raise NotImplementedError(
            "ServeEngine.serve (the open-loop core) is the next slice of "
            "the port: ROADMAP.md A5")
