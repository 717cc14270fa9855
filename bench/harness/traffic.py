"""The one traffic generator: it reads a mix from ``bench/traffic/<name>.json``.

A mix fixes a *set* of request sizes: ``set_size`` (prompt, output) pairs
at evenly spaced quantiles of each length's distribution, paired and put
in an order by a fixed permutation.  Every seed serves that set again and
again, so the work is the same for every seed; the seed draws the prompt
tokens (uniform over the vocabulary), the weights, the policy and the
order in which the work arrives, as far as that order leaves the work
unchanged:

* ``closed``: ``sessions`` clients, each sending its next request the
  moment its last one's final token is visible (no think time).  Session
  k's j-th request is the set's entry (k + j) mod ``set_size``.  Its
  first request stands for the one it is in the middle of when the loop
  is steady: entry k with a fixed share of its output already served, as
  part of the prompt, and the rest still to come.  The shares are
  (i + 0.5) / ``sessions``, spread over the sessions by a fixed
  permutation.  The seed orders the sessions' first submissions, and with
  them the slots they take.
* ``batches``: ``batch`` requests at a time, run back to back, each batch
  the set in its fixed order (in a monolithic run the order within a
  batch sets the decode steps, so it is not the seed's).
* ``poisson``: an open loop at ``rate_per_s``; the set's requests and its
  gaps (quantiles of the exponential distribution) each in the seed's
  order, a fresh order for every repetition.

Distributions: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``
(clipped) and ``{"dist": "uniform", "min", "max"}`` (integers, both ends
included).  A mix with a key that its kind does not read is refused.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np

from bench.harness.system import seed_stream

_NORMAL = statistics.NormalDist()
# the fixed permutations of every mix: how the set's prompt and output
# lengths pair, the set's order, and the closed sessions' served shares
_FIXED_SEED = 0
KEYS = {"closed": {"sessions"}, "batches": {"batch"},
        "poisson": {"rate_per_s"}}
COMMON = {"about", "kind", "set_size", "prompt", "output"}


def validate(mix: Dict) -> None:
    """Refuse a mix of unknown kind or with a key its kind does not read."""
    kind = mix.get("kind")
    if kind not in KEYS:
        raise ValueError(f"unknown traffic kind {kind!r}")
    extra = set(mix) - COMMON - KEYS[kind]
    if extra:
        raise ValueError(f"{kind} traffic does not read {sorted(extra)}")


def quantile(spec: Dict, q: float) -> int:
    """The ``q``-quantile (0 < q < 1) of a length distribution."""
    if spec["dist"] == "lognormal":
        v = spec["median"] * math.exp(spec["sigma"] * _NORMAL.inv_cdf(q))
        return int(min(max(round(v), spec["min"]), spec["max"]))
    if spec["dist"] == "uniform":
        lo, hi = spec["min"], spec["max"]
        return int(min(lo + math.floor(q * (hi - lo + 1)), hi))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def size_set(mix: Dict) -> List[Tuple[int, int]]:
    """The mix's (prompt length, output length) pairs, in its fixed
    order."""
    n = mix["set_size"]
    qs = [(i + 0.5) / n for i in range(n)]
    prompts = [quantile(mix["prompt"], q) for q in qs]
    outs = [quantile(mix["output"], q) for q in qs]
    rng = np.random.default_rng(_FIXED_SEED)
    pair, order = rng.permutation(n), rng.permutation(n)
    return [(prompts[int(i)], outs[int(pair[i])]) for i in order]


def served_shares(sessions: int) -> List[float]:
    """Closed loop: the share of its first request's output that each
    session has served when the window opens."""
    rng = np.random.default_rng([_FIXED_SEED, sessions])
    return [(int(i) + 0.5) / sessions for i in rng.permutation(sessions)]


def arrival_gaps(mix: Dict) -> List[float]:
    """Open loop: the set's inter-arrival gaps in seconds."""
    n = mix["set_size"]
    return [-math.log(1.0 - (i + 0.5) / n) / mix["rate_per_s"]
            for i in range(n)]


class Stream:
    """The run's requests: ``next(session)`` for a closed mix, ``next()``
    for the others, each (prompt tokens int32, output length), with the gap
    before it for ``poisson``.  A request's tokens depend on the seed and
    its place in the mix alone, not on when it is asked for."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        validate(mix)
        self.mix = mix
        self.seed = seed
        self.vocab = vocab
        self.sizes = size_set(mix)
        self.gaps = arrival_gaps(mix) if mix["kind"] == "poisson" else None
        self._order = seed_stream(seed, "order")
        n = mix.get("sessions", 0)
        # closed: the order of the sessions' first submissions
        self.first = [int(k) for k in self._order.permutation(n)]
        self._shares = served_shares(n) if n else []
        self._count: Dict[int, int] = {}
        self._block: List[int] = []
        self._gap_block: List[int] = []

    def _tokens(self, key: str, n: int) -> np.ndarray:
        rng = seed_stream(self.seed, f"tokens/{key}")
        return rng.integers(0, self.vocab, size=n).astype(np.int32)

    def next(self, session: int = 0):
        kind = self.mix["kind"]
        j = self._count.get(session, 0)
        self._count[session] = j + 1
        n = len(self.sizes)
        if kind == "closed":
            p, out = self.sizes[(session + j) % n]
            if j == 0:
                done = int(self._shares[session] * out)
                p, out = p + done, out - done
            return self._tokens(f"{session}/{j}", p), out
        if kind == "batches":
            p, out = self.sizes[j % n]
            return self._tokens(str(j), p), out
        if not self._block:
            self._block = [int(i) for i in self._order.permutation(n)]
            self._gap_block = [int(i) for i in
                               self._order.permutation(len(self.gaps))]
        p, out = self.sizes[self._block.pop(0)]
        return self._tokens(str(j), p), out, self.gaps[self._gap_block.pop(0)]

    def take(self, n: int) -> List:
        return [self.next() for _ in range(n)]
