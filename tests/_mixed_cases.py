"""Numpy inputs of the mixed-QBN product shared by two test files.

``tests/test_torch_mixed_launch.py`` holds the one-launch product on the
card (``packed_matmul.mixed_matmul``) to the port's plain version on these
inputs, and ``tests/test_torch_mixed_reference.py`` holds that plain
version, on the CPU, to the JAX package's ``packed_mixed_matmul`` on the
same inputs: a file of card tests imports no JAX.
"""
from typing import NamedTuple, Optional, Tuple

import numpy as np

# the benchmark policy's weight QBNs, given to a site's 64 channel groups in
# turn (bench/configs: pruned 10, int2 9, int4 18, int8 27 groups of 64)
QBNS = (0, 2, 3, 4, 5, 6, 8)
GROUPS = 64


def channel_bits(n: int, seed: int = 0) -> np.ndarray:
    """Per-channel QBNs of an n-channel site: 64 groups of n / 64 channels
    with the QBNs in turn, the groups in a seeded order."""
    vals = np.asarray([QBNS[i % len(QBNS)] for i in range(GROUPS)])
    vals = np.random.default_rng(seed).permutation(vals)
    return np.repeat(vals, n // GROUPS)


class Case(NamedTuple):
    x: np.ndarray            # (M, K), (E, C, K), or grouped (P, K)
    w: np.ndarray            # (K, N) or (E, K, N) float32
    bits: np.ndarray         # (N,) per-channel QBNs
    counts: Optional[Tuple[int, ...]]   # grouped: rows of each expert

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.counts)]).astype(np.int32)

    @property
    def cap(self) -> int:
        return max(self.counts)


# name -> (experts or 0, rows (grouped: counts), K, u): 64 u channels, u 12
# gives buckets of 108 / 216 / 324 channels (byte loads), u 16 of 144 / 288
# / 432 (16-byte copies); K is no multiple of 2 or 4
GROUPED_COUNTS = (130, 0, 9, 257, 1)
SHAPES = {
    **{f"dense_m{m}_{'vec' if u == 16 else 'nonvec'}": (0, m, 1001, u)
       for m in (9, 16, 129, 384) for u in (12, 16)},
    **{f"experts_c{c}": (3, c, 517, 12) for c in (9, 129)},
    **{f"grouped_{'vec' if u == 16 else 'nonvec'}":
       (len(GROUPED_COUNTS), GROUPED_COUNTS, 1001, u) for u in (12, 16)},
}
NAMES = list(SHAPES)


def mixed_case(name: str) -> Case:
    """The inputs of case ``name``, the same on every call."""
    E, rows, K, u = SHAPES[name]
    seed = NAMES.index(name)
    rng = np.random.default_rng(seed)
    n = GROUPS * u
    grouped = isinstance(rows, tuple)
    lead = (E,) if E else ()
    w = (rng.normal(size=lead + (K, n)) / np.sqrt(K)).astype(np.float32)
    if grouped:
        x = rng.normal(size=(sum(rows), K))
    else:
        x = rng.normal(size=lead + (rows, K))
    return Case(x.astype(np.float32), w, channel_bits(n, seed).astype(
        np.float32), rows if grouped else None)
