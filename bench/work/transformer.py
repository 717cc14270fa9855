"""The work that served tokens need in a decoder LM of attention blocks with
a dense or MoE SwiGLU FFN: operations and bytes, counted from the sizes of
the requests alone, whatever implements them.

* Weight contractions (the GEMM kernel group, K2 / K3): 2 M K N operations
  a site, N the site's stored (not pruned) channels and M the real rows:
  the tokens of the call, the routed top-k pairs for an expert, the rows
  whose logits are read for the unembedding.  Padding rows and the spare
  rows of dropless capacity are no work.  Bytes: each weight once a call
  at its bucket's width plus a 4-byte scale a channel (an expert stack
  only for the experts that the call's tokens are expected to reach), x
  read and y written once in fp32.
* Attention (K1 / K4): 4 Hq hd operations a (query, key) pair a layer;
  bytes: each query's K / V context once a call, q read and o written.
  Prompts are taken in chunks of the server's ``chunk_tokens`` from 0.
* The router's product counts towards the model's operations only.

A call class's bound is ``max(operations / peak, bytes / bandwidth)`` of
its summed work, site by site for the contractions: each call of a class
does alike, so this is a lower bound of the kernels' time.
"""
from __future__ import annotations

from typing import Dict

from bench.harness.common import PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S


def _sites(d: Dict):
    """(name, K, N_total, per-layer copies or None for the unembedding,
    expert)"""
    hd, dm = d["head_dim"], d["d_model"]
    qd, kvd = d["n_heads"] * hd, d["n_kv_heads"] * hd
    f = d["ffn"]
    ff = f["d_ff"]
    moe = f["kind"] == "moe"
    return [("p0.wq", dm, qd, False), ("p0.wk", dm, kvd, False),
            ("p0.wv", dm, kvd, False), ("p0.wo", qd, dm, False),
            ("p0.wg", dm, ff, moe), ("p0.wu", dm, ff, moe),
            ("p0.wd", ff, dm, moe)]


def _weight_bytes(widths: Dict[int, int], K: int) -> float:
    return sum(K * n * bits / 8 + 4 * n for bits, n in widths.items()
               if bits > 0)


def _stored(widths: Dict[int, int]) -> int:
    return sum(n for bits, n in widths.items() if bits > 0)


def experts_reached(d: Dict, tokens: float) -> float:
    """Expected number of experts that at least one of ``tokens`` tokens
    routes to, each choosing top_k distinct experts of E."""
    f = d["ffn"]
    if f["kind"] != "moe":
        return 1.0
    E, k = f["n_experts"], f["top_k"]
    return E * (1.0 - (1.0 - k / E) ** tokens)


def gemm(d: Dict, widths: Dict, calls: float, rows: float,
         logit_rows: float) -> Dict[str, float]:
    """Contraction work of ``calls`` calls of ``rows`` real token rows and
    ``logit_rows`` unembedded rows each."""
    if calls <= 0:
        return {"flops": 0.0, "bytes": 0.0, "bound_s": 0.0}
    L = d["n_layers"]
    f = d["ffn"]
    flops = byts = bound = 0.0
    for name, K, _, expert in _sites(d):
        N = _stored(widths[name])
        m = rows * (f["top_k"] if expert else 1)
        copies = experts_reached(d, rows) if expert else 1.0
        fl = calls * L * 2 * m * K * N
        by = calls * L * (_weight_bytes(widths[name], K) * copies +
                          4 * m * (K + N))
        flops, byts = flops + fl, byts + by
        bound += max(fl / PEAK_TF32_FLOP_S, by / PEAK_HBM_BYTES_S)
    K = d["d_model"]
    N = _stored(widths["unembed"])
    fl = calls * 2 * logit_rows * K * N
    by = calls * (_weight_bytes(widths["unembed"], K) +
                  4 * logit_rows * (K + N))
    bound += max(fl / PEAK_TF32_FLOP_S, by / PEAK_HBM_BYTES_S)
    return {"flops": flops + fl, "bytes": byts + by, "bound_s": bound}


def _attn_query(d: Dict, ctx: int, q_rows: int) -> tuple:
    """Operations and bytes of ``q_rows`` queries ending at context
    ``ctx`` (the last sees ``ctx`` keys), over all layers."""
    L, hd = d["n_layers"], d["head_dim"]
    Hq, Hkv = d["n_heads"], d["n_kv_heads"]
    first = ctx - q_rows + 1
    pairs = (first + ctx) * q_rows / 2
    flops = L * 4 * Hq * hd * pairs
    byts = L * 4 * (2 * Hkv * hd * ctx + 2 * Hq * hd * q_rows)
    return flops, byts


def phase(d: Dict, widths: Dict, s: Dict) -> Dict[str, Dict[str, float]]:
    """Work of a phase summary ``s``: ``prefill_lens`` (prompts whose
    prefill completed), ``decode_pos`` (position of each decode token's
    input), ``chunk_calls`` / ``decode_calls`` (model calls of each
    shape), ``slots`` and ``chunk``."""
    n_c, n_d = s["chunk_calls"], s["decode_calls"]
    n = max(n_c + n_d, 1)
    D = len(s["decode_pos"])
    P = sum(s["prefill_lens"])
    lanes = D / n
    done = len(s["prefill_lens"])
    out_g = [gemm(d, widths, n_c, P / max(n_c, 1) + lanes,
                  lanes + done / max(n_c, 1)),
             gemm(d, widths, n_d, lanes, lanes)]
    share_c = n_c / n                  # decode tokens riding chunk calls
    af = [0.0, 0.0]
    ab = [0.0, 0.0]
    for p in s["decode_pos"]:
        fl, by = _attn_query(d, p + 1, 1)
        af[0] += share_c * fl
        ab[0] += share_c * by
        af[1] += (1 - share_c) * fl
        ab[1] += (1 - share_c) * by
    c = s["chunk"] or 1
    for plen in s["prefill_lens"]:
        for s0 in range(0, plen, c):
            fl, by = _attn_query(d, min(s0 + c, plen), min(c, plen - s0))
            af[0] += fl
            ab[0] += by
    attn = {"flops": sum(af), "bytes": sum(ab),
            "bound_s": sum(max(f / PEAK_TF32_FLOP_S, b / PEAK_HBM_BYTES_S)
                           for f, b in zip(af, ab))}
    f = d["ffn"]
    router = 0.0
    if f["kind"] == "moe":
        router = 2 * (P + D) * d["d_model"] * f["n_experts"] * d["n_layers"]
    g = {k: out_g[0][k] + out_g[1][k] for k in out_g[0]}
    return {"gemm": g, "attn": attn,
            "model_flops": g["flops"] + attn["flops"] + router}
