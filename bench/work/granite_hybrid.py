"""The work that served tokens need in granite-4.0-h (``granitemoehybrid``):
Mamba-2 and attention layers, each followed by a MoE FFN beside a shared
expert, counted from the sizes of the requests alone.

* Weight contractions (the GEMM kernel group, K2 / K3): as in
  ``work/transformer.py``, 2 M K N operations a site, N its stored
  channels, M the real rows: every token for the Mamba projections
  (``w_xz``, ``w_bc``, ``w_out``), the attention projections and the
  shared expert; the routed top-k pairs for the experts; the rows whose
  logits are read for the unembedding.  Bytes: each weight once a call at
  its bucket's width (an expert stack only for the experts the call's
  tokens are expected to reach), x read and y written once in fp32.
* Attention (K1 / K4) in the attention layers alone: 4 Hq hd operations a
  (query, key) pair, as ``work/transformer.py`` counts them.
* The SSD scan (``ssd``): the recurrence's least work, 4 H P N operations
  a real token a Mamba layer (the state update and its read-out), as
  ``work/mamba2.py`` counts it; bytes: the fp32 state (H, P, N) read and
  written once for each row a call advances (a decode lane, a prompt
  chunk) a layer, and x, B, C, dt and y once a token a layer in fp32.
* The conv (2 d_conv (d_inner + 2 d_state)), the dense ``w_dt`` product
  and the router count towards the model's operations only.

A call class's bound is ``max(operations / peak, bytes / bandwidth)`` of
its summed work.
"""
from __future__ import annotations

from typing import Dict

from bench.harness.common import PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S
from bench.work.transformer import _attn_query, _stored, _weight_bytes

_ZERO = {"flops": 0.0, "bytes": 0.0, "bound_s": 0.0}


def _ssm(d: Dict):
    s = d["ssm"]
    di = s["expand"] * d["d_model"]
    return di, di // s["head_dim"], s["head_dim"], s["d_state"]


def _repeats(d: Dict) -> int:
    return d["n_layers"] // len(d["pattern"])


def _layers(d: Dict, kind: str) -> int:
    return _repeats(d) * d["pattern"].count(kind)


def _sites(d: Dict):
    """(name, K, expert) of every contraction of the period."""
    dm, hd = d["d_model"], d["head_dim"]
    di = _ssm(d)[0]
    f = d["moe"]
    out = []
    for p, kind in enumerate(d["pattern"]):
        nm = f"p{p}"
        if kind == "attention":
            out += [(f"{nm}.wq", dm, False), (f"{nm}.wk", dm, False),
                    (f"{nm}.wv", dm, False),
                    (f"{nm}.wo", d["n_heads"] * hd, False)]
        else:
            out += [(f"{nm}.w_xz", dm, False), (f"{nm}.w_bc", dm, False),
                    (f"{nm}.w_out", di, False)]
        out += [(f"{nm}.wg", dm, True), (f"{nm}.wu", dm, True),
                (f"{nm}.wd", f["d_ff"], True),
                (f"{nm}.shared.wg", dm, False),
                (f"{nm}.shared.wu", dm, False),
                (f"{nm}.shared.wd", f["shared_d_ff"], False)]
    return out


def experts_reached(d: Dict, tokens: float) -> float:
    """Expected number of experts that at least one of ``tokens`` tokens
    routes to, each choosing top_k distinct experts of E."""
    E, k = d["moe"]["n_experts"], d["moe"]["top_k"]
    return E * (1.0 - (1.0 - k / E) ** tokens)


def gemm(d: Dict, widths: Dict, calls: float, rows: float,
         logit_rows: float) -> Dict[str, float]:
    """Contraction work of ``calls`` calls of ``rows`` real token rows and
    ``logit_rows`` unembedded rows each."""
    if calls <= 0:
        return dict(_ZERO)
    R, k = _repeats(d), d["moe"]["top_k"]
    flops = byts = bound = 0.0
    for name, K, expert in _sites(d) + [("unembed", d["d_model"], False)]:
        N = _stored(widths[name])
        if name == "unembed":
            m, copies, layers = logit_rows, 1.0, 1
        else:
            m = rows * (k if expert else 1)
            copies = experts_reached(d, rows) if expert else 1.0
            layers = R
        fl = calls * layers * 2 * m * K * N
        by = calls * layers * (_weight_bytes(widths[name], K) * copies +
                               4 * m * (K + N))
        flops, byts = flops + fl, byts + by
        bound += max(fl / PEAK_TF32_FLOP_S, by / PEAK_HBM_BYTES_S)
    return {"flops": flops, "bytes": byts, "bound_s": bound}


def ssd(d: Dict, tokens: float, rows: float) -> Dict[str, float]:
    """The scan's work over ``tokens`` real tokens in ``rows`` advanced
    rows, every Mamba layer."""
    L = _layers(d, "mamba")
    _, H, P, N = _ssm(d)
    flops = L * tokens * 4 * H * P * N
    byts = L * (rows * 2 * 4 * H * P * N +
                tokens * 4 * (2 * H * P + 2 * N + H))
    return {"flops": flops, "bytes": byts,
            "bound_s": max(flops / PEAK_TF32_FLOP_S,
                           byts / PEAK_HBM_BYTES_S)}


def phase(d: Dict, widths: Dict, s: Dict) -> Dict[str, Dict[str, float]]:
    """Work of a phase summary ``s``: ``prefill_lens`` (prompts whose
    prefill completed), ``decode_pos`` (position of each decode token's
    input), ``chunk_calls`` / ``decode_calls`` (model calls of each
    shape) and ``chunk``; prompts are taken in chunks of ``chunk`` from
    position 0, one advanced row each."""
    n_c, n_d = s["chunk_calls"], s["decode_calls"]
    n = max(n_c + n_d, 1)
    D = len(s["decode_pos"])
    P = sum(s["prefill_lens"])
    lanes = D / n
    done = len(s["prefill_lens"])
    parts = [gemm(d, widths, n_c, P / max(n_c, 1) + lanes,
                  lanes + done / max(n_c, 1)),
             gemm(d, widths, n_d, lanes, lanes)]
    g = {k: parts[0][k] + parts[1][k] for k in parts[0]}
    c = s["chunk"] or 1
    da = dict(d, n_layers=_layers(d, "attention"))
    share_c = n_c / n                  # decode tokens riding chunk calls
    af, ab = [0.0, 0.0], [0.0, 0.0]
    for p in s["decode_pos"]:
        fl, by = _attn_query(da, p + 1, 1)
        for i, w in enumerate((share_c, 1 - share_c)):
            af[i] += w * fl
            ab[i] += w * by
    for plen in s["prefill_lens"]:
        for s0 in range(0, plen, c):
            fl, by = _attn_query(da, min(s0 + c, plen), min(c, plen - s0))
            af[0] += fl
            ab[0] += by
    attn = {"flops": sum(af), "bytes": sum(ab),
            "bound_s": sum(max(f / PEAK_TF32_FLOP_S, b / PEAK_HBM_BYTES_S)
                           for f, b in zip(af, ab))}
    chunks = sum(-(-plen // c) for plen in s["prefill_lens"])
    scan = ssd(d, P + D, chunks + D)
    di, H, _, N = _ssm(d)
    dm, Lm = d["d_model"], _layers(d, "mamba")
    other = (P + D) * (Lm * (2 * d["ssm"]["d_conv"] * (di + 2 * N) +
                             2 * dm * H) +
                       d["n_layers"] * 2 * dm * d["moe"]["n_experts"])
    return {"gemm": g, "attn": attn, "ssd": scan,
            "model_flops": g["flops"] + attn["flops"] + scan["flops"] +
            other}
