"""The work that served tokens need in a Mamba2 (SSD) decoder LM, counted
from the sizes of the requests alone.

* Weight contractions (the GEMM kernel group, K2 / K3): ``w_xz``, ``w_bc``
  and ``w_out`` on every token, the unembedding on the rows whose logits
  are read (a prefill's last token, each decode lane): 2 M K N operations,
  N the stored channels; bytes as in ``work/transformer.py``.
* The scan: the recurrence's least work, 4 H P N operations a token a
  layer (the state update and its read-out); the conv 2 d_conv d_inner;
  the dense ``w_dt`` product 2 d_model H.  These count towards the model's
  operations only.

A batch-1 prefill is its own call; decode calls are taken together at
their mean lanes.
"""
from __future__ import annotations

from typing import Dict

from bench.harness.common import PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S
from bench.work.transformer import _stored, _weight_bytes


def _dims(d: Dict):
    di = d["expand"] * d["d_model"]
    return di, di // d["head_dim"], d["head_dim"], d["d_state"]


def gemm(d: Dict, widths: Dict, calls: float, rows: float,
         logit_rows: float) -> Dict[str, float]:
    if calls <= 0:
        return {"flops": 0.0, "bytes": 0.0, "bound_s": 0.0}
    di, _, _, N = _dims(d)
    dm, L = d["d_model"], d["n_layers"]
    flops = byts = bound = 0.0
    for name, K, m, per_layer in (("p0.w_xz", dm, rows, True),
                                  ("p0.w_bc", dm, rows, True),
                                  ("p0.w_out", di, rows, True),
                                  ("unembed", dm, logit_rows, False)):
        n = _stored(widths[name])
        copies = L if per_layer else 1
        fl = calls * copies * 2 * m * K * n
        by = calls * copies * (_weight_bytes(widths[name], K) +
                               4 * m * (K + n))
        flops, byts = flops + fl, byts + by
        bound += max(fl / PEAK_TF32_FLOP_S, by / PEAK_HBM_BYTES_S)
    return {"flops": flops, "bytes": byts, "bound_s": bound}


def phase(d: Dict, widths: Dict, s: Dict) -> Dict[str, Dict[str, float]]:
    """Work of a phase summary ``s``: ``prefill_lens`` (one batch-1
    prefill each), ``decode_tokens`` over ``decode_calls`` steps."""
    parts = [gemm(d, widths, 1, p, 1) for p in s["prefill_lens"]]
    lanes = s["decode_tokens"] / max(s["decode_calls"], 1)
    parts.append(gemm(d, widths, s["decode_calls"], lanes, lanes))
    g = {k: sum(p[k] for p in parts) for k in ("flops", "bytes", "bound_s")}
    di, H, P, N = _dims(d)
    tokens = sum(s["prefill_lens"]) + s["decode_tokens"]
    other = tokens * d["n_layers"] * (4 * H * P * N + 2 * d["d_conv"] * di +
                                      2 * d["d_model"] * H)
    zero = {"flops": 0.0, "bytes": 0.0, "bound_s": 0.0}
    return {"gemm": g, "attn": zero, "model_flops": g["flops"] + other}
