"""Whether what the window served is correct, judged by the plain reference.

After the window, with the program's state freed, the reference draws the
same weights from the seed, works out the policy's dequantized weights
from them, and runs once over each sampled request's prompt followed by
its served tokens.  For each served token it reads the gap by which that
token's logit lies below the reference's best at its position.  Served
tokens are greedy, so a sound program serves the reference's best token or
one within rounding of it.  Two numbers come of the gaps, and a cell's
workload file names the ones it compares, each with its limit:
``max_gap``, the widest gap, and ``flip_share``, the share of served
tokens that are not the reference's best (gap above 0).

The control (``control=True``) is the same reference in the nearest lower
precision, TF32 matmuls, put in the program's place: at each position of
the same prompts and served tokens it picks its own best token, and that
token's gap below the fp32 reference's best is judged as a served one's
would be.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from bench.harness import system
from bench.reference.quant import dequantize_


@contextlib.contextmanager
def tf32(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def sample(record, seed: int, n: int) -> List[int]:
    """Up to ``n`` requests that served tokens inside the window: the
    finished one with the most served tokens, and the rest drawn from the
    seed among all that served any, finished or still in flight at the
    close (their tokens up to the close are judged)."""
    served = sorted(rid for rid, r in record.reqs.items() if r.stamps)
    done = [rid for rid in served if record.reqs[rid].done]
    if not done:
        return []
    longest = max(done, key=lambda rid: (record.reqs[rid].n_new,
                                         record.reqs[rid].prompt.size, -rid))
    rest = [rid for rid in served if rid != longest]
    rng = system.seed_stream(seed, "sample")
    pick = rng.permutation(len(rest))[:max(n - 1, 0)]
    return [longest] + sorted(rest[int(i)] for i in pick)


def reference_weights(cfg: Dict, seed: int, policy: Dict, device):
    """The seed's weights with every policy site dequantized in place."""
    w = system.make_weights(cfg, seed, device)
    bits = system.site_channel_bits(cfg, policy)
    for name, path, _ in system.family(cfg).sites(cfg["dims"]):
        node = w
        for key in path:
            node = node[key]
        dequantize_(node, bits[name])
    return w


def judge(cfg: Dict, seed: int, policy: Dict, record, rids: List[int],
          device, control: bool = False) -> Dict:
    """Per sampled request, the gaps of its served tokens, or with
    ``control`` of the control's picks at the same positions."""
    fam = system.family(cfg)
    weights = reference_weights(cfg, seed, policy, device)
    act = float(cfg["policy"]["act_qbn"])
    out = {"requests": [], "max_gap": 0.0, "tokens": 0, "flips": 0}
    for rid in rids:
        r = record.reqs[rid]
        served = np.asarray(r.tokens, np.int64)
        seq = np.concatenate([r.prompt.astype(np.int64), served[:-1]])
        toks = torch.as_tensor(seq, device=device)
        rows = range(r.prompt.size - 1, seq.size)
        with tf32(False):
            lg = fam.logits(weights, cfg["dims"], toks, act, rows)
        best = lg.max(dim=-1).values
        if control:
            with tf32(True):
                picks = fam.logits(weights, cfg["dims"], toks, act,
                                   rows).argmax(dim=-1, keepdim=True)
        else:
            picks = torch.as_tensor(served, device=device)[:, None]
        gaps = (best - lg.gather(1, picks)[:, 0]).cpu().numpy()
        rec = {"rid": rid, "prompt": int(r.prompt.size),
               "served": int(served.size), "max_gap": float(gaps.max()),
               "flips": int((gaps > 0).sum())}
        out["requests"].append(rec)
        out["max_gap"] = max(out["max_gap"], rec["max_gap"])
        out["flips"] += rec["flips"]
        out["tokens"] += int(served.size)
    out["flip_share"] = out["flips"] / max(out["tokens"], 1)
    return out
