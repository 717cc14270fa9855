#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printing one JSON line per result; any failure raises and the
run exits non-zero:

1. build   -- nvcc-compiles the three CUDA kernels from ``src/repro_torch/
              csrc`` in parallel and prints the card's name and power limit.
2. kernels -- holds each kernel against its plain PyTorch version on the
              card at the shapes gemma2-2b's serving path gives it, and
              times kernel, plain version, one library call and the bound
              (CUDA events, L2 flushed before each run, median of 10).
3. serve   -- ServeEngine.generate on gemma2-2b at full width and depth
              with a seeded kernel-wise policy: engine A (packed store,
              CUDA kernels) against engine B (fake-quant store, plain
              attention), both on the card.  Checks the prefill logits,
              the greedy streams (top-2 gap rule) and the launch counts.

The line before the last lists every kernel with its launches on the main
path and its times; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, it prints no
result and exits 2.  It imports neither JAX nor the reference package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet: HBM3 bandwidth
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet: fp32, non-tensor

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_attention.py:25
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_packed.py:68-69
# Engines A and B differ in summation order only (fp32 throughout), but 26
# layers deep on random weights a 1e-6 relative difference per GEMM grows;
# 2e-3 on logits capped at +-30 still separates any real fault (a wrong
# bucket or mask moves logits by O(1)).  This holds with activation
# quantization off.
LOGIT_ATOL = 2e-3
# With activation QBN 8 every block rounds each token's activations to 255
# levels; a 1-ulp difference that crosses a rounding boundary moves that
# element by a whole step (amax / 127), and such flips compound over 26
# layers: on an H100 this pair measured 0.072 on the prefill logits, and
# 2.2e-5 with activation quantization off.
ACT_LOGIT_ATOL = 0.25

ARCH = "gemma2-2b"
B, PROMPT, N_NEW, MAX_LEN = 2, 4160, 16, 4224
POLICY_QBNS = (0, 2, 3, 4, 5, 6, 8)
SEED = 0

SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:124"),
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:25"),
    "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                      "src/repro/kernels/packed_matmul.py:50"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


class Timer:
    """CUDA-event timing with the L2 cache flushed before every run.

    A call's event time includes the host's launch work whenever the
    device outruns it (small decode kernels); :meth:`device` reads the
    device time of the kernels alone from ``torch.profiler``."""

    def __init__(self, torch, reps=10, warm=2):
        self.torch, self.reps, self.warm = torch, reps, warm
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")

    def _profiled_us(self, fn):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(self.reps):
                self.flush.zero_()
                if fn is not None:
                    fn()
            torch.cuda.synchronize()
        return sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages())

    def device(self, fn):
        """Mean device time per call in ms: the profiled kernel time
        of ``reps`` (flush + call) runs less that of ``reps`` flushes.
        None if the profiler saw no device activity."""
        flush_us = self._profiled_us(None)
        total_us = self._profiled_us(fn)
        if flush_us <= 0 or total_us <= 0:
            return None
        return (total_us - flush_us) / self.reps / 1e3

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warm):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def compare(torch, got, want, tol, what):
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    if not torch.allclose(got, want, **tol):
        raise AssertionError(f"{what}: max abs err {err} (max rel {rel}) "
                             f"outside {tol}")
    return err, rel


# --------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for name, rec in info.items():
        print(rec["ptxas"], file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"]}
                      for n, r in info.items()}})
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return smi.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 2
def _attn_cases(torch):
    """(label, q, k, v, q_pos, kv_pos, window, chunk) at the serving path's
    shapes: prefill of 2 x 4160 tokens (global and local layers) and the
    last decode step against the global cache and the local ring."""
    cfg_h, cfg_kv, D = 8, 4, 256
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")

    ar = torch.arange(PROMPT, dtype=torch.int32, device="cuda").repeat(B, 1)
    q = randn(B, PROMPT, cfg_h, D)
    k, v = randn(B, PROMPT, cfg_kv, D), randn(B, PROMPT, cfg_kv, D)
    yield "prefill_global", q, k, v, ar, ar, None, 1024
    yield "prefill_window4096", q, k, v, ar, ar, 4096, 1024
    last = PROMPT + N_NEW - 1                     # position of the last token
    qd = randn(B, 1, cfg_h, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, MAX_LEN, cfg_kv, D), randn(B, MAX_LEN, cfg_kv, D)
    kp = torch.full((B, MAX_LEN), 2**31 - 1, dtype=torch.int32, device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "decode_global", qd, kc, vc, qp, kp, None, MAX_LEN
    W = 4096                                      # local layers' ring buffer
    ring = torch.arange(last + 1 - W, last + 1, dtype=torch.int32,
                        device="cuda")
    kr = torch.empty((B, W), dtype=torch.int32, device="cuda")
    kr[:, (ring % W).long()] = ring
    yield "decode_ring4096", qd, kc[:, :W].contiguous(), \
        vc[:, :W].contiguous(), qp, kr, W, W


def _attn_library(torch, q, k, v, q_pos, kv_pos, window):
    """F.scaled_dot_product_attention with the position mask and GQA
    expanded beforehand (SDPA has no softcap: it is timed without it)."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qp, kp = q_pos[:, None, :, None].long(), kv_pos[:, None, None, :].long()
    mask = (kp != 2**31 - 1) & (kp <= qp)
    if window is not None:
        mask &= kp > qp - window
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def phase_kernels(torch, timer):
    from repro_torch.kernels import attention, ops, pack
    from repro_torch.kernels.ref import packed_matmul_ref, quant_matmul_ref
    from repro_torch.models.layers import attention_ref
    rows = []
    cap = 50.0
    for label, q, k, v, qp, kp, window, chunk in _attn_cases(torch):
        kern = lambda: attention.flash_attention(
            q, k, v, q_pos=qp, kv_pos=kp, window=window, attn_cap=cap)
        plain = lambda: attention_ref(q, k, v, q_pos=qp, kv_pos=kp,
                                      window=window, attn_cap=cap,
                                      chunk=chunk)
        got = kern()
        torch.cuda.synchronize()
        err, rel = compare(torch, got, plain(), ATTN_TOL, label)
        qq, kk = qp[:, :, None].long(), kp[:, None, :].long()
        valid = (kk != 2**31 - 1) & (kk <= qq)
        if window is not None:
            valid &= kk > qq - window
        pairs = float(valid.sum()) * q.shape[2]           # x query heads
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + \
            4 * (qp.numel() + kp.numel())
        b_ms, b_by = bound_ms(nbytes, 4 * q.shape[3] * pairs)
        rows.append(dict(
            name="flash_attention", case=label, shape=list(q.shape) +
            [k.shape[1]], max_abs_err=err, max_rel_err=rel, tol=ATTN_TOL,
            ms=timer(kern), plain_ms=timer(plain),
            library_ms=timer(_attn_library(torch, q, k, v, qp, kp, window)),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del got
    gemm_shapes = [("wg_decode", 2, 2304, 9216), ("wg_prefill", 8320, 2304,
                                                   9216),
                   ("wd_decode", 2, 9216, 2304),
                   ("unembed_decode", 2, 2304, 256000),
                   ("ragged", 37, 1001, 333)]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for bits, name in ((8, "quant_matmul"), (4, "packed_matmul"),
                       (2, "packed_matmul")):
        lv = 2 ** (bits - 1) - 1
        for label, M, K, N in gemm_shapes:
            x = torch.randn((M, K), generator=g, device="cuda")
            qv = torch.randint(-lv, lv + 1, (K, N), generator=g,
                               device="cuda", dtype=torch.int8)
            s = (torch.rand((N,), generator=g, device="cuda") + 0.5) / \
                (lv * math.sqrt(K))
            if bits == 8:
                w = qv
                kern = lambda: ops.quant_matmul(x, w, s)
                plain = lambda: quant_matmul_ref(x, w, s)
            else:
                w = pack.pack_sub8(qv, bits, axis=0)
                kern = lambda: ops.packed_matmul(x, w, s, store_bits=bits)
                plain = lambda: packed_matmul_ref(x, w, s, bits)
            got = kern()
            torch.cuda.synchronize()
            err, rel = compare(torch, got, plain(), GEMM_TOL,
                               f"{name}/int{bits}/{label}")
            wdeq = qv.float() * s[None, :]
            nbytes = 4 * (M * K + N + M * N) + w.numel()
            b_ms, b_by = bound_ms(nbytes, 2.0 * M * K * N)
            rows.append(dict(
                name=name, case=f"int{bits}_{label}", shape=[M, K, N],
                max_abs_err=err, max_rel_err=rel, tol=GEMM_TOL,
                ms=timer(kern), plain_ms=timer(plain),
                library_ms=timer(lambda: torch.matmul(x, wdeq)),
                device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
            emit({"phase": "kernel", **rows[-1]})
            del x, qv, w, wdeq, got
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 3
def make_policy(graph, seed=SEED):
    """Seeded kernel-wise policy: per-group weight QBNs from POLICY_QBNS,
    so the pruned, int2, int4 and int8 buckets all occur; act QBN 8."""
    from repro_torch.quant.policy import QuantMode, QuantPolicy
    rng = np.random.default_rng(seed)
    wbits = {l.name: rng.choice(POLICY_QBNS, size=l.n_groups).astype(
        np.float32) for l in graph.layers}
    return QuantPolicy(QuantMode.QUANT, wbits,
                       {l.name: 8.0 for l in graph.layers})


def run_engine(torch, label, model, params, policy, tokens, *, store, impl,
               serve_act_bits=True, device="cuda", max_len=MAX_LEN,
               n_new=N_NEW, profile=False):
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, policy=policy, max_len=max_len,
                      weight_store=store, attn_impl=impl,
                      serve_act_bits=serve_act_bits, device=device)
    setup_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    out = eng.generate(tokens, n_new)
    launches = kernels.launch_counts()
    st = out["stats"]
    rec = dict(engine=label, weight_store=store, attn_impl=impl,
               act_bits=serve_act_bits,
               setup_s=setup_s, prefill_s=st.prefill_s,
               decode_tok_per_s=st.decode_tok_per_s,
               peak_mem_bytes=int(torch.cuda.max_memory_allocated())
               if on_card else None,
               weight_hbm_bytes=eng.weight_hbm_bytes(), launches=launches)
    emit({"phase": "serve", **rec})
    result = dict(rec=rec, tokens=out["tokens"], gaps=out["top2_gap"],
                  logits=out["prefill_logits"].float().cpu())
    if profile:
        emit({"phase": "profile", "engine": label,
              **profile_generate(torch, eng, tokens, n_new)})
    del eng, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return result


def profile_generate(torch, eng, tokens, n_new):
    """Device time of one more ``generate`` call by kernel name, and the
    device's busy share of the call's wall time (torch.profiler, CUDA
    activity only)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(tokens, n_new)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sorted(((e.key[:90], e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return dict(wall_s=wall, device_ms=device_ms,
                busy_share=device_ms / 1e3 / wall,
                top=[dict(name=n, ms=ms, calls=c) for n, ms, c in rows[:12]])


def check_serve(torch, a, b, tol, n_layers, vocab, n_new=N_NEW):
    """A (packed, kernels) against B (fake, plain): prefill logits within
    ``tol``; greedy streams equal or first different where B's top-2 gap
    is below ``tol``; K1 launched once per layer per model call, K2 and K3
    at least once, and no kernel in B.  Reports every problem found."""
    problems = []
    for r in (a, b):
        if not bool(torch.isfinite(r["logits"]).all()):
            problems.append(f"engine {r['rec']['engine']}: non-finite")
        if r["tokens"].shape != (B, n_new) or r["tokens"].min() < 0 or \
                r["tokens"].max() >= vocab:
            problems.append("tokens out of shape or range")
    d = (a["logits"] - b["logits"]).abs().flatten()
    diff = float(d.max())
    if diff > tol:
        problems.append(f"prefill logits differ by {diff} > {tol}")
    first = None
    bad = np.argwhere(a["tokens"] != b["tokens"])
    if bad.size:
        t = int(bad[:, 1].min())
        rows = np.unique(bad[bad[:, 1] == t][:, 0])
        gaps = [float(b["gaps"][t, r]) for r in rows]
        first = dict(step=t, rows=rows.tolist(), b_top2_gap=gaps)
        if max(gaps) >= tol:
            problems.append(f"streams differ at step {t} where B's top-2 "
                            f"gap is {gaps}")
    la, lb = a["rec"]["launches"], b["rec"]["launches"]
    want = n_layers * (1 + n_new)
    if la["flash_attention"] != want:
        problems.append(f"flash_attention launched {la['flash_attention']} "
                        f"times, want {want}")
    if la["quant_matmul"] <= 0 or la["packed_matmul"] <= 0:
        problems.append(f"GEMM kernels not on the path: {la}")
    if any(lb.values()):
        problems.append(f"engine B launched kernels: {lb}")
    rec = dict(pair=a["rec"]["engine"] + "/" + b["rec"]["engine"],
               prefill_logit_max_abs_diff=diff,
               prefill_logit_mean_abs_diff=float(d.mean()),
               prefill_logit_p999_abs_diff=float(d.quantile(0.999)),
               tol=tol, streams_equal=first is None,
               first_difference=first, min_b_top2_gap=float(b["gaps"].min()),
               launches_a=la, problems=problems)
    emit({"phase": "check", **rec})
    return rec


def phase_serve(torch):
    """The main path (policy with activation QBN 8), then the same pair
    with activation quantization off, which the tight tolerance holds."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    cfg = ARCHS[ARCH].config
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "layers": cfg.n_layers,
          "seconds": time.perf_counter() - t0})
    policy = make_policy(model.graph(seq_len=1, batch=1))
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                  size=(B, PROMPT))
    recs, checks = {}, []
    for tag, act, tol in (("", True, ACT_LOGIT_ATOL),
                          ("0", False, LOGIT_ATOL)):
        a = run_engine(torch, "A" + tag, model, params, policy, tokens,
                       store="packed", impl="cuda", serve_act_bits=act,
                       profile=act)
        b = run_engine(torch, "B" + tag, model, params, policy, tokens,
                       store="fake", impl="ref", serve_act_bits=act,
                       profile=act)
        recs[tag] = (a["rec"], b["rec"])
        checks.append(check_serve(torch, a, b, tol, cfg.n_layers, cfg.vocab))
        del a, b
    problems = [p for c in checks for p in c["problems"]]
    if problems:
        raise AssertionError("serve checks failed: " + "; ".join(problems))
    return recs[""][0], recs[""][1], checks


# ------------------------------------------------------------------ main
def summarize(rows, launches):
    """One entry per kernel: sums over its measured shapes."""
    out = []
    for name, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        worst = max(mine, key=lambda r: r["bound_ms"])
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine),
            plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            bound_by=worst["bound_by"],
            library_ms=sum(r["library_ms"] for r in mine),
            device_ms=None if any(r["device_ms"] is None for r in mine)
            else sum(r["device_ms"] for r in mine),
            cases=[r["case"] for r in mine]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.backend  # noqa: F401  (TF32 off)

    t0 = time.perf_counter()
    card = phase_build()
    rows = phase_kernels(torch, Timer(torch))
    rec_a, rec_b, checks = phase_serve(torch)
    kernels = summarize(rows, rec_a["launches"])
    result = {"card": card, "kernel_rows": rows, "engine_a": rec_a,
              "engine_b": rec_b, "checks": checks, "kernels": kernels,
              "seconds": time.perf_counter() - t0}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
