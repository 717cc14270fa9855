#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printing one JSON line per result; any failure raises and the
run exits non-zero:

1. build   -- nvcc-compiles the six CUDA kernels from ``src/repro_torch/
              csrc`` in parallel and prints the card's name and power limit.
2. kernels -- holds each kernel against its plain PyTorch version on the
              card at the shapes its path gives it (gemma2-2b serving for
              K1-K4; the search's CIF10 layers and gemma2-2b's stacked
              weights for B5 fake-quant, bit for bit; CIF10's conv0, conv1
              and conv5 im2col and fc products for B6 bit-plane matmul),
              and times kernel, plain version, one library call and the
              bound (CUDA events, L2 flushed before each run, median of
              10).  K1's prefill rows run its TF32 tensor-core walk
              (flash_tc, route tc_3xtf32) and are also held against the
              plain statement of its arithmetic (attention_tf32x3_ref).
              K1's decode rows (the global cache, the local ring, and
              one query at position 40 whose splits are mostly empty) and
              K4's (4 rows at ~4175 positions: global, window, int8 pool;
              4 rows at ~40) run the split-KV walks: each prints its split
              count and is also held against its walk's plain statement;
              every K1 and K4 row must give the same bits on a second call.
              The GEMM rows cover generate's shapes and run()'s 2048-row
              chunk shapes; each prints its route (K2 and K3: tc_2xtf32
              for M > 8, else skinny) and that route's bound beside the
              function's; every tensor-core row must also come within
              TC_ERR_LIMIT of quant_matmul_ref / packed_matmul_ref.  Every
              bound counts the function's operations at the TF32 peak
              where its values are exact in TF32 or the route makes them
              so (GEMMs, attention); `route_bound_ms` is the floor of the
              route taken (2 TF32 passes for the GEMMs on tensor cores, 3
              for K1's prefill, fp32 on CUDA cores for the rest).
3. serve   -- ServeEngine.generate on gemma2-2b at full width and depth
              with a seeded kernel-wise policy: engine A (packed store,
              CUDA kernels) against engine B (fake-quant store, plain
              attention), both on the card.  Checks the prefill logits,
              the greedy streams (top-2 gap rule) and the launch counts.
4. paged-model -- LM.model_step feeds one 4160-token prompt in 512-token
              chunks into a fresh paged pool (K4); its last-token logits
              must match LM.prefill's (K1).
5. run     -- ServeEngine.run, continuous batching of 8 mixed-length
              requests over the paged pool on engine A: overlap on ==
              off bitwise, every stream against the same engine's
              generate (top-2 gap rule), monolithic prefill on the first
              4, launch counts, host syncs per step, and one profiled run
              (device time by kernel group: K4's chunk and decode
              launches, K2's and K3's GEMMs).
6. search  -- the AutoQ search on CIF10-7CNN at full width: trains the
              substrate (250 Adam steps, batch 128, as the example does)
              twice from one seed and requires every leaf equal bit for
              bit (cuDNN runs deterministic, repro_torch.backend), then
              runs a short QUANT search (HierarchicalAgent, 5 episodes)
              twice on it and requires equal policies (every group's and
              every activation QBN) and rewards; checks the 32-bit policy
              against the unquantized accuracy,
              the QUANT evaluator on B5 against a plain evaluation (weights
              bit for bit, same accuracy) for three seeded policies, and
              the BINARIZE evaluator on B6 against the dense
              fake-binarized conv (logits within 1e-4); then run_search
              with a HierarchicalAgent, 40 QUANT and 20 BINARIZE episodes
              (accuracy-guaranteed reward), with seconds per episode split
              into acting, evaluating and updating, exactly 8 launches
              per evaluation of its mode's kernel, one profiled
              evaluation (kernel launches, B6's device time) and, for
              BINARIZE, the im2col's event time and launches; last, one
              make_lm_evaluator call on the gemma2-2b params against a
              plain evaluation (weights bit for bit, logits against the
              plain-attention forward, accuracy by the gap rule).

The line before the last lists every kernel with its launches on its path
(K1-K3: generate; K4: run; B5: the QUANT search; B6: the BINARIZE search)
and its times; the last line is
``{"ok": true, "device": {...}}``.
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
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet: HBM3 bandwidth
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet: fp32, non-tensor
TF32_FLOP_PER_S = 495e12      # H100 SXM data sheet: TF32 tensor, dense
# device-time groups of the profiled runs: kernel-name fragments
KERNEL_GROUPS = {
    "k1_tc": ("flash_tc",),
    "k1_split": ("flash_split", "split_combine"),
    "k4_chunk": ("paged_fwd",),
    "k4_decode": ("paged_split", "paged_combine"),
    "k2_tc": ("Int8Stage",),              # gemm_tc's weight source names it
    "k2_skinny": ("gemm_skinny<8>",),
    "k3_tc": ("PackedStage",),
    "k3_skinny": ("gemm_skinny<4>", "gemm_skinny<2>"),
    "gemm_reduce_k2_k3": ("gemm_reduce",),
}

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_attention.py:25
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_packed.py:68-69
# K2's and K3's tensor-core rows (outputs ~0.5): a sound two-pass kernel
# ends within ~1.4e-5 of quant_matmul_ref / packed_matmul_ref at K = 9216,
# one that chains every MMA into the truncating accumulator ~1.7e-4 (still
# inside GEMM_TOL by its rtol)
TC_ERR_LIMIT = 5e-5
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
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/attention.py:206"),
    "fake_quant": ("src/repro_torch/csrc/fake_quant.cu",
                   "src/repro/kernels/fake_quant.py:19"),
    "binary_matmul": ("src/repro_torch/csrc/binary_matmul.cu",
                      "src/repro/kernels/binary_matmul.py:20"),
}

# phase search: CIF10-7CNN, the example's substrate preparation and a
# 40 + 20 episode search (examples/autoq_search_cnn.py's schedule, cut)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, VAL_IMAGES = 250, 128, 2e-3, 512
SEARCH_RUNS = (("quant", 10, 30), ("binarize", 5, 15))
DETERMINISM_EPISODES = (3, 2)       # explore, exploit: C1's repeat check
LM_EVAL_BATCH, LM_EVAL_LEN = 4, 128
FQ_NOTE = ("no single PyTorch call: torch.fake_quantize_per_channel_affine "
           "takes one integer range for all channels, with no prune or "
           "pass-through")

# phase run: 8 requests over 4 slots, so later requests reuse freed pages
RUN_PROMPTS = (4160, 3100, 2050, 1030, 515, 260, 97, 33)
RUN_NEW = (16, 12, 16, 8, 16, 12, 16, 10)
RUN_SLOTS, PAGE, CHUNK = 4, 16, 512
SENT = 2**31 - 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, flop_per_s=FP32_FLOP_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def kernel_groups(keyed):
    """Device ms and launches of each KERNEL_GROUPS group from
    ``(kernel name, device ms, calls)`` triples."""
    return {g: dict(ms=sum(ms for n, ms, _ in keyed
                           if any(f in n for f in frags)),
                    calls=sum(c for n, ms, c in keyed
                              if any(f in n for f in frags) and ms > 0))
            for g, frags in KERNEL_GROUPS.items()}


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
    shapes: prefill of 2 x 4160 tokens (global and local layers), the last
    decode step against the global cache and the local ring, and an early
    decode step (position 40) against the global cache."""
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
    # one query at position 40 over the whole cache: most splits are empty
    qs = torch.full((B, 1), 40, dtype=torch.int32, device="cuda")
    ks = torch.full((B, MAX_LEN), SENT, dtype=torch.int32, device="cuda")
    ks[:, :41] = torch.arange(41, dtype=torch.int32, device="cuda")
    yield "decode_short", qd, kc, vc, qs, ks, None, MAX_LEN


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


def _paged_pool(torch, g, rows, k, kv_bits=None):
    """A pool of PAGE-slot pages (Hkv 4, D 256) in shuffled order and one q
    tile of ``k`` columns per row.  rows: per row (L, c0, c): the row holds
    positions 0..L-1 and its real columns are positions c0..c0+c-1 (the
    chunk or token just written); L == 0 is an idle lane (all-trash table,
    all-sentinel tile).  Returns (q, k, v, pos, bt, q_pos, k_s, v_s)."""
    Hkv, G, D = 4, 2, 256
    nb = MAX_LEN // PAGE
    B, P = len(rows), 1 + len(rows) * nb
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    bt = torch.zeros((B, nb), dtype=torch.int32, device="cuda")
    pos = torch.full((P, PAGE), SENT, dtype=torch.int32, device="cuda")
    qp = torch.full((B, k), SENT, dtype=torch.int32, device="cuda")
    used = 0
    for i, (L, c0, c) in enumerate(rows):
        n = -(-L // PAGE)
        pages = perm[used:used + n]
        used += n
        bt[i, :n] = pages.int()
        ar = torch.arange(L, dtype=torch.int64, device="cuda")
        pos[pages[ar // PAGE], ar % PAGE] = ar.int()
        qp[i, :c] = torch.arange(c0, c0 + c, dtype=torch.int32, device="cuda")
    kf = torch.randn((P, PAGE, Hkv, D), generator=g, device="cuda")
    vf = torch.randn((P, PAGE, Hkv, D), generator=g, device="cuda")
    q = torch.randn((B, k, Hkv * G, D), generator=g, device="cuda")
    if kv_bits != 8:
        return q, kf, vf, pos, bt, qp, None, None
    from repro_torch.models.transformer import _kv_quant
    (kq, ks), (vq, vs) = _kv_quant(kf), _kv_quant(vf)
    return q, kq, vq, pos, bt, qp, ks, vs


def _paged_cases():
    """(label, rows, k, window, kv_bits) at the run phase's shapes: 512-token
    chunks (a late chunk of a 4160-token prompt, a first chunk, a partial
    chunk, an idle lane), decode tokens at ~4175 positions, and decode
    tokens at ~40 (most splits empty)."""
    chunk = [(4160, 3648, 512), (512, 0, 512), (1254, 1024, 230), (0, 0, 0)]
    dec = [(4176, 4175, 1), (4171, 4170, 1), (4161, 4160, 1),
           (4101, 4100, 1)]
    short = [(41, 40, 1), (44, 43, 1), (39, 38, 1), (37, 36, 1)]
    yield "chunk_global", chunk, CHUNK, None, None
    yield "chunk_window4096", chunk, CHUNK, 4096, None
    yield "decode_global", dec, 1, None, None
    yield "decode_window4096", dec, 1, 4096, None
    yield "decode_int8", dec, 1, None, 8
    yield "decode_short", short, 1, None, None


def paged_rows(torch, timer, cap):
    """K4 against paged_attention_ref on the real (non-sentinel) columns
    (and, where it splits, against the split walk's plain statement); the
    idle lane must come back as exact zeros, and a second call must give
    the same bits."""
    from repro_torch.kernels import attention
    from repro_torch.kernels.ref import paged_attention_split_ref
    from repro_torch.models.layers import paged_attention_ref, paged_gather
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, spec, k, window, kv_bits in _paged_cases():
        q, kp, vp, pos, bt, qp, ks, vs = _paged_pool(torch, g, spec, k,
                                                     kv_bits)
        args = (q, kp, vp, pos, bt)
        kw = dict(q_pos=qp, window=window, attn_cap=cap, k_scale_pages=ks,
                  v_scale_pages=vs)
        kern = lambda: attention.paged_prefill_attention(*args, **kw)
        plain = lambda: paged_attention_ref(*args, **kw)
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paged/{label}: two calls on the same "
                                 "inputs give different bits")
        want = plain()
        real = [(i, c) for i, (_, _, c) in enumerate(spec) if c]
        pick = lambda t: torch.cat([t[i, :c] for i, c in real])
        err, rel = compare(torch, pick(got), pick(want), ATTN_TOL,
                           f"paged/{label}")
        ns = attention.paged_decode_splits(
            q.shape[0], k, q.shape[2], kp.shape[2], bt.shape[1] * PAGE, n_sm)
        split_err = None
        if ns > 1:
            split_err, _ = compare(
                torch, pick(got), pick(paged_attention_split_ref(
                    *args, **kw, n_splits=ns)), ATTN_TOL,
                f"paged/{label}/split")
        for i, (L, _, c) in enumerate(spec):
            if not L and bool((got[i] != 0).any()):
                raise AssertionError(f"paged/{label}: idle lane {i} is not "
                                     "exact zeros")
        # bound: the pages the walk must read (first block of the window of
        # column 0 to the block of the last real position), q and o, and
        # 4 D operations per allowed (query head, key) pair
        Hkv, D = kp.shape[2], kp.shape[3]
        page_bytes = PAGE * (2 * Hkv * D * kp.element_size() + 4)
        if ks is not None:
            page_bytes += 2 * PAGE * Hkv * 4
        n_pages = 0
        for L, c0, c in spec:
            if c:
                first = max(0, c0 - (window - 1)) // PAGE if window else 0
                n_pages += (c0 + c - 1) // PAGE - first + 1
        kvp = paged_gather(pos, bt)
        qq, kk = qp[:, :, None].long(), kvp[:, None, :].long()
        valid = (kk != SENT) & (qq != SENT) & (kk <= qq)
        if window is not None:
            valid &= kk > qq - window
        pairs = float(valid.sum()) * q.shape[2]
        nbytes = n_pages * page_bytes + 8 * q.numel() + \
            4 * (bt.numel() + qp.numel())
        # the function's operations at the TF32 peak (3 TF32 passes give
        # fp32 accuracy); its route's, fp32 FMAs on CUDA cores, beside it
        b_ms, b_by = bound_ms(nbytes, 4 * D * pairs, TF32_FLOP_PER_S)
        r_ms = bound_ms(nbytes, 4 * D * pairs)[0]
        kg, vg = paged_gather(kp, bt), paged_gather(vp, bt)
        if ks is not None:
            kg = kg.float() * paged_gather(ks, bt)[..., None]
            vg = vg.float() * paged_gather(vs, bt)[..., None]
        rows.append(dict(
            name="paged_attention", case=label,
            shape=list(q.shape) + [bt.shape[1] * PAGE], splits=ns,
            route="fp32_split" if ns > 1 else "fp32_walk",
            route_bound_ms=r_ms,
            split_ref_max_abs_err=split_err, max_abs_err=err,
            max_rel_err=rel, tol=ATTN_TOL, ms=timer(kern),
            plain_ms=timer(plain),
            library_ms=timer(_attn_library(torch, q, kg, vg, qp, kvp,
                                           window)),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by,
            pages_walked=n_pages))
        emit({"phase": "kernel", **rows[-1]})
        del got, again, want, kg, vg, kp, vp
    torch.cuda.empty_cache()
    return rows


def _fq_inputs(torch, g, M, N):
    """x (M, N) and per-column scale / levels / bits as the QUANT evaluator
    makes them: bits from 0..8 with every 16th column at 32."""
    x = torch.randn((M, N), generator=g, device="cuda")
    bits = torch.randint(0, 9, (N,), generator=g, device="cuda").float()
    bits[::16] = 32.0
    lv = torch.clamp(torch.pow(2.0, bits - 1.0) - 1.0, min=1.0)
    amax = x.abs().amax(dim=0)
    sc = torch.where(amax > 0, amax / lv, torch.ones_like(amax))
    return x, sc, lv, bits


def search_kernel_rows(torch, timer):
    """B5 at the search's CIF10 conv5 and fc weights and at gemma2-2b's
    stacked wg and unembed (bit for bit); B6 at CIF10's conv0, conv1 and
    conv5 im2col products, the fc, and one single-plane case (GEMM_TOL).  B6's
    bound counts 2 M K N operations, the fewest any implementation of the
    function needs; its library call is torch.matmul against the folded
    weight."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import binary_matmul_ref, fake_quant_ref
    cfg = ARCHS[ARCH].config
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = []
    for label, M, N in (("cif10_conv5", 9 * 128, 128), ("cif10_fc", 128, 10),
                        ("gemma2_wg_stack", cfg.n_repeat * cfg.d_model,
                         cfg.d_ff),
                        ("gemma2_unembed", cfg.d_model, cfg.vocab_padded)):
        x, sc, lv, bits = _fq_inputs(torch, g, M, N)
        kern = lambda: ops.fake_quant_channels(x, sc, lv, bits)
        plain = lambda: fake_quant_ref(x, sc, lv, bits)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"fake_quant/{label}: differs from its plain "
                                 f"version (max abs err {err})")
        b_ms, b_by = bound_ms(4 * (2 * M * N + 3 * N), 5.0 * M * N)
        rows.append(dict(
            name="fake_quant", case=label, shape=[M, N], max_abs_err=err,
            max_rel_err=0.0, tol="bitwise", ms=timer(kern),
            plain_ms=timer(plain), library_ms=None, library_note=FQ_NOTE,
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del x, got, want
    torch.cuda.empty_cache()
    for label, M, K, N, P in (("cif10_conv0_im2col", 512 * 32 * 32, 9 * 3,
                               32, 8),
                              ("cif10_conv1_im2col", 512 * 32 * 32, 9 * 32,
                               32, 8),
                              ("cif10_conv5_im2col", 512 * 8 * 8, 9 * 128,
                               128, 8),
                              ("cif10_fc", 512, 128, 10, 8),
                              ("conv5_one_plane", 512 * 8 * 8, 9 * 128, 128,
                               1)):
        x = torch.randn((M, K), generator=g, device="cuda")
        planes = (torch.randint(0, 2, (P, K, N), generator=g, device="cuda")
                  * 2 - 1).to(torch.int8)
        alpha = torch.rand((P, N), generator=g, device="cuda") / math.sqrt(K)
        kern = lambda: ops.binary_matmul(x, planes, alpha)
        plain = lambda: binary_matmul_ref(x, planes, alpha)
        got = kern()
        torch.cuda.synchronize()
        err, rel = compare(torch, got, plain(), GEMM_TOL,
                           f"binary_matmul/{label}")
        w_hat = (alpha[:, None, :] * planes.float()).sum(0)
        b_ms, b_by = bound_ms(4 * (M * K + P * N + M * N) + P * K * N,
                              2.0 * M * K * N)
        rows.append(dict(
            name="binary_matmul", case=label, shape=[M, K, N, P],
            max_abs_err=err, max_rel_err=rel, tol=GEMM_TOL, ms=timer(kern),
            plain_ms=timer(plain),
            library_ms=timer(lambda: torch.matmul(x, w_hat)),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del x, planes, got, w_hat
    torch.cuda.empty_cache()
    return rows


def flash_rows(torch, timer, cap):
    """K1 against attention_ref and against the plain statement of its
    route (the tensor-core walk's attention_tf32x3_ref, or the split walk's
    attention_split_ref), the same bits on a second call."""
    from repro_torch.kernels import attention
    from repro_torch.kernels.ref import (attention_split_ref,
                                         attention_tf32x3_ref)
    from repro_torch.models.layers import attention_ref
    rows = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, q, k, v, qp, kp, window, chunk in _attn_cases(torch):
        kern = lambda: attention.flash_attention(
            q, k, v, q_pos=qp, kv_pos=kp, window=window, attn_cap=cap)
        plain = lambda: attention_ref(q, k, v, q_pos=qp, kv_pos=kp,
                                      window=window, attn_cap=cap,
                                      chunk=chunk)
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two calls on the same inputs "
                                 "give different bits")
        err, rel = compare(torch, got, plain(), ATTN_TOL, label)
        ns = attention.decode_splits(q.shape[0], q.shape[1], q.shape[2],
                                     k.shape[2], k.shape[1], n_sm)
        kw = dict(q_pos=qp, kv_pos=kp, window=window, attn_cap=cap)
        if ns > 1:
            route, route_ref = "fp32_split", attention_split_ref(
                q, k, v, **kw, n_splits=ns)
        else:
            route, route_ref = "tc_3xtf32", attention_tf32x3_ref(q, k, v,
                                                                 **kw)
        route_err, _ = compare(torch, got, route_ref, ATTN_TOL,
                               f"{label}/{route}")
        del route_ref
        qq, kk = qp[:, :, None].long(), kp[:, None, :].long()
        valid = (kk != 2**31 - 1) & (kk <= qq)
        if window is not None:
            valid &= kk > qq - window
        pairs = float(valid.sum()) * q.shape[2]           # x query heads
        # K/V rows that some query may attend, read once per kv head
        slots = float(valid.any(dim=1).sum())
        nbytes = 4 * (2 * q.numel() + 2 * slots * k.shape[2] * k.shape[3]) \
            + 4 * (qp.numel() + kp.numel())
        # the function's operations at the TF32 peak; its route's beside
        # it: 3 TF32 passes (flash_tc), or fp32 FMAs on CUDA cores (split)
        flops = 4 * q.shape[3] * pairs
        b_ms, b_by = bound_ms(nbytes, flops, TF32_FLOP_PER_S)
        r_ms = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)[0] \
            if route == "tc_3xtf32" else bound_ms(nbytes, flops)[0]
        rows.append(dict(
            name="flash_attention", case=label, shape=list(q.shape) +
            [k.shape[1]], splits=ns, route=route, route_bound_ms=r_ms,
            route_ref_max_abs_err=route_err,
            max_abs_err=err, max_rel_err=rel, tol=ATTN_TOL,
            ms=timer(kern), plain_ms=timer(plain),
            library_ms=timer(_attn_library(torch, q, k, v, qp, kp, window)),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del got, again
    return rows


def phase_kernels(torch, timer):
    from repro_torch.kernels import ops, pack, quant_matmul
    from repro_torch.kernels.ref import packed_matmul_ref, quant_matmul_ref
    cap = 50.0
    rows = search_kernel_rows(torch, timer) + paged_rows(torch, timer, cap) \
        + flash_rows(torch, timer, cap)
    gemm_shapes = [("wg_decode", 2, 2304, 9216), ("wg_prefill", 8320, 2304,
                                                   9216),
                   ("wd_decode", 2, 9216, 2304),
                   ("unembed_decode", 2, 2304, 256000),
                   ("wg_chunk", 2048, 2304, 9216),
                   ("wd_chunk", 2048, 9216, 2304),
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
            route = quant_matmul.route(M, bits)
            if route == "tc_2xtf32" and err > TC_ERR_LIMIT:
                raise AssertionError(f"{name}/int{bits}/{label}: max abs err "
                                     f"{err} over {TC_ERR_LIMIT}")
            # the function's 2 M K N operations at the TF32 peak (an integer
            # weight is exact in TF32); its route's own work beside it: two
            # TF32 passes on the tensor cores, else fp32 on CUDA cores.
            # Every tensor-core row (K2 and K3) is held to TC_ERR_LIMIT
            flops = 2.0 * M * K * N
            b_ms, b_by = bound_ms(nbytes, flops, TF32_FLOP_PER_S)
            r_ms = bound_ms(nbytes, 2 * flops, TF32_FLOP_PER_S)[0] \
                if route == "tc_2xtf32" else bound_ms(nbytes, flops)[0]
            rows.append(dict(
                name=name, case=f"int{bits}_{label}", shape=[M, K, N],
                route=route, route_bound_ms=r_ms, max_abs_err=err,
                max_rel_err=rel, tol=GEMM_TOL,
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
        rec["profile"] = profile_call(torch,
                                      lambda: eng.generate(tokens, n_new))
        emit({"phase": "profile", "engine": label, **rec["profile"]})
    del eng, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return result


def profile_call(torch, fn, match=()):
    """Device time of one ``fn()`` by kernel name, the device launches
    (entries with device time), and the device's busy share of its wall
    time (torch.profiler, CUDA activity only); for each name fragment in
    ``match``, the device ms and launches of the kernels whose names hold
    it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    out = dict(wall_s=wall, device_ms=device_ms,
               busy_share=device_ms / 1e3 / wall,
               kernel_launches=sum(r[2] for r in rows if r[1] > 0),
               groups=kernel_groups(rows),
               top=[dict(name=n[:90], ms=ms, calls=c)
                    for n, ms, c in rows[:12]])
    for m in match:
        out[m] = dict(ms=sum(r[1] for r in rows if m in r[0]),
                      calls=sum(r[2] for r in rows if m in r[0]))
    return out


def im2col_profile(torch, cfg):
    """The im2col of one BINARIZE evaluation, after one warm-up call: the
    7 convs' inputs at VAL_IMAGES images (contiguous NHWC; on the path
    some are permuted views, copied the same way).  Its CUDA-event time
    (its copies of ~1.2 GB outlast the host's launches) and its kernel
    launches, counted as the runtime's cudaLaunchKernel calls."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.cnn import im2col
    xs, h, c = [], cfg.img_size, cfg.in_channels
    for i, cout in enumerate(cfg.channels):
        xs.append(torch.randn((VAL_IMAGES, h, h, c), device="cuda"))
        c = cout
        if i in cfg.pool_after:
            h //= 2
    fn = lambda: [im2col(x, cfg.kernel) for x in xs]
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return dict(event_ms=a.elapsed_time(b), kernel_launches=launches)


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


def init_model(torch):
    """Full-width gemma2-2b with random weights from SEED, on the card, and
    the seeded policy."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    cfg = ARCHS[ARCH].config
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "layers": cfg.n_layers,
          "seconds": time.perf_counter() - t0})
    return cfg, model, params, make_policy(model.graph(seq_len=1, batch=1))


def phase_serve(torch, cfg, model, params, policy):
    """The main path (policy with activation QBN 8), then the same pair
    with activation quantization off, which the tight tolerance holds."""
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


# --------------------------------------------------------------- phase 4
def phase_paged_model(torch, cfg, model, eng):
    """LM.model_step over one PROMPT-token prompt in CHUNK-token chunks
    into a fresh pool with shuffled pages, against LM.prefill on the same
    packed store: last-token logits within LOGIT_ATOL with activation
    quantization off and ACT_LOGIT_ATOL with the policy's QBN 8."""
    from repro_torch.serve.paged_kv import pages_needed
    rng = np.random.default_rng(SEED + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, PROMPT)),
                           device="cuda")
    n = pages_needed(PROMPT, PAGE)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    bt = (torch.randperm(n, generator=g, device="cuda") + 1).int()[None]
    out = []
    for act, tol in ((False, LOGIT_ATOL), (True, ACT_LOGIT_ATOL)):
        ab = eng.act_bits if act else None
        dense = model.init_cache(1, PROMPT, device="cuda")
        want, _ = model.prefill(eng.params, {"tokens": toks}, dense, ab,
                                attn_impl="cuda")
        del dense
        pool = model.init_paged_cache(1, n + 1, PAGE, device="cuda")
        for c0 in range(0, PROMPT, CHUNK):
            c = min(CHUNK, PROMPT - c0)
            t = torch.zeros((1, CHUNK), dtype=torch.int64, device="cuda")
            p = torch.full((1, CHUNK), SENT, dtype=torch.int32, device="cuda")
            t[0, :c] = toks[0, c0:c0 + c]
            p[0, :c] = torch.arange(c0, c0 + c, dtype=torch.int32,
                                    device="cuda")
            got, pool = model.model_step(
                eng.params, t, p, torch.zeros(1, dtype=torch.int32,
                                              device="cuda"),
                pool, bt, torch.full((1,), c - 1, dtype=torch.int32,
                                     device="cuda"), ab, attn_impl="cuda")
        del pool
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("paged-model: non-finite logits")
        diff = float((got[0, 0] - want[0, 0]).abs().max())
        out.append(dict(act_bits=act, max_abs_diff=diff, tol=tol))
        emit({"phase": "paged-model", **out[-1]})
        if diff > tol:
            raise AssertionError(f"paged-model: model_step logits differ "
                                 f"from prefill by {diff} > {tol}")
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 5
def _run_record(torch, label, res, wall, launches):
    st = res["stats"]
    rec = dict(run=label, wall_s=wall, steps=st.steps,
               prefill_s=st.prefill_s, decode_s=st.decode_s,
               decode_tok_per_s=st.decode_tok_per_s,
               tokens_out=st.tokens_out,
               ttft_s=st.ttft_percentiles((50, 99)),
               peak_pages=st.peak_pages, requeues=st.requeues,
               peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
               launches=launches,
               k4_per_step=launches["paged_attention"] / max(st.steps, 1))
    emit({"phase": "run", **rec})
    return rec


def profile_run(torch, eng, reqs, kw):
    """One profiled ``run()`` with the sync debug mode at "warn": device
    time by kernel name, the device's busy share of the wall time, and the
    host syncs the step loop made (each would stall the pipeline)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as seen, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = eng.run(reqs, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = [str(w.message)[:120] for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    steps = res["stats"].steps
    return res, dict(wall_s=wall, device_ms=device_ms,
                     busy_share=device_ms / 1e3 / wall, steps=steps,
                     host_syncs=len(syncs),
                     host_syncs_per_step=len(syncs) / max(steps, 1),
                     sync_examples=sorted(set(syncs))[:3],
                     groups=kernel_groups(rows),
                     top=[dict(name=n[:90], ms=ms, calls=c)
                          for n, ms, c in rows[:12]])


def _check_streams(name, got, want, gaps, tol, problems):
    """Equal, or first different where generate's top-2 gap is below
    ``tol``; returns the first difference (or None)."""
    if got.shape != want.shape:
        problems.append(f"{name}: stream shape {got.shape} != {want.shape}")
        return None
    bad = np.flatnonzero(got != want)
    if not bad.size:
        return None
    t = int(bad[0])
    first = dict(request=name, step=t, gap=float(gaps[t]))
    if gaps[t] >= tol:
        problems.append(f"{name}: differs from generate at step {t} where "
                        f"its top-2 gap is {gaps[t]}")
    return first


def phase_run(torch, cfg, model, params, policy):
    """Continuous batching on engine A: 8 requests over 4 slots."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    rng = np.random.default_rng(SEED)
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in zip(RUN_PROMPTS, RUN_NEW)]
    eng = ServeEngine(model, params, policy=policy, max_len=MAX_LEN,
                      weight_store="packed", attn_impl="cuda",
                      device="cuda")
    paged = phase_paged_model(torch, cfg, model, eng)
    kw = dict(page_size=PAGE, max_slots=RUN_SLOTS, chunk_tokens=CHUNK)
    problems, recs = [], {}
    nl = cfg.n_layers
    for label, extra, rq in (("sync", dict(overlap=False), reqs),
                             ("overlap", dict(overlap=True), reqs),
                             ("monolithic", dict(prefill="monolithic"),
                              reqs[:4])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.run(rq, **kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        recs[label] = (res, _run_record(torch, label, res, wall, launches))
        st = res["stats"]
        if label == "monolithic":
            want = {"flash_attention": nl * len(rq),
                    "paged_attention": nl * st.steps}
        else:
            want = {"flash_attention": 0, "paged_attention": nl * st.steps}
        for name, n in want.items():
            if launches[name] != n:
                problems.append(f"run {label}: {name} launched "
                                f"{launches[name]} times, want {n}")
        if launches["quant_matmul"] <= 0 or launches["packed_matmul"] <= 0:
            problems.append(f"run {label}: GEMM kernels not on the path: "
                            f"{launches}")
    on, off = recs["overlap"][0]["outputs"], recs["sync"][0]["outputs"]
    bitwise = all(np.array_equal(a, b) for a, b in zip(on, off))
    if not bitwise:
        problems.append("run: overlap on and off give different streams")
    if eng.trace_counts["model_step"] > 2:
        problems.append(f"run: model_step saw {eng.trace_counts} shapes")
    firsts = []
    for i, (toks, n_new) in enumerate(reqs):
        gen = eng.generate(toks[None], n_new)
        want, gaps = gen["tokens"][0], gen["top2_gap"][:, 0]
        if not np.all((want >= 0) & (want < cfg.vocab)):
            problems.append(f"request {i}: generate tokens out of range")
        for label in ("overlap", "monolithic"):
            outs = recs[label][0]["outputs"]
            if i < len(outs):
                f = _check_streams(f"{label}/{i}", outs[i], want, gaps,
                                   ACT_LOGIT_ATOL, problems)
                if f:
                    firsts.append(f)
    check = dict(overlap_bitwise=bitwise, first_differences=firsts,
                 trace_counts=dict(eng.trace_counts), problems=problems)
    emit({"phase": "run-check", **check})
    res, prof = profile_run(torch, eng, reqs, dict(kw, overlap=True))
    if not all(np.array_equal(a, b) for a, b in zip(res["outputs"], on)):
        problems.append("run: the profiled run's streams differ")
    emit({"phase": "run-profile", **prof})
    if problems:
        raise AssertionError("run checks failed: " + "; ".join(problems))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(paged_model=paged,
                runs={k: v[1] for k, v in recs.items()}, check=check,
                profile=prof)


# --------------------------------------------------------------- phase 6
def train_substrate(torch, model, params, data):
    """The example's preparation: TRAIN_STEPS Adam steps (the port's
    core.ddpg.adam_update, lr TRAIN_LR) on fresh synthetic batches."""
    from repro_torch import backend
    from repro_torch.core.ddpg import (adam_init, adam_update, tree_leaves,
                                       tree_map, tree_unflatten)
    dev = torch.device("cuda")
    opt = adam_init(params)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        b = {k: backend.upload(v, dev)
             for k, v in data.batch(i, TRAIN_BATCH).items()}
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = model.loss(p, b)
        grads = tree_unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
        params, opt = adam_update(tree_map(torch.detach, p), grads, opt,
                                  TRAIN_LR)
        losses.append(loss.detach())
    torch.cuda.synchronize()
    return params, dict(seconds=time.perf_counter() - t0,
                        first_loss=float(losses[0]),
                        last_loss=float(losses[-1]))


def _cnn_policy(graph, seed, mode, act=None):
    """Seeded kernel-wise policy: weight QBNs from 0..8 and 32, activation
    QBNs from 3..8 (or ``act``)."""
    from repro_torch.quant.policy import QuantPolicy
    rng = np.random.default_rng(seed)
    wb = {l.name: rng.choice([0, 1, 2, 3, 4, 5, 6, 8, 32],
                             size=l.n_groups).astype(np.float32)
          for l in graph.layers}
    ab = {l.name: float(act if act is not None else rng.integers(3, 9))
          for l in graph.layers}
    return QuantPolicy(mode, wb, ab)


def _syncs_of(torch, fn):
    """Host syncs ``fn`` makes, counted by the sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing CUDA operation" in
                    str(w.message) for w in seen)


def check_evaluators(torch, model, params, graph, val, acc_raw):
    """The 32-bit policy == unquantized; QUANT on B5 == a plain evaluation
    (weights bit for bit, same accuracy) for three seeded policies;
    BINARIZE on B6 == the dense fake-binarized forward (plane-form weights
    bit for bit, logits 1e-4) with activations at 32 bits.  Counts host syncs per evaluation."""
    from repro_torch import backend
    from repro_torch.core import evaluate, make_cnn_evaluator
    from repro_torch.models.cnn import conv_rows
    from repro_torch.quant.apply import apply_policy_to_params, get_path
    from repro_torch.quant.policy import QuantMode, QuantPolicy
    dev = torch.device("cuda")
    names = [l.name for l in graph.layers]
    xb = {k: backend.upload(v, dev) for k, v in val.items()}
    problems, rec = [], {}
    ev = {m: make_cnn_evaluator(model, params, graph, val, mode=m)
          for m in (QuantMode.QUANT, QuantMode.BINARIZE)}
    acc32 = ev[QuantMode.QUANT](QuantPolicy.uniform(graph, 32.0))
    rec["acc_uniform32"] = acc32
    if abs(acc32 - acc_raw) > 1e-3:
        problems.append(f"32-bit policy {acc32} != unquantized {acc_raw}")
    rec["quant"] = []
    for seed in range(3):
        pol = _cnn_policy(graph, SEED + 10 + seed, QuantMode.QUANT)
        wb, _ = evaluate.upload_bits(pol, graph, dev)
        with torch.no_grad():
            q = evaluate._quantize_params(params, graph, wb, QuantMode.QUANT)
            plain = apply_policy_to_params(params, graph, pol)
            same = all(torch.equal(get_path(q, l.param_path),
                                   get_path(plain, l.param_path))
                       for l in graph.layers)
            acc_plain = float(model.accuracy(
                plain, xb, act_bits=pol.act_bits)) * 100.0
        acc, syncs = _syncs_of(torch, lambda: ev[QuantMode.QUANT](pol))
        rec["quant"].append(dict(seed=seed, weights_bitwise=same, acc=acc,
                                 acc_plain=acc_plain, host_syncs=syncs))
        if not same or acc != acc_plain:
            problems.append(f"QUANT policy {seed}: weights bitwise {same}, "
                            f"acc {acc} vs plain {acc_plain}")
    pol = _cnn_policy(graph, SEED + 20, QuantMode.BINARIZE, act=32.0)
    wb, _ = evaluate.upload_bits(pol, graph, dev)
    with torch.no_grad():
        qp = evaluate._quantize_params(params, graph, wb, QuantMode.BINARIZE,
                                       planes=True)
        dense = apply_policy_to_params(params, graph, pol)
        # the plane form summed in plane order (as B6 folds it) == the dense
        # fake-binarized weight, bit for bit
        w_same = True
        for l in graph.layers:
            node = get_path(qp, l.param_path[:-1])
            folded = torch.zeros(node["planes"].shape[1:], device=dev)
            for a, b in zip(node["alpha"], node["planes"]):
                folded = folded + a * b.float()
            w = get_path(dense, l.param_path)
            w_same &= torch.equal(folded, conv_rows(w) if l.kind == "conv"
                                  else w)
        got = model.apply(qp, xb["x"])
        want = model.apply(dense, xb["x"])
    diff = float((got - want).abs().max())
    acc_b, syncs_b = _syncs_of(torch, lambda: ev[QuantMode.BINARIZE](pol))
    rec["binarize"] = dict(logit_max_abs_diff=diff, tol=GEMM_TOL,
                           weights_bitwise=w_same, acc=acc_b,
                           host_syncs=syncs_b,
                           logit_max_abs=float(want.abs().max()))
    if not w_same:
        problems.append("BINARIZE plane form != the dense fake-binarized "
                        "weights")
    if not bool(torch.isfinite(got).all()) or \
            not torch.allclose(got, want, **GEMM_TOL):
        problems.append(f"BINARIZE logits differ from the dense forward by "
                        f"{diff}")
    rec["problems"] = problems
    emit({"phase": "search-check", **rec})
    return rec


def _timed_agent(agent):
    """Wrap the controllers' act / update and the env's evaluator with
    host timers (act and update read back to the host, the evaluator
    reads its accuracy, so each call ends synchronised)."""
    spent = {"act": 0.0, "evaluate": 0.0, "update": 0.0}
    calls = {"act": 0, "evaluate": 0, "update": 0}

    def wrap(obj, attr, key):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[key] += time.perf_counter() - t0
            calls[key] += 1
            return out
        setattr(obj, attr, timed)

    for ctl in (agent.hlc, agent.llc):
        wrap(ctl, "act", "act")
        wrap(ctl, "update", "update")
    wrap(agent.env, "evaluator", "evaluate")
    return spent, calls


def run_cnn_search(torch, model, params, graph, val, mode_name, n_explore,
                   n_exploit):
    """run_search over a HierarchicalAgent (accuracy-guaranteed reward) on
    the CNN evaluator of ``mode_name``: the main path of B5 (quant) or B6
    (binarize).  Launch counts are reset just before and read just
    after."""
    from repro_torch import kernels
    from repro_torch.core import (HierarchicalAgent, QuantEnv, RewardCfg,
                                  make_cnn_evaluator, run_search)
    from repro_torch.quant.policy import QuantMode
    mode = QuantMode.QUANT if mode_name == "quant" else QuantMode.BINARIZE
    ev = make_cnn_evaluator(model, params, graph, val, mode=mode)
    env = QuantEnv(graph, params, ev, RewardCfg.accuracy_guaranteed(),
                   mode=mode)
    agent = HierarchicalAgent(env, seed=SEED)
    spent, calls = _timed_agent(agent)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = run_search(agent, n_explore=n_explore, n_exploit=n_exploit)
    launches = kernels.launch_counts()
    spent, calls = dict(spent), dict(calls)
    n = len(res.history)
    mine = "fake_quant" if mode_name == "quant" else "binary_matmul"
    other = "binary_matmul" if mode_name == "quant" else "fake_quant"
    problems = []
    if n != n_explore + n_exploit or calls["evaluate"] != n:
        problems.append(f"{n} episodes, {calls['evaluate']} evaluations")
    want = len(graph.layers) * calls["evaluate"]
    if launches[mine] != want or launches[other] != 0:
        problems.append(f"launches {launches}: want {mine} {want} and "
                        f"{other} 0")
    if not all(np.isfinite(h.reward) and np.isfinite(h.acc)
               for h in res.history):
        problems.append("non-finite reward or accuracy")
    # after the counted run: one more episode, then one evaluation of the
    # best policy, under the profiler
    prof_episode = profile_call(torch, lambda: agent.run_episode(noise=0.1))
    prof_eval = profile_call(torch, lambda: ev(res.best_policy),
                             match=("bitplane_gemm", "fold_planes"))
    wall = res.wall_s
    rec = dict(
        mode=mode_name, episodes=n, n_explore=n_explore,
        n_exploit=n_exploit, wall_s=wall, s_per_episode=wall / n,
        split_s=dict(spent, other=wall - sum(spent.values())),
        calls=calls, ms_per_act=1e3 * spent["act"] / max(calls["act"], 1),
        ms_per_update=1e3 * spent["update"] / max(calls["update"], 1),
        ms_per_eval=1e3 * spent["evaluate"] / max(calls["evaluate"], 1),
        evals_per_s=calls["evaluate"] / max(spent["evaluate"], 1e-9),
        best_acc=res.best_log.acc, best_reward=res.best_log.reward,
        best_avg_wbits=res.best_log.avg_wbits,
        best_avg_abits=res.best_log.avg_abits,
        first_reward=res.history[0].reward,
        last_reward=res.history[-1].reward,
        mean_acc_last5=float(np.mean([h.acc for h in res.history[-5:]])),
        launches=launches, launches_per_eval=launches[mine] /
        max(calls["evaluate"], 1), profile_episode=prof_episode,
        profile_eval=prof_eval, problems=problems)
    if mode_name == "binarize":
        rec["im2col"] = im2col_profile(torch, model.cfg)
    emit({"phase": "search-run", **rec})
    return rec


def check_lm_evaluator(torch, cfg, model, params, policy):
    """One make_lm_evaluator call on the full-width params: B5 launches ==
    the graph's layer count; against a plain evaluation
    (apply_policy_to_params, then the forward with plain attention) the
    weights bit for bit, the logits within ACT_LOGIT_ATOL (the policy
    quantizes activations at QBN 8), and the accuracy by the gap rule: a
    token may score differently only where the plain top-2 gap is below
    that tolerance."""
    from repro_torch import backend, kernels
    from repro_torch.core import evaluate, make_lm_evaluator
    from repro_torch.data import TokenStream
    from repro_torch.quant.apply import apply_policy_to_params, get_path
    dev = torch.device("cuda")
    graph = model.graph(seq_len=LM_EVAL_LEN, batch=LM_EVAL_BATCH)
    val = TokenStream(vocab=cfg.vocab).batch(0, LM_EVAL_BATCH, LM_EVAL_LEN)
    vb = {k: backend.upload(np.asarray(v), dev) for k, v in val.items()}
    problems = []
    with torch.no_grad():
        plain = apply_policy_to_params(params, graph, policy)
        wb, _ = evaluate.upload_bits(policy, graph, dev)
        q = evaluate._quantize_params(params, graph, wb, evaluate.QuantMode
                                      .QUANT)
        same = all(torch.equal(get_path(q, l.param_path),
                               get_path(plain, l.param_path))
                   for l in graph.layers)
        got = evaluate.lm_logits(model, q, graph, policy, vb)
        del q
        want = evaluate.lm_logits(model, plain, graph, policy, vb,
                                  attn_impl="ref")
        del plain
        acc_plain = float(evaluate.token_accuracy(want, vb["labels"]))
        d = (got - want).abs()
        top2 = torch.topk(want, 2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        labels = vb["labels"].long()
        flips = (torch.argmax(got, -1) != torch.argmax(want, -1)) & \
            (labels >= 0)
        n_tok = int((labels >= 0).sum())
        n_flips = int(flips.sum())
        flip_gap = float(gap[flips].max()) if n_flips else None
        rec_logits = dict(
            logit_max_abs_diff=float(d.max()),
            logit_mean_abs_diff=float(d.mean()), tol=ACT_LOGIT_ATOL,
            logits_bitwise=bool(torch.equal(got, want)),
            logit_max_abs=float(want.abs().max()),
            min_plain_top2_gap=float(gap.min()),
            argmax_flips=n_flips, max_flip_gap=flip_gap)
        if not bool(torch.isfinite(got).all()) or \
                got.shape != (LM_EVAL_BATCH, LM_EVAL_LEN, cfg.vocab_padded):
            problems.append(f"LM evaluator logits {tuple(got.shape)} or "
                            f"not finite")
        if rec_logits["logit_max_abs_diff"] > ACT_LOGIT_ATOL:
            problems.append(f"LM evaluator logits differ from the plain "
                            f"forward by {rec_logits['logit_max_abs_diff']}")
        if n_flips and flip_gap >= ACT_LOGIT_ATOL:
            problems.append(f"LM evaluator argmax differs where the plain "
                            f"top-2 gap is {flip_gap}")
        del got, want, d, top2, gap
    torch.cuda.empty_cache()
    ev = make_lm_evaluator(model, params, graph, val)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    acc = ev(policy)
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if launches["fake_quant"] != len(graph.layers):
        problems.append(f"B5 launched {launches['fake_quant']} times for "
                        f"{len(graph.layers)} layers")
    if not same or abs(acc - acc_plain) > 100.0 * n_flips / max(n_tok, 1):
        problems.append(f"LM evaluator: weights bitwise {same}, acc {acc} "
                        f"vs plain {acc_plain} with {n_flips} flips")
    rec = dict(arch=cfg.name, tokens=[LM_EVAL_BATCH, LM_EVAL_LEN],
               layers=len(graph.layers), acc=acc, acc_plain=acc_plain,
               weights_bitwise=same, **rec_logits, seconds=seconds,
               launches=launches,
               peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
               problems=problems)
    emit({"phase": "search-lm", **rec})
    torch.cuda.empty_cache()
    return rec


def short_search(torch, model, params, graph, val):
    """DETERMINISM_EPISODES episodes of a QUANT search (HierarchicalAgent
    from SEED, accuracy-guaranteed reward): each episode's policy and
    reward."""
    from repro_torch.core import (HierarchicalAgent, QuantEnv, RewardCfg,
                                  make_cnn_evaluator, run_search)
    from repro_torch.quant.policy import QuantMode
    ev = make_cnn_evaluator(model, params, graph, val, mode=QuantMode.QUANT)
    env = QuantEnv(graph, params, ev, RewardCfg.accuracy_guaranteed(),
                   mode=QuantMode.QUANT)
    agent = HierarchicalAgent(env, seed=SEED)
    policies, episode = [], agent.run_episode

    def recorded(*a, **k):
        log, policy = episode(*a, **k)
        policies.append(policy.copy())
        return log, policy
    agent.run_episode = recorded
    res = run_search(agent, n_explore=DETERMINISM_EPISODES[0],
                     n_exploit=DETERMINISM_EPISODES[1])
    return policies, [h.reward for h in res.history]


def check_determinism(torch, model, data, graph, val):
    """C1: the substrate trained twice from SEED, every leaf bit for bit,
    then a short QUANT search twice on it: the same policies (every
    group's and every activation QBN) and rewards.  Returns the first
    substrate and the training record (seconds of each training)."""
    from repro_torch.core.ddpg import tree_leaves
    runs = [train_substrate(torch, model, model.init(SEED, "cuda"), data)
            for _ in range(2)]
    (params, train), (again, train2) = runs
    leaves = list(zip(tree_leaves(params), tree_leaves(again)))
    differ = sum(not torch.equal(a, b) for a, b in leaves)
    searches = [short_search(torch, model, params, graph, val)
                for _ in range(2)]
    (pols, rewards), (pols2, rewards2) = searches
    same_policy = len(pols) == len(pols2) and all(
        a.weight_bits.keys() == b.weight_bits.keys()
        and all(np.array_equal(a.weight_bits[n], b.weight_bits[n])
                for n in a.weight_bits)
        and a.act_bits == b.act_bits for a, b in zip(pols, pols2))
    rec = dict(leaves=len(leaves), leaves_differing=differ,
               episodes=len(rewards), policies_equal=same_policy,
               rewards_equal=rewards == rewards2, rewards=rewards,
               rewards_repeat=rewards2)
    emit({"phase": "search-determinism", **rec})
    if differ or not same_policy or rewards != rewards2:
        raise AssertionError(f"search: two runs from one seed differ: {rec}")
    return params, dict(train, seconds_repeat=train2["seconds"])


def phase_search(torch, cfg, lm, lm_params, lm_policy):
    """The AutoQ search on CIF10-7CNN at full width, then the LM
    evaluator on the serving phases' gemma2-2b params."""
    from repro_torch import backend
    from repro_torch.data import SyntheticImages
    from repro_torch.models.cnn import CIF10, CNN
    t0 = time.perf_counter()
    model = CNN(CIF10)
    data = SyntheticImages(img_size=CIF10.img_size)
    val = data.batch(99_999, VAL_IMAGES)
    graph = model.graph()
    params, train = check_determinism(torch, model, data, graph, val)
    with torch.no_grad():
        acc_raw = float(model.accuracy(params, {
            k: backend.upload(v, torch.device("cuda"))
            for k, v in val.items()})) * 100.0
    emit({"phase": "search-train", "model": CIF10.name, **train,
          "val_images": VAL_IMAGES, "val_acc": acc_raw,
          "searched_groups": sum(l.n_groups for l in graph.layers)})
    checks = check_evaluators(torch, model, params, graph, val, acc_raw)
    runs = [run_cnn_search(torch, model, params, graph, val, *r)
            for r in SEARCH_RUNS]
    cnn_s = time.perf_counter() - t0
    lm_rec = check_lm_evaluator(torch, cfg, lm, lm_params, lm_policy)
    problems = checks["problems"] + [p for r in runs for p in r["problems"]] \
        + lm_rec["problems"]
    if train["last_loss"] >= train["first_loss"]:
        problems.append(f"substrate loss did not fall: {train}")
    if problems:
        raise AssertionError("search checks failed: " + "; ".join(problems))
    return dict(train=train, val_acc=acc_raw, checks=checks, runs=runs,
                lm=lm_rec, cnn_seconds=cnn_s)


# ------------------------------------------------------------------ main
def summarize(rows, launches):
    """One entry per kernel: sums over its measured shapes.  ``launches``
    maps each kernel to its count on its own path's run."""
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
            library_ms=None if any(r["library_ms"] is None for r in mine)
            else sum(r["library_ms"] for r in mine),
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
    cfg, model, params, policy = init_model(torch)
    rec_a, rec_b, checks = phase_serve(torch, cfg, model, params, policy)
    run = phase_run(torch, cfg, model, params, policy)
    search = phase_search(torch, cfg, model, params, policy)
    launches = dict(rec_a["launches"])
    launches["paged_attention"] = \
        run["runs"]["overlap"]["launches"]["paged_attention"]
    for r in search["runs"]:
        name = "fake_quant" if r["mode"] == "quant" else "binary_matmul"
        launches[name] = r["launches"][name]
    kernels = summarize(rows, launches)
    result = {"card": card, "kernel_rows": rows, "engine_a": rec_a,
              "engine_b": rec_b, "checks": checks, "run": run,
              "search": search, "kernels": kernels,
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
