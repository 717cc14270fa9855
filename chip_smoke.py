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
              bound (CUDA events, L2 flushed before each run, median of 10;
              kernel and library runs take turns), the device time of both,
              and on the GEMM rows the host time of both. K1's prefill rows
              and K4's chunk rows (4 x 512 over fp32 pages, global and
              window, and over int8 pages) run the TF32 tensor-core walk
              (attn_tc, route tc_3xtf32, or tc_3xtf32_split where K4's chunk
              rule splits it) and are also held against the plain statement
              of its arithmetic (attention_tf32x3_ref,
              paged_attention_split_ref with einsum_tf32x3). K1's decode
              rows (the global cache, the local ring, and one query at
              position 40 whose splits are mostly empty) and K4's (4 rows at
              ~4175 positions: global, window, int8 pool; 4 rows at ~40; 36
              rows at one split) run the split-KV walks on CUDA cores
              (fp32_split), also held against their plain statements. Each
              attention row prints its split count. The GEMM rows cover
              generate's shapes and run()'s 2048-row chunk shapes; each
              prints its route (K2 and K3: tc_2xtf32 for M > 8, else skinny,
              one launch that sums its K splits in a cluster) and that
              route's bound beside the function's, must make exactly one
              launch a call, and every tensor-core row must also come within
              TC_ERR_LIMIT of quant_matmul_ref / packed_matmul_ref. Every
              kernel row must give the same bits on a second call. Every
              bound counts the function's operations at the TF32 peak where
              its values are exact in TF32 or the route makes them so
              (GEMMs, attention); `route_bound_ms` is the floor of the route
              taken (2 TF32 passes for the GEMMs on tensor cores, 3 for the
              attention walks on tensor cores, fp32 on CUDA cores for the
              rest).  Rows of the later paths: K1's and K4's decode (and
              K4's chunk) over bf16 K/V, granite-moe's K1 prefill and
              decode and K4 chunk and decode at D 64, G 3; the
              expert-batched K2 / K3 (granite's wg and wd over 40 experts
              at C = 1024, 2 and 4 rows, one launch for all experts, the
              library call torch.bmm on the dequantized stack) and K2 on
              the uniform int8 store's gemma2-2b wq.
3. serve   -- ServeEngine.generate on gemma2-2b at full width, cut to
              GEMMA_LAYERS layers, with a seeded kernel-wise policy: engine A (packed store,
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
              launches, K2's and K3's GEMMs; one device launch per GEMM
              call, a trace that lost kernel records taken again, at
              most TRACE_ATTEMPTS times, as is generate's on engine A).
   cache-store -- gemma2-2b over a bf16 cache and pool (engine A's store
              with cache_dtype=torch.bfloat16): run() against each
              request's generate() by the gap rule, both against the fp32
              twins by the gap rule at BF16_GAP_TOL, the pool's bytes; then
              the uniform int8 store (model.quantize_params_int8): its
              prefill logits against the fp32 engine's (mean |lf - lq| /
              std(lf) < 0.35), K2 on every GEMM (exact launch count, one
              device launch a call) and no K3, run() against generate().
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
   moe     -- granite-moe-3b-a800m at published width and depth (32 layers,
              40 experts top-8, capacity factor 1.25), random fp32
              weights: generate (2 x 2048 + 16) on engine A (packed store,
              kernels) against engine B (fake store, plain versions) by
              check_serve's rules, the expert GEMMs on one batched K2 / K3
              launch per bucket of each site (exact counts), and the pair
              again with activation quantization off at a tight limit;
              run() on 8 requests at capacity factor 1.25 (0 host syncs)
              and at 0 (each stream against its generate, gap rule); one
              profiled generate (device ms by kernel group, busy share)
              and one with the host traced too (device ms inside the MoE
              dispatch and gather profiler ranges); the peak memory.
   ssm     -- mamba2-780m at published width and depth (48 layers, d_model
              1536, 48 heads of 64, d_state 128, chunk 256), random fp32
              weights: its fp32 noise floor (the forwards of the kernels'
              store and of the plain fp32 path against an fp64 evaluation,
              ssm-floor; the kernels no farther from it than the plain
              path); how far engines A and B part with depth, activation
              QBN 8 and off (ssm-drift, reported); generate (2 x 2048 +
              16) on engine A at QBN 8 (no K1 or K4 and exactly one K2 /
              K3 launch per bucket of w_xz, w_bc, w_out and the
              unembedding a model call), and A against B with activation
              quantization off, held at LOGIT_ATOL plus twice the plain
              path's fp64 distance; QBN 8 held on the first
              SSM_GATE_LAYERS layers (A / B at ACT_LOGIT_ATOL, and run()
              on 8 requests against generate); a profiled prefill with
              the host traced (device ms inside the SSD chunk scan's
              profiler ranges, every K2 / K3 launch in the trace) and a
              profiled generate (device ms by kernel group, busy share,
              launches per decode token); run() on 8 requests with
              prefill left to the engine (monolithic; chunked,
              speculative and serve() refused before any model call;
              streams against generate by the gap rule at the act-off
              tolerance; exact launch counts); then the jamba hybrid at
              HYBRID_CUT's reduced width (one 8-layer period, d_model
              2048): its noise floor, A against B with activation
              quantization off (K1 once per attention layer and call,
              exact K2 / K3 counts), and run() on 4 requests the same way
              at QBN 8, with K1, K4 and the expert-batched K2 / K3
              launched.
7. train   -- the paper's pipeline after the search, on its CIF10-7CNN
              substrate: the Trainer (AdamW, 40 steps, checkpoints every
              10) uninterrupted and preempted at step 25, resumed from
              step 20, every parameter and optimizer leaf bit for bit,
              the mean loss of the last 10 steps under the first 10's
              (train-trainer); 3 + 2 QUANT episodes under the roofline
              reward on H100Roofline at the card's power limit, each
              reward recomputed on the host, and the H100 and TPU models'
              latency and energy of the best and uniform policies
              (train-roofline); qat_finetune of the QUANT search's best
              policy (30 steps, batch 128): accuracy after >= before - 2,
              B5 exactly 8 launches a step and B6 none, one step's
              straight-through gradients bit for bit the plain
              statement's, a profiled step with B5's device ms apart
              (train-qat); 2 training steps (LM.loss at 1 x 512 tokens,
              remat=True, 8-bit AdamW) of full-width gemma2-2b and of
              granite-moe-3b-a800m at published width and depth, each
              run twice from one seed, losses, the last gradients and
              every leaf bit for bit, the remat=False loss equal, peak
              memory; for granite-moe first C2's probe, two gradients with
              the row gathers' plain CUDA backward, its differing leaves
              reported, not checked (train-lm).

The line before the last lists every kernel with its launches on its path
(K1-K3: gemma2-2b's generate; K4: its run; B5: the QUANT search plus QAT;
B6: the BINARIZE search), ``launches_by_path`` for the kernels that more
than one path runs (K1-K4: the generate and run of each serving phase,
granite-moe's, mamba2-780m's and jamba's included; B5: search, QAT) and
its times; the last line is
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
# (attn_tc's K/V source and gemm_tc's weight source name their launches;
# paged_combine merges the splits of both K4 walks)
KERNEL_GROUPS = {
    "k1_tc": ("DenseSlots",),
    "k1_split": ("flash_split", "split_combine"),
    "k4_chunk": ("PagedSlots",),
    "k4_decode": ("paged_split",),
    "k4_merge": ("paged_combine",),
    "k2_tc": ("Int8Stage",),
    "k2_skinny": ("gemm_stream<8,",),
    "k3_tc": ("PackedStage",),
    "k3_skinny": ("gemm_stream<4,", "gemm_stream<2,"),
}
GEMM_GROUPS = {"quant_matmul": ("k2_tc", "k2_skinny"),
               "packed_matmul": ("k3_tc", "k3_skinny")}
# profiled runs traced again when their trace lost GEMM launch records
TRACE_ATTEMPTS = 3

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_attention.py:25
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_packed.py:68-69
# K2's and K3's tensor-core rows (outputs ~0.5): a sound two-pass kernel
# ends within ~1.4e-5 of quant_matmul_ref / packed_matmul_ref at K = 9216,
# one that chains every MMA into the truncating accumulator ~1.7e-4 (still
# inside GEMM_TOL by its rtol)
TC_ERR_LIMIT = 5e-5
# Engines A and B differ in summation order only (fp32 throughout), but
# many layers deep on random weights a 1e-6 relative difference per GEMM
# grows;
# 2e-3 on logits capped at +-30 still separates any real fault (a wrong
# bucket or mask moves logits by O(1)).  This holds with activation
# quantization off.
LOGIT_ATOL = 2e-3
# With activation QBN 8 every block rounds each token's activations to 255
# levels; a 1-ulp difference that crosses a rounding boundary moves that
# element by a whole step (amax / 127), and such flips compound over the
# layers: on an H100 this pair measured 0.072 on the prefill logits, and
# 2.2e-5 with activation quantization off (gemma2-2b at its 26 layers).
ACT_LOGIT_ATOL = 0.25

ARCH = "gemma2-2b"
# gemma2-2b at published width, its depth cut from 26 layers to 12 (6
# local / global pairs) in every phase that serves or trains it, so that
# the whole script stays near 250 s with the granite-moe phase added
GEMMA_LAYERS = 12
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

# phase train: the Trainer (40 steps from a fresh init, checkpoints every
# 10, preempted at 25), a 3 + 2 episode search under the roofline reward,
# QAT of the best QUANT policy (tests/test_system.py:68's 30 steps at
# batch 128) and 2 gemma2-2b training steps at 1 x 512 tokens, twice.
# The Trainer's AdamW (b2 0.95) runs at lr 5e-4: at 2e-3 this CNN's loss
# leaps in the first steps and then sits near chance in both packages, so
# a falling loss would be luck
TRAINER_STEPS, TRAINER_CKPT, TRAINER_PREEMPT = 40, 10, 25
TRAINER_LR, TRAINER_WINDOW = 5e-4, 10
ROOFLINE_EPISODES = (3, 2)
QAT_STEPS, QAT_BATCH, QAT_DATA = 30, 128, 1000
LM_TRAIN_STEPS, LM_TRAIN_LEN = 2, 512

# phase moe: granite-moe-3b-a800m at published width and depth (32 layers,
# d_model 1536, 24 q / 8 kv heads of 64, 40 experts top-8 of d_ff 512,
# capacity factor 1.25): generate at 2 x 2048 + 16, run on 8 requests
MOE_ARCH = "granite-moe-3b-a800m"
MOE_PROMPT, MOE_MAX_LEN = 2048, 2112
MOE_RUN_PROMPTS = (2048, 1536, 1024, 515, 260, 97, 33, 17)
MOE_RUN_NEW = (16, 12, 16, 8, 16, 12, 16, 10)
MOE_E, MOE_FF = 40, 512
# int8 weights track fp: mean |lf - lq| / std(lf) (tests/
# test_quant_serving.py:29-32)
INT8_REL_LIMIT = 0.35
# A bf16 cache rounds every K and V to 8 mantissa bits (2^-9 relative);
# layers deep, with activation QBN 8 turning small differences into
# whole rounding steps, the logits (softcapped at 30) of the bf16 and fp32
# engines may differ by O(0.1-1): their streams are held to each other by
# the gap rule at this tolerance
BF16_GAP_TOL = 1.0
# granite-moe's A / B pair (packed store on the kernels against the fake
# store on the plain versions, activation QBN 8): besides the act-quant
# rounding flips of the dense pair, a flip can move a token to another
# expert (top-8 of 40), which moves that token's FFN output by O(1/8)
MOE_LOGIT_ATOL = 0.25
# the same pair with activation quantization off differs in summation
# order only, as the dense pair at LOGIT_ATOL does: on an H100 it measured
# 3.0e-5 on the prefill logits (a wrong bucket, expert or gate moves them
# by O(0.1-1))
MOE_ACT_OFF_ATOL = LOGIT_ATOL

# phase ssm: mamba2-780m at published width and depth (48 layers, d_model
# 1536, d_inner 3072, 48 heads of 64, d_state 128, d_conv 4, chunk 256,
# vocab 50280 padded to 50304): generate at 2 x 2048 + 16, run on 8
# requests; then the jamba hybrid at a reduced width (HYBRID_CUT)
SSM_ARCH, HYBRID_ARCH = "mamba2-780m", "jamba-1.5-large-398b"
SSM_PROMPT, SSM_MAX_LEN = 2048, 2112
# jamba-1.5-large-398b does not fit one card at published width (one MoE
# layer's 16 experts are 16 x 3 x 8192 x 24576 fp32 weights, ~39 GB): one
# pattern period (8 of 72 layers: 7 mamba + 1 attention, MoE on the odd
# positions), d_model 8192 -> 2048, 64 q / 8 kv heads -> 16 / 2 (head dim
# 128 kept), dense and expert d_ff 24576 -> 4096; 16 experts top-2 at
# capacity factor 1.25, the SSM block (d_state 128, d_conv 4, expand 2,
# heads of 64, chunk 256) and vocab 65536 as published: ~2.2 B
# parameters, ~9 GB in fp32
HYBRID_CUT = dict(n_layers=8, d_model=2048, n_heads=16, n_kv_heads=2,
                  d_ff=4096)
HYBRID_EXPERT_D_FF = 4096
HYBRID_E, HYBRID_TOP_K = 16, 2       # as published
HYBRID_RUN_PROMPTS = (1024, 515, 97, 17)
HYBRID_RUN_NEW = (8, 12, 16, 10)
# mamba2-780m's A / B pair with the policy's activation QBN 8 is held on
# its first SSM_GATE_LAYERS layers (the same weights): deeper, the two
# engines part chaotically (each rounding flip moves a whole step, and the
# recurrent state carries it to every later position), which
# SSM_DRIFT_DEPTHS measures on the full forward at these depths
SSM_GATE_LAYERS = 2
SSM_DRIFT_DEPTHS = (1, 2, 4, 8, 16, 32, 48)

# phase run: 8 requests over 4 slots, so later requests reuse freed pages
RUN_PROMPTS = (4160, 3100, 2050, 1030, 515, 260, 97, 33)
RUN_NEW = (16, 12, 16, 8, 16, 12, 16, 10)
RUN_SLOTS, PAGE, CHUNK = 4, 16, 512
SPEC_K = 4                          # draft tokens a lane, run()'s default
# first verify positions of the 4 lanes of a verify-only step (K4's verify
# and draft rows, the step cost), near the end of MAX_LEN like the run's
SPEC_STARTS = (4175, 4170, 4160, 4100)
STEP_REPS = 3
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


def traced_gemm_launches(trace, what):
    """``trace()`` -> a profile with ``groups``, taken until K2's and K3's
    device launches in it equal their wrappers' counts of the same run:
    one launch per call.  A CUPTI trace can drop kernel records (plain
    PyTorch kernels' as well as ours, a few in a run of tens of
    thousands) but never adds one, so more device launches than calls
    fail at once and fewer trace the run again, TRACE_ATTEMPTS times at
    most.  Returns the last profile, with ``gemm_launches`` (the pairs)
    and ``trace_shortfalls`` (the launches each earlier trace missed),
    and the problems found."""
    from repro_torch import kernels
    shortfalls = []
    for _ in range(TRACE_ATTEMPTS):
        kernels.reset_launch_counts()
        prof = trace()
        launches = kernels.launch_counts()
        pairs = {name: dict(calls=launches[name],
                            device_launches=sum(prof["groups"][g]["calls"]
                                                for g in grps))
                 for name, grps in GEMM_GROUPS.items()}
        prof["gemm_launches"], prof["trace_shortfalls"] = pairs, shortfalls
        over = [f"{what}: {n} made {p['device_launches']} device launches "
                f"for {p['calls']} calls" for n, p in pairs.items()
                if p["device_launches"] > p["calls"]]
        if over:
            return prof, over
        short = sum(p["calls"] - p["device_launches"]
                    for p in pairs.values())
        if not short:
            return prof, []
        shortfalls.append(short)
    return prof, [f"{what}: each of {TRACE_ATTEMPTS} traces missed GEMM "
                  f"launches ({shortfalls}); last {pairs}"]


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
        A pair of traces in which either saw no device activity (a trace
        can come back empty) is taken again, TRACE_ATTEMPTS times at
        most; None if every pair did."""
        for _ in range(TRACE_ATTEMPTS):
            flush_us = self._profiled_us(None)
            total_us = self._profiled_us(fn)
            if flush_us > 0 and total_us > 0:
                return (total_us - flush_us) / self.reps / 1e3
        return None

    def launches(self, fn) -> int:
        """Device launches (kernels with device time) of one ``fn()``.  A
        trace that shows none is taken again (TRACE_ATTEMPTS times at
        most): it can drop a kernel record but never adds one."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(TRACE_ATTEMPTS):
            self.torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                self.torch.cuda.synchronize()
            n = sum(e.count for e in prof.key_averages()
                    if getattr(e, "device_time_total", 0.0) > 0)
            if n:
                return n
        return n

    def _event(self, fn) -> float:
        torch = self.torch
        self.flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def __call__(self, fn) -> float:
        for _ in range(self.warm):
            fn()
        return float(np.median([self._event(fn) for _ in range(self.reps)]))

    def pair(self, fn, lib):
        """Event ms (medians) of ``fn`` and ``lib``, their runs taking
        turns, so that drift on the shared host falls on both alike."""
        for _ in range(self.warm):
            fn()
            lib()
        a, b = [], []
        for _ in range(self.reps):
            a.append(self._event(fn))
            b.append(self._event(lib))
        return float(np.median(a)), float(np.median(b))

    def host(self, fn) -> float:
        """Host ms of one call: ``reps`` calls back to back (none waits
        for the device) from an idle device, over ``reps``."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(self.reps):
            fn()
        t = time.perf_counter() - t0
        self.torch.cuda.synchronize()
        return t / self.reps * 1e3


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
    """(label, q, k, v, q_pos, kv_pos, window, chunk, cap) at the serving
    paths' shapes: gemma2-2b's prefill of 2 x 4160 tokens (global and local
    layers), the last decode step against the global cache and the local
    ring, in fp32 and in a bf16 cache, and an early decode step (position
    40) against the global cache; granite-moe's prefill of 2 x 2048 (D 64,
    G 3, no softcap) and its last decode step of generate; the jamba
    hybrid's the same (16 q / 2 kv heads of 128 at HYBRID_CUT: G 8, no
    softcap)."""
    cfg_h, cfg_kv, D, cap = 8, 4, 256, 50.0
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")

    ar = torch.arange(PROMPT, dtype=torch.int32, device="cuda").repeat(B, 1)
    q = randn(B, PROMPT, cfg_h, D)
    k, v = randn(B, PROMPT, cfg_kv, D), randn(B, PROMPT, cfg_kv, D)
    yield "prefill_global", q, k, v, ar, ar, None, 1024, cap
    yield "prefill_window4096", q, k, v, ar, ar, 4096, 1024, cap
    last = PROMPT + N_NEW - 1                     # position of the last token
    qd = randn(B, 1, cfg_h, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, MAX_LEN, cfg_kv, D), randn(B, MAX_LEN, cfg_kv, D)
    kp = torch.full((B, MAX_LEN), 2**31 - 1, dtype=torch.int32, device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "decode_global", qd, kc, vc, qp, kp, None, MAX_LEN, cap
    W = 4096                                      # local layers' ring buffer
    ring = torch.arange(last + 1 - W, last + 1, dtype=torch.int32,
                        device="cuda")
    kr = torch.empty((B, W), dtype=torch.int32, device="cuda")
    kr[:, (ring % W).long()] = ring
    yield "decode_ring4096", qd, kc[:, :W].contiguous(), \
        vc[:, :W].contiguous(), qp, kr, W, W, cap
    # a bf16 cache (ServeEngine(cache_dtype=torch.bfloat16))
    kb, vb = kc.bfloat16(), vc.bfloat16()
    yield "decode_global_bf16", qd, kb, vb, qp, kp, None, MAX_LEN, cap
    yield "decode_ring4096_bf16", qd, kb[:, :W].contiguous(), \
        vb[:, :W].contiguous(), qp, kr, W, W, cap
    del kb, vb
    # one query at position 40 over the whole cache: most splits are empty
    qs = torch.full((B, 1), 40, dtype=torch.int32, device="cuda")
    ks = torch.full((B, MAX_LEN), SENT, dtype=torch.int32, device="cuda")
    ks[:, :41] = torch.arange(41, dtype=torch.int32, device="cuda")
    yield "decode_short", qd, kc, vc, qs, ks, None, MAX_LEN, cap
    del q, k, v, kc, vc
    # granite-moe-3b-a800m: 24 q / 8 kv heads of 64, no softcap
    Hq, Hkv, D = 24, 8, 64
    ar = torch.arange(MOE_PROMPT, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    q = randn(B, MOE_PROMPT, Hq, D)
    k, v = randn(B, MOE_PROMPT, Hkv, D), randn(B, MOE_PROMPT, Hkv, D)
    yield "moe_prefill", q, k, v, ar, ar, None, 1024, None
    last = MOE_PROMPT + N_NEW - 1
    qd = randn(B, 1, Hq, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, MOE_MAX_LEN, Hkv, D), randn(B, MOE_MAX_LEN, Hkv, D)
    kp = torch.full((B, MOE_MAX_LEN), SENT, dtype=torch.int32,
                    device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "moe_decode", qd, kc, vc, qp, kp, None, MOE_MAX_LEN, None
    del q, k, v, kc, vc
    # the jamba hybrid at HYBRID_CUT
    Hq, Hkv = HYBRID_CUT["n_heads"], HYBRID_CUT["n_kv_heads"]
    D = HYBRID_CUT["d_model"] // Hq
    ar = torch.arange(SSM_PROMPT, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    q = randn(B, SSM_PROMPT, Hq, D)
    k, v = randn(B, SSM_PROMPT, Hkv, D), randn(B, SSM_PROMPT, Hkv, D)
    yield "hybrid_prefill", q, k, v, ar, ar, None, 1024, None
    last = SSM_PROMPT + N_NEW - 1
    qd = randn(B, 1, Hq, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, SSM_MAX_LEN, Hkv, D), randn(B, SSM_MAX_LEN, Hkv, D)
    kp = torch.full((B, SSM_MAX_LEN), SENT, dtype=torch.int32,
                    device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "hybrid_decode", qd, kc, vc, qp, kp, None, SSM_MAX_LEN, None


def _attn_library(torch, q, k, v, q_pos, kv_pos, window):
    """F.scaled_dot_product_attention with the position mask and GQA
    expanded beforehand (SDPA has no softcap: it is timed without it; a
    bf16 K/V is upcast beforehand, outside the timed call)."""
    import torch.nn.functional as F
    k, v = k.float(), v.float()
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qp, kp = q_pos[:, None, :, None].long(), kv_pos[:, None, None, :].long()
    mask = (kp != 2**31 - 1) & (kp <= qp)
    if window is not None:
        mask &= kp > qp - window
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def _paged_pool(torch, g, rows, k, kv_bits=None, dtype=None, Hkv=4, G=2,
                D=256, max_len=MAX_LEN):
    """A pool of PAGE-slot pages (gemma2-2b's Hkv 4, G 2, D 256 unless
    given) in shuffled order and one q tile of ``k`` columns per row.
    rows: per row (L, c0, c): the row holds positions 0..L-1 and its real
    columns are positions c0..c0+c-1 (the chunk or token just written);
    L == 0 is an idle lane (all-trash table, all-sentinel tile).  Pages are
    fp32, ``dtype`` (bf16), or int8 with ``kv_bits=8``.  Returns (q, k, v,
    pos, bt, q_pos, k_s, v_s)."""
    nb = max_len // PAGE
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
    if dtype is not None:
        return q, kf.to(dtype), vf.to(dtype), pos, bt, qp, None, None
    if kv_bits != 8:
        return q, kf, vf, pos, bt, qp, None, None
    from repro_torch.models.transformer import _kv_quant
    (kq, ks), (vq, vs) = _kv_quant(kf), _kv_quant(vf)
    return q, kq, vq, pos, bt, qp, ks, vs


def _paged_cases(torch):
    """(label, rows, k, window, kv_bits, pool) at the run phases' shapes
    (``pool``: _paged_pool's other arguments and the row's softcap, which
    is gemma2-2b's 50 unless given): 512-token
    chunks (a late chunk of a 4160-token prompt, a first chunk, a partial
    chunk, an idle lane) over fp32 and int8 pages, decode tokens at ~4175
    positions, decode tokens at ~40 (most splits empty), a decode step
    of 36 slots at 1000-4150 positions, whose 144 blocks fill the card
    unsplit (the decode walk at one split), and speculative decode's two
    new shapes: a verify-only step (4 lanes x 5 columns at ~4175 in a
    512-wide tile, the tensor-core walk) and the draft's 2-column call
    over an int8 pool (the decode walk); then a chunk and decode tokens
    over a bf16 pool, and granite-moe's chunk and decode tokens (D 64,
    G 3, no softcap; its run's prompts are at most 2048 tokens), and the
    jamba hybrid's last decode step of its 4-request run (D 128, G 8, no
    softcap)."""
    chunk = [(4160, 3648, 512), (512, 0, 512), (1254, 1024, 230), (0, 0, 0)]
    dec = [(4176, 4175, 1), (4171, 4170, 1), (4161, 4160, 1),
           (4101, 4100, 1)]
    short = [(41, 40, 1), (44, 43, 1), (39, 38, 1), (37, 36, 1)]
    yield "chunk_global", chunk, CHUNK, None, None, {}
    yield "chunk_window4096", chunk, CHUNK, 4096, None, {}
    yield "chunk_int8", chunk, CHUNK, None, 8, {}
    yield "decode_global", dec, 1, None, None, {}
    yield "decode_window4096", dec, 1, 4096, None, {}
    yield "decode_int8", dec, 1, None, 8, {}
    yield "decode_short", short, 1, None, None, {}
    wide = [(1000 + 90 * i, 999 + 90 * i, 1) for i in range(36)]
    yield "decode_wide", wide, 1, None, None, {}
    # speculative decode: a verify-only step (SPEC_K + 1 real columns a
    # lane in the CHUNK-wide tile) and the low-bit draft's catch-up call
    # (2 columns a lane) over its int8 pool
    c = SPEC_K + 1
    verify = [(s0 + c, s0, c) for s0 in SPEC_STARTS]
    yield "verify_4x5", verify, CHUNK, None, None, {}
    draft = [(s0 + 2, s0, 2) for s0 in SPEC_STARTS]
    yield "draft_4x2_int8", draft, 2, None, 8, {}
    bf = dict(dtype=torch.bfloat16)
    yield "chunk_bf16", chunk, CHUNK, None, None, bf
    yield "decode_bf16", dec, 1, None, None, bf
    moe = dict(Hkv=8, G=3, D=64, max_len=MOE_MAX_LEN, cap=None)
    mchunk = [(2048, 1536, 512), (512, 0, 512), (1254, 1024, 230),
              (0, 0, 0)]
    mdec = [(2064, 2063, 1), (1548, 1547, 1), (1040, 1039, 1),
            (530, 529, 1)]
    yield "moe_chunk", mchunk, CHUNK, None, None, moe
    yield "moe_decode", mdec, 1, None, None, moe
    Hkv = HYBRID_CUT["n_kv_heads"]
    hybrid = dict(Hkv=Hkv, G=HYBRID_CUT["n_heads"] // Hkv,
                  D=HYBRID_CUT["d_model"] // HYBRID_CUT["n_heads"],
                  max_len=SSM_MAX_LEN, cap=None)
    hdec = [(n + k, n + k - 1, 1)
            for n, k in zip(HYBRID_RUN_PROMPTS, HYBRID_RUN_NEW)]
    yield "hybrid_decode", hdec, 1, None, None, hybrid


def paged_rows(torch, timer, cap):
    """K4 against paged_attention_ref on the real (non-sentinel) columns
    and against the plain statement of the walk it takes (the decode
    walk's paged_attention_split_ref, or the tensor-core walk's, with
    einsum_tf32x3); the idle lane must come back as exact zeros, and a
    second call must give the same bits."""
    from repro_torch.kernels import attention
    from repro_torch.kernels.ref import (einsum_tf32x3,
                                         paged_attention_split_ref)
    from repro_torch.models.layers import paged_attention_ref, paged_gather
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    gemma_cap = cap
    for label, spec, k, window, kv_bits, pool in _paged_cases(torch):
        pool = dict(pool)
        cap = pool.pop("cap", gemma_cap)
        q, kp, vp, pos, bt, qp, ks, vs = _paged_pool(torch, g, spec, k,
                                                     kv_bits, **pool)
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
        shape = (q.shape[0], k, q.shape[2], kp.shape[2], bt.shape[1] * PAGE,
                 n_sm)
        walk, ns = attention.paged_walk(*shape)
        if walk == "decode":
            route, mm = "fp32_split", torch.einsum
        else:
            route = "tc_3xtf32_split" if ns > 1 else "tc_3xtf32"
            mm = einsum_tf32x3
        route_err, _ = compare(
            torch, pick(got), pick(paged_attention_split_ref(
                *args, **kw, n_splits=ns, mm=mm)), ATTN_TOL,
            f"paged/{label}/{route}")
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
        # fp32 accuracy); its route's beside it: 3 TF32 passes (attn_tc),
        # or fp32 FMAs on CUDA cores (the decode walk)
        b_ms, b_by = bound_ms(nbytes, 4 * D * pairs, TF32_FLOP_PER_S)
        r_ms = bound_ms(nbytes, 4 * D * pairs)[0] if route == "fp32_split" \
            else bound_ms(nbytes, 3 * 4 * D * pairs, TF32_FLOP_PER_S)[0]
        kg, vg = paged_gather(kp, bt), paged_gather(vp, bt)
        if ks is not None:
            kg = kg.float() * paged_gather(ks, bt)[..., None]
            vg = vg.float() * paged_gather(vs, bt)[..., None]
        lib = _attn_library(torch, q, kg, vg, qp, kvp, window)
        ms, lib_ms = timer.pair(kern, lib)
        rows.append(dict(
            name="paged_attention", case=label,
            shape=list(q.shape) + [bt.shape[1] * PAGE],
            kv_dtype=str(kp.dtype).replace("torch.", ""), splits=ns,
            route=route, route_bound_ms=r_ms,
            route_ref_max_abs_err=route_err, max_abs_err=err,
            max_rel_err=rel, tol=ATTN_TOL, ms=ms,
            plain_ms=timer(plain), library_ms=lib_ms,
            library_device_ms=timer.device(lib),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by,
            pages_walked=n_pages))
        emit({"phase": "kernel", **rows[-1]})
        del got, again, want, kg, vg, kp, vp, lib
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


def flash_rows(torch, timer):
    """K1 against attention_ref and against the plain statement of its
    route (the tensor-core walk's attention_tf32x3_ref, or the split walk's
    attention_split_ref), the same bits on a second call."""
    from repro_torch.kernels import attention
    from repro_torch.kernels.ref import (attention_split_ref,
                                         attention_tf32x3_ref)
    from repro_torch.models.layers import attention_ref
    rows = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, q, k, v, qp, kp, window, chunk, cap in _attn_cases(torch):
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
        nbytes = 8 * q.numel() + 4 * (qp.numel() + kp.numel()) + \
            2 * slots * k.shape[2] * k.shape[3] * k.element_size()
        # the function's operations at the TF32 peak; its route's beside
        # it: 3 TF32 passes (flash_tc), or fp32 FMAs on CUDA cores (split)
        flops = 4 * q.shape[3] * pairs
        b_ms, b_by = bound_ms(nbytes, flops, TF32_FLOP_PER_S)
        r_ms = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)[0] \
            if route == "tc_3xtf32" else bound_ms(nbytes, flops)[0]
        lib = _attn_library(torch, q, k, v, qp, kp, window)
        ms, lib_ms = timer.pair(kern, lib)
        rows.append(dict(
            name="flash_attention", case=label, shape=list(q.shape) +
            [k.shape[1]], kv_dtype=str(k.dtype).replace("torch.", ""),
            splits=ns, route=route, route_bound_ms=r_ms,
            route_ref_max_abs_err=route_err,
            max_abs_err=err, max_rel_err=rel, tol=ATTN_TOL,
            ms=ms, plain_ms=timer(plain), library_ms=lib_ms,
            library_device_ms=timer.device(lib),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del got, again, lib
    return rows


def phase_kernels(torch, timer):
    from repro_torch.kernels import ops, pack, quant_matmul
    from repro_torch.kernels.ref import packed_matmul_ref, quant_matmul_ref
    cap = 50.0
    rows = search_kernel_rows(torch, timer) + paged_rows(torch, timer, cap) \
        + flash_rows(torch, timer)
    gemm_shapes = [("wg_decode", 2, 2304, 9216), ("wg_prefill", 8320, 2304,
                                                   9216),
                   ("wd_decode", 2, 9216, 2304),
                   ("unembed_decode", 2, 2304, 256000),
                   ("wg_chunk", 2048, 2304, 9216),
                   ("wd_chunk", 2048, 9216, 2304),
                   ("wg_draft", 8, 2304, 9216),
                   ("wd_draft", 8, 9216, 2304),
                   ("ragged", 37, 1001, 333),
                   # mamba2-780m (phase ssm): prefill at 2 x 2048, decode
                   ("mamba_wxz_prefill", 4096, 1536, 6144),
                   ("mamba_wxz_decode", 2, 1536, 6144),
                   ("mamba_wout_prefill", 4096, 3072, 1536),
                   ("mamba_wout_decode", 2, 3072, 1536),
                   ("mamba_wbc_prefill", 4096, 1536, 256),
                   ("mamba_unembed_decode", 2, 1536, 50304),
                   # the jamba hybrid at HYBRID_CUT (d_model 2048, d_inner
                   # 4096): its A / B prefill at 2 x 2048, decode
                   ("hybrid_wxz_prefill", 4096, 2048, 8192),
                   ("hybrid_wxz_decode", 2, 2048, 8192),
                   ("hybrid_wout_prefill", 4096, 4096, 2048),
                   ("hybrid_wout_decode", 2, 4096, 2048),
                   ("hybrid_wbc_prefill", 4096, 2048, 256),
                   ("hybrid_unembed_decode", 2, 2048, 65536)]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
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
            again = kern()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}/int{bits}/{label}: two calls on "
                                     "the same inputs give different bits")
            err, rel = compare(torch, got, plain(), GEMM_TOL,
                               f"{name}/int{bits}/{label}")
            n_launch = timer.launches(kern)
            if n_launch != 1:
                raise AssertionError(f"{name}/int{bits}/{label}: {n_launch} "
                                     "device launches a call, want 1")
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
            lib = lambda: torch.matmul(x, wdeq)
            ms, lib_ms = timer.pair(kern, lib)
            rows.append(dict(
                name=name, case=f"int{bits}_{label}", shape=[M, K, N],
                route=route, route_bound_ms=r_ms, max_abs_err=err,
                max_rel_err=rel, tol=GEMM_TOL, launches_per_call=n_launch,
                splits=quant_matmul.skinny_splits(w.shape[0], N, n_sm)
                if route == "skinny" else None,
                ms=ms, plain_ms=timer(plain), library_ms=lib_ms,
                library_device_ms=timer.device(lib),
                device_ms=timer.device(kern), host_ms=timer.host(kern),
                library_host_ms=timer.host(lib), bound_ms=b_ms,
                bound_by=b_by))
            emit({"phase": "kernel", **rows[-1]})
            del x, qv, w, wdeq, got, again
    torch.cuda.empty_cache()
    return rows + expert_gemm_rows(torch, timer)


def expert_gemm_rows(torch, timer):
    """K2 and K3 on expert stacks, one launch for all E experts: granite-
    moe's wg (E 40, C x 1536 x 512) and wd (C x 512 x 1536) at C = 1024
    (generate's prefill at capacity factor 1.25: the tensor-core route)
    and at C = 2 and 4 (decode, and run()'s 4-slot decode: skinny), int8,
    int4 and int2; the jamba hybrid's the same way at HYBRID_CUT (E 16,
    C x 2048 x 4096 and C x 4096 x 2048; C = 640 at its A / B prefill of
    2 x 2048 tokens, 2 and 4 in decode); then K2 on the uniform int8
    store's gemma2-2b wq
    (2304 x 2048) at generate's M = 8320 and 2.  Each against its plain
    version (GEMM_TOL, TC_ERR_LIMIT on the tensor-core route), the same
    bits twice, one device launch a call; the library call is torch.bmm
    (torch.matmul for the 2-d rows) on the dequantized fp32 weight."""
    from repro_torch.kernels import ops, pack, quant_matmul
    from repro_torch.kernels.ref import packed_matmul_ref, quant_matmul_ref
    from repro_torch.models.layers import moe_capacity
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    d_h, ff_h = HYBRID_CUT["d_model"], HYBRID_EXPERT_D_FF
    c_h = moe_capacity(B * SSM_PROMPT, HYBRID_E, HYBRID_TOP_K, 1.25)
    cases = [(bits, f"{tag}_{site}_c{C}", E, C, K, N)
             for tag, E, Cs, d, ff in (("moe", MOE_E, (1024, 2, 4), 1536,
                                        MOE_FF),
                                       ("hybrid", HYBRID_E, (c_h, 2, 4),
                                        d_h, ff_h))
             for bits in (8, 4, 2) for C in Cs
             for site, K, N in (("wg", d, ff), ("wd", ff, d))]
    cases += [(8, "int8_store_wq_prefill", None, B * PROMPT, 2304, 2048),
              (8, "int8_store_wq_decode", None, B, 2304, 2048)]
    rows = []
    for bits, label, E, M, K, N in cases:
        lv = 2 ** (bits - 1) - 1
        lead = (E,) if E else ()
        x = torch.randn(lead + (M, K), generator=g, device="cuda")
        qv = torch.randint(-lv, lv + 1, lead + (K, N), generator=g,
                           device="cuda", dtype=torch.int8)
        s = (torch.rand(lead + (N,), generator=g, device="cuda") + 0.5) / \
            (lv * math.sqrt(K))
        name = "quant_matmul" if bits == 8 else "packed_matmul"
        if bits == 8:
            w = qv
            kern = lambda: ops.quant_matmul(x, w, s)
            plain = lambda: quant_matmul_ref(x, w, s)
        else:
            w = pack.pack_sub8(qv, bits, axis=-2)
            kern = lambda: ops.packed_matmul(x, w, s, store_bits=bits)
            plain = lambda: packed_matmul_ref(x, w, s, bits)
        what = f"{name}/int{bits}/{label}"
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls on the same inputs "
                                 "give different bits")
        err, rel = compare(torch, got, plain(), GEMM_TOL, what)
        n_launch = timer.launches(kern)
        if n_launch != 1:
            raise AssertionError(f"{what}: {n_launch} device launches a "
                                 "call, want 1")
        route = quant_matmul.route(M, bits)
        if route == "tc_2xtf32" and err > TC_ERR_LIMIT:
            raise AssertionError(f"{what}: max abs err {err} over "
                                 f"{TC_ERR_LIMIT}")
        n_e = E or 1
        wdeq = qv.float() * s[..., None, :]
        nbytes = 4 * n_e * (M * K + N + M * N) + w.numel()
        flops = 2.0 * n_e * M * K * N
        b_ms, b_by = bound_ms(nbytes, flops, TF32_FLOP_PER_S)
        r_ms = bound_ms(nbytes, 2 * flops, TF32_FLOP_PER_S)[0] \
            if route == "tc_2xtf32" else bound_ms(nbytes, flops)[0]
        lib = (lambda: torch.bmm(x, wdeq)) if E else \
            (lambda: torch.matmul(x, wdeq))
        ms, lib_ms = timer.pair(kern, lib)
        rows.append(dict(
            name=name, case=f"int{bits}_{label}",
            shape=([E] if E else []) + [M, K, N], route=route,
            route_bound_ms=r_ms, max_abs_err=err, max_rel_err=rel,
            tol=GEMM_TOL, launches_per_call=n_launch,
            splits=quant_matmul.skinny_splits(w.shape[-2], N, n_sm, n_e)
            if route == "skinny" else None,
            ms=ms, plain_ms=timer(plain), library_ms=lib_ms,
            library_device_ms=timer.device(lib),
            device_ms=timer.device(kern), host_ms=timer.host(kern),
            library_host_ms=timer.host(lib), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del x, qv, w, wdeq, got, again
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
               n_new=N_NEW, profile=False, cache_dtype=None):
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, policy=policy, max_len=max_len,
                      weight_store=store, attn_impl=impl,
                      serve_act_bits=serve_act_bits,
                      cache_dtype=cache_dtype or torch.float32,
                      device=device)
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
        prof, problems = traced_gemm_launches(
            lambda: profile_call(torch, lambda: eng.generate(tokens, n_new)),
            f"generate {label}")
        rec["profile"] = prof
        emit({"phase": "profile", "engine": label, **prof})
        if problems:
            raise AssertionError("; ".join(problems))
    del eng, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return result


def device_rows(prof):
    """(kernel name, device ms, launches) of every device activity in a
    finished torch.profiler trace, largest first: what key_averages()
    gives for a CUDA-only trace (user annotations and async events left
    out), summed from the trace's raw events.  key_averages() first builds
    a FunctionEvent per event, which takes over a minute for the ~10^5
    kernels of a profiled speculative run(); the raw sum takes a second."""
    from torch.autograd import DeviceType
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_async() or \
                e.is_user_annotation():
            continue
        ms, n = acc.get(e.name(), (0.0, 0))
        acc[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in acc.items()),
                  key=lambda r: -r[1])


def range_rows(prof, names):
    """Device ms and launches of the kernels that ran inside each profiler
    range of ``names`` (``torch.profiler.record_function``), with the
    number of ranges traced.  The trace marks a range on the device as
    the span from its first kernel's start to its last kernel's end; on
    one stream the kernels that start inside such a span are exactly the
    range's own."""
    import bisect
    from torch.autograd import DeviceType
    spans, kern = {n: [] for n in names}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_async():
            continue
        if e.is_user_annotation():
            if e.name() in spans:
                spans[e.name()].append((e.start_ns(),
                                        e.start_ns() + e.duration_ns()))
        else:
            kern.append((e.start_ns(), e.duration_ns()))
    kern.sort()
    starts = [k[0] for k in kern]
    out = {}
    for n, sp in spans.items():
        hit = [kern[i] for a, b in sp
               for i in range(bisect.bisect_left(starts, a),
                              bisect.bisect_left(starts, b))]
        out[n] = dict(ms=sum(d for _, d in hit) / 1e6,
                      calls=sum(d > 0 for _, d in hit), ranges=len(sp))
    return out


def profile_call(torch, fn, match=(), ranges=()):
    """Device time of one ``fn()`` by kernel name, the device launches
    (entries with device time), and the device's busy share of its wall
    time (torch.profiler, CUDA activity only); for each name fragment in
    ``match``, the device ms and launches of the kernels whose names hold
    it.  ``ranges`` names profiler ranges whose kernels' device ms and
    launches to report apart (range_rows); the trace then records the
    host's operators too, which the ranges need, so its wall time and
    busy share include that tracing."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges
                                      else [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = device_rows(prof)
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
    if ranges:
        out["ranges"] = range_rows(prof, ranges)
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
    """Full-width gemma2-2b at GEMMA_LAYERS layers with random weights from
    SEED, on the card, and the seeded policy."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    cfg = dataclasses.replace(ARCHS[ARCH].config, n_layers=GEMMA_LAYERS)
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
        dense = model.init_cache(1, PROMPT, dtype=torch.float32,
                                 device="cuda")
        want, _ = model.prefill(eng.params, {"tokens": toks}, dense, ab,
                                attn_impl="cuda")
        del dense
        pool = model.init_paged_cache(1, n + 1, PAGE, dtype=torch.float32,
                                      device="cuda")
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
    rows = device_rows(prof)
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
    firsts, gens = [], []
    for i, (toks, n_new) in enumerate(reqs):
        gen = eng.generate(toks[None], n_new)
        want, gaps = gen["tokens"][0], gen["top2_gap"][:, 0]
        gens.append((want, gaps))
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
    traced = []

    def trace():
        res, prof = profile_run(torch, eng, reqs, dict(kw, overlap=True))
        traced.append(res["outputs"])
        return prof

    prof, gemm_problems = traced_gemm_launches(trace, "run profile")
    problems += gemm_problems
    if not all(np.array_equal(a, b) for outs in traced
               for a, b in zip(outs, on)):
        problems.append("run: a profiled run's streams differ")
    emit({"phase": "run-profile", **prof})
    if problems:
        raise AssertionError("run checks failed: " + "; ".join(problems))
    spec = phase_spec(torch, cfg, eng, reqs, gens, recs["overlap"][1])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(paged_model=paged,
                runs={k: v[1] for k, v in recs.items()}, check=check,
                profile=prof, spec=spec,
                _streams=dict(reqs=reqs, run=on, gens=gens))


# ------------------------------------------------------------- phase moe
def _moe_gemm_launches(graph, policy, n_repeat, calls):
    """K2 and K3 launches of ``calls`` model calls on the packed store of
    ``policy``: one launch per non-empty int8 bucket (K2) and per
    non-empty int2 / int4 bucket (K3) of each GEMM site and repeat (an
    expert site's buckets are shared by its E experts: one launch each,
    not E), the unembedding once a call.  Returns ({kernel: launches},
    {site: [buckets]})."""
    from repro_torch.kernels.pack import bucket_of_bits
    k2 = k3 = 0
    sites = {}
    for l in graph.layers:
        names = sorted({bucket_of_bits(b)
                        for b in policy.expand_weight_bits(l)} -
                       {"pruned", "full"})
        sites[l.name] = names
        reps = 1 if l.kind == "unembed" else n_repeat
        k2 += reps * ("int8" in names)
        k3 += reps * sum(n in ("int2", "int4") for n in names)
    return dict(quant_matmul=k2 * calls, packed_matmul=k3 * calls), sites


def phase_moe(torch):
    """granite-moe-3b-a800m at published width and depth with random fp32
    weights from SEED (~13.5 GB) and the seeded kernel-wise policy.

    * generate (2 x 2048 prompt, 16 new): engine A (packed store, the
      kernels) against engine B (fake store, plain versions) by
      check_serve's rules at MOE_LOGIT_ATOL; K1 once per layer and call,
      and the expert GEMMs on one batched K2 / K3 launch per bucket of
      each site (launches equal _moe_gemm_launches exactly); then the
      same pair with activation quantization off at MOE_ACT_OFF_ATOL.
    * run (8 requests, 4 slots, chunk 512) at capacity factor 1.25:
      prefill s, decode tok/s, TTFT, host syncs (none allowed), launches.
    * the same run at capacity factor 0 (no token dropped, the reference's
      smoke setting): each stream against its own generate by the gap
      rule, as the dense run phase holds them.  At 1.25 a token's drop
      depends on the batch it rides in, so run and generate may rightly
      differ there and are not compared.
    * one profiled generate on engine A: device ms by kernel group and
      the busy share; a second one that also traces the host gives the
      device ms inside the MoE dispatch and gather profiler ranges.
    Returns the records and each path's launches."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.models.layers import MOE_DISPATCH, MOE_GATHER
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    cfg = ARCHS[MOE_ARCH].config
    model = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    init = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                expert_d_ff=cfg.moe.d_ff, vocab=cfg.vocab,
                capacity_factor=cfg.moe.capacity_factor,
                seconds=time.perf_counter() - t0,
                param_bytes=int(sum(t.numel() * t.element_size()
                                    for blk in params["blocks"]
                                    for t in blk.values()) +
                                sum(params[k].numel() * 4 for k in
                                    ("embed", "unembed", "final_norm"))))
    emit({"phase": "moe-init", **init})
    peaks = [int(torch.cuda.max_memory_allocated())]
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    rng = np.random.default_rng(SEED + 6)
    tokens = rng.integers(0, cfg.vocab, size=(B, MOE_PROMPT))
    problems = []
    a = run_engine(torch, "moe-A", model, params, policy, tokens,
                   store="packed", impl="cuda", max_len=MOE_MAX_LEN)
    b = run_engine(torch, "moe-B", model, params, policy, tokens,
                   store="fake", impl="ref", max_len=MOE_MAX_LEN)
    a_rec, b_rec = a["rec"], b["rec"]
    peaks += [a_rec["peak_mem_bytes"], b_rec["peak_mem_bytes"]]
    check = check_serve(torch, a, b, MOE_LOGIT_ATOL, cfg.n_layers,
                        cfg.vocab)
    problems += check["problems"]
    want, sites = _moe_gemm_launches(graph, policy, cfg.n_repeat,
                                     1 + N_NEW)
    got = {k: a_rec["launches"][k] for k in want}
    if got != want:
        problems.append(f"moe generate: GEMM launches {got}, want {want} "
                        "(one a bucket of each site)")
    emit({"phase": "moe-gemm-launches", "launches": got, "want": want,
          "buckets": {n: v for n, v in sites.items()
                      if n.split(".")[-1] in ("wg", "wu", "wd")}})
    del a, b
    # the pair with activation quantization off, held at MOE_ACT_OFF_ATOL
    a0 = run_engine(torch, "moe-A0", model, params, policy, tokens,
                    store="packed", impl="cuda", serve_act_bits=False,
                    max_len=MOE_MAX_LEN)
    b0 = run_engine(torch, "moe-B0", model, params, policy, tokens,
                    store="fake", impl="ref", serve_act_bits=False,
                    max_len=MOE_MAX_LEN)
    peaks += [a0["rec"]["peak_mem_bytes"], b0["rec"]["peak_mem_bytes"]]
    check0 = check_serve(torch, a0, b0, MOE_ACT_OFF_ATOL, cfg.n_layers,
                         cfg.vocab)
    problems += check0["problems"]
    del a0, b0
    # continuous batching at capacity factor 1.25
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in zip(MOE_RUN_PROMPTS, MOE_RUN_NEW)]
    kw = dict(page_size=PAGE, max_slots=RUN_SLOTS, chunk_tokens=CHUNK)
    eng = ServeEngine(model, params, policy=policy, max_len=MOE_MAX_LEN,
                      weight_store="packed", attn_impl="cuda",
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, syncs = _syncs_of(torch, lambda: eng.run(reqs, **kw))
    torch.cuda.synchronize()
    run = _run_record(torch, "moe-cf1.25", res, time.perf_counter() - t0,
                      kernels.launch_counts())
    peaks.append(run["peak_mem_bytes"])
    st = res["stats"]
    run.update(host_syncs=syncs, host_syncs_per_step=syncs / max(st.steps,
                                                                 1))
    emit({"phase": "moe-run", "run": run["run"], "host_syncs": syncs})
    lr = run["launches"]
    if syncs:
        problems.append(f"moe run: {syncs} host syncs in {st.steps} steps")
    if lr["paged_attention"] != cfg.n_layers * st.steps or \
            lr["flash_attention"] or not (lr["quant_matmul"] and
                                          lr["packed_matmul"]):
        problems.append(f"moe run: launches {lr} over {st.steps} steps")
    if st.tokens_out != sum(MOE_RUN_NEW):
        problems.append(f"moe run: tokens_out {st.tokens_out}")
    # one profiled generate: device time by kernel group and busy share
    prof, gemm_problems = traced_gemm_launches(
        lambda: profile_call(torch, lambda: eng.generate(tokens, N_NEW)),
        "moe generate")
    problems += gemm_problems
    emit({"phase": "moe-profile", **prof})
    # and one that also traces the host, for the device time inside the
    # MoE dispatch and gather ranges (one of each a layer and model call)
    split = profile_call(torch, lambda: eng.generate(tokens, N_NEW),
                         ranges=(MOE_DISPATCH, MOE_GATHER))
    ranged = split["ranges"]
    moe_split = dict(device_ms=split["device_ms"],
                     groups={g: v["ms"] for g, v in split["groups"].items()},
                     ranges=ranged, ranges_per_name=cfg.n_layers * (1 + N_NEW),
                     other_ms=split["device_ms"] -
                     sum(v["ms"] for v in ranged.values()) -
                     sum(v["ms"] for v in split["groups"].values()))
    prof["split"] = moe_split
    emit({"phase": "moe-dispatch", **moe_split})
    for n, v in ranged.items():
        if not v["ranges"] or not v["calls"]:
            problems.append(f"moe profile: no kernel traced in range {n}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # capacity factor 0: run() against generate() per request
    cfg0 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.0))
    eng = ServeEngine(LM(cfg0), params, policy=policy, max_len=MOE_MAX_LEN,
                      weight_store="packed", attn_impl="cuda",
                      device="cuda")
    run0, _, _, gl0 = _run_and_generate(torch, "moe-cf0", eng, reqs, kw,
                                        problems)
    peaks.append(run0["peak_mem_bytes"])
    emit({"phase": "moe-run-cf0", "first_differences":
          run0["first_differences"], "generate_launches": gl0})
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(init=init, engine_a=a_rec, engine_b=b_rec,
               check=check, check_act_off=check0,
               gemm_launches=dict(got=got, want=want),
               run=run, run_cf0=run0, profile=prof,
               peak_mem_bytes=max(peaks),
               seconds=time.perf_counter() - t_phase, problems=problems)
    emit({"phase": "moe", "seconds": out["seconds"],
          "peak_mem_bytes": out["peak_mem_bytes"], "problems": problems})
    if problems:
        raise AssertionError("moe checks failed: " + "; ".join(problems))
    return out


# ------------------------------------------------------------- phase ssm
def _param_bytes(params) -> int:
    from repro_torch.core.ddpg import tree_leaves
    return int(sum(t.numel() * t.element_size()
                   for t in tree_leaves(params)))


def _attn_layers(cfg) -> int:
    """Attention layers of a config: K1 (prefill, dense decode) and K4
    (paged decode) launch once in each per model call."""
    return cfg.n_repeat * sum(b.kind != "mamba" for b in cfg.pattern)


def _gemm_check(problems, what, launches, graph, policy, n_repeat, calls):
    """K2 / K3 launches of ``calls`` model calls against the exact count
    of _moe_gemm_launches (one a bucket of each site and repeat)."""
    want, _ = _moe_gemm_launches(graph, policy, n_repeat, calls)
    got = {k: launches[k] for k in want}
    if got != want:
        problems.append(f"{what}: GEMM launches {got}, want {want} (one a "
                        "bucket of each site)")
    return want


def _fp64_floor(torch, model, params, graph, policy, tokens):
    """The noise floor of ``model`` at fp32 under ``policy``'s weights,
    activation quantization off: the full forward (``LM.apply``, every
    position of ``tokens``) of the fake store in fp32 (B) and in fp64
    (F: every step of the port's plain path then runs in fp64), and of
    the packed store on the kernels (A).  Returns |A - F| and |B - F| over
    the real vocabulary (mean, max, and max at the last position, whose
    logits generate's prefill returns) and F's standard deviation."""
    from repro_torch.core.ddpg import tree_map
    from repro_torch.quant.apply import (apply_policy_packed,
                                         apply_policy_to_params)
    V = model.cfg.vocab
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    with torch.no_grad():
        fake = apply_policy_to_params(params, graph, policy)
        lb = model.apply(fake, batch)[0][..., :V]
        lf = model.apply(tree_map(lambda t: t.double(), fake),
                         batch)[0][..., :V]
        del fake
        la = model.apply(apply_policy_packed(params, graph, policy),
                         batch, attn_impl="cuda")[0][..., :V]
    out = dict(fp64_logit_std=float(lf.std()))
    for name, lg in (("a", la), ("b", lb)):
        e = (lg.double() - lf).abs()
        out.update({f"{name}_mean": float(e.mean()),
                    f"{name}_max": float(e.max()),
                    f"{name}_last_max": float(e[:, -1].max())})
    del la, lb, lf
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _state_run(torch, label, eng, reqs, graph, policy, problems,
               tol=ACT_LOGIT_ATOL):
    """``eng.run(reqs)`` with ``prefill`` left to the engine on a pattern
    with recurrent state: chunked and speculative runs and open-loop
    serving refused before any model call; the run monolithic, each
    stream held to its own ``generate`` by the gap rule; K1 once per
    attention layer and admission (generate: and model call), K4 once
    per attention layer and decode step, K2 / K3 exactly one launch per
    bucket of each site and model call, in the run and in the
    generates.  Returns the run record."""
    from repro_torch import kernels
    from repro_torch.serve import FrontEnd
    cfg = eng.model.cfg
    na = _attn_layers(cfg)
    kw = dict(page_size=PAGE, max_slots=RUN_SLOTS)
    for bad in (dict(prefill="chunked"), dict(speculative=True), None):
        kernels.reset_launch_counts()
        calls = dict(eng.call_counts)
        try:
            if bad is None:
                eng.serve(FrontEnd(), **kw)
            else:
                eng.run(reqs, **kw, **bad)
            problems.append(f"{label}: {bad or 'serve()'} did not raise")
        except ValueError:
            pass
        if dict(eng.call_counts) != calls or \
                any(kernels.launch_counts().values()):
            problems.append(f"{label}: {bad or 'serve()'} called the "
                            "model before raising")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs, **kw)
    torch.cuda.synchronize()
    rec = _run_record(torch, label, res, time.perf_counter() - t0,
                      kernels.launch_counts())
    st, lr = res["stats"], rec["launches"]
    rec["mode"] = st.mode
    if st.mode != "monolithic":
        problems.append(f"{label}: mode {st.mode}, want monolithic")
    if lr["flash_attention"] != na * len(reqs) or \
            lr["paged_attention"] != na * st.steps:
        problems.append(f"{label}: attention launches {lr} over "
                        f"{len(reqs)} admissions and {st.steps} steps")
    rec["gemm_want"] = _gemm_check(problems, label, lr, graph, policy,
                                   cfg.n_repeat, len(reqs) + st.steps)
    kernels.reset_launch_counts()
    gens = []
    for toks, n_new in reqs:
        out = eng.generate(toks[None], n_new)
        gens.append((out["tokens"][0], out["top2_gap"][:, 0]))
    gl = kernels.launch_counts()
    calls = sum(1 + n for _, n in reqs)
    if gl["flash_attention"] != na * calls or gl["paged_attention"]:
        problems.append(f"{label}: generate attention launches {gl}")
    _gemm_check(problems, label + " generate", gl, graph, policy,
                cfg.n_repeat, calls)
    rec["generate_launches"] = gl
    rec["first_differences"] = [
        f for i, (out, (want, gaps)) in enumerate(zip(res["outputs"], gens))
        if (f := _check_streams(f"{label}/{i}", out, want, gaps, tol,
                                problems))]
    emit({"phase": label + "-check", "mode": st.mode, "tol": tol,
          "first_differences": rec["first_differences"],
          "generate_launches": gl, "gemm_want": rec["gemm_want"]})
    return rec


def _act_drift(torch, model, params, graph, policy, tokens):
    """How far apart the full forwards (``LM.apply``, every position of
    ``tokens``) of the packed store on the kernels (A) and of the fake
    store on the plain versions (B) lie on the first d pattern repeats of
    ``params``, for each d in SSM_DRIFT_DEPTHS: with the policy's
    activation QBNs and with activation quantization off, max and mean
    |A - B| over the real vocabulary, and B's standard deviation.
    Measured, not held: it shows at which depth the pair parts."""
    import dataclasses
    from repro_torch.models import LM
    from repro_torch.quant.apply import (apply_policy_packed,
                                         apply_policy_to_params)
    cfg, V = model.cfg, model.cfg.vocab
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    bits = model.block_act_bits(graph, [policy.act_bits[l.name]
                                        for l in graph.layers])
    pa = apply_policy_packed(params, graph, policy)
    pb = apply_policy_to_params(params, graph, policy)
    rows = []
    with torch.no_grad():
        for d in SSM_DRIFT_DEPTHS:
            n = d * len(cfg.pattern)
            m = LM(dataclasses.replace(cfg, n_layers=n))
            row = dict(layers=n)
            for tag, ab in (("act8", bits[:d]), ("act_off", None)):
                la = m.apply(model.draft_prefix_params(pa, d), batch,
                             act_bits=ab, attn_impl="cuda")[0][..., :V]
                lb = m.apply(model.draft_prefix_params(pb, d), batch,
                             act_bits=ab)[0][..., :V]
                e = (la - lb).abs()
                row[tag] = dict(max=float(e.max()), mean=float(e.mean()),
                                b_std=float(lb.std()))
                del la, lb, e
            rows.append(row)
    del pa, pb
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_ssm(torch):
    """mamba2-780m at published width and depth with random fp32 weights
    from SEED (~3.4 GB) and the seeded kernel-wise policy, then the jamba
    hybrid at HYBRID_CUT's reduced width.

    * the noise floor (_fp64_floor): with activation quantization off,
      the kernels' forward must be as close to an fp64 evaluation as the
      plain fp32 forward is: mean |A - F| <= mean |B - F| + LOGIT_ATOL.
      On random weights 48 layers deep, fp32 rounding grows with depth
      (an H100 run: |B - F| up to 1.5 at some of the 4096 positions,
      mean 2.4e-3, logits' std 0.94), so no fixed logits tolerance from
      the shallower models holds here.
    * the drift (_act_drift): engine A's and B's forwards on the first
      1 ... 48 layers, with activation QBN 8 and with it off, reported.
    * generate (2 x 2048 prompt, 16 new) on engine A with the policy's
      activation QBN 8, the served configuration: finite, no K1 or K4 (no
      attention layer) and K2 / K3 exactly one launch per bucket of w_xz,
      w_bc, w_out and the unembedding a model call; then engine A against
      engine B (fake store, plain versions) with activation quantization
      off: prefill logits and streams by check_serve's rules at
      LOGIT_ATOL plus twice B's distance from F at the last position (two
      fp32 evaluations each that close to F).
    * activation QBN 8 held on the first SSM_GATE_LAYERS layers (the same
      weights, a policy of their own): the A / B pair by check_serve's
      rules at ACT_LOGIT_ATOL, and run() on 8 requests (prompts 2048 ...
      17) against generate by _state_run's rules.
    * where the time goes: a profiled prefill with the host traced (device
      ms inside the SSD_SCAN ranges, one a layer; its trace taken until it
      holds every K2 / K3 launch, traced_gemm_launches) and a profiled
      generate (device ms by kernel group, busy share, launches per decode
      step by difference; the GEMM launches its trace shows beside the
      wrappers' count, as a trace of ~77,000 kernels can drop records).
    * run on the same 8 requests at full depth with prefill left to the
      engine, activation quantization off: monolithic, streams against
      generate by the gap rule at the act-off pair's tolerance
      (_state_run).
    * jamba (7 mamba + 1 attention, MoE on the odd positions) at
      HYBRID_CUT: its own noise floor, engine A against engine B with
      activation quantization off by check_serve's rules at LOGIT_ATOL
      plus twice its B's fp64 distance (K1 once per attention layer and
      model call, K2 / K3 exactly one launch per bucket of each site, the
      experts' included), then run on 4 requests at activation QBN 8 by
      _state_run's rules, with K1, K4 and the expert-batched K2 / K3
      launched.
    Returns the records and each path's launches."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.models.ssm import SSD_SCAN
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    problems = []
    cfg = ARCHS[SSM_ARCH].config
    model = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    s_cfg = cfg.ssm
    init = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                d_inner=s_cfg.d_inner(cfg.d_model),
                heads=s_cfg.n_heads(cfg.d_model), head_dim=s_cfg.head_dim,
                d_state=s_cfg.d_state, d_conv=s_cfg.d_conv,
                chunk=s_cfg.chunk, vocab=cfg.vocab,
                vocab_padded=cfg.vocab_padded,
                seconds=time.perf_counter() - t0,
                param_bytes=_param_bytes(params))
    emit({"phase": "ssm-init", **init})
    peaks = [int(torch.cuda.max_memory_allocated())]
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    rng = np.random.default_rng(SEED + 8)
    tokens = rng.integers(0, cfg.vocab, size=(B, SSM_PROMPT))
    floor = _fp64_floor(torch, model, params, graph, policy, tokens)
    tol0 = LOGIT_ATOL + 2 * floor["b_last_max"]
    floor["act_off_tol"] = tol0
    emit({"phase": "ssm-floor", **floor})
    if floor["a_mean"] > floor["b_mean"] + LOGIT_ATOL:
        problems.append(f"ssm: the kernels' forward is farther from fp64 "
                        f"than the plain one: {floor}")
    drift = _act_drift(torch, model, params, graph, policy, tokens)
    emit({"phase": "ssm-drift", "depths": drift})
    # the served configuration: activation QBN 8, on the kernels
    a = run_engine(torch, "ssm-A", model, params, policy, tokens,
                   store="packed", impl="cuda", max_len=SSM_MAX_LEN)
    a_rec, la = a["rec"], a["rec"]["launches"]
    peaks.append(a_rec["peak_mem_bytes"])
    if not bool(torch.isfinite(a["logits"]).all()) or \
            a["tokens"].shape != (B, N_NEW) or a["tokens"].min() < 0 or \
            a["tokens"].max() >= cfg.vocab:
        problems.append("ssm-A: non-finite logits or tokens out of shape "
                        "or range")
    if la["flash_attention"] or la["paged_attention"]:
        problems.append(f"ssm generate: attention launched {la}")
    want = _gemm_check(problems, "ssm generate", la, graph, policy,
                       cfg.n_repeat, 1 + N_NEW)
    emit({"phase": "ssm-gemm-launches", "launches": la, "want": want})
    del a
    # A against B with activation quantization off, at the noise floor
    # (no attention layer: check_serve then wants 0 K1 launches)
    a0 = run_engine(torch, "ssm-A0", model, params, policy, tokens,
                    store="packed", impl="cuda", serve_act_bits=False,
                    max_len=SSM_MAX_LEN)
    b0 = run_engine(torch, "ssm-B0", model, params, policy, tokens,
                    store="fake", impl="ref", serve_act_bits=False,
                    max_len=SSM_MAX_LEN)
    peaks += [a0["rec"]["peak_mem_bytes"], b0["rec"]["peak_mem_bytes"]]
    check0 = check_serve(torch, a0, b0, tol0, 0, cfg.vocab)
    problems += check0["problems"]
    del a0, b0
    # activation QBN 8 held where the pair has not parted yet
    gcfg = dataclasses.replace(cfg, n_layers=SSM_GATE_LAYERS)
    gmodel = LM(gcfg)
    gparams = model.draft_prefix_params(params, SSM_GATE_LAYERS)
    ggraph = gmodel.graph(seq_len=1, batch=1)
    gpolicy = make_policy(ggraph)
    ga = run_engine(torch, "ssm-gate-A", gmodel, gparams, gpolicy, tokens,
                    store="packed", impl="cuda", max_len=SSM_MAX_LEN)
    gb = run_engine(torch, "ssm-gate-B", gmodel, gparams, gpolicy, tokens,
                    store="fake", impl="ref", max_len=SSM_MAX_LEN)
    gate = check_serve(torch, ga, gb, ACT_LOGIT_ATOL, 0, cfg.vocab)
    problems += gate["problems"]
    _gemm_check(problems, "ssm-gate generate", ga["rec"]["launches"],
                ggraph, gpolicy, gcfg.n_repeat, 1 + N_NEW)
    del ga, gb
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in zip(MOE_RUN_PROMPTS, MOE_RUN_NEW)]
    geng = ServeEngine(gmodel, gparams, policy=gpolicy, max_len=SSM_MAX_LEN,
                       weight_store="packed", attn_impl="cuda",
                       device="cuda")
    gate_run = _state_run(torch, "ssm-gate-run", geng, reqs, ggraph,
                          gpolicy, problems)
    del geng, gparams
    gc.collect()
    # where the time goes
    eng = ServeEngine(model, params, policy=policy, max_len=SSM_MAX_LEN,
                      weight_store="packed", attn_impl="cuda",
                      device="cuda")
    pre, gemm_problems = traced_gemm_launches(
        lambda: profile_call(torch, lambda: eng.generate(tokens, 0),
                             ranges=(SSD_SCAN,)), "ssm prefill")
    problems += gemm_problems
    ssd = pre["ranges"][SSD_SCAN]
    if ssd["ranges"] != cfg.n_layers or not ssd["calls"]:
        problems.append(f"ssm profile: SSD ranges {ssd}, want one a layer")
    kernels.reset_launch_counts()
    prof = profile_call(torch, lambda: eng.generate(tokens, N_NEW))
    calls = kernels.launch_counts()
    g = prof["groups"]
    where = dict(
        device_ms=prof["device_ms"], wall_s=prof["wall_s"],
        busy_share=prof["busy_share"],
        kernel_launches=prof["kernel_launches"],
        gemm_trace={n: dict(calls=calls[n], device_launches=sum(
            g[k]["calls"] for k in grps)) for n, grps in GEMM_GROUPS.items()},
        prefill_device_ms=pre["device_ms"],
        prefill_launches=pre["kernel_launches"],
        prefill_gemm_launches=pre["gemm_launches"],
        prefill_trace_shortfalls=pre["trace_shortfalls"],
        ssd_ms=ssd["ms"], ssd_launches=ssd["calls"],
        ssd_share_of_prefill=ssd["ms"] / max(pre["device_ms"], 1e-9),
        prefill_gemm_ms={k: pre["groups"][k]["ms"]
                         for k in ("k2_tc", "k2_skinny", "k3_tc",
                                   "k3_skinny")},
        gemm_ms={k: g[k]["ms"] for k in ("k2_tc", "k2_skinny", "k3_tc",
                                         "k3_skinny")},
        launches_per_decode_step=(prof["kernel_launches"] -
                                  pre["kernel_launches"]) / N_NEW,
        decode_device_ms_per_step=(prof["device_ms"] - pre["device_ms"]) /
        N_NEW, top=prof["top"])
    where["launches_per_decode_token"] = where["launches_per_decode_step"] / B
    emit({"phase": "ssm-profile", **where})
    del eng
    gc.collect()
    eng = ServeEngine(model, params, policy=policy, max_len=SSM_MAX_LEN,
                      weight_store="packed", attn_impl="cuda",
                      serve_act_bits=False, device="cuda")
    run = _state_run(torch, "ssm-run", eng, reqs, graph, policy, problems,
                     tol=tol0)
    peaks.append(run["peak_mem_bytes"])
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    # the jamba hybrid at a reduced width
    base = ARCHS[HYBRID_ARCH].config
    hcfg = dataclasses.replace(base, **HYBRID_CUT, moe=dataclasses.replace(
        base.moe, d_ff=HYBRID_EXPERT_D_FF))
    hmodel = LM(hcfg)
    torch.cuda.reset_peak_memory_stats()
    hparams = hmodel.init(SEED, device="cuda")
    hinit = dict(arch=hcfg.name, cut=dict(HYBRID_CUT,
                                          expert_d_ff=HYBRID_EXPERT_D_FF),
                 published=dict(n_layers=base.n_layers,
                                d_model=base.d_model, n_heads=base.n_heads,
                                n_kv_heads=base.n_kv_heads, d_ff=base.d_ff,
                                expert_d_ff=base.moe.d_ff),
                 pattern=[b.kind + ("+moe" if b.use_moe else "")
                          for b in hcfg.pattern],
                 experts=hcfg.moe.n_experts, top_k=hcfg.moe.top_k,
                 capacity_factor=hcfg.moe.capacity_factor,
                 vocab=hcfg.vocab, param_bytes=_param_bytes(hparams))
    emit({"phase": "hybrid-init", **hinit})
    hgraph = hmodel.graph(seq_len=1, batch=1)
    hpolicy = make_policy(hgraph)
    htokens = rng.integers(0, hcfg.vocab, size=(B, SSM_PROMPT))
    hfloor = _fp64_floor(torch, hmodel, hparams, hgraph, hpolicy, htokens)
    htol = LOGIT_ATOL + 2 * hfloor["b_last_max"]
    hfloor["act_off_tol"] = htol
    emit({"phase": "hybrid-floor", **hfloor})
    if hfloor["a_mean"] > hfloor["b_mean"] + LOGIT_ATOL:
        problems.append(f"hybrid: the kernels' forward is farther from "
                        f"fp64 than the plain one: {hfloor}")
    ha = run_engine(torch, "hybrid-A0", hmodel, hparams, hpolicy, htokens,
                    store="packed", impl="cuda", serve_act_bits=False,
                    max_len=SSM_MAX_LEN)
    hb = run_engine(torch, "hybrid-B0", hmodel, hparams, hpolicy, htokens,
                    store="fake", impl="ref", serve_act_bits=False,
                    max_len=SSM_MAX_LEN)
    peaks += [ha["rec"]["peak_mem_bytes"], hb["rec"]["peak_mem_bytes"]]
    hcheck = check_serve(torch, ha, hb, htol, _attn_layers(hcfg),
                         hcfg.vocab)
    problems += hcheck["problems"]
    hcheck["gemm_want"] = _gemm_check(
        problems, "hybrid generate", ha["rec"]["launches"], hgraph, hpolicy,
        hcfg.n_repeat, 1 + N_NEW)
    del ha, hb
    heng = ServeEngine(hmodel, hparams, policy=hpolicy, max_len=SSM_MAX_LEN,
                       weight_store="packed", attn_impl="cuda",
                       device="cuda")
    hreqs = [(rng.integers(0, hcfg.vocab, size=n).astype(np.int32), k)
             for n, k in zip(HYBRID_RUN_PROMPTS, HYBRID_RUN_NEW)]
    hrun = _state_run(torch, "hybrid-run", heng, hreqs, hgraph, hpolicy,
                      problems)
    if not all(hrun["launches"][k] for k in ("flash_attention",
                                             "paged_attention",
                                             "quant_matmul",
                                             "packed_matmul")):
        problems.append(f"hybrid run: a kernel not launched "
                        f"{hrun['launches']}")
    peaks.append(hrun["peak_mem_bytes"])
    del heng, hparams
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(init=init, floor=floor, drift=drift, engine_a=a_rec,
               check_act_off=check0, gate=gate, gate_run=gate_run,
               gemm_launches=dict(got=la, want=want), profile=where,
               run=run, hybrid_init=hinit, hybrid_floor=hfloor,
               hybrid_check=hcheck, hybrid_run=hrun,
               peak_mem_bytes=max(peaks),
               seconds=time.perf_counter() - t_phase, problems=problems)
    emit({"phase": "ssm", "seconds": out["seconds"],
          "peak_mem_bytes": out["peak_mem_bytes"], "problems": problems})
    if problems:
        raise AssertionError("ssm checks failed: " + "; ".join(problems))
    return out


# ------------------------------------------------------------- phase 5b
def _pool_bytes(cfg, max_slots, max_len, page, elem_bytes):
    """Bytes of the paged pool ServeEngine.run allocates: max_slots
    sequences at max_len plus the trash page, K and V of elem_bytes an
    element and int32 positions, per layer."""
    pages = max_slots * -(-max_len // page) + 1
    slots = cfg.n_layers * pages * page
    return slots * (2 * cfg.n_kv_heads * cfg.hdim * elem_bytes + 4)


def _run_and_generate(torch, label, eng, reqs, kw, problems):
    """``eng.run(reqs)`` (its launches and record), then each request's
    ``generate`` (their launches summed); every run stream held to its
    generate by the gap rule.  Returns (run record, run outputs, generate
    streams and gaps, generate launches)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs, **kw)
    torch.cuda.synchronize()
    rec = _run_record(torch, label, res, time.perf_counter() - t0,
                      kernels.launch_counts())
    nl = eng.model.cfg.n_layers
    st = res["stats"]
    if rec["launches"]["paged_attention"] != nl * st.steps or \
            rec["launches"]["flash_attention"]:
        problems.append(f"run {label}: attention launches "
                        f"{rec['launches']} over {st.steps} steps")
    kernels.reset_launch_counts()
    gens = []
    for toks, n_new in reqs:
        out = eng.generate(toks[None], n_new)
        gens.append((out["tokens"][0], out["top2_gap"][:, 0]))
    gen_launches = kernels.launch_counts()
    want = nl * sum(1 + n for _, n in reqs)
    if gen_launches["flash_attention"] != want:
        problems.append(f"generate {label}: flash_attention launched "
                        f"{gen_launches['flash_attention']} times, want "
                        f"{want}")
    firsts = []
    for i, (out, (want_toks, gaps)) in enumerate(zip(res["outputs"], gens)):
        f = _check_streams(f"{label}/{i}", out, want_toks, gaps,
                           ACT_LOGIT_ATOL, problems)
        if f:
            firsts.append(f)
    rec["first_differences"] = firsts
    rec["generate_launches"] = gen_launches
    return rec, res["outputs"], gens, gen_launches


def phase_cache_and_store(torch, cfg, model, params, policy, fp32):
    """gemma2-2b over a bf16 pool and cache, then in the uniform int8
    weight store, on the run phase's 8 requests.

    bf16: engine A's packed store and policy with
    ``cache_dtype=torch.bfloat16``: run() against each request's
    generate() by the gap rule (as the fp32 pool is held), and both
    against their fp32 twins (the run phase's streams) by the gap rule at
    BF16_GAP_TOL; the pool's bytes beside the fp32 pool's.
    int8 store: ``model.quantize_params_int8(params)`` served with no
    policy: generate's prefill logits against the fp32 engine's
    (mean |lf - lq| / std(lf) < INT8_REL_LIMIT, the reference's test), K2
    on every GEMM (launches = GEMM sites x model calls, traced: one device
    launch a call) and no K3, and run() against generate() by the gap
    rule."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    reqs, problems, out = fp32["reqs"], [], {}
    kw = dict(page_size=PAGE, max_slots=RUN_SLOTS, chunk_tokens=CHUNK)
    # ---- bf16 cache and pool
    eng = ServeEngine(model, params, policy=policy, max_len=MAX_LEN,
                      weight_store="packed", attn_impl="cuda",
                      cache_dtype=torch.bfloat16, device="cuda")
    rec, outs, gens, gl = _run_and_generate(torch, "bf16", eng, reqs, kw,
                                            problems)
    twins = []
    for i, (o, (g_toks, _), (f_toks, f_gaps)) in enumerate(
            zip(outs, gens, fp32["gens"])):
        for what, got in (("run", o), ("generate", g_toks)):
            f = _check_streams(f"bf16-{what}-vs-fp32/{i}", got, f_toks,
                               f_gaps, BF16_GAP_TOL, problems)
            if f:
                twins.append(f)
    rec.update(twin_first_differences=twins, twin_tol=BF16_GAP_TOL,
               pool_bytes=_pool_bytes(cfg, RUN_SLOTS, MAX_LEN, PAGE, 2),
               fp32_pool_bytes=_pool_bytes(cfg, RUN_SLOTS, MAX_LEN, PAGE,
                                           4))
    emit({"phase": "bf16-run", **rec})
    out["bf16"] = rec
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # ---- the uniform int8 store
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                  size=(B, PROMPT))
    f = run_engine(torch, "fp32", model, params, None, tokens, store="fake",
                   impl="cuda")
    t0 = time.perf_counter()
    qparams = model.quantize_params_int8(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    q = run_engine(torch, "int8", model, qparams, None, tokens,
                   store="fake", impl="cuda", profile=True)
    lf, lq = f["logits"], q["logits"]
    rel = float((lf - lq).abs().mean() / lf.std().clamp(min=1e-6))
    if not rel < INT8_REL_LIMIT:
        problems.append(f"int8 store: prefill logits rel {rel} >= "
                        f"{INT8_REL_LIMIT}")
    la = q["rec"]["launches"]
    sites = 7 * cfg.n_layers + 1          # q k v o, g u d a layer; unembed
    want = dict(quant_matmul=sites * (1 + N_NEW), packed_matmul=0,
                flash_attention=cfg.n_layers * (1 + N_NEW))
    for name, n in want.items():
        if la[name] != n:
            problems.append(f"int8 store generate: {name} launched "
                            f"{la[name]} times, want {n}")
    eng = ServeEngine(model, qparams, max_len=MAX_LEN, attn_impl="cuda",
                      device="cuda")
    rec, _, _, gl = _run_and_generate(torch, "int8-store", eng, reqs, kw,
                                      problems)
    if rec["launches"]["packed_matmul"] or gl["packed_matmul"]:
        problems.append("int8 store: K3 launched")
    rec.update(prefill_logit_rel=rel, rel_limit=INT8_REL_LIMIT,
               quantize_s=quant_s, generate=q["rec"],
               generate_fp32=f["rec"],
               weight_hbm_bytes=eng.weight_hbm_bytes())
    emit({"phase": "int8-store", **{k: v for k, v in rec.items()
                                    if k not in ("generate",
                                                 "generate_fp32")}})
    out["int8"] = rec
    del eng, qparams
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["problems"] = problems
    emit({"phase": "cache-store", "seconds": out["seconds"],
          "problems": problems})
    if problems:
        raise AssertionError("bf16 / int8-store checks failed: " +
                             "; ".join(problems))
    return out


class _Sessions:
    """Counts what the scheduler does inside ``with``: the schedulers that
    sessions build (``repro_torch.serve.engine.Scheduler``, patched to a
    subclass for the duration) and the pages their
    ``rollback_speculation`` returns."""

    def __enter__(self):
        from repro_torch.serve import engine, scheduler
        watch, self.scheds, self.rolled_back = self, [], 0

        class Watched(scheduler.Scheduler):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                watch.scheds.append(self)

            def rollback_speculation(self, slot):
                freed = super().rollback_speculation(slot)
                watch.rolled_back += len(freed)
                return freed

        self._engine, self._orig = engine, engine.Scheduler
        engine.Scheduler = Watched
        return self

    def __exit__(self, *exc):
        self._engine.Scheduler = self._orig

    def leaked(self):
        """Pages not back on a free list (0 when every pool drained)."""
        return sum(s.allocator.num_pages - 1 - s.allocator.n_free
                   for s in self.scheds)


def _spec_record(torch, label, res, wall, launches, calls, syncs,
                 rolled_back, leaked, trace_counts):
    st = res["stats"]
    rec = dict(run=label, wall_s=wall, steps=st.steps,
               prefill_s=st.prefill_s, decode_s=st.decode_s,
               decode_tok_per_s=st.decode_tok_per_s,
               tokens_out=st.tokens_out, spec_steps=st.spec_steps,
               spec_lane_steps=st.spec_lane_steps,
               spec_tokens_out=st.spec_tokens_out,
               draft_proposed=st.draft_proposed,
               draft_accepted=st.draft_accepted,
               acceptance_rate=st.acceptance_rate,
               spec_tokens_per_step=st.spec_tokens_per_step,
               accepted_hist={str(r): h for r, h in
                              sorted(st.accepted_hist.items())},
               rolled_back_pages=rolled_back, leaked_pages=leaked,
               peak_pages=st.peak_pages,
               ttft_s=st.ttft_percentiles((50, 99)),
               host_syncs=syncs,
               host_syncs_per_spec_step=syncs / max(st.spec_steps, 1),
               calls=calls, trace_counts=trace_counts, launches=launches)
    emit({"phase": "spec-run", **rec})
    return rec


def _step_inputs(torch, cfg, rows, w, k, dev):
    """One step's model_step inputs on 4 lanes: tokens and positions
    (4, w), each lane's real columns c0..c0+c-1 (``rows``: (c0, c)),
    padding at the sentinel; logit_cols (4, k + 1) (k > 0) or (4,)."""
    n = len(rows)
    toks = torch.randint(0, cfg.vocab, (n, w), device=dev)
    pos = torch.full((n, w), SENT, dtype=torch.int32, device=dev)
    cols = torch.zeros((n, k + 1) if k else (n,), dtype=torch.int32,
                       device=dev)
    for i, (c0, c) in enumerate(rows):
        pos[i, :c] = torch.arange(c0, c0 + c, dtype=torch.int32,
                                  device=dev)
        cols[i] = torch.clamp(torch.arange(k + 1, device=dev),
                              max=c - 1) if k else c - 1
    return toks, pos, cols


def step_costs(torch, timer, cfg, eng, k):
    """Event ms (Timer) and device ms (the profiler's kernel time over
    STEP_REPS calls, by kernel group) of one verify-only step (4 lanes,
    k + 1 real columns each at ~4175 in the run's CHUNK-wide tile, logits
    of every verify column) against one plain decode step (4 lanes x 1
    column), through LM.model_step on engine A's packed store, over a
    pool whose 4 sequences hold ~4175 positions each."""
    from repro_torch.serve.paged_kv import pages_needed
    dev = eng.device
    starts = SPEC_STARTS
    nb = pages_needed(MAX_LEN, PAGE)
    pool = eng.model.init_paged_cache(4, 4 * nb + 1, PAGE,
                                      dtype=torch.float32, device=dev)
    bt = (torch.arange(4 * nb, dtype=torch.int32, device=dev) + 1
          ).reshape(4, nb)
    for entry in pool:
        for i, c0 in enumerate(starts):
            L = c0 + k + 1
            ar = torch.arange(L, dtype=torch.int64, device=dev)
            entry["pos"][:, bt[i, ar // PAGE].long(), ar % PAGE] = ar.int()
    slot_map = torch.arange(4, dtype=torch.int32, device=dev)
    out = {}
    for label, w, rows, kk in (
            ("verify", CHUNK, [(c0, k + 1) for c0 in starts], k),
            ("decode", 1, [(c0, 1) for c0 in starts], 0)):
        toks, pos, cols = _step_inputs(torch, cfg, rows, w, kk, dev)
        fn = lambda: eng.model.model_step(eng.params, toks, pos, slot_map,
                                          pool, bt, cols, eng.act_bits,
                                          attn_impl="cuda")
        ms = timer(fn)
        prof = profile_call(torch, lambda: [fn() for _ in range(STEP_REPS)])
        out[label] = dict(width=w, real_tokens=sum(c for _, c in rows),
                          ms=ms, device_ms=prof["device_ms"] / STEP_REPS,
                          launches=prof["kernel_launches"] / STEP_REPS,
                          groups={g: v["ms"] / STEP_REPS
                                  for g, v in prof["groups"].items()
                                  if v["ms"]})
    del pool
    torch.cuda.empty_cache()
    return out


def phase_spec(torch, cfg, eng, reqs, gens, plain):
    """Speculative decode on engine A after the plain runs: the prefix
    draft on all requests, the self-draft and the low-bit draft on the 4
    shortest.  Every stream against generate's (top-2 gap rule), the
    accounting, the pool, the shapes, K4's launches, the host syncs; then
    a sampled pair (plain against self-draft, printed, not gated), a
    profile of the prefix run and one verify-only step's device time
    against a plain decode step's."""
    from repro_torch import kernels
    t_phase = time.perf_counter()
    kw = dict(page_size=PAGE, max_slots=RUN_SLOTS, chunk_tokens=CHUNK,
              speculative=True, draft_k=SPEC_K)
    nl, R = cfg.n_layers, cfg.n_repeat
    short = sorted(range(len(reqs)), key=lambda i: len(reqs[i][0]))[:4]
    short.sort()
    problems, recs, seconds = [], {}, {}
    shapes0 = dict(eng.trace_counts)
    for label, extra, idx, dl in (
            ("prefix", {}, list(range(len(reqs))),
             (R // 2) * len(cfg.pattern)),
            ("self", dict(draft_layers=R), short, nl),
            ("lowbit", dict(draft_policy="lowbit"), short, nl)):
        rq = [reqs[i] for i in idx]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        eng.call_counts.clear()
        before = dict(eng.trace_counts)
        with _Sessions() as sessions:
            t0 = time.perf_counter()
            res, syncs = _syncs_of(torch, lambda: eng.run(rq, **kw, **extra))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, calls = kernels.launch_counts(), dict(eng.call_counts)
        rec = _spec_record(torch, label, res, wall, launches, calls, syncs,
                           sessions.rolled_back, sessions.leaked(),
                           dict(eng.trace_counts))
        recs[label] = (res, rec)
        st = res["stats"]
        firsts = []
        for j, i in enumerate(idx):
            f = _check_streams(f"spec-{label}/{i}", res["outputs"][j],
                               gens[i][0], gens[i][1], ACT_LOGIT_ATOL,
                               problems)
            if f:
                firsts.append(f)
        rec["first_differences"] = firsts
        if st.tokens_out != sum(n for _, n in rq):
            problems.append(f"spec {label}: tokens_out {st.tokens_out}")
        if st.spec_tokens_out != st.draft_accepted + st.spec_lane_steps:
            problems.append(f"spec {label}: spec_tokens_out "
                            f"{st.spec_tokens_out} != accepted + lane steps")
        if st.spec_steps <= 0:
            problems.append(f"spec {label}: no verify step")
        if sessions.leaked():
            problems.append(f"spec {label}: {sessions.leaked()} pages not "
                            "back on the free list")
        if label == "prefix" and sessions.rolled_back <= 0:
            problems.append("spec prefix: no page rolled back")
        if launches["flash_attention"]:
            problems.append(f"spec {label}: flash_attention launched")
        # a draft_tail call is one (R, 1) step of the draft
        want = nl * calls.get("model_step", 0) + dl * (
            calls.get("draft_step", 0) + calls.get("draft_tail", 0))
        if launches["paged_attention"] != want:
            problems.append(f"spec {label}: paged_attention launched "
                            f"{launches['paged_attention']} times, want "
                            f"{want} ({calls})")
        if launches["quant_matmul"] <= 0 or launches["packed_matmul"] <= 0:
            problems.append(f"spec {label}: GEMM kernels not on the path")
        # a verify step syncs twice (proposals, verify tokens), others once
        if syncs > st.steps + st.spec_steps:
            problems.append(f"spec {label}: {syncs} host syncs in "
                            f"{st.steps} steps ({st.spec_steps} verify)")
        if label == "self" and st.spec_tokens_per_step <= 1.0:
            problems.append("spec self: spec_tokens_per_step "
                            f"{st.spec_tokens_per_step} <= 1")
        emit({"phase": "spec-check", "run": label, "new_shapes": {
            n: c - before.get(n, 0) for n, c in eng.trace_counts.items()},
            "first_differences": firsts})
    # the speculative session's own shapes (plain runs pass 1-D logit_cols)
    added = {n: c - shapes0.get(n, 0) for n, c in eng.trace_counts.items()}
    for name, most in (("model_step", 2), ("draft_step", 2),
                       ("draft_tail", 1)):
        if added.get(name, 0) > most:
            problems.append(f"spec: {name} saw {added[name]} shapes")
    seconds["runs"] = time.perf_counter() - t_phase
    # sampled pair: plain against the self-draft, first difference printed
    temps = (0.8, 0.0, 1.2, 0.5)
    srq = [dict(tokens=reqs[i][0], n_new=reqs[i][1], temperature=t,
                seed=40 + j) for j, (i, t) in enumerate(zip(short, temps))]
    plain_s = eng.run(srq, page_size=PAGE, max_slots=RUN_SLOTS,
                      chunk_tokens=CHUNK)
    spec_s, syncs_s = _syncs_of(torch, lambda: eng.run(
        srq, **kw, draft_layers=R))
    sampled = []
    for j, (a, b) in enumerate(zip(plain_s["outputs"], spec_s["outputs"])):
        bad = np.flatnonzero(a != b)
        sampled.append(dict(request=short[j], temperature=temps[j],
                            equal=not bad.size,
                            first_difference=int(bad[0]) if bad.size
                            else None))
    st = spec_s["stats"]
    emit({"phase": "spec-sampled", "streams": sampled, "host_syncs": syncs_s,
          "steps": st.steps, "spec_steps": st.spec_steps,
          "acceptance_rate": st.acceptance_rate})
    # rewinding a sampled lane's generator is host state: no extra sync
    if syncs_s > st.steps + st.spec_steps:
        problems.append(f"spec sampled: {syncs_s} host syncs in {st.steps} "
                        f"steps ({st.spec_steps} verify)")
    seconds["sampled"] = time.perf_counter() - t_phase - seconds["runs"]
    # one profiled prefix run, and the cost of one step at each width
    t0 = time.perf_counter()
    res, prof = profile_run(torch, eng, reqs, kw)
    if not all(np.array_equal(a, b) for a, b in
               zip(res["outputs"], recs["prefix"][0]["outputs"])):
        problems.append("spec: the profiled run's streams differ")
    prof["spec_steps"] = res["stats"].spec_steps
    emit({"phase": "spec-profile", **prof})
    seconds["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = step_costs(torch, Timer(torch), cfg, eng, SPEC_K)
    emit({"phase": "spec-step-cost", **steps})
    seconds["step_cost"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_phase
    out = dict(runs={k: v[1] for k, v in recs.items()}, sampled=sampled,
               profile=prof, step_costs=steps, shapes_added=added,
               plain=dict(decode_tok_per_s=plain["decode_tok_per_s"],
                          wall_s=plain["wall_s"]), seconds=seconds,
               problems=problems)
    emit({"phase": "spec", "seconds": seconds, "shapes_added": added,
          "problems": problems})
    if problems:
        raise AssertionError("spec checks failed: " + "; ".join(problems))
    return out


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
    return rec, res


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


def short_search(torch, model, params, graph, val, reward=None,
                 roofline=None, episodes=DETERMINISM_EPISODES):
    """``episodes`` (explore, exploit) of a QUANT search (HierarchicalAgent
    from SEED; the accuracy-guaranteed reward unless ``reward`` is given,
    with ``roofline`` for kind "roofline"): each episode's policy, and
    the SearchResult."""
    from repro_torch.core import (HierarchicalAgent, QuantEnv, RewardCfg,
                                  make_cnn_evaluator, run_search)
    from repro_torch.quant.policy import QuantMode
    ev = make_cnn_evaluator(model, params, graph, val, mode=QuantMode.QUANT)
    env = QuantEnv(graph, params, ev, reward or RewardCfg.accuracy_guaranteed(),
                   mode=QuantMode.QUANT, roofline=roofline)
    agent = HierarchicalAgent(env, seed=SEED)
    policies, episode = [], agent.run_episode

    def recorded(*a, **k):
        log, policy = episode(*a, **k)
        policies.append(policy.copy())
        return log, policy
    agent.run_episode = recorded
    return policies, run_search(agent, n_explore=episodes[0],
                                n_exploit=episodes[1])


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
    (pols, res), (pols2, res2) = searches
    rewards = [h.reward for h in res.history]
    rewards2 = [h.reward for h in res2.history]
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
    evaluator on the serving phases' gemma2-2b params.  Returns the
    record and what phase train builds on: the CNN, its trained
    substrate, graph, data, val images and the QUANT run's best policy."""
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
    runs, results = zip(*[run_cnn_search(torch, model, params, graph, val,
                                         *r) for r in SEARCH_RUNS])
    cnn_s = time.perf_counter() - t0
    lm_rec = check_lm_evaluator(torch, cfg, lm, lm_params, lm_policy)
    problems = checks["problems"] + [p for r in runs for p in r["problems"]] \
        + lm_rec["problems"]
    if train["last_loss"] >= train["first_loss"]:
        problems.append(f"substrate loss did not fall: {train}")
    if problems:
        raise AssertionError("search checks failed: " + "; ".join(problems))
    substrate = dict(model=model, params=params, graph=graph, data=data,
                     val=val, best=results[0].best_policy)
    return dict(train=train, val_acc=acc_raw, checks=checks, runs=list(runs),
                lm=lm_rec, cnn_seconds=cnn_s), substrate


# --------------------------------------------------------------- phase 7
def _power_w(card: str) -> float:
    """The power limit in watts from nvidia-smi's ``name, limit W`` line."""
    return float(card.rsplit(",", 1)[1].split()[0])


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def train_trainer(torch, model, data, tmp):
    """The Trainer on CIF10-7CNN from a fresh init: an uninterrupted run,
    then one preempted at TRAINER_PREEMPT and resumed from its newest
    checkpoint; every parameter and optimizer leaf must be equal bit for
    bit, and the loss (logged every step) must fall: the mean of the
    last TRAINER_WINDOW steps under that of the first."""
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.optim import AdamW
    from repro_torch.train.loop import SimulatedPreemption, Trainer, TrainConfig
    cfg = TrainConfig(total_steps=TRAINER_STEPS, ckpt_every=TRAINER_CKPT,
                      lr=TRAINER_LR, keep=3, log_every=1)

    def make(sub, preempt_at=None):
        return Trainer(model, model.init(SEED, "cuda"), AdamW(lr=TRAINER_LR),
                       lambda s: data.batch(s, TRAIN_BATCH),
                       os.path.join(tmp, sub), cfg, preempt_at=preempt_at,
                       device="cuda")

    full, saves = make("full"), []
    save = full.ckpt.save

    def timed_save(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(*a, **k)
        saves.append(time.perf_counter() - t0)
        return out
    full.ckpt.save = timed_save
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = full.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    problems = []
    try:
        make("pre", preempt_at=TRAINER_PREEMPT).run()
        problems.append("the preempted run was not preempted")
    except SimulatedPreemption:
        pass
    resumed = make("pre")
    t0 = time.perf_counter()
    out = resumed.run()
    torch.cuda.synchronize()
    wall_resumed = time.perf_counter() - t0
    leaves = list(zip(tree_leaves(ref["params"]) + tree_leaves(ref["opt"]),
                      tree_leaves(out["params"]) + tree_leaves(out["opt"])))
    differ = sum(not torch.equal(a, b) for a, b in leaves)
    want_start = TRAINER_PREEMPT // TRAINER_CKPT * TRAINER_CKPT
    losses = [h["loss"] for h in ref["history"]]
    if resumed.start_step != want_start:
        problems.append(f"resumed at step {resumed.start_step}, want "
                        f"{want_start}")
    if differ:
        problems.append(f"resumed run differs from the uninterrupted one in "
                        f"{differ} of {len(leaves)} leaves")
    first = float(np.mean(losses[:TRAINER_WINDOW]))
    last = float(np.mean(losses[-TRAINER_WINDOW:]))
    if not last < first:
        problems.append(f"Trainer loss did not fall: {losses}")
    newest = full.ckpt.dir / f"step_{full.ckpt.latest_step():010d}"
    rec = dict(model=model.cfg.name, steps=TRAINER_STEPS,
               batch=TRAIN_BATCH, ckpt_every=TRAINER_CKPT,
               preempt_at=TRAINER_PREEMPT, start_step=resumed.start_step,
               lr=TRAINER_LR, leaves=len(leaves), leaves_differing=differ,
               loss_first_window=first, loss_last_window=last,
               history=ref["history"], stragglers=ref["stragglers"],
               s_per_step=(wall - sum(saves)) / TRAINER_STEPS,
               resumed_s_per_step=wall_resumed / (TRAINER_STEPS -
                                                  resumed.start_step),
               ckpt_bytes=_dir_bytes(newest), saves=len(saves),
               s_per_save=float(np.mean(saves)), kept=full.ckpt.all_steps(),
               problems=problems)
    emit({"phase": "train-trainer", **rec})
    return rec


def train_roofline(torch, model, params, graph, val, power_w):
    """A short QUANT search under the roofline reward on the H100 model:
    every episode's reward recomputed on the host from its logged policy
    and accuracy; the H100 and TPU models' latency and energy of the best
    policy and of uniform ones."""
    from repro_torch.core import (H100Roofline, RewardCfg, TPURoofline,
                                  extrinsic_reward)
    from repro_torch.quant.policy import QuantPolicy
    roof = H100Roofline(power_w=power_w)
    cfg = RewardCfg(alpha=2.0, beta=0.5, gamma=0.5, kind="roofline")
    t0 = time.perf_counter()
    policies, res = short_search(torch, model, params, graph, val,
                                 reward=cfg, roofline=roof,
                                 episodes=ROOFLINE_EPISODES)
    seconds = time.perf_counter() - t0
    rewards = [h.reward for h in res.history]
    host = [extrinsic_reward(h.acc, graph, p, cfg, roofline=roof)
            for h, p in zip(res.history, policies)]
    problems = []
    if not all(np.isfinite(rewards)):
        problems.append(f"non-finite roofline rewards {rewards}")
    if host != rewards:
        problems.append(f"rewards {rewards} != host recomputation {host}")
    models = {"h100": roof, "tpu": TPURoofline()}
    table = {}
    for label, pol in [("best", res.best_policy)] + [
            (f"uniform{b}", QuantPolicy.uniform(graph, float(b)))
            for b in (32, 8, 4, 2)]:
        table[label] = {n: dict(latency_s=m.latency(graph, pol),
                                latency_ratio=m.latency(graph, pol) /
                                m.latency_full(graph),
                                energy_j=m.energy(graph, pol))
                        for n, m in models.items()}
    rec = dict(episodes=len(rewards), power_w=power_w, rewards=rewards,
               host_rewards=host, accs=[h.acc for h in res.history],
               best_avg_wbits=res.best_log.avg_wbits, seconds=seconds,
               models=table, problems=problems)
    emit({"phase": "train-roofline", **rec})
    return rec


def train_qat(torch, model, params, graph, val, data, best):
    """qat_finetune of the QUANT search's best policy (QAT_STEPS steps,
    batch QAT_BATCH): validation accuracy before and after, B5's launches
    (one a searched weight a step; B6 none); one step's gradients against
    the plain statement's (CNN.loss at the weights fake_quant_per_channel
    gives), bit for bit; one profiled step, B5's device ms apart."""
    from repro_torch import kernels
    from repro_torch.core import make_cnn_evaluator
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.core.evaluate import upload_bits
    from repro_torch.optim import AdamW
    from repro_torch.quant.apply import get_path, set_path
    from repro_torch.quant.linear_quant import fake_quant_per_channel
    from repro_torch.train.loop import upload_batch, value_and_grad
    from repro_torch.train.qat import make_qat_loss, qat_finetune
    dev = torch.device("cuda")

    def data_fn(i):
        return data.batch(QAT_DATA + i, QAT_BATCH)
    acc_before = make_cnn_evaluator(model, params, graph, val)(best)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tuned = qat_finetune(model, params, graph, best, data_fn, steps=QAT_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    acc_after = make_cnn_evaluator(model, tuned, graph, val)(best)
    problems = []
    want = len(graph.layers) * QAT_STEPS
    if launches["fake_quant"] != want or launches["binary_matmul"] != 0:
        problems.append(f"QAT launches {launches}: want fake_quant {want}, "
                        f"binary_matmul 0")
    if not acc_after >= acc_before - 2.0:
        problems.append(f"QAT accuracy {acc_after} < {acc_before} - 2")
    # the straight-through step against the plain statement
    batch = upload_batch(data_fn(0), dev)
    loss_fn = make_qat_loss(model, graph, best, device=dev)
    l_ste, g_ste = value_and_grad(loss_fn, params, batch)
    wb, ab = upload_bits(best, graph, dev)
    qp = params
    for layer, bits in zip(graph.layers, wb):
        qp = set_path(qp, layer.param_path, fake_quant_per_channel(
            get_path(params, layer.param_path), bits,
            axis=layer.channel_axis))
    act = dict(zip((l.name for l in graph.layers), ab))
    l_plain, g_plain = value_and_grad(
        lambda p: model.loss(p, batch, act_bits=act), qp)
    pairs = list(zip(tree_leaves(g_ste), tree_leaves(g_plain)))
    ste_differ = sum(not torch.equal(a, b) for a, b in pairs)
    if ste_differ or not torch.equal(l_ste, l_plain):
        problems.append(f"STE gradients differ from the plain statement's "
                        f"in {ste_differ} of {len(pairs)} leaves (loss "
                        f"{float(l_ste)} vs {float(l_plain)})")
    opt = AdamW(lr=3e-4, grad_clip=1.0)
    state = opt.init(params)

    def one_step():
        _, g = value_and_grad(loss_fn, params, batch)
        return opt.update(params, g, state)
    one_step()
    kernels.reset_launch_counts()
    prof = profile_call(torch, one_step, match=("fake_quant_rows",))
    b5 = dict(prof.pop("fake_quant_rows"),
              wrapper_calls=kernels.launch_counts()["fake_quant"])
    rec = dict(model=model.cfg.name, steps=QAT_STEPS, batch=QAT_BATCH,
               best_avg_wbits=best.avg_weight_bits(graph),
               acc_before=acc_before, acc_after=acc_after,
               s_per_step=seconds / QAT_STEPS, launches=launches,
               ste_leaves=len(pairs), ste_leaves_differing=ste_differ,
               step_device_ms=prof["device_ms"], step_b5_ms=b5["ms"],
               step_b5_launches=b5["calls"],
               step_b5_wrapper_calls=b5["wrapper_calls"],
               step_rest_ms=prof["device_ms"] - b5["ms"],
               profile_step=prof, problems=problems)
    emit({"phase": "train-qat", **rec})
    return rec


def _unpinned_grads_equal(torch, model, batch):
    """C2's probe: two ``LM.loss`` gradients from one seed with the row
    gathers' backward left to ``index_select``'s own CUDA backward (the
    embedding and MoE dispatch and gather without ``layers.gather_rows``'s
    deterministic sum).  Returns the number of leaves whose bits differ;
    not a check: the path runs the pinned backward."""
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.models import layers, transformer
    from repro_torch.train.loop import value_and_grad
    pinned = layers.gather_rows

    def plain(table, idx):
        return table.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + table.shape[1:])

    params = model.init(SEED + 1, "cuda")
    layers.gather_rows = transformer.gather_rows = plain
    try:
        grads = [tree_leaves(value_and_grad(
            lambda p: model.loss(p, batch, remat=True), params)[1])
            for _ in range(2)]
    finally:
        layers.gather_rows = transformer.gather_rows = pinned
    differ = sum(not torch.equal(a, b) for a, b in zip(*grads))
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return differ


def train_lm(torch, cfg, model):
    """LM_TRAIN_STEPS training steps of ``model`` at full width (LM.loss
    at 1 x LM_TRAIN_LEN tokens with remat=True, backward, one 8-bit AdamW
    update), run twice from one seed: the losses, the last step's
    gradients and every parameter leaf equal bit for bit.  The
    remat=False loss of step 1 must equal the remat=True one.  Peak
    memory is this call's.  On an MoE model, C2's probe
    (_unpinned_grads_equal) runs first."""
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.optim import AdamW
    from repro_torch.train.loop import upload_batch, value_and_grad
    dev = torch.device("cuda")
    opt = AdamW(lr=1e-4, state_bits=8)
    stream = TokenStream(vocab=cfg.vocab)
    batches = [stream.batch(i, 1, LM_TRAIN_LEN) for i in range(LM_TRAIN_STEPS)]
    unpinned = None
    if cfg.moe is not None:
        unpinned = _unpinned_grads_equal(torch, model,
                                         upload_batch(batches[0], dev))
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def one_run(first):
        params = model.init(SEED + 1, "cuda")
        state = opt.init(params)
        steps = []
        for i, b in enumerate(batches):
            tb = upload_batch(b, dev)
            if first and i == 0:
                with torch.no_grad():
                    loss_nr = model.loss(params, tb, remat=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = value_and_grad(
                lambda p: model.loss(p, tb, remat=True), params)
            params, state, m = opt.update(params, g, state)
            torch.cuda.synchronize()
            steps.append(dict(seconds=time.perf_counter() - t0, loss=loss,
                              grad_norm=m["grad_norm"]))
            if i + 1 < len(batches):
                del g
        return params, g, steps, (loss_nr if first else None)

    params, g, steps, loss_nr = one_run(True)
    peak = torch.cuda.max_memory_allocated()
    kept = [t.cpu() for t in tree_leaves(params)]
    kept_g = [t.cpu() for t in tree_leaves(g)]
    del params, g
    gc.collect()
    torch.cuda.empty_cache()
    params2, g2, steps2, _ = one_run(False)
    n_leaves = len(kept)
    differ = sum(not torch.equal(a.to(dev), b)
                 for a, b in zip(kept, tree_leaves(params2)))
    grads_differ = sum(not torch.equal(a.to(dev), b)
                       for a, b in zip(kept_g, tree_leaves(g2)))
    losses_equal = all(torch.equal(a["loss"], b["loss"])
                       for a, b in zip(steps, steps2))
    remat_equal = bool(torch.equal(loss_nr, steps[0]["loss"]))
    del params2, g2, kept, kept_g
    gc.collect()
    torch.cuda.empty_cache()
    problems = []
    if differ or grads_differ or not losses_equal:
        problems.append(f"two {cfg.name} training runs differ: {differ} "
                        f"parameter and {grads_differ} gradient leaves, "
                        f"losses equal {losses_equal}")
    if not remat_equal:
        problems.append(f"remat=False loss {float(loss_nr)} != remat=True "
                        f"{float(steps[0]['loss'])}")
    if not all(np.isfinite(float(s["loss"])) for s in steps + steps2):
        problems.append(f"non-finite {cfg.name} loss")

    def fl(st):
        return [dict(seconds=s["seconds"], loss=float(s["loss"]),
                     grad_norm=float(s["grad_norm"])) for s in st]
    rec = dict(arch=cfg.name, layers=cfg.n_layers, tokens=[1, LM_TRAIN_LEN],
               remat=True, state_bits=8, steps=fl(steps),
               steps_repeat=fl(steps2), leaves=n_leaves,
               leaves_differing=differ, grad_leaves_differing=grads_differ,
               losses_equal=losses_equal,
               loss_remat_false=float(loss_nr), remat_equal=remat_equal,
               unpinned_grad_leaves_differing=unpinned,
               resident_bytes_before=resident, peak_mem_bytes=peak,
               peak_mem_bytes_both=torch.cuda.max_memory_allocated(),
               problems=problems)
    emit({"phase": "train-lm", **rec})
    return rec


def phase_train(torch, cfg, lm, card, sub):
    """The Trainer, the roofline reward, QAT (on the search phase's
    substrate, val images and best QUANT policy), and the LM training
    steps of gemma2-2b and of granite-moe-3b-a800m at published width and
    depth (C2's check: MoE training bit-reproducible)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        trainer = train_trainer(torch, sub["model"], sub["data"], tmp)
    roof = train_roofline(torch, sub["model"], sub["params"], sub["graph"],
                          sub["val"], _power_w(card))
    qat = train_qat(torch, sub["model"], sub["params"], sub["graph"],
                    sub["val"], sub["data"], sub["best"])
    lm_rec = train_lm(torch, cfg, lm)
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    moe_cfg = ARCHS[MOE_ARCH].config
    moe_rec = train_lm(torch, moe_cfg, LM(moe_cfg))
    recs = dict(trainer=trainer, roofline=roof, qat=qat, lm=lm_rec,
                lm_moe=moe_rec, seconds=time.perf_counter() - t0)
    problems = [p for r in (trainer, roof, qat, lm_rec, moe_rec)
                for p in r["problems"]]
    emit({"phase": "train", "seconds": recs["seconds"]})
    if problems:
        raise AssertionError("train checks failed: " + "; ".join(problems))
    return recs


# ------------------------------------------------------------------ main
def summarize(rows, launches, by_path):
    """One entry per kernel: sums over its measured shapes.  ``launches``
    maps each kernel to its count on its own paths' runs; ``by_path``
    splits it for a kernel that more than one path runs."""
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
        if name in by_path:
            out[-1]["launches_by_path"] = by_path[name]
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
    store = phase_cache_and_store(torch, cfg, model, params, policy,
                                  run.pop("_streams"))
    search, substrate = phase_search(torch, cfg, model, params, policy)
    del params                  # the serving phases' weights
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(torch)
    ssm = phase_ssm(torch)
    train = phase_train(torch, cfg, model, card, substrate)
    launches = dict(rec_a["launches"])
    launches["paged_attention"] = \
        run["runs"]["overlap"]["launches"]["paged_attention"]
    for r in search["runs"]:
        name = "fake_quant" if r["mode"] == "quant" else "binary_matmul"
        launches[name] = r["launches"][name]
    gen = {"generate": rec_a["launches"],
           "generate_bf16": store["bf16"]["generate_launches"],
           "generate_int8_store": store["int8"]["generate"]["launches"],
           "moe_generate": moe["engine_a"]["launches"],
           "ssm_generate": ssm["engine_a"]["launches"],
           "ssm_gate_generate": ssm["gate"]["launches_a"],
           "hybrid_generate": ssm["hybrid_check"]["launches_a"]}
    runs = {"run": run["runs"]["overlap"]["launches"],
            "run_bf16": store["bf16"]["launches"],
            "run_int8_store": store["int8"]["launches"],
            "moe_run": moe["run"]["launches"],
            "moe_run_cf0": moe["run_cf0"]["launches"],
            "ssm_run": ssm["run"]["launches"],
            "ssm_gate_run": ssm["gate_run"]["launches"],
            "hybrid_run": ssm["hybrid_run"]["launches"]}
    by_path = {"fake_quant": {"search": launches["fake_quant"],
                              "qat": train["qat"]["launches"]["fake_quant"]}}
    for name in ("flash_attention", "quant_matmul", "packed_matmul",
                 "paged_attention"):
        by_path[name] = {p: c[name] for p, c in {**gen, **runs}.items()}
    launches["fake_quant"] = sum(by_path["fake_quant"].values())
    kernels = summarize(rows, launches, by_path)
    result = {"card": card, "kernel_rows": rows, "engine_a": rec_a,
              "engine_b": rec_b, "checks": checks, "run": run,
              "cache_and_store": store, "moe": moe, "ssm": ssm,
              "search": search, "train": train, "kernels": kernels,
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
