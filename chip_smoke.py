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
              launch a call (counted as the kernel nodes of a CUDA graph
              that captures the call; a CUPTI trace's count is printed
              beside it), and every tensor-core row must also come within
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
              library call torch.bmm on the dequantized stack), the
              grouped K2 / K3 over the routed pairs (the same sites at
              P = 32768 pairs, uniform and skewed, fp32 and bf16 x, bit
              for bit against the capacity launch, timed beside it), one
              launch for a whole mixed-QBN PackedWeight (mixed_gemm_rows:
              granite-4.0-h-small's w_out, shared.wg and grouped experts'
              wg at a 384-row step, and shared.wg on a bf16 x, bit for
              bit against the per-bucket launches and index copies,
              within GEMM_TOL of the plain product, one device launch a
              call, both timed) and K2 on
              the uniform int8 store's gemma2-2b wq; musicgen-large's K1
              prefill and decode at D 64, G 1, and llama-3.2-vision's
              cross-attention K1 rows, non-causal over the 1600-token
              memory (prefill, decode in fp32 and bf16; the library call
              SDPA without a causal mask); K2 / K3 at vision's wg
              (4096 and 2 rows x 8192 x 28672), its unembedding (2 x 8192
              x 128256) and musicgen's wg (4096 x 2048 x 8192).  Last, a
              bf16 model's rows: K1's prefill (2 x 4160) and decode
              (against a 4224 bf16 cache) and K4's 4 x 512 chunk and 4 x 1
              decode over a bf16 pool, each on a bf16 q (BF16_ATTN_TOL,
              bf16 output); K2 / K3 on a bf16 x at 2 and 8320 x 2304 x
              9216 and expert-batched at 40 x 1024 x 1536 x 512
              (BF16_GEMM_TOL, bf16 output, route tc_1xtf32 at M > 8), the
              library call SDPA on bf16 q, k, v and torch.matmul / bmm on
              the bf16 dequantized weight.  Then B5 and B6 on a bf16 x (a
              bf16 CNN's evaluators, a bf16 LM's QUANT evaluator): B5 at
              CIF10's conv5 weight and gemma2-2b's stacked wg and unembed,
              bit for bit; B6 at CIF10's conv0, conv1 and conv5 im2col
              products and the fc (P 8) within one bf16 ulp
              (BF16_GEMM_TOL); each row bf16 out, the same bits twice, one
              wrapper launch a call and its device launches counted exactly
              (1 for B5; 2 for B6, the fold and the product); B6's bound
              counts P planes of 2 M K N operations at the bf16 tensor
              peak (x and the planes are exact in bf16), its route bound
              the folded 2 M K N at the fp32 peak; B6's library call
              cuBLAS bf16 on the reconstructed weight, event and device.
              Last, the bf16 families' rows: K1 on bf16 q, K and V at
              vision's cross prefill (2 x 2048 over 1600, non-causal) and
              musicgen's prefill (D 64, G 1); K2 / K3 on a bf16 x at
              mamba2's w_xz and w_out (4096 and 2 rows), jamba's w_xz
              (1024 and 4) and vision's wg (4096 and 2).
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
              launches, K2's and K3's GEMMs; by route, no more device
              launches in the trace than GEMM calls, and the records the
              trace lost reported, as in generate's on engine A); at most
              one model_step shape a width and rung of the compacted
              step's ladder (step_shapes); and compact_step_gate: the
              serving benchmark's 16 x 256 step over its whole grid
              (padded) against compacted (the real cells' rows alone),
              logits and pool within COMPACT_TOL, bit-equality printed.
   cache-store -- gemma2-2b over a bf16 cache and pool (engine A's store
              with cache_dtype=torch.bfloat16): run() against each
              request's generate() by the gap rule, both against the fp32
              twins by the gap rule at BF16_GAP_TOL, the pool's bytes; then
              the uniform int8 store (model.quantize_params_int8): its
              prefill logits against the fp32 engine's (mean |lf - lq| /
              std(lf) < 0.35), K2 on every GEMM (exact launch count, its
              trace no more device launches than calls) and no K3, run()
              against generate().
   bf16    -- a bf16 model: gemma2-2b at GEMMA_LAYERS layers from
              LM.init(SEED, dtype=torch.bfloat16), bf16 caches and pools.
              generate 2 x 4160 + 16 on the dense store (K1 on a bf16 q;
              cuBLAS bf16 products) and on the packed store (K1, K2, K3 on
              bf16 q and x): engine A (kernels) against engine B (plain
              versions), prefill logits within BF16_TWIN_FACTOR x B's
              distance from B on the fp32 twin (the same parameters
              upcast, the plain versions in both: a yardstick that no
              kernel moves), streams by the gap rule at BF16_GAP_TOL,
              launches equal to A's fp32 twin's; run() of the run phase's 8 requests on the
              packed store: overlap on == off bitwise, streams against
              generate (gap rule), launches equal to the twin's run, 0
              host syncs a step, one profiled run (busy share; no more
              GEMM device launches than calls by route).  Prints
              prefill_s, decode tok/s, busy share, weight bytes and peak
              memory beside the card's name and power limit.
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
              check_serve's rules, K2 / K3 counted exactly (one launch a
              site where it has over 8 rows, the expert stacks' grouped
              launches included, else one a bucket), and the pair
              again with activation quantization off at a tight limit;
              run() on 8 requests at capacity factor 1.25 (0 host syncs,
              never compacted) and at 0 (each stream against its
              generate, gap rule; compact_step_gate); at
              both, generate through the grouped and the capacity expert
              dispatch, bit for bit, and one grouped MoE call under the
              sync debug mode "error"; one
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
              SSM_GATE_LAYERS layers (A / B at ACT_LOGIT_ATOL, run() on
              8 requests against generate, compact_step_gate); a
              profiled prefill with
              the host traced (device ms inside the SSD chunk scan's
              profiler ranges, every K2 / K3 launch in the trace) and a
              profiled generate (device ms by kernel group, busy share,
              launches per decode token); run(prefill="monolithic")
              on 8 requests (speculative run and serve refused before
              any model call;
              streams against generate by the gap rule at the act-off
              tolerance; exact launch counts); then the jamba hybrid at
              HYBRID_CUT's reduced width (one 8-layer period, d_model
              2048): its noise floor, A against B with activation
              quantization off (K1 once per attention layer and call,
              exact K2 / K3 counts), and run() on 4 requests the same way
              at QBN 8, with K1, K4 and the expert-batched K2 / K3
              launched.
   frontends -- musicgen-large at published width and depth (48 layers,
              d_model 2048, 32 heads of 64 over 32 kv heads, 3.22 B
              parameters), seeded frame embeddings: its fp64 floor over
              2 x 2064 frames, engine A against engine B (activation
              quantization off) over LM.prefill of 2048 frames and 16
              teacher-forced LM.decode_step calls, every step's logits
              within LOGIT_ATOL plus twice B's fp64 distance of B's and
              of A's own LM.apply, K1 48 launches a call, exact K2 / K3
              counts; activation QBN 8 held on its first 2 layers; a
              profiled prefill + step; 2 training steps through
              launch.train.make_data_fn (1 x 512 frames, remat, 8-bit
              AdamW) twice, bit for bit; then llama-3.2-vision-90b cut to
              one 5-layer period at published width (4 self + 1 cross,
              6.46 B parameters), 2 x 2048 tokens beside seeded image
              embeddings: an fp64 evaluation of the prefill's last
              logits, one block's weights converted at a time; A against
              B over 16 greedy tokens on a dense fp32 cache (K1 5 a call,
              exact K2 / K3 counts with the cross block's wk / wv at
              prefill only); the same prompts through batch-1 prefills,
              write_prefill of "paged" and "memory" entries and 16
              decode_step_paged steps (4 K4 and 1 K1 a step, streams
              against the dense run's by the gap rule); engine A over a
              bf16 cache, streams by the gap rule at BF16_GAP_TOL.
   bf16-families -- the four families with bf16 parameters from
              LM.init(SEED, dtype=bf16), fp32 twins (the same values
              upcast, fp32 caches) beside them; A is the packed store on
              the kernels, B the fake store on the plain versions, A / B
              within BF16_TWIN_FACTOR x B's twin distance, which is
              printed over the logits' standard deviation.  mamba2-780m
              at published width and depth: generate 2 x 2048 + 16
              (activation quantization off) over a bf16 and an fp32
              cache; the same on its first SSM_GATE_LAYERS layers, where
              the twin distance stays under the logits' spread, and run()
              on those layers at QBN 8 over a bf16 pool against generate
              (gap rule at BF16_GAP_TOL).  The jamba hybrid at HYBRID_CUT:
              run() of its 4 requests over a bf16 pool the same way.
              musicgen-large, published: prefill of 2 x 2048 bf16 frames
              + 16 teacher-forced steps.  One llama-3.2-vision period: 16
              greedy tokens over a dense bf16 cache (bf16 "memory"), then
              the paged path over a bf16 pool.  Every bf16 path's K1 /
              K4 / K2 / K3 launches equal its fp32 twin's.
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
   bf16-train -- bf16 parameters through B5 and B6.  (a) The search
              phase's CIF10 substrate rounded to bf16 (its fp32 twin the
              same values upcast), bf16 validation images: the QUANT
              evaluator on B5 against a plain evaluation for three seeded
              policies (bf16 weights bit for bit, the same accuracy), the
              BINARIZE evaluator on B6 against the dense fake-binarized
              bf16 forward (logits within BF16_TWIN_FACTOR x the plain
              forward's distance from its fp32 twin; accuracy the plane
              form's, and the dense forward's but for samples whose top-2
              gap is within twice that bound), 8 launches of the
              mode's kernel an evaluation; run_search for 7 + 3 QUANT and
              3 + 2 BINARIZE episodes, each twice, equal policies and
              rewards (bf16-train-search); 10 QAT steps on B5 (8 launches a
              step, latent weights bf16, one step's gradients bit for bit
              the plain statement's); one make_lm_evaluator call on bf16
              gemma2-2b against a plain evaluation (logits within the
              twin rule).  (b) gemma2-2b at GEMMA_LAYERS from
              LM.init(SEED + 1, dtype=bf16) trained by the Trainer at 1 x
              512 (remat, 8-bit AdamW): 3 steps uninterrupted, then
              preempted at step 2 and resumed from its checkpoint, every
              leaf and every loss bit for bit (train_trainer, as the
              CNN's); then the same steps as a plain loop: its losses and
              parameters the Trainer's bit for bit, each AdamW step its
              fp32 statement rounded once (state bit for bit) and moving
              some parameter, each loss within BF16_TWIN_FACTOR x the
              largest plain-forward distance from the fp32 forward on the
              same parameters of the fp32 twin's; s a step, s a save,
              checkpoint bytes, peak memory (bf16-train-lm).  (c) granite-moe-3b-a800m at
              published width and depth at bf16: two LM.loss steps twice,
              bit for bit (bf16-train-moe).  Prints its seconds.
8. shard   -- A11 on the card: a one-rank NCCL group and the 1x1 host
              mesh.  (a) compressed_allreduce of gemma2-2b's LM.loss
              gradients (GEMMA_LAYERS, 1 x 512) equals the _q8-dequantized
              gradients bit for bit, with the exchange's ms and its bytes
              against fp32 (shard-exchange); (b) two steps of
              make_train_step(compress_pod=True) on DTensors, twice, bit
              for bit, and bit for bit the plain step on q8-dequantized
              gradients (shard-train); the dry-run counts of that step
              (launch/dryrun.count_step: flops, bytes) give its H100
              roofline (fp32, TF32 off), and the measured step may not
              beat its largest term (shard-roofline); (c) LM.prefill at
              2 x 2048 with DTensor params and cache equals the unsharded
              prefill bit for bit, with as many K1 launches
              (shard-prefill).

The line before the last lists every kernel with its launches on its path
(K1-K3: gemma2-2b's generate; K4: its run; B5: the QUANT searches, QAT
and the bf16 LM evaluation; B6: the BINARIZE searches), ``launches_by_path``
for the kernels that more than one path runs (K1-K4: the generate and run
of each serving phase, granite-moe's, mamba2-780m's, jamba's, musicgen's
and vision's included, at fp32 and at bf16; B5: search, QAT, and their
bf16 runs; B6: search and its bf16 run) and its times; the last line is
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

# device-time groups of the profiled runs: kernel-name fragments
# (attn_tc's K/V source and gemm_tc's weight source name their launches;
# paged_combine merges the splits of both K4 walks).  A kernel falls in the
# first group that matches it: gemm_tc_mixed, whose name holds every
# stage type, before K2's and K3's per-bucket tiles.
KERNEL_GROUPS = {
    "k1_tc": ("DenseSlots",),
    "k1_split": ("flash_split", "split_combine"),
    "k4_chunk": ("PagedSlots",),
    "k4_decode": ("paged_split",),
    "k4_merge": ("paged_combine",),
    "k23_mixed": ("gemm_tc_mixed",),
    "k2_tc": ("Int8Stage",),
    "k2_skinny": ("gemm_stream<8,",),
    "k3_tc": ("PackedStage",),
    "k3_skinny": ("gemm_stream<4,", "gemm_stream<2,"),
}
# K2's and K3's wrapper launches by kind of route (gemm_route_kind) beside
# the group that holds their device launches: (LaunchCount, kind, group).
# One launch for every bucket of a PackedWeight counts under K3's
# mixed_* / grouped_mixed_* routes.
GEMM_ROUTES = (("quant_matmul", "tc", "k2_tc"),
               ("quant_matmul", "skinny", "k2_skinny"),
               ("packed_matmul", "tc", "k3_tc"),
               ("packed_matmul", "skinny", "k3_skinny"),
               ("packed_matmul", "mixed", "k23_mixed"))
GEMM_MS_GROUPS = ("k23_mixed", "k2_tc", "k2_skinny", "k3_tc", "k3_skinny")
# a pair of timing traces taken again when one came back empty
TRACE_ATTEMPTS = 3

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_attention.py:25
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_packed.py:68-69
# K2's and K3's tensor-core rows (outputs ~0.5): a sound two-pass kernel
# ends within ~1.4e-5 of quant_matmul_ref / packed_matmul_ref at K = 9216,
# one that chains every MMA into the truncating accumulator ~1.7e-4 (still
# inside GEMM_TOL by its rtol)
TC_ERR_LIMIT = 5e-5
# bf16 q: the kernel and its plain version compute in fp32 (their fp32
# results within ATTN_TOL) and round once to bf16, so an output differs by
# at most one bf16 ulp, 2^-7 of its value
BF16_ATTN_TOL = dict(rtol=2.0**-7, atol=ATTN_TOL["atol"])
# bf16 x: the kernels and their plain versions sum the same exact fp32
# products (within GEMM_TOL of each other) and round once to bf16, so an
# output differs by at most one bf16 ulp beyond that
BF16_GEMM_TOL = dict(rtol=2.0**-7, atol=GEMM_TOL["atol"])
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
# phase bf16: engine A's prefill logits (the kernels, bf16 throughout) may
# be at most this many times as far from engine B's (the plain versions)
# as B's are from B on the fp32 twin (the same parameters upcast, the plain
# versions again, so no kernel moves the limit); on the CPU the port's
# bf16 smoke models sit within 1.4x the reference's twin distance of the
# reference's (tests/test_torch_bf16_model.py)
BF16_TWIN_FACTOR = 2.0
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

# phase frontends: musicgen-large at published width and depth (48 layers,
# d_model 2048, 32 heads of 64 over 32 kv heads, d_ff 8192, vocab 2048;
# frame embeddings in place of tokens): prefill of 2 x 2048 seeded frames
# (x 0.3, tests/test_models.py:18's scale), then 16 teacher-forced
# decode steps; llama-3.2-vision-90b cut to one 5-layer period of its 100
# layers (4 self-attention + 1 cross-attention, d_model 8192, 64 q / 8 kv
# heads of 128, d_ff 28672, vocab 128256, 1600 image tokens as
# published): 2 x 2048 prompt tokens beside seeded image embeddings (x
# 0.3), 16 greedy tokens; musicgen trained 2 steps at 1 x 512 frames
AUDIO_ARCH, VISION_ARCH = "musicgen-large", "llama-3.2-vision-90b"
AUDIO_HEADS, VISION_IMG, VISION_LAYERS = 32, 1600, 5
FE_PROMPT, FE_MAX_LEN = 2048, 2064
FE_SCALE = 0.3
FE_GATE_LAYERS = 2                  # musicgen's QBN-8 pair (cf. ssm's)

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
# compact_step_gate: the serving benchmark's 16 x 256 token-budget step
# over pools of 128 pages a row.  K2 / K3 give each row the same bits at
# any M > 8; cuBLAS's dense fp32 products (the MoE router, mamba's w_dt)
# round otherwise at another row count (an H100 run of granite's 16 x 256
# step: logits <= 3.4e-5 apart, a mamba state <= 2.8e-4)
COMPACT_R, COMPACT_W, COMPACT_NB = 16, 256, 128
COMPACT_TOL = dict(rtol=1e-3, atol=1e-3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peak(kind: str) -> float:
    """The H100 data sheet's rate ``kind`` ("fp32", "tf32", "bf16" FLOP/s
    or "hbm" B/s), as ``repro_torch.core.roofline`` states it."""
    from repro_torch.core import roofline
    return {"fp32": roofline.H100_FP32, "tf32": roofline.H100_TF32,
            "bf16": roofline.H100_BF16, "hbm": roofline.H100_HBM_BW}[kind]


def bound_ms(nbytes: float, flops: float, rate: str = "fp32"):
    t_b, t_f = nbytes / peak("hbm"), flops / peak(rate)
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def _attn_tf32_equiv(torch, flops, q, k):
    """Attention's 4 D operations a pair as TF32-peak work: with a bf16 q
    and bf16 K/V the scores' half (q k) could run at the bf16 peak, while
    P V keeps P in fp32, as the reference's kernel does."""
    if q.dtype == k.dtype == torch.bfloat16:
        return flops / 2 * peak("tf32") / peak("bf16") + flops / 2
    return flops


def kernel_group(name):
    """The KERNEL_GROUPS group of kernel ``name``: the first that matches
    it, or None."""
    return next((g for g, frags in KERNEL_GROUPS.items()
                 if any(f in name for f in frags)), None)


def kernel_groups(keyed):
    """Device ms and launches of each KERNEL_GROUPS group from
    ``(kernel name, device ms, calls)`` triples."""
    of = [(kernel_group(n), ms, c) for n, ms, c in keyed]
    return {g: dict(ms=sum(ms for h, ms, _ in of if h == g),
                    calls=sum(c for h, ms, c in of if h == g and ms > 0))
            for g in KERNEL_GROUPS}


def gemm_route_kind(route):
    """``skinny``, ``mixed`` (one launch for a whole PackedWeight, dense
    or grouped) or ``tc`` (a bucket's tensor-core launch) for a
    ``LaunchCount`` route of K2 / K3."""
    return route if route == "skinny" else \
        "mixed" if "mixed" in route else "tc"


def traced_gemm_launches(trace, what):
    """``trace()`` -> a profile with ``groups``: K2's and K3's device
    launches in it, route by route (the kernel-name groups of
    GEMM_ROUTES: gemm_tc's, gemm_tc_mixed's and gemm_stream's), beside the
    wrappers' launches of the same run on that route.  A CUPTI trace drops
    kernel records now and then (cluster launches of gemm_stream among
    them) but never adds one, so a route with more device launches than
    calls fails at once, and one with fewer is reported, not failed
    (``missing``, the records the trace lost).  One launch a call is held
    exactly where no record can be lost: every GEMM kernel row counts the
    kernel nodes of a CUDA graph that captures one call (graph_launches),
    at the paths' shapes.  Returns the profile, with ``gemm_launches``,
    and the problems found."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    prof = trace()
    routes = kernels.launch_routes()
    pairs, over = {}, []
    for name, kind, group in GEMM_ROUTES:
        calls = sum(n for r, n in routes[name].items()
                    if gemm_route_kind(r) == kind)
        dev = prof["groups"][group]["calls"]
        pairs[f"{name}/{kind}"] = dict(
            calls=calls, device_launches=dev, missing=calls - dev,
            kernel=KERNEL_GROUPS[group])
        if dev > calls:
            over.append(f"{what}: {name} made {dev} device launches on "
                        f"its {kind} route for {calls} calls")
    prof["gemm_launches"] = pairs
    return prof, over


def graph_launches(torch, fn) -> int:
    """Device launches of one ``fn()``, exactly: the kernel nodes of the
    CUDA graph that captures it (``torch.cuda.graph``, relaxed capture),
    read through the driver API while the capture is open (a capture
    records every launch on its stream; a CUPTI trace may drop records).
    ``fn`` must have run before: its kernels built, its allocations
    cached."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph()
    found = {}
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
        status, cid = ctypes.c_int(), ctypes.c_ulonglong()
        g, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), \
            ctypes.c_size_t()
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = cu.cuStreamGetCaptureInfo_v2(
            stream, ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(g), ctypes.byref(deps), ctypes.byref(ndeps))
        n = ctypes.c_size_t(0)
        if err == 0:
            err = cu.cuGraphGetNodes(g, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        if err == 0:
            err = cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
        kernels = 0
        for i in range(n.value if err == 0 else 0):
            kind = ctypes.c_int(-1)
            cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                  ctypes.byref(kind))
            kernels += kind.value == 0       # CU_GRAPH_NODE_TYPE_KERNEL
        found.update(err=err, kernels=kernels)
    del graph
    if found["err"] != 0:
        raise RuntimeError(f"graph_launches: CUDA driver error "
                           f"{found['err']} reading the captured graph")
    return found["kernels"]


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
    """(label, q, k, v, q_pos, kv_pos, window, chunk, cap, causal) at the
    serving paths' shapes: gemma2-2b's prefill of 2 x 4160 tokens (global
    and local layers), the last decode step against the global cache and
    the local ring, in fp32 and in a bf16 cache, and an early decode step
    (position 40) against the global cache; granite-moe's prefill of 2 x
    2048 (D 64, G 3, no softcap) and its last decode step of generate; the
    jamba hybrid's the same (16 q / 2 kv heads of 128 at HYBRID_CUT: G 8,
    no softcap); musicgen-large's prefill of 2 x 2048 frames and its last
    decode step against the 2064-frame cache (32 q / 32 kv heads of 64:
    G 1); llama-3.2-vision's cross-attention, non-causal with every key at
    position 0: the prefill's 2 x 2048 queries over the 1600-token image
    memory and a decode query over it in fp32 and in a bf16 cache (64 q /
    8 kv heads of 128: G 8); then a bf16 model's (phase bf16): gemma2-2b's
    prefill with bf16 q, K and V and its last decode step's bf16 q over a
    bf16 cache; and the bf16 families' (phase bf16-families): vision's
    cross prefill and musicgen's prefill on bf16 q, K and V."""
    cfg_h, cfg_kv, D, cap = 8, 4, 256, 50.0
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")

    ar = torch.arange(PROMPT, dtype=torch.int32, device="cuda").repeat(B, 1)
    q = randn(B, PROMPT, cfg_h, D)
    k, v = randn(B, PROMPT, cfg_kv, D), randn(B, PROMPT, cfg_kv, D)
    yield "prefill_global", q, k, v, ar, ar, None, 1024, cap, True
    yield "prefill_window4096", q, k, v, ar, ar, 4096, 1024, cap, True
    last = PROMPT + N_NEW - 1                     # position of the last token
    qd = randn(B, 1, cfg_h, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, MAX_LEN, cfg_kv, D), randn(B, MAX_LEN, cfg_kv, D)
    kp = torch.full((B, MAX_LEN), 2**31 - 1, dtype=torch.int32, device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "decode_global", qd, kc, vc, qp, kp, None, MAX_LEN, cap, True
    W = 4096                                      # local layers' ring buffer
    ring = torch.arange(last + 1 - W, last + 1, dtype=torch.int32,
                        device="cuda")
    kr = torch.empty((B, W), dtype=torch.int32, device="cuda")
    kr[:, (ring % W).long()] = ring
    yield "decode_ring4096", qd, kc[:, :W].contiguous(), \
        vc[:, :W].contiguous(), qp, kr, W, W, cap, True
    # a bf16 cache (ServeEngine(cache_dtype=torch.bfloat16))
    kb, vb = kc.bfloat16(), vc.bfloat16()
    yield "decode_global_bf16", qd, kb, vb, qp, kp, None, MAX_LEN, cap, True
    yield "decode_ring4096_bf16", qd, kb[:, :W].contiguous(), \
        vb[:, :W].contiguous(), qp, kr, W, W, cap, True
    del kb, vb
    # one query at position 40 over the whole cache: most splits are empty
    qs = torch.full((B, 1), 40, dtype=torch.int32, device="cuda")
    ks = torch.full((B, MAX_LEN), SENT, dtype=torch.int32, device="cuda")
    ks[:, :41] = torch.arange(41, dtype=torch.int32, device="cuda")
    yield "decode_short", qd, kc, vc, qs, ks, None, MAX_LEN, cap, True
    del q, k, v, kc, vc
    # granite-moe-3b-a800m: 24 q / 8 kv heads of 64, no softcap
    Hq, Hkv, D = 24, 8, 64
    ar = torch.arange(MOE_PROMPT, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    q = randn(B, MOE_PROMPT, Hq, D)
    k, v = randn(B, MOE_PROMPT, Hkv, D), randn(B, MOE_PROMPT, Hkv, D)
    yield "moe_prefill", q, k, v, ar, ar, None, 1024, None, True
    last = MOE_PROMPT + N_NEW - 1
    qd = randn(B, 1, Hq, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, MOE_MAX_LEN, Hkv, D), randn(B, MOE_MAX_LEN, Hkv, D)
    kp = torch.full((B, MOE_MAX_LEN), SENT, dtype=torch.int32,
                    device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "moe_decode", qd, kc, vc, qp, kp, None, MOE_MAX_LEN, None, True
    del q, k, v, kc, vc
    # the jamba hybrid at HYBRID_CUT
    Hq, Hkv = HYBRID_CUT["n_heads"], HYBRID_CUT["n_kv_heads"]
    D = HYBRID_CUT["d_model"] // Hq
    ar = torch.arange(SSM_PROMPT, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    q = randn(B, SSM_PROMPT, Hq, D)
    k, v = randn(B, SSM_PROMPT, Hkv, D), randn(B, SSM_PROMPT, Hkv, D)
    yield "hybrid_prefill", q, k, v, ar, ar, None, 1024, None, True
    last = SSM_PROMPT + N_NEW - 1
    qd = randn(B, 1, Hq, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, SSM_MAX_LEN, Hkv, D), randn(B, SSM_MAX_LEN, Hkv, D)
    kp = torch.full((B, SSM_MAX_LEN), SENT, dtype=torch.int32,
                    device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "hybrid_decode", qd, kc, vc, qp, kp, None, SSM_MAX_LEN, None, True
    del q, k, v, kc, vc
    # musicgen-large: 32 q / 32 kv heads of 64 (G 1), no softcap
    Hq = Hkv = AUDIO_HEADS
    D = 64
    ar = torch.arange(FE_PROMPT, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    q = randn(B, FE_PROMPT, Hq, D)
    k, v = randn(B, FE_PROMPT, Hkv, D), randn(B, FE_PROMPT, Hkv, D)
    yield "audio_prefill", q, k, v, ar, ar, None, 1024, None, True
    last = FE_PROMPT + N_NEW - 1
    qd = randn(B, 1, Hq, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc, vc = randn(B, FE_MAX_LEN, Hkv, D), randn(B, FE_MAX_LEN, Hkv, D)
    kp = torch.arange(FE_MAX_LEN, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    yield "audio_decode", qd, kc, vc, qp, kp, None, FE_MAX_LEN, None, True
    del q, k, v, kc, vc
    # llama-3.2-vision-90b's cross-attention: 64 q / 8 kv heads of 128
    # over the 1600-token memory, every key at position 0, non-causal
    Hq, Hkv, D = 64, 8, 128
    ar = torch.arange(FE_PROMPT, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    zp = torch.zeros((B, VISION_IMG), dtype=torch.int32, device="cuda")
    q = randn(B, FE_PROMPT, Hq, D)
    k, v = randn(B, VISION_IMG, Hkv, D), randn(B, VISION_IMG, Hkv, D)
    yield "cross_prefill", q, k, v, ar, zp, None, 1024, None, False
    qd = randn(B, 1, Hq, D)
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    yield "cross_decode", qd, k, v, qp, zp, None, VISION_IMG, None, False
    yield "cross_decode_bf16", qd, k.bfloat16(), v.bfloat16(), qp, zp, \
        None, VISION_IMG, None, False
    del q, k, v, qd
    # a bf16 model (phase bf16): gemma2-2b's prefill with bf16 q, K and V,
    # and its last decode step's bf16 q against a bf16 cache
    Hq, Hkv, D = cfg_h, cfg_kv, 256
    ar = torch.arange(PROMPT, dtype=torch.int32, device="cuda").repeat(B, 1)
    q = randn(B, PROMPT, Hq, D).bfloat16()
    k, v = randn(B, PROMPT, Hkv, D).bfloat16(), \
        randn(B, PROMPT, Hkv, D).bfloat16()
    yield "prefill_global_bf16q", q, k, v, ar, ar, None, 1024, cap, True
    del q, k, v
    last = PROMPT + N_NEW - 1
    qd = randn(B, 1, Hq, D).bfloat16()
    qp = torch.full((B, 1), last, dtype=torch.int32, device="cuda")
    kc = randn(B, MAX_LEN, Hkv, D).bfloat16()
    vc = randn(B, MAX_LEN, Hkv, D).bfloat16()
    kp = torch.full((B, MAX_LEN), SENT, dtype=torch.int32, device="cuda")
    kp[:, :last + 1] = torch.arange(last + 1, dtype=torch.int32,
                                    device="cuda")
    yield "decode_global_bf16q", qd, kc, vc, qp, kp, None, MAX_LEN, cap, True
    del qd, kc, vc
    # the bf16 families (phase bf16-families): llama-3.2-vision's
    # cross-attention prefill (2 x 2048 over the 1600-token memory, G 8,
    # non-causal) and musicgen-large's prefill (2 x 2048 frames, D 64,
    # G 1), bf16 q, K and V
    Hq, Hkv, D = 64, 8, 128
    ar = torch.arange(FE_PROMPT, dtype=torch.int32,
                      device="cuda").repeat(B, 1)
    zp = torch.zeros((B, VISION_IMG), dtype=torch.int32, device="cuda")
    q = randn(B, FE_PROMPT, Hq, D).bfloat16()
    k = randn(B, VISION_IMG, Hkv, D).bfloat16()
    v = randn(B, VISION_IMG, Hkv, D).bfloat16()
    yield "cross_prefill_bf16q", q, k, v, ar, zp, None, 1024, None, False
    Hq = Hkv = AUDIO_HEADS
    D = 64
    q = randn(B, FE_PROMPT, Hq, D).bfloat16()
    k = randn(B, FE_PROMPT, Hkv, D).bfloat16()
    v = randn(B, FE_PROMPT, Hkv, D).bfloat16()
    yield "audio_prefill_bf16q", q, k, v, ar, ar, None, 1024, None, True


def _attn_library(torch, q, k, v, q_pos, kv_pos, window, causal=True):
    """F.scaled_dot_product_attention with the position mask and GQA
    expanded beforehand (SDPA has no softcap: it is timed without it; a
    bf16 K/V is upcast beforehand, outside the timed call, unless q is
    bf16 too: then all three are bf16); a non-causal call masks the
    sentinel slots only."""
    import torch.nn.functional as F
    k, v = k.to(q.dtype), v.to(q.dtype)
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qp, kp = q_pos[:, None, :, None].long(), kv_pos[:, None, None, :].long()
    mask = kp != 2**31 - 1
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask &= kp > qp - window
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def _paged_pool(torch, g, rows, k, kv_bits=None, dtype=None, Hkv=4, G=2,
                D=256, max_len=MAX_LEN, q_dtype=None):
    """A pool of PAGE-slot pages (gemma2-2b's Hkv 4, G 2, D 256 unless
    given) in shuffled order and one q tile of ``k`` columns per row.
    rows: per row (L, c0, c): the row holds positions 0..L-1 and its real
    columns are positions c0..c0+c-1 (the chunk or token just written);
    L == 0 is an idle lane (all-trash table, all-sentinel tile).  Pages are
    fp32, ``dtype`` (bf16), or int8 with ``kv_bits=8``; q is fp32 or
    ``q_dtype``.  Returns (q, k, v, pos, bt, q_pos, k_s, v_s)."""
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
    if q_dtype is not None:
        q = q.to(q_dtype)
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
    softcap); last, a bf16 model's chunk and decode tokens (bf16 q over a
    bf16 pool)."""
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
    # a bf16 model (phase bf16): bf16 q over a bf16 pool
    bq = dict(dtype=torch.bfloat16, q_dtype=torch.bfloat16)
    yield "chunk_bf16q", chunk, CHUNK, None, None, bq
    yield "decode_bf16q", dec, 1, None, None, bq


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
        tol = BF16_ATTN_TOL if q.dtype == torch.bfloat16 else ATTN_TOL
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paged/{label}: two calls on the same "
                                 "inputs give different bits")
        if got.dtype != q.dtype:
            raise AssertionError(f"paged/{label}: output {got.dtype}, q "
                                 f"{q.dtype}")
        want = plain()
        real = [(i, c) for i, (_, _, c) in enumerate(spec) if c]
        pick = lambda t: torch.cat([t[i, :c] for i, c in real])
        err, rel = compare(torch, pick(got), pick(want), tol,
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
                *args, **kw, n_splits=ns, mm=mm)), tol,
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
        nbytes = n_pages * page_bytes + 2 * q.element_size() * q.numel() + \
            4 * (bt.numel() + qp.numel())
        # the function's operations at the TF32 peak (3 TF32 passes give
        # fp32 accuracy; a bf16 q over bf16 pages has the scores' half at
        # the bf16 peak); its route's beside it: 3 TF32 passes (attn_tc),
        # or fp32 FMAs on CUDA cores (the decode walk)
        b_ms, b_by = bound_ms(
            nbytes, _attn_tf32_equiv(torch, 4 * D * pairs, q, kp),
            "tf32")
        r_ms = bound_ms(nbytes, 4 * D * pairs)[0] if route == "fp32_split" \
            else bound_ms(nbytes, 3 * 4 * D * pairs, "tf32")[0]
        kg, vg = paged_gather(kp, bt), paged_gather(vp, bt)
        if ks is not None:
            kg = kg.float() * paged_gather(ks, bt)[..., None]
            vg = vg.float() * paged_gather(vs, bt)[..., None]
        lib = _attn_library(torch, q, kg, vg, qp, kvp, window)
        ms, lib_ms = timer.pair(kern, lib)
        rows.append(dict(
            name="paged_attention", case=label,
            shape=list(q.shape) + [bt.shape[1] * PAGE],
            kv_dtype=str(kp.dtype).replace("torch.", ""),
            q_dtype=str(q.dtype).replace("torch.", ""), splits=ns,
            route=route, route_bound_ms=r_ms,
            route_ref_max_abs_err=route_err, max_abs_err=err,
            max_rel_err=rel, tol=tol, ms=ms,
            plain_ms=timer(plain), library_ms=lib_ms,
            library_device_ms=timer.device(lib),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by,
            pages_walked=n_pages))
        emit({"phase": "kernel", **rows[-1]})
        del got, again, want, kg, vg, kp, vp, lib
    torch.cuda.empty_cache()
    return rows


def _fq_inputs(torch, g, M, N, dtype=None):
    """x (M, N) in ``dtype`` (fp32 when None) and per-column scale /
    levels / bits as the QUANT evaluator makes them: bits from 0..8 with
    every 16th column at 32, scales in fp32."""
    x = torch.randn((M, N), generator=g, device="cuda").to(
        dtype or torch.float32)
    bits = torch.randint(0, 9, (N,), generator=g, device="cuda").float()
    bits[::16] = 32.0
    lv = torch.clamp(torch.pow(2.0, bits - 1.0) - 1.0, min=1.0)
    amax = x.float().abs().amax(dim=0)
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
            library_device_ms=timer.device(lambda: torch.matmul(x, w_hat)),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del x, planes, got, w_hat
    torch.cuda.empty_cache()
    return rows


def flash_rows(torch, timer):
    """K1 against attention_ref and against the plain statement of its
    route (the tensor-core walk's attention_tf32x3_ref, or the split walk's
    attention_split_ref), the same bits on a second call.  A bf16 q (its
    output bf16) is held at BF16_ATTN_TOL."""
    from repro_torch.kernels import attention
    from repro_torch.kernels.ref import (attention_split_ref,
                                         attention_tf32x3_ref)
    from repro_torch.models.layers import attention_ref
    rows = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, q, k, v, qp, kp, window, chunk, cap, causal in \
            _attn_cases(torch):
        kern = lambda: attention.flash_attention(
            q, k, v, q_pos=qp, kv_pos=kp, causal=causal, window=window,
            attn_cap=cap)
        plain = lambda: attention_ref(q, k, v, q_pos=qp, kv_pos=kp,
                                      causal=causal, window=window,
                                      attn_cap=cap, chunk=chunk)
        tol = BF16_ATTN_TOL if q.dtype == torch.bfloat16 else ATTN_TOL
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two calls on the same inputs "
                                 "give different bits")
        if got.dtype != q.dtype:
            raise AssertionError(f"{label}: output {got.dtype}, q {q.dtype}")
        err, rel = compare(torch, got, plain(), tol, label)
        ns = attention.decode_splits(q.shape[0], q.shape[1], q.shape[2],
                                     k.shape[2], k.shape[1], n_sm)
        kw = dict(q_pos=qp, kv_pos=kp, causal=causal, window=window,
                  attn_cap=cap)
        if ns > 1:
            route, route_ref = "fp32_split", attention_split_ref(
                q, k, v, **kw, n_splits=ns)
        else:
            route, route_ref = "tc_3xtf32", attention_tf32x3_ref(q, k, v,
                                                                 **kw)
        route_err, _ = compare(torch, got, route_ref, tol, f"{label}/{route}")
        del route_ref
        qq, kk = qp[:, :, None].long(), kp[:, None, :].long()
        valid = (kk != 2**31 - 1).repeat(1, qq.shape[1], 1)
        if causal:
            valid = valid & (kk <= qq)
        if window is not None:
            valid &= kk > qq - window
        pairs = float(valid.sum()) * q.shape[2]           # x query heads
        # K/V rows that some query may attend, read once per kv head
        slots = float(valid.any(dim=1).sum())
        nbytes = 2 * q.element_size() * q.numel() + \
            4 * (qp.numel() + kp.numel()) + \
            2 * slots * k.shape[2] * k.shape[3] * k.element_size()
        # the function's operations at the TF32 peak (for a bf16 q and K/V,
        # the scores' half at the bf16 peak: P stays fp32); its route's
        # beside it: 3 TF32 passes (flash_tc), or fp32 FMAs on CUDA cores
        flops = 4 * q.shape[3] * pairs
        b_ms, b_by = bound_ms(nbytes, _attn_tf32_equiv(torch, flops, q, k),
                              "tf32")
        r_ms = bound_ms(nbytes, 3 * flops, "tf32")[0] \
            if route == "tc_3xtf32" else bound_ms(nbytes, flops)[0]
        lib = _attn_library(torch, q, k, v, qp, kp, window, causal)
        ms, lib_ms = timer.pair(kern, lib)
        rows.append(dict(
            name="flash_attention", case=label, shape=list(q.shape) +
            [k.shape[1]], kv_dtype=str(k.dtype).replace("torch.", ""),
            q_dtype=str(q.dtype).replace("torch.", ""), causal=causal,
            splits=ns, route=route, route_bound_ms=r_ms,
            route_ref_max_abs_err=route_err,
            max_abs_err=err, max_rel_err=rel, tol=tol,
            ms=ms, plain_ms=timer(plain), library_ms=lib_ms,
            library_device_ms=timer.device(lib),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del got, again, lib
    return rows


def phase_kernels(torch, timer):
    cap = 50.0
    rows = search_kernel_rows(torch, timer) + paged_rows(torch, timer, cap) \
        + flash_rows(torch, timer) + gemm_rows(torch, timer, GEMM_SHAPES)
    return rows + expert_gemm_rows(torch, timer) + \
        grouped_gemm_rows(torch, timer) + mixed_gemm_rows(torch, timer) + \
        bf16_gemm_rows(torch, timer) + \
        bf16_search_kernel_rows(torch, timer)


# (label, M, K, N) of K2's and K3's rows in phase kernels
GEMM_SHAPES = [("wg_decode", 2, 2304, 9216),
               ("wg_prefill", 8320, 2304, 9216),
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
               ("hybrid_unembed_decode", 2, 2048, 65536),
               # llama-3.2-vision-90b (phase frontends): wg at its
               # 2 x 2048 prefill and at decode, the unembedding at
               # decode; musicgen-large's wg at its prefill
               ("vision_wg_prefill", 4096, 8192, 28672),
               ("vision_wg_decode", 2, 8192, 28672),
               ("vision_unembed_decode", 2, 8192, 128256),
               ("audio_wg_prefill", 4096, 2048, 8192)]


def _gemm_row(torch, timer, g, n_sm, bits, label, E, M, K, N,
              x_dtype=None):
    """One K2 (``bits`` 8) or K3 (4, 2) row: x (M, K) in ``x_dtype``
    (fp32 by default) against an int weight on the ``bits`` grid with
    scales (N,), or an expert stack of E of each (one launch).  Held to
    its plain version (GEMM_TOL; BF16_GEMM_TOL for a bf16 x, whose output
    is bf16), the same bits twice, one device launch a call
    (graph_launches), a tensor-core row
    on fp32 x within TC_ERR_LIMIT; timed beside torch.matmul / bmm on the
    dequantized weight (bf16 for a bf16 x).  The bound counts the
    function's 2 M K N operations at the TF32 peak (an integer weight is
    exact in TF32), at the bf16 peak for a bf16 x (exact in bf16 too),
    and x and y in their dtype's bytes; the route's own work beside it:
    two TF32 passes on the tensor cores (one for a bf16 x), else fp32 on
    CUDA cores."""
    from repro_torch.kernels import ops, pack, quant_matmul
    from repro_torch.kernels.ref import packed_matmul_ref, quant_matmul_ref
    x_dtype = x_dtype or torch.float32
    lv = 2 ** (bits - 1) - 1
    lead = (E,) if E else ()
    x = torch.randn(lead + (M, K), generator=g, device="cuda").to(x_dtype)
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
    bf16 = x_dtype == torch.bfloat16
    tol = BF16_GEMM_TOL if bf16 else GEMM_TOL
    got = kern()
    again = kern()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls on the same inputs give "
                             "different bits")
    if got.dtype != x_dtype:
        raise AssertionError(f"{what}: output {got.dtype}, x {x_dtype}")
    err, rel = compare(torch, got, plain(), tol, what)
    n_launch = graph_launches(torch, kern)
    if n_launch != 1:
        raise AssertionError(f"{what}: {n_launch} device launches a call, "
                             "want 1")
    route = quant_matmul.route(M, bits, x_dtype)
    if route == "tc_2xtf32" and err > TC_ERR_LIMIT:
        raise AssertionError(f"{what}: max abs err {err} over "
                             f"{TC_ERR_LIMIT}")
    n_e = E or 1
    wdeq = (qv.float() * s[..., None, :]).to(x_dtype)
    nbytes = n_e * (x.element_size() * (M * K + M * N) + 4 * N) + w.numel()
    flops = 2.0 * n_e * M * K * N
    b_ms, b_by = bound_ms(nbytes, flops,
                          "bf16" if bf16 else "tf32")
    passes = {"tc_2xtf32": 2, "tc_1xtf32": 1}.get(route)
    r_ms = bound_ms(nbytes, passes * flops, "tf32")[0] if passes \
        else bound_ms(nbytes, flops)[0]
    lib = (lambda: torch.bmm(x, wdeq)) if E else \
        (lambda: torch.matmul(x, wdeq))
    ms, lib_ms = timer.pair(kern, lib)
    row = dict(
        name=name, case=f"int{bits}_{label}",
        shape=([E] if E else []) + [M, K, N],
        x_dtype=str(x_dtype).replace("torch.", ""), route=route,
        route_bound_ms=r_ms, max_abs_err=err, max_rel_err=rel, tol=tol,
        launches_per_call=n_launch,
        splits=quant_matmul.skinny_splits(w.shape[-2], N, n_sm, n_e)
        if route == "skinny" else None,
        ms=ms, plain_ms=timer(plain), library_ms=lib_ms,
        library_device_ms=timer.device(lib), device_ms=timer.device(kern),
        host_ms=timer.host(kern), library_host_ms=timer.host(lib),
        bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "kernel", **row})
    return row


def gemm_rows(torch, timer, gemm_shapes):
    """K2 (int8) and K3 (int4, int2) at each (label, M, K, N)
    (_gemm_row)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [_gemm_row(torch, timer, g, n_sm, bits, label, None, M, K, N)
            for bits in (8, 4, 2) for label, M, K, N in gemm_shapes]
    torch.cuda.empty_cache()
    return rows


def expert_gemm_rows(torch, timer):
    """K2 and K3 on expert stacks, one launch for all E experts: granite-
    moe's wg (E 40, C x 1536 x 512) and wd (C x 512 x 1536) at C = 1024
    (generate's prefill at capacity factor 1.25: the tensor-core route)
    and at C = 2 and 4 (decode, and run()'s 4-slot decode: skinny), int8,
    int4 and int2; the jamba hybrid's the same way at HYBRID_CUT (E 16,
    C x 2048 x 4096 and C x 4096 x 2048; C = 640 at its A / B prefill of
    2 x 2048 tokens, 2 and 4 in decode); then K2 on the uniform int8
    store's gemma2-2b wq (2304 x 2048) at generate's M = 8320 and 2
    (_gemm_row; the library call is torch.bmm, torch.matmul for the 2-d
    rows)."""
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
    rows = [_gemm_row(torch, timer, g, n_sm, *c) for c in cases]
    torch.cuda.empty_cache()
    return rows


# the grouped K2 / K3 rows: granite-moe's dropless MoE at one 4096-token
# serve step, T x K = 4096 x 8 routed pairs over 40 experts (at most T an
# expert)
GROUPED_T, GROUPED_P = 4096, 4096 * 8


def grouped_counts(skewed: bool):
    """Rows of each of the 40 experts, summing to GROUPED_P: uniform (819
    or 820), or skewed: expert 0 all GROUPED_T tokens, expert 1 none, the
    other 38 a ramp from 100 up (ragged, every count at most GROUPED_T)."""
    if not skewed:
        return [GROUPED_P // MOE_E + (e < GROUPED_P % MOE_E)
                for e in range(MOE_E)]
    ramp = [int(v) for v in np.rint(np.linspace(100, 1409, MOE_E - 2))]
    ramp[-1] += GROUPED_P - GROUPED_T - sum(ramp)
    return [GROUPED_T, 0] + ramp


def grouped_gemm_rows(torch, timer):
    """K2 and K3 grouped over the routed pairs (quant_matmul_grouped,
    packed_matmul_grouped): granite-moe's wg (1536 x 512) and wd (512 x
    1536) over 40 experts at P = 32768 pairs, uniform and skewed counts
    (grouped_counts), fp32 and bf16 x, int8, int4 and int2.  Each row: the
    grouped launch's output on every group's rows equal bit for bit to the
    capacity launch's (the same pairs in an (E, 4096, K) buffer, C = T as
    dropless routing gives, one launch for all experts), within the plain
    version's tolerance, the same bits twice, one device launch a call;
    timed beside the capacity launch (its ms and device ms as
    ``capacity_*``).  The bound counts the pairs' 2 P K N operations
    (TF32 peak; bf16's for a bf16 x), x and y once and the stored weight
    once."""
    from repro_torch.kernels import ops, pack
    from repro_torch.kernels.ref import packed_matmul_ref, quant_matmul_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = []
    for skewed in (False, True):
        counts = grouped_counts(skewed)
        off = np.concatenate([[0], np.cumsum(counts)])
        offsets = torch.tensor(off, dtype=torch.int32, device="cuda")
        pair = torch.cat([e * GROUPED_T + torch.arange(n, device="cuda")
                          for e, n in enumerate(counts)])
        for x_dtype in (torch.float32, torch.bfloat16):
            for bits in (8, 4, 2):
                for site, K, N in (("wg", 1536, MOE_FF), ("wd", MOE_FF,
                                                          1536)):
                    lv = 2 ** (bits - 1) - 1
                    x = torch.randn(GROUPED_P, K, generator=g,
                                    device="cuda").to(x_dtype)
                    qv = torch.randint(-lv, lv + 1, (MOE_E, K, N),
                                       generator=g, device="cuda",
                                       dtype=torch.int8)
                    s = (torch.rand(MOE_E, N, generator=g, device="cuda") +
                         0.5) / (lv * math.sqrt(K))
                    xc = x.new_zeros((MOE_E * GROUPED_T, K))
                    xc[pair] = x
                    xc = xc.reshape(MOE_E, GROUPED_T, K)
                    if bits == 8:
                        w = qv
                        kern = lambda: ops.quant_matmul_grouped(
                            x, w, s, offsets, GROUPED_T)
                        cap = lambda: ops.quant_matmul(xc, w, s)
                        plain = lambda: quant_matmul_ref(xc, w, s)
                    else:
                        w = pack.pack_sub8(qv, bits, axis=-2)
                        kern = lambda: ops.packed_matmul_grouped(
                            x, w, s, offsets, GROUPED_T, store_bits=bits)
                        cap = lambda: ops.packed_matmul(xc, w, s,
                                                        store_bits=bits)
                        plain = lambda: packed_matmul_ref(xc, w, s, bits)
                    name = "quant_matmul" if bits == 8 else "packed_matmul"
                    dt = str(x_dtype).replace("torch.", "")
                    case = (f"int{bits}_grouped_moe_{site}_"
                            f"{'skewed' if skewed else 'uniform'}_{dt}")
                    what = f"{name}/{case}"
                    got, again = kern(), kern()
                    want = cap().reshape(MOE_E * GROUPED_T, N)[pair]
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{what}: two calls give "
                                             "different bits")
                    if not torch.equal(got, want):
                        bad = int((got != want).any(-1).sum())
                        raise AssertionError(f"{what}: {bad} rows differ "
                                             "from the capacity launch's")
                    bf16 = x_dtype == torch.bfloat16
                    err, rel = compare(
                        torch, got, plain().reshape(-1, N)[pair],
                        BF16_GEMM_TOL if bf16 else GEMM_TOL, what)
                    n_launch = graph_launches(torch, kern)
                    if n_launch != 1:
                        raise AssertionError(f"{what}: {n_launch} device "
                                             "launches a call, want 1")
                    nbytes = x.element_size() * GROUPED_P * (K + N) + \
                        w.numel() + 4 * MOE_E * N
                    b_ms, b_by = bound_ms(
                        nbytes, 2.0 * GROUPED_P * K * N,
                        "bf16" if bf16 else "tf32")
                    ms, cap_ms = timer.pair(kern, cap)
                    row = dict(
                        name=name, case=case,
                        shape=[MOE_E, GROUPED_P, K, N], x_dtype=dt,
                        counts="skewed" if skewed else "uniform",
                        max_rows=max(counts), empty_groups=counts.count(0),
                        bits_equal_capacity=True, max_abs_err=err,
                        max_rel_err=rel, launches_per_call=n_launch, ms=ms,
                        device_ms=timer.device(kern), capacity_ms=cap_ms,
                        capacity_device_ms=timer.device(cap),
                        bound_ms=b_ms, bound_by=b_by)
                    emit({"phase": "kernel", **row})
                    rows.append(row)
                    del x, xc, got, again, want
    torch.cuda.empty_cache()
    return rows


# one launch for a whole PackedWeight (mixed_gemm_rows): granite-4.0-h-
# small's sites at the benchmark's 384-row step, (label, experts or None,
# K, N, x and weight dtype); the experts' wg grouped over the 384 x 10
# routed pairs; shared.wg once more on a bf16 x against a bf16 store
MIXED_M, MIXED_PAIRS = 384, 3840
MIXED_SHAPES = [("w_out", None, 8192, 4096, "float32"),
                ("shared_wg", None, 4096, 1536, "float32"),
                ("experts_wg", 72, 4096, 768, "float32"),
                ("shared_wg_bf16", None, 4096, 1536, "bfloat16")]


def bench_channel_bits(n, seed):
    """The benchmark policy's split of an n-channel site: 64 channel groups
    with the QBNs POLICY_QBNS in turn, in a seeded order."""
    vals = np.asarray([POLICY_QBNS[i % len(POLICY_QBNS)] for i in range(64)])
    return np.repeat(np.random.default_rng(seed).permutation(vals), n // 64)


def mixed_gemm_rows(torch, timer):
    """One launch for a whole mixed-QBN PackedWeight (``packed_matmul.
    mixed_matmul``) against the per-bucket path (``ops.bucket_matmul``: a
    zero fill, one K2 / K3 launch a bucket and an ``index_copy_`` a
    bucket) at MIXED_SHAPES: w_out 384x8192x4096, shared.wg
    384x4096x1536 (fp32 x, and bf16 x against a store packed from bf16
    weights), and the experts' wg grouped over 3840 pairs of 72 experts
    (4096 x 768 each; seeded counts).  Each store splits its channels as
    the benchmark's policy does (bench_channel_bits); weights ~ N(0, 1 /
    K), so outputs are ~1.  Each row: the fused output equal bit for bit
    to the per-bucket path's and within GEMM_TOL (BF16_GEMM_TOL for a
    bf16 x) of the plain product, x @ w.dequant() in fp32 (each group's
    rows through grouped_ref for the experts), the same bits twice, one
    device launch a call (graph_launches; the per-bucket path's count
    beside it), both paths' event and device ms.  Bound: 2 M K N at the
    TF32 peak (bf16's for a bf16 x), or the bytes (x and y once, the
    stored weight once)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.kernels.packed_matmul import mixed_matmul
    from repro_torch.kernels.quant_matmul import grouped_ref
    from repro_torch.quant.linear_quant import quant_pack_sub8
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    rows = []
    for label, E, K, N, dt in MIXED_SHAPES:
        x_dtype = getattr(torch, dt)
        bf16 = x_dtype == torch.bfloat16
        bits = bench_channel_bits(N, SEED + len(rows))
        lead = (E,) if E else ()
        w = quant_pack_sub8((torch.randn(lead + (K, N), generator=g,
                                         device="cuda") /
                             math.sqrt(K)).to(x_dtype), bits)
        off, cap = None, None
        if E:
            counts = np.random.default_rng(SEED).multinomial(
                MIXED_PAIRS, np.full(E, 1.0 / E))
            off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                               dtype=torch.int32, device="cuda")
            cap, M = int(counts.max()), MIXED_PAIRS
        else:
            M = MIXED_M
        x = torch.randn(M, K, generator=g, device="cuda").to(x_dtype)
        fused = lambda: mixed_matmul(x, w, off)              # noqa: E731
        per = lambda: ops.bucket_matmul(x, w, off, cap)      # noqa: E731
        what = f"packed_matmul/mixed_{label}"
        got, again, want = fused(), fused(), per()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls give different bits")
        if not torch.equal(got, want):
            bad = int((got != want).any(-1).sum())
            raise AssertionError(f"{what}: {bad} rows differ from the "
                                 "per-bucket launches'")
        # the store's weight in fp32, as the kernels scale their sums
        deq = dataclasses.replace(w, out_dtype="float32").dequant()
        plain = lambda xb: xb.float() @ deq                  # noqa: E731
        err, rel = compare(torch, got,
                           grouped_ref(plain, x, off, cap) if E else
                           plain(x), BF16_GEMM_TOL if bf16 else GEMM_TOL,
                           what)
        del deq
        n_launch = graph_launches(torch, fused)
        if n_launch != 1:
            raise AssertionError(f"{what}: {n_launch} device launches a "
                                 "call, want 1")
        b_ms, b_by = bound_ms(x.element_size() * M * (K + N) +
                              w.hbm_bytes(), 2.0 * M * K * N,
                              "bf16" if bf16 else "tf32")
        ms, per_ms = timer.pair(fused, per)
        row = dict(
            name="packed_matmul", case=f"mixed_{label}",
            shape=[E or 1, M, K, N], x_dtype=dt,
            buckets={name: len(idx) for name, idx in w.buckets},
            bits_equal_per_bucket=True, max_abs_err=err, max_rel_err=rel,
            launches_per_call=n_launch,
            per_bucket_launches_per_call=graph_launches(torch, per), ms=ms,
            device_ms=timer.device(fused), per_bucket_ms=per_ms,
            per_bucket_device_ms=timer.device(per), bound_ms=b_ms,
            bound_by=b_by)
        emit({"phase": "kernel", **row})
        rows.append(row)
        del w, x, got, again, want
    torch.cuda.empty_cache()
    return rows


# K2 / K3 on a bf16 x, as a bf16 model's packed store calls them: (label,
# experts or None, rows, K, N)
BF16_GEMM_SHAPES = [("bf16_wg_decode", None, 2, 2304, 9216),
                    ("bf16_wg_prefill", None, 8320, 2304, 9216),
                    ("bf16_moe_wg_c1024", MOE_E, 1024, 1536, MOE_FF),
                    # the bf16 families (phase bf16-families): mamba2-780m
                    # at its 2 x 2048 prefill and decode, the jamba
                    # hybrid's w_xz at HYBRID_CUT at run()'s longest
                    # prompt and 4-slot decode, vision's wg at its
                    # 2 x 2048 prefill and decode
                    ("bf16_mamba_wxz_prefill", None, 4096, 1536, 6144),
                    ("bf16_mamba_wxz_decode", None, 2, 1536, 6144),
                    ("bf16_mamba_wout_prefill", None, 4096, 3072, 1536),
                    ("bf16_mamba_wout_decode", None, 2, 3072, 1536),
                    ("bf16_hybrid_wxz_prefill", None, 1024, 2048, 8192),
                    ("bf16_hybrid_wxz_decode", None, 4, 2048, 8192),
                    ("bf16_vision_wg_prefill", None, 4096, 8192, 28672),
                    ("bf16_vision_wg_decode", None, 2, 8192, 28672)]


def bf16_gemm_rows(torch, timer):
    """K2 (int8) and K3 (int4, int2) on a bf16 x with a bf16 output, as a
    bf16 model's packed store calls them: gemma2-2b's wg at generate's
    decode (2 rows) and prefill (8320), granite-moe's expert-batched wg
    (40 experts x 1024 rows x 1536 x 512, one launch), and the bf16
    families' mamba w_xz / w_out, jamba w_xz and vision wg at prefill
    (tensor cores) and decode (skinny) (_gemm_row)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [_gemm_row(torch, timer, g, n_sm, bits, *shape,
                      x_dtype=torch.bfloat16)
            for bits in (8, 4, 2) for shape in BF16_GEMM_SHAPES]
    torch.cuda.empty_cache()
    return rows


def _twice_same(torch, kern, what):
    """Two calls of ``kern`` on the same inputs: the same bits, one
    wrapper launch each; returns the first output."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    got = kern()
    again = kern()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls on the same inputs give "
                             "different bits")
    if sum(counts.values()) != 2:
        raise AssertionError(f"{what}: wrapper launches {counts} for two "
                             "calls")
    return got


def bf16_search_kernel_rows(torch, timer):
    """B5 and B6 on a bf16 x, as a bf16 CNN's evaluators and a bf16 LM's
    QUANT evaluator call them: B5 at CIF10's conv5 weight and gemma2-2b's
    stacked wg and unembed, bit for bit its plain version; B6 at CIF10's
    conv0, conv1 and conv5 im2col products and the fc (P 8), within one
    bf16 ulp of its plain version (BF16_GEMM_TOL: the two sum the same
    exact fp32 products in other orders and round once).  Each row: output
    bf16, the same bits on a second call, one wrapper launch a call, and
    the device launches of a call counted exactly (graph_launches): 1 for
    B5; 2 for B6, its fold and its product.  Bounds count bf16 bytes for
    x and y.  B5's operations are fp32 on CUDA cores.  B6's bound counts
    2 P M K N operations at the bf16 tensor peak: x and the +-1 planes are
    exact in bf16, so each plane's product could run on bf16 tensor cores
    with fp32 sums, the reference's own arithmetic; its route_bound_ms is
    the folded product's 2 M K N at the fp32 CUDA-core peak, the route
    this kernel takes.  B6's library call is cuBLAS bf16 on the
    reconstructed weight rounded to bf16."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import binary_matmul_ref, fake_quant_ref
    cfg = ARCHS[ARCH].config
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    bf16 = torch.bfloat16
    rows = []
    for label, M, N in (("cif10_conv5_bf16", 9 * 128, 128),
                        ("gemma2_wg_stack_bf16", cfg.n_repeat * cfg.d_model,
                         cfg.d_ff),
                        ("gemma2_unembed_bf16", cfg.d_model,
                         cfg.vocab_padded)):
        x, sc, lv, bits = _fq_inputs(torch, g, M, N, bf16)
        kern = lambda: ops.fake_quant_channels(x, sc, lv, bits)
        plain = lambda: fake_quant_ref(x, sc, lv, bits)
        what = f"fake_quant/{label}"
        got = _twice_same(torch, kern, what)
        want = plain()
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != bf16 or not torch.equal(got, want):
            raise AssertionError(f"{what}: {got.dtype} output differs from "
                                 f"its plain version (max abs err {err})")
        n_launch = graph_launches(torch, kern)
        if n_launch != 1:
            raise AssertionError(f"{what}: {n_launch} device launches a "
                                 "call, want 1")
        b_ms, b_by = bound_ms(2 * 2 * M * N + 4 * 3 * N, 5.0 * M * N)
        rows.append(dict(
            name="fake_quant", case=label, shape=[M, N], x_dtype="bfloat16",
            route="cuda_rows", route_bound_ms=b_ms, max_abs_err=err,
            max_rel_err=0.0, tol="bitwise", launches_per_call=1,
            device_launches_per_call=n_launch, ms=timer(kern),
            plain_ms=timer(plain), library_ms=None, library_note=FQ_NOTE,
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del x, got, want
    torch.cuda.empty_cache()
    for label, M, K, N, P in (("cif10_conv0_im2col_bf16", 512 * 32 * 32,
                               9 * 3, 32, 8),
                              ("cif10_conv1_im2col_bf16", 512 * 32 * 32,
                               9 * 32, 32, 8),
                              ("cif10_conv5_im2col_bf16", 512 * 8 * 8,
                               9 * 128, 128, 8),
                              ("cif10_fc_bf16", 512, 128, 10, 8)):
        x = torch.randn((M, K), generator=g, device="cuda").to(bf16)
        planes = (torch.randint(0, 2, (P, K, N), generator=g, device="cuda")
                  * 2 - 1).to(torch.int8)
        alpha = torch.rand((P, N), generator=g, device="cuda") / math.sqrt(K)
        kern = lambda: ops.binary_matmul(x, planes, alpha)
        plain = lambda: binary_matmul_ref(x, planes, alpha)
        what = f"binary_matmul/{label}"
        got = _twice_same(torch, kern, what)
        if got.dtype != bf16:
            raise AssertionError(f"{what}: output {got.dtype}, x bf16")
        err, rel = compare(torch, got, plain(), BF16_GEMM_TOL, what)
        n_launch = graph_launches(torch, kern)
        if n_launch != 2:
            raise AssertionError(f"{what}: {n_launch} device launches a "
                                 "call, want 2 (fold, product)")
        w_hat = (alpha[:, None, :] * planes.float()).sum(0).to(bf16)
        lib = lambda: torch.matmul(x, w_hat)
        nbytes = 2 * (M * K + M * N) + 4 * P * N + P * K * N
        b_ms, b_by = bound_ms(nbytes, 2.0 * P * M * K * N, "bf16")
        r_ms, _ = bound_ms(nbytes, 2.0 * M * K * N)
        ms, lib_ms = timer.pair(kern, lib)
        rows.append(dict(
            name="binary_matmul", case=label, shape=[M, K, N, P],
            x_dtype="bfloat16", route="cuda_fold_fp32", route_bound_ms=r_ms,
            max_abs_err=err, max_rel_err=rel, tol=BF16_GEMM_TOL,
            launches_per_call=1, device_launches_per_call=n_launch, ms=ms,
            plain_ms=timer(plain), library_ms=lib_ms,
            library_device_ms=timer.device(lib),
            device_ms=timer.device(kern), bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", **rows[-1]})
        del x, planes, got, w_hat
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
               n_new=N_NEW, profile=False, cache_dtype=None, warm=False):
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
    if warm:                     # the process's first calls at these shapes
        eng.generate(tokens, n_new)
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
    from repro_torch.models.layers import StepLayout
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
                eng.params, t, StepLayout.of(p, bt, torch.zeros(
                    1, dtype=torch.int32, device="cuda")),
                pool, torch.full((1,), c - 1, dtype=torch.int32,
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


def _compact_inputs(torch, model, n_chunk):
    """(tokens, positions, tables, logit_cols, pool, real counts per row)
    of compact_step_gate's step: row 0 a prompt chunk of COMPACT_W that
    continues at position 768, row 1 a fresh chunk of ``n_chunk``, the
    others decode lanes at 1000, 1064, ...; the pool holds each row's
    earlier positions in its own pages (random K/V) and random mamba
    state and windows."""
    R, W, NB = COMPACT_R, COMPACT_W, COMPACT_NB
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    starts = [768, 0] + [1000 + 64 * i for i in range(R - 2)]
    lens = [W, n_chunk] + [1] * (R - 2)
    pos = torch.full((R, W), SENT, dtype=torch.int32)
    for r, (s0, c) in enumerate(zip(starts, lens)):
        pos[r, :c] = torch.arange(s0, s0 + c)
    tables = (1 + torch.arange(R)[:, None] * NB +
              torch.arange(NB)[None]).to(torch.int32)
    pool = model.init_paged_cache(R, 1 + R * NB, PAGE, dtype=torch.float32,
                                  device="cuda")
    logical = torch.arange(NB * PAGE, dtype=torch.int32)
    for entry in pool:
        for key, t in entry.items():
            if key != "pos":
                t.normal_(generator=g)
        if "pos" in entry:
            for r, s0 in enumerate(starts):
                p = logical[:s0]
                entry["pos"][:, tables[r, p // PAGE].long().cuda(),
                             (p % PAGE).long().cuda()] = p.cuda()
    toks = torch.randint(0, model.cfg.vocab, (R, W), generator=g,
                         device="cuda")
    cols = torch.tensor([c - 1 for c in lens], dtype=torch.int32)
    return toks, pos, tables.cuda(), cols.cuda(), pool, lens


def compact_step_gate(torch, label, eng, n_chunk=80):
    """One token-budget step at the serving benchmark's 16 x 256 shape
    through ``LM.model_step``, over the whole grid (padded) and compacted
    (the layout of ``LM.step_layout``: the real cells on a rung of the
    ladder), on two copies of one pool, activations unquantized as the
    benchmark serves them.  Every real row's logits and every pool plane
    (the trash page aside: sentinel cells write there) within
    COMPACT_TOL; prints whether each is bit-equal and its largest
    difference.  Returns (record, problems)."""
    model, params = eng.model, eng.params
    toks, pos, tables, cols, pool, lens = _compact_inputs(torch, model,
                                                          n_chunk)
    layout = model.step_layout(pos.numpy(), np.arange(COMPACT_R),
                               tables.cpu().numpy())
    cells = layout.cells
    problems = []
    if cells is None:
        return {}, [f"{label} compact step: {sum(lens)} real cells of "
                    f"{pos.numel()} did not compact"]
    pool_c = tuple({k: t.clone() for k, t in e.items()} for e in pool)
    with torch.no_grad():
        want, pool = model.model_step(
            params, toks, layout._replace(cells=None).upload("cuda"), pool,
            cols, None, attn_impl=eng.attn_impl)
        got, pool_c = model.model_step(
            params, toks, layout.upload("cuda"), pool_c, cols, None,
            attn_impl=eng.attn_impl)
    torch.cuda.synchronize()
    pairs = {"logits": (got, want)}
    for i, (a, b) in enumerate(zip(pool, pool_c)):
        for key in a:
            pairs[f"pool{i}.{key}"] = (b[key], a[key]) if key in (
                "state", "conv") else (b[key][:, 1:], a[key][:, 1:])
    diffs = {}
    for name, (x, y) in pairs.items():
        d = (x.double() - y.double()).abs()
        diffs[name] = dict(equal=bool(torch.equal(x, y)),
                           max_abs=float(d.max()))
        if not torch.allclose(x.double(), y.double(), **COMPACT_TOL):
            problems.append(f"{label} compact step: {name} {diffs[name]}")
    rec = dict(real=sum(lens), grid=pos.numel(), rows=len(cells),
               tol=COMPACT_TOL, all_equal=all(
                   v["equal"] for v in diffs.values()),
               logits=diffs["logits"],
               worst_pool=max((v["max_abs"], k) for k, v in diffs.items()
                              if k != "logits"),
               unequal=sorted(k for k, v in diffs.items()
                              if not v["equal"]))
    emit({"phase": f"{label}-compact-step", **rec, "problems": problems})
    del pool, pool_c
    torch.cuda.empty_cache()
    return rec, problems


def step_shapes(n_slots: int, width: int) -> int:
    """The most ``model_step`` shapes (``trace_counts``) a chunked run at
    ``n_slots`` x ``width`` makes: one at width 1, and at the wide width
    one a rung of the compacted step's ladder below the grid plus the
    grid itself."""
    from repro_torch.models.transformer import compact_rows
    wide = n_slots * width
    return 1 + len({min(compact_rows(n), wide) for n in range(1, wide + 1)})


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
    if eng.trace_counts["model_step"] > step_shapes(RUN_SLOTS, CHUNK):
        problems.append(f"run: model_step saw {eng.trace_counts} shapes")
    compact, compact_problems = compact_step_gate(torch, "run", eng)
    problems += compact_problems
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
                 trace_counts=dict(eng.trace_counts), compact_step=compact,
                 problems=problems)
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
def _moe_gemm_launches(graph, policy, cfg, calls, prefills=(), skip=()):
    """K2 and K3 launches of ``calls`` model calls on the packed store of
    ``policy`` for a model of config ``cfg``.  ``prefills`` holds the
    tokens T of each call among them that prefills; the others decode at
    most SKINNY_M rows.  A site whose product has more rows than
    SKINNY_M (T, or for an expert stack the capacity layout's rows
    ``layers.moe_capacity``, grouped or not) is one mixed launch for all
    its buckets (``packed_matmul.mixed_matmul``, K3's count) unless it has
    a bf16 ``full`` bucket; otherwise one launch per non-empty int8 bucket
    (K2) and per non-empty int2 / int4 bucket (K3) (an expert site's
    buckets are shared by its E experts: one launch each, not E).  The
    unembedding runs once a call on the last position of each batch row,
    at most SKINNY_M rows here.  The sites named in ``skip`` are left out.
    Returns ({kernel: launches}, {site: [buckets]})."""
    from repro_torch.kernels.pack import bucket_of_bits
    from repro_torch.kernels.quant_matmul import SKINNY_M
    from repro_torch.models.layers import moe_capacity
    k2 = k3 = 0
    sites = {}
    for l in graph.layers:
        if l.name in skip:
            continue
        buckets = {bucket_of_bits(b) for b in policy.expand_weight_bits(l)}
        names = sorted(buckets - {"pruned", "full"})
        sites[l.name] = names
        reps = 1 if l.kind == "unembed" else cfg.n_repeat
        per_bucket = (reps * ("int8" in names),
                      reps * sum(n in ("int2", "int4") for n in names))
        for T in [None] * (calls - len(prefills)) + list(prefills):
            rows = 0 if T is None or l.kind == "unembed" else \
                moe_capacity(T, cfg.moe.n_experts, cfg.moe.top_k,
                             cfg.moe.capacity_factor) \
                if l.kind == "expert" else T
            if rows > SKINNY_M and "full" not in buckets:
                k3 += reps
            else:
                k2, k3 = k2 + per_bucket[0], k3 + per_bucket[1]
    return dict(quant_matmul=k2, packed_matmul=k3), sites


def _dispatch_bits(torch, eng, tokens, label):
    """``eng.generate(tokens, 2)`` with the experts in the layout
    ``layers._grouped_applies`` picks (grouped, at a 2 x 2048 prefill on
    the packed store), then with that choice patched to the capacity
    layout: the prefill logits and the tokens must be the same bits, the
    first call must have taken the grouped launches and the second none.
    Returns the record and its problems."""
    from repro_torch import kernels
    from repro_torch.models import layers

    def generate():
        kernels.reset_launch_counts()
        out = eng.generate(tokens, 2)
        routes = kernels.launch_routes()
        return out, sum(n for name in ("quant_matmul", "packed_matmul")
                        for r, n in routes[name].items()
                        if r.startswith("grouped_"))

    grouped, n_grouped = generate()
    applies = layers._grouped_applies
    layers._grouped_applies = lambda *a: False
    try:
        capacity, n_capacity = generate()
    finally:
        layers._grouped_applies = applies
    same = bool(torch.equal(grouped["prefill_logits"],
                            capacity["prefill_logits"])) and \
        np.array_equal(grouped["tokens"], capacity["tokens"])
    rec = dict(phase="moe-dispatch-bits", engine=label,
               grouped_launches=n_grouped, capacity_run_grouped_launches=
               n_capacity, logits_and_tokens_equal=same)
    emit(rec)
    problems = []
    if not same:
        problems.append(f"{label}: grouped and capacity dispatch differ")
    if not n_grouped or n_capacity:
        problems.append(f"{label}: grouped launches {n_grouped} / "
                        f"{n_capacity}")
    return rec, problems


def _grouped_sync_check(torch, cfg, eng):
    """One grouped ``_moe_ffn_impl`` call on the first layer of ``eng``'s
    packed store at a 4096-token step under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync raises."""
    from repro_torch.kernels.pack import PackedWeight
    from repro_torch.models import layers
    blk = eng.params["blocks"][0]
    p = {k: blk[k].take(0) if isinstance(blk[k], PackedWeight) else blk[k][0]
         for k in ("router", "wg", "wu", "wd")}
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x = torch.randn(GROUPED_T, cfg.d_model, generator=g, device="cuda")
    kw = dict(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
              capacity_factor=cfg.moe.capacity_factor, act_bits=None)
    C = layers.moe_capacity(GROUPED_T, cfg.moe.n_experts, cfg.moe.top_k,
                            cfg.moe.capacity_factor)
    if not layers._grouped_applies(x, p, C, 1):
        raise AssertionError("moe sync check: the call is not grouped")
    layers._moe_ffn_impl(x, p, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        layers._moe_ffn_impl(x, p, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "moe-grouped-syncs", "host_syncs": 0,
          "capacity_factor": cfg.moe.capacity_factor})


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
      prefill s, decode tok/s, TTFT, host syncs (none allowed), launches;
      then generate through the grouped and the capacity dispatch, the
      same bits (_dispatch_bits), and a grouped MoE call without a host
      sync (_grouped_sync_check).  A capacity-limited MoE never compacts
      a step: one model_step shape a width.
    * the same run at capacity factor 0 (no token dropped, the reference's
      smoke setting): each stream against its own generate by the gap
      rule, as the dense run phase holds them, the two dispatches
      dropless (_dispatch_bits), and the compacted 16 x 256 step against
      the whole grid's (compact_step_gate).  At 1.25 a token's drop
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
    want, sites = _moe_gemm_launches(graph, policy, cfg, 1 + N_NEW,
                                     (tokens.size,))
    got = {k: a_rec["launches"][k] for k in want}
    if got != want:
        problems.append(f"moe generate: GEMM launches {got}, want {want} "
                        "(one a site on the tensor cores, else a bucket)")
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
    if eng.trace_counts["model_step"] > 2:   # capacity-limited: whole grid
        problems.append(f"moe run: a compacted step at capacity factor "
                        f"1.25 ({eng.trace_counts})")
    bits, bits_problems = _dispatch_bits(torch, eng, tokens, "moe-cf1.25")
    problems += bits_problems
    _grouped_sync_check(torch, cfg, eng)
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
    bits0, bits_problems = _dispatch_bits(torch, eng, tokens, "moe-cf0")
    problems += bits_problems
    compact, compact_problems = compact_step_gate(torch, "moe-cf0", eng)
    problems += compact_problems
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(init=init, engine_a=a_rec, engine_b=b_rec,
               check=check, check_act_off=check0,
               gemm_launches=dict(got=got, want=want),
               run=run, run_cf0=run0, dispatch_bits=[bits, bits0],
               compact_step=compact,
               profile=prof,
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


def _gemm_check(problems, what, launches, graph, policy, cfg, calls,
                prefills):
    """K2 / K3 launches of ``calls`` model calls, ``prefills`` the tokens
    of those that prefill, against the exact count of _moe_gemm_launches
    (one a site and repeat on the tensor-core route, else one a bucket)."""
    want, _ = _moe_gemm_launches(graph, policy, cfg, calls, prefills)
    got = {k: launches[k] for k in want}
    if got != want:
        problems.append(f"{what}: GEMM launches {got}, want {want} (one a "
                        "site on the tensor cores, else one a bucket)")
    return want


def _fp64_floor(torch, model, params, graph, policy, tokens, batch=None,
                tail=1, keep_a=False):
    """The noise floor of ``model`` at fp32 under ``policy``'s weights,
    activation quantization off: the full forward (``LM.apply``, every
    position of ``tokens``, or of ``batch``'s inputs) of the fake store in
    fp32 (B) and in fp64 (F: every step of the port's plain path then runs
    in fp64, the batch's embeddings too), and of the packed store on the
    kernels (A).  Returns |A - F| and |B - F| over the real vocabulary
    (mean, max, max at the last position, whose logits generate's prefill
    returns, and max over the last ``tail`` positions), F's standard
    deviation, and with ``keep_a`` A's logits at those positions
    (``a_tail``, on the host)."""
    from repro_torch.core.ddpg import tree_map
    from repro_torch.quant.apply import (apply_policy_packed,
                                         apply_policy_to_params)
    V = model.cfg.vocab
    if batch is None:
        batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    with torch.no_grad():
        fake = apply_policy_to_params(params, graph, policy)
        lb = model.apply(fake, batch)[0][..., :V]
        lf = model.apply(tree_map(lambda t: t.double(), fake),
                         b64)[0][..., :V]
        del fake, b64
        la = model.apply(apply_policy_packed(params, graph, policy),
                         batch, attn_impl="cuda")[0][..., :V]
    out = dict(fp64_logit_std=float(lf.std()))
    for name, lg in (("a", la), ("b", lb)):
        e = (lg.double() - lf).abs()
        out.update({f"{name}_mean": float(e.mean()),
                    f"{name}_max": float(e.max()),
                    f"{name}_last_max": float(e[:, -1].max()),
                    f"{name}_tail_max": float(e[:, -tail:].max())})
        del e
    if keep_a:
        out["a_tail"] = la[:, -tail:].float().cpu()
    del la, lb, lf
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _state_run(torch, label, eng, reqs, graph, policy, problems,
               tol=ACT_LOGIT_ATOL):
    """``eng.run(reqs, prefill="monolithic")`` on a pattern with recurrent
    state: speculative runs and speculative open-loop serving refused
    before any model call; each stream of the monolithic run held to its
    own ``generate`` by the gap rule (the chunked path, ``run()``'s
    default, is the benchmark's ``granite-h-chat``); K1 once per
    attention layer and admission (generate: and model call), K4 once
    per attention layer and decode step, K2 / K3 exactly as
    _moe_gemm_launches counts them (one launch a site of a prefill, one a
    bucket of a decode step's), in the run and in the generates.  Returns
    the run record."""
    from repro_torch import kernels
    from repro_torch.serve import FrontEnd
    cfg = eng.model.cfg
    na = _attn_layers(cfg)
    kw = dict(page_size=PAGE, max_slots=RUN_SLOTS)
    for bad in ("run", "serve"):
        kernels.reset_launch_counts()
        calls = dict(eng.call_counts)
        try:
            if bad == "serve":
                eng.serve(FrontEnd(), **kw, speculative=True)
            else:
                eng.run(reqs, **kw, speculative=True)
            problems.append(f"{label}: speculative {bad} did not raise")
        except ValueError:
            pass
        if dict(eng.call_counts) != calls or \
                any(kernels.launch_counts().values()):
            problems.append(f"{label}: speculative {bad} called the "
                            "model before raising")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs, **kw, prefill="monolithic")
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
    prefills = [len(t) for t, _ in reqs]
    rec["gemm_want"] = _gemm_check(problems, label, lr, graph, policy, cfg,
                                   len(reqs) + st.steps, prefills)
    kernels.reset_launch_counts()
    gens = []
    for toks, n_new in reqs:
        out = eng.generate(toks[None], n_new)
        gens.append((out["tokens"][0], out["top2_gap"][:, 0]))
    gl = kernels.launch_counts()
    calls = sum(1 + n for _, n in reqs)
    if gl["flash_attention"] != na * calls or gl["paged_attention"]:
        problems.append(f"{label}: generate attention launches {gl}")
    _gemm_check(problems, label + " generate", gl, graph, policy, cfg,
                calls, prefills)
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
      attention layer) and K2 / K3 exactly as _moe_gemm_launches counts
      w_xz, w_bc, w_out and the unembedding; then engine A against
      engine B (fake store, plain versions) with activation quantization
      off: prefill logits and streams by check_serve's rules at
      LOGIT_ATOL plus twice B's distance from F at the last position (two
      fp32 evaluations each that close to F).
    * activation QBN 8 held on the first SSM_GATE_LAYERS layers (the same
      weights, a policy of their own): the A / B pair by check_serve's
      rules at ACT_LOGIT_ATOL, run() on 8 requests (prompts 2048 ...
      17) against generate by _state_run's rules, and the compacted 16 x
      256 step against the whole grid's (compact_step_gate).
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
      model call, K2 / K3 exactly as _moe_gemm_launches counts them, the
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
    want = _gemm_check(problems, "ssm generate", la, graph, policy, cfg,
                       1 + N_NEW, (tokens.size,))
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
                ggraph, gpolicy, gcfg, 1 + N_NEW, (tokens.size,))
    del ga, gb
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in zip(MOE_RUN_PROMPTS, MOE_RUN_NEW)]
    geng = ServeEngine(gmodel, gparams, policy=gpolicy, max_len=SSM_MAX_LEN,
                       weight_store="packed", attn_impl="cuda",
                       device="cuda")
    gate_run = _state_run(torch, "ssm-gate-run", geng, reqs, ggraph,
                          gpolicy, problems)
    gate_run["compact_step"], compact_problems = compact_step_gate(
        torch, "ssm-gate", geng)
    problems += compact_problems
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
            g[k]["calls"] for m, _, k in GEMM_ROUTES if m == n))
            for n in ("quant_matmul", "packed_matmul")},
        prefill_device_ms=pre["device_ms"],
        prefill_launches=pre["kernel_launches"],
        prefill_gemm_launches=pre["gemm_launches"],
        ssd_ms=ssd["ms"], ssd_launches=ssd["calls"],
        ssd_share_of_prefill=ssd["ms"] / max(pre["device_ms"], 1e-9),
        prefill_gemm_ms={k: pre["groups"][k]["ms"] for k in GEMM_MS_GROUPS},
        gemm_ms={k: g[k]["ms"] for k in GEMM_MS_GROUPS},
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
        hcfg, 1 + N_NEW, (htokens.size,))
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


# ------------------------------------------------------------- phase 6b
def _store_bytes(params) -> int:
    """Stored weight bytes: a PackedWeight's buffers and scales, every
    other leaf as it is."""
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.kernels.pack import PackedWeight
    return int(sum(l.hbm_bytes() if isinstance(l, PackedWeight)
                   else l.numel() * l.element_size()
                   for l in tree_leaves(params)))


def lm_stream(torch, label, model, params, batch, n_new, *, impl,
              act_bits=None, cache_dtype=None, feed=None):
    """``LM.prefill`` of ``batch`` over a fresh dense cache, then ``n_new``
    ``LM.decode_step`` calls, as ``ServeEngine.generate`` runs them (the
    engine takes token prompts only, so these families are driven
    through the model's own entry points): step i's input is
    ``feed(i, token)`` (a teacher-forced frame) or the greedy token.
    Returns check_serve's record (prefill logits, the greedy token of
    every step's logits and its top-2 gap, launches) with every step's
    logits over the real vocabulary (``steps``, (B, 1 + n_new, V), on the
    host), times and the peak memory."""
    from repro_torch import kernels
    cfg = model.cfg
    x0 = batch["embeds"] if "embeds" in batch else batch["tokens"]
    Bn, S = x0.shape[:2]
    dt = cache_dtype or torch.float32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(Bn, S + n_new, dtype=dt, device="cuda")
    kernels.reset_launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache, act_bits,
                                      attn_impl=impl)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        steps, toks, gaps = [logits[:, -1, :cfg.vocab].float()], [], []
        t0 = time.perf_counter()
        for i in range(n_new):
            top2 = torch.topk(steps[-1], 2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            cur = torch.argmax(steps[-1], dim=-1)
            toks.append(cur)
            x = feed(i, cur) if feed is not None else cur[:, None]
            logits, cache = model.decode_step(params, x, cache, S + i,
                                              act_bits, attn_impl=impl)
            steps.append(logits[:, -1, :cfg.vocab].float())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    rec = dict(engine=label, attn_impl=impl, act_bits=act_bits is not None,
               cache_dtype=str(dt).replace("torch.", ""), batch=Bn,
               prompt=S, n_new=n_new, prefill_s=prefill_s,
               decode_s=decode_s, decode_per_s=Bn * n_new / decode_s,
               peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
               weight_bytes=_store_bytes(params),
               launches=kernels.launch_counts())
    emit({"phase": "frontend-stream", **rec})
    out = dict(rec=rec, logits=steps[0].cpu(),
               tokens=torch.stack(toks, 1).cpu().numpy(),
               gaps=torch.stack(gaps).cpu().numpy(),
               steps=torch.stack(steps, 1).cpu())
    del cache, steps, logits
    return out


def _steps_apart(a, b):
    """Max |A - B| over the step logits two streams share: every step
    while their tokens agree, up to and including the first step whose
    logits chose different tokens (later inputs differ)."""
    bad = np.flatnonzero((a["tokens"] != b["tokens"]).any(axis=0))
    n = int(bad[0]) + 1 if bad.size else a["steps"].shape[1]
    return float((a["steps"][:, :n] - b["steps"][:, :n]).abs().max())


def _fp64_last_logits(torch, model, params, batch):
    """The last position's logits of ``LM.apply`` evaluated in fp64 (F),
    one block's weights converted at a time: a whole fp64 copy of a
    5-layer llama-3.2-vision period (51.7 GB) does not fit beside its two
    stores.  The same blocks, in the same order, as ``LM._stack``."""
    from repro_torch.core.ddpg import tree_map
    from repro_torch.models.transformer import _repeat
    cfg = model.cfg
    d64 = lambda t: tree_map(lambda a: a.double(), t)  # noqa: E731
    with torch.no_grad():
        x = model._embed(params, batch).double()
        Bn, S, _ = x.shape
        q_pos = torch.arange(S, dtype=torch.int32,
                             device=x.device).repeat(Bn, 1)
        img = batch.get("img_embeds")
        img = None if img is None else img.double()
        for r in range(cfg.n_repeat):
            for p_idx, bdef in enumerate(cfg.pattern):
                bp = d64(_repeat(params["blocks"][p_idx], r))
                x, _ = model._apply_block(bp, bdef, x, q_pos=q_pos,
                                          mode="train", cache=None,
                                          img_embeds=img)
                del bp
        head = {"final_norm": params["final_norm"].double(),
                "unembed": params["unembed"].double()}
        lf = model.logits_of(head, x[:, -1:])[:, 0, :cfg.vocab]
        del head, x
    gc.collect()
    torch.cuda.empty_cache()
    return lf


def _audio_frontend(torch, problems):
    """musicgen-large at published width and depth, random fp32 weights
    from SEED and the seeded policy: the fp64 floor over all 2064 frames;
    engine A (packed store, kernels) against engine B (fake store, plain
    versions), activation quantization off, prefill of 2 x 2048 frames
    and 16 teacher-forced decode steps, every step's logits within the
    floor's tolerance of B's and of A's own full forward, the argmax
    streams by check_serve's rules (K1 once a layer a call), K2 / K3
    exactly as _moe_gemm_launches counts them; activation QBN 8
    held on the first FE_GATE_LAYERS layers; weight bytes, one profiled
    prefill + decode step (busy share)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.models import LM
    from repro_torch.quant.apply import (apply_policy_packed,
                                         apply_policy_to_params)
    cfg = ARCHS[AUDIO_ARCH].config
    model = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    init = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                vocab=cfg.vocab, frontend=cfg.frontend,
                seconds=time.perf_counter() - t0,
                parameters=int(sum(t.numel() for t in tree_leaves(params))),
                param_bytes=_param_bytes(params))
    emit({"phase": "audio-init", **init})
    peaks = [int(torch.cuda.max_memory_allocated())]
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    frames = FE_SCALE * torch.randn((B, FE_MAX_LEN, cfg.d_model),
                                    generator=g, device="cuda")
    prompt = {"embeds": frames[:, :FE_PROMPT]}
    feed = lambda i, cur: frames[:, FE_PROMPT + i:FE_PROMPT + i + 1]  # noqa
    floor = _fp64_floor(torch, model, params, graph, policy, None,
                        batch={"embeds": frames}, tail=N_NEW + 1,
                        keep_a=True)
    a_full = floor.pop("a_tail")
    tol = LOGIT_ATOL + 2 * floor["b_tail_max"]
    floor["act_off_tol"] = tol
    emit({"phase": "audio-floor", **floor})
    if floor["a_mean"] > floor["b_mean"] + LOGIT_ATOL:
        problems.append(f"audio: the kernels' forward is farther from fp64 "
                        f"than the plain one: {floor}")
    pa = apply_policy_packed(params, graph, policy)
    pb = apply_policy_to_params(params, graph, policy)
    a = lm_stream(torch, "audio-A0", model, pa, prompt, N_NEW, impl="cuda",
                  feed=feed)
    b = lm_stream(torch, "audio-B0", model, pb, prompt, N_NEW, impl="ref",
                  feed=feed)
    peaks += [a["rec"]["peak_mem_bytes"], b["rec"]["peak_mem_bytes"]]
    check = check_serve(torch, a, b, tol, cfg.n_layers, cfg.vocab)
    problems += check["problems"]
    check["steps_max_abs_diff"] = float((a["steps"] - b["steps"]).abs().max())
    check["a_vs_own_apply_max_abs_diff"] = float(
        (a["steps"] - a_full).abs().max())
    for key in ("steps_max_abs_diff", "a_vs_own_apply_max_abs_diff"):
        if check[key] > tol:
            problems.append(f"audio: {key} {check[key]} > {tol}")
    check["gemm_want"] = _gemm_check(problems, "audio generate",
                                     a["rec"]["launches"], graph, policy,
                                     cfg, 1 + N_NEW, (B * FE_PROMPT,))
    emit({"phase": "audio-check", **{k: check[k] for k in (
        "steps_max_abs_diff", "a_vs_own_apply_max_abs_diff", "gemm_want")}})
    a_rec = a["rec"]
    del a, b, pb, a_full
    gc.collect()
    # activation QBN 8 where the pair has not parted yet
    gcfg = dataclasses.replace(cfg, n_layers=FE_GATE_LAYERS)
    gmodel = LM(gcfg)
    gparams = model.draft_prefix_params(params, FE_GATE_LAYERS)
    ggraph = gmodel.graph(seq_len=1, batch=1)
    gpolicy = make_policy(ggraph)
    bits = gmodel.block_act_bits(ggraph, [gpolicy.act_bits[l.name]
                                          for l in ggraph.layers])
    ga = lm_stream(torch, "audio-gate-A", gmodel,
                   apply_policy_packed(gparams, ggraph, gpolicy), prompt,
                   N_NEW, impl="cuda", act_bits=bits, feed=feed)
    gb = lm_stream(torch, "audio-gate-B", gmodel,
                   apply_policy_to_params(gparams, ggraph, gpolicy), prompt,
                   N_NEW, impl="ref", act_bits=bits, feed=feed)
    gate = check_serve(torch, ga, gb, ACT_LOGIT_ATOL, FE_GATE_LAYERS,
                       cfg.vocab)
    gate["steps_max_abs_diff"] = float((ga["steps"] - gb["steps"]
                                        ).abs().max())
    if gate["steps_max_abs_diff"] > ACT_LOGIT_ATOL:
        gate["problems"].append(f"audio gate: step logits "
                                f"{gate['steps_max_abs_diff']} apart")
    problems += gate["problems"]
    _gemm_check(problems, "audio-gate generate", ga["rec"]["launches"],
                ggraph, gpolicy, gcfg, 1 + N_NEW, (B * FE_PROMPT,))
    del ga, gb, gparams
    gc.collect()

    def prefill_and_step():
        c = model.init_cache(B, FE_PROMPT + 1, dtype=torch.float32,
                             device="cuda")
        with torch.no_grad():
            model.prefill(pa, prompt, c, attn_impl="cuda")
            model.decode_step(pa, feed(0, None), c, FE_PROMPT,
                              attn_impl="cuda")

    prefill_and_step()
    prof = profile_call(torch, prefill_and_step)
    where = dict(device_ms=prof["device_ms"], wall_s=prof["wall_s"],
                 busy_share=prof["busy_share"],
                 kernel_launches=prof["kernel_launches"],
                 groups={k: v for k, v in prof["groups"].items()
                         if v["calls"]}, top=prof["top"])
    emit({"phase": "audio-profile", **where})
    rec = dict(init=init, floor=floor, engine_a=a_rec, check=check,
               gate=gate, profile=where,
               weight_bytes=dict(packed=_store_bytes(pa),
                                 fp32=init["param_bytes"]),
               peak_mem_bytes=max(peaks))
    emit({"phase": "audio", "prefill_s": a_rec["prefill_s"],
          "decode_frames_per_s": a_rec["decode_per_s"],
          "weight_bytes": rec["weight_bytes"],
          "peak_mem_bytes": rec["peak_mem_bytes"],
          "busy_share": where["busy_share"]})
    del pa, params, frames, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _vision_paged(torch, model, params, prompt, dense, tol, problems,
                  dtype=None, label="vision-paged"):
    """Run 2: the dense run's prompts through the paged path, as
    ``run()``'s monolithic admission does it: a batch-1 prefill per
    sequence into a dense cache, ``paged_kv.write_prefill`` of its
    ``"paged"`` and ``"memory"`` entries into lane b of a 2-slot pool
    (pages of PAGE; caches and pool in ``dtype``, fp32 by default), then
    N_NEW ``decode_step_paged`` steps on the greedy tokens.  Streams
    against the dense run's by the gap rule at ``tol``; exactly one K4 launch per self-attention layer and one K1
    per cross layer a step (the cross block reads its memory lane)."""
    from repro_torch import kernels
    from repro_torch.serve import paged_kv
    cfg = model.cfg
    kinds = cfg.cache_kinds()
    nb = -(-FE_MAX_LEN // PAGE)
    L = -(-FE_PROMPT // PAGE) * PAGE
    dtype = dtype or torch.float32
    pool = model.init_paged_cache(B, 1 + B * nb, PAGE, dtype=dtype,
                                  device="cuda")
    bt = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    first = []
    with torch.no_grad():
        for r in range(B):
            c = model.init_cache(1, L, dtype=dtype, device="cuda")
            lg, c = model.prefill(params, {
                "tokens": prompt["tokens"][r:r + 1],
                "img_embeds": prompt["img_embeds"][r:r + 1]}, c,
                attn_impl="cuda")
            paged_kv.write_prefill(pool, c, kinds, r,
                                   [int(x) for x in bt[r, :L // PAGE]], PAGE)
            first.append(lg[0, -1, :cfg.vocab].float())
            del c, lg
        last = torch.stack(first)
        prefill_diff = float((last.cpu() - dense["logits"]).abs().max())
        bt_t = torch.as_tensor(bt, device="cuda")
        pos = torch.full((B,), FE_PROMPT, dtype=torch.int32, device="cuda")
        toks = []
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_NEW):
            cur = torch.argmax(last, dim=-1)
            toks.append(cur)
            lg, pool = model.decode_step_paged(params, cur[:, None], pool,
                                               bt_t, pos + i,
                                               attn_impl="cuda")
            last = lg[:, -1, :cfg.vocab].float()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n_cross = cfg.n_repeat * sum(b.kind == "cross_attn" for b in cfg.pattern)
    n_self = cfg.n_repeat * len(cfg.pattern) - n_cross
    if launches["paged_attention"] != n_self * N_NEW or \
            launches["flash_attention"] != n_cross * N_NEW:
        problems.append(f"{label}: attention launches {launches}, want "
                        f"{n_self} K4 and {n_cross} K1 a step")
    if prefill_diff > tol:
        problems.append(f"{label}: batch-1 prefill logits {prefill_diff}"
                        f" from the dense run's")
    tokens = torch.stack(toks, 1).cpu().numpy()
    firsts = [f for r in range(B)
              if (f := _check_streams(f"{label}/{r}", tokens[r],
                                      dense["tokens"][r],
                                      dense["gaps"][:, r], tol, problems))]
    rec = dict(page_size=PAGE, pages=1 + B * nb,
               pool_dtype=str(dtype).replace("torch.", ""),
               launches=launches,
               prefill_logit_max_abs_diff=prefill_diff, decode_s=decode_s,
               decode_tok_per_s=B * N_NEW / decode_s,
               first_differences=firsts, tol=tol)
    emit({"phase": label, **rec})
    del pool
    return rec


def _vision_frontend(torch, problems):
    """llama-3.2-vision-90b, one 5-layer period at published width (the
    depth cut is on the vision-init line), random fp32 weights from SEED
    and the seeded policy, 2 x 2048 prompt tokens beside seeded image
    embeddings: F, the fp64 evaluation of the prefill's last logits
    (_fp64_last_logits); run 1, 16 greedy tokens on a dense fp32 cache,
    engine A (packed store, kernels) against engine B (fake store, plain
    versions) with activation quantization off, by check_serve's rules
    at LOGIT_ATOL plus twice B's distance from F (K1 once a layer a call,
    the cross block's included), K2 / K3 exactly as _moe_gemm_launches
    counts them (the cross block's wk / wv at prefill only); run
    2 through the paged pool (_vision_paged); run 3, engine A over a bf16
    cache, its streams against run 1's by the gap rule at BF16_GAP_TOL."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.models import LM
    from repro_torch.quant.apply import (apply_policy_packed,
                                         apply_policy_to_params)
    base = ARCHS[VISION_ARCH].config
    cfg = dataclasses.replace(base, n_layers=VISION_LAYERS)
    model = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = int(sum(t.numel() for t in tree_leaves(params)))
    init = dict(arch=cfg.name, layers=cfg.n_layers,
                reduced=dict(n_layers=[base.n_layers, cfg.n_layers]),
                pattern=[b.kind for b in cfg.pattern], d_model=cfg.d_model,
                heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                vocab=cfg.vocab, n_img_tokens=cfg.n_img_tokens,
                seconds=time.perf_counter() - t0, parameters=n_params,
                param_bytes=_param_bytes(params))
    emit({"phase": "vision-init", **init})
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    rng = np.random.default_rng(SEED + 11)
    tokens = rng.integers(0, cfg.vocab, size=(B, FE_PROMPT))
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    prompt = {"tokens": torch.as_tensor(tokens, device="cuda"),
              "img_embeds": FE_SCALE * torch.randn(
                  (B, cfg.n_img_tokens, cfg.d_model), generator=g,
                  device="cuda")}
    pa = apply_policy_packed(params, graph, policy)
    pb = apply_policy_to_params(params, graph, policy)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    peaks = [int(torch.cuda.max_memory_allocated())]
    lf = _fp64_last_logits(torch, model, pb, prompt).cpu()
    a = lm_stream(torch, "vision-A0", model, pa, prompt, N_NEW,
                  impl="cuda")
    b = lm_stream(torch, "vision-B0", model, pb, prompt, N_NEW, impl="ref")
    peaks += [a["rec"]["peak_mem_bytes"], b["rec"]["peak_mem_bytes"]]
    ea = (a["logits"].double() - lf).abs()
    eb = (b["logits"].double() - lf).abs()
    floor = dict(fp64_logit_std=float(lf.std()), a_mean=float(ea.mean()),
                 a_last_max=float(ea.max()), b_mean=float(eb.mean()),
                 b_last_max=float(eb.max()))
    tol = LOGIT_ATOL + 2 * floor["b_last_max"]
    floor["act_off_tol"] = tol
    emit({"phase": "vision-floor", **floor})
    if floor["a_mean"] > floor["b_mean"] + LOGIT_ATOL:
        problems.append(f"vision: the kernels' prefill is farther from fp64 "
                        f"than the plain one: {floor}")
    check = check_serve(torch, a, b, tol, cfg.n_layers, cfg.vocab)
    problems += check["problems"]
    check["steps_max_abs_diff"] = _steps_apart(a, b)
    if check["steps_max_abs_diff"] > tol:
        problems.append(f"vision: step logits {check['steps_max_abs_diff']}"
                        f" apart, over {tol}")
    cross = {f"p{i}.{w}" for i, bd in enumerate(cfg.pattern)
             if bd.kind == "cross_attn" for w in ("wk", "wv")}
    w1, _ = _moe_gemm_launches(graph, policy, cfg, 1, (B * FE_PROMPT,))
    wd, _ = _moe_gemm_launches(graph, policy, cfg, N_NEW, skip=cross)
    want = {k: w1[k] + wd[k] for k in w1}
    got = {k: a["rec"]["launches"][k] for k in want}
    if got != want:
        problems.append(f"vision generate: GEMM launches {got}, want {want}")
    check["gemm_want"] = want
    emit({"phase": "vision-check", "steps_max_abs_diff":
          check["steps_max_abs_diff"], "gemm_want": want})
    del b, pb
    gc.collect()
    torch.cuda.empty_cache()
    paged = _vision_paged(torch, model, pa, prompt, a, tol, problems)
    c = lm_stream(torch, "vision-A0-bf16", model, pa, prompt, N_NEW,
                  impl="cuda", cache_dtype=torch.bfloat16)
    bf16 = dict(prefill_logit_max_abs_diff=float(
        (c["logits"] - a["logits"]).abs().max()), tol=BF16_GAP_TOL,
        launches=c["rec"]["launches"],
        first_differences=[f for r in range(B) if (f := _check_streams(
            f"vision-bf16/{r}", c["tokens"][r], a["tokens"][r],
            a["gaps"][:, r], BF16_GAP_TOL, problems))])
    if c["rec"]["launches"] != a["rec"]["launches"]:
        problems.append(f"vision bf16: launches {c['rec']['launches']}, want "
                        f"the fp32 run's {a['rec']['launches']}")
    emit({"phase": "vision-bf16", **bf16})
    rec = dict(init=init, floor=floor, engine_a=a["rec"], check=check,
               paged=paged, bf16=bf16, bf16_engine=c["rec"],
               weight_bytes=dict(packed=_store_bytes(pa),
                                 fp32=init["param_bytes"]),
               peak_mem_bytes=max(peaks + [c["rec"]["peak_mem_bytes"]]))
    emit({"phase": "vision", "prefill_s": a["rec"]["prefill_s"],
          "decode_tok_per_s": a["rec"]["decode_per_s"],
          "weight_bytes": rec["weight_bytes"],
          "peak_mem_bytes": rec["peak_mem_bytes"]})
    del a, c, pa, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_frontends(torch):
    """The audio front end and cross-attention's "memory" caches:
    musicgen-large at published width and depth (_audio_frontend), its
    training through the launcher's ``make_data_fn`` (2 steps at 1 x 512
    frames, remat, 8-bit AdamW, twice from one seed, bit for bit:
    train_lm), then one llama-3.2-vision-90b period at published width
    (_vision_frontend).  Vision is not trained on the card: its params and
    gradients alone are 51.6 GB (its gradients are held on the CPU,
    tests/test_torch_frontends.py)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import make_data_fn
    from repro_torch.models import LM
    t_phase = time.perf_counter()
    problems = []
    audio = _audio_frontend(torch, problems)
    cfg = ARCHS[AUDIO_ARCH].config
    train = train_lm(torch, cfg, LM(cfg), make_data_fn(cfg, 1, LM_TRAIN_LEN))
    problems += train["problems"]
    gc.collect()
    torch.cuda.empty_cache()
    vision = _vision_frontend(torch, problems)
    out = dict(audio=audio, audio_train=train, vision=vision,
               peak_mem_bytes=max(audio["peak_mem_bytes"],
                                  train["peak_mem_bytes"],
                                  vision["peak_mem_bytes"]),
               seconds=time.perf_counter() - t_phase, problems=problems)
    emit({"phase": "frontends", "seconds": out["seconds"],
          "peak_mem_bytes": out["peak_mem_bytes"], "problems": problems})
    if problems:
        raise AssertionError("frontends checks failed: " +
                             "; ".join(problems))
    return out


# ------------------------------------------------------------- phase 6c
def _bf16_run_twin(torch, label, model, params, twin, policy, reqs, graph,
                   problems):
    """run() of a bf16 model with recurrent state over a bf16 pool on the
    packed store (_state_run: monolithic, refusals, exact launches,
    streams against generate by the gap rule at BF16_GAP_TOL), then its
    fp32 twin's run over an fp32 pool, whose launches it must equal."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    kw = dict(max_len=SSM_MAX_LEN, weight_store="packed", attn_impl="cuda",
              device="cuda")
    eng = ServeEngine(model, params, policy=policy,
                      cache_dtype=torch.bfloat16, **kw)
    rec = _state_run(torch, label, eng, reqs, graph, policy, problems,
                     tol=BF16_GAP_TOL)
    del eng
    teng = ServeEngine(model, twin, policy=policy, cache_dtype=torch.float32,
                       **kw)
    kernels.reset_launch_counts()
    teng.run(reqs, page_size=PAGE, max_slots=RUN_SLOTS, prefill="monolithic")
    rec["twin_launches"] = kernels.launch_counts()
    del teng
    if rec["launches"] != rec["twin_launches"]:
        problems.append(f"{label}: launches {rec['launches']}, its fp32 "
                        f"twin's {rec['twin_launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _bf16_mamba(torch, problems):
    """mamba2-780m at published width and depth from ``LM.init(SEED,
    dtype=bf16)``: generate (B x SSM_PROMPT + N_NEW, activation
    quantization off, as phase ssm's full-depth pair) of A / B over a bf16
    cache and over an fp32 cache (ServeEngine's default, where a decode
    window comes back fp32), against the fp32 twins (_twin_checks, no K1,
    exact K2 / K3); the same on the first SSM_GATE_LAYERS layers, where
    the twin distance stays below the logits' spread however deep the
    full model parts; run() on those layers at activation QBN 8 over a
    bf16 pool (_bf16_run_twin)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    cfg = ARCHS[SSM_ARCH].config
    model = LM(cfg)
    params = model.init(SEED, device="cuda", dtype=torch.bfloat16)
    twin = _cast_tree(torch, params, torch.float32)
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    rng = np.random.default_rng(SEED + 8)
    tokens = rng.integers(0, cfg.vocab, size=(B, SSM_PROMPT))
    out = dict(param_bytes=_param_bytes(params))

    def pair(tag, m, p, tw, gr, pol, caches):
        kw = dict(max_len=SSM_MAX_LEN, serve_act_bits=False)
        t = run_engine(torch, f"bf16-{tag}-twin", m, tw, pol, tokens,
                       store="packed", impl="cuda",
                       cache_dtype=torch.float32, **kw)
        bt = run_engine(torch, f"bf16-{tag}-B-twin", m, tw, pol, tokens,
                        store="fake", impl="ref", cache_dtype=torch.float32,
                        **kw)
        recs = {}
        for dt in caches:
            name = f"{tag}-{str(dt).replace('torch.', '')}-cache"
            a = run_engine(torch, f"bf16-{name}-A", m, p, pol, tokens,
                           store="packed", impl="cuda", cache_dtype=dt,
                           warm=dt == caches[0], **kw)
            b = run_engine(torch, f"bf16-{name}-B", m, p, pol, tokens,
                           store="fake", impl="ref", cache_dtype=dt, **kw)
            rec = _twin_checks(torch, name, m.cfg.vocab, a, b, t, bt,
                               problems, 0)
            rec["gemm_want"] = _gemm_check(
                problems, f"bf16 {name} generate", rec["launches"], gr, pol,
                m.cfg, 1 + N_NEW, (tokens.size,))
            rec.update(prefill_s=a["rec"]["prefill_s"],
                       decode_tok_per_s=a["rec"]["decode_tok_per_s"],
                       peak_mem_bytes=a["rec"]["peak_mem_bytes"],
                       weight_hbm_bytes=a["rec"]["weight_hbm_bytes"],
                       twin_prefill_s=t["rec"]["prefill_s"],
                       twin_decode_tok_per_s=t["rec"]["decode_tok_per_s"])
            emit({"phase": "bf16-families-generate", "model": name, **rec})
            recs[name] = rec
            del a, b
        del t, bt
        gc.collect()
        torch.cuda.empty_cache()
        return recs

    out["generate"] = pair("ssm", model, params, twin, graph, policy,
                           (torch.bfloat16, torch.float32))
    gcfg = dataclasses.replace(cfg, n_layers=SSM_GATE_LAYERS)
    gmodel = LM(gcfg)
    gparams = model.draft_prefix_params(params, SSM_GATE_LAYERS)
    gtwin = model.draft_prefix_params(twin, SSM_GATE_LAYERS)
    ggraph = gmodel.graph(seq_len=1, batch=1)
    gpolicy = make_policy(ggraph)
    out["gate"] = pair("ssm-gate", gmodel, gparams, gtwin, ggraph, gpolicy,
                       (torch.bfloat16,))
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in zip(MOE_RUN_PROMPTS, MOE_RUN_NEW)]
    out["gate_run"] = _bf16_run_twin(torch, "bf16-ssm-gate-run", gmodel,
                                     gparams, gtwin, gpolicy, reqs, ggraph,
                                     problems)
    del params, twin, gparams, gtwin
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _bf16_hybrid(torch, problems):
    """The jamba hybrid at HYBRID_CUT from ``LM.init(SEED, dtype=bf16)``:
    run() of phase ssm's 4 hybrid requests on the packed store over a
    bf16 pool, activation QBN 8 (_bf16_run_twin), with K1, K4 and the
    expert-batched K2 / K3 launched."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    base = ARCHS[HYBRID_ARCH].config
    cfg = dataclasses.replace(base, **HYBRID_CUT, moe=dataclasses.replace(
        base.moe, d_ff=HYBRID_EXPERT_D_FF))
    model = LM(cfg)
    params = model.init(SEED, device="cuda", dtype=torch.bfloat16)
    twin = _cast_tree(torch, params, torch.float32)
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    rng = np.random.default_rng(SEED + 9)
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in zip(HYBRID_RUN_PROMPTS, HYBRID_RUN_NEW)]
    rec = _bf16_run_twin(torch, "bf16-hybrid-run", model, params, twin,
                         policy, reqs, graph, problems)
    if not all(rec["launches"][k] for k in ("flash_attention",
                                            "paged_attention",
                                            "quant_matmul",
                                            "packed_matmul")):
        problems.append(f"bf16 hybrid run: a kernel not launched "
                        f"{rec['launches']}")
    rec["param_bytes"] = _param_bytes(params)
    del params, twin
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _bf16_streams(torch, tag, model, params, graph, policy, prompt,
                  twin_prompt, problems, feed=None, twin_feed=None,
                  after_a=None):
    """lm_stream of the bf16 ``params`` (A: the packed store on the
    kernels, B: the fake store on the plain versions, bf16 caches) and of
    their fp32 twin (fp32 caches, the prompt upcast), one store at a time,
    the bf16 parameters freed before the twin is made (a whole vision
    period's bf16 and fp32 trees and a store do not fit the card
    together: the caller keeps no reference to ``params``); held by
    _twin_checks over the step logits.  ``after_a(store, a, cache dtype)``
    runs while A's store is alive."""
    from repro_torch.quant.apply import (apply_policy_packed,
                                         apply_policy_to_params)
    cfg = model.cfg
    held = [params]
    del params
    res = {}
    for name, pr, fd, dt in (("", prompt, feed, torch.bfloat16),
                             ("-twin", twin_prompt, twin_feed,
                              torch.float32)):
        p = held[0] if dt == torch.bfloat16 else \
            _cast_tree(torch, held.pop(), torch.float32)
        for side, store, impl in (("B", apply_policy_to_params, "ref"),
                                  ("A", apply_policy_packed, "cuda")):
            st = store(p, graph, policy)
            r = lm_stream(torch, f"bf16-{tag}-{side}{name}", model, st, pr,
                          N_NEW, impl=impl, cache_dtype=dt, feed=fd)
            res[side + name] = r
            if side == "A" and after_a is not None:
                res["after" + name] = after_a(st, r, dt)
            del st
            gc.collect()
            torch.cuda.empty_cache()
        del p
        gc.collect()
        torch.cuda.empty_cache()
    rec = _twin_checks(torch, tag, cfg.vocab, res["A"], res["B"],
                       res["A-twin"], res["B-twin"], problems,
                       cfg.n_layers * (1 + N_NEW))
    rec.update(prefill_s=res["A"]["rec"]["prefill_s"],
               decode_per_s=res["A"]["rec"]["decode_per_s"],
               peak_mem_bytes=max(r["rec"]["peak_mem_bytes"]
                                  for k, r in res.items()
                                  if not k.startswith("after")),
               weight_bytes=res["A"]["rec"]["weight_bytes"],
               twin_prefill_s=res["A-twin"]["rec"]["prefill_s"],
               twin_decode_per_s=res["A-twin"]["rec"]["decode_per_s"])
    emit({"phase": "bf16-families-stream", "model": tag, **rec})
    return rec, res


def _bf16_audio(torch, problems):
    """musicgen-large at published width and depth from ``LM.init(SEED,
    dtype=bf16)``: LM.prefill of 2 x FE_PROMPT bf16 frames and N_NEW
    teacher-forced decode steps, A / B by _bf16_streams (K1 once a layer
    a call, exact K2 / K3)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    cfg = ARCHS[AUDIO_ARCH].config
    model = LM(cfg)
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    frames = (FE_SCALE * torch.randn((B, FE_MAX_LEN, cfg.d_model),
                                     generator=g, device="cuda")
              ).to(torch.bfloat16)
    f32 = frames.float()
    rec, res = _bf16_streams(
        torch, "audio", model,
        model.init(SEED, device="cuda", dtype=torch.bfloat16), graph, policy,
        {"embeds": frames[:, :FE_PROMPT]}, {"embeds": f32[:, :FE_PROMPT]},
        problems,
        feed=lambda i, cur: frames[:, FE_PROMPT + i:FE_PROMPT + i + 1],
        twin_feed=lambda i, cur: f32[:, FE_PROMPT + i:FE_PROMPT + i + 1])
    rec["gemm_want"] = _gemm_check(problems, "bf16 audio", rec["launches"],
                                   graph, policy, cfg, 1 + N_NEW,
                                   (B * FE_PROMPT,))
    del frames, f32, res
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _bf16_vision(torch, problems):
    """One llama-3.2-vision-90b period (VISION_LAYERS) at published width
    from ``LM.init(SEED, dtype=bf16)``, 2 x FE_PROMPT tokens beside bf16
    image embeddings: A / B over 16 greedy tokens on a dense bf16 cache
    (bf16 "memory" entries) by _bf16_streams (K1 once a layer a call,
    exact K2 / K3 with the cross block's wk / wv at prefill only), and A's
    store through the paged path over a bf16 pool (_vision_paged: 4 K4
    and 1 K1 a step, streams against A's dense run by the gap rule at
    BF16_GAP_TOL), its launches equal to the fp32 twin's paged run."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    base = ARCHS[VISION_ARCH].config
    cfg = dataclasses.replace(base, n_layers=VISION_LAYERS)
    model = LM(cfg)
    graph = model.graph(seq_len=1, batch=1)
    policy = make_policy(graph)
    rng = np.random.default_rng(SEED + 11)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, FE_PROMPT)),
                             device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    img = (FE_SCALE * torch.randn((B, cfg.n_img_tokens, cfg.d_model),
                                  generator=g, device="cuda")
           ).to(torch.bfloat16)
    prompt = {"tokens": tokens, "img_embeds": img}
    twin_prompt = {"tokens": tokens, "img_embeds": img.float()}

    def paged(store, dense, dt):
        bf16 = dt == torch.bfloat16
        return _vision_paged(
            torch, model, store, prompt if bf16 else twin_prompt, dense,
            BF16_GAP_TOL, problems, dtype=dt,
            label="bf16-vision-paged" + ("" if bf16 else "-twin"))

    rec, res = _bf16_streams(
        torch, "vision", model,
        model.init(SEED, device="cuda", dtype=torch.bfloat16), graph, policy,
        prompt, twin_prompt, problems, after_a=paged)
    cross = {f"p{i}.{w}" for i, bd in enumerate(cfg.pattern)
             if bd.kind == "cross_attn" for w in ("wk", "wv")}
    w1, _ = _moe_gemm_launches(graph, policy, cfg, 1, (B * FE_PROMPT,))
    wd, _ = _moe_gemm_launches(graph, policy, cfg, N_NEW, skip=cross)
    want = {k: w1[k] + wd[k] for k in w1}
    if {k: rec["launches"][k] for k in want} != want:
        problems.append(f"bf16 vision: GEMM launches {rec['launches']}, "
                        f"want {want}")
    rec["gemm_want"] = want
    rec["paged"], pt = res["after"], res["after-twin"]
    if rec["paged"]["launches"] != pt["launches"]:
        problems.append(f"bf16 vision paged: launches "
                        f"{rec['paged']['launches']}, its fp32 twin's "
                        f"{pt['launches']}")
    rec["paged"]["twin_launches"] = pt["launches"]
    del res, prompt, twin_prompt, img
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_bf16_families(torch, card):
    """A12 on the card: mamba2-780m, the jamba hybrid, musicgen-large and a
    llama-3.2-vision period with bf16 parameters from ``LM.init(SEED,
    dtype=bf16)`` beside their fp32 twins (_bf16_mamba, _bf16_hybrid,
    _bf16_audio, _bf16_vision).  Every bf16 path's K1 / K4 / K2 / K3
    launches equal its fp32 twin's.  The card's name and power limit
    stand beside the numbers."""
    t_phase = time.perf_counter()
    problems = []
    out = {"card": card}
    for name, fn in (("ssm", _bf16_mamba), ("hybrid", _bf16_hybrid),
                     ("audio", _bf16_audio), ("vision", _bf16_vision)):
        t0 = time.perf_counter()
        out[name] = fn(torch, problems)
        out[name]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["problems"] = problems
    gen = out["ssm"]["generate"]
    emit({"phase": "bf16-families", "card": card, "seconds": out["seconds"],
          "seconds_by_model": {k: out[k]["seconds"]
                               for k in ("ssm", "hybrid", "audio",
                                         "vision")},
          "twin_distance_over_std": {
              **{k: r["twin_distance_over_std"] for k, r in gen.items()},
              **{k: r["twin_distance_over_std"]
                 for k, r in out["ssm"]["gate"].items()},
              "audio": out["audio"]["twin_distance_over_std"],
              "vision": out["vision"]["twin_distance_over_std"]},
          "problems": problems})
    if problems:
        raise AssertionError("bf16-families checks failed: " +
                             "; ".join(problems))
    return out


# ------------------------------------------------------------- phase 5b
def _pool_bytes(cfg, max_slots, max_len, page, elem_bytes):
    """Bytes of the paged pool ServeEngine.run allocates: max_slots
    sequences at max_len plus the trash page, K and V of elem_bytes an
    element and int32 positions, per layer."""
    pages = max_slots * -(-max_len // page) + 1
    slots = cfg.n_layers * pages * page
    return slots * (2 * cfg.n_kv_heads * cfg.hdim * elem_bytes + 4)


def _run_and_generate(torch, label, eng, reqs, kw, problems,
                      tol=ACT_LOGIT_ATOL):
    """``eng.run(reqs)`` (its launches and record), then each request's
    ``generate`` (their launches summed); every run stream held to its
    generate by the gap rule at ``tol``.  Returns (run record, run
    outputs, generate streams and gaps, generate launches)."""
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
        f = _check_streams(f"{label}/{i}", out, want_toks, gaps, tol,
                           problems)
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


def _cast_tree(torch, tree, dtype):
    """Every tensor leaf of a parameter tree cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_tree(torch, v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_tree(torch, v, dtype) for v in tree)
    return tree.to(dtype)


def _logits_apart(x, y, vocab):
    """Max |x - y| of two results over the real vocabulary (a padded
    column is -1e30 in both, which bf16 and fp32 round apart): over the
    step logits two streams share (_steps_apart) where both carry them,
    else over the prefill logits."""
    if "steps" in x and "steps" in y:
        return _steps_apart(x, y)
    return float((x["logits"][..., :vocab] - y["logits"][..., :vocab]
                  ).abs().max())


def _twin_checks(torch, tag, vocab, a, b, t, bt, problems, want_k1):
    """Engine / stream A (the kernels) against B (the plain versions) of a
    bf16 model, beside their fp32 twins t and bt (the same parameters
    upcast, fp32 caches): finite logits, tokens in range; A / B within
    BF16_TWIN_FACTOR x B's distance from its twin (plain versions only,
    so a fault in a bf16 kernel moves A / B and not the limit; over the
    step logits of streams that carry them, _logits_apart); B's twin
    distance beside the logits' standard deviation (a distance above it
    would make the rule hold nothing); streams by the gap rule at
    BF16_GAP_TOL; A launches each kernel exactly as often as its twin, K1
    ``want_k1`` times; B and B's twin launch none.  Returns the record
    (``logits_over`` says which logits the ``*_logit_max_abs_diff``
    distances cover)."""
    for r in (a, b, t, bt):
        if not bool(torch.isfinite(r["logits"]).all()):
            problems.append(f"bf16 {r['rec']['engine']}: non-finite logits")
        if r["tokens"].min() < 0 or r["tokens"].max() >= vocab:
            problems.append(f"bf16 {r['rec']['engine']}: tokens out of "
                            "range")
    d_ab, d_twin, d_plain = (_logits_apart(x, y, vocab)
                             for x, y in ((a, b), (a, t), (b, bt)))
    std = float(bt["logits"][..., :vocab].std())
    if d_ab > BF16_TWIN_FACTOR * d_plain:
        problems.append(f"bf16 {tag}: A / B logits {d_ab} apart, over "
                        f"{BF16_TWIN_FACTOR} x B's twin distance {d_plain}")
    first = None
    bad = np.argwhere(a["tokens"] != b["tokens"])
    if bad.size:
        st = int(bad[:, 1].min())
        rows = np.unique(bad[bad[:, 1] == st][:, 0])
        gaps = [float(b["gaps"][st, r]) for r in rows]
        first = dict(step=st, rows=rows.tolist(), b_top2_gap=gaps)
        if max(gaps) >= BF16_GAP_TOL:
            problems.append(f"bf16 {tag}: streams differ at step {st} where "
                            f"B's top-2 gap is {gaps}")
    la, lb, lt, lbt = (r["rec"]["launches"] for r in (a, b, t, bt))
    if la != lt:
        problems.append(f"bf16 {tag}: launches {la}, its fp32 twin's {lt}")
    if any(lb.values()) or any(lbt.values()):
        problems.append(f"bf16 {tag}: engine B or its twin launched "
                        f"kernels: {lb}, {lbt}")
    if la["flash_attention"] != want_k1:
        problems.append(f"bf16 {tag}: K1 launched {la['flash_attention']} "
                        f"times, want {want_k1}")
    return dict(logits_over="steps" if "steps" in a else "prefill",
                prefill_logit_max_abs_diff=d_ab,
                twin_prefill_logit_max_abs_diff=d_twin,
                b_twin_prefill_logit_max_abs_diff=d_plain,
                b_twin_logit_std=std,
                twin_distance_over_std=d_plain / max(std, 1e-30),
                twin_factor=BF16_TWIN_FACTOR, gap_tol=BF16_GAP_TOL,
                streams_equal=first is None, first_difference=first,
                min_b_top2_gap=float(b["gaps"].min()),
                launches=la, twin_launches=lt)


def _bf16_pair(torch, tag, model, params, twin, policy, tokens, problems):
    """generate on one store of the bf16 model: engine A (the kernels)
    against engine B (the plain versions), both bf16 with a bf16 cache,
    and the fp32 twins of both (the same parameters upcast, an fp32
    cache), A and its twin timed on their second generate, held by
    _twin_checks (K1 once a layer a call); K2 / K3 launched only on the
    packed store."""
    cfg = model.cfg
    store = "packed" if policy is not None else "fake"
    a = run_engine(torch, f"bf16-{tag}-A", model, params, policy, tokens,
                   store=store, impl="cuda", cache_dtype=torch.bfloat16,
                   warm=True)
    b = run_engine(torch, f"bf16-{tag}-B", model, params, policy, tokens,
                   store="fake", impl="ref", cache_dtype=torch.bfloat16)
    t = run_engine(torch, f"bf16-{tag}-twin", model, twin, policy, tokens,
                   store=store, impl="cuda", cache_dtype=torch.float32,
                   warm=True)
    bt = run_engine(torch, f"bf16-{tag}-B-twin", model, twin, policy,
                    tokens, store="fake", impl="ref",
                    cache_dtype=torch.float32)
    rec = _twin_checks(torch, tag, cfg.vocab, a, b, t, bt, problems,
                       cfg.n_layers * (1 + N_NEW))
    la = rec["launches"]
    gemm = la["quant_matmul"] + la["packed_matmul"]
    if (policy is None) != (gemm == 0):
        problems.append(f"bf16 {tag}: GEMM launches {la}")
    ra = a["rec"]
    rec.update(store=tag, prefill_s=ra["prefill_s"],
               decode_tok_per_s=ra["decode_tok_per_s"],
               peak_mem_bytes=ra["peak_mem_bytes"],
               weight_hbm_bytes=ra["weight_hbm_bytes"],
               twin_weight_hbm_bytes=t["rec"]["weight_hbm_bytes"],
               b_prefill_s=b["rec"]["prefill_s"],
               twin_prefill_s=t["rec"]["prefill_s"],
               twin_decode_tok_per_s=t["rec"]["decode_tok_per_s"])
    emit({"phase": "bf16-generate", **rec})
    return rec


def phase_bf16(torch, cfg, model, policy, fp32, card):
    """A bf16 model served on the kernels: gemma2-2b at published width,
    GEMMA_LAYERS layers, parameters from ``LM.init(SEED,
    dtype=torch.bfloat16)`` (the serving phases' fp32 draws, rounded), bf16
    caches and pools.  generate (B x PROMPT + N_NEW) on the dense store
    (K1; the weights' products are cuBLAS bf16 GEMMs, fp32 reduction) and
    with the seeded policy on the packed store (K1, K2, K3 on bf16 q and
    x): _bf16_pair.  run() of the run phase's 8 requests on the packed
    store over a bf16 pool: overlap on == off bitwise, every stream
    against its generate by the gap rule at BF16_GAP_TOL, K1 / K4 / K2 /
    K3 launches equal to the fp32 twin's run, and one profiled run (0
    host syncs a step, the busy share; by route no more GEMM device
    launches than calls).  The card's name and power limit stand beside
    the numbers."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    t_phase = time.perf_counter()
    problems, out = [], {"card": card}
    params = model.init(SEED, device="cuda", dtype=torch.bfloat16)
    twin = _cast_tree(torch, params, torch.float32)
    torch.cuda.synchronize()
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                  size=(B, PROMPT))
    out["dense"] = _bf16_pair(torch, "dense", model, params, twin, None,
                              tokens, problems)
    out["packed"] = _bf16_pair(torch, "packed", model, params, twin, policy,
                               tokens, problems)
    reqs = fp32["reqs"]
    kw = dict(page_size=PAGE, max_slots=RUN_SLOTS, chunk_tokens=CHUNK)
    eng = ServeEngine(model, params, policy=policy, max_len=MAX_LEN,
                      weight_store="packed", attn_impl="cuda",
                      cache_dtype=torch.bfloat16, device="cuda")
    rec, outs, _, gl = _run_and_generate(torch, "bf16-model", eng, reqs, kw,
                                         problems, tol=BF16_GAP_TOL)
    off = eng.run(reqs, **kw, overlap=False)["outputs"]
    bitwise = all(np.array_equal(x, y) for x, y in zip(outs, off))
    if not bitwise:
        problems.append("bf16 run: overlap on and off give different "
                        "streams")
    teng = ServeEngine(model, twin, policy=policy, max_len=MAX_LEN,
                       weight_store="packed", attn_impl="cuda",
                       cache_dtype=torch.float32, device="cuda")
    kernels.reset_launch_counts()
    teng.run(reqs, **kw)
    twin_launches = kernels.launch_counts()
    del teng
    if rec["launches"] != twin_launches:
        problems.append(f"bf16 run: launches {rec['launches']}, its fp32 "
                        f"twin's {twin_launches}")
    prof, over = traced_gemm_launches(
        lambda: profile_run(torch, eng, reqs, kw)[1], "bf16 run profile")
    problems += over
    if prof["host_syncs"]:
        problems.append(f"bf16 run: {prof['host_syncs']} host syncs in "
                        f"{prof['steps']} steps")
    rec.update(overlap_bitwise=bitwise, twin_launches=twin_launches,
               pool_bytes=_pool_bytes(cfg, RUN_SLOTS, MAX_LEN, PAGE, 2),
               weight_hbm_bytes=eng.weight_hbm_bytes(),
               profile={k: prof[k] for k in (
                   "device_ms", "wall_s", "busy_share", "steps",
                   "host_syncs_per_step", "gemm_launches", "groups")})
    emit({"phase": "bf16-run", **{k: v for k, v in rec.items()
                                  if k != "generate_launches"}})
    out["run"] = rec
    out["generate_launches"] = gl
    del eng, params, twin
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["problems"] = problems
    emit({"phase": "bf16", "card": card, "seconds": out["seconds"],
          "dense": {k: out["dense"][k] for k in (
              "prefill_s", "decode_tok_per_s", "peak_mem_bytes",
              "weight_hbm_bytes", "prefill_logit_max_abs_diff",
              "twin_prefill_logit_max_abs_diff",
              "b_twin_prefill_logit_max_abs_diff")},
          "packed": {k: out["packed"][k] for k in (
              "prefill_s", "decode_tok_per_s", "peak_mem_bytes",
              "weight_hbm_bytes", "prefill_logit_max_abs_diff",
              "twin_prefill_logit_max_abs_diff",
              "b_twin_prefill_logit_max_abs_diff")},
          "run": {k: rec[k] for k in ("prefill_s", "decode_tok_per_s",
                                      "peak_mem_bytes")},
          "run_busy_share": prof["busy_share"],
          "run_host_syncs_per_step": prof["host_syncs_per_step"],
          "problems": problems})
    if problems:
        raise AssertionError("bf16 checks failed: " + "; ".join(problems))
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
    from repro_torch.models.layers import StepLayout
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
        layout = StepLayout.of(pos, bt, slot_map)
        fn = lambda: eng.model.model_step(eng.params, toks, layout, pool,
                                          cols, eng.act_bits,
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
    for name, most in (("model_step", step_shapes(RUN_SLOTS, CHUNK)),
                       ("draft_step", 2), ("draft_tail", 1)):
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


def check_lm_evaluator(torch, cfg, model, params, policy, tol=ACT_LOGIT_ATOL,
                       label="search-lm"):
    """One make_lm_evaluator call on the full-width params: B5 launches ==
    the graph's layer count; against a plain evaluation
    (apply_policy_to_params, then the forward with plain attention) the
    weights bit for bit, the logits within ``tol`` (ACT_LOGIT_ATOL: the
    policy quantizes activations at QBN 8), and the accuracy by the gap
    rule: a token may score differently only where the plain top-2 gap is
    below that tolerance."""
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
            logit_mean_abs_diff=float(d.mean()), tol=tol,
            logits_bitwise=bool(torch.equal(got, want)),
            logit_max_abs=float(want.abs().max()),
            min_plain_top2_gap=float(gap.min()),
            argmax_flips=n_flips, max_flip_gap=flip_gap)
        if not bool(torch.isfinite(got).all()) or \
                got.shape != (LM_EVAL_BATCH, LM_EVAL_LEN, cfg.vocab_padded):
            problems.append(f"LM evaluator logits {tuple(got.shape)} or "
                            f"not finite")
        if rec_logits["logit_max_abs_diff"] > tol:
            problems.append(f"LM evaluator logits differ from the plain "
                            f"forward by {rec_logits['logit_max_abs_diff']}")
        if n_flips and flip_gap >= tol:
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
    emit({"phase": label, **rec})
    torch.cuda.empty_cache()
    return rec


def short_search(torch, model, params, graph, val, reward=None,
                 roofline=None, episodes=DETERMINISM_EPISODES, mode=None):
    """``episodes`` (explore, exploit) of a search in ``mode`` (QUANT
    unless given; HierarchicalAgent from SEED; the accuracy-guaranteed
    reward unless ``reward`` is given, with ``roofline`` for kind
    "roofline"): each episode's policy, and the SearchResult."""
    from repro_torch.core import (HierarchicalAgent, QuantEnv, RewardCfg,
                                  make_cnn_evaluator, run_search)
    from repro_torch.quant.policy import QuantMode
    mode = mode or QuantMode.QUANT
    ev = make_cnn_evaluator(model, params, graph, val, mode=mode)
    env = QuantEnv(graph, params, ev, reward or RewardCfg.accuracy_guaranteed(),
                   mode=mode, roofline=roofline)
    agent = HierarchicalAgent(env, seed=SEED)
    policies, episode = [], agent.run_episode

    def recorded(*a, **k):
        log, policy = episode(*a, **k)
        policies.append(policy.copy())
        return log, policy
    agent.run_episode = recorded
    return policies, run_search(agent, n_explore=episodes[0],
                                n_exploit=episodes[1])


def _same_policies(pols, pols2) -> bool:
    """Two searches' episode policies equal: every group's weight QBN and
    every activation QBN."""
    return len(pols) == len(pols2) and all(
        a.weight_bits.keys() == b.weight_bits.keys()
        and all(np.array_equal(a.weight_bits[n], b.weight_bits[n])
                for n in a.weight_bits)
        and a.act_bits == b.act_bits for a, b in zip(pols, pols2))


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
    same_policy = _same_policies(pols, pols2)
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


def train_trainer(torch, model, params, opt, data_fn, tmp, steps, ckpt_every,
                  preempt_at, *, keep=3, loss_kwargs=None, skip_saves=False):
    """The Trainer on ``model`` from ``params``: an uninterrupted run of
    ``steps``, then one preempted at ``preempt_at`` and resumed from its
    newest checkpoint.  Every parameter and optimizer leaf must be equal
    bit for bit, every logged loss of the preempted and the resumed run
    the uninterrupted run's, and every parameter keep its dtype.  With
    ``skip_saves`` only the checkpoints that the resume reads are written
    (the uninterrupted and the resumed run's saves are counted and
    skipped).  Returns the record (not yet emitted) and the uninterrupted
    run's output."""
    import shutil
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.train.loop import SimulatedPreemption, Trainer, TrainConfig
    cfg = TrainConfig(total_steps=steps, ckpt_every=ckpt_every,
                      lr=opt.lr, keep=keep, log_every=1)
    skipped, saves = [], {"full": [], "pre": []}

    def make(sub, preempt_at=None, skip=False):
        tr = Trainer(model, params, opt, data_fn, os.path.join(tmp, sub), cfg,
                     loss_kwargs=loss_kwargs, preempt_at=preempt_at,
                     device="cuda")
        save = tr.ckpt.save

        def timed_save(step, *a, **k):
            if skip:
                skipped.append(step)
                return None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = save(step, *a, **k)
            saves[sub].append(time.perf_counter() - t0)
            return out
        tr.ckpt.save = timed_save
        return tr

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full = make("full", skip=skip_saves)
    t0 = time.perf_counter()
    ref = full.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_times, kept = list(full.step_times), full.ckpt.all_steps()
    del full
    problems = []
    pre = make("pre", preempt_at=preempt_at)
    try:
        pre.run()
        problems.append("the preempted run was not preempted")
    except SimulatedPreemption:
        pass
    pre_losses = [h["loss"] for h in pre.history]
    ckpt_bytes = _dir_bytes(pre.ckpt.dir / f"step_"
                            f"{pre.ckpt.latest_step():010d}")
    del pre
    t0 = time.perf_counter()
    resumed = make("pre", skip=skip_saves)
    t1 = time.perf_counter()
    out = resumed.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    start = resumed.start_step
    del resumed
    shutil.rmtree(os.path.join(tmp, "pre"))
    leaves = list(zip(tree_leaves(ref["params"]) + tree_leaves(ref["opt"]),
                      tree_leaves(out["params"]) + tree_leaves(out["opt"])))
    differ = sum(not torch.equal(a, b) for a, b in leaves)
    losses = [h["loss"] for h in ref["history"]]
    dtypes = {str(t.dtype) for t in tree_leaves(out["params"])}
    want_dtypes = {str(t.dtype) for t in tree_leaves(params)}
    want_start = preempt_at // ckpt_every * ckpt_every
    if start != want_start:
        problems.append(f"resumed at step {start}, want {want_start}")
    if differ:
        problems.append(f"resumed run differs from the uninterrupted one in "
                        f"{differ} of {len(leaves)} leaves")
    if pre_losses != losses[:len(pre_losses)] or \
            [h["loss"] for h in out["history"]] != losses[start:]:
        problems.append(f"Trainer losses differ between runs: {losses}, "
                        f"{pre_losses}, {out['history']}")
    if dtypes != want_dtypes:
        problems.append(f"Trainer parameters became {dtypes}, were "
                        f"{want_dtypes}")
    all_saves = saves["full"] + saves["pre"]
    rec = dict(model=model.cfg.name, steps=steps, ckpt_every=ckpt_every,
               preempt_at=preempt_at, start_step=start, lr=opt.lr,
               leaves=len(leaves), leaves_differing=differ, losses=losses,
               history=ref["history"], stragglers=ref["stragglers"],
               s_per_step=(wall - sum(saves["full"])) / steps,
               step_times_s=step_times, resume_s=t2 - t0,
               resumed_s_per_step=(t2 - t1) / (steps - start),
               ckpt_bytes=ckpt_bytes, saves=len(all_saves),
               s_per_save=float(np.mean(all_saves)), saves_skipped=skipped,
               kept=kept, resident_bytes_before=resident,
               peak_mem_bytes=peak, problems=problems)
    del out, leaves
    return rec, ref


def cnn_trainer(torch, model, data, tmp):
    """train_trainer on CIF10-7CNN from a fresh init (TRAINER_STEPS, fp32
    AdamW at TRAINER_LR); besides, the loss (logged every step) must
    fall: the mean of the last TRAINER_WINDOW steps under that of the
    first."""
    from repro_torch.optim import AdamW
    rec, _ = train_trainer(torch, model, model.init(SEED, "cuda"),
                           AdamW(lr=TRAINER_LR),
                           lambda s: data.batch(s, TRAIN_BATCH), tmp,
                           TRAINER_STEPS, TRAINER_CKPT, TRAINER_PREEMPT)
    losses = rec.pop("losses")
    first = float(np.mean(losses[:TRAINER_WINDOW]))
    last = float(np.mean(losses[-TRAINER_WINDOW:]))
    if not last < first:
        rec["problems"].append(f"Trainer loss did not fall: {losses}")
    rec.update(batch=TRAIN_BATCH, loss_first_window=first,
               loss_last_window=last)
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


def train_lm(torch, cfg, model, data_fn=None, dtype=None, probe=True,
             label="train-lm"):
    """LM_TRAIN_STEPS training steps of ``model`` at full width (LM.loss
    at 1 x LM_TRAIN_LEN tokens with remat=True, backward, one 8-bit AdamW
    update), run twice from one seed: the losses, the last step's
    gradients and every parameter leaf equal bit for bit.  The
    remat=False loss of step 1 must equal the remat=True one.  Peak
    memory is this call's.  On an MoE model, C2's probe
    (_unpinned_grads_equal) runs first unless ``probe`` is False.  The
    batches are TokenStream's, or ``data_fn(step)``'s (the launcher's
    ``make_data_fn``).  ``dtype`` (fp32 when None) is the parameters'
    (``LM.init(dtype=)``)."""
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.optim import AdamW
    from repro_torch.train.loop import upload_batch, value_and_grad
    dev = torch.device("cuda")
    opt = AdamW(lr=1e-4, state_bits=8)
    if data_fn is None:
        stream = TokenStream(vocab=cfg.vocab)
        data_fn = lambda i: stream.batch(i, 1, LM_TRAIN_LEN)  # noqa: E731
    batches = [data_fn(i) for i in range(LM_TRAIN_STEPS)]
    unpinned = None
    if cfg.moe is not None and probe:
        unpinned = _unpinned_grads_equal(torch, model,
                                         upload_batch(batches[0], dev))
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def one_run(first):
        params = model.init(SEED + 1, "cuda", dtype=dtype or torch.float32)
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
               dtype=str(dtype or torch.float32).replace("torch.", ""),
               remat=True, state_bits=8, steps=fl(steps),
               steps_repeat=fl(steps2), leaves=n_leaves,
               leaves_differing=differ, grad_leaves_differing=grads_differ,
               losses_equal=losses_equal,
               loss_remat_false=float(loss_nr), remat_equal=remat_equal,
               unpinned_grad_leaves_differing=unpinned,
               resident_bytes_before=resident, peak_mem_bytes=peak,
               peak_mem_bytes_both=torch.cuda.max_memory_allocated(),
               problems=problems)
    emit({"phase": label, **rec})
    return rec


def phase_train(torch, cfg, lm, card, sub):
    """The Trainer, the roofline reward, QAT (on the search phase's
    substrate, val images and best QUANT policy), and the LM training
    steps of gemma2-2b and of granite-moe-3b-a800m at published width and
    depth (C2's check: MoE training bit-reproducible)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        trainer = cnn_trainer(torch, sub["model"], sub["data"], tmp)
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


# ------------------------------------------------------------ bf16-train
# (a) the search phase's CIF10 substrate rounded to bf16: 7 + 3 QUANT and
# 3 + 2 BINARIZE episodes (explore, exploit), each search run twice, and
# QAT steps at batch QAT_BATCH; (b) gemma2-2b at GEMMA_LAYERS from
# LM.init(dtype=bf16) trained by the Trainer at 1 x LM_TRAIN_LEN (8-bit
# AdamW), checkpoints every BF16_TRAIN_CKPT steps, preempted at
# BF16_TRAIN_PREEMPT; (c) granite-moe at published width and depth, two
# bf16 LM.loss steps twice (train_lm)
BF16_SEARCH_EPISODES = (("quant", (7, 3)), ("binarize", (3, 2)))
BF16_QAT_STEPS = 10
BF16_TRAIN_STEPS, BF16_TRAIN_CKPT, BF16_TRAIN_PREEMPT = 3, 2, 2
BF16_TRAIN_LR = 1e-4


def _bf16_images(torch, batch):
    """An image batch with x rounded to bf16, as a CPU tensor: the
    evaluators and upload_batch take it in that dtype."""
    return {"x": torch.from_numpy(np.asarray(batch["x"])).to(torch.bfloat16),
            "y": batch["y"]}


def bf16_evaluators(torch, model, p16, twin, graph, val16):
    """The bf16 CNN's evaluators: QUANT on B5 against a plain evaluation
    (weights bit for bit in bf16, the same accuracy) for three seeded
    policies; BINARIZE on B6 (plane form, activations at 32 bits) against
    the dense fake-binarized bf16 forward, logits within BF16_TWIN_FACTOR
    x the plain forward's distance from its fp32 twin, and its accuracy
    the plane form's and the dense forward's but for near ties; each
    evaluation exactly one launch of its mode's kernel per searched
    layer."""
    from repro_torch import backend, kernels
    from repro_torch.core import evaluate, make_cnn_evaluator
    from repro_torch.quant.apply import apply_policy_to_params, get_path
    from repro_torch.quant.policy import QuantMode
    dev = torch.device("cuda")
    n_layers = len(graph.layers)
    xb = {k: backend.upload(v, dev) for k, v in val16.items()}
    problems, rec = [], {"quant": []}
    for seed in range(3):
        pol = _cnn_policy(graph, SEED + 10 + seed, QuantMode.QUANT)
        wb, _ = evaluate.upload_bits(pol, graph, dev)
        with torch.no_grad():
            q = evaluate._quantize_params(p16, graph, wb, QuantMode.QUANT)
            plain = apply_policy_to_params(p16, graph, pol)
            same = all(get_path(q, l.param_path).dtype == torch.bfloat16 and
                       torch.equal(get_path(q, l.param_path),
                                   get_path(plain, l.param_path))
                       for l in graph.layers)
            acc_plain = float(model.accuracy(
                plain, xb, act_bits=pol.act_bits)) * 100.0
        ev = make_cnn_evaluator(model, p16, graph, val16,
                                mode=QuantMode.QUANT)
        kernels.reset_launch_counts()
        acc = ev(pol)
        n = kernels.launch_counts()
        rec["quant"].append(dict(seed=seed, weights_bitwise=same, acc=acc,
                                 acc_plain=acc_plain, launches=n))
        if not same or acc != acc_plain or n["fake_quant"] != n_layers \
                or n["binary_matmul"]:
            problems.append(f"bf16 QUANT policy {seed}: weights bitwise "
                            f"{same}, acc {acc} vs plain {acc_plain}, "
                            f"launches {n}")
    pol = _cnn_policy(graph, SEED + 20, QuantMode.BINARIZE, act=32.0)
    wb, ab = evaluate.upload_bits(pol, graph, dev)
    act = dict(zip((l.name for l in graph.layers), ab))
    with torch.no_grad():
        qp = evaluate._quantize_params(p16, graph, wb, QuantMode.BINARIZE,
                                       planes=True)
        got = model.apply(qp, xb["x"], act_bits=act)
        want = model.apply(apply_policy_to_params(p16, graph, pol), xb["x"],
                           act_bits=act)
        want_twin = model.apply(apply_policy_to_params(twin, graph, pol),
                                xb["x"].float(), act_bits=act)
    diff = float((got.float() - want.float()).abs().max())
    twin_d = float((want.float() - want_twin).abs().max())
    top = float(want.float().abs().max())
    limit = BF16_TWIN_FACTOR * twin_d
    ev = make_cnn_evaluator(model, p16, graph, val16, mode=QuantMode.BINARIZE)
    kernels.reset_launch_counts()
    acc_b = ev(pol)
    n = kernels.launch_counts()
    # the evaluator's accuracy is the plane form's; against the dense
    # forward's, only a sample whose top-2 gap there is within 2 x limit
    # (each logit moved by at most limit) may flip
    labels = xb["y"].long()
    acc_got = float((got.argmax(-1) == labels).float().mean() * 100.0)
    acc_want = float((want.argmax(-1) == labels).float().mean() * 100.0)
    top2 = want.float().topk(2, dim=-1).values
    near = int((top2[:, 0] - top2[:, 1] <= 2 * limit).sum())
    allowance = 100.0 * near / len(labels)
    rec["binarize"] = dict(logit_max_abs_diff=diff, twin_distance=twin_d,
                           limit=limit, logits_dtype=str(got.dtype),
                           acc=acc_b, acc_plane_form=acc_got,
                           acc_dense=acc_want, near_ties=near,
                           acc_allowance=allowance, launches=n,
                           logit_max_abs=top)
    if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got).all()) \
            or diff > limit:
        problems.append(f"bf16 BINARIZE logits ({got.dtype}) differ from "
                        f"the dense forward by {diff}, limit "
                        f"{BF16_TWIN_FACTOR} x {twin_d}")
    if acc_b != acc_got or abs(acc_b - acc_want) > allowance:
        problems.append(f"bf16 BINARIZE accuracy {acc_b}: plane form "
                        f"{acc_got}, dense {acc_want}, allowance {allowance}")
    if n["binary_matmul"] != n_layers or n["fake_quant"]:
        problems.append(f"bf16 BINARIZE evaluation launches {n}")
    rec["problems"] = problems
    emit({"phase": "bf16-train-check", **rec})
    return rec


def bf16_searches(torch, model, p16, graph, val16):
    """A short search per mode (BF16_SEARCH_EPISODES) on the bf16 CNN, run
    twice from SEED: equal policies and rewards, the mode's kernel
    launched once per searched layer and evaluation, the other never."""
    from repro_torch import kernels
    from repro_torch.quant.policy import QuantMode
    n_layers = len(graph.layers)
    recs, best, problems = {}, None, []
    for mode_name, eps in BF16_SEARCH_EPISODES:
        mode = QuantMode.QUANT if mode_name == "quant" else \
            QuantMode.BINARIZE
        mine, other = ("fake_quant", "binary_matmul") if mode_name == \
            "quant" else ("binary_matmul", "fake_quant")
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            pols, res = short_search(torch, model, p16, graph, val16,
                                     episodes=eps, mode=mode)
            runs.append((pols, res, kernels.launch_counts(),
                         time.perf_counter() - t0))
        (pols, res, n, sec), (pols2, res2, n2, sec2) = runs
        rewards = [h.reward for h in res.history]
        rewards2 = [h.reward for h in res2.history]
        same = _same_policies(pols, pols2)
        want = n_layers * sum(eps)
        recs[mode_name] = dict(
            episodes=len(rewards), policies_equal=same,
            rewards_equal=rewards == rewards2, rewards=rewards,
            best_acc=res.best_log.acc, best_avg_wbits=res.best_log.avg_wbits,
            launches=n, launches_repeat=n2, seconds=sec, seconds_repeat=sec2,
            s_per_episode=sec / max(len(rewards), 1))
        if not same or rewards != rewards2:
            problems.append(f"bf16 {mode_name} search: two runs differ")
        if n[mine] != want or n[other] or n2 != n:
            problems.append(f"bf16 {mode_name} search launches {n} / {n2}: "
                            f"want {mine} {want}, {other} 0")
        if not all(np.isfinite(rewards)):
            problems.append(f"bf16 {mode_name} search: non-finite rewards")
        if mode_name == "quant":
            best = res.best_policy
    recs["problems"] = problems
    emit({"phase": "bf16-train-search", **recs})
    return recs, best


def bf16_qat(torch, model, p16, graph, data, best):
    """qat_finetune of the bf16 search's best QUANT policy on the bf16 CNN
    (BF16_QAT_STEPS steps of bf16 batches): B5 once per searched weight a
    step, B6 never; every latent weight stays bf16 and finite; one step's
    straight-through gradients bit for bit the plain statement's."""
    from repro_torch import kernels
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.core.evaluate import upload_bits
    from repro_torch.quant.apply import get_path, set_path
    from repro_torch.quant.linear_quant import fake_quant_per_channel
    from repro_torch.train.loop import upload_batch, value_and_grad
    from repro_torch.train.qat import make_qat_loss, qat_finetune
    dev = torch.device("cuda")

    def data_fn(i):
        return _bf16_images(torch, data.batch(QAT_DATA + i, QAT_BATCH))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tuned = qat_finetune(model, p16, graph, best, data_fn,
                         steps=BF16_QAT_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    problems = []
    want = len(graph.layers) * BF16_QAT_STEPS
    if launches["fake_quant"] != want or launches["binary_matmul"]:
        problems.append(f"bf16 QAT launches {launches}: want fake_quant "
                        f"{want}, binary_matmul 0")
    leaves = tree_leaves(tuned)
    if not all(t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())
               for t in leaves):
        problems.append("bf16 QAT: a latent weight left bf16 or is not "
                        "finite")
    moved = sum(not torch.equal(a, b)
                for a, b in zip(leaves, tree_leaves(p16)))
    batch = upload_batch(data_fn(0), dev)
    l_ste, g_ste = value_and_grad(make_qat_loss(model, graph, best,
                                                device=dev), p16, batch)
    wb, ab = upload_bits(best, graph, dev)
    qp = p16
    for layer, bits in zip(graph.layers, wb):
        qp = set_path(qp, layer.param_path, fake_quant_per_channel(
            get_path(p16, layer.param_path), bits, axis=layer.channel_axis))
    act = dict(zip((l.name for l in graph.layers), ab))
    l_plain, g_plain = value_and_grad(
        lambda p: model.loss(p, batch, act_bits=act), qp)
    pairs = list(zip(tree_leaves(g_ste), tree_leaves(g_plain)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    if differ or not torch.equal(l_ste, l_plain):
        problems.append(f"bf16 STE gradients differ from the plain "
                        f"statement's in {differ} of {len(pairs)} leaves")
    rec = dict(steps=BF16_QAT_STEPS, batch=QAT_BATCH,
               s_per_step=seconds / BF16_QAT_STEPS, launches=launches,
               leaves=len(leaves), leaves_moved=moved,
               loss_dtype=str(l_ste.dtype), ste_leaves_differing=differ,
               problems=problems)
    emit({"phase": "bf16-train-qat", **rec})
    return rec


def bf16_lm_evaluator(torch, cfg, lm, policy):
    """One make_lm_evaluator call on bf16 gemma2-2b weights
    (LM.init(SEED, dtype=bf16), GEMMA_LAYERS) against a plain evaluation
    (check_lm_evaluator), the logits held within BF16_TWIN_FACTOR x the
    plain forward's distance from its fp32 twin."""
    from repro_torch import backend
    from repro_torch.core import evaluate
    from repro_torch.data import TokenStream
    from repro_torch.quant.apply import apply_policy_to_params
    dev = torch.device("cuda")
    p16 = lm.init(SEED, "cuda", dtype=torch.bfloat16)
    graph = lm.graph(seq_len=LM_EVAL_LEN, batch=LM_EVAL_BATCH)
    val = TokenStream(vocab=cfg.vocab).batch(0, LM_EVAL_BATCH, LM_EVAL_LEN)
    vb = {k: backend.upload(np.asarray(v), dev) for k, v in val.items()}
    with torch.no_grad():
        want = evaluate.lm_logits(lm, apply_policy_to_params(
            p16, graph, policy), graph, policy, vb, attn_impl="ref").float()
        twin = _cast_tree(torch, p16, torch.float32)
        want_twin = evaluate.lm_logits(lm, apply_policy_to_params(
            twin, graph, policy), graph, policy, vb, attn_impl="ref")
        twin_d = float((want - want_twin).abs().max())
    del want, want_twin, twin
    gc.collect()
    torch.cuda.empty_cache()
    rec = check_lm_evaluator(torch, cfg, lm, p16, policy,
                             tol=BF16_TWIN_FACTOR * twin_d,
                             label="bf16-train-lm-eval")
    rec["twin_distance"] = twin_d
    del p16
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _tree_equal(torch, a, b) -> int:
    """How many leaves of two parameter trees differ in their bits."""
    from repro_torch.core.ddpg import tree_leaves
    return sum(not torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def bf16_trainer(torch, cfg, lm, tmp):
    """train_trainer on bf16 gemma2-2b (LM.init(SEED + 1, dtype=bf16),
    GEMMA_LAYERS, 1 x LM_TRAIN_LEN tokens, remat, 8-bit AdamW), writing
    only the checkpoint that the resume reads (a save of the ~8.5 GB tree
    takes ~13 s on the H100 machine).  Then the same steps as a plain loop
    of value_and_grad and AdamW.update, each step held to:
      * the Trainer: its loss, and at the end every parameter, bit for
        bit;
      * AdamW's fp32 statement: the update of the parameters and
        gradients upcast, from the same state, gives the same state bit
        for bit and parameters that round once to the step's; and the
        step moves some parameter (a bf16 update may not round away
        everywhere);
      * its fp32 twin (the starting parameters upcast, trained by the
        same steps in fp32): its loss within BF16_TWIN_FACTOR x the
        largest distance of a plain bf16 forward from the fp32 forward on
        the same parameters upcast, over the run's steps (a yardstick
        that the change of batch does not move)."""
    from repro_torch.core.ddpg import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.optim import AdamW
    from repro_torch.train.loop import upload_batch, value_and_grad
    dev = torch.device("cuda")
    stream = TokenStream(vocab=cfg.vocab)

    def data_fn(i):
        return stream.batch(i, 1, LM_TRAIN_LEN)
    opt = AdamW(lr=BF16_TRAIN_LR, state_bits=8)
    p0 = lm.init(SEED + 1, "cuda", dtype=torch.bfloat16)
    rec, ref = train_trainer(torch, lm, p0, opt, data_fn, tmp,
                             BF16_TRAIN_STEPS, BF16_TRAIN_CKPT,
                             BF16_TRAIN_PREEMPT, keep=1,
                             loss_kwargs={"remat": True}, skip_saves=True)
    problems, losses = rec["problems"], rec["losses"]
    trained = ref.pop("params")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # the plain loop, each step beside AdamW's fp32 statement
    p16, state = p0, opt.init(p0)
    plain_losses, fwd_dists, moved, stmt_differ = [], [], [], 0
    for i in range(BF16_TRAIN_STEPS):
        b = upload_batch(data_fn(i), dev)
        loss, g = value_and_grad(lambda p: lm.loss(p, b, remat=True), p16)
        up = _cast_tree(torch, p16, torch.float32)
        with torch.no_grad():
            fwd32 = lm.loss(up, b)
        plain_losses.append(float(loss))
        fwd_dists.append(abs(float(loss) - float(fwd32)))
        nxt, nstate, _ = opt.update(p16, g, state)
        g32 = _cast_tree(torch, g, torch.float32)
        del g
        want, wstate, _ = opt.update(up, g32, state)
        del up, g32
        stmt_differ += _tree_equal(torch, nxt,
                                   _cast_tree(torch, want, torch.bfloat16))
        stmt_differ += _tree_equal(torch, nstate, wstate)
        moved.append(sum(int((x != y).sum()) for x, y in
                         zip(tree_leaves(nxt), tree_leaves(p16))))
        del want, wstate
        p16, state = nxt, nstate
    trainer_differ = _tree_equal(torch, p16, trained)
    n_elems = sum(t.numel() for t in tree_leaves(p0))
    d16 = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(tree_leaves(p16), tree_leaves(p0)))
    del p16, state, nxt, nstate, trained
    gc.collect()
    torch.cuda.empty_cache()
    # the fp32 twin
    twin = _cast_tree(torch, p0, torch.float32)
    state = opt.init(twin)
    twin_losses = []
    for i in range(BF16_TRAIN_STEPS):
        b = upload_batch(data_fn(i), dev)
        loss, g = value_and_grad(lambda p: lm.loss(p, b, remat=True), twin)
        twin, state, _ = opt.update(twin, g, state)
        twin_losses.append(float(loss))
        del g
    d32 = max(float((x - y.float()).abs().max())
              for x, y in zip(tree_leaves(twin), tree_leaves(p0)))
    del twin, state, p0
    gc.collect()
    torch.cuda.empty_cache()
    if plain_losses != losses or trainer_differ:
        problems.append(f"bf16 plain loop differs from the Trainer: losses "
                        f"{plain_losses} vs {losses}, {trainer_differ} "
                        "parameter leaves")
    if stmt_differ:
        problems.append(f"bf16 AdamW differs from its fp32 statement rounded "
                        f"once in {stmt_differ} leaves over the steps")
    if not all(moved):
        problems.append(f"a bf16 step moved no parameter: {moved} elements")
    limit = BF16_TWIN_FACTOR * max(fwd_dists)
    dists = [abs(a - b) for a, b in zip(losses, twin_losses)]
    if not all(np.isfinite(losses)) or any(d > limit for d in dists):
        problems.append(f"bf16 losses {losses} against the fp32 twin's "
                        f"{twin_losses}: distances {dists}, limit {limit}")
    rec.update(arch=cfg.name, layers=cfg.n_layers, tokens=[1, LM_TRAIN_LEN],
               twin_losses=twin_losses, twin_distances=dists,
               forward_twin_distances=fwd_dists, twin_limit=limit,
               elements=n_elems, elements_moved=moved,
               statement_leaves_differing=stmt_differ,
               trainer_leaves_differing=trainer_differ,
               max_abs_change=d16, twin_max_abs_change=d32)
    emit({"phase": "bf16-train-lm", **rec})
    return rec


def phase_bf16_train(torch, cfg, lm, sub, policy):
    """bf16 parameters through B5 and B6: (a) the search phase's CIF10
    substrate rounded to bf16 (its fp32 twin the same values upcast):
    the evaluators, two short searches per mode and QAT; one LM
    evaluation on bf16 gemma2-2b; (b) the bf16 gemma2-2b Trainer; (c)
    two bf16 granite-moe LM.loss steps twice, bit for bit."""
    import tempfile
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    t0 = time.perf_counter()
    model, graph = sub["model"], sub["graph"]
    p16 = _cast_tree(torch, sub["params"], torch.bfloat16)
    twin = _cast_tree(torch, p16, torch.float32)
    val16 = _bf16_images(torch, sub["val"])
    checks = bf16_evaluators(torch, model, p16, twin, graph, val16)
    searches, best = bf16_searches(torch, model, p16, graph, val16)
    qat = bf16_qat(torch, model, p16, graph, sub["data"], best)
    lm_eval = bf16_lm_evaluator(torch, cfg, lm, policy)
    t_a = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        trainer = bf16_trainer(torch, cfg, lm, tmp)
    t_b = time.perf_counter() - t0 - t_a
    moe_cfg = ARCHS[MOE_ARCH].config
    moe = train_lm(torch, moe_cfg, LM(moe_cfg), dtype=torch.bfloat16,
                   probe=False, label="bf16-train-moe")
    recs = dict(checks=checks, searches=searches, qat=qat, lm_eval=lm_eval,
                trainer=trainer, moe=moe, seconds=time.perf_counter() - t0,
                seconds_a=t_a, seconds_b=t_b)
    emit({"phase": "bf16-train", "seconds": recs["seconds"],
          "seconds_a": t_a, "seconds_b": t_b,
          "seconds_c": recs["seconds"] - t_a - t_b})
    problems = [p for r in (checks, searches, qat, lm_eval, trainer, moe)
                for p in r["problems"]]
    if problems:
        raise AssertionError("bf16-train checks failed: " +
                             "; ".join(problems))
    return recs


# ----------------------------------------------------------------- shard
SHARD_TRAIN_LEN = 512               # (b)'s step: 1 x 512, as train-lm's
SHARD_PREFILL = (2, 2048)           # (c)
SHARD_EXCHANGE_REPS = 3


def _dtensors(tree, specs, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding import specs as sh
    return sh.tree_map_with_path(
        lambda p, t: distribute_tensor(t, mesh, sh.to_placements(
            specs if sh.is_spec(specs) else sh.spec_at(specs, p), mesh)),
        tree)


def _local(tree):
    from repro_torch.core.ddpg import tree_map
    return tree_map(lambda t: t.to_local() if hasattr(t, "to_local")
                    else t, tree)


def _leaves_equal(a, b) -> int:
    """How many leaves of two trees differ (bit for bit)."""
    from repro_torch.core.ddpg import tree_leaves
    return sum(not torch_equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def torch_equal(x, y) -> bool:
    import torch
    return x.shape == y.shape and x.dtype == y.dtype and \
        bool(torch.equal(x, y))


def phase_shard(torch, cfg, model, device="cuda", impl="cuda",
                train_len=SHARD_TRAIN_LEN, prefill=SHARD_PREFILL):
    """A11 on one card (the port's launch/, sharding/ and the model's mesh
    hooks): (a) the compressed exchange, (b) the compressed train step on
    the 1x1 host mesh and its roofline, (c) the sharded prefill (module
    docstring, phase 8).  ``device`` / ``impl`` let a CPU rehearsal run the
    same checks at a smoke size."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.core.ddpg import tree_leaves, tree_map
    from repro_torch.data import TokenStream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import hidden_rules, make_train_step
    from repro_torch.models.api import ShapeCfg
    from repro_torch.optim import AdamW
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.collectives import (_q8, compressed_allreduce,
                                                  exchanged_bytes)
    from repro_torch.sharding.ctx import sharding_rules
    from repro_torch.train.loop import upload_batch, value_and_grad
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    mesh = make_host_mesh(device)
    problems = []
    world = dist.get_world_size()
    stream = TokenStream(vocab=cfg.vocab)
    batches = [upload_batch(stream.batch(i, 1, train_len), dev)
               for i in range(2)]

    # (a) the compressed exchange on LM.loss gradients
    params = model.init(SEED + 2, device)
    loss, grads = value_and_grad(
        lambda p: model.loss(p, batches[0], remat=True), params)
    times = []
    for _ in range(SHARD_EXCHANGE_REPS):
        sync()
        t0 = time.perf_counter()
        out = compressed_allreduce({"g": grads, "l": loss})
        sync()
        times.append(time.perf_counter() - t0)

    def deq(g):
        if g.ndim == 0 or g.numel() < 256:
            return g
        q, sc = _q8(g.to(torch.float32))
        return (q.to(torch.float32) * sc).to(g.dtype)
    want = tree_map(deq, grads)
    differ = _leaves_equal(out["g"], want) + (
        not torch_equal(out["l"], loss))
    nbytes = exchanged_bytes(grads)
    if differ:
        problems.append(f"compressed exchange at n=1 differs from the "
                        f"q8-dequantized gradients in {differ} leaves")
    rec_a = dict(world=world, cards=torch.cuda.device_count() if cuda else 0,
                 leaves=len(tree_leaves(grads)), leaves_differing=differ,
                 exchange_ms=sorted(times)[len(times) // 2] * 1e3,
                 exchange_ms_all=[t * 1e3 for t in times],
                 payload_bytes=nbytes["compressed"],
                 fp32_bytes=nbytes["fp32"],
                 ratio=nbytes["compressed"] / nbytes["fp32"])
    emit({"phase": "shard-exchange", **rec_a})
    del out, want, grads, loss

    # (b) make_train_step(compress_pod=True) on the 1x1 mesh, twice, and
    # the plain step on q8-dequantized gradients
    opt = AdamW(lr=1e-4, state_bits=8)
    step = make_train_step(model, opt, lr=1e-4, compress_pod=True)
    rules = hidden_rules(mesh)
    pspecs = sh.param_specs(params, mesh, cfg)

    def sharded_args(i):
        p = model.init(SEED + 2, device)
        st = opt.init(p)
        return (_dtensors(p, pspecs, mesh),
                _dtensors(st, sh.opt_specs(st, pspecs, mesh), mesh),
                _dtensors(batches[i], sh.batch_specs(batches[i], mesh),
                          mesh))

    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sharded_run():
        P, S, _ = sharded_args(0)
        losses, ts = [], []
        with sharding_rules(mesh, rules):
            for i in range(2):
                B = _dtensors(batches[i], sh.batch_specs(batches[i], mesh),
                              mesh)
                sync()
                t0 = time.perf_counter()
                P, S, m = step(P, S, B)
                sync()
                ts.append(time.perf_counter() - t0)
                losses.append(m["loss"].to_local())
        return _local(P), _local(S), losses, ts

    del params                  # (a)'s; each run below makes its own
    run1 = sharded_run()
    p = model.init(SEED + 2, device)
    st = opt.init(p)
    plain_losses, plain_ts = [], []
    for i in range(2):
        sync()
        t0 = time.perf_counter()
        loss, g = value_and_grad(
            lambda q: model.loss(q, batches[i], remat=True), p)
        g = tree_map(deq, g)
        p, st, _ = opt.update(p, g, st, lr=1e-4)
        del g
        sync()
        plain_ts.append(time.perf_counter() - t0)
        plain_losses.append(loss)
    vs_plain = _leaves_equal(run1[0], p) + _leaves_equal(run1[1], st)
    del p, st
    run2 = sharded_run()
    twice = _leaves_equal(run1[0], run2[0]) + _leaves_equal(run1[1], run2[1])
    losses_equal = all(torch_equal(a, b) for a, b in
                       zip(run1[2], plain_losses)) and \
        all(torch_equal(a, b) for a, b in zip(run1[2], run2[2]))
    if twice or vs_plain or not losses_equal:
        problems.append(f"compressed train step: {twice} leaves differ "
                        f"between two runs, {vs_plain} from the plain step "
                        f"on q8-dequantized gradients, losses equal "
                        f"{losses_equal}")
    rec_b = dict(layers=cfg.n_layers, tokens=[1, train_len],
                 step_s=run1[3] + run2[3], plain_step_s=plain_ts,
                 losses=[float(x) for x in run1[2]],
                 leaves_differing_twice=twice,
                 leaves_differing_vs_plain=vs_plain,
                 losses_equal=losses_equal,
                 peak_mem_bytes=torch.cuda.max_memory_allocated()
                 if cuda else None)
    emit({"phase": "shard-train", **rec_b})
    del run1, run2
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the dry run's counts of that step on the 1x1 mesh, and its roofline
    counted = count_step(step, sharded_args(0), mesh, rules)
    cell = dict(arch=cfg.name, shape="train_1x512", mesh="host_1x1",
                devices=1, dtype="float32",
                tf32=bool(torch.backends.cuda.matmul.allow_tf32),
                mesh_axes=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                **counted)
    row = roofline.analyze_cell(cell, cfg, ShapeCfg("train_1x512", train_len,
                                                    1, "train"))
    measured = min(rec_b["step_s"][1:]) if len(rec_b["step_s"]) > 1 \
        else rec_b["step_s"][0]
    rec_r = dict(flops=counted["stats"]["flops_per_device"],
                 bytes=counted["stats"]["bytes_traffic_per_device"],
                 peak_flops=row["peak_flops"], t_compute_s=row["t_compute_s"],
                 t_memory_s=row["t_memory_s"],
                 t_collective_s=row["t_collective_s"],
                 dominant=row["dominant"], bound_s=row["bound_s"],
                 model_flops=row["model_flops"],
                 useful_ratio=row["useful_ratio"], measured_s=measured,
                 measured_over_bound=measured / row["bound_s"])
    emit({"phase": "shard-roofline", **rec_r})
    if cuda and measured < row["bound_s"]:
        problems.append(f"the step ({measured:.4f} s) beat its roofline's "
                        f"largest term ({row['bound_s']:.4f} s): the "
                        f"constants or the counts are wrong")

    # (c) the sharded prefill against the unsharded one
    B, S = prefill
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)).to(dev)
    params = model.init(SEED, device)
    reset_launch_counts()
    cache = model.init_cache(B, S, dtype=torch.float32, device=device)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache,
                                  attn_impl=impl)
    sync()
    k1_plain = launch_counts()["flash_attention"]
    cache_s = model.init_cache(B, S, dtype=torch.float32, device=device)
    P = _dtensors(params, sh.param_specs(params, mesh, cfg), mesh)
    C = _dtensors(cache_s, sh.cache_specs(cache_s, cfg, mesh, False), mesh)
    T = _dtensors(tokens, sh.batch_specs(tokens, mesh), mesh)
    reset_launch_counts()
    t0 = time.perf_counter()
    with sharding_rules(mesh, rules):
        logits_s, C = model.prefill(P, {"tokens": T}, C, attn_impl=impl)
    sync()
    sharded_s = time.perf_counter() - t0
    k1_sharded = launch_counts()["flash_attention"]
    logits_differ = not torch_equal(logits_s.to_local(), logits)
    cache_differ = _leaves_equal(_local(C), cache)
    if logits_differ or cache_differ or k1_sharded != k1_plain:
        problems.append(f"sharded prefill: logits differ {logits_differ}, "
                        f"{cache_differ} cache leaves differ, K1 launches "
                        f"{k1_sharded} against {k1_plain}")
    rec_c = dict(batch=B, seq=S, k1_launches=k1_sharded,
                 k1_launches_plain=k1_plain, logits_differ=logits_differ,
                 cache_leaves_differing=cache_differ, sharded_s=sharded_s)
    emit({"phase": "shard-prefill", **rec_c})
    dist.destroy_process_group()
    rec = dict(exchange=rec_a, train=rec_b, roofline=rec_r, prefill=rec_c,
               seconds=time.perf_counter() - t_phase, problems=problems)
    emit({"phase": "shard", "seconds": rec["seconds"],
          "problems": problems})
    if problems:
        raise AssertionError("shard checks failed: " + "; ".join(problems))
    return rec


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
    streams = run.pop("_streams")
    store = phase_cache_and_store(torch, cfg, model, params, policy, streams)
    bf16 = phase_bf16(torch, cfg, model, policy, streams, card)
    search, substrate = phase_search(torch, cfg, model, params, policy)
    del params                  # the serving phases' weights
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(torch)
    ssm = phase_ssm(torch)
    frontends = phase_frontends(torch)
    families = phase_bf16_families(torch, card)
    train = phase_train(torch, cfg, model, card, substrate)
    bf16_train = phase_bf16_train(torch, cfg, model, substrate, policy)
    shard = phase_shard(torch, cfg, model)
    launches = dict(rec_a["launches"])
    launches["paged_attention"] = \
        run["runs"]["overlap"]["launches"]["paged_attention"]
    for r in search["runs"]:
        name = "fake_quant" if r["mode"] == "quant" else "binary_matmul"
        launches[name] = r["launches"][name]
    gen = {"generate": rec_a["launches"],
           "generate_bf16": store["bf16"]["generate_launches"],
           "generate_int8_store": store["int8"]["generate"]["launches"],
           "bf16_dense_generate": bf16["dense"]["launches"],
           "bf16_packed_generate": bf16["packed"]["launches"],
           "moe_generate": moe["engine_a"]["launches"],
           "ssm_generate": ssm["engine_a"]["launches"],
           "ssm_gate_generate": ssm["gate"]["launches_a"],
           "hybrid_generate": ssm["hybrid_check"]["launches_a"],
           "audio_prefill_decode": frontends["audio"]["check"]["launches_a"],
           "audio_gate": frontends["audio"]["gate"]["launches_a"],
           "vision_prefill_decode":
               frontends["vision"]["check"]["launches_a"],
           "vision_bf16": frontends["vision"]["bf16"]["launches"],
           **{f"bf16_{k.replace('-', '_')}_generate": r["launches"]
              for k, r in {**families["ssm"]["generate"],
                           **families["ssm"]["gate"]}.items()},
           "bf16_audio_prefill_decode": families["audio"]["launches"],
           "bf16_vision_prefill_decode": families["vision"]["launches"]}
    runs = {"run": run["runs"]["overlap"]["launches"],
            "run_bf16": store["bf16"]["launches"],
            "run_int8_store": store["int8"]["launches"],
            "bf16_run": bf16["run"]["launches"],
            "moe_run": moe["run"]["launches"],
            "moe_run_cf0": moe["run_cf0"]["launches"],
            "ssm_run": ssm["run"]["launches"],
            "ssm_gate_run": ssm["gate_run"]["launches"],
            "hybrid_run": ssm["hybrid_run"]["launches"],
            "vision_paged_decode": frontends["vision"]["paged"]["launches"],
            "bf16_ssm_gate_run": families["ssm"]["gate_run"]["launches"],
            "bf16_hybrid_run": families["hybrid"]["launches"],
            "bf16_vision_paged_decode":
                families["vision"]["paged"]["launches"]}
    bf16_s = bf16_train["searches"]
    by_path = {"fake_quant": {
        "search": launches["fake_quant"],
        "qat": train["qat"]["launches"]["fake_quant"],
        "search_bf16": bf16_s["quant"]["launches"]["fake_quant"],
        "qat_bf16": bf16_train["qat"]["launches"]["fake_quant"],
        "lm_eval_bf16": bf16_train["lm_eval"]["launches"]["fake_quant"]},
        "binary_matmul": {
            "search": launches["binary_matmul"],
            "search_bf16": bf16_s["binarize"]["launches"]["binary_matmul"]}}
    for name in ("flash_attention", "quant_matmul", "packed_matmul",
                 "paged_attention"):
        by_path[name] = {p: c[name] for p, c in {**gen, **runs}.items()}
    for name in ("fake_quant", "binary_matmul"):
        launches[name] = sum(by_path[name].values())
    kernels = summarize(rows, launches, by_path)
    result = {"card": card, "kernel_rows": rows, "engine_a": rec_a,
              "engine_b": rec_b, "checks": checks, "run": run,
              "cache_and_store": store, "bf16": bf16, "moe": moe,
              "ssm": ssm,
              "frontends": frontends, "bf16_families": families,
              "search": search, "train": train, "bf16_train": bf16_train,
              "shard": shard,
              "kernels": kernels,
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
