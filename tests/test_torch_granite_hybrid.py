"""granite-4.0-h-small (``granitemoehybrid``) in the port, on the CPU at
its smoke size, held against the benchmark's plain reference
(``bench/reference/granite_hybrid.py``, the file the benchmark's check
runs) on seeded random weights.

* The full forward pass: logits at rtol = atol = 1e-4 (fp32 on both
  sides; only the order of summation differs), plain weights and a
  kernel-wise policy's fake-quant store with activation QBN 8.
* Serving: every position whose logits a ``model_step`` computed, through
  ``serve`` / ``run(prefill="chunked")`` with chunks that split prompts
  inside the scan's blocks and across them, slots reused after a finish
  and a prompt preempted and requeued, against the reference's full
  forward pass over the request's prompt and served tokens, at the same
  tolerance.  The control zeroes the carried state between chunks and
  must fail it.
* ``ssm.mamba_step`` against the full-sequence scan and the decode step,
  with conv over x alone and over x, B and C.
* Streams: chunked ``run()`` equal to monolithic ``run()`` and to
  ``generate()`` for mamba2-smoke, jamba-smoke and granite-h-smoke, overlap
  on and off.
* The router's softmax, top-k and renormalisation equal Granite's top-k
  gating (softmax over the top-k logits).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.harness import check, system  # noqa: E402
from bench.reference import granite_hybrid as ref  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.api import Mamba2Cfg, SSMCfg  # noqa: E402
from repro_torch.models.layers import (POS_SENTINEL, StepLayout,  # noqa: E402
                                       moe_route)
from repro_torch.quant.apply import apply_policy_to_params  # noqa: E402
from repro_torch.serve import FrontEnd, ServeEngine  # noqa: E402

ARCH = "granite-4.0-h-small"
TOL = dict(rtol=1e-4, atol=1e-4)
SEED = 2 ** 31 + 7
# (prompt_len, n_new): more requests than slots, prompts over several
# chunks and inside one, a one-token prompt
SHAPES = [(13, 4), (5, 6), (9, 3), (3, 5), (17, 2), (1, 3), (22, 4)]


def _dims(c):
    """The reference's ``dims`` for the port's config ``c``."""
    m, s = c.moe, c.ssm
    return {"d_model": c.d_model, "n_layers": c.n_layers,
            "pattern": ["attention" if b.kind == "attn" else "mamba"
                        for b in c.pattern],
            "n_heads": c.n_heads, "n_kv_heads": c.n_kv_heads,
            "head_dim": c.hdim, "vocab": c.vocab,
            "vocab_padded": c.vocab_padded, "norm_eps": c.norm_eps,
            "ssm": {"d_state": s.d_state, "d_conv": s.d_conv,
                    "expand": s.expand, "head_dim": s.head_dim,
                    "chunk": s.chunk},
            "moe": {"n_experts": m.n_experts, "top_k": m.top_k,
                    "d_ff": m.d_ff, "shared_d_ff": m.shared_d_ff},
            "mup": {"embedding_multiplier": c.embedding_multiplier,
                    "residual_multiplier": c.residual_multiplier,
                    "attention_multiplier": c.attention_multiplier,
                    "logits_scaling": c.logits_scaling}}


MODEL = LM(get(ARCH).smoke)
CFG = {"name": ARCH, "family": "granite_hybrid", "dims": _dims(MODEL.cfg),
       "policy": {"weight_qbns": [0, 2, 3, 4, 5, 6, 8], "act_qbn": 8,
                  "max_groups": 64}}
_W = {}


def _weights():
    """The reference's layout drawn from SEED: the port's tree too."""
    if not _W:
        _W["w"] = system.make_weights(CFG, SEED, "cpu")
    return _W["w"]


def _requests(shapes=SHAPES, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, MODEL.cfg.vocab, size=s).astype(np.int32), n)
            for s, n in shapes]


def test_layout_sites_and_graph_agree():
    """The reference's leaves are the port's parameter tree, leaf for leaf
    and shape for shape, and its policy sites the port's graph (the shared
    expert's three among them)."""
    ours = MODEL.init(0, device="cpu")
    theirs = _weights()

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], path + (k,))
        elif isinstance(t, tuple):
            for i, v in enumerate(t):
                yield from leaves(v, path + (i,))
        else:
            yield path, tuple(t.shape)
    assert list(leaves(ours)) == list(leaves(theirs))
    graph, _ = system.program_policy(CFG, MODEL,
                                     system.make_policy(CFG, SEED))
    assert "p0.shared.wg" in {l.name for l in graph.layers}


@pytest.mark.parametrize("act", [None, 8])
def test_forward_matches_reference(act):
    """LM.apply against the reference's full forward pass: on the plain
    weights, and on a kernel-wise policy's fake-quant store with
    activation QBN 8 (the reference dequantizes the same grid)."""
    toks = torch.as_tensor(
        system.seed_stream(SEED, "t").integers(0, MODEL.cfg.vocab, 41))
    if act is None:
        w, act_bits = _weights(), None
        port_w = w
    else:
        policy = system.make_policy(CFG, SEED)
        graph, qp = system.program_policy(CFG, MODEL, policy)
        port_w = apply_policy_to_params(_weights(), graph, qp)
        act_bits = MODEL.block_act_bits(graph, [float(act)] *
                                        len(graph.layers))
        w = check.reference_weights(CFG, SEED, policy, "cpu")
    want, _ = MODEL.apply(port_w, {"tokens": toks[None]}, act_bits=act_bits,
                          attn_impl="ref")
    got = ref.logits(w, CFG["dims"], toks, act, range(toks.numel()))
    torch.testing.assert_close(got, want[0], **TOL)


def test_router_topk_softmax_is_granite_gating():
    """The port's routing (softmax over all experts, the top k, gates
    renormalised) picks Granite's experts with Granite's gates (softmax
    over the top k logits)."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(257, 72, generator=g) * 3.0
    gv, gi = moe_route(torch.softmax(logits, dim=-1), 10)
    rv, ri = ref.granite_gates(logits, 10)
    assert torch.equal(gi, ri)
    torch.testing.assert_close(gv, rv, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- serving
def _served_logits(eng, reqs, **kw):
    """Serve ``reqs`` through run(); returns (outputs, stats, rows):
    ``rows[rid]`` lists (position, logits) of every row whose logits a
    model_step computed for that request (the slot's request read from
    the scheduler when the call is made)."""
    sched = {}
    session = eng._session

    def spy_session(*a):
        out = session(*a)
        sched["s"] = out[1]
        return out
    step = eng._model_step

    def spy_step(params, tokens, layout, cache, cols, *a, **k):
        logits, cache = step(params, tokens, layout, cache, cols, *a, **k)
        pos = layout.pos.numpy()
        for r, c in enumerate(cols.numpy()):
            if pos[r, 0] == POS_SENTINEL:
                continue
            rid = sched["s"].slot(int(layout.slot_map[r])).req.rid
            rows.setdefault(rid, []).append((int(pos[r, c]),
                                             logits[r, 0].clone()))
        return logits, cache
    rows = {}
    eng._session, eng._model_step = spy_session, spy_step
    try:
        res = eng.run(reqs, **kw)
    finally:
        del eng._session, eng._model_step
    return res["outputs"], res["stats"], rows


def _worst_gap(reqs, outputs, rows):
    """The largest |served - reference| over every served position,
    against rtol = atol = 1e-4 (0 or less: within it)."""
    worst = -np.inf
    for rid, ((prompt, _), out) in enumerate(zip(reqs, outputs)):
        seq = torch.as_tensor(np.concatenate([prompt, out[:-1]])).long()
        want = ref.logits(_weights(), CFG["dims"], seq, None,
                          range(seq.numel()))
        for pos, got in rows[rid]:
            w = want[pos]
            excess = (got - w).abs() - (TOL["atol"] + TOL["rtol"] * w.abs())
            worst = max(worst, float(excess.max()))
    return worst


SERVE_CASES = {
    # chunks of 5 inside and across the scan's blocks of 8; slots reused
    "chunk5": dict(page_size=4, max_slots=3, chunk_tokens=5,
                   token_budget=9),
    # chunks of 12: the step's own scan spans two blocks
    "chunk12": dict(page_size=4, max_slots=2, chunk_tokens=12,
                    token_budget=14, overlap=False),
    # a pool too small for every prompt: prefills preempted and requeued
    "requeue": dict(page_size=4, max_slots=3, chunk_tokens=4,
                    token_budget=7, num_pages=9),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_served_logits_match_reference(case):
    """Every logits row the token-budget steps computed (prompt chunks'
    last columns and decode tokens) against the reference's full forward
    pass at that position; the streams are generate()'s."""
    eng = ServeEngine(MODEL, _weights(), max_len=32, device="cpu")
    reqs = _requests()
    outputs, stats, rows = _served_logits(eng, reqs, **SERVE_CASES[case])
    assert stats.mode == "chunked"
    if case == "requeue":
        assert stats.requeues > 0
    assert _worst_gap(reqs, outputs, rows) <= 0.0
    for (prompt, n), out in zip(reqs, outputs):
        np.testing.assert_array_equal(
            out, eng.generate(prompt[None], n)["tokens"][0])


def test_zeroed_state_control_fails(monkeypatch):
    """The control: the same comparison with every row's carried state
    and conv window zeroed before each step fails the tolerance, so the
    comparison sees the state that chunks hand on."""
    step = ssm_mod.mamba_step

    def forgetful(params, x, cache, layout, cfg, d_model):
        cache = {k: torch.zeros_like(v) for k, v in cache.items()}
        return step(params, x, cache, layout, cfg, d_model)
    monkeypatch.setattr(ssm_mod, "mamba_step", forgetful)
    eng = ServeEngine(MODEL, _weights(), max_len=32, device="cpu")
    reqs = _requests()
    outputs, _, rows = _served_logits(eng, reqs, **SERVE_CASES["chunk5"])
    assert _worst_gap(reqs, outputs, rows) > 0.0


@pytest.mark.parametrize("ssm_cfg", [
    SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8),
    Mamba2Cfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)],
    ids=["conv_x", "conv_xbc"])
def test_mamba_step_matches_full_scan_and_decode(ssm_cfg):
    """Row 0 takes a 13-token sequence in chunks of 5, 1, 4 and 3 columns
    (padded to 5; the first chunk at position 0 starts from zeros though
    its slot held state): its outputs, final state and window are the
    full-sequence forward's.  Row 1 is empty every step: its state and
    window stay as they were, bit for bit.  A one-column step equals
    mamba_decode_step."""
    d = 32
    g = torch.Generator().manual_seed(1)

    def lin(fan_in, *shape):
        return torch.randn(shape, generator=g) / fan_in ** 0.5

    params = ssm_mod.init_mamba_params(lin, lambda *s: torch.zeros(s), d,
                                       ssm_cfg)
    params["dt_bias"] = torch.randn(params["dt_bias"].shape, generator=g)
    S, w = 13, 5
    x = torch.randn(1, S, d, generator=g)
    y_full, final = ssm_mod.mamba_forward(params, x, ssm_cfg, d)
    cache = ssm_mod.init_mamba_cache(2, d, ssm_cfg, torch.float32)
    cache = {k: torch.randn(v.shape, generator=g) for k, v in cache.items()}
    before = {k: v[1].clone() for k, v in cache.items()}
    ys, p0 = [], 0
    for n in (5, 1, 4, 3):
        xs = torch.zeros(2, w, d)
        xs[0, :n] = x[0, p0:p0 + n]
        pos = torch.full((2, w), POS_SENTINEL, dtype=torch.int32)
        pos[0, :n] = torch.arange(p0, p0 + n)
        y, cache = ssm_mod.mamba_step(params, xs, cache, StepLayout.of(pos),
                                      ssm_cfg, d)
        ys.append(y[0, :n])
        p0 += n
    torch.testing.assert_close(torch.cat(ys)[None], y_full, rtol=1e-5,
                               atol=1e-5)
    for key in ("state", "conv"):
        torch.testing.assert_close(cache[key][0], final[key][0], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(cache[key][1], before[key])
    tok = torch.randn(2, 1, d, generator=g)
    y_dec, dec = ssm_mod.mamba_decode_step(params, tok, cache, ssm_cfg, d)
    y_step, step = ssm_mod.mamba_step(
        params, tok, cache,
        StepLayout.of(torch.tensor([[S], [S + 4]], dtype=torch.int32)),
        ssm_cfg, d)
    torch.testing.assert_close(y_step, y_dec, rtol=1e-5, atol=1e-5)
    for key in ("state", "conv"):
        torch.testing.assert_close(step[key], dec[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b",
                                  ARCH])
def test_chunked_streams_equal_monolithic_and_generate(arch):
    """run() (chunked, overlap on and off, chunks of 3 under a budget of
    6) and run(prefill="monolithic") give every request generate()'s
    stream, more requests than slots."""
    m = LM(get(arch).smoke)
    eng = ServeEngine(m, m.init(0, device="cpu"), max_len=32, device="cpu")
    reqs = _requests(seed=11)
    want = [eng.generate(p[None], n)["tokens"][0] for p, n in reqs]
    kw = dict(page_size=4, max_slots=3)
    for extra in (dict(chunk_tokens=3, token_budget=6),
                  dict(chunk_tokens=3, token_budget=6, overlap=False),
                  dict(prefill="monolithic")):
        res = eng.run(reqs, **kw, **extra)
        assert res["stats"].mode == extra.get("prefill", "chunked")
        for i, (out, w) in enumerate(zip(res["outputs"], want)):
            np.testing.assert_array_equal(out, w, err_msg=f"{extra} {i}")
    assert eng.trace_counts["model_step"] <= 2


def test_serve_front_end_streams():
    """Open-loop serve() over a FrontEnd gives each request generate()'s
    stream, the cell's server shape at smoke size."""
    eng = ServeEngine(MODEL, _weights(), max_len=32, device="cpu")
    fe = FrontEnd()
    reqs = _requests(seed=13)
    rids = [fe.submit(r).rid for r in reqs]
    out = eng.serve(fe, page_size=4, max_slots=3, chunk_tokens=8,
                    token_budget=12)["outputs"]
    for rid, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(
            out[rid], eng.generate(p[None], n)["tokens"][0])
