"""Continuous batching in the port (``ServeEngine.run`` / ``serve``), on the
CPU, mirroring tests/test_paged_kv.py and tests/test_open_loop.py.

Inside the port the reference's invariant holds exactly: ``run()`` emits,
per request, the stream a single-request ``generate()`` gives it (greedy,
and sampled with the request's seed), whatever the weight store, KV
width, window, prefill mode, chunk size, overlap setting or arrival
pattern.  Against the reference's own ``run()`` the streams must be equal
or first differ only where the port's top-2 logit gap is below the logits
tolerance (ROADMAP.md section C): across frameworks the summation order
differs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import (FrontEnd, PagesExhausted, Request,  # noqa: E402
                               ServeEngine)

LOGIT_ATOL = 1e-4
# (prompt_len, n_new): page-aligned and ragged prompts, staggered finish
# times, more requests than slots; 11 and 13 pass gemma2-smoke's window 8
MIXED_8 = [(3, 5), (7, 4), (5, 6), (9, 3), (2, 5), (6, 4), (8, 5), (4, 6)]
LONG = [(13, 4), (11, 5), (3, 6), (9, 3)]


def _requests(vocab, shapes, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=s).astype(np.int32), n)
            for s, n in shapes]


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        m = LM(ARCHS[arch].smoke)
        _MODELS[arch] = (m, m.init(0, device="cpu"))
    return _MODELS[arch]


def _engine(arch, **kw):
    m, p = _model(arch)
    kw.setdefault("max_len", 32)
    return m.cfg, ServeEngine(m, p, device="cpu", **kw)


def _policy(model, seed=0):
    graph = model.graph(seq_len=1, batch=1)
    rng = np.random.default_rng(seed)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 6, 8, 16],
                                size=l.n_groups).astype(np.float32)
             for l in graph.layers}
    return QuantPolicy(QuantMode.QUANT, wbits,
                       {l.name: float(6 + i % 3)
                        for i, l in enumerate(graph.layers)})


def _assert_run_matches_generate(eng, reqs, **run_kw):
    res = eng.run(reqs, **run_kw)
    assert len(res["outputs"]) == len(reqs)
    for i, (r, out) in enumerate(zip(reqs, res["outputs"])):
        if isinstance(r, dict):
            want = eng.generate(r["tokens"][None], r["n_new"],
                                temperature=r["temperature"],
                                seed=r["seed"])["tokens"][0]
        else:
            want = eng.generate(r[0][None], r[1])["tokens"][0]
        np.testing.assert_array_equal(out, want, err_msg=f"request {i}")
    return res


# --------------------------------------------------- run() == generate()
@pytest.mark.parametrize("cell", [
    "dense", "window", "more_than_slots", "packed_act", "int8", "monolithic",
    "monolithic_int8_window", "sampled",
])
def test_run_matches_generate(cell):
    arch = "internlm2-20b" if cell in ("dense", "more_than_slots") \
        else "gemma2-2b"
    kw, run_kw = {}, dict(page_size=4, max_slots=4)
    shapes = MIXED_8
    if cell == "window":
        shapes = LONG + MIXED_8[:4]
    elif cell == "more_than_slots":
        run_kw["max_slots"] = 2
    elif cell == "packed_act":
        kw = dict(policy=_policy(_model(arch)[0]), weight_store="packed")
        shapes = LONG
    elif cell == "int8":
        kw = dict(kv_bits=8)
        shapes = LONG + MIXED_8[:2]
    elif cell == "monolithic":
        run_kw["prefill"] = "monolithic"
    elif cell == "monolithic_int8_window":
        kw = dict(kv_bits=8)
        run_kw["prefill"] = "monolithic"
        shapes = LONG
    cfg, eng = _engine(arch, **kw)
    reqs = _requests(cfg.vocab, shapes)
    if cell == "sampled":
        # odd requests sampled, each with its own seed; even ones greedy
        reqs = [dict(tokens=t, n_new=n, seed=100 + i,
                     temperature=0.8 + 0.1 * i if i % 2 else 0.0)
                for i, (t, n) in enumerate(reqs)]
    res = _assert_run_matches_generate(eng, reqs, **run_kw)
    st = res["stats"]
    assert st.tokens_out == sum(n for _, n in shapes)
    assert st.mode == run_kw.get("prefill", "chunked")
    if cell == "more_than_slots":
        assert st.steps < sum(n for _, n in shapes)      # batching happened


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_overlap_and_chunk_matrix_matches_generate(overlap, chunk):
    cfg, eng = _engine("gemma2-2b")
    reqs = _requests(cfg.vocab, LONG + MIXED_8[:3], seed=11)
    res = _assert_run_matches_generate(eng, reqs, page_size=4, max_slots=3,
                                       chunk_tokens=chunk, overlap=overlap)
    st = res["stats"]
    assert st.overlapped == overlap
    assert st.chunk_prefill_tokens == sum(len(t) for t, _ in reqs)


# ------------------------------------------------------------ open loop
class TickClock:
    """Virtual clock: every reading advances a tick, ``sleep`` the nap."""

    def __init__(self, tick=1e-3):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def sleep(self, dt):
        self.t += max(dt, self.tick)


def _vclock_frontend(**kw):
    clk = TickClock()
    return FrontEnd(clock=clk, sleep=clk.sleep, **kw), clk


def test_serve_all_at_once_equals_run():
    cfg, eng = _engine("internlm2-20b")
    reqs = _requests(cfg.vocab, MIXED_8[:6], seed=5)
    ref = eng.run(reqs, page_size=4, max_slots=4)
    fe = FrontEnd()
    rids = [fe.submit(r).rid for r in reqs]
    res = eng.serve(fe, page_size=4, max_slots=4)
    assert res["shed"] == []
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(res["outputs"][rid], ref["outputs"][i])
    assert res["stats"].n_requests == len(reqs)


def test_mid_run_arrival_joins_batch_and_streams_in_order():
    cfg, eng = _engine("internlm2-20b")
    fe, _ = _vclock_frontend()
    rng = np.random.default_rng(9)
    prompt_a = rng.integers(0, cfg.vocab, size=3).astype(np.int32)
    prompt_b = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
    events = []

    def cb(rid, idx, tok):
        events.append((rid, idx, tok))

    a = fe.submit((prompt_a, 10), on_token=cb)
    b = fe.submit((prompt_b, 4), at=0.01, on_token=cb)
    res = eng.serve(fe, page_size=4, max_slots=4)
    stats = res["stats"]
    for req, prompt, n in ((a, prompt_a, 10), (b, prompt_b, 4)):
        want = eng.generate(prompt[None], n)["tokens"][0]
        np.testing.assert_array_equal(res["outputs"][req.rid], want)
    a_ev = [e for e in events if e[0] == a.rid]
    b_ev = [e for e in events if e[0] == b.rid]
    assert events.index(a_ev[-1]) > events.index(b_ev[0])   # b joined mid-run
    for req in (a, b):
        mine = [e for e in events if e[0] == req.rid]
        assert [i for _, i, _ in mine] == list(range(len(mine)))
        np.testing.assert_array_equal([t for _, _, t in mine],
                                      res["outputs"][req.rid])
    for rid in (a.rid, b.rid):
        assert stats.queue_wait_s[rid] >= 0.0
        assert stats.e2e_s[rid] >= stats.ttft_s[rid] > 0.0
    assert len(stats.itl_s) == (10 - 1) + (4 - 1)
    assert stats.overlapped


def test_queue_slo_sheds_waiter_and_max_queue_rejects():
    cfg, eng = _engine("internlm2-20b")
    fe, _ = _vclock_frontend(queue_slo_s=0.004)
    rng = np.random.default_rng(13)
    prompt_a = rng.integers(0, cfg.vocab, size=5).astype(np.int32)
    prompt_b = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
    a = fe.submit((prompt_a, 12))
    b = fe.submit((prompt_b, 4))
    res = eng.serve(fe, page_size=4, max_slots=1)
    assert res["shed"] == [b.rid] and res["stats"].n_shed == 1
    assert res["outputs"][b.rid].size == 0
    want = eng.generate(prompt_a[None], 12)["tokens"][0]
    np.testing.assert_array_equal(res["outputs"][a.rid], want)
    fe, _ = _vclock_frontend(max_queue=2)
    reqs = [fe.submit((prompt_b, 2)) for _ in range(3)]
    assert fe.shed == [reqs[2].rid]
    res = eng.serve(fe, page_size=4, max_slots=2)
    assert [res["outputs"][r.rid].size for r in reqs] == [2, 2, 0]


def test_model_step_shapes_independent_of_prompt_lengths():
    """Ten distinct prompt lengths still give two model_step shapes: the
    mixed width and the pure-decode width."""
    cfg, eng = _engine("internlm2-20b")
    shapes = [(s, 2) for s in (1, 2, 3, 5, 6, 7, 9, 10, 11, 12)]
    eng.run(_requests(cfg.vocab, shapes, seed=23), page_size=4, max_slots=3)
    assert eng.trace_counts["model_step"] <= 2
    eng.run(_requests(cfg.vocab, shapes[:2], seed=24), page_size=4,
            max_slots=3)
    assert eng.trace_counts["model_step"] <= 2


def test_run_requeues_instead_of_failing_when_pool_is_tight():
    cfg, eng = _engine("internlm2-20b")
    reqs = _requests(cfg.vocab, [(12, 3), (11, 3), (10, 2)], seed=31)
    res = _assert_run_matches_generate(eng, reqs, page_size=4, max_slots=3,
                                       num_pages=9, chunk_tokens=4)
    assert res["stats"].requeues > 0


# ---------------------------------------------------------- error paths
def test_run_error_paths():
    cfg, eng = _engine("internlm2-20b")
    toks = np.arange(6, dtype=np.int32)
    with pytest.raises(PagesExhausted):          # pool too small
        eng.run([(toks, 20)], page_size=4, num_pages=3)
    with pytest.raises(PagesExhausted):
        eng.run([(toks, 20)], page_size=4, num_pages=3, prefill="monolithic")
    with pytest.raises(ValueError, match="max_len"):     # oversized
        eng.run([(toks, 40)], page_size=4)
    with pytest.raises(ValueError, match="max_len"):
        eng.run([(toks, 40)], page_size=4, prefill="monolithic")
    with pytest.raises(ValueError, match="token_budget"):
        eng.run([(toks, 2)], page_size=4, max_slots=4, token_budget=3)
    with pytest.raises(ValueError, match="prefill"):
        eng.run([(toks, 2)], prefill="eager")
    # speculative arguments: the reference's ValueErrors, on run and serve
    for bad, match in ((dict(draft_k=0), "draft_k"),
                       (dict(draft_policy="oracle"), "draft_policy"),
                       (dict(draft_policy="lowbit", draft_layers=1),
                        "draft_layers"),
                       (dict(draft_layers=99), "draft_layers"),
                       (dict(draft_policy="prefix", draft_act_bits=2.0),
                        "draft_act_bits")):
        with pytest.raises(ValueError, match=match):
            eng.run([(toks, 2)], speculative=True, **bad)
        with pytest.raises(ValueError, match=match):
            eng.serve(FrontEnd(), speculative=True, **bad)
    with pytest.raises(ValueError, match="chunked"):
        eng.run([(toks, 2)], prefill="monolithic", speculative=True)
    with pytest.raises(ValueError, match="n_new"):
        Request(rid=0, tokens=toks, n_new=0)


# --------------------------------------------- against the reference
def test_run_streams_match_reference_run():
    """The port's run() against the reference's (attn_impl="ref") on the
    same parameters: equal, or first different where the port's top-2
    logit gap is below the logits tolerance."""
    arch = "gemma2-2b"
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    jeng = JEngine(jm, jp, max_len=32, attn_impl="ref")
    eng = ServeEngine(LM(ARCHS[arch].smoke),
                      params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                      max_len=32, device="cpu")
    reqs = _requests(jm.cfg.vocab, LONG + MIXED_8[:4], seed=7)
    kw = dict(page_size=4, max_slots=3, chunk_tokens=4)
    want = jeng.run(reqs, **kw)["outputs"]
    got = eng.run(reqs, **kw)["outputs"]
    for i, ((toks, n_new), g, w) in enumerate(zip(reqs, got, want)):
        bad = np.flatnonzero(g != w)
        if bad.size:
            gaps = eng.generate(toks[None], n_new)["top2_gap"][:, 0]
            assert gaps[bad[0]] < LOGIT_ATOL, (i, int(bad[0]), gaps)
