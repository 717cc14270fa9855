"""Speculative decode in the port (``run(speculative=True)``), on the CPU,
mirroring tests/test_speculative.py.

Inside the port the reference's contract holds exactly: a speculative
``run()`` emits, per request, the stream plain decode gives it (greedy
and sampled), for any draft -- acceptance changes speed, never output --
and over-speculated pages roll back the same step, so the pool drains
clean.  Layers of coverage:

* the scheduler with no model: one scenario drives the reference's and
  the port's ``Scheduler`` (``plan_step(draft_k)`` -> record ->
  ``rollback_speculation``), which must plan identically and hold plain
  decode's occupancy;
* ``draft_prefix_params`` against the reference's, dense and packed;
* engine streams against ``generate`` and plain ``run()`` for the prefix,
  self and low-bit drafts, window + int8 pool + packed store, a
  noise-corrupted draft, and out-of-window reclamation;
* the port's speculative streams against the reference's on the same
  parameters: equal, or first different where the port's top-2 logit gap
  is below the logits tolerance (ROADMAP.md section C).
"""
import dataclasses as dc

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.pack import PackedWeight  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import ServeEngine, engine as tengine  # noqa: E402
from repro_torch.serve import paged_kv, scheduler as tsched  # noqa: E402

LOGIT_ATOL = 1e-4
MIXED = [(3, 5), (7, 4), (5, 6), (9, 3), (2, 5), (6, 4)]
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


def _policy(graph, seed=0):
    rng = np.random.default_rng(seed)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 6, 8, 16],
                                size=l.n_groups).astype(np.float32)
             for l in graph.layers}
    return wbits, {l.name: float(6 + i % 3)
                   for i, l in enumerate(graph.layers)}


class _Watched:
    """The schedulers a session builds, through ``engine.Scheduler``."""

    def __init__(self, monkeypatch):
        self.scheds = []
        watch = self

        class Counted(tsched.Scheduler):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                watch.scheds.append(self)

        monkeypatch.setattr(tengine, "Scheduler", Counted)

    def drained(self):
        return all(s.allocator.n_free == s.allocator.num_pages - 1
                   for s in self.scheds)


def _assert_spec_matches_generate(eng, reqs, **run_kw):
    """The speculative run's streams against ``generate``'s; returns the
    run's result and the engine's shape counts before the ``generate``
    calls."""
    res = eng.run(reqs, speculative=True, **run_kw)
    counts = dict(eng.trace_counts)
    for i, ((toks, n_new), out) in enumerate(zip(reqs, res["outputs"])):
        ref = eng.generate(toks[None], n_new)["tokens"][0]
        np.testing.assert_array_equal(out, ref, err_msg=f"request {i}")
    assert res["stats"].tokens_out == sum(n for _, n in reqs)
    return res, counts


# -------------------------------------- scheduler, against the reference
def _request_of(sched, rid, prompt_len, n_new):
    """A request (no prompt values) of the scheduler's own package."""
    mod = jsched if isinstance(sched, jsched.Scheduler) else tsched
    return mod.Request(rid, np.zeros(prompt_len, np.int32), n_new=n_new)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), page_size=st.integers(1, 5),
       draft_k=st.integers(1, 5), n_req=st.integers(1, 3))
def test_scheduler_plans_match_reference_and_plain_occupancy(
        seed, page_size, draft_k, n_req):
    """One scenario of random prompts, budgets and draft agreement drives
    both schedulers with no model in the loop: every plan is identical,
    and after each record + rollback every lane holds exactly the pages
    plain decode would (``pages_needed(pos)``); the pool drains."""
    rng = np.random.default_rng(seed)
    reqs = [(int(rng.integers(1, 12)), int(rng.integers(2, 12)))
            for _ in range(n_req)]
    bps = max(paged_kv.pages_needed(p + n, page_size) for p, n in reqs)
    num_pages = n_req * bps + 1
    scheds = [mod.Scheduler(n_req, page_size, bps,
                            mod.PageAllocator(num_pages))
              for mod in (jsched, tsched)]           # reference, port
    for s in scheds:
        for rid, (p, n) in enumerate(reqs):
            s.submit(_request_of(s, rid, p, n))
    chunk = int(rng.integers(1, 6))
    budget = n_req * (draft_k + 1) + chunk - 1
    while scheds[0].has_work:
        for s in scheds:
            while s.try_admit_chunked(chunk) is not None:
                pass
        plans = [s.plan_step(chunk, budget, draft_k=draft_k)
                 for s in scheds]
        ref, got = plans
        assert ref.keys() == got.keys()
        for key in ref:
            if isinstance(ref[key], dict):
                assert got[key] == ref[key], key
            else:
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=key)
        agree = {i: int(rng.integers(0, c)) for i, c in ref["spec"].items()}
        for s, plan in zip(scheds, plans):
            for i in plan["sample"]:
                slot = s.slot(i)
                if not slot.out:
                    s.record_first(i, 1)
                    continue
                done = False
                for _ in range(agree[i] + 1):
                    done = s.record(i, 7)
                if not done:
                    s.rollback_speculation(i)
                    assert s.tables.n_live(i) == paged_kv.pages_needed(
                        s.slot(i).pos, page_size)
        assert scheds[0].allocator.n_free == scheds[1].allocator.n_free
        np.testing.assert_array_equal(scheds[1].tables.as_array(),
                                      scheds[0].tables.as_array())
    assert all(s.allocator.n_free == num_pages - 1 for s in scheds)


# ----------------------------------------------------- draft prefix view
def _jit_apply_policy_packed(params, graph, policy):
    """The reference's ``apply_policy_packed`` with each weight's
    ``quant_pack_sub8`` under one ``jax.jit`` (op by op takes minutes on
    a CPU)."""
    from repro.quant.apply import _get_path, _set_path
    from repro.quant.linear_quant import quant_pack_sub8
    out = params
    for layer in graph.layers:
        bits = policy.expand_weight_bits(layer)
        pack = jax.jit(lambda w, b=bits: quant_pack_sub8(w, b))
        out = _set_path(out, layer.param_path,
                        pack(_get_path(params, layer.param_path)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, PackedWeight):
        for part in tree.parts:
            yield from part
    else:
        yield tree


@pytest.mark.parametrize("store", ["dense", "packed"])
def test_draft_prefix_params_match_reference(store):
    arch = "gemma2-2b"
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    if store == "packed":
        graph = jm.graph(seq_len=1, batch=1)
        wbits, abits = _policy(graph)
        jp = _jit_apply_policy_packed(jp, graph,
                                      JPolicy(JMode.QUANT, wbits, abits))
    tm = LM(ARCHS[arch].smoke)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    R = tm.cfg.n_repeat
    for d in range(1, R + 1):
        want = params_from_numpy(
            jax.tree.map(np.asarray, jm.draft_prefix_params(jp, d)), "cpu")
        got = tm.draft_prefix_params(tp, d)
        gl, wl = list(_leaves(got)), list(_leaves(want))
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
        # a view: every stacked leaf shares the full params' storage
        for g, full in zip(_leaves(got["blocks"]), _leaves(tp["blocks"])):
            assert g.untyped_storage().data_ptr() == \
                full.untyped_storage().data_ptr()
        if store == "packed":
            pw = got["blocks"][0]["wq"]
            assert isinstance(pw, PackedWeight)
            assert pw.buckets == tp["blocks"][0]["wq"].buckets
    for bad in (0, R + 1):
        with pytest.raises(ValueError, match="draft_layers"):
            tm.draft_prefix_params(tp, bad)


# ------------------------------------------------ greedy: spec == generate
@pytest.mark.parametrize("cell", ["prefix", "self", "lowbit",
                                  "window_int8_packed"])
def test_spec_run_matches_generate(cell, monkeypatch):
    arch = "internlm2-20b" if cell in ("prefix", "self") else "gemma2-2b"
    m, p = _model(arch)
    kw, run_kw, shapes = {}, dict(page_size=4, max_slots=3, draft_k=3), MIXED
    if cell == "self":
        run_kw["draft_layers"] = m.cfg.n_repeat
    elif cell == "lowbit":
        run_kw["draft_policy"] = "lowbit"
    elif cell == "window_int8_packed":
        graph = m.graph(seq_len=1, batch=1)
        kw = dict(policy=QuantPolicy(QuantMode.QUANT, *_policy(graph)),
                  weight_store="packed", kv_bits=8)
        shapes = LONG
    eng = ServeEngine(m, p, max_len=32, device="cpu", **kw)
    watch = _Watched(monkeypatch)
    res, counts = _assert_spec_matches_generate(
        eng, _requests(m.cfg.vocab, shapes), **run_kw)
    st_ = res["stats"]
    assert st_.mode == "chunked" and not st_.overlapped
    assert st_.spec_steps > 0 and st_.draft_proposed > 0
    assert st_.spec_tokens_out == st_.draft_accepted + st_.spec_lane_steps
    assert counts["model_step"] <= 2     # verify / mixed width + decode
    assert counts["draft_step"] <= 2     # mirror width + chunkless width 2
    assert counts["draft_tail"] <= 1     # (R, 1)
    assert counts.get("prefill", 0) == 0
    assert watch.drained()
    if cell == "self":
        assert st_.acceptance_rate == 1.0
        assert 1.0 < st_.spec_tokens_per_step <= 4.0


# ---------------------------------------------- sampled: spec == plain run
@pytest.mark.parametrize("draft", ["self", "prefix", "lowbit"])
def test_spec_sampled_streams_match_plain_run(draft):
    """Each emitted token is drawn from the logits row and generator state
    plain decode would use (rejected columns consume no randomness), so
    even sampled streams equal the plain run's bit for bit."""
    m, p = _model("internlm2-20b")
    eng = ServeEngine(m, p, max_len=32, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [{"tokens": rng.integers(0, m.cfg.vocab, size=s).astype(np.int32),
             "n_new": n, "temperature": t, "seed": 40 + i}
            for i, (s, n, t) in enumerate(
                [(3, 6, 0.8), (9, 4, 0.0), (5, 5, 1.2), (2, 6, 0.5)])]
    kw = {"self": dict(draft_layers=m.cfg.n_repeat), "prefix": {},
          "lowbit": dict(draft_policy="lowbit")}[draft]
    plain = eng.run(reqs, page_size=4, max_slots=4)
    spec = eng.run(reqs, page_size=4, max_slots=4, speculative=True,
                   draft_k=3, **kw)
    assert spec["stats"].spec_steps > 0
    for i, (a, b) in enumerate(zip(plain["outputs"], spec["outputs"])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


# ------------------------------------------ random draft agreement, pool
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), draft_k=st.integers(1, 4),
       flip=st.sampled_from([0.0, 0.3, 0.7, 1.0]))
def test_spec_parity_under_random_draft_agreement(seed, draft_k, flip):
    """A self-draft corrupted token-wise with probability ``flip`` gives
    arbitrary accept / reject prefixes; the streams still equal
    ``generate``'s and the pool drains clean."""
    m, p = _model("gemma2-2b")
    eng = ServeEngine(m, p, max_len=32, device="cpu")
    rng = np.random.default_rng(seed)
    orig = eng._draft_propose

    def noisy(spec, plan, sched, spec_lanes, w1):
        drafts = orig(spec, plan, sched, spec_lanes, w1)
        for d in drafts.values():
            mask = rng.random(d.shape) < flip
            d[mask] = rng.integers(0, m.cfg.vocab, int(mask.sum()))
        return drafts

    eng._draft_propose = noisy
    with pytest.MonkeyPatch.context() as mp:
        watch = _Watched(mp)
        res, _ = _assert_spec_matches_generate(
            eng, _requests(m.cfg.vocab, MIXED[:4], seed=seed % 1000),
            page_size=4, max_slots=2, draft_k=draft_k,
            draft_layers=m.cfg.n_repeat)
    assert watch.drained()
    if flip == 0.0:
        assert res["stats"].acceptance_rate == 1.0


def test_spec_with_out_of_window_reclamation():
    """Speculative spans and O(window) page reclamation compose: a long
    all-local generation speculates, rolls back and reclaims, and still
    reproduces ``generate`` in a pool far smaller than its history."""
    base = ARCHS["gemma2-2b"].smoke
    cfg = dc.replace(base, pattern=(base.pattern[0], base.pattern[0]),
                     window=8)
    model = LM(cfg)
    eng = ServeEngine(model, model.init(0, device="cpu"), max_len=64,
                      device="cpu")
    toks = _requests(cfg.vocab, [(4, 40)], seed=31)[0][0]
    ref = eng.generate(toks[None], 40)["tokens"][0]
    res = eng.run([(toks, 40)], page_size=4, max_slots=1, num_pages=9,
                  speculative=True, draft_k=3, draft_layers=cfg.n_repeat)
    np.testing.assert_array_equal(res["outputs"][0], ref)
    st_ = res["stats"]
    assert st_.reclaimed_pages > 0
    assert st_.spec_tokens_per_step > 1.0
    assert st_.peak_pages <= 5


# --------------------------------------------------- against the reference
@pytest.mark.parametrize("draft", ["prefix", "self"])
def test_spec_streams_match_reference_spec_run(draft):
    """The port's speculative run() against the reference's (attn_impl
    "ref") on the same parameters: equal, or first different where the
    port's top-2 logit gap is below the logits tolerance.  The self-draft
    accepts everything in both, so its spec counters agree wherever the
    streams do."""
    arch = "gemma2-2b"
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    jeng = JEngine(jm, jp, max_len=32, attn_impl="ref")
    eng = ServeEngine(LM(ARCHS[arch].smoke),
                      params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                      max_len=32, device="cpu")
    reqs = _requests(jm.cfg.vocab, LONG, seed=7)
    kw = dict(page_size=4, max_slots=3, chunk_tokens=4, speculative=True,
              draft_k=3)
    if draft == "self":
        kw["draft_layers"] = jm.cfg.n_repeat
    want = jeng.run(reqs, **kw)
    got = eng.run(reqs, **kw)
    equal = True
    for i, ((toks, n_new), g, w) in enumerate(zip(reqs, got["outputs"],
                                                  want["outputs"])):
        bad = np.flatnonzero(g != w)
        if bad.size:
            equal = False
            gaps = eng.generate(toks[None], n_new)["top2_gap"][:, 0]
            assert gaps[bad[0]] < LOGIT_ATOL, (i, int(bad[0]), gaps)
    if draft == "self":
        assert got["stats"].acceptance_rate == 1.0
        if equal:
            for f in ("spec_steps", "spec_lane_steps", "spec_tokens_out",
                      "draft_proposed", "draft_accepted", "tokens_out"):
                assert getattr(got["stats"], f) == \
                    getattr(want["stats"], f), f
