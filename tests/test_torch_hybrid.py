"""Serving patterns with recurrent (mamba) state in the port, on the CPU:
mamba2-smoke (all ``"state"``) and jamba-smoke (``"state"`` beside
``"paged"`` attention and MoE FFNs), mirroring tests/test_paged_kv.py:239
and :426, tests/test_speculative.py:223 and the reference's
``init_paged_cache`` / ``write_prefill`` for the ``"state"`` kind.

Inside the port ``run(prefill="monolithic")`` streams equal
``generate()``'s bit for bit; the chunked path (``run()``'s default),
open-loop ``serve()`` and ``model_step`` take such patterns, each slot's
state carried through the token-budget step (tests/test_torch_granite_
hybrid.py holds them to the full forward pass), and speculation raises
before any model call.  Against the reference: logits at rtol = atol =
1e-4 (f32 on both sides, summation order only), pools plane for plane,
and the port's chunked ``run()`` streams against the reference's
monolithic ones: equal or first different where the port's top-2 logit
gap is below that tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import paged_kv as jpkv  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import FrontEnd, ServeEngine  # noqa: E402
from repro_torch.serve import paged_kv as tpkv  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SENT = 2**31 - 1
MAMBA, JAMBA = "mamba2-780m", "jamba-1.5-large-398b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _requests(vocab, shapes, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=s).astype(np.int32), n)
            for s, n in shapes]


def _policy(model, seed=0):
    graph = model.graph(seq_len=1, batch=1)
    rng = np.random.default_rng(seed)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 6, 8, 16],
                                size=l.n_groups).astype(np.float32)
             for l in graph.layers}
    return QuantPolicy(QuantMode.QUANT, wbits,
                       {l.name: 8.0 for l in graph.layers})


def _engine(arch, **kw):
    m = LM(ARCHS[arch].smoke)
    return m.cfg, ServeEngine(m, m.init(0, device="cpu"), max_len=32,
                              device="cpu", **kw)


@pytest.mark.parametrize("arch,store,cache_dtype", [
    (MAMBA, "fake", "float32"), (MAMBA, "packed", "float32"),
    (MAMBA, "fake", "bfloat16"), (JAMBA, "fake", "float32"),
    (JAMBA, "packed", "float32")])
def test_run_is_monolithic_and_matches_generate(arch, store, cache_dtype):
    """Mirrors tests/test_paged_kv.py:239: run(prefill="monolithic") on
    recurrent state, each stream equal to the request's generate(), with
    more requests than slots (a slot's state is overwritten by the next
    admission), under a packed policy with activation QBN 8 and over a
    bf16 cache and pool."""
    m = LM(ARCHS[arch].smoke)
    params = m.init(0, device="cpu")
    policy = _policy(m) if store == "packed" else None
    eng = ServeEngine(m, params, policy=policy, max_len=32,
                      weight_store=store, device="cpu",
                      cache_dtype=getattr(torch, cache_dtype))
    reqs = _requests(m.cfg.vocab, [(4, 4), (6, 3), (3, 5), (9, 4), (1, 3)],
                     seed=7)
    res = eng.run(reqs, page_size=4, max_slots=2, prefill="monolithic")
    assert res["stats"].mode == "monolithic"
    assert eng.call_counts["model_step"] == 0
    for i, ((toks, n), out) in enumerate(zip(reqs, res["outputs"])):
        want = eng.generate(toks[None], n)["tokens"][0]
        np.testing.assert_array_equal(out, want, err_msg=f"request {i}")


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_chunked_speculative_and_serve_reject_recurrent_state(arch):
    """Mirrors tests/test_speculative.py:223: speculation on recurrent
    state raises a ValueError naming the way out, before any model call,
    through run() and serve() alike (a rejected draft cannot roll the
    state back).  The chunked path, open-loop serving and model_step take
    the pattern: run(prefill="chunked") and serve() stream what
    generate() does, and model_step writes the row's state into its
    slot."""
    cfg, eng = _engine(arch)
    reqs = _requests(cfg.vocab, [(3, 2)], seed=1)
    for call in (lambda: eng.run(reqs, page_size=4, max_slots=1,
                                 speculative=True),
                 lambda: eng.serve(FrontEnd(), page_size=4, max_slots=1,
                                   speculative=True)):
        with pytest.raises(ValueError, match="speculative=False"):
            call()
    assert not any(eng.call_counts.values())
    want = eng.generate(reqs[0][0][None], 2)["tokens"][0]
    res = eng.run(reqs, page_size=4, max_slots=1, prefill="chunked")
    assert res["stats"].mode == "chunked"
    np.testing.assert_array_equal(res["outputs"][0], want)
    fe = FrontEnd()
    rid = fe.submit(reqs[0]).rid
    np.testing.assert_array_equal(
        eng.serve(fe, page_size=4, max_slots=1)["outputs"][rid], want)
    pool = eng.model.init_paged_cache(1, 3, 4, device="cpu")
    z = np.zeros((1, 2), np.int32)
    layout = eng.model.step_layout(z, z[:, 0], z).upload("cpu")
    eng.model.model_step(eng.params, torch.zeros((1, 2), dtype=torch.int64),
                         layout, pool, torch.zeros(1, dtype=torch.int32))
    state = pool[cfg.cache_kinds().index("state")]["state"]
    assert bool(state.abs().sum() > 0)


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_init_paged_cache_matches_reference(arch):
    """Per kind, the reference's planes: a "state" entry is the dense
    recurrent state with batch axis n_slots (state fp32, conv in the
    cache dtype), a "paged" entry the pool."""
    jm, tm = JLM(JARCHS[arch].smoke), LM(ARCHS[arch].smoke)
    jc = jm.init_paged_cache(3, 7, 4, dtype=jnp.bfloat16)
    tc = tm.init_paged_cache(3, 7, 4, device="cpu")
    assert len(jc) == len(tc) == len(tm.cfg.pattern)
    for jcp, tcp in zip(jc, tc):
        assert sorted(jcp) == sorted(tcp)
        for key in jcp:
            assert tuple(tcp[key].shape) == jcp[key].shape, key
            assert str(tcp[key].dtype).split(".")[-1] == str(jcp[key].dtype)
            np.testing.assert_array_equal(
                tcp[key].float().numpy(),
                np.asarray(jcp[key]).astype(np.float32))


def test_write_prefill_copies_state_into_its_slot_like_the_reference():
    """A "state" entry copies whole into batch lane ``slot`` (every plane,
    cast to the pool's dtype), beside a "paged" entry scattered through
    the blocks; the other lanes are untouched."""
    rng = np.random.default_rng(2)
    R, W, ps = 2, 8, 4
    state = {"state": rng.normal(size=(R, 1, 3, 4, 5)).astype(np.float32),
             "conv": rng.normal(size=(R, 1, 3, 6)).astype(np.float32)}
    spool = {k: rng.normal(size=(R, 3) + v.shape[2:]).astype(np.float32)
             for k, v in state.items()}
    p = np.concatenate([np.arange(6), np.full(W - 6, SENT)]).astype(np.int32)
    paged = {"pos": np.broadcast_to(p, (R, 1, W)).copy(),
             "k": rng.normal(size=(R, 1, W, 1, 2)).astype(np.float32),
             "v": rng.normal(size=(R, 1, W, 1, 2)).astype(np.float32)}
    ppool = {k: np.zeros((R, 5, ps) + v.shape[3:], v.dtype)
             for k, v in paged.items()}
    ppool["pos"][:] = SENT
    kinds = ("state", "paged")
    jout = jpkv.write_prefill(
        tuple({k: jnp.asarray(v) for k, v in d.items()}
              for d in (spool, ppool)),
        tuple({k: jnp.asarray(v) for k, v in d.items()}
              for d in (state, paged)), kinds, 1, [3, 1], ps)
    tpool = tuple({k: _t(v) for k, v in d.items()} for d in (spool, ppool))
    out = tpkv.write_prefill(
        tpool, tuple({k: _t(v) for k, v in d.items()} for d in
                     (state, paged)), kinds, 1, [3, 1], ps)
    assert out is tpool
    for tp, jp in zip(tpool, jout):
        for key in tp:
            np.testing.assert_array_equal(tp[key].numpy(),
                                          np.asarray(jp[key]))
    np.testing.assert_array_equal(tpool[0]["state"][:, 0].numpy(),
                                  spool["state"][:, 0])


def test_decode_step_paged_matches_reference():
    """jamba-smoke: two requests prefilled alone (batch 1, dense cache)
    and written into 3-slot pools in both packages, then two
    decode_step_paged calls with slot 2 idle (sentinel position, all-trash
    table): the active lanes' logits at TOL, and the active lanes'
    recurrent state too."""
    jm = JLM(JARCHS[JAMBA].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(ARCHS[JAMBA].smoke)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cfg, kinds = jm.cfg, jm.cfg.cache_kinds()
    rng = np.random.default_rng(3)
    jc = jm.init_paged_cache(3, 9, 4, dtype=jnp.float32)
    tc = tm.init_paged_cache(3, 9, 4, dtype=torch.float32, device="cpu")
    bt = np.zeros((3, 4), np.int32)
    bt[0, :3] = [3, 1, 6]
    bt[1, :2] = [2, 5]
    pos = np.array([9, 6, SENT], np.int32)
    jpre = jax.jit(jm.prefill)
    for slot, n in ((0, 9), (1, 6)):
        toks = rng.integers(0, cfg.vocab, size=(1, n)).astype(np.int32)
        L = -(-n // 4) * 4
        _, jd = jpre(jp, {"tokens": jnp.asarray(toks)},
                     jm.init_cache(1, L, dtype=jnp.float32))
        _, td = tm.prefill(tp, {"tokens": _t(toks).long()},
                           tm.init_cache(1, L, dtype=torch.float32,
                                         device="cpu"))
        blocks = [int(b) for b in bt[slot, :L // 4]]
        jc = jpkv.write_prefill(jc, jd, kinds, slot, blocks, 4)
        tpkv.write_prefill(tc, td, kinds, slot, blocks, 4)
    jdec = jax.jit(jm.decode_step_paged)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, size=(3, 1)).astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(bt),
                      jnp.asarray(pos))
        tl, tc = tm.decode_step_paged(tp, _t(tok), tc, _t(bt), _t(pos))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **TOL)
        pos = np.where(pos == SENT, SENT, pos + 1).astype(np.int32)
    for kind, jcp, tcp in zip(kinds, jc, tc):
        if kind == "state":
            for key in ("state", "conv"):
                np.testing.assert_allclose(tcp[key][:, :2].numpy(),
                                           np.asarray(jcp[key])[:, :2],
                                           **TOL)


def test_run_streams_match_reference_run():
    """mamba2-smoke: the port's run() (chunked, the state carried through
    model_step) against the reference's (monolithic, its only path for
    recurrent state) on the same parameters: equal, or first different
    where the port's top-2 logit gap is below the logits tolerance."""
    jm = JLM(JARCHS[MAMBA].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    jeng = JEngine(jm, jp, max_len=32, attn_impl="ref")
    eng = ServeEngine(LM(ARCHS[MAMBA].smoke),
                      params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                      max_len=32, device="cpu")
    reqs = _requests(jm.cfg.vocab, [(5, 4), (3, 5), (7, 3)], seed=11)
    kw = dict(page_size=4, max_slots=2)
    want = jeng.run(reqs, **kw)
    got = eng.run(reqs, **kw)
    assert want["stats"].mode == "monolithic"
    assert got["stats"].mode == "chunked"
    for i, ((toks, n_new), g, w) in enumerate(zip(reqs, got["outputs"],
                                                  want["outputs"])):
        bad = np.flatnonzero(g != w)
        if bad.size:
            gaps = eng.generate(toks[None], n_new)["top2_gap"][:, 0]
            assert gaps[bad[0]] < TOL["atol"], (i, int(bad[0]), gaps)
