"""The port's paged serving layers against the JAX reference, on the CPU.

* Kernel K4's wrapper (its plain version on CPU tensors) against the
  reference's ``paged_prefill_attention`` in interpret mode and its
  ``paged_attention_ref``, at ``TOL`` of test_attention.py, over a sampled
  matrix of page sizes, q-tile widths, GQA shapes, windows, softcaps, fp32
  and int8 pools, idle lanes and shuffled page orders.  Against the kernel
  only the real (left-aligned) columns count: padded columns are garbage
  the scheduler never reads, and the two treat them differently.
* ``LM.model_step`` (1-D and 2-D ``logit_cols``) and ``decode_step_paged``
  against the reference's on the gemma2 and internlm2 smoke configs, fp32
  and int8 pools: logits at rtol = atol = 1e-4, the written pools' ``pos``
  and int8 planes bit for bit, fp32 planes and scales at the same 1e-4.
* ``scrub_pages``, ``write_prefill`` and a scripted scheduler session whose
  step plans must equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.kernels import attention as jattn  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import _kv_quant as j_kv_quant  # noqa: E402
from repro.serve import paged_kv as jpkv  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve import paged_kv as tpkv  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SENT = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- K4
def _pool(rng, lens, k, ps, hkv, g, D=8, kv_bits=None, shuffle=True):
    """Pool + q tiles in the chunked-prefill layout (test_attention.py's
    ``_paged_chunk_pool``) with the physical pages in a shuffled order.
    Sequence i has ``lens[i]`` written positions and its q tile is the
    last ``min(k, lens[i])`` of them, left-aligned, sentinel-padded;
    ``lens[i] == 0`` is an idle lane (all-trash table)."""
    B = len(lens)
    nb = max(-(-max(lens) // ps), 1) + 1
    P = 1 + sum(-(-s // ps) for s in lens if s)
    ids = np.arange(1, P)
    if shuffle:
        ids = rng.permutation(ids)
    kf = rng.normal(size=(P, ps, hkv, D)).astype(np.float32)
    vf = rng.normal(size=(P, ps, hkv, D)).astype(np.float32)
    pos = np.full((P, ps), SENT, np.int32)
    bt = np.zeros((B, nb), np.int32)
    q_pos = np.full((B, k), SENT, np.int32)
    used = 0
    for i, s in enumerate(lens):
        npages = -(-s // ps)
        bt[i, :npages] = ids[used:used + npages]
        used += npages
        for p in range(s):
            pos[bt[i, p // ps], p % ps] = p
        c = min(k, s)
        q_pos[i, :c] = range(s - c, s)
    q = rng.normal(size=(B, k, hkv * g, D)).astype(np.float32)
    pools = {"k": kf, "v": vf, "pos": pos, "k_s": None, "v_s": None}
    if kv_bits == 8:
        kq, ks = j_kv_quant(jnp.asarray(kf))
        vq, vs = j_kv_quant(jnp.asarray(vf))
        pools.update(k=np.asarray(kq), v=np.asarray(vq), k_s=np.asarray(ks),
                     v_s=np.asarray(vs))
    return q, pools, bt, q_pos


def _args(pools, conv):
    return {"k_scale_pages": None if pools["k_s"] is None
            else conv(pools["k_s"]),
            "v_scale_pages": None if pools["v_s"] is None
            else conv(pools["v_s"])}


# ps, k, hkv, g, window, cap, kv_bits, lens
PAGED_CASES = [
    (4, 1, 2, 2, None, None, None, [9, 0, 4]),        # decode, idle lane
    (8, 1, 1, 2, 5, 50.0, None, [17, 3]),             # decode, window
    (4, 3, 2, 1, None, 50.0, None, [10, 3, 0, 7]),    # chunks, MHA
    (8, 3, 1, 1, 5, None, None, [20, 1]),             # window skips pages
    (4, 8, 2, 2, 5, 50.0, None, [13, 5, 0]),          # wide tile, window
    (8, 8, 1, 2, None, None, None, [24, 8]),          # many pages
    (4, 1, 1, 1, None, None, 8, [10, 3, 17]),         # int8 decode
    (8, 3, 2, 2, 5, 50.0, 8, [19, 0, 6]),             # int8 chunk, window
    (4, 8, 2, 1, None, None, 8, [11, 2]),             # int8 wide tile
]


@pytest.mark.parametrize("ps,k,hkv,g,window,cap,kv_bits,lens", PAGED_CASES)
def test_paged_prefill_attention_matches_reference(ps, k, hkv, g, window, cap,
                                                   kv_bits, lens):
    rng = np.random.default_rng(ps * 1000 + k * 100 + hkv * 10 + g)
    q, pools, bt, q_pos = _pool(rng, lens, k, ps, hkv, g, kv_bits=kv_bits)
    kw = dict(window=window, attn_cap=cap)
    got = tattn.paged_prefill_attention(
        _t(q), _t(pools["k"]), _t(pools["v"]), _t(pools["pos"]), _t(bt),
        q_pos=_t(q_pos), **kw, **_args(pools, _t)).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
             jnp.asarray(pools["pos"]), jnp.asarray(bt))
    jkw = dict(q_pos=jnp.asarray(q_pos), **kw, **_args(pools, jnp.asarray))
    oracle = np.asarray(jlayers.paged_attention_ref(*jargs, **jkw))
    kernel = np.asarray(jattn.paged_prefill_attention(*jargs, **jkw,
                                                      interpret=True))
    # the plain version is the reference's oracle, padded columns and all
    np.testing.assert_allclose(got, oracle, **TOL)
    for i, s in enumerate(lens):
        c = min(k, s)
        np.testing.assert_allclose(got[i, :c], kernel[i, :c],
                                   err_msg=f"row {i}", **TOL)
    # the port's dispatcher reaches the same function for both impls
    for impl in ("ref", "cuda"):
        out = tlayers.paged_attention(
            _t(q), _t(pools["k"]), _t(pools["v"]), _t(pools["pos"]), _t(bt),
            q_pos=_t(q_pos), impl=impl, **kw, **_args(pools, _t))
        np.testing.assert_array_equal(out.numpy(), got)


def test_paged_decode_is_the_k1_tile_and_scales_go_with_int8():
    rng = np.random.default_rng(8)
    q, pools, bt, q_pos = _pool(rng, [9, 4], 1, 4, 2, 2)
    args = (_t(q), _t(pools["k"]), _t(pools["v"]), _t(pools["pos"]), _t(bt))
    dec = tattn.paged_decode_attention(*args, q_pos=_t(q_pos[:, 0]))
    pre = tattn.paged_prefill_attention(*args, q_pos=_t(q_pos))
    np.testing.assert_array_equal(dec.numpy(), pre.numpy())
    q, pools, bt, q_pos = _pool(rng, [5], 1, 4, 2, 2, kv_bits=8)
    args = (_t(q), _t(pools["k"]), _t(pools["v"]), _t(pools["pos"]), _t(bt))
    with pytest.raises(AssertionError, match="scale"):
        tattn.paged_decode_attention(*args, q_pos=_t(q_pos))
    with pytest.raises(AssertionError, match="scale"):
        tattn.paged_prefill_attention(
            _t(q), _t(pools["k"]).float(), _t(pools["v"]).float(),
            _t(pools["pos"]), _t(bt), q_pos=_t(q_pos),
            **_args(pools, _t))


def test_paged_gather_matches_reference():
    rng = np.random.default_rng(2)
    pages = rng.normal(size=(7, 4, 2, 3)).astype(np.float32)
    bt = rng.integers(0, 7, size=(3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tlayers.paged_gather(_t(pages), _t(bt)).numpy(),
        np.asarray(jlayers.paged_gather(jnp.asarray(pages), jnp.asarray(bt))))


# --------------------------------------------------------------- the model
def _pair(arch):
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, LM(ARCHS[arch].smoke), tp


def _step_script(vocab, rng):
    """Three model_step calls over 3 slots (page size 4, 6 blocks): two
    prompt chunks at width 5 with an idle lane, a chunk finishing beside
    a decode token, then a 2-column verify-style read.  Yields (tokens,
    positions, logit_cols, rows with real tokens)."""
    def step(rows, W, cols2=False):
        toks = np.zeros((3, W), np.int32)
        pos = np.full((3, W), SENT, np.int32)
        lc = np.zeros((3, 2) if cols2 else (3,), np.int32)
        for r, (p0, n) in rows.items():
            toks[r, :n] = rng.integers(0, vocab, size=n)
            pos[r, :n] = np.arange(p0, p0 + n)
            lc[r] = [max(n - 2, 0), n - 1] if cols2 else n - 1
        return toks, pos, lc, sorted(rows)
    yield step({0: (0, 5), 1: (0, 3)}, 5)
    yield step({0: (5, 4), 1: (3, 1)}, 5)
    yield step({0: (9, 3), 1: (4, 2)}, 5, cols2=True)


def _pool_tables():
    bt = np.zeros((3, 6), np.int32)
    bt[0, :4] = [3, 1, 6, 8]
    bt[1, :2] = [2, 5]
    return bt          # slot 2 idle: all trash


def _assert_pools_match(tc, jc, real_pages):
    for tcp, jcp in zip(tc, jc):
        for key in tcp:
            t = tcp[key].numpy()
            j = np.asarray(jcp[key])
            if key == "pos":                   # every page, trash included
                np.testing.assert_array_equal(t, j)
            elif t.dtype == np.int8:
                np.testing.assert_array_equal(t[:, real_pages],
                                              j[:, real_pages])
            else:       # sentinel lanes' trash-page writes race; skip page 0
                np.testing.assert_allclose(t[:, real_pages], j[:, real_pages],
                                           **LOGIT_TOL)


@pytest.mark.parametrize("arch,kv_bits,impl", [
    ("gemma2-2b", None, "cuda"),            # local + global, window 8
    ("gemma2-2b", 8, "ref"),
    ("internlm2-20b", None, "ref"),
    ("internlm2-20b", 8, "cuda"),
])
def test_model_step_and_decode_step_paged_match_reference(arch, kv_bits,
                                                          impl):
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(5)
    jc = jm.init_paged_cache(3, 9, 4, dtype=jnp.float32, kv_bits=kv_bits)
    tc = tm.init_paged_cache(3, 9, 4, dtype=torch.float32, kv_bits=kv_bits,
                             device="cpu")
    bt = _pool_tables()
    slot_map = np.arange(3, dtype=np.int32)
    jstep = jax.jit(jm.model_step, static_argnames=("attn_impl",))
    for toks, pos, lc, real in _step_script(cfg.vocab, rng):
        jl, jc = jstep(jp, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(slot_map), jc, jnp.asarray(bt),
                       jnp.asarray(lc), attn_impl="ref")
        layout = tm.step_layout(pos, slot_map, bt).upload("cpu")
        tl, tc = tm.model_step(tp, _t(toks), layout, tc, _t(lc),
                               attn_impl=impl)
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   **LOGIT_TOL)
    # one decode step at per-sequence positions, slot 2 idle (sentinel)
    tok = rng.integers(0, cfg.vocab, size=(3, 1)).astype(np.int32)
    pos = np.array([12, 6, SENT], np.int32)
    jl, jc = jax.jit(jm.decode_step_paged, static_argnames=("attn_impl",))(
        jp, jnp.asarray(tok), jc, jnp.asarray(bt), jnp.asarray(pos),
        attn_impl="ref")
    tl, tc = tm.decode_step_paged(tp, _t(tok), tc, _t(bt), _t(pos),
                                  attn_impl=impl)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               **LOGIT_TOL)
    _assert_pools_match(tc, jc, real_pages=[1, 2, 3, 5, 6, 8])


def test_model_step_chunks_match_prefill_logits():
    """A prompt fed in chunks through model_step ends at prefill's
    last-token logits (the invariant behind run() == generate())."""
    _, _, tm, tp = _pair("gemma2-2b")
    rng = np.random.default_rng(6)
    S = 13                                           # past window 8
    toks = rng.integers(0, tm.cfg.vocab, size=(1, S))
    want, _ = tm.prefill(tp, {"tokens": _t(toks)},
                         tm.init_cache(1, 16, dtype=torch.float32,
                                       device="cpu"))
    pool = tm.init_paged_cache(1, 5, 4, dtype=torch.float32, device="cpu")
    bt = np.array([[4, 2, 1, 3]], np.int32)
    for c0 in range(0, S, 5):
        n = min(5, S - c0)
        t = np.zeros((1, 5), np.int64)
        p = np.full((1, 5), SENT, np.int32)
        t[0, :n] = toks[0, c0:c0 + n]
        p[0, :n] = np.arange(c0, c0 + n)
        layout = tm.step_layout(p, np.zeros(1, np.int32), bt).upload("cpu")
        got, pool = tm.model_step(tp, _t(t), layout, pool,
                                  _t(np.array([n - 1], np.int32)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)


# ------------------------------------------------------- pool operations
def test_scrub_pages_matches_reference():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 50, size=(2, 6, 4)).astype(np.int32)
    jc = ({"k": jnp.zeros((2, 6, 4, 1, 2)), "pos": jnp.asarray(pos)},)
    tc = ({"k": torch.zeros((2, 6, 4, 1, 2)), "pos": _t(pos)},)
    jc = jpkv.scrub_pages(jc, ("paged",), [2, 5])
    out = tpkv.scrub_pages(tc, ("paged",), [2, 5])
    assert out is tc                                   # in place
    np.testing.assert_array_equal(tc[0]["pos"].numpy(),
                                  np.asarray(jc[0]["pos"]))
    assert tpkv.scrub_pages(tc, ("paged",), []) is tc


@pytest.mark.parametrize("kv_bits,W", [(None, 16), (8, 16), (None, 8)])
def test_write_prefill_matches_reference(kv_bits, W):
    """The dense cache of a 13-token prompt (a ring of 8 when W == 8)
    scattered into shuffled pages: every plane equal, bit for bit."""
    rng = np.random.default_rng(4)
    R, Hkv, hd, S, ps = 2, 2, 4, 13, 4
    p = np.arange(S, dtype=np.int32)
    if W < S:
        keep = p[-W:]
        p = np.roll(keep, (S - W) % W)
    else:
        p = np.concatenate([p, np.full(W - S, SENT, np.int32)])
    dense = {"pos": np.broadcast_to(p, (R, 1, W)).copy()}
    kv_dt = np.int8 if kv_bits == 8 else np.float32
    for key in ("k", "v"):
        x = rng.normal(size=(R, 1, W, Hkv, hd)) * 40
        dense[key] = x.astype(kv_dt)
        if kv_bits == 8:
            dense[key + "_s"] = rng.random((R, 1, W, Hkv)).astype(np.float32)
    pool = {key: np.zeros((R, 9, ps) + a.shape[3:], a.dtype)
            for key, a in dense.items()}
    pool["pos"][:] = SENT
    blocks = [7, 2, 5, 1]
    jout = jpkv.write_prefill(
        ({k: jnp.asarray(v) for k, v in pool.items()},),
        ({k: jnp.asarray(v) for k, v in dense.items()},), ("paged",), 0,
        blocks, ps)
    tpool = ({k: _t(v) for k, v in pool.items()},)
    tpkv.write_prefill(tpool, ({k: _t(v) for k, v in dense.items()},),
                       ("paged",), 0, blocks, ps)
    for key in pool:
        np.testing.assert_array_equal(tpool[0][key].numpy(),
                                      np.asarray(jout[0][key]))


# ---------------------------------------------------------- scheduler
def _session(mod, pkv):
    """A fixed scheduler session on a tight pool: chunked admission, step
    plans with preemption and requeue, first tokens, decode, finishing,
    out-of-window reclamation; returns everything it observed."""
    sched = mod.Scheduler(3, 4, pkv.pages_needed(40, 4),
                          pkv.PageAllocator(8))
    shapes = [(9, 4), (14, 3), (5, 6), (21, 2), (3, 3)]
    rng = np.random.default_rng(12)
    for i, (s, n) in enumerate(shapes):
        sched.submit(mod.Request(rid=i, tokens=rng.integers(0, 50, size=s),
                                 n_new=n))
    seen, tok = [], 100
    for _ in range(40):
        if not sched.has_work:
            break
        seen.append(("reclaim", sched.reclaim_out_of_window(6)))
        while (adm := sched.try_admit_chunked(5)) is not None:
            seen.append(("admit", adm[0].rid, adm[1], adm[2]))
        plan = sched.plan_step(5, 12)
        seen.append(("plan", {k: (v.tolist() if isinstance(v, np.ndarray)
                                  else v) for k, v in plan.items()}))
        for i in plan["sample"]:
            tok += 1
            if sched.slot(i).out:
                seen.append(("record", i, sched.record(i, tok)))
            else:
                seen.append(("first", i, sched.record_first(i, tok)))
        seen.append(("tables", sched.tables.as_array().tolist(),
                     sched.allocator.n_free))
    assert not sched.has_work
    return seen


def test_scheduler_session_plans_equal_reference():
    want = _session(jsched, jpkv)
    got = _session(tsched, tpkv)
    assert any(e[0] == "plan" and e[1]["requeued"] for e in want)
    assert got == want


def test_allocator_and_block_tables_match_reference():
    for mod in (jpkv, tpkv):
        a = mod.PageAllocator(5)
        assert a.alloc(2) == [1, 2] and a.n_free == 2
        with pytest.raises(mod.PagesExhausted):
            a.alloc(3)
        a.free([2])
        with pytest.raises(ValueError, match="double free"):
            a.free([2])
        bt = mod.BlockTables(2, 4)
        bt.append(0, [3, 1, 4])
        assert bt.free_prefix(0, 2) == [3, 1]
        assert bt.truncate_to(0, 2) == [4]
        assert bt.as_array().tolist() == [[0, 0, 0, 0], [0, 0, 0, 0]]
        assert mod.pages_needed(9, 4) == 3 and mod.pages_needed(0, 4) == 0
