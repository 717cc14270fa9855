"""A bf16 model in the port, on the CPU, against the JAX reference.

Both packages get the same parameters: the reference's
``LM.init(key, dtype=bfloat16)``, carried across bit for bit
(``interop.params_from_numpy``, and ``params_to_numpy`` back).

* Kernels on a bf16 q or x (their wrappers run their plain versions on CPU
  tensors) against the reference's Pallas kernels in interpret mode, output
  dtypes equal.  Attention at ``BF16_ATTN_TOL``: both compute in fp32 and
  round the output once to bf16, so an element differs by at most one bf16
  ulp (2^-7 of its value) beyond the fp32 tolerance of test_attention.py.
  GEMMs at the reference's own bf16 tolerance (tests/test_kernels.py:24,
  rtol 2e-2 and atol 10 x that, at its input scale).  K2's and K3's plain
  versions have the reference kernel's arithmetic (the fp32 weight, an
  fp32 sum, one rounding); the packed store's plain contraction of a bf16
  result dequantizes the weight to bf16 first, as the reference's store
  does (``PackedWeight.dequant``), and equals ``x @ w.dequant()``.
* gemma2-2b's smoke at bf16 on the dense, packed and int8 stores, and
  granite-moe's on the packed store, against the reference's engine.  XLA
  fuses the reference's bf16 elementwise chains and rounds once where eager
  PyTorch rounds after every op, so the two differ by more than fp32 noise.
  The bound comes from the bf16 model's own distance to its fp32 twin (the
  reference with the same parameters upcast): prefill logits within
  ``BF16_TWIN_FACTOR`` (2) times that distance.  Over seeds 0-3 of both
  smoke models the ratio measured 0.55-1.37.  The int8 store's fp32 scales
  make every activation fp32 in both packages (the twin distance is 0), so
  it is held at test_torch_int8_store.py's fp32 tolerance.  Streams are
  equal, or first differ where the reference's top-2 gap (teacher-forced
  along its own stream) is below the logit bound.
* The packed stores: each engine packs its own store from the same bf16
  parameters and policy, the reference's eagerly (its
  ``apply_policy_packed`` under ``jax.disable_jit()``): jitted, XLA
  rounds some quotients of the coarse bf16 grid that sit on a tie the
  other way, moving those weights by one quantization step, while the
  port's ``quant_pack_sub8`` equals the reference's eager one bit for bit
  (tested here on a stacked bf16 weight).
* Inside the port, bitwise: ``run()`` == ``generate()`` in every prefill
  mode, overlap on == off, speculative == plain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.kernels import attention as jattn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack as jpack  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.quant import apply as japply  # noqa: E402
from repro.quant import linear_quant as jlq  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import (params_from_numpy, params_to_numpy,  # noqa
                                 tensor_to_numpy)
from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.quant import linear_quant as tlq  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

BF16_ATTN_TOL = dict(rtol=2.0**-7, atol=2e-5)
BF16_GEMM_TOL = dict(rtol=2e-2, atol=2e-1)         # tests/test_kernels.py:24
BF16_TWIN_FACTOR = 2.0
INT8_STORE_TOL = dict(rtol=1e-4, atol=1e-4)     # test_torch_int8_store.py
SENT = 2**31 - 1
S, N_NEW, MAX_LEN = 12, 5, 24


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, path=()):
    """(path, leaf) of a parameter tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _bits16(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 array (numpy) or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# ------------------------------------------------------------------- init
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m",
                                  "mamba2-780m"])
def test_init_bf16_leaves_and_interop(arch):
    """``LM.init(dtype=torch.bfloat16)`` has the reference's leaves (paths,
    shapes, dtypes), is the fp32 draw cast leaf by leaf, and the
    reference's bf16 parameters cross over and back bit for bit."""
    jm, tm = JLM(JARCHS[arch].smoke), LM(ARCHS[arch].smoke)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                          dtype=jnp.bfloat16))
    own = tm.init(0, device="cpu", dtype=torch.bfloat16)
    want = [(p, a.shape) for p, a in _leaves(jp)]
    assert [(p, tuple(t.shape)) for p, t in _leaves(own)] == want
    assert all(a.dtype.name == "bfloat16" for _, a in _leaves(jp))
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(own))
    f32 = tm.init(0, device="cpu")
    for (_, a), (_, b) in zip(_leaves(own), _leaves(f32)):
        assert torch.equal(a, b.to(torch.bfloat16))
    tp = params_from_numpy(jp, "cpu")
    back = params_to_numpy(tp)
    for (_, a), (_, t), (_, b) in zip(_leaves(jp), _leaves(tp),
                                      _leaves(back)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits16(t), _bits16(a))
        assert b.dtype.name == "bfloat16"
        np.testing.assert_array_equal(_bits16(b), _bits16(a))
    with pytest.raises(ValueError, match="dtype"):
        tm.init(0, device="cpu", dtype=torch.float16)


# -------------------------------------------------------- kernels, bf16 q
@pytest.mark.parametrize("B,Sq,Skv,hkv,g,window,cap,n_sent", [
    (2, 1, 30, 1, 4, 5, 30.0, 6),         # decode, sentinel tail, window
    (2, 12, 12, 1, 4, 5, None, 0),        # prefill, GQA 4, window
    (1, 16, 16, 2, 4, None, 30.0, 0),     # several q and kv tiles
])
def test_flash_attention_bf16_q_matches_reference(B, Sq, Skv, hkv, g, window,
                                                  cap, n_sent):
    rng = np.random.default_rng(Sq * 100 + Skv)
    D = 8
    q, k, v = (jnp.asarray(rng.normal(size=s), jnp.bfloat16) for s in (
        (B, Sq, hkv * g, D), (B, Skv, hkv, D), (B, Skv, hkv, D)))
    n_real = Skv - n_sent
    q_pos = np.broadcast_to(np.arange(n_real - Sq, n_real, dtype=np.int32),
                            (B, Sq)).copy()
    kv_pos = np.full((B, Skv), SENT, np.int32)
    kv_pos[:, :n_real] = np.arange(n_real, dtype=np.int32)
    ref = jattn.flash_attention(q, k, v, q_pos=jnp.asarray(q_pos),
                                kv_pos=jnp.asarray(kv_pos), window=window,
                                attn_cap=cap, bq=8, bk=8)
    tq, tk, tv = (params_from_numpy(np.asarray(a), "cpu") for a in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, q_pos=_t(q_pos),
                                kv_pos=_t(kv_pos), window=window,
                                attn_cap=cap)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_ATTN_TOL)


@pytest.mark.parametrize("k,lens,window", [(1, [9, 0, 14], None),
                                           (4, [7, 13, 3], 6)])
def test_paged_attention_bf16_q_matches_reference(k, lens, window):
    """K4 on a bf16 q over a bf16 pool with shuffled pages, an idle lane
    and a softcap: its real columns against the reference kernel's."""
    rng = np.random.default_rng(k * 10 + len(lens))
    ps, Hkv, G, D, nb = 4, 2, 2, 8, 4
    B, P = len(lens), 1 + len(lens) * nb
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, nb), np.int32)
    pos = np.full((P, ps), SENT, np.int32)
    q_pos = np.full((B, k), SENT, np.int32)
    for i, L in enumerate(lens):
        pages = perm[i * nb:(i + 1) * nb]
        bt[i] = pages
        for p in range(L):
            pos[pages[p // ps], p % ps] = p
        c = min(k, L)
        q_pos[i, :c] = np.arange(L - c, L)
    q = jnp.asarray(rng.normal(size=(B, k, Hkv * G, D)), jnp.bfloat16)
    kp = jnp.asarray(rng.normal(size=(P, ps, Hkv, D)), jnp.bfloat16)
    vp = jnp.asarray(rng.normal(size=(P, ps, Hkv, D)), jnp.bfloat16)
    ref = jattn.paged_prefill_attention(
        q, kp, vp, jnp.asarray(pos), jnp.asarray(bt),
        q_pos=jnp.asarray(q_pos), window=window, attn_cap=30.0,
        interpret=True)
    tq, tk, tv = (params_from_numpy(np.asarray(a), "cpu") for a in (q, kp, vp))
    got = tattn.paged_prefill_attention(tq, tk, tv, _t(pos), _t(bt),
                                        q_pos=_t(q_pos), window=window,
                                        attn_cap=30.0)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    for i, L in enumerate(lens):
        c = min(k, L)
        np.testing.assert_allclose(got[i, :c].float().numpy(),
                                   np.asarray(ref[i, :c], np.float32),
                                   **BF16_ATTN_TOL)


# ---------------------------------------------------- kernels, bf16 x
def _gemm_inputs(rng, bits, lead, M, K, N):
    """tests/test_kernels.py's bf16 inputs: x ~ N(0, 1) in bf16, weights
    on the ``bits`` grid, scales U(0.01, 0.1)."""
    lv = 2 ** (bits - 1) - 1
    x = jnp.asarray(rng.normal(size=lead + (M, K)), jnp.bfloat16)
    q = rng.integers(-lv, lv + 1, size=lead + (K, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, size=lead + (N,)).astype(np.float32)
    return x, q, s


def _reference_gemm(x, q, s, bits):
    """The reference's Pallas kernel (interpret mode) for one matrix."""
    if bits == 8:
        return jops.quant_matmul(x, jnp.asarray(q), jnp.asarray(s))
    pw = jpack.pack_sub8(jnp.asarray(q.astype(np.int32)), bits, axis=0)
    return jops.packed_matmul(x, pw, jnp.asarray(s), store_bits=bits)


def _port_gemm(x, q, s, bits):
    from repro_torch.kernels.pack import pack_sub8
    tx = params_from_numpy(np.asarray(x), "cpu")
    if bits == 8:
        return tops.quant_matmul(tx, _t(q), _t(s))
    pw = pack_sub8(_t(q).to(torch.int32), bits, axis=-2)
    return tops.packed_matmul(tx, pw, _t(s), store_bits=bits)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (100, 200, 300),
                                   (1, 128, 128)])
def test_gemm_bf16_x_matches_reference_kernel(bits, M, K, N):
    rng = np.random.default_rng(M + K + N + bits)
    x, q, s = _gemm_inputs(rng, bits, (), M, K, N)
    ref = _reference_gemm(x, q, s, bits)
    got = _port_gemm(x, q, s, bits)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_GEMM_TOL)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_expert_gemm_bf16_x_matches_reference_kernel(bits):
    """An expert stack in one wrapper call (one launch on the card) against
    the reference kernel expert by expert."""
    rng = np.random.default_rng(40 + bits)
    E, C, K, N = 3, 9, 64, 40
    x, q, s = _gemm_inputs(rng, bits, (E,), C, K, N)
    got = _port_gemm(x, q, s, bits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, C, N)
    for e in range(E):
        ref = _reference_gemm(x[e], q[e], s[e], bits)
        np.testing.assert_allclose(got[e].float().numpy(),
                                   np.asarray(ref, np.float32),
                                   **BF16_GEMM_TOL)


def test_int8_store_bf16_x_is_the_fp32_product():
    """A bf16 x against an int8-store leaf, plain and expert-batched, gives
    the reference's ``x @ (q * s)`` in fp32 (``layers.deq``: the fp32
    scales promote), weights unrounded; and the wrappers refuse an x that
    is neither fp32 nor bf16."""
    rng = np.random.default_rng(7)
    x, q, s = _gemm_inputs(rng, 8, (2,), 6, 96, 50)
    want = np.asarray(x.astype(jnp.float32) @ (jnp.asarray(q).astype(
        jnp.float32) * jnp.asarray(s)[:, None]))
    tx = params_from_numpy(np.asarray(x), "cpu")
    for e in range(2):
        got = tlayers.linear(tx[e], {"q": _t(q[e]), "s": _t(s[e][None])})
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[e], rtol=1e-5,
                                   atol=1e-5)
    got = tlayers.expert_linear(tx, {"q": _t(q), "s": _t(s[:, None])})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bfloat16"):
        tops.quant_matmul(tx[0].half(), _t(q[0]), _t(s[0]))
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.flash_attention(
            torch.zeros(1, 2, 2, 8, dtype=torch.float16),
            torch.zeros(1, 3, 1, 8), torch.zeros(1, 3, 1, 8),
            q_pos=torch.zeros(1, 2, dtype=torch.int32),
            kv_pos=torch.zeros(1, 3, dtype=torch.int32))


def test_bf16_store_contractions_and_dtypes():
    """The packed store of a bf16 weight is packed as the reference's eager
    ``quant_pack_sub8`` packs it (every part bit for bit, ``out_dtype``
    bfloat16, the ``full`` bucket bf16); its contraction on a bf16 x is
    bf16 and equals the reference's ``x @ w.dequant()``; per-token
    activation fake quant on bf16 returns the reference's bf16."""
    rng = np.random.default_rng(11)
    R, K, N = 2, 64, 96
    w = jnp.asarray(rng.normal(size=(R, K, N)) / 8, jnp.bfloat16)
    bits = rng.choice([0, 2, 3, 4, 6, 8, 16], size=N).astype(np.float32)
    jw = jlq.quant_pack_sub8(w, bits)
    tw = tlq.quant_pack_sub8(params_from_numpy(np.asarray(w), "cpu"), bits)
    assert tw.out_dtype == jw.out_dtype == "bfloat16"
    assert tw.buckets == jw.buckets
    for tpart, jpart in zip(tw.parts, jw.parts):
        for a, b in zip(tpart, jpart):
            assert str(a.dtype).replace("torch.", "") == b.dtype.name
            np.testing.assert_array_equal(tensor_to_numpy(a), np.asarray(b))
    x = jnp.asarray(rng.normal(size=(5, K)), jnp.bfloat16)
    tx = params_from_numpy(np.asarray(x), "cpu")
    for r in range(R):
        want = np.asarray(x @ jw.dequant()[r], np.float32)
        got = tops.packed_mixed_matmul(tx, tw.take(r))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7,
                                   atol=1e-6)
        lin = tlayers.linear(tx[None], tw.take(r))
        assert lin.dtype == torch.bfloat16
    int8 = {"q": _t(rng.integers(-127, 128, size=(K, N)).astype(np.int8)),
            "s": _t(rng.uniform(0.01, 0.1, size=(1, N)).astype(np.float32))}
    assert tlayers.linear(tx, int8).dtype == torch.float32
    a = jnp.asarray(rng.normal(size=(3, 7, K)), jnp.bfloat16)
    want = jlq.fake_quant_per_token(a, 8.0)
    got = tlq.fake_quant_per_token(params_from_numpy(np.asarray(a), "cpu"),
                                   8.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(got), _bits16(want))


# ------------------------------------------------------------ the model
def _policy(graph, seed):
    rng = np.random.default_rng(seed)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 6, 8, 16], size=l.n_groups
                                ).astype(np.float32) for l in graph.layers}
    return wbits, {l.name: 8.0 for l in graph.layers}


def _engines(arch, store, monkeypatch):
    """The reference's bf16 engine, its fp32 twin and the port's bf16
    engine on ``store``; bf16 caches for the bf16 engines."""
    jm, tm = JLM(JARCHS[arch].smoke), LM(ARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jkw, tkw = {}, {}
    if store == "packed":
        tgraph = tm.graph(seq_len=4, batch=2)
        wbits, abits = _policy(jm.graph(seq_len=4, batch=2), 0)

        def eager_pack(params, graph, policy):
            with jax.disable_jit():
                return japply.apply_policy_packed(params, graph, policy)
        monkeypatch.setattr("repro.serve.engine.apply_policy_packed",
                            eager_pack)
        jkw = dict(policy=JPolicy(JMode.QUANT, wbits, abits),
                   weight_store="packed")
        tkw = dict(policy=QuantPolicy(QuantMode.QUANT, wbits, abits),
                   graph=tgraph, weight_store="packed")
    elif store == "int8":
        jp, jp32 = jm.quantize_params_int8(jp), jm.quantize_params_int8(jp32)
        tp = tm.quantize_params_int8(tp)
    je = JEngine(jm, jp, max_len=MAX_LEN, attn_impl="ref",
                 cache_dtype=jnp.bfloat16, **jkw)
    je32 = JEngine(jm, jp32, max_len=MAX_LEN, attn_impl="ref", **jkw)
    te = ServeEngine(tm, tp, max_len=MAX_LEN, cache_dtype=torch.bfloat16,
                     device="cpu", **tkw)
    return je, je32, te


def _reference_logits(eng, toks, stream=None, t=0):
    """Last-position logits of the reference engine after the prompt and
    ``t`` tokens of ``stream`` (teacher-forced), f32."""
    cache = eng.model.init_cache(toks.shape[0], eng.max_len,
                                 dtype=eng.cache_dtype)
    lg, cache = eng._prefill(eng.params, {"tokens": jnp.asarray(toks)},
                             cache, eng.act_bits, attn_impl="ref")
    for i in range(t):
        lg, cache = eng._decode(eng.params, jnp.asarray(stream[:, i:i + 1]),
                                cache, jnp.int32(toks.shape[1] + i),
                                eng.act_bits, attn_impl="ref")
    return np.asarray(lg[:, -1], np.float32)


def _check_against_reference(arch, store, monkeypatch):
    je, je32, te = _engines(arch, store, monkeypatch)
    toks = np.random.default_rng(1).integers(0, je.model.cfg.vocab,
                                             size=(2, S))
    jl, jl32 = _reference_logits(je, toks), _reference_logits(je32, toks)
    cache = te.model.init_cache(2, MAX_LEN, dtype=torch.bfloat16,
                                device="cpu")
    tl, _ = te._prefill(te.params, {"tokens": torch.as_tensor(toks)}, cache,
                        te.act_bits, attn_impl="cuda")
    tl = tl[:, -1].float().numpy()
    if store == "int8":
        np.testing.assert_allclose(tl, jl, **INT8_STORE_TOL)
        bound = INT8_STORE_TOL["atol"]
    else:
        d_twin = float(np.abs(jl - jl32).max())
        assert d_twin > 0
        bound = BF16_TWIN_FACTOR * d_twin
        assert float(np.abs(tl - jl).max()) <= bound, (
            float(np.abs(tl - jl).max()), d_twin)
    want = je.generate(toks, N_NEW)["tokens"]
    got = te.generate(toks, N_NEW)
    assert got["prefill_logits"].dtype == (
        torch.float32 if store == "int8" else torch.bfloat16)
    diff = np.argwhere(got["tokens"] != want)
    if diff.size:
        t = int(diff[:, 1].min())
        ref = _reference_logits(je, toks, want, t)
        for b in np.unique(diff[diff[:, 1] == t][:, 0]):
            top = np.sort(ref[b])
            assert top[-1] - top[-2] < bound, (b, t, top[-2:])


@pytest.mark.parametrize("store", ["dense", "packed", "int8"])
def test_gemma2_bf16_matches_reference(store, monkeypatch):
    _check_against_reference("gemma2-2b", store, monkeypatch)


def test_granite_moe_bf16_packed_matches_reference(monkeypatch):
    _check_against_reference("granite-moe-3b-a800m", "packed", monkeypatch)


# ------------------------------------------------- inside the port, bitwise
@pytest.fixture(scope="module")
def bf16_engine():
    cfg = ARCHS["gemma2-2b"].smoke
    m = LM(cfg)
    params = m.init(0, device="cpu", dtype=torch.bfloat16)
    graph = m.graph(seq_len=4, batch=2)
    wbits, abits = _policy(graph, 3)
    eng = ServeEngine(m, params, policy=QuantPolicy(QuantMode.QUANT, wbits,
                                                    abits), graph=graph,
                      max_len=32, weight_store="packed",
                      cache_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(41)
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in [(3, 5), (7, 4), (5, 6), (9, 3)]]
    gens = [eng.generate(t[None], n)["tokens"][0] for t, n in reqs]
    return eng, reqs, gens


@pytest.mark.parametrize("kw", [
    dict(), dict(overlap=False), dict(prefill="monolithic"),
    dict(speculative=True, draft_k=3),
    dict(speculative=True, draft_k=2, draft_policy="lowbit")],
    ids=["overlap", "sync", "monolithic", "spec", "spec-lowbit"])
def test_bf16_run_equals_generate(bf16_engine, kw):
    eng, reqs, gens = bf16_engine
    res = eng.run(reqs, page_size=4, max_slots=2, **kw)
    for i, (out, want) in enumerate(zip(res["outputs"], gens)):
        np.testing.assert_array_equal(out, want, err_msg=f"request {i}")
