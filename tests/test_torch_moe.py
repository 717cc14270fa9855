"""The port's MoE FFN and the MoE families against the JAX reference, on
the CPU.

Seeded numpy inputs go through the reference's ``_moe_ffn_impl`` and the
port's ``moe_ffn``, and the reference's smoke models (granite-moe,
llama4-scout) cross over with ``interop.params_from_numpy``.  Outputs
must agree to rtol = atol = 1e-4 (both sides compute in f32 and differ
in summation order), gradients to rtol 1e-4 / atol 1e-5
(``GRAD_TOL``, tests/test_torch_train.py).  Routing must be the same
experts in the same order first: a router-probability difference at f32 rounding can swap a
token's k-th and (k+1)-th expert and move its output by O(1), so a token
whose adjacent top-(k+1) probabilities lie within ``TIE`` of each other
is left out of both comparisons (the gap rule, applied to routing);
these seeds give none.  The port's expert GEMMs on the packed store run
the plain versions of the expert-batched K2 / K3 launches on CPU
tensors: one call per bucket and expert site, never one per expert.  The
grouped dispatch (the routed pairs alone, sorted by expert) must give the
capacity dispatch's bits.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import packed_matmul as kpm  # noqa: E402
from repro_torch.kernels import quant_matmul as kqm  # noqa: E402
from repro_torch.kernels.pack import pack_sub8  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.quant.apply import apply_policy_packed  # noqa: E402
from repro_torch.quant.linear_quant import quant_pack_sub8  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_torch_train.py
TIE = 1e-6
MOE_ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch, cfg=None, seed=0):
    cfg = cfg or JARCHS[arch].smoke
    jm = JLM(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, LM(cfg), tp


def _near_ties(probs, k):
    """Tokens whose top-(k+1) router probabilities hold two within TIE."""
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    return (np.abs(np.diff(top, axis=-1)) < TIE).any(axis=-1)


# ------------------------------------------------------------- moe_ffn
@pytest.mark.parametrize("top_k,cf", [(1, 0.0), (1, 1.25), (8, 0.0),
                                      (8, 1.25)])
def test_moe_ffn_matches_reference(top_k, cf):
    rng = np.random.default_rng(10 + top_k)
    T, d, E, ff = 64, 16, (16 if top_k == 8 else 8), 24
    router = rng.normal(size=(d, E))
    router[:, :3] += 0.6          # a few popular experts: cf 1.25 drops
    p = {"router": router / np.sqrt(d),
         "wg": rng.normal(size=(E, d, ff)) / np.sqrt(d),
         "wu": rng.normal(size=(E, d, ff)) / np.sqrt(d),
         "wd": rng.normal(size=(E, ff, d)) / np.sqrt(ff)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.normal(size=(2, T // 2, d)) + 0.5).astype(np.float32)
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=cf, act_bits=8.0)
    jo, jprobs = jlayers._moe_ffn_impl(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, **kw)
    to, tprobs = tlayers.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()},
                                 **kw)
    jprobs = np.asarray(jprobs)
    np.testing.assert_allclose(tprobs.numpy(), jprobs, **TOL)
    # routing first: the same experts in the same order
    ok = ~_near_ties(jprobs, top_k)
    _, ji = jax.lax.top_k(jnp.asarray(jprobs), top_k)
    _, ti = tlayers.moe_route(tprobs, top_k)
    np.testing.assert_array_equal(ti.numpy()[ok], np.asarray(ji)[ok])
    C = tlayers.moe_capacity(T, E, top_k, cf)
    load = np.bincount(np.asarray(ji).reshape(-1), minlength=E)
    assert (load.max() > C) == (cf > 0)          # cf 1.25 drops, cf 0 not
    np.testing.assert_allclose(to.numpy().reshape(T, d)[ok],
                               np.asarray(jo).reshape(T, d)[ok], **TOL)


def test_position_in_expert_is_the_one_hot_cumsum():
    """The reference's position rule, cumsum(one_hot(eidx)) - 1 read at
    each pair's expert, over padded experts that nothing routes to."""
    eidx = torch.from_numpy(np.random.default_rng(11).integers(
        0, 5, size=200))
    onehot = torch.nn.functional.one_hot(eidx, 8)
    want = (torch.cumsum(onehot, dim=0) - 1).gather(1, eidx[:, None])[:, 0]
    assert torch.equal(tlayers._position_in_expert(eidx, 8), want)


def test_moe_aux_loss_matches_reference():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(20, 6)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    gi = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    want = jlayers.moe_aux_loss(jnp.asarray(probs), jnp.asarray(gi), 6)
    got = tlayers.moe_aux_loss(_t(probs), _t(gi), 6)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_moe_route_breaks_ties_toward_the_lower_expert():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    _, gi = tlayers.moe_route(probs, 2)
    _, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gi.numpy(), [[1, 2], [0, 1]])


# ---------------------------------------------------------- the models
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_matches_reference(arch):
    """apply (logits and aux), loss (NLL + 0.01 aux), and prefill + three
    decode steps over an fp32 cache, K1's wrapper on the plain path."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, 10)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, size=(2, 10)).astype(np.int32)
    jl, jaux = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.apply(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    batch = {"tokens": toks, "labels": labels}
    jloss = jax.jit(jm.loss)(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tloss = tm.loss(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, tc,
                        attn_impl="cuda")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(jm.decode_step)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.int32(10 + i))
        tl, tc = tm.decode_step(tp, _t(tok).long(), tc, 10 + i,
                                attn_impl="cuda")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_lm_grads_match_reference(arch, cf):
    """value_and_grad of LM.loss against jax.value_and_grad of the
    reference's, every leaf at GRAD_TOL (tests/test_torch_train.py), at
    capacity factor 0 (nothing dropped) and 1.25 (over-capacity pairs
    dropped; their gradient is the residual path's alone): the dispatch's
    and the gather's index_select backwards, the gates' and the router's
    gradients included."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.interop import params_to_numpy
    base = JARCHS[arch].smoke
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    jm, jp, tm, tp = _pair(arch, cfg)
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 12)),
             "labels": rng.integers(0, cfg.vocab, size=(2, 12))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][0, -3:] = -1
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = value_and_grad(lambda p: tm.loss(p, {k: _t(v) for k, v in
                                                  batch.items()}), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tleaves = jax.tree.leaves(params_to_numpy(tg))
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(np.asarray(a), b, **GRAD_TOL)
    router = [np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(
        params_to_numpy(tg))[0] if "router" in jax.tree_util.keystr(p)]
    assert router and all(np.abs(r).sum() > 0 for r in router)


def test_moe_local_dispatch_no_mesh_is_identity():
    """Mirrors tests/test_quant_serving.py:51: without a mesh (the port
    never has one) local_dispatch is the plain path, bit for bit."""
    base = ARCHS["granite-moe-3b-a800m"].smoke
    cfg = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, local_dispatch=True))
    m1, m2 = LM(base), LM(cfg)
    params = m1.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab, size=(2, 8)))
    l1, _ = m1.apply(params, {"tokens": toks})
    l2, _ = m2.apply(params, {"tokens": toks})
    assert torch.equal(l1, l2)


def test_ep_pad_preserves_routing_semantics():
    """Mirrors tests/test_quant_serving.py:64: padded (never-routed)
    experts change nothing, in the port and against the reference's
    padded model."""
    base = JARCHS["llama4-scout-17b-a16e"].smoke
    padded = dataclasses.replace(base,
                                 moe=dataclasses.replace(base.moe, pad_to=8))
    jm, jp, tm, tp = _pair("llama4-scout-17b-a16e")
    pm = LM(padded)
    pp = pm.init(1, device="cpu")
    E = base.moe.n_experts
    for i, blk in enumerate(tp["blocks"]):
        for k, v in blk.items():
            if k in ("wg", "wu", "wd"):
                assert pp["blocks"][i][k].shape[1] == 8
                pp["blocks"][i][k][:, :E] = v
            else:
                pp["blocks"][i][k] = v
    for k in ("embed", "unembed", "final_norm"):
        pp[k] = tp[k]
    toks = np.random.default_rng(4).integers(0, base.vocab, size=(2, 8))
    l1, _ = tm.apply(tp, {"tokens": _t(toks)})
    l2, _ = pm.apply(pp, {"tokens": _t(toks)})
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=1e-4)
    jpm = JLM(padded)
    jl2, _ = jax.jit(jpm.apply)(jax.tree.map(lambda t: jnp.asarray(
        t.numpy()), pp), {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_graph_sites_match_reference(arch):
    jm, tm = JLM(JARCHS[arch].smoke), LM(ARCHS[arch].smoke)
    key = lambda g: [(l.name, l.kind, l.c_in, l.c_out, l.macs, l.numel,
                      l.param_path, l.channel_axis, l.n_groups)
                     for l in g.layers]
    jg, tg = jm.graph(seq_len=4, batch=2), tm.graph(seq_len=4, batch=2)
    assert key(tg) == key(jg)
    assert sum(l.kind == "expert" for l in tg.layers) == 3


def _jit_apply_policy_packed(params, graph, policy):
    """The reference's ``apply_policy_packed`` with each weight's
    ``quant_pack_sub8`` under one ``jax.jit`` (op by op it takes minutes
    on a CPU)."""
    from repro.quant.apply import _get_path, _set_path
    from repro.quant.linear_quant import quant_pack_sub8
    out = params
    for layer in graph.layers:
        bits = policy.expand_weight_bits(layer)
        pack = jax.jit(lambda w, b=bits: quant_pack_sub8(w, b))
        out = _set_path(out, layer.param_path,
                        pack(_get_path(params, layer.param_path)))
    return out


def test_packed_expert_store_matches_reference(monkeypatch):
    """granite-smoke in the packed store (every bucket): the port's own
    apply_policy_packed equals the reference's store (data bit for bit,
    scales to f32 rounding: the reference's divide runs under jit),
    and its forward through the plain expert-batched GEMMs equals the
    reference's packed forward, with one GEMM call per non-empty
    int2 / int4 / int8 bucket of each expert site and repeat."""
    arch = "granite-moe-3b-a800m"
    jm, jp, tm, tp = _pair(arch)
    jg, tg = jm.graph(seq_len=4, batch=2), tm.graph(seq_len=4, batch=2)
    rng = np.random.default_rng(7)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 6, 8, 16], size=l.n_groups
                                ).astype(np.float32) for l in jg.layers}
    jpacked = _jit_apply_policy_packed(jp, jg, JPolicy(JMode.QUANT, wbits, {}))
    tpacked = apply_policy_packed(tp, tg, QuantPolicy(QuantMode.QUANT,
                                                      wbits, {}))
    ref_store = params_from_numpy(jax.tree.map(np.asarray, jpacked), "cpu")
    for l in tg.layers:
        a = tpacked["blocks"][0][l.name.split(".")[1]] \
            if l.name != "unembed" else tpacked["unembed"]
        b = ref_store["blocks"][0][l.name.split(".")[1]] \
            if l.name != "unembed" else ref_store["unembed"]
        assert a.buckets == b.buckets
        for pa, pb in zip(a.parts, b.parts):
            assert pa[0].shape == pb[0].shape
            if pa[0].dtype == torch.int8:
                assert torch.equal(pa[0], pb[0])
            for sa, sb in zip(pa[1:], pb[1:]):     # scales: f32 rounding
                np.testing.assert_allclose(sa.numpy(), sb.numpy(),
                                           rtol=1e-6, atol=0)
    calls = []
    for name in ("quant_matmul", "packed_matmul"):
        fn = getattr(kops, name)
        monkeypatch.setattr(
            kops, name, lambda x, *a, _f=fn, **kw: calls.append(x.ndim) or
            _f(x, *a, **kw))
    toks = rng.integers(0, jm.cfg.vocab, size=(2, 10)).astype(np.int32)
    jl, _ = jax.jit(jm.apply)(jpacked, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.apply(tpacked, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    want = sum(sum(name in ("int2", "int4", "int8")
                   for name, _ in tpacked["blocks"][0][s].buckets)
               for s in ("wg", "wu", "wd")) * jm.cfg.n_repeat
    # QBN 16 gives the stacks a bf16 full bucket, which has no grouped
    # launch: the experts keep the capacity layout's batched calls
    assert any(name == "full" for s in ("wg", "wu", "wd")
               for name, _ in tpacked["blocks"][0][s].buckets)
    assert calls.count(3) == want


# ------------------------------------------------- the grouped dispatch
GROUPED_E, GROUPED_K, GROUPED_D, GROUPED_FF = 8, 2, 24, 16


def _k23_stacks(store, rng):
    """wg, wu, wd of GROUPED_E experts as stacks that K2 / K3 contract as
    they are: the packed store (pruned, int2, int4 and int8 buckets) or
    the uniform int8 store."""
    E, d, ff = GROUPED_E, GROUPED_D, GROUPED_FF

    def one(shape):
        w = torch.from_numpy(rng.normal(size=shape).astype(np.float32) /
                             math.sqrt(shape[-2]))
        if store == "int8":
            s = w.abs().amax(dim=-2, keepdim=True) / 127.0
            return {"q": torch.round(w / s).to(torch.int8), "s": s}
        bits = np.resize(np.float32([0, 2, 3, 4, 8]), shape[-1])
        return quant_pack_sub8(w, rng.permutation(bits))

    return {"wg": one((E, d, ff)), "wu": one((E, d, ff)),
            "wd": one((E, ff, d))}


@pytest.mark.parametrize("store", ["packed", "int8"])
@pytest.mark.parametrize("T,cf", [(8, 0.0), (9, 0.0), (192, 0.0),
                                  (192, 1.25)])
def test_grouped_dispatch_equals_capacity_dispatch(T, cf, store,
                                                   monkeypatch):
    """The two layouts of the experts on the same logits give the same
    bits, out and probs: routing skewed so that expert 0 is in every
    token's top 2 (at T 192 its 192 pairs fill two 128-row tiles) and
    expert 7 in none; capacity factor 1.25 drops pairs.  moe_ffn takes
    the grouped layout exactly where the capacity layout's C is over
    SKINNY_M (T 8: C 8, capacity; T 9: grouped), its ``moe`` span counts
    T x K rows grouped and E x C otherwise, and each grouped stack takes
    one grouped call per K2 / K3 bucket."""
    rng = np.random.default_rng(20 + T)
    E, K, d = GROUPED_E, GROUPED_K, GROUPED_D
    router = rng.normal(size=(d, E)).astype(np.float32) / math.sqrt(d)
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32) + 0.5)
    router[:, 0] += 4.0 * np.sign(x.numpy().sum(0))
    router[:, 7] -= 4.0 * np.sign(x.numpy().sum(0))
    p = {"router": torch.from_numpy(router), **_k23_stacks(store, rng)}
    C = tlayers.moe_capacity(T, E, K, cf)
    logits = tlayers.linear(x, p["router"], role=None)
    load = torch.bincount(tlayers.moe_route(torch.softmax(logits, -1),
                                            K)[1].reshape(-1), minlength=E)
    assert load[0] == T and load[7] == 0
    assert (load.max() > C) == (cf > 0)
    kw = dict(top_k=K, capacity=C, act_bits=8.0)
    a, pa = tlayers._moe_capacity(x, logits, p, **kw)
    b, pb = tlayers._moe_grouped(x, logits, p, **kw)
    assert torch.equal(a, b) and torch.equal(pa, pb)

    calls = []
    for mod, name in ((kops, "quant_matmul_grouped"),
                      (kops, "packed_matmul_grouped"),
                      (kqm, "quant_matmul_grouped"),
                      (kpm, "packed_matmul_grouped")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, **k:
                            calls.append(1) or _f(*a, **k))
    grouped = C > kqm.SKINNY_M
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out, _ = tlayers.moe_ffn(x, p, n_experts=E, top_k=K,
                                 capacity_factor=cf, act_bits=8.0)
    (moe,) = [r for r in spans.records() if r[0] == tlayers.MOE]
    spans.clear()
    assert torch.equal(out, a)
    assert moe[4] == {"pairs": T * K, "rows": T * K if grouped else E * C}
    want = sum(1 if store == "int8" else
               sum(name != "pruned" for name, _ in p[k].buckets)
               for k in ("wg", "wu", "wd"))
    assert len(calls) == want * grouped


def _grouped_gemm(bits, x, w, s, offsets, cap):
    if bits == 8:
        return kqm.quant_matmul_grouped(x, w, s, offsets, cap)
    return kpm.packed_matmul_grouped(x, w, s, offsets, cap,
                                     store_bits=bits)


def _grouped_operands(bits, rng, E=4, P=40, K=24, N=16):
    lv = 2 ** (bits - 1) - 1
    q = torch.from_numpy(rng.integers(-lv, lv + 1, size=(E, K, N))
                         ).to(torch.int8)
    w = q if bits == 8 else pack_sub8(q, bits, axis=-2)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, size=(E, N)).astype(
        np.float32)) / (lv * math.sqrt(K))
    x = torch.from_numpy(rng.normal(size=(P, K)).astype(np.float32))
    return x, q, w, s


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_grouped_gemm_plain_equals_per_expert_calls(bits):
    """The grouped K2 / K3 wrappers' plain version: groups of 7, 0, 12 and
    9 rows (rows 1-2 and 30-39 in none), cap 12.  Each group's rows are
    the expert-batched plain call's rows on the (E, cap, K) layout, bit for
    bit, and that expert's own plain call's to f32 rounding; rows outside
    every group are zero."""
    from repro_torch.kernels.ref import packed_matmul_ref, quant_matmul_ref
    x, q, w, s = _grouped_operands(bits, np.random.default_rng(30 + bits))
    off = [0, 7, 7, 19, 28]
    offsets = torch.tensor(off, dtype=torch.int32)
    y = _grouped_gemm(bits, x, w, s, offsets, 12)
    plain = (lambda xb, e=slice(None): quant_matmul_ref(xb, w[e], s[e])) \
        if bits == 8 else \
        (lambda xb, e=slice(None): packed_matmul_ref(xb, w[e], s[e], bits))
    batch = x.new_zeros((4, 12, x.shape[1]))
    for e, (a, b) in enumerate(zip(off, off[1:])):
        batch[e, :b - a] = x[a:b]
    yb = plain(batch)
    for e, (a, b) in enumerate(zip(off, off[1:])):
        assert torch.equal(y[a:b], yb[e, :b - a])
        torch.testing.assert_close(y[a:b], plain(x[a:b], e), rtol=1e-6,
                                   atol=1e-6)
    assert not y[off[-1]:].any()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bad", ["dtype", "length", "not_monotone",
                                 "past_end", "over_cap"])
def test_grouped_gemm_refuses_bad_offsets(bits, bad):
    x, _, w, s = _grouped_operands(bits, np.random.default_rng(40))
    off = {"dtype": torch.tensor([0, 5, 9, 9, 20]),
           "length": torch.tensor([0, 5, 9, 20], dtype=torch.int32),
           "not_monotone": torch.tensor([0, 9, 5, 9, 20], dtype=torch.int32),
           "past_end": torch.tensor([0, 5, 9, 9, 41], dtype=torch.int32),
           "over_cap": torch.tensor([0, 5, 9, 9, 40], dtype=torch.int32),
           }[bad]
    with pytest.raises(ValueError, match="offsets"):
        _grouped_gemm(bits, x, w, s, off, 16)
    _grouped_gemm(bits, x, w, s, torch.tensor([0, 5, 9, 9, 20],
                                              dtype=torch.int32), 16)


@pytest.mark.parametrize("store", ["dense", "packed"])
def test_moe_run_matches_generate(store):
    """run() == generate() per request on granite-smoke (capacity_factor
    0, as the smoke config sets: a token's dispatch does not depend on the
    batch it rides in), in the dense and the packed store."""
    cfg = ARCHS["granite-moe-3b-a800m"].smoke
    assert cfg.moe.capacity_factor == 0.0
    m = LM(cfg)
    params = m.init(0, device="cpu")
    policy = None
    if store == "packed":
        graph = m.graph(seq_len=1, batch=1)
        rng = np.random.default_rng(1)
        policy = QuantPolicy(
            QuantMode.QUANT,
            {l.name: rng.choice([0, 2, 4, 8], size=l.n_groups).astype(
                np.float32) for l in graph.layers},
            {l.name: 8.0 for l in graph.layers})
    eng = ServeEngine(m, params, policy=policy, max_len=32,
                      weight_store="packed" if policy else "fake",
                      device="cpu")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab, size=s).astype(np.int32), n)
            for s, n in [(3, 5), (7, 4), (5, 6), (9, 3), (2, 5)]]
    res = eng.run(reqs, page_size=4, max_slots=3)
    for i, ((toks, n), out) in enumerate(zip(reqs, res["outputs"])):
        want = eng.generate(toks[None], n)["tokens"][0]
        np.testing.assert_array_equal(out, want, err_msg=f"request {i}")
    assert eng.trace_counts["model_step"] <= 2


def test_moe_speculative_run_matches_plain_run():
    """Speculative decode is not gated on MoE patterns (the reference's
    isn't): the self-draft and the prefix draft emit the plain streams."""
    cfg = ARCHS["granite-moe-3b-a800m"].smoke
    m = LM(cfg)
    eng = ServeEngine(m, m.init(0, device="cpu"), max_len=32, device="cpu")
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, cfg.vocab, size=s).astype(np.int32), n)
            for s, n in [(5, 6), (3, 5), (8, 4)]]
    plain = eng.run(reqs, page_size=4, max_slots=2)["outputs"]
    for kw in (dict(draft_layers=cfg.n_repeat), {}):
        spec = eng.run(reqs, page_size=4, max_slots=2, speculative=True,
                       draft_k=2, **kw)["outputs"]
        for a, b in zip(spec, plain):
            np.testing.assert_array_equal(a, b)
