"""mamba2, jamba, musicgen and llama-3.2-vision with bf16 parameters in the
port, on the CPU, against the JAX reference.

Both packages get the same parameters: the reference's smoke models
``LM.init(key, dtype=bfloat16)``, carried across bit for bit
(``interop.params_from_numpy``); seeded numpy inputs (frame and image
embeddings x 0.3, as tests/test_models.py:18, rounded to bf16 for both).

* The decode window: ``mamba_decode_step`` joins the cached window and the
  new token in the type they promote to, as the reference's
  ``jnp.concatenate``, and returns it in that type: fp32 over an fp32
  cache, bf16 over a bf16 cache of a bf16 model.  Its window is then equal
  to the reference's bit for bit and its state within ``STATE_TOL``.
* Everything else by the twin rule of tests/test_torch_bf16_model.py:
  XLA fuses the reference's bf16 elementwise chains (the causal conv's sum
  of K products, the gate, the norms) and rounds once where eager PyTorch
  rounds after every op, so the packages differ by more than fp32 noise.
  The bound is the reference's own distance from its fp32 twin (the same
  parameters and inputs upcast, fp32 caches): within ``BF16_TWIN_FACTOR``
  (2) times it, as max abs over the real vocabulary (musicgen's padded
  columns, -1e30 in both, left out).  A stream of steps (prefill, then
  decode) is held as a whole: the max over all its steps against the
  twin's max over the same steps, since one step's twin distance can
  happen to be small.  The loss is the mean of the per-position NLL, held
  by the twin rule on that NLL vector.  Gradients: every leaf, max abs,
  against the twin's max over every leaf (tests/test_torch_bf16_train.py).
* Streams by the gap rule: the port's greedy stream equals the
  reference's, or first differs where the reference's top-2 gap
  (teacher-forced along its own stream) is below the twin bound.
* The stores: each package packs its own store from the same bf16
  parameters and policy (the reference's ``apply_policy_packed`` eagerly,
  under ``jax.disable_jit()``), every part bit for bit; their forwards by
  the twin rule, the twin the reference's store of the upcast parameters.
  The uniform int8 store: ``q`` bit for bit, ``s`` to fp32 rounding.
* Inside the port, bitwise: monolithic ``run()`` == ``generate()``,
  chunked ``run()`` overlap on == off (its streams against generate's by
  the gap rule), and speculative runs on recurrent state still raise.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import paged_kv as jpkv  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.ddpg import tree_leaves  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 params_to_numpy, tensor_to_numpy)
from repro_torch.kernels.pack import PackedWeight  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.quant.apply import apply_policy_packed  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve import paged_kv as tpkv  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402

BF16_TWIN_FACTOR = 2.0                 # tests/test_torch_bf16_model.py
# one decode step from the same window and state: both packages convolve
# the same window in the same type and update the fp32 state, so they
# differ by fp32 summation order and the bf16 rounding of x's projections
STATE_TOL = dict(rtol=1e-2, atol=1e-2)
INT8_SCALE_TOL = dict(rtol=1e-7, atol=0)    # tests/test_torch_frontends.py
MAMBA, JAMBA = "mamba2-780m", "jamba-1.5-large-398b"
AUDIO, VISION = "musicgen-large", "llama-3.2-vision-90b"
FAMILIES = [MAMBA, JAMBA, AUDIO, VISION]
SENT = 2**31 - 1
BF = jnp.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, its bf16 params, their fp32 twin, port model,
    the port's copy of the bf16 params)."""
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0), dtype=BF)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jm, jp, jp32, LM(ARCHS[arch].smoke), params_from_numpy(_np(jp),
                                                                  "cpu")


def _bf16(a):
    return np.asarray(jnp.asarray(a, BF))


def _inputs(cfg, B, S, seed):
    """Numpy inputs of S positions (bf16 embeddings), and labels."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.frontend == "audio_stub":
        out["embeds"] = _bf16(0.3 * rng.standard_normal((B, S, cfg.d_model)))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(B, S)
                                     ).astype(np.int32)
    if any(b.kind == "cross_attn" for b in cfg.pattern):
        out["img_embeds"] = _bf16(0.3 * rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)))
    return out


def _key(cfg):
    return "embeds" if cfg.frontend == "audio_stub" else "tokens"


def _model_in(cfg, batch, lo, hi):
    """The model inputs of positions lo..hi (no labels)."""
    out = {_key(cfg): batch[_key(cfg)][:, lo:hi]}
    if "img_embeds" in batch:
        out["img_embeds"] = batch["img_embeds"]
    return out


def _j(b, twin=False):
    """jnp inputs; the twin's embeddings in fp32."""
    return {k: jnp.asarray(v, jnp.float32) if twin and v.dtype == BF
            else jnp.asarray(v) for k, v in b.items()}


def _tt(b):
    return {k: params_from_numpy(v, "cpu") for k, v in b.items()}


def _f32(a, V):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)[..., :V]


def _dist(a, b, V):
    return float(np.abs(_f32(a, V) - _f32(b, V)).max())


def _twin_rule(port, ref, twin, V, what):
    """|port - ref| within BF16_TWIN_FACTOR x |ref - twin| (max abs over
    the real vocabulary); returns the bound."""
    d_twin = _dist(ref, twin, V)
    assert d_twin > 0, what
    d = _dist(port, ref, V)
    assert d <= BF16_TWIN_FACTOR * d_twin, (what, d, d_twin)
    return BF16_TWIN_FACTOR * d_twin


def _nll(logits, labels):
    """Per-position next-token NLL of (B, S, V) logits, in fp64."""
    lf = np.asarray(logits, np.float64)
    m = lf.max(-1, keepdims=True)
    lse = m[..., 0] + np.log(np.exp(lf - m).sum(-1))
    gold = np.take_along_axis(lf, labels[..., None], -1)[..., 0]
    return lse - gold


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


# ------------------------------------------------------ the decode window
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_decode_window_dtype_and_state_match_reference(cache):
    """One ``mamba_decode_step`` of mamba2-smoke's first block on a bf16
    x, from the same window and state: the new window in the reference's
    type (fp32 over an fp32 window, bf16 over a bf16 one) and equal to it
    bit for bit (the cached entries and the new token's bf16 projection);
    the new state within STATE_TOL."""
    jm, jp, _, tm, tp = _pair(MAMBA)
    cfg = jm.cfg
    rng = np.random.default_rng(12)
    B, di = 2, cfg.ssm.d_inner(cfg.d_model)
    H, P, N = cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim, \
        cfg.ssm.d_state
    x = _bf16(0.3 * rng.standard_normal((B, 1, cfg.d_model)))
    conv = rng.standard_normal((B, cfg.ssm.d_conv - 1, di)).astype(
        np.float32)
    conv = conv if cache == "float32" else _bf16(conv)
    state = 0.3 * rng.standard_normal((B, H, P, N)).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"])
    tbp = {k: v[0] for k, v in tp["blocks"][0]["mamba"].items()}
    jy, jc = jax.jit(lambda p, x, c: jssm.mamba_decode_step(
        p, x, c, cfg.ssm, cfg.d_model))(
        jbp, jnp.asarray(x), {"conv": jnp.asarray(conv),
                              "state": jnp.asarray(state)})
    ty, tc = tssm.mamba_decode_step(
        tbp, params_from_numpy(x, "cpu"),
        {"conv": params_from_numpy(conv, "cpu"), "state": _t(state)},
        cfg.ssm, cfg.d_model)
    assert str(jc["conv"].dtype) == cache
    assert _dtype_name(tc["conv"]) == cache
    assert tc["state"].dtype == torch.float32 and ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(tensor_to_numpy(tc["conv"]),
                                  np.asarray(jc["conv"]))
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                               **STATE_TOL)


# ------------------------------------------------------- apply and loss
@pytest.mark.parametrize("arch", FAMILIES)
def test_apply_and_loss_match_reference(arch):
    """The full forward at every position (bf16 logits) and the loss (the
    mean of the per-position NLL: that vector by the twin rule, the loss
    within the same bound)."""
    jm, jp, jp32, tm, tp = _pair(arch)
    cfg = jm.cfg
    V = cfg.vocab
    batch = _inputs(cfg, 2, 12, seed=1)
    x = _model_in(cfg, batch, 0, 12)
    jl, _ = jax.jit(jm.apply)(jp, _j(x))
    jl32, _ = jax.jit(jm.apply)(jp32, _j(x, twin=True))
    tl, aux = tm.apply(tp, _tt(x))
    assert jl.dtype == BF and tl.dtype == torch.bfloat16
    _twin_rule(tl, jl, jl32, V, "logits")
    lab = batch["labels"]
    nll = [_nll(_f32(a, V), lab) for a in (tl, jl, jl32)]
    d_twin = float(np.abs(nll[1] - nll[2]).max())
    assert float(np.abs(nll[0] - nll[1]).max()) <= BF16_TWIN_FACTOR * d_twin
    jloss = jax.jit(jm.loss)(jp, _j(batch))
    tloss = tm.loss(tp, _tt(batch))
    assert tloss.dtype == torch.float32
    assert abs(float(tloss) - float(jloss)) <= BF16_TWIN_FACTOR * d_twin


# --------------------------------------------- prefill and decode, dense
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_match_reference(arch, cache):
    """prefill of 8 positions, then 4 decode steps (teacher-forced) over a
    dense cache of ``cache`` type: every step's logits by the twin rule
    over the stream, and every cache plane in the reference's type after
    decode (a mamba window: fp32 over an fp32 cache, bf16 over a bf16
    one; a vision "memory" entry in the cache type)."""
    jm, jp, jp32, tm, tp = _pair(arch)
    cfg = jm.cfg
    V, B, Sp, S = cfg.vocab, 2, 8, 12
    jdt = jnp.float32 if cache == "float32" else BF
    tdt = getattr(torch, cache)
    batch = _inputs(cfg, B, S, seed=2)
    jc = jm.init_cache(B, S, dtype=jdt)
    jc32 = jm.init_cache(B, S, dtype=jnp.float32)
    tc = tm.init_cache(B, S, dtype=tdt, device="cpu")
    pre = _model_in(cfg, batch, 0, Sp)
    steps = [[], [], []]
    jl, jc = jax.jit(jm.prefill)(jp, _j(pre), jc)
    jl32, jc32 = jax.jit(jm.prefill)(jp32, _j(pre, twin=True), jc32)
    tl, tc = tm.prefill(tp, _tt(pre), tc)
    for s, a in zip(steps, (tl, jl, jl32)):
        s.append(_f32(a, V))
    dec = jax.jit(jm.decode_step)
    for i in range(Sp, S):
        xi = {"x": batch[_key(cfg)][:, i:i + 1]}
        jl, jc = dec(jp, _j(xi)["x"], jc, jnp.int32(i))
        jl32, jc32 = dec(jp32, _j(xi, twin=True)["x"], jc32, jnp.int32(i))
        tl, tc = tm.decode_step(tp, _tt(xi)["x"], tc, i)
        assert tl.dtype == torch.bfloat16
        for s, a in zip(steps, (tl, jl, jl32)):
            s.append(_f32(a, V))
    port, ref, twin = (np.stack(s) for s in steps)
    _twin_rule(port, ref, twin, V, "stream")
    for kind, jcp, tcp in zip(cfg.cache_kinds(), jc, tc):
        assert sorted(jcp) == sorted(tcp), kind
        for k in jcp:
            assert _dtype_name(tcp[k]) == str(jcp[k].dtype), (kind, k)


# ------------------------------------------------- paged pools, bf16 model
def _paged_streams(jm, jp, tm, tp, pool_dt, twin=False, port=True):
    """Two requests (prompts 9 and 6, an image each for vision) prefilled
    alone into batch-1 dense caches, written into 3-slot pools (slot 2
    idle) of the reference and, with ``port``, the port; then 2
    ``decode_step_paged`` steps.  Returns each package's active-lane
    logits of every step and the pools."""
    cfg, kinds = jm.cfg, jm.cfg.cache_kinds()
    rng = np.random.default_rng(6)
    jdt = jnp.float32 if pool_dt == torch.float32 else BF
    jc = jm.init_paged_cache(3, 9, 4, dtype=jdt)
    tc = tm.init_paged_cache(3, 9, 4, dtype=pool_dt, device="cpu") \
        if port else None
    bt = np.zeros((3, 4), np.int32)
    bt[0, :3] = [3, 1, 6]
    bt[1, :2] = [2, 5]
    jout, tout = [[], []], [[], []]
    for slot, n in ((0, 9), (1, 6)):
        b = {"tokens": rng.integers(0, cfg.vocab, size=(1, n)
                                    ).astype(np.int32)}
        if any(x.kind == "cross_attn" for x in cfg.pattern):
            b["img_embeds"] = _bf16(0.3 * rng.standard_normal(
                (1, cfg.n_img_tokens, cfg.d_model)))
        L = -(-n // 4) * 4
        blocks = [int(x) for x in bt[slot, :L // 4]]
        jl, jd = jax.jit(jm.prefill)(jp, _j(b, twin=twin),
                                     jm.init_cache(1, L, dtype=jdt))
        jc = jpkv.write_prefill(jc, jd, kinds, slot, blocks, 4)
        jout[slot].append(np.asarray(jl, np.float32)[0])
        if port:
            tl, td = tm.prefill(tp, _tt(b), tm.init_cache(
                1, L, dtype=pool_dt, device="cpu"))
            assert tpkv.write_prefill(tc, td, kinds, slot, blocks, 4) is tc
            tout[slot].append(_f32(tl, None)[0])
    pos = np.array([9, 6, SENT], np.int32)
    jdec = jax.jit(jm.decode_step_paged)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, size=(3, 1)).astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(bt),
                      jnp.asarray(pos))
        if port:
            tl, tc = tm.decode_step_paged(tp, _t(tok), tc, _t(bt), _t(pos))
            assert tl.dtype == torch.bfloat16
        for lane in range(2):
            jout[lane].append(np.asarray(jl, np.float32)[lane])
            if port:
                tout[lane].append(_f32(tl, None)[lane])
        pos = np.where(pos == SENT, SENT, pos + 1).astype(np.int32)
    return np.stack([np.concatenate(s) for s in jout]), jc, \
        (np.stack([np.concatenate(s) for s in tout]) if port else None), tc


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [JAMBA, VISION])
def test_paged_decode_matches_reference(arch, pool):
    """jamba's "state" lanes and vision's "memory" lanes through
    write_prefill into a pool of ``pool`` type, then decode_step_paged:
    the active lanes' logits of every step by the twin rule over the
    stream (the twin: fp32 parameters over an fp32 pool), and every pool
    plane in the reference's type."""
    jm, jp, jp32, tm, tp = _pair(arch)
    dt = getattr(torch, pool)
    ref, jc, port, tc = _paged_streams(jm, jp, tm, tp, dt)
    twin, _, _, _ = _paged_streams(jm, jp32, tm, tp, torch.float32,
                                   twin=True, port=False)
    _twin_rule(port, ref, twin, jm.cfg.vocab, "paged stream")
    for kind, jcp, tcp in zip(jm.cfg.cache_kinds(), jc, tc):
        for k in jcp:
            assert _dtype_name(tcp[k]) == str(jcp[k].dtype), (kind, k)


# ------------------------------------------------------------ the engine
def _stream_logits(step, toks, stream, n):
    """Every step's last-position logits (f32, (B, n, V)) of a prefill of
    ``toks`` and n - 1 decode steps teacher-forced along ``stream``:
    ``step(x, i)`` runs the prefill (i None) or the decode at position i."""
    out = [step(toks, None)]
    for t in range(n - 1):
        out.append(step(stream[:, t:t + 1], toks.shape[1] + t))
    return np.stack([_f32(o, None)[:, -1] for o in out], 1)


def _reference_step(jm, params, B, cache_dtype):
    state = {"c": jm.init_cache(B, 32, dtype=cache_dtype)}
    pre, dec = jax.jit(jm.prefill), jax.jit(jm.decode_step)

    def step(x, i):
        if i is None:
            lg, state["c"] = pre(params, {"tokens": jnp.asarray(x)},
                                 state["c"])
        else:
            lg, state["c"] = dec(params, jnp.asarray(x), state["c"],
                                 jnp.int32(i))
        return np.asarray(lg, np.float32)
    return step


def _port_step(tm, params, B, cache_dtype):
    state = {"c": tm.init_cache(B, 32, dtype=cache_dtype, device="cpu")}

    def step(x, i):
        if i is None:
            lg, state["c"] = tm.prefill(params, {"tokens": _t(x)},
                                        state["c"])
        else:
            lg, state["c"] = tm.decode_step(params, _t(x), state["c"], i)
        return lg
    return step


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_engine_on_recurrent_state(arch, cache):
    """ServeEngine on the bf16 model over a cache and pool of ``cache``
    type: run(prefill="monolithic") (write_prefill copying state and
    window into each slot), every stream equal to generate()'s bit for
    bit; run() chunked (the default: each slot's state carried through
    ``model_step``), overlap on == off bit for bit, and every stream equal
    to generate()'s or first different where generate's own top-2 gap is
    below the twin bound (the chunk's scan and conv sum in another order
    than prefill and decode, and bf16 rounds the difference);
    speculative runs still refused.  generate of two prompts against the
    reference's engine: the step logits teacher-forced along the
    reference's stream by the twin rule over the stream, the streams by
    the gap rule at that bound."""
    jm, jp, jp32, tm, tp = _pair(arch)
    cfg = jm.cfg
    dt = getattr(torch, cache)
    jdt = jnp.float32 if cache == "float32" else BF
    eng = ServeEngine(tm, tp, max_len=32, cache_dtype=dt, device="cpu")
    rng = np.random.default_rng(41)
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), k)
            for n, k in [(3, 5), (7, 4), (5, 6), (9, 3)]]
    gens = [eng.generate(t[None], n) for t, n in reqs]
    res = eng.run(reqs, page_size=4, max_slots=2, prefill="monolithic")
    assert res["stats"].mode == "monolithic"
    for i, (out, want) in enumerate(zip(res["outputs"], gens)):
        np.testing.assert_array_equal(out, want["tokens"][0], err_msg=str(i))
    with pytest.raises(ValueError):
        eng.run(reqs, page_size=4, max_slots=2, speculative=True)
    n = 6
    toks = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    want = JEngine(jm, jp, max_len=32, attn_impl="ref",
                   cache_dtype=jdt).generate(toks, n)["tokens"]
    got = eng.generate(toks, n)["tokens"]
    ref = _stream_logits(_reference_step(jm, jp, 2, jdt), toks, want, n)
    bound = _twin_rule(
        _stream_logits(_port_step(tm, tp, 2, dt), toks, want, n), ref,
        _stream_logits(_reference_step(jm, jp32, 2, jnp.float32), toks,
                       want, n), cfg.vocab, "stream")
    np.testing.assert_array_equal(ref.argmax(-1), want)
    diff = np.argwhere(got != want)
    if diff.size:
        t = int(diff[:, 1].min())
        for b in np.unique(diff[diff[:, 1] == t][:, 0]):
            top = np.sort(ref[b, t])
            assert top[-1] - top[-2] < bound, (b, t, top[-2:])
    chunked = [eng.run(reqs, page_size=4, max_slots=2, **kw)
               for kw in (dict(), dict(overlap=False))]
    assert chunked[0]["stats"].mode == "chunked"
    for i, (a, b, g) in enumerate(zip(chunked[0]["outputs"],
                                      chunked[1]["outputs"], gens)):
        np.testing.assert_array_equal(a, b, err_msg=f"overlap {i}")
        bad = np.flatnonzero(a != g["tokens"][0])
        if bad.size:
            assert g["top2_gap"][bad[0], 0] < bound, (i, int(bad[0]))


# ------------------------------------------------------------ the stores
def _packed_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _packed_leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _packed_leaves(v, path + (i,))
    elif isinstance(tree, PackedWeight):
        yield path, tree


def _policy(graph, seed=0):
    rng = np.random.default_rng(seed)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 6, 8, 16], size=l.n_groups
                                ).astype(np.float32) for l in graph.layers}
    return JPolicy(JMode.QUANT, wbits, {}), QuantPolicy(QuantMode.QUANT,
                                                        wbits, {})


def _to_reference_store(tree, twin=False):
    """The reference's tree of the port's store: every PackedWeight's parts
    as they are (with ``twin``, out_dtype float32 and the bf16 ``full``
    bucket upcast: the same weights in fp32), every other leaf its fp32
    upcast under ``twin``."""
    from repro.kernels.pack import PackedWeight as JPacked
    if isinstance(tree, dict):
        return {k: _to_reference_store(v, twin) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_reference_store(v, twin) for v in tree)
    if isinstance(tree, PackedWeight):
        parts = tuple(tuple(jnp.asarray(tensor_to_numpy(x)) for x in part)
                      for part in tree.parts)
        if twin:
            parts = tuple(tuple(x.astype(jnp.float32) if x.dtype == BF
                                else x for x in part) for part in parts)
        return JPacked(parts=parts, k=tree.k, n=tree.n,
                       buckets=tree.buckets,
                       out_dtype="float32" if twin else tree.out_dtype)
    a = jnp.asarray(tensor_to_numpy(tree))
    return a.astype(jnp.float32) if twin and a.dtype == BF else a


# the site of each family that the reference packs eagerly (its whole
# store op by op takes ~50-300 s a smoke model): an SSM projection,
# jamba's expert stack, musicgen's attention and vision's cross-attention
PACK_SITES = {MAMBA: ("p0.w_xz",), JAMBA: ("p1.wg",), AUDIO: ("p0.wq",),
              VISION: ("p4.wk",)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_packed_and_int8_stores_match_reference(arch):
    """The packed store of the bf16 parameters under a policy over every
    bucket: every PackedWeight with ``out_dtype`` bfloat16, and at
    PACK_SITES every part bit for bit the reference's eager
    ``quant_pack_sub8`` of the same weight and bits; the reference's
    forward on that store against the port's by the twin rule (the twin:
    the same store upcast).  The uniform int8 store: every ``q`` bit for
    bit, ``s`` to fp32 rounding, dtypes the reference's."""
    from repro.quant.apply import _get_path
    from repro.quant.linear_quant import quant_pack_sub8 as jpack_sub8
    jm, jp, jp32, tm, tp = _pair(arch)
    cfg = jm.cfg
    jg, tg = jm.graph(seq_len=4, batch=2), tm.graph(seq_len=4, batch=2)
    jpol, tpol = _policy(jg)
    tpk = apply_policy_packed(tp, tg, tpol)
    stores = [w for _, w in _packed_leaves(tpk)]
    assert len(stores) == len(tg.layers)
    assert all(w.out_dtype == "bfloat16" for w in stores)
    for layer in jg.layers:
        if layer.name not in PACK_SITES[arch]:
            continue
        with jax.disable_jit():
            want = jpack_sub8(_get_path(jp, layer.param_path),
                              jpol.expand_weight_bits(layer))
        got = _get_path(tpk, layer.param_path)
        assert got.buckets == want.buckets, layer.name
        for tpart, jpart in zip(got.parts, want.parts):
            for x, y in zip(tpart, jpart):
                np.testing.assert_array_equal(tensor_to_numpy(x),
                                              np.asarray(y),
                                              err_msg=layer.name)
    x = _model_in(cfg, _inputs(cfg, 2, 10, seed=4), 0, 10)
    jl, _ = jax.jit(jm.apply)(_to_reference_store(tpk), _j(x))
    jl32, _ = jax.jit(jm.apply)(_to_reference_store(tpk, twin=True),
                                _j(x, twin=True))
    tl, _ = tm.apply(tpk, _tt(x))
    assert tl.dtype == torch.bfloat16
    _twin_rule(tl, jl, jl32, cfg.vocab, "packed forward")
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(  # noqa: E731
        t, is_leaf=lambda v: isinstance(v, torch.Tensor))[0]
    jl_, tl_ = flat(jq), flat(tq)
    assert [jax.tree_util.keystr(p) for p, _ in jl_] == \
        [jax.tree_util.keystr(p) for p, _ in tl_]
    for (path, a), (_, b) in zip(jl_, tl_):
        name = jax.tree_util.keystr(path)
        assert _dtype_name(b) == str(a.dtype), name
        if name.endswith("['q']"):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        elif name.endswith("['s']"):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       **INT8_SCALE_TOL)


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_grads_match_reference(arch):
    """value_and_grad of LM.loss on the bf16 parameters: bf16 gradients
    within BF16_TWIN_FACTOR x the reference's distance from its fp32 twin
    (max abs over every leaf), the same bits on a second call."""
    jm, jp, jp32, tm, tp = _pair(arch)
    batch = _inputs(jm.cfg, 2, 12, seed=3)
    batch["labels"][0, -3:] = -1
    _, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, _j(batch))
    _, jg32 = jax.jit(jax.value_and_grad(jm.loss))(jp32, _j(batch,
                                                             twin=True))
    tb = _tt(batch)
    _, tg = value_and_grad(lambda p: tm.loss(p, tb), tp)
    _, tg2 = value_and_grad(lambda p: tm.loss(p, tb), tp)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tg))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tg),
                                                 tree_leaves(tg2)))
    T = [np.asarray(a, np.float32)
         for a in jax.tree.leaves(params_to_numpy(tg))]
    J = [np.asarray(a, np.float32) for a in jax.tree.leaves(_np(jg))]
    Z = [np.asarray(a, np.float32) for a in jax.tree.leaves(_np(jg32))]
    assert len(T) == len(J) == len(Z)
    twin = max(float(np.abs(j - z).max()) for j, z in zip(J, Z))
    assert twin > 0
    got = max(float(np.abs(t - j).max()) for t, j in zip(T, J))
    assert got <= BF16_TWIN_FACTOR * twin, (got, twin)
