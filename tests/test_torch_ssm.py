"""The port's Mamba2 (SSD) block and the SSM families against the JAX
reference, on the CPU.

Seeded numpy inputs go through the reference's ``models/ssm.py`` and the
port's, and the reference's smoke models (mamba2-smoke, jamba-smoke)
cross over with ``interop.params_from_numpy``.  Tolerances:

* the block's pieces and the models' logits and losses: rtol = atol =
  1e-4 (both sides compute in f32 and differ in summation order);
* gradients: every leaf within ``GRAD_TOL``'s rtol 1e-4
  (tests/test_torch_train.py) of the reference's as a vector, plus twice
  the reference's own f32 error on that leaf.  The SSD's backward sums
  terms of opposite sign (each ``l_cum`` enters ``rel`` twice), and on
  these smoke models the reference's f32 gradients themselves lie
  farther than ``GRAD_TOL`` elementwise from an evaluation with the SSD
  blocks in fp64: an elementwise comparison (atol 1e-5) is below the f32
  noise of both packages, while the MoE and attention families'
  gradients, better conditioned, are held to it elementwise
  (test_torch_moe.py, test_torch_train.py);
* prefill + decode against the full forward inside the port: max abs
  error < 1e-3 (tests/test_models.py:45-69);
* the uniform int8 store: ``q`` bit for bit, mean |lf - lq| / std(lf) <
  0.35 against the fp forward (tests/test_quant_serving.py:13-32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.api import SSMCfg as JSSMCfg  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.ddpg import tree_leaves  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels.pack import PackedWeight  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.api import SSMCfg  # noqa: E402
from repro_torch.quant.apply import apply_policy_packed  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_torch_train.py
SSM_ARCHS = ["mamba2-780m", "jamba-1.5-large-398b"]
# the block at smoke width: d_model 32, d_inner 64, 4 heads of 16, N 8
D_MODEL = 32
CFG = dict(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, cfg=None):
    cfg = cfg or JARCHS[arch].smoke
    jm = JLM(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, LM(cfg), params_from_numpy(_np(jp), "cpu")


def _block_params(seed=0):
    """Reference block parameters with every leaf drawn (the reference's
    init leaves dt_bias, A_log, conv_b and norm_w at 0 and D at 1)."""
    rng = np.random.default_rng(seed)
    p = _np(jssm.init_mamba_params(jax.random.PRNGKey(seed), D_MODEL,
                                   JSSMCfg(**CFG)))
    for k in ("dt_bias", "A_log", "conv_b", "norm_w", "D"):
        p[k] = (rng.normal(size=p[k].shape) * 0.5).astype(np.float32)
    return p


def _scan_inputs(S, seed=1):
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 3, 4, 5
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dt = (rng.random((B, S, H)) * 0.5 + 0.05).astype(np.float32)
    A = -(rng.random(H) + 0.5).astype(np.float32)
    return xh, Bm, Cm, dt, A


# ---------------------------------------------------------- the block
@pytest.mark.parametrize("S", [16, 13, 5])
def test_ssd_chunk_scan_matches_reference(S):
    """S a whole number of chunks (16 = 2 x 8), a padded tail (13) and a
    prompt shorter than one chunk (5): outputs and the final state (the
    state at the last real position, whatever the padding) at TOL; the
    same scan one step a chunk (the plain recurrence) agrees too."""
    ins = _scan_inputs(S)
    jy, js = jssm._ssd_chunk_scan(*map(jnp.asarray, ins), chunk=8)
    ty, ts = tssm._ssd_chunk_scan(*map(_t, ins), chunk=8)
    assert tuple(ty.shape) == ins[0].shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    ry, rs = tssm._ssd_chunk_scan(*map(_t, ins), chunk=1)
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), **TOL)
    np.testing.assert_allclose(ts.numpy(), rs.numpy(), **TOL)


def test_ssd_chunk_scan_gradients_are_finite():
    """rel is masked before exp: with strongly decaying steps, l_t - l_s
    above the diagonal is large and positive, and masking after exp would
    make the backward NaN (inf * 0)."""
    xh, Bm, Cm, dt, A = map(_t, _scan_inputs(16))
    dt = (dt * 200).requires_grad_(True)
    y, s = tssm._ssd_chunk_scan(xh, Bm, Cm, dt, A * 4, chunk=8)
    (g,) = torch.autograd.grad(y.sum() + s.sum(), dt)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("S", [1, 2, 3, 10])
def test_causal_conv_and_last_conv_window_match_reference(S):
    """Down to prompts shorter than d_conv - 1 = 3, which the window pads
    on the left."""
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    np.testing.assert_allclose(
        tssm._causal_conv(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))), **TOL)
    xz = rng.normal(size=(2, S, 24)).astype(np.float32)
    want = np.asarray(jssm._last_conv_window(jnp.asarray(xz),
                                             JSSMCfg(**CFG)))
    got = tssm._last_conv_window(_t(xz), SSMCfg(**CFG)).numpy()
    assert got.shape == (2, 3, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mamba_forward_and_decode_step_match_reference(cache_dtype):
    """mamba_forward over an 11-token prompt (a padded tail), then three
    mamba_decode_step calls from its cache, the conv window cast to the
    cache dtype first as the model's prefill casts it: outputs and every
    cache plane at TOL."""
    p = _block_params()
    jcfg, tcfg = JSSMCfg(**CFG), SSMCfg(**CFG)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, D_MODEL)).astype(np.float32)
    jy, jc = jssm.mamba_forward(jp, jnp.asarray(x), jcfg, D_MODEL)
    ty, tc = tssm.mamba_forward(tp, _t(x), tcfg, D_MODEL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in ("state", "conv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    jc = dict(jc, conv=jc["conv"].astype(getattr(jnp, cache_dtype)))
    tc = dict(tc, conv=tc["conv"].to(getattr(torch, cache_dtype)))
    for _ in range(3):
        x = rng.normal(size=(2, 1, D_MODEL)).astype(np.float32)
        jy, jc = jssm.mamba_decode_step(jp, jnp.asarray(x), jc, jcfg,
                                        D_MODEL)
        ty, tc = tssm.mamba_decode_step(tp, _t(x), tc, tcfg, D_MODEL)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for key in ("state", "conv"):
            assert tc[key].dtype == torch.float32
            np.testing.assert_allclose(tc[key].numpy(),
                                       np.asarray(jc[key]), **TOL)


def test_init_mamba_cache_matches_reference():
    jc = jssm.init_mamba_cache(3, D_MODEL, JSSMCfg(**CFG), jnp.bfloat16)
    tc = tssm.init_mamba_cache(3, D_MODEL, SSMCfg(**CFG), torch.bfloat16,
                               (2,), "cpu")
    for key in ("state", "conv"):
        assert tuple(tc[key].shape) == (2,) + jc[key].shape
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        assert not tc[key].any()


# ----------------------------------------------------------- the models
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_lm_apply_and_loss_match_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, 13)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, size=(2, 13)).astype(np.int32)
    jl, jaux = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.apply(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    batch = {"tokens": toks, "labels": labels}
    jloss = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tloss = tm.loss(tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_lm_grads_match_reference(arch):
    """value_and_grad of LM.loss against jax.value_and_grad, every leaf
    (module docstring): ||port - ref|| <= 1e-4 ||ref|| + 2 ||ref - exact||,
    where "exact" is the port's evaluation on fp64 parameters (its SSD
    blocks and norms then run in fp64), itself within 1e-3 of the
    reference's f32 gradient; remat True and "dots" give the same bits as False."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 12)),
             "labels": rng.integers(0, cfg.vocab, size=(2, 12))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][0, -3:] = -1
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: _t(v) for k, v in batch.items()}
    got = {r: value_and_grad(lambda p: tm.loss(p, tb, remat=r), tp)
           for r in (False, True, "dots")}
    tl, tg = got[False]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    p64 = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a, np.float64)), _np(jp))
    _, eg = value_and_grad(lambda p: tm.loss(p, tb), p64)
    tleaves = [np.asarray(a) for a in jax.tree.leaves(params_to_numpy(tg))]
    eleaves = [np.asarray(a) for a in jax.tree.leaves(params_to_numpy(eg))]
    jleaves = jax.tree.leaves(_np(jg))
    assert len(tleaves) == len(jleaves) == len(eleaves)
    for i, (t, j, e) in enumerate(zip(tleaves, jleaves, eleaves)):
        ref_err = np.linalg.norm(j - e)
        assert ref_err <= 1e-3 * np.linalg.norm(e), (i, ref_err)
        assert np.linalg.norm(t - j) <= \
            GRAD_TOL["rtol"] * np.linalg.norm(j) + 2 * ref_err, i
    assert sum(float(np.abs(a).sum()) for a in tleaves) > 0
    for r in (True, "dots"):
        assert torch.equal(got[r][0], tl)
        for a, b in zip(tree_leaves(got[r][1]), tree_leaves(tg)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,cache_dtype,act", [
    ("mamba2-780m", "float32", None), ("mamba2-780m", "bfloat16", None),
    ("mamba2-780m", "float32", 6.0), ("jamba-1.5-large-398b", "float32",
                                      None),
    ("jamba-1.5-large-398b", "float32", 8.0)])
def test_prefill_decode_match_full_forward_and_reference(arch, cache_dtype,
                                                         act):
    """Mirrors tests/test_models.py:45-69 (prefill 8, decode to 12 against
    apply, < 1e-3) inside the port, and holds each step's logits and the
    recurrent state to the reference's at TOL, with and without
    activation QBNs (the block's one act-quant hook).  Over a bf16 cache the
    prefill's conv window is rounded to bf16 (within one bf16 ulp of the
    reference's: their f32 windows differ at f32 rounding, which can
    carry a value across a rounding boundary); both decoders then start
    from the reference's planes, and the conv plane holds every decoded
    entry in fp32, as the reference's decode returns it."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    B, S, Sp = 2, 12, 8
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    j_act = t_act = None
    if act is not None:
        j_act = jnp.full((cfg.n_repeat, len(cfg.pattern)), act, jnp.float32)
        t_act = np.full((cfg.n_repeat, len(cfg.pattern)), act, np.float32)
    full, _ = tm.apply(tp, {"tokens": _t(toks)}, act_bits=t_act)
    jc = jm.init_cache(B, S, dtype=getattr(jnp, cache_dtype))
    tc = tm.init_cache(B, S, dtype=getattr(torch, cache_dtype), device="cpu")
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :Sp])},
                                 jc, j_act)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :Sp]).long()}, tc, t_act,
                        attn_impl="cuda")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    states = [(jcp, tcp) for kind, jcp, tcp in
              zip(cfg.cache_kinds(), jc, tc) if kind == "state"]
    # one bf16 ulp (2^-7 relative at most)
    tol = TOL if cache_dtype == "float32" else dict(rtol=2.0 ** -7, atol=0)
    for jcp, tcp in states:
        assert tcp["conv"].dtype == getattr(torch, cache_dtype)
        want = np.asarray(jcp["conv"]).astype(np.float32)
        np.testing.assert_allclose(tcp["conv"].float().numpy(), want, **tol)
        tcp["conv"].copy_(_t(want))
        tcp["state"].copy_(_t(jcp["state"]))
    errs = [float((tl[:, 0] - full[:, Sp - 1]).abs().max())]
    jdec = jax.jit(jm.decode_step)
    for t in range(Sp, S):
        tok = toks[:, t:t + 1]
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.int32(t), j_act)
        tl, tc = tm.decode_step(tp, _t(tok).long(), tc, t, t_act,
                                attn_impl="cuda")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        errs.append(float((tl[:, 0] - full[:, t]).abs().max()))
    if cache_dtype == "float32":
        assert max(errs) < 1e-3, errs
    for kind, jcp, tcp in zip(cfg.cache_kinds(), jc, tc):
        if kind == "state":
            for key in ("state", "conv"):
                assert tcp[key].dtype == torch.float32
                np.testing.assert_allclose(tcp[key].numpy(),
                                           np.asarray(jcp[key]), **TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_int8_store_matches_reference_and_tracks_fp(arch):
    """Mirrors tests/test_quant_serving.py:13-32: every matmul leaf,
    mamba's w_xz / w_bc / w_dt / w_out included, becomes {"q", "s"} (q
    bit for bit the reference's); the forward on K2's plain version
    matches the reference's and stays within 0.35 of the fp logits."""
    jm, jp, tm, tp = _pair(arch)
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    for name in ("w_xz", "w_bc", "w_dt", "w_out"):
        leaf = tq["blocks"][0]["mamba"][name]
        assert leaf["q"].dtype == torch.int8
        np.testing.assert_array_equal(
            leaf["q"].numpy(), np.asarray(jq["blocks"][0]["mamba"][name]["q"]))
    assert isinstance(tq["blocks"][0]["mamba"]["conv_w"], torch.Tensor)
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, size=(2, 10))
    jl, _ = jax.jit(jm.apply)(jq, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.apply(tq, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    lf, _ = tm.apply(tp, {"tokens": _t(toks)})
    rel = float((lf - tl).abs().mean() / torch.clamp(lf.std(), min=1e-6))
    assert rel < 0.35, rel


def _jit_apply_policy_packed(params, graph, policy):
    """The reference's apply_policy_packed, each weight's quant_pack_sub8
    under one jax.jit (op by op it takes minutes on a CPU)."""
    from repro.quant.apply import _get_path, _set_path
    from repro.quant.linear_quant import quant_pack_sub8
    out = params
    for layer in graph.layers:
        bits = policy.expand_weight_bits(layer)
        pack = jax.jit(lambda w, b=bits: quant_pack_sub8(w, b))
        out = _set_path(out, layer.param_path,
                        pack(_get_path(params, layer.param_path)))
    return out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_graph_and_packed_store_match_reference(arch):
    """graph() emits the reference's sites (mamba's w_xz, w_bc, w_out with
    its MACs, numel and 4-long param paths), block_act_bits collapses
    them as the reference does, and the packed store of a policy over
    every bucket gives the reference's packed forward at TOL."""
    jm, jp, tm, tp = _pair(arch)
    key = lambda g: [(l.name, l.kind, l.c_in, l.c_out, l.macs, l.numel,
                      tuple(l.param_path), l.channel_axis, l.n_groups)
                     for l in g.layers]
    jg, tg = jm.graph(seq_len=4, batch=2), tm.graph(seq_len=4, batch=2)
    assert key(tg) == key(jg)
    assert ("blocks", 0, "mamba", "w_xz") in [tuple(l.param_path)
                                             for l in tg.layers]
    vals = [float(3 + i % 5) for i in range(len(jg.layers))]
    np.testing.assert_array_equal(tm.block_act_bits(tg, vals),
                                  np.asarray(jm.block_act_bits(jg, vals)))
    rng = np.random.default_rng(7)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 6, 8, 16], size=l.n_groups
                                ).astype(np.float32) for l in jg.layers}
    jpacked = _jit_apply_policy_packed(jp, jg, JPolicy(JMode.QUANT, wbits, {}))
    tpacked = apply_policy_packed(tp, tg, QuantPolicy(QuantMode.QUANT,
                                                      wbits, {}))
    assert isinstance(tpacked["blocks"][0]["mamba"]["w_xz"], PackedWeight)
    toks = rng.integers(0, jm.cfg.vocab, size=(2, 10)).astype(np.int32)
    jl, _ = jax.jit(jm.apply)(jpacked, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.apply(tpacked, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_interop_round_trips_nested_mamba_tree():
    """The nested "mamba" dicts cross both ways unchanged, in fp32 and
    in the packed store; the draft-prefix view slices them leaf by
    leaf."""
    jm, jp, tm, tp = _pair("jamba-1.5-large-398b")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jp))):
        np.testing.assert_array_equal(a, b)
    jg = jm.graph(seq_len=1, batch=1)
    wbits = {l.name: np.full(l.n_groups, 4.0, np.float32) for l in jg.layers}
    jpacked = _jit_apply_policy_packed(jp, jg, JPolicy(JMode.QUANT, wbits, {}))
    carried = params_from_numpy(_np(jpacked), "cpu")
    pw = carried["blocks"][0]["mamba"]["w_xz"]
    jw = jpacked["blocks"][0]["mamba"]["w_xz"]
    assert isinstance(pw, PackedWeight) and pw.buckets == jw.buckets
    np.testing.assert_array_equal(pw.parts[0][0].numpy(),
                                  np.asarray(jw.parts[0][0]))
    draft = tm.draft_prefix_params(tp, 1)
    for p_idx in range(len(tm.cfg.pattern)):
        for name, leaf in draft["blocks"][p_idx].get("mamba", {}).items():
            full = tp["blocks"][p_idx]["mamba"][name]
            assert leaf.shape[0] == 1 and torch.equal(leaf, full[:1])
