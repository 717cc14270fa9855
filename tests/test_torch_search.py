"""The AutoQ search of the PyTorch port against the JAX reference, on the CPU.

Both packages get the same numpy inputs; the reference's CNN / LM params
and DDPG states cross over with ``interop.params_from_numpy``.  The port's
evaluators run the kernel wrappers B5 (fake-quant) and B6 (bit-plane
product), whose plain versions serve CPU tensors.  Tolerances:

* binarization: the reference test's rtol 1e-5 / atol 1e-6
  (test_binarize.py:58): means of |r| sum in another order;
* CNN logits, one Adam step of the substrate, BINARIZE logits: 1e-4 (f32
  in both, summation order only), with activations at 32 bits;
* QUANT weights: bitwise (exactly rounded f32 steps, as fake_quant);
* accuracies with quantized activations: the gap rule -- an image (or
  token) may be classified differently only where the reference's top-2
  logit gap is below the logits tolerance, since one rounding flip of a
  quantized activation moves it a whole step;
* DDPG: actor outputs 1e-5, one update's new state rtol 1e-4;
* agent: policies bit for bit, unless a pre-round action lies within 1e-4
  of a .5 boundary, where the rounding may go either way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import ddpg as jddpg  # noqa: E402
from repro.core import evaluate as jeval  # noqa: E402
from repro.data import SyntheticImages as JImages  # noqa: E402
from repro.data import TokenStream as JTokens  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.quant import binarize as jbin  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import evaluate as teval  # noqa: E402
from repro_torch.data import SyntheticImages, TokenStream  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import binary_matmul as tbm  # noqa: E402
from repro_torch.kernels import fake_quant as tfq  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.quant import binarize as tbin  # noqa: E402
from repro_torch.quant.apply import get_path  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402

BIN_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(name="t", img_size=8, channels=(8, 16), pool_after=(0,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(got, want, **tol):
    gl = tddpg.tree_leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


@pytest.fixture(scope="module")
def cnn():
    jm = jcnn.CNN(jcnn.CNNConfig(**CFG))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tcnn.CNN(tcnn.CNNConfig(**CFG))
    val = JImages(img_size=8).batch(999, 64)
    assert all(np.array_equal(a, b) for a, b in zip(
        val.values(), SyntheticImages(img_size=8).batch(999, 64).values()))
    return dict(jm=jm, jp=jp, tm=tm, tp=params_from_numpy(_np(jp), "cpu"),
                val=val, jg=jm.graph(), tg=tm.graph())


def _policies(graph, seed, mode, act):
    """A seeded kernel-wise policy in both packages: weight QBNs 0..8 and 32
    (so pruned and pass-through channels occur), activation QBN ``act``
    (None: drawn from 3..8)."""
    rng = np.random.default_rng(seed)
    wb = {l.name: rng.choice([0, 1, 2, 3, 4, 5, 6, 8, 32],
                             size=l.n_groups).astype(np.float32)
          for l in graph.layers}
    ab = {l.name: float(act if act is not None else rng.integers(3, 9))
          for l in graph.layers}
    tmode = QuantMode.QUANT if mode == JMode.QUANT else QuantMode.BINARIZE
    return JPolicy(mode, wb, ab), QuantPolicy(tmode, wb, ab)


def _gap_rule(t_logits, j_logits, tol=TOL["atol"]):
    """Predictions may differ only where the reference's top-2 gap < tol."""
    j = np.asarray(j_logits, np.float64).reshape(-1, j_logits.shape[-1])
    t = t_logits.double().numpy().reshape(j.shape)
    top2 = np.sort(j, axis=-1)[:, -2:]
    bad = np.flatnonzero(t.argmax(-1) != j.argmax(-1))
    assert np.all(top2[bad, 1] - top2[bad, 0] < tol), bad
    return len(bad)


# ----------------------------------------------------------- binarization
@pytest.mark.parametrize("planes", [1, 2, 4, 8])
def test_binarize_residual_matches_reference(planes):
    rng = np.random.default_rng(planes)
    w = rng.normal(size=(3, 3, 8, 12)).astype(np.float32)
    jB, ja = jbin.binarize_residual(jnp.asarray(w), planes, axis=3)
    tB, ta = tbin.binarize_residual(_t(w), planes, axis=3)
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tbin.reconstruct(tB, ta).numpy(),
                               np.asarray(jbin.reconstruct(jB, ja)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape,axis", [((24, 6), 1), ((3, 3, 4, 10), 3),
                                        ((5, 16, 7), -1)])
def test_fake_binarize_and_planes_match_reference(shape, axis):
    """fake_binarize_per_channel == the reference; the plane form
    reconstructs it for every BBN 0..8 and a pass-through 32."""
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(size=shape).astype(np.float32)
    n = shape[axis]
    bits = np.resize(np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 32], np.float32), n)
    want = np.asarray(jbin.fake_binarize_per_channel(jnp.asarray(w), bits,
                                                     axis=axis))
    got = tbin.fake_binarize_per_channel(_t(w), bits, axis=axis)
    np.testing.assert_allclose(got.numpy(), want, **BIN_TOL)
    w2 = np.moveaxis(w, axis, -1).reshape(-1, n)
    planes, alpha = tbin.fake_binarize_planes(_t(w2), bits)
    assert planes.dtype == torch.int8 and tuple(planes.shape) == \
        (tbin.MAX_PLANES,) + w2.shape
    assert set(np.unique(planes.numpy())) <= {-1, 1}
    dense = tbin.fake_binarize_per_channel(_t(w2), bits, axis=1)
    np.testing.assert_allclose(tbin.reconstruct(planes, alpha[:, None, :])
                               .numpy(), dense.numpy(), **BIN_TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(
        jbin.fake_binarize_per_channel(jnp.asarray(w2), bits, axis=1)),
        **BIN_TOL)


@pytest.mark.parametrize("kind,shape,seed", [("conv", (3, 3, 64, 64), 28),
                                             ("conv", (3, 3, 128, 128), 12),
                                             ("dense", (96, 10), 0)])
def test_plane_form_sums_to_dense_binarize_bitwise(kind, shape, seed):
    """The evaluator's plane form, summed plane by plane in order (as B6
    folds it), is the dense fake-binarized weight bit for bit, in im2col
    row order for a conv.  The seeds are ones where alphas taken over the
    im2col rows instead of the HWIO weight flip a residual's sign."""
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    w = _t(rng.normal(size=shape).astype(np.float32))
    bits = np.resize(np.arange(9, dtype=np.float32), shape[-1])
    layer = SimpleNamespace(name=kind, kind=kind, channel_axis=-1)
    node = teval._plane_form({"w": w, "b": torch.zeros(shape[-1])}, "w", w,
                             layer, _t(bits))
    assert set(node) == {"planes", "alpha", "b"}
    folded = torch.zeros(node["planes"].shape[1:])
    for p in range(tbin.MAX_PLANES):
        folded = folded + node["alpha"][p] * node["planes"][p].float()
    dense = tbin.fake_binarize_per_channel(w, bits)
    want = tcnn.conv_rows(dense) if kind == "conv" else dense
    assert torch.equal(folded, want)


# ------------------------------------------------------------------ CNN
def test_cnn_logits_and_adam_step_match_reference(cnn):
    """Logits at 1e-4 (activations off); one Adam step of the substrate
    (the example's preparation, lr 2e-3) gives params at 1e-4."""
    batch = SyntheticImages(img_size=8).batch(3, 16)
    jl = cnn["jm"].apply(cnn["jp"], jnp.asarray(batch["x"]))
    tl = cnn["tm"].apply(cnn["tp"], _t(batch["x"]))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(p, b):
        loss, g = jax.value_and_grad(cnn["jm"].loss)(p, b)
        return (loss,) + jddpg.adam_update(p, g, jddpg.adam_init(p), 2e-3)
    jloss, jnew, jopt = step(cnn["jp"], jb)
    tp = tddpg.tree_map(lambda p: p.clone().requires_grad_(True), cnn["tp"])
    loss = cnn["tm"].loss(tp, {k: _t(v) for k, v in batch.items()})
    grads = tddpg.tree_unflatten(tp, torch.autograd.grad(
        loss, tddpg.tree_leaves(tp)))
    tnew, topt = tddpg.adam_update(tddpg.tree_map(torch.detach, tp), grads,
                                   tddpg.adam_init(cnn["tp"]), 2e-3)
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    _close_trees(tnew, jnew, **TOL)
    _close_trees(topt["m"], jopt["m"], **TOL)
    assert int(topt["t"]) == int(jopt["t"]) == 1


def test_cnn_graph_matches_reference(cnn):
    big_j, big_t = jcnn.CNN(jcnn.CIF10).graph(), tcnn.CNN(tcnn.CIF10).graph()
    for jg, tg in ((cnn["jg"], cnn["tg"]), (big_j, big_t)):
        assert [(l.name, l.c_in, l.c_out, l.macs, l.numel, l.param_path,
                 l.channel_axis, l.n_groups) for l in tg.layers] == \
            [(l.name, l.c_in, l.c_out, l.macs, l.numel, l.param_path,
              l.channel_axis, l.n_groups) for l in jg.layers]
    assert sum(l.n_groups for l in big_t.layers) == 586


# ------------------------------------------------------------ evaluators
def test_quantize_params_bitwise_and_counts_no_launch(cnn):
    """QUANT: every weight == the reference's fake_quant_per_channel, bit
    for bit, through the B5 wrapper (plain version on CPU tensors)."""
    jpol, tpol = _policies(cnn["jg"], 1, JMode.QUANT, 8.0)
    jwb, _ = jeval._expand_bits(jpol, cnn["jg"])
    want = _np(jeval._quantize_params(cnn["jp"], cnn["jg"], jwb,
                                      JMode.QUANT))
    before = tfq.COUNT.launches
    wb, ab = teval.upload_bits(tpol, cnn["tg"], torch.device("cpu"))
    got = teval._quantize_params(cnn["tp"], cnn["tg"], wb, QuantMode.QUANT)
    assert tfq.COUNT.launches == before
    for l in cnn["tg"].layers:
        name = l.param_path[0]
        np.testing.assert_array_equal(got[name]["w"].numpy(),
                                      want[name]["w"])
    np.testing.assert_array_equal(ab.numpy(), [8.0] * len(cnn["tg"].layers))


@pytest.mark.parametrize("mode,act,seed", [(JMode.QUANT, None, 2),
                                           (JMode.BINARIZE, None, 3),
                                           (JMode.QUANT, 32.0, 4)])
def test_cnn_evaluator_accuracy_matches_reference(cnn, mode, act, seed):
    """Accuracy of a fixed policy equals the reference's, up to images the
    gap rule allows; the port's logits come from the same quantized
    params the evaluator builds (plane form for BINARIZE)."""
    jpol, tpol = _policies(cnn["jg"], seed, mode, act)
    tmode = tpol.mode
    jev = jcore.make_cnn_evaluator(cnn["jm"], cnn["jp"], cnn["jg"],
                                   cnn["val"], mode=mode)
    tev = tcore.make_cnn_evaluator(cnn["tm"], cnn["tp"], cnn["tg"],
                                   cnn["val"], mode=tmode)
    jacc, tacc = jev(jpol), tev(tpol)
    jwb, jab = jeval._expand_bits(jpol, cnn["jg"])
    jq = jeval._quantize_params(cnn["jp"], cnn["jg"], jwb, mode)
    names = [l.name for l in cnn["jg"].layers]
    jl = cnn["jm"].apply(jq, jnp.asarray(cnn["val"]["x"]),
                         act_bits=dict(zip(names, jab)))
    wb, ab = teval.upload_bits(tpol, cnn["tg"], torch.device("cpu"))
    tq = teval._quantize_params(cnn["tp"], cnn["tg"], wb, tmode,
                                planes=tmode == QuantMode.BINARIZE)
    if tmode == QuantMode.BINARIZE:
        assert "planes" in tq["conv0"] and "w" not in tq["conv0"]
    tl = cnn["tm"].apply(tq, _t(cnn["val"]["x"]),
                         act_bits=dict(zip(names, ab)))
    n_bad = _gap_rule(tl, jl)
    assert abs(tacc - jacc) <= 100.0 * n_bad / len(cnn["val"]["y"]) + 1e-9
    if act == 32.0:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("shape", [
    (4, tcnn.CIF10_TINY.img_size, tcnn.CIF10_TINY.img_size,
     tcnn.CIF10_TINY.in_channels),
    (2, tcnn.CIF10.img_size, tcnn.CIF10.img_size, tcnn.CIF10.in_channels),
    (3, 5, 7, 6),
])
def test_im2col_rows_equal_unfold(shape):
    """The one-copy im2col of the plane-form convs == F.unfold's rows
    transposed, bit for bit, in (c, kh, kw) order."""
    import torch.nn.functional as F
    B, H, W, C = shape
    x = torch.from_numpy(np.random.default_rng(sum(shape)).normal(
        size=shape).astype(np.float32))
    want = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1).transpose(1, 2) \
        .reshape(B * H * W, C * 9)
    got = tcnn.im2col(x, 3)
    assert got.is_contiguous() and torch.equal(got, want)


def test_binarized_logits_match_dense_reference(cnn):
    """BINARIZE with activations at 32 bits: the plane-form forward (B6's
    plain version for every conv and the fc) == the reference's dense
    fake-binarized forward, logits at 1e-4."""
    jpol, tpol = _policies(cnn["jg"], 5, JMode.BINARIZE, 32.0)
    jwb, _ = jeval._expand_bits(jpol, cnn["jg"])
    jq = jeval._quantize_params(cnn["jp"], cnn["jg"], jwb, JMode.BINARIZE)
    jl = cnn["jm"].apply(jq, jnp.asarray(cnn["val"]["x"]))
    wb, _ = teval.upload_bits(tpol, cnn["tg"], torch.device("cpu"))
    before = tbm.COUNT.launches
    tq = teval._quantize_params(cnn["tp"], cnn["tg"], wb,
                                QuantMode.BINARIZE, planes=True)
    tl = cnn["tm"].apply(tq, _t(cnn["val"]["x"]))
    assert tbm.COUNT.launches == before
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_evaluator_full_bits_matches_unquantized(cnn):
    """The 32-bit uniform policy's accuracy is the unquantized accuracy."""
    ev = tcore.make_cnn_evaluator(cnn["tm"], cnn["tp"], cnn["tg"], cnn["val"])
    raw = float(cnn["tm"].accuracy(cnn["tp"], {k: _t(v) for k, v in
                                               cnn["val"].items()})) * 100
    assert abs(raw - ev(QuantPolicy.uniform(cnn["tg"], 32.0))) < 1e-3


@pytest.fixture(scope="module")
def lm():
    arch = "phi4-mini-3.8b"
    jm, tm = JLM(JARCHS[arch].smoke), LM(ARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    vocab = ARCHS[arch].smoke.vocab
    val = JTokens(vocab=vocab).batch(0, 4, 16)
    assert all(np.array_equal(a, b) for a, b in zip(
        val.values(), TokenStream(vocab=vocab).batch(0, 4, 16).values()))
    return (jm, jp, tm, params_from_numpy(_np(jp), "cpu"), val,
            jm.graph(seq_len=16, batch=4, max_groups=8),
            tm.graph(seq_len=16, batch=4, max_groups=8))


@pytest.mark.parametrize("mode", [JMode.QUANT, JMode.BINARIZE])
def test_lm_evaluator_matches_reference(lm, mode):
    """make_lm_evaluator on phi4-mini-3.8b smoke, a fixed policy with
    activation QBNs: accuracy under the gap rule; QUANT weights bitwise."""
    jm, jp, tm, tp, val, jg, tg = lm
    jpol, tpol = _policies(jg, 6, mode, None)
    jacc = jcore.make_lm_evaluator(jm, jp, jg, val, mode=mode)(jpol)
    tacc = tcore.make_lm_evaluator(tm, tp, tg, val, mode=tpol.mode)(tpol)

    @jax.jit
    def quantized_logits(wb, ab):
        q = jeval._quantize_params(jp, jg, wb, mode)
        return q, jm.apply(q, {k: jnp.asarray(v) for k, v in val.items()},
                           act_bits=jm.block_act_bits(jg, ab))[0]
    jq, jl = quantized_logits(*jeval._expand_bits(jpol, jg))
    wb, _ = teval.upload_bits(tpol, tg, torch.device("cpu"))
    tq = teval._quantize_params(tp, tg, wb, tpol.mode)
    if mode == JMode.QUANT:
        for l in tg.layers:
            np.testing.assert_array_equal(
                get_path(tq, l.param_path).numpy(),
                np.asarray(get_path(jq, l.param_path)))
    tl = teval.lm_logits(tm, tq, tg, tpol, {"tokens": _t(val["tokens"])})
    assert float(teval.token_accuracy(tl, _t(val["labels"]))) == tacc
    n_bad = _gap_rule(tl, jl)
    assert abs(tacc - jacc) <= 100.0 * n_bad / val["labels"].size + 1e-6


# ------------------------------------------------------------------- DDPG
def _ddpg_pair(sd=17, ad=1, seed=0):
    cfg = dict(state_dim=sd, action_dim=ad, action_scale=8.0)
    jd = jddpg.DDPG(jddpg.DDPGConfig(**cfg), jax.random.PRNGKey(seed))
    td = tddpg.DDPG(tddpg.DDPGConfig(**cfg), seed, device="cpu")
    td.load_state(_np(jd.state))
    return jd, td


def test_ddpg_actor_and_update_match_reference():
    jd, td = _ddpg_pair(ad=2)
    rng = np.random.default_rng(0)
    s = rng.uniform(size=(5, 17)).astype(np.float32)
    want = jd._act(jd.state["actor"], jnp.asarray(s))
    got = tddpg.mlp_apply(td.state["actor"], _t(s), final_act=td._final)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for i in range(2):
        a_j = jd.act(s[i], 0.5, np.random.default_rng(i))
        a_t = td.act(s[i], 0.5, np.random.default_rng(i))
        np.testing.assert_allclose(a_t, a_j, rtol=1e-5, atol=1e-5)
    batch = {"s": s[:4], "a": rng.uniform(0, 8, size=(4, 2)),
             "r": rng.normal(size=4), "s2": s[1:], "done": [0, 0, 0, 1.0]}
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    for _ in range(2):
        mj, mt = jd.update(batch), td.update(batch)
        for k in mj:
            assert abs(mt[k] - mj[k]) <= 1e-4 * max(1.0, abs(mj[k])), k
    _close_trees(td.state, jd.state, rtol=1e-4, atol=1e-6)
    assert int(td.state["opt_a"]["t"]) == 2


def test_replay_buffer_sample_identical():
    jb, tb = jddpg.ReplayBuffer(3, 1, size=10), tddpg.ReplayBuffer(3, 1, 10)
    rng = np.random.default_rng(1)
    for i in range(13):
        tr = (rng.normal(size=3), [i], float(i), rng.normal(size=3), i % 2)
        jb.push(*tr)
        tb.push(*tr)
    assert len(jb) == len(tb) == 10
    a = jb.sample(np.random.default_rng(5), 6)
    b = tb.sample(np.random.default_rng(5), 6)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])


# -------------------------------------------------------------------- env
def test_env_transitions_match_reference(cnn):
    """make_state, apply_var_ordering, account_rdc and episode_reward are
    equal for fixed actions (activations at 32 bits: the logits agree to
    1e-4, so the accuracy is exact here)."""
    jev = jcore.make_cnn_evaluator(cnn["jm"], cnn["jp"], cnn["jg"],
                                   cnn["val"])
    tev = tcore.make_cnn_evaluator(cnn["tm"], cnn["tp"], cnn["tg"],
                                   cnn["val"])
    cfg = jcore.RewardCfg.accuracy_guaranteed()
    jenv = jcore.QuantEnv(cnn["jg"], cnn["jp"], jev, cfg)
    tenv = tcore.QuantEnv(cnn["tg"], cnn["tp"], tev,
                          tcore.RewardCfg.accuracy_guaranteed())
    for k in jenv.group_vars:
        np.testing.assert_array_equal(tenv.group_vars[k], jenv.group_vars[k])
    from repro.core.env import StepCtx as JCtx
    from repro_torch.core.env import StepCtx as TCtx
    jctx, tctx = JCtx(), TCtx()
    rng = np.random.default_rng(2)
    for t, (jl, tl) in enumerate(zip(cnn["jg"].layers, cnn["tg"].layers)):
        for gi in (0, tl.n_groups - 1):
            for act in (True, False):
                np.testing.assert_array_equal(
                    tenv.make_state(t, tl, gi, tctx, act),
                    jenv.make_state(t, jl, gi, jctx, act))
        raw = rng.integers(0, 9, size=tl.n_groups).astype(np.float32)
        wb = tenv.apply_var_ordering(tl, raw)
        np.testing.assert_array_equal(wb, jenv.apply_var_ordering(jl, raw))
        jenv.account_rdc(jl, jctx, wb, 5.0)
        tenv.account_rdc(tl, tctx, wb, 5.0)
        assert tctx.rdc == jctx.rdc
    jpol, tpol = _policies(cnn["jg"], 7, JMode.QUANT, 32.0)
    assert tenv.episode_reward(tpol) == jenv.episode_reward(jpol)


# ------------------------------------------------------------------ agent
def _agent_pair(cnn, relabel="min"):
    """Reference and port agents on the same graph with the reference's
    DDPG states carried over.  Both envs share one numpy evaluator, so the
    comparison isolates the agent (the evaluators are held above)."""
    def evaluate(policy):
        return float(40.0 + policy.avg_weight_bits(cnn["jg"]) +
                     policy.avg_act_bits(cnn["jg"]))
    jenv = jcore.QuantEnv(cnn["jg"], cnn["jp"], evaluate,
                          jcore.RewardCfg.accuracy_guaranteed())
    tenv = tcore.QuantEnv(cnn["tg"], cnn["tp"], evaluate,
                          tcore.RewardCfg.accuracy_guaranteed())
    ja = jcore.HierarchicalAgent(jenv, seed=3, relabel=relabel,
                                 updates_per_episode=2)
    ta = tcore.HierarchicalAgent(tenv, seed=3, relabel=relabel,
                                 updates_per_episode=2, device="cpu")
    ta.hlc.load_state(_np(ja.hlc.state))
    ta.llc.load_state(_np(ja.llc.state))
    return ja, ta


def _record(agent):
    """Record every pre-round action the agent's controllers emit."""
    log = []
    for name in ("hlc", "llc"):
        ctl = getattr(agent, name)

        def act(s, noise, rng, _act=ctl.act, _name=name):
            a = _act(s, noise, rng)
            log.append((_name, np.array(a)))
            return a
        ctl.act = act
    return log


def _first_divergence(jlog, tlog, max_bits=8.0):
    """Index of the first LLC action whose rounding differs; asserts that
    every action before it agrees to 1e-4 and that the diverging one lies
    within 1e-4 of a .5 boundary.  None if none diverges."""
    assert len(jlog) == len(tlog)
    for i, ((jn, ja), (tn, ta)) in enumerate(zip(jlog, tlog)):
        assert jn == tn
        if jn == "llc":
            jr = np.clip(np.round(ja), 0, max_bits)
            tr = np.clip(np.round(ta), 0, max_bits)
            if not np.array_equal(jr, tr):
                frac = np.abs(np.abs(ja - np.floor(ja)) - 0.5)
                assert np.all(frac[jr != tr] < 1e-4), (i, ja, ta)
                return i
        np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-4)
    return None


@pytest.mark.parametrize("relabel", ["min", "ml"])
def test_agent_episodes_match_reference(cnn, relabel):
    """Two episodes (the second trains the LLC) with carried states and
    the same seed: the reference's policies bit for bit and its trained
    states at 1e-4, unless a rounding diverges at a .5 boundary."""
    ja, ta = _agent_pair(cnn, relabel)
    jlog, tlog = _record(ja), _record(ta)
    for ep in range(2):
        jl, jp = ja.run_episode(noise=0.5)
        tl, tp = ta.run_episode(noise=0.5)
        if _first_divergence(jlog, tlog) is not None:
            return
        for name in jp.weight_bits:
            np.testing.assert_array_equal(tp.weight_bits[name],
                                          jp.weight_bits[name])
            assert tp.act_bits[name] == jp.act_bits[name]
        assert tl.reward == jl.reward and tl.acc == jl.acc
    assert len(ta.llc_buf) == len(ja.llc_buf) == 74
    np.testing.assert_allclose(ta.hlc_buf.a, ja.hlc_buf.a, **TOL)  # goals
    _close_trees(ta.llc.state, ja.llc.state, **TOL)
    _close_trees(ta.hlc.state, ja.hlc.state, **TOL)


# ---------------------------------- the port's own search (test_env_search)
def _env(cnn, reward=None, mode=QuantMode.QUANT, bounder=False):
    ev = tcore.make_cnn_evaluator(cnn["tm"], cnn["tp"], cnn["tg"],
                                  cnn["val"], mode=mode)
    b = tcore.LayerBounder(cnn["tg"], 5.0, 5.0) if bounder else None
    return tcore.QuantEnv(cnn["tg"], cnn["tp"], ev,
                          reward or tcore.RewardCfg.accuracy_guaranteed(),
                          mode=mode, bounder=b)


def test_hierarchical_episode_produces_valid_policy(cnn):
    env = _env(cnn)
    log, policy = tcore.HierarchicalAgent(env, seed=0, device="cpu") \
        .run_episode(noise=0.5)
    for layer in env.graph.layers:
        wb = policy.weight_bits[layer.name]
        assert wb.shape == (layer.n_groups,)
        assert ((wb >= 0) & (wb <= 32)).all()
        assert 0 <= policy.act_bits[layer.name] <= 32
    assert np.isfinite(log.reward)


@pytest.mark.parametrize("mode", [QuantMode.QUANT, QuantMode.BINARIZE])
def test_search_tracks_best(cnn, mode):
    agent = tcore.HierarchicalAgent(_env(cnn, mode=mode), seed=0,
                                    updates_per_episode=2, device="cpu")
    res = tcore.run_search(agent, n_explore=2, n_exploit=2)
    assert len(res.history) == 4
    assert res.best_log.reward == max(h.reward for h in res.history)
    assert res.best_policy is not None and res.best_policy.mode == mode
    assert all(np.isfinite(h.acc) for h in res.history)


@pytest.mark.parametrize("granularity", ["layer", "channel"])
def test_flat_agents_run(cnn, granularity):
    agent = tcore.FlatAgent(_env(cnn), granularity=granularity,
                            updates_per_episode=2, device="cpu")
    res = tcore.run_search(agent, n_explore=1, n_exploit=1)
    assert len(res.history) == 2


def test_resource_constrained_respects_budget_direction(cnn):
    env = _env(cnn, reward=tcore.RewardCfg.resource_constrained(),
               bounder=True)
    agent = tcore.HierarchicalAgent(env, seed=0, updates_per_episode=2,
                                    device="cpu")
    log, _ = agent.run_episode(noise=0.3)
    assert log.avg_wbits <= 16.0


@pytest.mark.parametrize("relabel", ["min", "ml"])
def test_hiro_relabel_modes(cnn, relabel):
    agent = tcore.HierarchicalAgent(_env(cnn), seed=0, relabel=relabel,
                                    updates_per_episode=1, device="cpu")
    log, _ = agent.run_episode(noise=0.5)
    assert np.isfinite(log.reward)
