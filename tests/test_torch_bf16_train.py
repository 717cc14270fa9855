"""bf16 parameters through B5 and B6, QAT, the AutoQ search's evaluators
and training in the port, on the CPU, against the JAX reference.

Both packages get the same numpy inputs; bf16 parameters cross over bit
for bit (``interop.params_from_numpy`` of the reference's
``init(key, dtype=bfloat16)``), and a bf16 batch travels as an ml_dtypes
bfloat16 array, which the port uploads in that dtype.

* B5's plain version (and its wrapper on CPU tensors, which counts no
  launch) on a bf16 x equals the reference's Pallas kernel in interpret
  mode bit for bit: both compute in fp32 and round once to bf16.
  ``fake_quant_weight`` on a bf16 weight equals the reference's
  ``fake_quant_per_channel`` bit for bit (the scales in fp32), and the
  straight-through gradient passes a bf16 gradient unchanged.
* B6's plain version on a bf16 x at the reference test's bf16 tolerance
  (tests/test_kernels.py:58: 3e-2, atol 10 x that), output bf16.
* The bf16 CNN's evaluators, QAT and ``LM.loss`` gradients: XLA fuses the
  reference's bf16 chains and rounds once where eager PyTorch rounds after
  every op, and the port's BINARIZE product sums the unrounded fp32
  plane-form weight where the reference rounds the dense weight to bf16
  first, so the two differ by more than fp32 noise.  The bound is the
  reference's own distance from its fp32 twin (the same parameters and
  inputs upcast): within ``BF16_TWIN_FACTOR`` (2) times it.  Accuracies
  are equal, or differ only on images whose reference top-2 gap is
  within that logit bound.
* AdamW on bf16 leaves: each update in fp32, rounded once to bf16, within
  one bf16 ulp of the reference's parameters.
* Inside the port, bitwise: a bf16 Trainer preempted and resumed equals
  the uninterrupted run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import evaluate as jeval  # noqa: E402
from repro.data import SyntheticImages as JImages  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.quant import binarize as jbin  # noqa: E402
from repro.quant import linear_quant as jlq  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.train.qat import make_qat_loss as jmake_qat_loss  # noqa: E402
from repro.train.qat import qat_finetune as jqat_finetune  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import make_cnn_evaluator  # noqa: E402
from repro_torch.core import evaluate as teval  # noqa: E402
from repro_torch.core.ddpg import tree_leaves  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 params_to_numpy, tensor_to_numpy)
from repro_torch.kernels import binary_matmul as tbm  # noqa: E402
from repro_torch.kernels import fake_quant as tfq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.quant.binarize import fake_binarize_planes  # noqa: E402
from repro_torch.quant.linear_quant import (channel_scale,  # noqa: E402
                                            fake_quant_weight,
                                            ste_fake_quant)
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.train.loop import (SimulatedPreemption,  # noqa: E402
                                    Trainer, TrainConfig, value_and_grad)
from repro_torch.train.qat import make_qat_loss, qat_finetune  # noqa: E402

BF16 = jnp.bfloat16
BF16_BINARY_TOL = dict(rtol=3e-2, atol=3e-1)     # tests/test_kernels.py:58
BIN_TOL = dict(rtol=1e-5, atol=1e-6)               # tests/test_binarize.py:58
BF16_TWIN_FACTOR = 2.0
CFG = dict(name="t", img_size=8, channels=(8, 16), pool_after=(0,))
QAT_CFG = dict(name="sys", img_size=12, channels=(8, 16, 16),
               pool_after=(0, 1))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _bf16_np(a):
    """A float array rounded to bf16, as an ml_dtypes numpy array."""
    return np.asarray(jnp.asarray(a, BF16))


def _leaves_f64(tree):
    """Leaves as float64 numpy, the port's in JAX's order."""
    leaves = jax.tree.leaves(tree)
    if isinstance(leaves[0], torch.Tensor):
        leaves = jax.tree.leaves(params_to_numpy(tree))
    return [np.asarray(a, np.float64) for a in leaves]


def _max_dist(a, b):
    return max(float(np.abs(x - y).max())
               for x, y in zip(_leaves_f64(a), _leaves_f64(b)))


def _policies(graph, seed, mode, act=None):
    """A seeded kernel-wise policy in both packages: weight QBNs 0..8 and
    32, activation QBNs from 3..8 (or ``act``)."""
    rng = np.random.default_rng(seed)
    wb = {l.name: rng.choice([0, 1, 2, 3, 4, 5, 6, 8, 32],
                             size=l.n_groups).astype(np.float32)
          for l in graph.layers}
    ab = {l.name: float(act if act is not None else rng.integers(3, 9))
          for l in graph.layers}
    tmode = QuantMode.QUANT if mode == JMode.QUANT else QuantMode.BINARIZE
    return (JPolicy(mode, {k: v.copy() for k, v in wb.items()}, dict(ab)),
            QuantPolicy(tmode, wb, ab))


def _ulp_bf16(a):
    """One bf16 ulp at each element of ``a`` (float64 numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0**-126)))
    return 2.0 ** (e - 7)


# --------------------------------------------------------------- B5, B6
@pytest.mark.parametrize("shape", [(256, 128), (100, 70), (512, 257)])
def test_fake_quant_plain_bf16_matches_reference_bitwise(shape):
    """tests/test_kernels.py's shapes and inputs, rounded to bf16: the
    plain version and the CPU wrapper (no launch counted) equal the
    reference kernel bit for bit and return bf16."""
    M, N = shape
    rng = np.random.default_rng(M + N)
    x = _bf16_np(rng.normal(size=(M, N)))
    bits = rng.integers(0, 9, size=N).astype(np.float32)
    bits[::7] = 32.0
    lv = np.maximum(2.0 ** (bits - 1) - 1, 1.0).astype(np.float32)
    amax = np.abs(x.astype(np.float32)).max(axis=0)
    sc = np.where(amax > 0, amax / lv, 1.0).astype(np.float32)
    ref = jops.fake_quant_channels(jnp.asarray(x), jnp.asarray(sc),
                                   jnp.asarray(lv), jnp.asarray(bits))
    assert ref.dtype == BF16
    tx = params_from_numpy(x, "cpu")
    plain = tref.fake_quant_ref(tx, _t(sc), _t(lv), _t(bits))
    before = tfq.COUNT.launches
    got = tops.fake_quant_channels(tx, _t(sc), _t(lv), _t(bits))
    assert tfq.COUNT.launches == before
    assert plain.dtype == got.dtype == torch.bfloat16
    want = np.asarray(ref).view(np.int16)
    np.testing.assert_array_equal(tensor_to_numpy(plain).view(np.int16),
                                  want)
    np.testing.assert_array_equal(tensor_to_numpy(got).view(np.int16), want)


@pytest.mark.parametrize("shape,planes", [((128, 128, 128), 1),
                                          ((64, 100, 70), 4),
                                          ((256, 130, 128), 8)])
def test_binary_matmul_plain_bf16_matches_reference(shape, planes):
    """tests/test_kernels.py's shapes and planes on a bf16 x: the plain
    version (and the CPU wrapper, no launch counted) returns bf16 within
    the reference test's bf16 tolerance of the reference kernel."""
    M, K, N = shape
    rng = np.random.default_rng(M * planes + K)
    x = _bf16_np(rng.normal(size=(M, K)))
    B = rng.choice([-1, 1], size=(planes, K, N)).astype(np.int8)
    a = rng.uniform(0.1, 1.0, size=(planes, N)).astype(np.float32)
    ref = jops.binary_matmul(jnp.asarray(x), jnp.asarray(B), jnp.asarray(a))
    assert ref.dtype == BF16
    tx = params_from_numpy(x, "cpu")
    plain = tref.binary_matmul_ref(tx, _t(B), _t(a))
    before = tbm.COUNT.launches
    got = tops.binary_matmul(tx, _t(B), _t(a))
    assert tbm.COUNT.launches == before
    assert plain.dtype == got.dtype == torch.bfloat16
    assert torch.equal(got, plain)
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_BINARY_TOL)


@pytest.mark.parametrize("shape,axis", [((3, 3, 4, 6), 3), ((12, 10), 1),
                                        ((5, 7), 0)])
def test_fake_quant_weight_and_ste_on_bf16(shape, axis):
    """A bf16 weight: fp32 scales (amax / levels in fp32), the output in
    bf16 equal to the reference's fake_quant_per_channel bit for bit, and
    the straight-through backward hands the bf16 gradient back as it
    is."""
    rng = np.random.default_rng(sum(shape))
    w = _bf16_np(rng.normal(size=shape))
    bits = np.array([0, 1, 2, 3, 4, 5, 6, 8, 32, 7, 5, 3][:shape[axis]],
                    np.float32)
    want = jlq.fake_quant_per_channel(jnp.asarray(w), jnp.asarray(bits),
                                      axis=axis)
    tw = params_from_numpy(w, "cpu")
    amax = torch.movedim(tw, axis, -1).reshape(-1, shape[axis]).abs() \
        .amax(dim=0).float()
    scale, _ = channel_scale(amax, _t(bits))
    assert scale.dtype == torch.float32
    got = fake_quant_weight(tw, _t(bits), axis)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(tensor_to_numpy(got).view(np.int16),
                                  np.asarray(want).view(np.int16))
    wl = tw.detach().requires_grad_(True)
    out = ste_fake_quant(wl, _t(bits), axis)
    assert torch.equal(out, got)
    r = params_from_numpy(_bf16_np(rng.normal(size=shape)), "cpu")
    (gw,) = torch.autograd.grad(out, wl, grad_outputs=r)
    assert gw.dtype == torch.bfloat16 and torch.equal(gw, r)


@pytest.mark.parametrize("shape", [(24, 6), (3, 3, 4, 10)])
def test_fake_binarize_planes_of_bf16_weight(shape):
    """A bf16 weight's plane form: int8 signs equal to the reference's
    greedy planes (``binarize_residual``'s B, the weight upcast), fp32
    alphas, and the planes summed in order equal to the reference's
    fake_binarize_per_channel of the bf16 weight (fp32 in both) at the
    binarization tolerance."""
    rng = np.random.default_rng(len(shape))
    w = _bf16_np(rng.normal(size=shape))
    bits = rng.integers(0, 9, size=shape[-1]).astype(np.float32)
    jB, _ = jbin.binarize_residual(jnp.asarray(w), 8, axis=-1)
    want = jbin.fake_binarize_per_channel(jnp.asarray(w), jnp.asarray(bits),
                                          axis=-1)
    planes, alpha = fake_binarize_planes(params_from_numpy(w, "cpu"),
                                         _t(bits))
    assert planes.dtype == torch.int8 and alpha.dtype == torch.float32
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jB))
    dense = torch.zeros(shape)
    for a, b in zip(alpha, planes):
        dense = dense + a * b.float()
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **BIN_TOL)


def test_kernel_wrappers_take_bf16_and_refuse_other_dtypes():
    """On CPU tensors the wrappers take a bf16 x and return bf16; a
    float64 or float16 x is refused, as the kernels take neither."""
    x = torch.ones(4, 6, dtype=torch.bfloat16)
    v = torch.ones(6)
    assert tops.fake_quant_channels(x, v, v, v).dtype == torch.bfloat16
    B = torch.ones(2, 6, 3, dtype=torch.int8)
    a = torch.ones(2, 3)
    assert tops.binary_matmul(x, B, a).dtype == torch.bfloat16
    for dt in (torch.float64, torch.float16):
        with pytest.raises(ValueError):
            tops.fake_quant_channels(x.to(dt), v, v, v)
        with pytest.raises(ValueError):
            tops.binary_matmul(x.to(dt), B, a)


# ---------------------------------------------------------------- the CNN
def test_cnn_init_dtype():
    """init(dtype=) draws in fp32 and casts every leaf, biases too."""
    m = tcnn.CNN(tcnn.CNNConfig(**CFG))
    p32 = m.init(3, "cpu")
    p16 = m.init(3, "cpu", dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(p32), tree_leaves(p16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.bfloat16(), b)
    with pytest.raises(ValueError):
        m.init(3, "cpu", dtype=torch.float16)
    x = torch.randn(2, 8, 8, 3).bfloat16()
    assert m.apply(p16, x).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def cnn16():
    jm = jcnn.CNN(jcnn.CNNConfig(**CFG))
    jp = jm.init(jax.random.PRNGKey(0), dtype=BF16)
    val = JImages(img_size=8).batch(999, 64)
    val = {"x": _bf16_np(val["x"]), "y": val["y"]}
    return dict(jm=jm, jp=jp, tp=params_from_numpy(_np(jp), "cpu"),
                val=val, jg=jm.graph(), tg=tcnn.CNN(tcnn.CNNConfig(**CFG))
                .graph())


class _Spy(tcnn.CNN):
    """The port's CNN, keeping the logits of its last accuracy call."""

    def accuracy(self, params, batch, act_bits=None):
        self.logits = self.apply(params, batch["x"], act_bits=act_bits)
        return super().accuracy(params, batch, act_bits=act_bits)


def _ref_logits(c, jparams, x, jpol, mode):
    jwb, jab = jeval._expand_bits(jpol, c["jg"])
    jq = jeval._quantize_params(jparams, c["jg"], jwb, mode)
    names = [l.name for l in c["jg"].layers]
    return np.asarray(c["jm"].apply(jq, jnp.asarray(x),
                                    act_bits=dict(zip(names, jab))),
                      np.float64)


@pytest.mark.parametrize("mode,seed", [(JMode.QUANT, 2), (JMode.BINARIZE, 3)])
def test_cnn_evaluator_bf16_matches_reference(cnn16, mode, seed):
    """A bf16 CNN evaluated on a bf16 batch: the port's evaluator (B5 /
    B6 on bf16) computes bf16 logits (the batch is uploaded as given, not
    cast to fp32), within BF16_TWIN_FACTOR x the reference's distance from
    its fp32 twin of the reference's; accuracies equal up to images the
    gap rule allows at that bound."""
    c = cnn16
    jpol, tpol = _policies(c["jg"], seed, mode)
    jacc = jeval.make_cnn_evaluator(c["jm"], c["jp"], c["jg"], c["val"],
                                    mode=mode)(jpol)
    spy = _Spy(tcnn.CNNConfig(**CFG))
    tacc = make_cnn_evaluator(spy, c["tp"], spy.graph(), c["val"],
                              mode=tpol.mode)(tpol)
    assert spy.logits.dtype == torch.bfloat16
    jl = _ref_logits(c, c["jp"], c["val"]["x"], jpol, mode)
    twin = _ref_logits(c, _f32(c["jp"]), c["val"]["x"].astype(np.float32),
                       jpol, mode)
    bound = BF16_TWIN_FACTOR * float(np.abs(jl - twin).max())
    tl = spy.logits.double().numpy()
    assert float(np.abs(tl - jl).max()) <= bound
    top2 = np.sort(jl, axis=-1)[:, -2:]
    flips = np.flatnonzero(tl.argmax(-1) != jl.argmax(-1))
    assert np.all(top2[flips, 1] - top2[flips, 0] <= bound), flips
    assert abs(tacc - jacc) <= 100.0 * len(flips) / len(c["val"]["y"]) + 1e-9


def test_quantized_bf16_weights_bitwise(cnn16):
    """QUANT on bf16 weights: the evaluator's B5 weights equal the
    reference's fake_quant_per_channel bit for bit, in bf16."""
    c = cnn16
    jpol, tpol = _policies(c["jg"], 5, JMode.QUANT)
    jwb, _ = jeval._expand_bits(jpol, c["jg"])
    jq = jeval._quantize_params(c["jp"], c["jg"], jwb, JMode.QUANT)
    wb, _ = teval.upload_bits(tpol, c["tg"], torch.device("cpu"))
    tq = teval._quantize_params(c["tp"], c["tg"], wb, QuantMode.QUANT)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tq)),
                    jax.tree.leaves(_np(jq))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      np.asarray(b).view(np.int16))


@pytest.mark.parametrize("mode", [QuantMode.QUANT, QuantMode.BINARIZE])
def test_search_runs_on_bf16_cnn(cnn16, mode):
    """run_search over a HierarchicalAgent on the bf16 CNN's evaluator in
    each mode: finite rewards and accuracies, the best policy kept, and
    the parameters left bf16 (nothing on the path upcasts the model)."""
    c = cnn16
    ev = make_cnn_evaluator(tcnn.CNN(tcnn.CNNConfig(**CFG)), c["tp"],
                            c["tg"], c["val"], mode=mode)
    env = tcore.QuantEnv(c["tg"], c["tp"], ev,
                         tcore.RewardCfg.accuracy_guaranteed(), mode=mode)
    agent = tcore.HierarchicalAgent(env, seed=0, updates_per_episode=2,
                                    device="cpu")
    res = tcore.run_search(agent, n_explore=2, n_exploit=1)
    assert len(res.history) == 3
    assert all(np.isfinite(h.reward) and np.isfinite(h.acc)
               for h in res.history)
    assert res.best_policy is not None and res.best_policy.mode == mode
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(c["tp"]))


# -------------------------------------------------------------------- QAT
def test_qat_step_and_finetune_bf16_within_twin_bound():
    """One QAT step (loss and gradients) and 4 qat_finetune steps on a
    bf16 CNN with bf16 batches: every leaf bf16, within BF16_TWIN_FACTOR x
    the reference's own distance from its fp32 twin."""
    jm, tm = jcnn.CNN(jcnn.CNNConfig(**QAT_CFG)), \
        tcnn.CNN(tcnn.CNNConfig(**QAT_CFG))
    jp = jm.init(jax.random.PRNGKey(0), dtype=BF16)
    tp = params_from_numpy(_np(jp), "cpu")
    jg = jm.graph()
    jpol, tpol = _policies(jg, 3, JMode.QUANT)
    data = JImages(img_size=12)

    def batch16(i):
        b = data.batch(100 + i, 32)
        return {"x": _bf16_np(b["x"]), "y": b["y"]}

    b0 = batch16(0)
    jb = {k: jnp.asarray(v) for k, v in b0.items()}
    jl, jgr = jax.value_and_grad(jmake_qat_loss(jm, jg, jpol))(jp, jb)
    tw_l, tw_g = jax.value_and_grad(jmake_qat_loss(jm, jg, jpol))(
        _f32(jp), _f32(jb) | {"y": jb["y"]})
    tl, tg = value_and_grad(make_qat_loss(tm, tm.graph(), tpol,
                                          device="cpu"),
                            tp, {"x": params_from_numpy(b0["x"], "cpu"),
                                 "y": _t(b0["y"])})
    assert tl.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tg))
    assert abs(float(tl) - float(jl)) <= \
        BF16_TWIN_FACTOR * abs(float(jl) - float(tw_l))
    assert _max_dist(tg, _np(jgr)) <= \
        BF16_TWIN_FACTOR * _max_dist(_np(jgr), _np(tw_g))
    steps = 4
    tuned = qat_finetune(tm, tp, tm.graph(), tpol, batch16, steps=steps)
    jtuned = jqat_finetune(jm, jp, jg, jpol, batch16, steps=steps)
    jtwin = jqat_finetune(jm, _f32(jp), jg, jpol,
                          lambda i: {"x": batch16(i)["x"].astype(np.float32),
                                     "y": batch16(i)["y"]}, steps=steps)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tuned))
    assert _max_dist(tuned, _np(jtuned)) <= \
        BF16_TWIN_FACTOR * _max_dist(_np(jtuned), _np(jtwin))


# ---------------------------------------------------------------- LM.loss
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m"])
def test_lm_loss_grads_bf16_within_twin_bound(arch):
    """LM.loss and its gradients on bf16 parameters (the embedding's and
    the MoE dispatch's row gathers summed by the deterministic
    index_put_ on bf16 leaves): bf16 gradients within BF16_TWIN_FACTOR x
    the reference's own distance from its fp32 twin (max abs over every
    leaf), and the same bits on a second call."""
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0), dtype=BF16)
    cfg = ARCHS[arch].smoke
    batch = TokenStream(vocab=cfg.vocab).batch(0, 2, 12)
    batch["labels"][0, -3:] = -1
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jgr = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tw_l, tw_g = jax.jit(jax.value_and_grad(jm.loss))(_f32(jp), jb)
    tm = LM(cfg)
    tp = params_from_numpy(_np(jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg = value_and_grad(lambda p: tm.loss(p, tb), tp)
    _, tg2 = value_and_grad(lambda p: tm.loss(p, tb), tp)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tg))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tg),
                                                 tree_leaves(tg2)))
    assert abs(float(tl) - float(jl)) <= \
        BF16_TWIN_FACTOR * abs(float(jl) - float(tw_l))
    twin = _max_dist(_np(jgr), _np(tw_g))
    assert _max_dist(tg, _np(jgr)) <= BF16_TWIN_FACTOR * twin


# ------------------------------------------------------------------ AdamW
_TARGET = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)


def _jloss(p):
    return jnp.mean((p["w"] - _TARGET) ** 2) + \
        jnp.mean((p["nested"][0]["b"] - 1.0) ** 2)


def _tloss(p):
    return torch.mean((p["w"] - torch.from_numpy(_TARGET)) ** 2) + \
        torch.mean((p["nested"][0]["b"] - 1.0) ** 2)


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_on_bf16_leaves_matches_reference(bits):
    """AdamW (fp32 or 8-bit moments) on bf16 leaves: every update in fp32,
    rounded once to bf16; after 10 steps every parameter within one bf16
    ulp of the reference's, the leaves still bf16."""
    rng = np.random.default_rng(1)
    p0 = {"w": _bf16_np(rng.normal(size=(16, 16)) * 0.1),
          "nested": ({"b": _bf16_np(rng.normal(size=16) * 0.1)},)}
    jopt = JAdamW(lr=2e-2, state_bits=bits, weight_decay=0.01)
    topt = AdamW(lr=2e-2, state_bits=bits, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(lambda p, s: jopt.update(p, jax.grad(_jloss)(p), s))
    for _ in range(10):
        jp, js, _ = jstep(jp, js)
        _, g = value_and_grad(_tloss, tp)
        tp, ts, _ = topt.update(tp, g, ts)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    for a, b in zip(_leaves_f64(tp), _leaves_f64(_np(jp))):
        assert np.all(np.abs(a - b) <= _ulp_bf16(b)), np.abs(a - b).max()


# ---------------------------------------------------------------- Trainer
def test_bf16_trainer_resume_bitwise(tmp_path):
    """The Trainer on a bf16 CNN with bf16 batches: preempted at step 7
    and resumed from its step-4 checkpoint, every parameter and optimizer
    leaf equals the uninterrupted run's bit for bit; the parameters stay
    bf16 through the checkpoint."""
    cfg = tcnn.CNNConfig(**CFG)
    params = tcnn.CNN(cfg).init(0, "cpu", dtype=torch.bfloat16)
    data = JImages(img_size=8)

    def data_fn(step):
        b = data.batch(step, 16)
        return {"x": _bf16_np(b["x"]), "y": b["y"]}

    def trainer(sub, preempt_at=None):
        return Trainer(tcnn.CNN(cfg), params, AdamW(lr=1e-3), data_fn,
                       str(tmp_path / sub),
                       TrainConfig(total_steps=10, ckpt_every=4, log_every=1),
                       preempt_at=preempt_at, device="cpu")

    ref = trainer("ref").run()
    with pytest.raises(SimulatedPreemption):
        trainer("pre", preempt_at=7).run()
    resumed = trainer("pre")
    assert resumed.start_step == 4
    out = resumed.run()
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(out["params"]))
    for a, b in zip(tree_leaves(ref["params"]) + tree_leaves(ref["opt"]),
                    tree_leaves(out["params"]) + tree_leaves(out["opt"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [h["loss"] for h in ref["history"]][4:] == \
        [h["loss"] for h in out["history"]]
