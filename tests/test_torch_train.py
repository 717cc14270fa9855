"""Training in the PyTorch port against the JAX reference, on the CPU.

Same numpy inputs through both packages; the reference's params, states
and checkpoints cross over through numpy (``interop``) or on disk.
Tolerances:

* AdamW: parameters rtol 1e-5 / atol 1e-6 after 20 updates (f32 in both,
  summation order only); 8-bit moment codes within one step of each
  other (``_q8`` rounds ``x / scale``, and an ulp between the frameworks
  can move a code at a tie); ``grad_norm`` rtol 1e-6;
* ``cosine_warmup``: 1e-7;
* checkpoints: bit for bit, both ways, bf16 and int8 leaves included;
* Trainer: preempt-and-resume bit for bit inside the port; 24 steps
  within rtol 1e-4 / atol 1e-5 of the reference's Trainer;
* ``LM.loss``: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5
  (test_models.py's remat tolerance); remat True / "dots" == False, bit
  for bit, inside the port.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data import SyntheticImages as JImages  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models.cnn import CNN as JCNN  # noqa: E402
from repro.models.cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_warmup as jcosine  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro.train.loop import Trainer as JTrainer  # noqa: E402
from repro.train.loop import TrainConfig as JTrainConfig  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.ddpg import tree_leaves  # noqa: E402
from repro_torch.data import SyntheticImages, TokenStream  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.cnn import CNN, CNNConfig  # noqa: E402
from repro_torch.optim import AdamW, cosine_warmup  # noqa: E402
from repro_torch.train import CheckpointManager  # noqa: E402
from repro_torch.train.loop import (SimulatedPreemption,  # noqa: E402
                                    Trainer, TrainConfig, value_and_grad)

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """The port's leaves as numpy, in JAX's order."""
    return [np.asarray(a) for a in jax.tree.leaves(params_to_numpy(tree))]


# ------------------------------------------------------------------ AdamW
_TARGET = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)


def _quad_params():
    return {"w": np.zeros((16, 16), np.float32),
            "nested": ({"b": np.zeros(16, np.float32)},)}


def _jloss(p):
    return jnp.mean((p["w"] - _TARGET) ** 2) + \
        jnp.mean((p["nested"][0]["b"] - 1.0) ** 2)


def _tloss(p):
    return torch.mean((p["w"] - torch.from_numpy(_TARGET)) ** 2) + \
        torch.mean((p["nested"][0]["b"] - 1.0) ** 2)


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_matches_reference(bits):
    jopt = JAdamW(lr=2e-2, state_bits=bits, weight_decay=0.01)
    topt = AdamW(lr=2e-2, state_bits=bits, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, _quad_params())
    tp = params_from_numpy(_quad_params(), "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(lambda p, s: jopt.update(p, jax.grad(_jloss)(p), s))
    for _ in range(20):
        jp, js, jm = jstep(jp, js)
        _, g = value_and_grad(_tloss, tp)
        tp, ts, tm = topt.update(tp, g, ts)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for a, b in zip(_leaves(tp), jax.tree.leaves(_np(jp))):
        np.testing.assert_allclose(a, b, **PARAM_TOL)
    # the state trees have the reference's structure, leaf for leaf
    assert jax.tree.structure(params_to_numpy(ts)) == \
        jax.tree.structure(_np(js))
    for a, b in zip(_leaves(ts), jax.tree.leaves(_np(js))):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_cosine_warmup_matches_reference():
    for s in range(101):
        kw = dict(base_lr=1.0, warmup=10, total=100)
        got = float(cosine_warmup(s, **kw))
        assert abs(got - float(jcosine(s, **kw))) <= 1e-7
        assert float(cosine_warmup(torch.tensor(s), **kw)) == got


def _converges(bits):
    opt = AdamW(lr=5e-2, state_bits=bits)
    p = params_from_numpy(_quad_params(), "cpu")
    s = opt.init(p)
    l0 = float(_tloss(p))
    for _ in range(200):
        _, g = value_and_grad(_tloss, p)
        p, s, _ = opt.update(p, g, s)
    assert float(_tloss(p)) < l0 * 0.05


def _state_layout(_):
    s = AdamW(state_bits=8).init(params_from_numpy(_quad_params(), "cpu"))
    assert s["m"]["w"]["q"].dtype == torch.int8
    assert s["m"]["w"]["s"].shape == (16, 1)
    assert s["m"]["nested"][0]["b"]["s"].shape == (1,)
    assert s["t"].dtype == torch.int32 and s["t"].shape == ()


def _tracks_fp32(_):
    p0 = params_from_numpy(_quad_params(), "cpu")
    out = []
    for bits in (32, 8):
        opt, p = AdamW(lr=2e-2, state_bits=bits), p0
        s = opt.init(p)
        for _ in range(50):
            _, g = value_and_grad(_tloss, p)
            p, s, _ = opt.update(p, g, s)
        out.append(float(_tloss(p)))
    l0 = float(_tloss(p0))
    assert out[0] < l0 * 0.5 and out[1] < l0 * 0.5


def _grad_clip(_):
    opt = AdamW(lr=1.0, grad_clip=1e-3)
    p = {"w": torch.zeros(4)}
    before = p["w"].clone()
    newp, _, m = opt.update(p, {"w": torch.full((4,), 1e9)}, opt.init(p))
    assert float(m["grad_norm"]) > 1e8
    assert float(newp["w"].abs().max()) < 10.0
    assert torch.equal(p["w"], before)       # functional: no leaf written


@pytest.mark.parametrize("case,arg", [
    (_converges, 32), (_converges, 8), (_state_layout, None),
    (_tracks_fp32, None), (_grad_clip, None)],
    ids=["converges32", "converges8", "state_layout", "tracks_fp32",
         "grad_clip"])
def test_adamw_port_cases(case, arg):
    case(arg)


# ------------------------------------------------------------ checkpoints
def _jtree():
    key = jax.random.PRNGKey(0)
    return {
        "a": jax.random.normal(key, (4, 8)),
        "blocks": ({"w": jax.random.normal(key, (2, 3)).astype(jnp.bfloat16)},
                   {"w": jnp.arange(6, dtype=jnp.int8).reshape(2, 3)}),
        "opt": {"m": {"q": jnp.ones((2, 5), jnp.int8),
                      "s": jnp.full((2, 1), 0.5, jnp.float32)}},
        "t": jnp.int32(7),
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_checkpoints_cross_restore_both_ways(tmp_path):
    jt = _jtree()
    JCkpt(tmp_path / "ref").save(5, jt, extra={"note": "hi"})
    tlike = params_from_numpy(_np(jt), "cpu")
    step, got, extra = CheckpointManager(tmp_path / "ref").restore(
        tlike, device="cpu")
    assert step == 5 and extra == {"note": "hi"}
    assert got["blocks"][0]["w"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(_np(jt)), jax.tree.leaves(
            params_to_numpy(got))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the port's own checkpoint of the same tree: the reference's manifest
    # (names, keys, dtypes, shapes) and arrays, and it restores there
    CheckpointManager(tmp_path / "port").save(5, tlike, extra={"note": "hi"})
    for name in ("ref", "port"):
        d = tmp_path / name / "step_0000000005"
        assert sorted(p.name for p in d.iterdir()) == ["data.npz",
                                                       "manifest.json"]
    mans = [json.loads((tmp_path / n / "step_0000000005" /
                        "manifest.json").read_text()) for n in ("ref", "port")]
    assert mans[0] == mans[1]
    step, back, _ = JCkpt(tmp_path / "port").restore(
        jax.eval_shape(lambda: jt))
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_keep_k_and_errors(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, {"x": torch.zeros(3)})
    assert cm.all_steps() == [3, 4] and cm.latest_step() == 4
    assert not (tmp_path / "tmp.4").exists()
    with pytest.raises(ValueError, match="shape mismatch"):
        cm.restore({"x": torch.zeros(4)}, device="cpu")
    with pytest.raises(KeyError, match="missing leaf y"):
        cm.restore({"y": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="without a mesh"):
        cm.restore({"x": torch.zeros(3)}, shardings={"x": None})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"x": torch.zeros(3)},
                                                      device="cpu")


def test_interop_carries_an_adamw_state_unchanged():
    js = JAdamW(state_bits=8).init(jax.tree.map(jnp.asarray, _quad_params()))
    ts = params_from_numpy(_np(js), "cpu")
    assert ts["m"]["w"]["q"].dtype == torch.int8
    assert ts["v"]["nested"][0]["b"]["s"].dtype == torch.float32
    assert ts["t"].dtype == torch.int32 and ts["t"].shape == ()
    for a, b in zip(jax.tree.leaves(_np(js)),
                    jax.tree.leaves(params_to_numpy(ts))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- Trainer
CNN_CFG = dict(name="t", img_size=8, channels=(8, 8), pool_after=(0,))


def _data_fn(step):
    return SyntheticImages(img_size=8).batch(step, 32)


def _trainer(ckpt_dir, params, preempt_at=None, steps=24):
    return Trainer(CNN(CNNConfig(**CNN_CFG)), params, AdamW(lr=1e-3),
                   _data_fn, str(ckpt_dir),
                   TrainConfig(total_steps=steps, ckpt_every=8, log_every=8),
                   preempt_at=preempt_at, device="cpu")


def test_trainer_resume_bitwise_and_matches_reference(tmp_path):
    jm = JCNN(JCNNConfig(**CNN_CFG))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jp), "cpu")
    ref = _trainer(tmp_path / "ref", tp).run()
    with pytest.raises(SimulatedPreemption):
        _trainer(tmp_path / "pre", tp, preempt_at=13).run()
    resumed = _trainer(tmp_path / "pre", tp)
    assert resumed.start_step == 8
    out = resumed.run()
    for a, b in zip(tree_leaves(ref["params"]) + tree_leaves(ref["opt"]),
                    tree_leaves(out["params"]) + tree_leaves(out["opt"])):
        assert torch.equal(a, b)
    assert [h["step"] for h in ref["history"]] == [8, 16, 24]
    assert isinstance(ref["stragglers"], list)
    # a finished run resumes into a no-op
    again = _trainer(tmp_path / "ref", tp)
    assert again.start_step == 24
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(again.run()["params"]), tree_leaves(ref["params"])))
    # the reference's Trainer on the same params and data
    data = JImages(img_size=8)
    jt = JTrainer(jm, jp, JAdamW(lr=1e-3), lambda s: data.batch(s, 32),
                  str(tmp_path / "jref"),
                  JTrainConfig(total_steps=24, ckpt_every=8, log_every=8))
    jout = jt.run()
    for a, b in zip(_leaves(ref["params"]), jax.tree.leaves(
            _np(jout["params"]))):
        np.testing.assert_allclose(a, b, **TRAIN_TOL)
    for h, jh in zip(ref["history"], jout["history"]):
        np.testing.assert_allclose(h["loss"], jh["loss"], **TRAIN_TOL)


# ---------------------------------------------------------------- LM.loss
@pytest.mark.parametrize("arch", ["gemma2-2b", "internlm2-20b"])
def test_lm_loss_and_grads_match_reference(arch):
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ARCHS[arch].smoke
    batch = TokenStream(vocab=cfg.vocab).batch(0, 2, 12)
    batch["labels"][0, -3:] = -1           # masked positions
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = LM(cfg)
    tp = params_from_numpy(_np(jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for remat in (False, True, "dots"):
        got[remat] = value_and_grad(
            lambda p: tm.loss(p, tb, remat=remat), tp)
    tl, tg = got[False]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(_leaves(tg), jax.tree.leaves(_np(jg))):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    for remat in (True, "dots"):
        rl, rg = got[remat]
        assert torch.equal(rl, tl)
        for a, b in zip(tree_leaves(rg), tree_leaves(tg)):
            assert torch.equal(a, b)
