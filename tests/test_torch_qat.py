"""QAT and the roofline reward of the PyTorch port against the JAX
reference, on the CPU.

* ``ste_fake_quant``: forward bit for bit ``fake_quant_per_channel`` (B5's
  plain version on CPU tensors), backward the identity;
* QAT on test_system.py's small CNN under a seeded kernel-wise policy
  (weight and activation QBNs): one ``make_qat_loss`` step's loss and
  gradients, and five ``qat_finetune`` steps' parameters, within rtol
  1e-4 / atol 1e-5 of the reference (f32 in both, summation order only);
* ``TPURoofline`` (a copy of the reference's) and
  ``extrinsic_reward(kind="roofline")``: equal (``==``) to the reference
  for seeded policies on CIF10-7CNN's and gemma2-2b's smoke graphs;
* ``H100Roofline``: latency never rises as bits fall, storage follows
  the packed store's buckets, the compute rate follows the GEMM route.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core.reward import RewardCfg as JRewardCfg  # noqa: E402
from repro.core.reward import extrinsic_reward as jreward  # noqa: E402
from repro.core.roofline import TPURoofline as JTPURoofline  # noqa: E402
from repro.data import SyntheticImages as JImages  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models.cnn import CIF10 as JCIF10  # noqa: E402
from repro.models.cnn import CNN as JCNN  # noqa: E402
from repro.models.cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.train.qat import make_qat_loss as jmake_qat_loss  # noqa: E402
from repro.train.qat import qat_finetune as jqat_finetune  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import H100Roofline, TPURoofline  # noqa: E402
from repro_torch.core.reward import RewardCfg, extrinsic_reward  # noqa: E402
from repro_torch.core.roofline import (H100_FP32,  # noqa: E402
                                       H100_TC_PASSES, H100_TF32,
                                       h100_storage_bytes_per_elem)
from repro_torch.data import SyntheticImages  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels import pack  # noqa: E402
from repro_torch.kernels.quant_matmul import SKINNY_M, route  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.cnn import CIF10, CNN, CNNConfig  # noqa: E402
from repro_torch.quant.linear_quant import (_bucket_ids,  # noqa: E402
                                            fake_quant_per_channel,
                                            ste_fake_quant)
from repro_torch.quant.policy import (LayerInfo, QuantizableGraph,  # noqa: E402
                                      QuantMode, QuantPolicy)
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.train.qat import make_qat_loss, qat_finetune  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
SYS_CFG = dict(name="sys", img_size=12, channels=(8, 16, 16),
               pool_after=(0, 1))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits_of(graph, seed, act=None):
    """Seeded weight QBNs from {0..6, 8, 32} per group, activation QBNs
    from 3..8 (or ``act``), as numpy dicts for both packages."""
    rng = np.random.default_rng(seed)
    wb = {l.name: rng.choice([0, 1, 2, 3, 4, 5, 6, 8, 32],
                             size=l.n_groups).astype(np.float32)
          for l in graph.layers}
    ab = {l.name: float(act if act is not None else rng.integers(3, 9))
          for l in graph.layers}
    return wb, ab


def _policies(jgraph, tgraph, seed, act=None):
    wb, ab = _bits_of(tgraph, seed, act)
    return (JPolicy(JMode.QUANT, {k: v.copy() for k, v in wb.items()},
                    dict(ab)),
            QuantPolicy(QuantMode.QUANT, wb, ab))


# ------------------------------------------------------- straight-through
@pytest.mark.parametrize("shape,axis", [((3, 3, 4, 6), 3), ((12, 10), 1),
                                        ((5, 7), 0)])
def test_ste_forward_is_fake_quant_and_backward_identity(shape, axis):
    g = torch.Generator().manual_seed(1)
    w = torch.randn(shape, generator=g)
    bits = torch.tensor([0, 1, 2, 3, 4, 5, 6, 8, 32, 7, 5, 3][:shape[axis]],
                        dtype=torch.float32)
    wl = w.detach().requires_grad_(True)
    out = ste_fake_quant(wl, bits, axis)
    assert torch.equal(out, fake_quant_per_channel(w, bits, axis=axis))
    r = torch.randn(shape, generator=g)
    (gw,) = torch.autograd.grad((out * r).sum(), wl)
    assert torch.equal(gw, r)


# -------------------------------------------------------------------- QAT
def test_qat_step_and_finetune_match_reference():
    jm, tm = JCNN(JCNNConfig(**SYS_CFG)), CNN(CNNConfig(**SYS_CFG))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jp), "cpu")
    jg, tg = jm.graph(), tm.graph()
    jpol, tpol = _policies(jg, tg, seed=3)
    batch = SyntheticImages(img_size=12).batch(7, 32)
    jl, jgrad = jax.value_and_grad(jmake_qat_loss(jm, jg, jpol))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = make_qat_loss(tm, tg, tpol, device="cpu")
    tl, tgrad = value_and_grad(
        tloss, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tgrad)),
                    jax.tree.leaves(_np(jgrad))):
        np.testing.assert_allclose(a, b, **TOL)
    data, jdata = SyntheticImages(img_size=12), JImages(img_size=12)
    tuned = qat_finetune(tm, tp, tg, tpol, lambda i: data.batch(100 + i, 32),
                         steps=5)
    jtuned = jqat_finetune(jm, jp, jg, jpol,
                           lambda i: jdata.batch(100 + i, 32), steps=5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tuned)),
                    jax.tree.leaves(_np(jtuned))):
        np.testing.assert_allclose(a, b, **TOL)
    assert tp["conv0"]["w"].device.type == "cpu"


# --------------------------------------------------------------- rooflines
def _graphs(which):
    if which == "cif10":
        return JCNN(JCIF10).graph(), CNN(CIF10).graph()
    return (JLM(JARCHS["gemma2-2b"].smoke).graph(seq_len=16, batch=2),
            LM(ARCHS["gemma2-2b"].smoke).graph(seq_len=16, batch=2))


@pytest.mark.parametrize("which", ["cif10", "gemma2_smoke"])
def test_tpu_roofline_and_reward_equal_reference(which):
    jgraph, tgraph = _graphs(which)
    jr, tr = JTPURoofline(), TPURoofline()
    assert tr.latency_full(tgraph) == jr.latency_full(jgraph)
    jcfg = JRewardCfg(alpha=2.0, beta=0.5, gamma=0.5, kind="roofline")
    tcfg = RewardCfg(alpha=2.0, beta=0.5, gamma=0.5, kind="roofline")
    for seed in range(5):
        jpol, tpol = _policies(jgraph, tgraph, seed)
        assert tr.latency(tgraph, tpol) == jr.latency(jgraph, jpol)
        assert tr.energy(tgraph, tpol) == jr.energy(jgraph, jpol)
        assert tr.throughput_fps(tgraph, tpol) == \
            jr.throughput_fps(jgraph, jpol)
        acc = 40.0 + 7.5 * seed
        assert extrinsic_reward(acc, tgraph, tpol, tcfg, roofline=tr) == \
            jreward(acc, jgraph, jpol, jcfg, roofline=jr)


def test_h100_roofline_latency_falls_with_bits():
    _, graph = _graphs("cif10")
    r = H100Roofline(power_w=500.0)
    lats = [r.latency(graph, QuantPolicy.uniform(graph, float(b)))
            for b in (32, 16, 8, 6, 5, 4, 3, 2, 1, 0)]
    assert all(a >= b for a, b in zip(lats, lats[1:]))
    assert lats[0] == r.latency_full(graph) and lats[-1] < lats[0]
    wb, ab = _bits_of(graph, 0)
    pol = QuantPolicy(QuantMode.QUANT, wb, ab)
    lower = pol.copy()
    for name in lower.weight_bits:
        lower.weight_bits[name] = np.maximum(lower.weight_bits[name] - 2, 0)
    assert r.latency(graph, lower) <= r.latency(graph, pol)
    assert r.energy(graph, pol) == 500.0 * r.latency(graph, pol)
    assert r.throughput_fps(graph, pol) == 1.0 / r.latency(graph, pol)


def test_h100_storage_follows_buckets():
    bits = np.array([0, 0.4, 1, 2, 2.4, 3, 4, 5, 7, 8, 8.4, 9, 16, 32])
    got = h100_storage_bytes_per_elem(bits)
    for b, bytes_ in zip(bits, got):
        name = pack.bucket_of_bits(b)
        want = {"pruned": 0.0, "full": 2.0}.get(
            name, pack.STORE_BITS.get(name, 0) / 8.0)
        assert bytes_ == want, (b, name)
    np.testing.assert_array_equal(
        got, np.array([0, 0.25, 0.5, 1, 2])[_bucket_ids(bits)])


def test_h100_rate_follows_gemm_route():
    def layer(rows):
        return LayerInfo(name="l", kind="linear", c_in=64, c_out=32, k=1,
                         stride=1, macs=float(rows * 64 * 32), numel=64 * 32,
                         param_path=("w",), channel_axis=1, n_groups=32)

    r = H100Roofline()
    for rows in (1, SKINNY_M, SKINNY_M + 1, 4096):
        lay = layer(rows)
        t_compute, _ = r._layer_terms(lay, np.full(32, 8.0))
        rate = H100_FP32 if route(rows) == "skinny" else \
            H100_TF32 / H100_TC_PASSES
        assert t_compute == 2.0 * lay.macs / rate
        assert (route(rows) == "skinny") == (rows <= SKINNY_M)
        g = QuantizableGraph(layers=[lay])
        # the rate does not depend on the QBN
        assert r._layer_terms(lay, np.full(32, 2.0))[0] == t_compute
        assert r.latency(g, QuantPolicy.uniform(g, 8.0)) == max(
            r._layer_terms(lay, np.full(32, 8.0)))
