"""The port's ``ServeEngine.generate`` against the JAX reference's, on the CPU.

One kernel-wise policy over QBNs {0, 2, 3, 4, 6, 8, 16} (every storage
bucket, ``full`` included) with activation QBNs, on gemma2-smoke with a
prompt longer than its window.  The reference runs ``attn_impl="ref"``;
the port its default ``"cuda"`` path, whose wrappers run their plain
versions on CPU tensors.  Greedy streams must be equal, or first differ
only at a step where the reference's top-2 logit gap is below the logits
tolerance: across frameworks the summation order differs, so a near-tie
may break either way (ROADMAP.md section C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

LOGIT_ATOL = 1e-4
ARCH, S, N_NEW, MAX_LEN = "gemma2-2b", 12, 5, 20


def _bits(layers, choices, seed):
    rng = np.random.default_rng(seed)
    return {l.name: rng.choice(choices, size=l.n_groups).astype(np.float32)
            for l in layers}


@pytest.fixture(scope="module")
def setup():
    jm = JLM(JARCHS[ARCH].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    graph = jm.graph(seq_len=4, batch=2)
    wbits = _bits(graph.layers, [0, 2, 3, 4, 6, 8, 16], 0)
    abits = {l.name: float(6 + i % 3) for i, l in enumerate(graph.layers)}
    tm = LM(ARCHS[ARCH].smoke)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, size=(2, S))
    return dict(jm=jm, jp=jp, jpol=JPolicy(JMode.QUANT, wbits, abits),
                tm=tm, tp=tp, tpol=QuantPolicy(QuantMode.QUANT, wbits, abits),
                tgraph=tm.graph(seq_len=4, batch=2), toks=toks)


def _jit_apply_policy_packed(params, graph, policy):
    """``repro.quant.apply.apply_policy_packed`` with each weight's
    ``quant_pack_sub8`` under one ``jax.jit``: the same function, compiled
    once per weight instead of op by op (which takes minutes on a CPU)."""
    from repro.quant.apply import _get_path, _set_path
    from repro.quant.linear_quant import quant_pack_sub8
    out = params
    for layer in graph.layers:
        bits = policy.expand_weight_bits(layer)
        pack = jax.jit(lambda w, b=bits: quant_pack_sub8(w, b))
        out = _set_path(out, layer.param_path,
                        pack(_get_path(params, layer.param_path)))
    return out


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The two reference engines of this file, and their streams."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("repro.serve.engine.apply_policy_packed",
                   _jit_apply_policy_packed)
        for store in ("fake", "packed"):
            eng = JEngine(setup["jm"], setup["jp"], policy=setup["jpol"],
                          max_len=MAX_LEN, weight_store=store,
                          attn_impl="ref")
            out[store] = (eng, eng.generate(setup["toks"], N_NEW)["tokens"])
    return out


def _port_engine(setup, store, **kw):
    return ServeEngine(setup["tm"], setup["tp"], policy=setup["tpol"],
                       graph=setup["tgraph"], max_len=MAX_LEN,
                       weight_store=store, device="cpu", **kw)


def _reference_gap(eng, toks, stream, b, t):
    """Top-2 logit gap of the reference at step ``t`` of row ``b``,
    teacher-forced along its own stream."""
    jm = eng.model
    cache = jm.init_cache(toks.shape[0], eng.max_len, dtype=jnp.float32)
    logits, cache = eng._prefill(eng.params, {"tokens": jnp.asarray(toks)},
                                 cache, eng.act_bits, attn_impl="ref")
    for i in range(t):
        logits, cache = eng._decode(eng.params, jnp.asarray(stream[:, i:i + 1]),
                                    cache, jnp.int32(toks.shape[1] + i),
                                    eng.act_bits, attn_impl="ref")
    top = np.sort(np.asarray(logits[b, -1], np.float32))
    return float(top[-1] - top[-2])


def assert_streams_agree(got, want, gap_of):
    """Equal, or first different where the reference's top-2 gap is below
    the logits tolerance."""
    assert got.shape == want.shape
    diff = np.argwhere(got != want)
    if diff.size == 0:
        return
    t = int(diff[:, 1].min())
    for b in np.unique(diff[diff[:, 1] == t][:, 0]):
        gap = gap_of(int(b), t)
        assert gap < LOGIT_ATOL, (b, t, gap)


@pytest.mark.parametrize("store", ["fake", "packed"])
def test_generate_greedy_matches_reference(setup, jax_runs, store):
    jeng, want = jax_runs[store]
    eng = _port_engine(setup, store)
    got = eng.generate(setup["toks"], N_NEW)
    assert got["tokens"].dtype == np.int32
    assert_streams_agree(
        got["tokens"], want,
        lambda b, t: _reference_gap(jeng, setup["toks"], want, b, t))
    assert got["top2_gap"].shape == (N_NEW, 2)
    if np.array_equal(got["tokens"], want):      # same path, same gaps
        gap = _reference_gap(jeng, setup["toks"], want, 1, 2)
        np.testing.assert_allclose(got["top2_gap"][2, 1], gap,
                                   atol=2 * LOGIT_ATOL)
    assert eng.weight_hbm_bytes() == jeng.weight_hbm_bytes()


def test_generate_ref_attention_matches_cuda_path(setup):
    """The escape hatch and the kernel path agree inside the port."""
    a = _port_engine(setup, "packed").generate(setup["toks"], N_NEW)
    b = _port_engine(setup, "packed", attn_impl="ref").generate(
        setup["toks"], N_NEW)
    np.testing.assert_allclose(a["prefill_logits"].numpy(),
                               b["prefill_logits"].numpy(),
                               rtol=LOGIT_ATOL, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_packed_streams_equal_fake_streams(setup, kv_bits):
    """QBN <= 8 channels quantize on the same grid in both stores, so the
    packed store serves the fake store's streams (test_packed.py:187)."""
    graph = setup["tgraph"]
    pol = QuantPolicy(QuantMode.QUANT,
                      _bits(graph.layers, [0, 2, 3, 4, 5, 8], 2),
                      {l.name: 8.0 for l in graph.layers})
    outs = {}
    for store in ("fake", "packed"):
        eng = ServeEngine(setup["tm"], setup["tp"], policy=pol, graph=graph,
                          max_len=MAX_LEN, weight_store=store,
                          kv_bits=kv_bits, device="cpu")
        outs[store] = eng.generate(setup["toks"], N_NEW)
        outs[store + "_bytes"] = eng.weight_hbm_bytes()
    np.testing.assert_array_equal(outs["packed"]["tokens"],
                                  outs["fake"]["tokens"])
    assert outs["packed_bytes"]["total"] < 0.5 * outs["fake_bytes"]["total"]


def test_sampled_generate_is_seeded(setup):
    """Sampling draws from a torch.Generator seeded per call: the same seed
    repeats its stream (threefry's stream is not reproduced)."""
    eng = _port_engine(setup, "fake")
    a = eng.generate(setup["toks"], N_NEW, temperature=1.0, seed=3)
    b = eng.generate(setup["toks"], N_NEW, temperature=1.0, seed=3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < eng.model.cfg.vocab


def test_engine_rejects_bad_options(setup):
    with pytest.raises(ValueError):
        _port_engine(setup, "fake", attn_impl="pallas")
    with pytest.raises(ValueError):
        _port_engine(setup, "fake", kv_bits=4)
    eng = _port_engine(setup, "fake")
    toks = setup["toks"][0].astype(np.int32)
    for bad, match in ((dict(draft_k=0), "draft_k"),
                       (dict(draft_policy="oracle"), "draft_policy"),
                       (dict(draft_policy="lowbit", draft_layers=1),
                        "draft_layers"),
                       (dict(draft_layers=99), "draft_layers"),
                       (dict(draft_act_bits=2.0), "draft_act_bits"),
                       (dict(prefill="monolithic"), "chunked")):
        with pytest.raises(ValueError, match=match):
            eng.run([(toks, 2)], speculative=True, **bad)
    # binarized policies: the fake store serves fake-binarized weights (as
    # the reference's does); the packed store is linear quantization only
    bpol = QuantPolicy(QuantMode.BINARIZE, setup["tpol"].weight_bits,
                       setup["tpol"].act_bits)
    with pytest.raises(ValueError, match="linear quantization"):
        ServeEngine(setup["tm"], setup["tp"], policy=bpol,
                    graph=setup["tgraph"], weight_store="packed",
                    device="cpu")
    from repro_torch.quant.binarize import fake_binarize_per_channel
    eng = ServeEngine(setup["tm"], setup["tp"], policy=bpol,
                      graph=setup["tgraph"], device="cpu")
    layer = setup["tgraph"].layers[0]
    np.testing.assert_array_equal(
        eng.params["blocks"][0]["wq"].numpy(),
        fake_binarize_per_channel(setup["tp"]["blocks"][0]["wq"],
                                  bpol.expand_weight_bits(layer)).numpy())
