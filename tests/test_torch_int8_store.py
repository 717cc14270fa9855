"""The uniform int8 weight store (``LM.quantize_params_int8``) in the port
against the JAX reference, on the CPU.

The transform must give the reference's leaves: ``q`` bit for bit, ``s``
to f32 rounding.  Forwards on the stored weights run K2's plain version
(``layers.linear`` and ``expert_linear`` on ``{"q", "s"}`` leaves, the
embedding a row gather times its scale) and must match the reference's
dequantize-at-use forward to rtol = atol = 1e-4.  The reference's own
check that int8 weights track fp (tests/test_quant_serving.py:13-32, mean
|lf - lq| / std(lf) < 0.35) holds for the port too, and the engine serves
such params with run() == generate().
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.quant import linear_quant as jlq  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.quant import dequant_int8, quant_pack_int8  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH_IDS = ["internlm2-20b", "granite-moe-3b-a800m"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch):
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, LM(ARCHS[arch].smoke), tp


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quantize_params_int8_leaves_match_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    jl, tl = _leaves(jq), _leaves(tq)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    n_q = 0
    for (path, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype and b.shape == a.shape
        if jax.tree_util.keystr(path).endswith("['q']"):
            n_q += 1
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-7, atol=0)
    assert n_q > 0
    # stacked leaves keep their leading (repeat, expert) dims; embedding
    # rows and every other weight's output channels carry the scales
    assert tq["embed"]["s"].shape == (tm.cfg.vocab_padded, 1)
    wg = tq["blocks"][0]["wg"]
    assert wg["s"].shape[:-2] == wg["q"].shape[:-2]
    assert wg["s"].shape[-2:] == (1, wg["q"].shape[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_int8_store_forward_matches_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, size=(2, 10))
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    jl, _ = jax.jit(jm.apply)(jq, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.apply(tq, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the reference's own int8 tree carries across through interop
    carried = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert torch.equal(tm.apply(carried, {"tokens": _t(toks)})[0], tl)
    # and the relation to the fp forward the reference's test holds
    lf, _ = tm.apply(tp, {"tokens": _t(toks)})
    rel = float((lf - tl).abs().mean() / torch.clamp(lf.std(), min=1e-6))
    assert rel < 0.35, rel


def test_quant_pack_int8_and_dequant_match_reference():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 40, 24)).astype(np.float32)
    w[..., 5] = 0.0                                   # an all-zero channel
    bits = rng.choice([0.0, 1.0, 3.0, 5.0, 8.0, 12.0], size=24).astype(
        np.float32)
    for axis in (-1, 1):
        b = bits if axis == -1 else bits[:1].repeat(40)
        jq, js, jb = jlq.quant_pack_int8(jnp.asarray(w), jnp.asarray(b),
                                         axis=axis)
        tq, ts, tb = quant_pack_int8(_t(w), _t(b), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                                   atol=0)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_allclose(
            dequant_int8(tq, ts).numpy(),
            np.asarray(jlq.dequant_int8(jq, js)), rtol=1e-7, atol=0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_int8_store_run_matches_generate(arch):
    """The engine serves already-transformed params as the reference's
    does (no new weight_store): run() == generate() per request, and the
    int8 leaves are counted as such."""
    cfg = ARCHS[arch].smoke
    m = LM(cfg)
    params = m.quantize_params_int8(m.init(0, device="cpu"))
    eng = ServeEngine(m, params, max_len=32, device="cpu")
    hbm = eng.weight_hbm_bytes()
    assert hbm["int8"] > 0 and hbm["packed"] == 0
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab, size=s).astype(np.int32), n)
            for s, n in [(3, 5), (9, 4), (6, 3), (2, 5)]]
    res = eng.run(reqs, page_size=4, max_slots=2)
    for i, ((toks, n), out) in enumerate(zip(reqs, res["outputs"])):
        want = eng.generate(toks[None], n)["tokens"][0]
        np.testing.assert_array_equal(out, want, err_msg=f"request {i}")
