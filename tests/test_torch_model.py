"""The PyTorch port's LM forward against the JAX reference, on the CPU.

The reference's initialized parameters cross over as numpy arrays
(``interop.params_from_numpy``); both packages then run ``prefill`` and
a few ``decode_step`` calls on the same tokens.  Logits must agree to
rtol = atol = 1e-4 (test_packed.py's tolerance: both sides compute in f32
and differ only in summation order).  The port attends through its flash
wrapper (``attn_impl="cuda"``, the plain version on CPU tensors) or the
chunked scan (``"ref"``); the reference through its jnp oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.configs import ARCHS, get  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import LM  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, seed=0):
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, LM(ARCHS[arch].smoke), tp


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_interop_round_trips_smoke_params(arch):
    """Every leaf arrives with the reference's shape, dtype and values."""
    jm, jp, tm, tp = _pair(arch)
    jl = jax.tree.leaves(jp)
    tl = jax.tree.leaves(tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the port's own init draws the same shapes
    own = jax.tree.leaves(tm.init(0, device="cpu"),
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [tuple(t.shape) for t in own] == [tuple(t.shape) for t in tl]


@pytest.mark.parametrize("arch,kv_bits,impl,act", [
    ("gemma2-2b", None, "cuda", None),      # prompt 12 > window 8: ring
    ("gemma2-2b", 8, "ref", 6.0),           # int8 KV, act QBNs
    ("internlm2-20b", None, "ref", None),
    ("internlm2-20b", 8, "cuda", 8.0),
    ("phi4-mini-3.8b", None, "cuda", None),   # G = 3
    ("starcoder2-7b", None, "cuda", None),
])
def test_prefill_decode_logits_match_reference(arch, kv_bits, impl, act):
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    B, S, n_dec, max_len = 2, 12, 3, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    j_act = t_act = None
    if act is not None:
        j_act = jnp.full((cfg.n_repeat, len(cfg.pattern)), act, jnp.float32)
        t_act = np.full((cfg.n_repeat, len(cfg.pattern)), act, np.float32)
    jc = jm.init_cache(B, max_len, dtype=jnp.float32, kv_bits=kv_bits)
    tc = tm.init_cache(B, max_len, dtype=torch.float32, kv_bits=kv_bits,
                       device="cpu")
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc, j_act)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                        t_act, attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jdec = jax.jit(jm.decode_step)
    for i in range(n_dec):
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.int32(S + i), j_act)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc, S + i,
                                t_act, attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    # the caches hold the same positions (ring order included)
    for jcp, tcp in zip(jc, tc):
        np.testing.assert_array_equal(tcp["pos"].numpy(),
                                      np.asarray(jcp["pos"]))


@pytest.mark.parametrize("arch,impl", [("gemma2-2b", "cuda"),
                                       ("internlm2-20b", "ref")])
def test_apply_logits_match_reference(arch, impl):
    """The full-sequence forward (the LM evaluator's) == the reference's
    ``apply`` at every position (prompt 12 > gemma2-smoke's window 8)."""
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab, size=(2, 12)).astype(np.int32)
    jl, _ = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                       attn_impl=impl)
    assert aux == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_block_act_bits_and_graph_match_reference():
    from repro.quant.policy import QuantPolicy as JPolicy
    jm = JLM(JARCHS["gemma2-2b"].smoke)
    tm = LM(ARCHS["gemma2-2b"].smoke)
    jg, tg = jm.graph(seq_len=4, batch=2), tm.graph(seq_len=4, batch=2)
    assert [(l.name, l.c_in, l.c_out, l.macs, l.numel, l.param_path,
             l.n_groups) for l in jg.layers] == \
        [(l.name, l.c_in, l.c_out, l.macs, l.numel, l.param_path,
          l.n_groups) for l in tg.layers]
    vals = [float(3 + i % 5) for i in range(len(jg.layers))]
    np.testing.assert_array_equal(tm.block_act_bits(tg, vals),
                                  np.asarray(jm.block_act_bits(jg, vals)))
    from repro_torch.quant.policy import QuantPolicy as TPolicy
    jp, tp = JPolicy.uniform(jg, 3.0), TPolicy.uniform(tg, 3.0)
    assert tp.logic_ops(tg) == jp.logic_ops(jg)
    assert tp.model_size_bits(tg) == jp.model_size_bits(jg)


def test_unported_families_name_their_roadmap_item():
    """The vision and audio families, and a cross-attention block or an
    audio front end on a ported family, raise naming their own item."""
    with pytest.raises(NotImplementedError, match="A10.*cross-attention"):
        get("llama-3.2-vision-90b")
    with pytest.raises(NotImplementedError, match="A10.*audio_stub"):
        get("musicgen-large")
    import dataclasses
    from repro_torch.configs.base import dense
    smoke = ARCHS["gemma2-2b"].smoke
    tm = LM(dataclasses.replace(smoke, pattern=(dense("cross_attn"),)))
    with pytest.raises(NotImplementedError, match="A10.*cross-attention"):
        tm.init(0, device="cpu")
    tm = LM(dataclasses.replace(smoke, frontend="audio_stub"))
    with pytest.raises(NotImplementedError, match="A10.*audio_stub"):
        tm.init(0, device="cpu")
    with pytest.raises(KeyError):
        get("no-such-arch")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
def test_moe_families_no_longer_raise(arch):
    """The MoE families left the unported list: the registry hands them
    out and the model builds, runs and graphs them."""
    spec = get(arch)
    assert spec.family == "moe"
    tm = LM(spec.smoke)
    tp = tm.init(0, device="cpu")
    logits, aux = tm.apply(tp, {"tokens": torch.zeros((1, 4),
                                                      dtype=torch.int64)})
    assert logits.shape == (1, 4, spec.smoke.vocab_padded)
    assert float(aux) > 0
    assert {l.kind for l in tm.graph(seq_len=4, batch=1).layers} >= \
        {"expert"}
