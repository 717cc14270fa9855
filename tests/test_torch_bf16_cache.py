"""bf16 KV caches and pools in the port, on the CPU.

* Dense bf16 cache: prefill and decode logits against the reference's
  bf16 cache (``init_cache(dtype=bfloat16)``).  Both round the same K/V
  to bf16, but their f32 K/V differ at f32 rounding, so now and then an
  element rounds to the neighbouring bf16 value (one bf16 ulp, 2^-8 of
  it): on gemma2-smoke that moves a logit by ~1e-3.  Logits are held to
  ``BF16_LOGIT_ATOL`` = 1e-2 (the reference's own int8-KV test allows
  0.05 at prefill and 0.2 at decode); the caches to one bf16 ulp plus
  the same atol (a decode token's K/V inherit the ~1e-3 difference of
  the hidden state they come from).
* The engine: ``cache_dtype`` defaults to fp32; with bf16 pools
  run() == generate() per request, in both prefill modes (mirrors
  tests/test_paged_kv.py:306-317): dense prefill attends the bf16 round
  trip of its K/V, the values the chunked path reads back.
* K1's and K4's plain versions (and the plain statements of their card
  walks) on bf16 K/V equal, bit for bit, their results on the K/V
  upcast to fp32: the kernels convert bf16 to fp32 exactly as they load
  it and compute in fp32 from there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import attention, ref  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.layers import paged_attention_ref  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

BF16_LOGIT_ATOL = 1e-2
SENT = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch,impl", [("gemma2-2b", "cuda"),
                                       ("granite-moe-3b-a800m", "ref")])
def test_bf16_dense_cache_matches_reference(arch, impl):
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tm = LM(ARCHS[arch].smoke)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jm.cfg.vocab, size=(2, 12)).astype(np.int32)
    jc = jm.init_cache(2, 16, dtype=jnp.bfloat16)
    tc = tm.init_cache(2, 16, device="cpu")          # the default: bf16
    assert tc[0]["k"].dtype == torch.bfloat16
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, tc,
                        attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=BF16_LOGIT_ATOL)
    jdec = jax.jit(jm.decode_step)
    for i in range(3):
        tok = rng.integers(0, jm.cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.int32(12 + i))
        tl, tc = tm.decode_step(tp, _t(tok).long(), tc, 12 + i,
                                attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=BF16_LOGIT_ATOL)
    for jcp, tcp in zip(jc, tc):
        np.testing.assert_array_equal(tcp["pos"].numpy(),
                                      np.asarray(jcp["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tcp[key].float().numpy(),
                np.asarray(jcp[key]).astype(np.float32), rtol=2.0**-8,
                atol=BF16_LOGIT_ATOL)


def test_engine_cache_dtype_defaults_to_fp32_and_threads_through():
    m = LM(ARCHS["internlm2-20b"].smoke)
    params = m.init(0, device="cpu")
    eng = ServeEngine(m, params, max_len=16, device="cpu")
    assert eng.cache_dtype == torch.float32
    pool, _, _ = eng._session(4, 2, None)
    assert pool[0]["k"].dtype == torch.float32
    eng = ServeEngine(m, params, max_len=16, cache_dtype=torch.bfloat16,
                      device="cpu")
    pool, _, _ = eng._session(4, 2, None)
    assert pool[0]["k"].dtype == torch.bfloat16
    # kv_bits=8 wins over cache_dtype, as in the reference
    eng = ServeEngine(m, params, max_len=16, cache_dtype=torch.bfloat16,
                      kv_bits=8, device="cpu")
    pool, _, _ = eng._session(4, 2, None)
    assert pool[0]["k"].dtype == torch.int8
    with pytest.raises(ValueError, match="cache_dtype"):
        ServeEngine(m, params, cache_dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="cache dtype"):
        m.init_cache(1, 8, dtype=torch.float16, device="cpu")


@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_run_matches_generate_bf16_pool(prefill):
    """Mirrors tests/test_paged_kv.py:306-317 (internlm2-smoke, a bf16
    cache and pool), on the port's default attention path."""
    cfg = ARCHS["internlm2-20b"].smoke
    m = LM(cfg)
    eng = ServeEngine(m, m.init(0, device="cpu"), max_len=32,
                      cache_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(41)
    reqs = [(rng.integers(0, cfg.vocab, size=s).astype(np.int32), n)
            for s, n in [(3, 5), (7, 4), (5, 6), (9, 3)]]
    res = eng.run(reqs, page_size=4, max_slots=2, prefill=prefill)
    for i, ((toks, n), out) in enumerate(zip(reqs, res["outputs"])):
        want = eng.generate(toks[None], n)["tokens"][0]
        np.testing.assert_array_equal(out, want, err_msg=f"request {i}")


def test_plain_attention_versions_on_bf16_equal_their_fp32_upcast():
    rng = np.random.default_rng(3)
    B, Sq, Hq, Hkv, D, S = 2, 5, 4, 2, 16, 70
    q = _t(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32))
    k = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32)).bfloat16()
    v = _t(rng.normal(size=(B, S, Hkv, D)).astype(np.float32)).bfloat16()
    kv_pos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    q_pos = kv_pos[:, -Sq:].contiguous()
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=40, attn_cap=20.0)
    for fn in (attention.flash_attention, ref.attention_tf32x3_ref,
               lambda *a, **k_: ref.attention_split_ref(*a, **k_,
                                                        n_splits=3)):
        assert torch.equal(fn(q, k, v, **kw),
                           fn(q, k.float(), v.float(), **kw))
    # K4 over a paged pool with a shuffled block table and a sentinel tail
    P, ps, nb = 9, 4, 5
    kp = _t(rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)).bfloat16()
    vp = _t(rng.normal(size=(P, ps, Hkv, D)).astype(np.float32)).bfloat16()
    pos = torch.full((P, ps), SENT, dtype=torch.int32)
    bt = torch.tensor([[3, 1, 6, 8, 0], [2, 5, 7, 0, 0]], dtype=torch.int32)
    for b, L in enumerate((18, 11)):
        for p in range(L):
            pos[bt[b, p // ps], p % ps] = p
    qp = torch.tensor([[15, 16, 17], [10, SENT, SENT]], dtype=torch.int32)
    qk = _t(rng.normal(size=(B, 3, Hq, D)).astype(np.float32))
    pkw = dict(q_pos=qp, window=8, attn_cap=20.0)
    for fn in (attention.paged_prefill_attention, paged_attention_ref,
               lambda *a, **k_: ref.paged_attention_split_ref(
                   *a, **k_, n_splits=2, mm=ref.einsum_tf32x3)):
        assert torch.equal(fn(qk, kp, vp, pos, bt, **pkw),
                           fn(qk, kp.float(), vp.float(), pos, bt, **pkw))
    # any other K/V type is refused
    with pytest.raises(ValueError, match="bfloat16"):
        attention.flash_attention(q, k.half(), v.half(), q_pos=q_pos,
                                  kv_pos=kv_pos)
    with pytest.raises(ValueError, match="bfloat16"):
        attention.paged_prefill_attention(qk, kp.half(), vp.half(), pos, bt,
                                          q_pos=qp)
