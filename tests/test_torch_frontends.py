"""The audio front end (musicgen) and the cross-attention "memory" caches
(llama-3.2-vision) in the port, against the JAX reference on the CPU.

Smoke configs, the reference's initialized parameters carried across with
``interop.params_from_numpy``, seeded numpy inputs: frame embeddings
(``batch["embeds"]``) for musicgen-smoke, tokens and image embeddings
(``batch["img_embeds"]``) for llama32v-smoke, both scaled by 0.3 as
tests/test_models.py:18 scales its inputs.  Tolerances:

* logits and losses: ``LOGIT_TOL`` rtol = atol = 1e-4 (f32 on both sides,
  summation order only), over fp32 dense caches and pools;
* over bf16 and int8 dense caches (and bf16 pools): ``NARROW_LOGIT_ATOL``
  = 1e-2, tests/test_torch_bf16_cache.py's ``BF16_LOGIT_ATOL``: both
  packages round the same K/V, but their f32 K/V differ at f32 rounding,
  so now and then an element rounds to the neighbouring bf16 value or
  int8 step (amax / 127); on llama32v-smoke's int8 cache that moved a
  logit by 5.2e-4 (the reference's own int8-KV test allows 0.05 at
  prefill and 0.2 at decode);
* prefill + decode against the full forward inside the port: max abs
  error < 1e-3 (tests/test_models.py:45-69);
* gradients: ``GRAD_TOL`` rtol 1e-4, atol 1e-5, elementwise
  (tests/test_torch_train.py), as the attention families are held.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.quant.apply import apply_policy_to_params as japply  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro.serve import paged_kv as jpkv  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa
from repro_torch.kernels.pack import PackedWeight  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.quant.apply import apply_policy_packed  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import paged_kv as tpkv  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NARROW_LOGIT_ATOL = 1e-2
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
AUDIO, VISION = "musicgen-large", "llama-3.2-vision-90b"
SENT = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch):
    jm = JLM(JARCHS[arch].smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, LM(ARCHS[arch].smoke), params_from_numpy(_np(jp), "cpu")


def _inputs(cfg, B, S, seed=0):
    """Numpy inputs of S positions: frame embeddings for the audio front
    end, else tokens and image embeddings; plus labels."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.frontend == "audio_stub":
        out["embeds"] = (0.3 * rng.standard_normal((B, S, cfg.d_model))
                         ).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(B, S)
                                     ).astype(np.int32)
        out["img_embeds"] = (0.3 * rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model))).astype(np.float32)
    return out


def _prefix(cfg, batch, n):
    """The model inputs of the first n positions (no labels)."""
    key = "embeds" if cfg.frontend == "audio_stub" else "tokens"
    out = {key: batch[key][:, :n]}
    if "img_embeds" in batch:
        out["img_embeds"] = batch["img_embeds"]
    return out


def _step(cfg, batch, i):
    """Decode input at position i: a (B, 1, d) frame or a (B, 1) token."""
    key = "embeds" if cfg.frontend == "audio_stub" else "tokens"
    return batch[key][:, i:i + 1]


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tt(b):
    return {k: _t(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", [AUDIO, VISION])
def test_apply_and_loss_match_reference(arch):
    """The full forward at every position and the loss; the audio tree
    carries no embedding table, as the reference's."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    assert ("embed" in tp) == (cfg.frontend != "audio_stub")
    assert sorted(tm.init(0, device="cpu")) == sorted(tp)
    batch = _inputs(cfg, 2, 12)
    jl, _ = jax.jit(jm.apply)(jp, _j(_prefix(cfg, batch, 12)))
    tl, aux = tm.apply(tp, _tt(_prefix(cfg, batch, 12)))
    assert aux == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jloss = jax.jit(jm.loss)(jp, _j(batch))
    np.testing.assert_allclose(float(tm.loss(tp, _tt(batch))), float(jloss),
                               **LOGIT_TOL)


@pytest.mark.parametrize("arch,cache", [
    (AUDIO, "float32"), (AUDIO, "bfloat16"), (AUDIO, "int8"),
    (VISION, "float32"), (VISION, "bfloat16"), (VISION, "int8")])
def test_prefill_decode_match_reference(arch, cache):
    """prefill of 8 positions then 4 decode steps over a dense cache in
    both packages (frames for audio; for vision the image memory written
    whole at prefill and read back at decode): every step's logits, and
    the cross blocks' memory planes."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    B, Sp, S = 2, 8, 12
    kv_bits = 8 if cache == "int8" else None
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16)}.get(
        cache, (jnp.float32, torch.float32))
    tol = LOGIT_TOL if cache == "float32" else \
        dict(rtol=0, atol=NARROW_LOGIT_ATOL)
    batch = _inputs(cfg, B, S, seed=1)
    jc = jm.init_cache(B, S, dtype=jdt, kv_bits=kv_bits)
    tc = tm.init_cache(B, S, dtype=tdt, kv_bits=kv_bits, device="cpu")
    jl, jc = jax.jit(jm.prefill)(jp, _j(_prefix(cfg, batch, Sp)), jc)
    tl, tc = tm.prefill(tp, _tt(_prefix(cfg, batch, Sp)), tc,
                        attn_impl="cuda")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    jdec = jax.jit(jm.decode_step)
    for i in range(Sp, S):
        x = _step(cfg, batch, i)
        jl, jc = jdec(jp, jnp.asarray(x), jc, jnp.int32(i))
        tl, tc = tm.decode_step(tp, _t(x), tc, i, attn_impl="cuda")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for kind, jcp, tcp in zip(cfg.cache_kinds(), jc, tc):
        assert sorted(jcp) == sorted(tcp)
        if kind == "memory":
            assert "pos" not in tcp and tcp["k"].shape == \
                (cfg.n_repeat, B, cfg.n_img_tokens, cfg.n_kv_heads, cfg.hdim)
            if cache == "float32":
                for key in tcp:
                    np.testing.assert_allclose(
                        tcp[key].numpy(), np.asarray(jcp[key]), **LOGIT_TOL)


@pytest.mark.parametrize("arch", [AUDIO, VISION])
def test_prefill_decode_match_full_forward(arch):
    """Mirrors tests/test_models.py:45-69 inside the port: prefill 8, decode
    to 12, each step's logits against apply's at that position."""
    _, _, tm, tp = _pair(arch)
    cfg = tm.cfg
    batch = _inputs(cfg, 2, 12, seed=2)
    full, _ = tm.apply(tp, _tt(_prefix(cfg, batch, 12)))
    cache = tm.init_cache(2, 12, dtype=torch.float32, device="cpu")
    lg, cache = tm.prefill(tp, _tt(_prefix(cfg, batch, 8)), cache)
    assert float((lg[:, 0] - full[:, 7]).abs().max()) < 1e-3
    for i in range(8, 12):
        lg, cache = tm.decode_step(tp, _t(_step(cfg, batch, i)), cache, i)
        assert float((lg[:, 0] - full[:, i]).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", [AUDIO, VISION])
def test_loss_grads_match_reference(arch):
    """value_and_grad of LM.loss against jax.value_and_grad, every leaf at
    GRAD_TOL; remat True and "dots" give the same bits as False."""
    jm, jp, tm, tp = _pair(arch)
    batch = _inputs(jm.cfg, 2, 10, seed=3)
    batch["labels"][0, -3:] = -1
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, _j(batch))
    tb = _tt(batch)
    got = {r: value_and_grad(lambda p: tm.loss(p, tb, remat=r), tp)
           for r in (False, True, "dots")}
    tl, tg = got[False]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tleaves = [np.asarray(a) for a in jax.tree.leaves(params_to_numpy(tg))]
    jleaves = jax.tree.leaves(_np(jg))
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    assert sum(float(np.abs(a).sum()) for a in tleaves) > 0
    for r in (True, "dots"):
        assert torch.equal(got[r][0], tl)
        for a, b in zip(jax.tree.leaves(params_to_numpy(got[r][1])),
                        tleaves):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", [AUDIO, VISION])
def test_graph_block_act_bits_and_packed_store_match_reference(arch):
    """graph() emits the reference's sites (cross wk / wv MACs over the
    image tokens), block_act_bits collapses them the same way, and the
    packed store of a policy over the pruned, int2, int4 and int8 buckets,
    on the port, gives the reference's fake-quant forward at LOGIT_TOL
    (QBNs above 8 would store bf16, which fake-quant does not compute)."""
    jm, jp, tm, tp = _pair(arch)
    key = lambda g: [(l.name, l.kind, l.c_in, l.c_out, l.macs, l.numel,
                      tuple(l.param_path), l.channel_axis, l.n_groups)
                     for l in g.layers]
    jg, tg = jm.graph(seq_len=4, batch=2), tm.graph(seq_len=4, batch=2)
    assert key(tg) == key(jg)
    vals = [float(3 + i % 5) for i in range(len(jg.layers))]
    np.testing.assert_array_equal(tm.block_act_bits(tg, vals),
                                  np.asarray(jm.block_act_bits(jg, vals)))
    rng = np.random.default_rng(7)
    wbits = {l.name: rng.choice([0, 2, 3, 4, 5, 6, 8], size=l.n_groups
                                ).astype(np.float32) for l in jg.layers}
    jfake = japply(jp, jg, JPolicy(JMode.QUANT, wbits, {}))
    tpacked = apply_policy_packed(tp, tg, QuantPolicy(QuantMode.QUANT,
                                                      wbits, {}))
    assert isinstance(tpacked["blocks"][-1]["wk"], PackedWeight)
    batch = _prefix(jm.cfg, _inputs(jm.cfg, 2, 10, seed=4), 10)
    jl, _ = jax.jit(jm.apply)(jfake, _j(batch))
    tl, _ = tm.apply(tpacked, _tt(batch), attn_impl="cuda")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_quantize_params_int8_on_the_audio_tree():
    """The uniform int8 store of a tree without an embedding table: the
    reference's leaves (``q`` bit for bit, ``s`` to f32 rounding) and its
    forward at LOGIT_TOL."""
    jm, jp, tm, tp = _pair(AUDIO)
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    assert "embed" not in tq
    flat = lambda t: jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    jl, tl = flat(jq), flat(tq)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        if jax.tree_util.keystr(path).endswith("['q']"):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7,
                                       atol=0)
    batch = _prefix(jm.cfg, _inputs(jm.cfg, 2, 10, seed=5), 10)
    jlog, _ = jax.jit(jm.apply)(jq, _j(batch))
    tlog, _ = tm.apply(tq, _tt(batch))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


def _paged_setup(jm, jp, tm, tp, dtype):
    """llama32v-smoke: two requests (prompts 9 and 6, an image each)
    prefilled alone into batch-1 dense caches and written into 3-slot
    pools of both packages (slot 2 idle: sentinel position, all-trash
    table).  Returns the pools, the tables, positions and the dense
    batch-2 cache of the same two requests, for decode_step."""
    cfg, kinds = jm.cfg, jm.cfg.cache_kinds()
    rng = np.random.default_rng(6)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc = jm.init_paged_cache(3, 9, 4, dtype=jdt)
    tc = tm.init_paged_cache(3, 9, 4, dtype=dtype, device="cpu")
    bt = np.zeros((3, 4), np.int32)
    bt[0, :3] = [3, 1, 6]
    bt[1, :2] = [2, 5]
    reqs = []
    for slot, n in ((0, 9), (1, 6)):
        toks = rng.integers(0, cfg.vocab, size=(1, n)).astype(np.int32)
        img = (0.3 * rng.standard_normal((1, cfg.n_img_tokens, cfg.d_model))
               ).astype(np.float32)
        L = -(-n // 4) * 4
        b = {"tokens": toks, "img_embeds": img}
        _, jd = jax.jit(jm.prefill)(jp, _j(b), jm.init_cache(
            1, L, dtype=jdt))
        _, td = tm.prefill(tp, _tt(b), tm.init_cache(1, L, dtype=dtype,
                                                     device="cpu"))
        blocks = [int(x) for x in bt[slot, :L // 4]]
        jc = jpkv.write_prefill(jc, jd, kinds, slot, blocks, 4)
        assert tpkv.write_prefill(tc, td, kinds, slot, blocks, 4) is tc
        reqs.append(b)
    return jc, tc, bt, np.array([9, 6, SENT], np.int32), reqs, rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_paged_over_memory_entries(dtype):
    """Vision's paged decode: each cross block reads its "memory" lane,
    which write_prefill copied whole (k and v in the pool's dtype, the
    other lanes untouched).  Two decode_step_paged steps: the active
    lanes' logits against the reference's at LOGIT_TOL (fp32 pools; the
    bf16 pools at NARROW_LOGIT_ATOL), and, for the fp32 pool, against the
    port's own dense decode_step of the same requests, one at a time."""
    jm, jp, tm, tp = _pair(VISION)
    cfg, kinds = jm.cfg, jm.cfg.cache_kinds()
    jc, tc, bt, pos, reqs, rng = _paged_setup(jm, jp, tm, tp, dtype)
    for kind, tcp in zip(kinds, tc):
        if kind == "memory":
            assert sorted(tcp) == ["k", "v"] and tcp["k"].dtype == dtype
            assert not tcp["k"][:, 2].any()
    tol = LOGIT_TOL if dtype == torch.float32 else \
        dict(rtol=0, atol=NARROW_LOGIT_ATOL)
    dense = []
    for b, n in zip(reqs, (9, 6)):
        c = tm.init_cache(1, 12, dtype=torch.float32, device="cpu")
        tm.prefill(tp, _tt(b), c)
        dense.append(c)
    jdec = jax.jit(jm.decode_step_paged)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, size=(3, 1)).astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(bt),
                      jnp.asarray(pos))
        tl, tc = tm.decode_step_paged(tp, _t(tok), tc, _t(bt), _t(pos),
                                      attn_impl="cuda")
        np.testing.assert_allclose(tl.float().numpy()[:2],
                                   np.asarray(jl, np.float32)[:2], **tol)
        if dtype == torch.float32:
            for lane in range(2):
                dl, _ = tm.decode_step(tp, _t(tok[lane:lane + 1]),
                                       dense[lane], int(pos[lane]))
                np.testing.assert_allclose(tl[lane].numpy(), dl[0].numpy(),
                                           **LOGIT_TOL)
        pos = np.where(pos == SENT, SENT, pos + 1).astype(np.int32)


def test_int8_memory_defect_of_the_reference_and_the_port_refusal():
    """The reference's paged "memory" entry holds K/V in the pool's float
    type even under kv_bits=8, and its write_prefill copies only k and v:
    a kv_bits=8 dense prefill lands as raw int8 codes without their
    scales (src/repro/serve/paged_kv.py:242-244, src/repro/models/
    transformer.py:536-542), so its memory lane is not the prefill's K/V.
    The port refuses that copy with a ValueError that says why, before
    touching the pool."""
    jm, jp, tm, tp = _pair(VISION)
    cfg, kinds = jm.cfg, jm.cfg.cache_kinds()
    b = _prefix(cfg, _inputs(cfg, 1, 4, seed=8), 4)
    jd = jax.jit(jm.prefill)(jp, _j(b), jm.init_cache(1, 4, kv_bits=8))[1]
    jc = jm.init_paged_cache(2, 3, 4, dtype=jnp.float32, kv_bits=8)
    jc = jpkv.write_prefill(jc, jd, kinds, 0, [1], 4)
    m = kinds.index("memory")
    assert sorted(jc[m]) == ["k", "v"] and jc[m]["k"].dtype == jnp.float32
    codes = np.asarray(jd[m]["k"])[:, 0]
    assert codes.dtype == np.int8 and np.abs(codes).max() == 127
    lane = np.asarray(jc[m]["k"])[:, 0]
    np.testing.assert_array_equal(lane, codes.astype(np.float32))
    real = codes.astype(np.float32) * np.asarray(jd[m]["k_s"])[:, 0][..., None]
    assert np.abs(lane - real).max() > 1.0       # codes, not values
    td = tm.prefill(tp, _tt(b), tm.init_cache(1, 4, kv_bits=8,
                                              device="cpu"))[1]
    tc = tm.init_paged_cache(2, 3, 4, dtype=torch.float32, kv_bits=8,
                             device="cpu")
    assert sorted(tc[m]) == ["k", "v"] and tc[m]["k"].dtype == torch.float32
    before = [{k: v.clone() for k, v in e.items()} for e in tc]
    with pytest.raises(ValueError, match="int8.*without their scales"):
        tpkv.write_prefill(tc, td, kinds, 0, [1], 4)
    for e, w in zip(tc, before):
        assert all(torch.equal(e[k], w[k]) for k in e)


def test_init_paged_cache_matches_reference():
    """Per kind, the reference's planes and dtypes: "paged" pools (int8
    with scale pages under kv_bits=8) beside a dense "memory" entry in the
    pool's float type with batch axis n_slots."""
    jm, jp, tm, tp = _pair(VISION)
    for kv_bits in (None, 8):
        jc = jm.init_paged_cache(3, 7, 4, dtype=jnp.bfloat16, kv_bits=kv_bits)
        tc = tm.init_paged_cache(3, 7, 4, kv_bits=kv_bits, device="cpu")
        for jcp, tcp in zip(jc, tc):
            assert sorted(jcp) == sorted(tcp)
            for key in jcp:
                assert tuple(tcp[key].shape) == jcp[key].shape
                assert str(tcp[key].dtype).split(".")[-1] == \
                    str(jcp[key].dtype)
    with pytest.raises(ValueError, match="all-paged|pure paged"):
        z = np.zeros((1, 2), np.int32)
        tm.model_step(tp, torch.zeros((1, 2), dtype=torch.int64),
                      tm.step_layout(z, z[:, 0], z[:, :1]).upload("cpu"),
                      tm.init_paged_cache(1, 3, 4, device="cpu"),
                      torch.zeros(1, dtype=torch.int32))


def test_cross_block_is_noncausal_and_ignores_rope():
    """Every query of a cross block attends every image token: the
    forward does not change when the positions of the text move (no RoPE
    on a cross block, keys all at position 0), and reversing the image
    tokens leaves it unchanged too (no causal order among them)."""
    _, _, tm, tp = _pair(VISION)
    cfg = dataclasses.replace(tm.cfg, n_layers=1,
                              pattern=tm.cfg.pattern[-1:])
    m1 = LM(cfg)
    p1 = {**tp, "blocks": tp["blocks"][-1:]}
    batch = _tt(_prefix(cfg, _inputs(cfg, 2, 6, seed=9), 6))
    base, _ = m1.apply(p1, batch)
    flipped = dict(batch, img_embeds=batch["img_embeds"].flip(1))
    np.testing.assert_allclose(m1.apply(p1, flipped)[0].numpy(),
                               base.numpy(), rtol=1e-5, atol=1e-5)
    c = m1.init_cache(2, 6, dtype=torch.float32, device="cpu")
    m1.prefill(p1, {k: v[:, :1] if k == "tokens" else v
                    for k, v in batch.items()}, c)
    a, _ = m1.decode_step(p1, batch["tokens"][:, 1:2], c, 1)
    b, _ = m1.decode_step(p1, batch["tokens"][:, 1:2], c, 5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
