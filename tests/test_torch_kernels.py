"""Kernel modules of the PyTorch port against the JAX reference, on the CPU.

On CPU tensors each port wrapper runs its plain version; the reference runs
its Pallas kernels in interpret mode.  Both get the same numpy inputs.
Tolerances are the reference tests' own: ``TOL`` of test_attention.py for
attention (f32 online-softmax rescale rounding), rtol = atol = 1e-4 of
test_packed.py for the GEMMs (the kernels scale the accumulator, the plain
versions the weight).  Packing and fake-quant are integer or exactly
rounded f32 steps, so they must match bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import attention as jattn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack as jpack  # noqa: E402
from repro.models.transformer import POS_SENTINEL  # noqa: E402
from repro.quant import linear_quant as jlq  # noqa: E402
from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pack as tpack  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.quant import linear_quant as tlq  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- attention K1
@pytest.mark.parametrize("B,Sq,Skv,hkv,g,window,cap,n_sent", [
    (2, 1, 23, 2, 2, None, None, 0),      # decode, GQA 2
    (2, 1, 30, 1, 4, 5, 30.0, 6),         # decode, sentinel tail, window
    (1, 9, 9, 2, 1, None, 30.0, 0),       # prefill, MHA, cap
    (2, 12, 12, 1, 4, 5, None, 0),        # prefill, GQA 4, window
    (2, 7, 19, 2, 2, 5, 30.0, 3),         # chunk past a prefix + sentinels
    (1, 16, 16, 2, 4, None, None, 0),     # several q and kv tiles
])
def test_flash_attention_plain_matches_reference(B, Sq, Skv, hkv, g, window,
                                                 cap, n_sent):
    """The port's flash-attention wrapper (its plain version on CPU) and
    the chunked scan it wraps == the reference kernel in interpret mode."""
    rng = np.random.default_rng(Sq * 100 + Skv)
    D = 8
    q = rng.normal(size=(B, Sq, hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, hkv, D)).astype(np.float32)
    n_real = Skv - n_sent
    q_pos = np.broadcast_to(np.arange(n_real - Sq, n_real, dtype=np.int32),
                            (B, Sq)).copy()
    kv_pos = np.full((B, Skv), POS_SENTINEL, np.int32)
    kv_pos[:, :n_real] = np.arange(n_real, dtype=np.int32)
    ref = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), window=window,
        attn_cap=cap, bq=8, bk=8)
    args = dict(q_pos=_t(q_pos), kv_pos=_t(kv_pos), window=window,
                attn_cap=cap)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), **args)
    chunked = tlayers.attention_ref(_t(q), _t(k), _t(v), chunk=7, **args)
    assert tattn.COUNT.launches == 0          # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref), **TOL)


def test_flash_attention_wrapper_validates():
    q = torch.zeros(1, 2, 4, 8)
    k = torch.zeros(1, 3, 2, 8)
    pos = torch.zeros(1, 2, dtype=torch.int32)
    kvp = torch.zeros(1, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, k, q_pos=pos.long(), kv_pos=kvp)
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, k, q_pos=pos, kv_pos=kvp[:, :2])
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k.transpose(1, 2), k, q_pos=pos, kv_pos=kvp)


# ------------------------------------------------- K1 split-KV decode
@pytest.mark.parametrize("B,hkv,g,Skv,n_real,window,cap,n_splits", [
    (2, 2, 2, 150, 150, None, None, 3),     # decode, GQA 2
    (2, 1, 4, 224, 40, None, None, 7),      # sentinel tail: splits 2-6 empty
    (1, 2, 2, 224, 200, 40, None, 3),       # window kills the leading splits
    (2, 2, 2, 100, 97, None, 30.0, 1),      # softcap, one split
    (1, 2, 2, 224, 180, 64, 30.0, 7),       # one split per tile
])
def test_attention_split_ref_matches_reference(B, hkv, g, Skv, n_real,
                                               window, cap, n_splits):
    """The plain statement of K1's split walk and merge == the reference
    kernel in interpret mode, at TOL."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels.ref import attention_split_ref
    rng = np.random.default_rng(Skv * 10 + n_splits)
    D = 8
    q = rng.normal(size=(B, 1, hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, hkv, D)).astype(np.float32)
    q_pos = np.full((B, 1), n_real - 1, np.int32)
    kv_pos = np.full((B, Skv), POS_SENTINEL, np.int32)
    kv_pos[:, :n_real] = np.arange(n_real, dtype=np.int32)
    ref = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), window=window,
        attn_cap=cap, bq=8, bk=32)
    got = attention_split_ref(_t(q), _t(k), _t(v), q_pos=_t(q_pos),
                              kv_pos=_t(kv_pos), window=window, attn_cap=cap,
                              n_splits=n_splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    tiles = ka.split_tiles(Skv, n_splits)
    assert len(tiles) == n_splits and tiles[-1][1] == -(-Skv // ka.BKV)


def test_decode_splits_rule():
    """gemma2-2b decode at B = 2 fills the 132 SMs of an H100; prefill and
    the LM evaluator's 4 x 128 forward keep the single walk; the splits
    never outnumber the tiles and none is empty."""
    from repro_torch.kernels.attention import decode_splits, split_tiles
    ns = decode_splits(2, 1, 8, 4, 4224, 132)
    assert ns * 4 * 2 >= 132 and ns == 33
    assert decode_splits(2, 4160, 8, 4, 4224, 132) == 1
    assert decode_splits(4, 128, 8, 4, 128, 132) == 1
    assert decode_splits(33, 1, 8, 4, 4224, 132) == 1     # grid fills the card
    assert decode_splits(1, 1, 4, 4, 20, 132) == 1        # one tile
    for B in (1, 2, 3, 8):
        for Skv in (33, 100, 640, 4096, 4224, 9999):
            for Hq, Hkv in ((8, 4), (8, 1), (4, 4), (32, 8)):
                for Sq in (1, 2, 5):
                    n = decode_splits(B, Sq, Hq, Hkv, Skv, 132)
                    n_tiles = -(-Skv // 32)
                    assert 1 <= n <= n_tiles
                    if Sq > 32 // (Hq // Hkv):
                        assert n == 1
                    assert all(t1 > t0 for t0, t1 in split_tiles(Skv, n))


# ------------------------------------------------------------- GEMMs K2/K3
SHAPES = [(5, 37, 19), (16, 130, 70), (1, 96, 257)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_quant_matmul_plain_matches_reference(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = rng.uniform(0.001, 0.01, size=(N,)).astype(np.float32)
    ref = jops.quant_matmul(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s))
    got = tops.quant_matmul(_t(x), _t(qw), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GEMM_TOL)


@pytest.mark.parametrize("store_bits", [2, 4])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_packed_matmul_plain_matches_reference(store_bits, M, K, N):
    rng = np.random.default_rng(M * K + N + store_bits)
    lv = 2 ** (store_bits - 1) - 1
    q = rng.integers(-lv, lv + 1, size=(K, N)).astype(np.int32)
    pw = np.asarray(jpack.pack_sub8(jnp.asarray(q), store_bits, axis=0))
    x = rng.normal(size=(M, K)).astype(np.float32)
    s = rng.uniform(0.01, 0.1, size=(N,)).astype(np.float32)
    ref = jops.packed_matmul(jnp.asarray(x), jnp.asarray(pw), jnp.asarray(s),
                             store_bits=store_bits)
    got = tops.packed_matmul(_t(x), _t(pw), _t(s), store_bits=store_bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GEMM_TOL)


@pytest.mark.parametrize("M,K,N", [(3, 45, 33), (12, 64, 90)])
def test_packed_mixed_matmul_matches_reference(M, K, N):
    """Every bucket (pruned, int2, int4, int8, full) in one weight."""
    from repro_torch.interop import params_from_numpy
    rng = np.random.default_rng(K * N)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    bits = rng.choice([0, 2, 3, 4, 6, 8, 16], size=N).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jw = jlq.quant_pack_sub8(jnp.asarray(w), bits)
    ref = jops.packed_mixed_matmul(jnp.asarray(x), jw)
    tw = params_from_numpy(jw, "cpu")
    got = tops.packed_mixed_matmul(_t(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GEMM_TOL)
    own = tops.packed_mixed_matmul(_t(x), tlq.quant_pack_sub8(_t(w), bits))
    np.testing.assert_array_equal(own.numpy(), got.numpy())


# ------------------------------------------------------- packing, bitwise
@pytest.mark.parametrize("store_bits", [2, 4])
@pytest.mark.parametrize("shape", [(13, 5), (3, 21, 7)])
def test_pack_sub8_bytes_equal_reference(store_bits, shape):
    rng = np.random.default_rng(store_bits + len(shape))
    lo, hi = -(2 ** (store_bits - 1)), 2 ** (store_bits - 1) - 1
    q = rng.integers(lo, hi + 1, size=shape).astype(np.int32)
    ref = np.asarray(jpack.pack_sub8(jnp.asarray(q), store_bits, axis=-2))
    got = tpack.pack_sub8(_t(q), store_bits, axis=-2)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tpack.unpack_sub8(got, store_bits, k=shape[-2], axis=-2)
    np.testing.assert_array_equal(back.numpy(), q.astype(np.int8))


@pytest.mark.parametrize("shape,choices", [
    ((37, 24), [0, 2, 3, 4, 5, 8, 16]),      # every bucket
    ((3, 22, 16), [1, 2, 4, 7, 8]),          # stacked: scales over the stack
    ((20, 8), [2]),                          # a single bucket
])
def test_quant_pack_sub8_equal_reference(shape, choices):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(size=shape).astype(np.float32)
    bits = rng.choice(choices, size=shape[-1]).astype(np.float32)
    ref = jlq.quant_pack_sub8(jnp.asarray(w), bits)
    got = tlq.quant_pack_sub8(_t(w), bits)
    assert got.buckets == ref.buckets
    assert (got.k, got.n, got.out_dtype) == (ref.k, ref.n, ref.out_dtype)
    for gp, rp in zip(got.parts, ref.parts):
        assert len(gp) == len(rp)
        for ga, ra in zip(gp, rp):
            ra = np.asarray(ra)
            assert tuple(ga.shape) == ra.shape
            if ra.dtype.name == "bfloat16":
                ga, ra = ga.view(torch.int16), ra.view(np.int16)
            np.testing.assert_array_equal(ga.numpy(), ra)
    assert got.hbm_bytes() == ref.hbm_bytes()
    assert got.bucket_nbytes() == ref.bucket_nbytes()
    np.testing.assert_array_equal(got.dequant().numpy(),
                                  np.asarray(ref.dequant()))


def test_bucket_routing_matches_reference():
    """The vectorised routing of quant_pack_sub8 == bucket_of_bits, per
    channel, in both packages (half-way QBNs included)."""
    bits = np.arange(-2.0, 20.0, 0.25)
    ids = tlq._bucket_ids(bits)
    for b, i in zip(bits, ids):
        assert tpack.BUCKETS[i] == tpack.bucket_of_bits(b) == \
            jpack.bucket_of_bits(b), b


def test_packed_weight_take_is_repeat_slice():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 10, 12)).astype(np.float32)
    pw = tlq.quant_pack_sub8(_t(w), rng.choice([0, 2, 4, 8], size=12))
    full = pw.dequant()
    for r in range(3):
        np.testing.assert_array_equal(pw.take(r).dequant().numpy(),
                                      full[r].numpy())


# ----------------------------------------------------- fake quant, bitwise
def test_fake_quant_bitwise_equal_reference():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(3, 17, 40)).astype(np.float32)
    bits = rng.choice([0, 1, 2, 3, 4.6, 5, 8, 16, 24, 30],
                      size=40).astype(np.float32)
    pairs = [
        (jlq.fake_quant(jnp.asarray(w), 5.0),
         tlq.fake_quant(_t(w), 5.0)),
        (jlq.fake_quant_per_channel(jnp.asarray(w), bits, axis=-1),
         tlq.fake_quant_per_channel(_t(w), bits, axis=-1)),
        (jlq.fake_quant_per_channel(jnp.asarray(w[0]), bits[:17], axis=0),
         tlq.fake_quant_per_channel(_t(w[0]), bits[:17], axis=0)),
    ]
    for b in (0.0, 2.0, 8.0, 24.0):
        pairs.append((jlq.fake_quant_per_token(jnp.asarray(w), b),
                      tlq.fake_quant_per_token(_t(w), b)))
    for ref, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------- B5 fake-quant, bitwise
@pytest.mark.parametrize("M,N", [(256, 128), (100, 70), (512, 257)])
def test_fake_quant_channels_plain_bitwise_reference(M, N):
    """The port's plain version == the reference kernel in interpret mode,
    bit for bit (f32, the shapes of test_kernels.py); the wrapper on CPU
    tensors returns the same and counts no launch."""
    from repro_torch.kernels import fake_quant as tfq
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(M + N)
    x = rng.normal(size=(M, N)).astype(np.float32)
    bits = rng.integers(0, 9, size=N).astype(np.float32)
    bits[::7] = 32.0
    lv = np.maximum(2.0 ** (bits - 1) - 1, 1.0).astype(np.float32)
    amax = np.abs(x).max(axis=0)
    sc = np.where(amax > 0, amax / lv, 1.0).astype(np.float32)
    ref = jops.fake_quant_channels(jnp.asarray(x), jnp.asarray(sc),
                                   jnp.asarray(lv), jnp.asarray(bits))
    plain = tref.fake_quant_ref(_t(x), _t(sc), _t(lv), _t(bits))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))
    before = tfq.COUNT.launches
    got = tops.fake_quant_channels(_t(x), _t(sc), _t(lv), _t(bits))
    assert tfq.COUNT.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fake_quant_channels_validates():
    x = torch.zeros(4, 3)
    v = torch.ones(3)
    assert tops.fake_quant_channels(x.bfloat16(), v, v, v).dtype == \
        torch.bfloat16
    with pytest.raises(ValueError):
        tops.fake_quant_channels(x.double(), v, v, v)
    with pytest.raises(ValueError):
        tops.fake_quant_channels(x, v[:2], v, v)
    with pytest.raises(ValueError):
        tops.fake_quant_channels(x, v, v.double(), v)


# ------------------------------------------------------ B6 bit-plane GEMM
@pytest.mark.parametrize("M,K,N,P", [(128, 128, 128, 1), (64, 100, 70, 4),
                                     (256, 130, 128, 8)])
def test_binary_matmul_plain_matches_reference(M, K, N, P):
    """The port's plain version (and its wrapper on CPU tensors, which
    counts no launch) == the reference kernel in interpret mode at
    test_kernels.py's shapes, rtol = atol = 1e-4."""
    from repro_torch.kernels import binary_matmul as tbm
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(M * P + K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    B = rng.choice([-1, 1], size=(P, K, N)).astype(np.int8)
    a = rng.uniform(0.1, 1.0, size=(P, N)).astype(np.float32)
    ref = jops.binary_matmul(jnp.asarray(x), jnp.asarray(B), jnp.asarray(a))
    plain = tref.binary_matmul_ref(_t(x), _t(B), _t(a))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **GEMM_TOL)
    before = tbm.COUNT.launches
    got = tops.binary_matmul(_t(x), _t(B), _t(a))
    assert tbm.COUNT.launches == before
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_binary_matmul_validates():
    x = torch.zeros(4, 6)
    B = torch.ones(2, 6, 3, dtype=torch.int8)
    a = torch.ones(2, 3)
    assert tops.binary_matmul(x.bfloat16(), B, a).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tops.binary_matmul(x.double(), B, a)
    with pytest.raises(ValueError):
        tops.binary_matmul(x[:, :5].contiguous(), B, a)
    with pytest.raises(ValueError):
        tops.binary_matmul(x, torch.ones(9, 6, 3, dtype=torch.int8),
                           torch.ones(9, 3))
    with pytest.raises(ValueError):
        tops.binary_matmul(x, B, a[:1])
