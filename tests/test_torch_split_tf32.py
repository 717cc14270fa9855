"""Plain statements of two launch shapes that run only on the card, against
the JAX reference on the CPU.

* K4's split-KV decode walk (``csrc/paged_attention.cu``: paged_split,
  paged_combine), stated by ``ref.paged_attention_split_ref``, against the
  reference's ``paged_prefill_attention`` in Pallas interpret mode at
  ``TOL`` of test_attention.py on the real (left-aligned) columns, over
  GQA decode across pages, a window that cuts leading pages, a short row
  beside long ones (empty splits), an idle lane (exact zeros), an int8
  pool, one split, and a two-column q tile; and the split rule
  ``attention.paged_decode_splits``.
* The tensor-core numerics of K2 and K3 (``csrc/gemm_tiles.cuh``:
  gemm_tc), stated by ``ref.quant_matmul_tf32x2_ref``: x split into two
  rna-TF32 parts against the reference's ``quant_matmul_ref`` (int8) and
  ``packed_matmul_ref`` (int4 / int2, the weight unpacked first: its
  fields are exact in TF32 too) at rtol = atol = 1e-4 of test_packed.py,
  and the single TF32 pass failing that tolerance at K = 9216, which is
  why the kernel makes two; and an emulation of the MMA's truncating
  accumulation, which is why the kernel sums each K step in a fresh
  accumulator.
* The process-wide numerics switches of ``repro_torch.backend``: TF32 off,
  cuDNN deterministic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import attention as jattn  # noqa: E402
from repro.kernels import pack as jpack  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.transformer import _kv_quant as j_kv_quant  # noqa: E402
from repro_torch import backend as tbackend  # noqa: E402
from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.kernels import pack as tpack  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
SENT = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------- K4 split walk
def _pool(rng, lens, k, ps, hkv, g, D=8, kv_bits=None):
    """A pool with shuffled pages; row i holds positions 0..lens[i]-1 and
    its q tile the last min(k, lens[i]) of them, left-aligned and
    sentinel-padded; lens[i] == 0 is an idle lane (all-trash table)."""
    B = len(lens)
    nb = max(-(-max(lens) // ps), 1) + 1
    P = 1 + sum(-(-s // ps) for s in lens if s)
    ids = rng.permutation(np.arange(1, P))
    kf = rng.normal(size=(P, ps, hkv, D)).astype(np.float32)
    vf = rng.normal(size=(P, ps, hkv, D)).astype(np.float32)
    pos = np.full((P, ps), SENT, np.int32)
    bt = np.zeros((B, nb), np.int32)
    q_pos = np.full((B, k), SENT, np.int32)
    used = 0
    for i, s in enumerate(lens):
        n = -(-s // ps)
        bt[i, :n] = ids[used:used + n]
        used += n
        for p in range(s):
            pos[bt[i, p // ps], p % ps] = p
        c = min(k, s)
        q_pos[i, :c] = range(s - c, s)
    q = rng.normal(size=(B, k, hkv * g, D)).astype(np.float32)
    pools = dict(k=kf, v=vf, pos=pos, k_s=None, v_s=None)
    if kv_bits == 8:
        kq, ks = j_kv_quant(jnp.asarray(kf))
        vq, vs = j_kv_quant(jnp.asarray(vf))
        pools.update(k=np.asarray(kq), v=np.asarray(vq), k_s=np.asarray(ks),
                     v_s=np.asarray(vs))
    return q, pools, bt, q_pos


# ps, k, hkv, g, window, cap, kv_bits, lens, n_splits
SPLIT_CASES = [
    (4, 1, 2, 2, None, None, None, [70, 45], 3),       # GQA 2, many pages
    (4, 1, 1, 2, 20, 50.0, None, [90, 60], 3),         # window cuts pages
    (16, 1, 2, 2, None, None, None, [130, 5, 100], 5),  # short row: empty
    (4, 1, 2, 2, None, 30.0, None, [40, 0, 33], 4),    # idle lane
    (8, 1, 2, 2, 30, None, 8, [75, 20], 3),            # int8 pool, window
    (4, 1, 1, 4, None, None, None, [50, 17], 1),       # one split
    (4, 2, 2, 2, None, 50.0, None, [40, 9], 2),        # two-column q tile
]


@pytest.mark.parametrize("ps,k,hkv,g,window,cap,kv_bits,lens,n_splits",
                         SPLIT_CASES)
def test_paged_attention_split_ref_matches_reference(ps, k, hkv, g, window,
                                                     cap, kv_bits, lens,
                                                     n_splits):
    rng = np.random.default_rng(ps * 100 + sum(lens) + n_splits)
    q, pools, bt, q_pos = _pool(rng, lens, k, ps, hkv, g, kv_bits=kv_bits)
    scales = [None if pools[n] is None else pools[n] for n in ("k_s", "v_s")]
    kw = dict(window=window, attn_cap=cap)
    got = tref.paged_attention_split_ref(
        _t(q), _t(pools["k"]), _t(pools["v"]), _t(pools["pos"]), _t(bt),
        q_pos=_t(q_pos), k_scale_pages=None if scales[0] is None
        else _t(scales[0]), v_scale_pages=None if scales[1] is None
        else _t(scales[1]), n_splits=n_splits, **kw).numpy()
    kernel = np.asarray(jattn.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
        jnp.asarray(pools["pos"]), jnp.asarray(bt), q_pos=jnp.asarray(q_pos),
        k_scale_pages=None if scales[0] is None else jnp.asarray(scales[0]),
        v_scale_pages=None if scales[1] is None else jnp.asarray(scales[1]),
        interpret=True, **kw))
    plain = tlayers.paged_attention_ref(
        _t(q), _t(pools["k"]), _t(pools["v"]), _t(pools["pos"]), _t(bt),
        q_pos=_t(q_pos), k_scale_pages=None if scales[0] is None
        else _t(scales[0]), v_scale_pages=None if scales[1] is None
        else _t(scales[1]), **kw).numpy()
    for i, s in enumerate(lens):
        c = min(k, s)
        if c == 0:      # an idle lane walks nothing: exact zeros
            assert not np.any(got[i])
            continue
        np.testing.assert_allclose(got[i, :c], kernel[i, :c],
                                   err_msg=f"row {i}", **TOL)
        np.testing.assert_allclose(got[i, :c], plain[i, :c],
                                   err_msg=f"row {i}", **TOL)


def test_paged_split_slots_cover_each_row_in_whole_tiles():
    """Every row's live range is cut into n_splits runs of whole 32-slot
    tiles counted from its first slot, in order and without gaps; a short
    row among long ones leaves its later splits empty."""
    assert tref.paged_live_slots([SENT], None, 16, 10) == (0, 0)
    assert tref.paged_live_slots([4175], None, 16, 264) == (0, 4176)
    assert tref.paged_live_slots([4175], 4096, 16, 264) == (80, 4176)
    assert tref.paged_live_slots([40, 41, SENT], None, 16, 264) == (0, 48)
    runs = tref.paged_split_slots(0, 48, 15)
    assert runs[:2] == [(0, 32), (32, 48)]
    assert all(a == b for a, b in runs[2:])
    for s0, s1, n in ((0, 4176, 15), (80, 4176, 15), (16, 48, 3),
                      (0, 32, 1), (8, 1000, 7), (0, 0, 4)):
        runs = tref.paged_split_slots(s0, s1, n)
        assert len(runs) == n and runs[0][0] == s0 and runs[-1][1] == s1
        for (a, b), (c, _) in zip(runs, runs[1:]):
            assert b == c and (a - s0) % 32 == 0 and a <= b


def test_paged_decode_splits_rule():
    """run()'s decode step (4 rows x 1 token, gemma2-2b, 264 pages of 16)
    puts about, and at most, two blocks on each of an H100's 132 SMs;
    chunk steps, q tiles wider than 32 / G, full grids and single tiles
    keep the single walk; the splits never outnumber the tiles.  K2 and K3
    route M > 8 to the tensor cores."""
    ns = tattn.paged_decode_splits(4, 1, 8, 4, 4224, 132)
    assert ns == 15 and 1.75 * 132 <= ns * 4 * 4 <= 2 * 132
    assert tattn.paged_decode_splits(4, 512, 8, 4, 4224, 132) == 1
    assert tattn.paged_decode_splits(4, 17, 8, 4, 4224, 132) == 1
    assert tattn.paged_decode_splits(4, 16, 8, 4, 4224, 132) > 1
    assert tattn.paged_decode_splits(33, 1, 8, 4, 4224, 132) == 1
    assert tattn.paged_decode_splits(2, 1, 8, 4, 32, 132) == 1
    for B in (1, 2, 4, 8):
        for n_slots in (48, 100, 640, 4224, 9999):
            for Hq, Hkv in ((8, 4), (8, 1), (4, 4), (32, 8), (32, 1)):
                for k in (1, 2, 5, 40):
                    n = tattn.paged_decode_splits(B, k, Hq, Hkv, n_slots, 132)
                    assert 1 <= n <= -(-n_slots // 32)
                    assert n == 1 or n * Hkv * B <= 2 * 132
                    if k > 32 // (Hq // Hkv) or Hkv * B >= 132:
                        assert n == 1
    assert tqm.route(2) == "skinny" and tqm.route(8, 4) == "skinny"
    assert tqm.route(9) == tqm.route(2048, 8) == "tc_2xtf32"
    assert tqm.route(9, 4) == tqm.route(2048, 2) == "tc_2xtf32"


# ------------------------------------------------------ K2 on TF32 cores
def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)           # TF32's ulp at 1
    x = np.array([1.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  1 + 3 * 2.0 ** -12, 0.0, 127.0, -3.0e-20],
                 dtype=np.float32)
    got = tref.tf32_rna(_t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.array([one, one + ulp, -(one + ulp), one, one + ulp, 0.0,
                       127.0, got[-1]], dtype=np.float32))
    bits = tref.tf32_rna(_t(np.random.default_rng(0).normal(
        size=1000).astype(np.float32))).numpy().view(np.int32)
    assert not np.any(bits & 0x1FFF)
    y = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    r = tref.tf32_rna(_t(y)).numpy()
    assert np.all(np.abs(r - y) <= np.abs(y) * 2.0 ** -11)


@pytest.mark.parametrize("M,K,N", [(64, 9216, 128), (37, 1001, 333)])
def test_quant_matmul_tf32x2_ref_matches_reference(M, K, N):
    """Two TF32 passes hold the reference tolerance; at K = 9216 one pass
    does not (x ~ N(0, 1), scales as chip_smoke.py draws them)."""
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = ((rng.random(N) + 0.5) / (127 * np.sqrt(K))).astype(np.float32)
    want = np.asarray(jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(qw),
                                            jnp.asarray(s)))
    two = tref.quant_matmul_tf32x2_ref(_t(x), _t(qw), _t(s)).numpy()
    np.testing.assert_allclose(two, want, **GEMM_TOL)
    assert np.abs(two - want).max() < 2e-5
    if K == 9216:
        one = (tref.tf32_rna(_t(x)) @ _t(qw).float() * _t(s)).numpy()
        assert not np.allclose(one, want, **GEMM_TOL)


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("M,K,N", [(64, 9216, 128), (37, 1001, 333)])
def test_packed_matmul_tf32x2_ref_matches_reference(M, K, N, bits):
    """K3 at M > 8 runs gemm_tc as K2 does, its int4 / int2 fields unpacked
    where the fragment is built: two TF32 passes of x against the unpacked
    weight hold the reference's packed_matmul_ref (K = 1001 leaves one
    int4 field, three int2 fields, of the last byte past K)."""
    rng = np.random.default_rng(M + K + N + bits)
    lv = 2 ** (bits - 1) - 1
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw = rng.integers(-lv, lv + 1, size=(K, N)).astype(np.int8)
    s = ((rng.random(N) + 0.5) / (lv * np.sqrt(K))).astype(np.float32)
    pw = np.asarray(jpack.pack_sub8(jnp.asarray(qw), bits, axis=0))
    want = np.asarray(jref.packed_matmul_ref(jnp.asarray(x), jnp.asarray(pw),
                                             jnp.asarray(s), bits))
    unpacked = tpack.unpack_sub8(_t(pw), bits, k=K, axis=0)
    assert torch.equal(unpacked, _t(qw))
    two = tref.quant_matmul_tf32x2_ref(_t(x), unpacked, _t(s)).numpy()
    np.testing.assert_allclose(two, want, **GEMM_TOL)
    assert np.abs(two - want).max() < 2e-5


def test_backend_pins_deterministic_cudnn():
    """Importing the port's backend turns TF32 off and makes cuDNN
    deterministic with its autotuner off (bit-reproducible training)."""
    assert tbackend.torch is torch
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _tc_accumulate(hi, lo, q, flush_every):
    """The tensor cores' m16n8k8 accumulation, emulated: each MMA adds its
    8 exact products to its accumulator and rounds toward zero; with
    ``flush_every`` > 0 a zeroed accumulator takes that many K steps of 8
    and is then added to a running f32 sum (round to nearest)."""
    def rz(v64):
        r = v64.astype(np.float32)
        over = np.abs(r.astype(np.float64)) > np.abs(v64)
        r[over] = np.nextafter(r[over], np.float32(0))
        return r
    total = np.zeros((hi.shape[0], q.shape[1]), np.float32)
    part = np.zeros_like(total)
    for step, k0 in enumerate(range(0, q.shape[0], 8)):
        for x in (hi, lo):
            part = rz(part.astype(np.float64) +
                      x[:, k0:k0 + 8].astype(np.float64) @
                      q[k0:k0 + 8].astype(np.float64))
        if flush_every and (step + 1) % flush_every == 0:
            total, part = total + part, np.zeros_like(part)
    return total + part


def test_truncating_mma_accumulation_needs_a_sum_per_k_step():
    """Why gemm_tc sums each K step of 32 (4 MMA steps of 8) in a fresh
    accumulator: chaining all of K = 9216 through the MMA's truncating
    adds drifts past the reference tolerance's atol, the per-step sum
    stays at f32 sgemm's level."""
    rng = np.random.default_rng(0)
    M, K, N = 32, 9216, 64
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, N)).astype(np.float32)
    s = ((rng.random(N) + 0.5) / (127 * np.sqrt(K))).astype(np.float32)
    hi = tref.tf32_rna(_t(x)).numpy()
    lo = tref.tf32_rna(_t(x - hi)).numpy()
    want = (x.astype(np.float64) @ q.astype(np.float64)) * s
    chained = np.abs(_tc_accumulate(hi, lo, q, 0) * s - want).max()
    per_step = np.abs(_tc_accumulate(hi, lo, q, 4) * s - want).max()
    assert chained > 1e-4 > 1e-5 > per_step
