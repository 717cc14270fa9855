"""The plain statement of K4's tensor-core chunk walk, and its split rule,
against the JAX reference on the CPU.

``csrc/paged_attention.cu`` runs chunk steps on ``attn_tc`` over
``PagedSlots`` (``csrc/attn_tc.cuh``): K1's three-pass TF32 walk with
the pool's logical slots as its K/V source, each row's live slot range
cut into ``NS`` runs of whole 32-slot tiles and the runs merged in
order.  ``ref.paged_attention_split_ref(mm=ref.einsum_tf32x3,
n_splits=NS)`` states that arithmetic; here it is held to the
reference's ``paged_attention_ref`` (``repro/models/layers.py``) at
``TOL`` of test_attention.py at gemma2-2b's head shape (D = 256, G = 2),
over chunks of more than 32 / G columns on page sizes 4 and 16, with and
without a window and a softcap, fp32 and int8 pools, an idle lane (exact
zeros) and a short row beside a long one (empty splits), for one split
and several.  One TF32 pass fails ``TOL`` there, which is why the walk
makes three.  The split count rule ``attention.paged_chunk_splits``
reads shapes only, and ``attention.paged_walk`` sends every q tile of at
most 32 / G columns to the decode walk instead, whatever the batch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import _kv_quant as j_kv_quant  # noqa: E402
from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.layers import paged_gather  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
SENT = np.iinfo(np.int32).max
D = 256


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _pool(rng, lens, k, ps, hkv, g, kv_bits=None):
    """A pool with shuffled pages; row i holds positions 0..lens[i]-1 and
    its q tile the last min(k, lens[i]) of them (the chunk just written),
    left-aligned and sentinel-padded; lens[i] == 0 is an idle lane."""
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
    ks = vs = None
    if kv_bits == 8:
        kq, ks = j_kv_quant(jnp.asarray(kf))
        vq, vs = j_kv_quant(jnp.asarray(vf))
        kf, vf, ks, vs = (np.asarray(a) for a in (kq, vq, ks, vs))
    return q, kf, vf, pos, bt, q_pos, ks, vs


def _reference(q, kp, vp, pos, bt, q_pos, ks, vs, window, cap):
    return np.asarray(jlayers.paged_attention_ref(
        _j(q), _j(kp), _j(vp), _j(pos), _j(bt), q_pos=_j(q_pos),
        window=window, attn_cap=cap, k_scale_pages=_j(ks),
        v_scale_pages=_j(vs)))


def _statement(q, kp, vp, pos, bt, q_pos, ks, vs, window, cap, n_splits,
               mm=tref.einsum_tf32x3):
    return tref.paged_attention_split_ref(
        _t(q), _t(kp), _t(vp), _t(pos), _t(bt), q_pos=_t(q_pos),
        window=window, attn_cap=cap, k_scale_pages=_t(ks),
        v_scale_pages=_t(vs), n_splits=n_splits, mm=mm).numpy()


# ps, k, hkv, window, cap, kv_bits, lens, n_splits
CASES = [
    (4, 40, 2, None, 50.0, None, [130, 70], 1),      # unsplit, global
    (4, 40, 2, None, 50.0, None, [130, 70], 3),      # split, ps 4
    (16, 40, 2, None, 50.0, None, [150, 40, 0], 3),  # ps 16, idle lane
    (4, 48, 1, 24, 50.0, None, [120, 60], 4),        # window cuts pages
    (16, 40, 2, 64, None, 8, [140, 90], 2),          # int8 pool, window
    (16, 64, 2, None, 30.0, 8, [100, 0, 20], 5),     # int8, empty splits
]


@pytest.mark.parametrize("ps,k,hkv,window,cap,kv_bits,lens,n_splits", CASES)
def test_paged_tc_statement_matches_reference(ps, k, hkv, window, cap,
                                              kv_bits, lens, n_splits):
    rng = np.random.default_rng(ps * 1000 + k + sum(lens) + n_splits)
    args = _pool(rng, lens, k, ps, hkv, 2, kv_bits=kv_bits)
    want = _reference(*args, window, cap)
    got = _statement(*args, window, cap, n_splits)
    for i, s in enumerate(lens):
        c = min(k, s)
        if c == 0:      # an idle lane walks nothing: exact zeros
            assert not np.any(got[i])
            continue
        np.testing.assert_allclose(got[i, :c], want[i, :c],
                                   err_msg=f"row {i}", **TOL)


def test_one_tf32_pass_fails_tol_on_the_paged_walk():
    """Operands rounded to TF32 once (one pass per product) end outside
    TOL on a 64-column chunk over 200 slots at D = 256; the three-pass
    statement holds well inside it, split or not."""
    rng = np.random.default_rng(7)
    args = _pool(rng, [200, 90], 64, 16, 2, 2)
    want = _reference(*args, None, 50.0)

    def one_pass(eq, a, b):
        return torch.einsum(eq, tref.tf32_rna(a), tref.tf32_rna(b))

    one = _statement(*args, None, 50.0, 1, mm=one_pass)
    assert not np.allclose(one[:, :64], want[:, :64], **TOL)
    for ns in (1, 4):
        three = _statement(*args, None, 50.0, ns)
        np.testing.assert_allclose(three[:, :64], want[:, :64], **TOL)
        err = np.abs(three[:, :64] - want[:, :64]).max()
        assert err < 0.25 * TOL["atol"]


def test_paged_chunk_splits_rule():
    """run()'s chunk step (4 rows x 512 columns, gemma2-2b, 264 pages of
    16) on an H100's 132 SMs takes 8 splits (1024 blocks); one row of 512
    (chip_smoke's paged-model phase) 33.  The rule reads shapes only,
    never splits more than the tiles, and keeps the grid at about eight
    blocks per SM."""
    assert tattn.paged_chunk_splits(4, 512, 8, 4, 4224, 132) == 8
    assert tattn.paged_chunk_splits(1, 512, 8, 4, 4160, 132) == 33
    assert tattn.paged_chunk_splits(4, 17, 8, 4, 4224, 132) > 1
    assert tattn.paged_chunk_splits(4, 512, 8, 4, 32, 132) == 1
    assert tattn.paged_chunk_splits(128, 512, 8, 4, 4224, 132) == 1
    for B in (1, 2, 4, 8):
        for n_slots in (48, 100, 640, 4224, 9999):
            for Hq, Hkv in ((8, 4), (8, 1), (4, 4), (32, 8)):
                for k in (17, 40, 512, 2048):
                    G = Hq // Hkv
                    n = tattn.paged_chunk_splits(B, k, Hq, Hkv, n_slots, 132)
                    assert 1 <= n <= max(1, -(-n_slots // 32))
                    blocks = -(-k // (128 // G)) * Hkv * B
                    assert n == 1 or n * blocks <= 8 * 132
    # what the kernel cuts with that count: whole tiles from each row's
    # first live slot, as for the decode walk
    s0, s1 = tref.paged_live_slots(list(range(3648, 4160)), None, 16, 264)
    runs = tref.paged_split_slots(s0, s1, 8)
    assert (s0, s1) == (0, 4160) and runs[0] == (0, 544)
    assert max(b - a for a, b in runs) == 17 * 32


def test_paged_walk_routes_by_columns_alone():
    """Every q tile of at most 32 / G columns takes the decode walk,
    whatever the batch: 33 or more gemma2-2b slots fill an H100's 132 SMs
    and run it at one split, never the 128-row tensor-core walk; wider
    tiles take the tensor-core walk with the chunk rule's splits."""
    assert tattn.paged_walk(4, 1, 8, 4, 4224, 132) == ("decode", 15)
    assert tattn.paged_walk(33, 1, 8, 4, 4224, 132) == ("decode", 1)
    assert tattn.paged_walk(2, 1, 8, 4, 32, 132) == ("decode", 1)
    assert tattn.paged_walk(4, 512, 8, 4, 4224, 132) == ("tc", 8)
    for B in (1, 4, 33, 128):
        for n_slots in (32, 640, 4224):
            for Hq, Hkv in ((8, 4), (8, 1), (4, 4), (32, 8)):
                for k in (1, 2, 5, 16, 17, 40, 512):
                    shape = (B, k, Hq, Hkv, n_slots, 132)
                    if k <= 32 // (Hq // Hkv):
                        want = ("decode", tattn.paged_decode_splits(*shape))
                    else:
                        want = ("tc", tattn.paged_chunk_splits(*shape))
                    assert tattn.paged_walk(*shape) == want


def test_unsplit_paged_statement_is_k1s_walk_over_gathered_rows():
    """One walk over the pool's slots is K1's tensor-core walk
    (attention_tf32x3_ref) over the gathered rows: the same kernel body
    with another K/V source."""
    rng = np.random.default_rng(3)
    q, kp, vp, pos, bt, q_pos, _, _ = _pool(rng, [96], 40, 16, 2, 2)
    got = _statement(q, kp, vp, pos, bt, q_pos, None, None, None, 50.0, 1)
    kg = paged_gather(_t(kp), _t(bt))
    vg = paged_gather(_t(vp), _t(bt))
    kv_pos = paged_gather(_t(pos), _t(bt))
    dense = tref.attention_tf32x3_ref(_t(q), kg, vg, q_pos=_t(q_pos),
                                      kv_pos=kv_pos, attn_cap=50.0).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-6)
