"""The plain statement of K1's tensor-core prefill walk against the JAX
reference on the CPU.

``csrc/flash_attention.cu``'s flash_tc computes both products of a KV
tile on TF32 tensor cores in three passes, each operand split into
``hi = tf32_rna(v)`` and ``lo = tf32_rna(v - hi)``.
``ref.attention_tf32x3_ref`` states that arithmetic; here it is held to
the reference's ``flash_attention`` (Pallas interpret mode) at ``TOL`` of
test_attention.py at gemma2-2b's head shape (D = 256, G = 2, softcap 50),
causal, with a window that cuts tiles, a sentinel tail and a row that
attends nothing (exact zeros).  One TF32 pass (operands rounded once)
fails ``TOL``, which is why the kernel makes three; and an emulation of
the MMA's truncating accumulation shows that chaining a score's D / 8
K steps in one accumulator keeps ``TOL`` at D = 256, so the kernel sums
the scores without a fresh accumulator per K step (it does take one per
tile for P V).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import attention as jattn  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
SENT = np.iinfo(np.int32).max
D, CAP = 256, 50.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, B, Sq, Skv, n_real, hkv=2, g=2, q_first=None):
    """Keys at positions 0..n_real-1 then sentinels; queries at the last
    Sq real positions, or from ``q_first`` on."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, hkv, D)).astype(np.float32)
    first = n_real - Sq if q_first is None else q_first
    q_pos = np.broadcast_to(np.arange(first, first + Sq, dtype=np.int32),
                            (B, Sq)).copy()
    kv_pos = np.full((B, Skv), SENT, np.int32)
    kv_pos[:, :n_real] = np.arange(n_real, dtype=np.int32)
    return q, k, v, q_pos, kv_pos


# seed, B, Sq, Skv, n_real, window, q_first
CASES = [
    (0, 1, 200, 200, 200, None, None),    # prefill, causal
    (1, 1, 160, 160, 160, 40, None),      # a window that cuts tiles
    (2, 2, 70, 300, 270, None, None),     # chunk past a prefix, sentinel tail
    (3, 1, 24, 230, 200, 16, 230),        # rows past the window: all masked
]


@pytest.mark.parametrize("seed,B,Sq,Skv,n_real,window,q_first", CASES)
def test_attention_tf32x3_ref_matches_reference(seed, B, Sq, Skv, n_real,
                                                window, q_first):
    q, k, v, q_pos, kv_pos = _inputs(seed, B, Sq, Skv, n_real,
                                     q_first=q_first)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), window=window,
        attn_cap=CAP, interpret=True))
    got = tref.attention_tf32x3_ref(
        _t(q), _t(k), _t(v), q_pos=_t(q_pos), kv_pos=_t(kv_pos),
        window=window, attn_cap=CAP).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if q_first is not None:
        # queries at 230..253 with window 16 see no key (keys end at 199)
        assert not np.any(got) and not np.any(want)


def test_one_tf32_pass_fails_tol():
    """Operands rounded to TF32 once (one pass per product) end outside
    TOL at D = 256, three passes well inside it."""
    q, k, v, q_pos, kv_pos = _inputs(0, 1, 200, 200, 200)
    kw = dict(q_pos=_t(q_pos), kv_pos=_t(kv_pos), attn_cap=CAP)
    want = tlayers.attention_ref(_t(q), _t(k), _t(v), **kw).numpy()

    def one_pass(eq, a, b):
        return torch.einsum(eq, tref.tf32_rna(a), tref.tf32_rna(b))

    qf = (_t(q) * (1.0 / math.sqrt(D))).reshape(1, 200, 2, 2, D)
    one = tref._split_walk(qf, _t(k), _t(v), _t(q_pos), _t(kv_pos),
                           [(0, 200)], window=None, attn_cap=CAP,
                           causal=True, mm=one_pass).reshape(q.shape).numpy()
    three = tref.attention_tf32x3_ref(_t(q), _t(k), _t(v), **kw).numpy()
    assert not np.allclose(one, want, **TOL)
    np.testing.assert_allclose(three, want, **TOL)
    assert np.abs(three - want).max() < 0.25 * TOL["atol"]


def _rz(v64):
    """f64 -> f32 rounded toward zero, as the MMA adds into its
    accumulator."""
    r = v64.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v64)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_truncating_tf32_score_accumulation_holds_tol_at_d256():
    """A score's 3 x D / 8 = 96 MMAs chained through the truncating
    accumulator (m16n8k8: 8 exact products added, then rounded toward
    zero) move it by ~1e-5 at D = 256; after the softcap and the softmax
    the output stays an order inside TOL's atol.  (K2's K = 9216 chain,
    2304 MMAs, does not: tests/test_torch_split_tf32.py.)"""
    rng = np.random.default_rng(0)
    R, N = 32, 256
    q = (rng.normal(size=(R, D)) / math.sqrt(D)).astype(np.float32)
    k = rng.normal(size=(N, D)).astype(np.float32)
    v = rng.normal(size=(N, D))
    qh = tref.tf32_rna(_t(q)).numpy()
    ql = tref.tf32_rna(_t(q - qh)).numpy()
    kh = tref.tf32_rna(_t(k)).numpy()
    kl = tref.tf32_rna(_t(k - kh)).numpy()
    s = np.zeros((R, N), np.float32)
    for k0 in range(0, D, 8):
        for a, b in ((qh, kh), (qh, kl), (ql, kh)):
            s = _rz(s.astype(np.float64) + a[:, k0:k0 + 8].astype(np.float64)
                    @ b[:, k0:k0 + 8].T.astype(np.float64))
    exact = q.astype(np.float64) @ k.T.astype(np.float64)

    def attend(sc):
        sc = CAP * np.tanh(sc / CAP)
        p = np.exp(sc - sc.max(axis=1, keepdims=True))
        return (p @ v) / p.sum(axis=1, keepdims=True)

    assert 1e-6 < np.abs(s - exact).max() < 1e-4
    got, want = attend(s.astype(np.float64)), attend(exact)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - want).max() < 0.25 * TOL["atol"]
