"""The plain mixed-QBN product of the port against the JAX package's, on
the inputs of ``_mixed_cases``: the cases on which
``tests/test_torch_mixed_launch.py`` holds the one-launch product on the
card (``packed_matmul.mixed_matmul``) to this plain version.  The card
tests import no JAX, so this file links them to the reference: the port
packs the same numpy weights into the reference's store, bit for bit, and
its product on CPU tensors (the kernels' plain versions, bucket by bucket)
matches the reference's ``packed_mixed_matmul`` (Pallas in interpret mode)
within test_packed.py's GEMM tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import _mixed_cases as mixed_cases  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack as jpack  # noqa: E402
from repro.quant import linear_quant as jlq  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.quant import linear_quant as tlq  # noqa: E402

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", mixed_cases.NAMES)
def test_packed_mixed_matmul_at_the_card_cases_matches_reference(name):
    """The inputs on which tests/test_torch_mixed_launch.py holds the
    one-launch product on the card to the port's plain version: the port
    packs them into the reference's store, bit for bit, and its plain
    product (CPU) matches the reference's packed_mixed_matmul, one expert
    (group) at a time for a stack (the reference's product is 2-d)."""
    c = mixed_cases.mixed_case(name)
    jw = jlq.quant_pack_sub8(jnp.asarray(c.w), c.bits)
    tw = tlq.quant_pack_sub8(_t(c.w), c.bits)
    ref_store = params_from_numpy(jw, "cpu")
    assert tw.buckets == ref_store.buckets
    for got_part, ref_part in zip(tw.parts, ref_store.parts):
        for a, b in zip(got_part, ref_part):
            assert torch.equal(a, b)

    def expert(e):
        return jpack.PackedWeight(
            parts=tuple(tuple(a[e] for a in p) for p in jw.parts), k=jw.k,
            n=jw.n, buckets=jw.buckets, out_dtype=jw.out_dtype)

    if c.counts is not None:
        off = c.offsets
        got = tops.packed_mixed_matmul(_t(c.x), tw, _t(off), c.cap)
        for e, (a, b) in enumerate(zip(off, off[1:])):
            if b > a:
                ref = jops.packed_mixed_matmul(jnp.asarray(c.x[a:b]),
                                               expert(e))
                np.testing.assert_allclose(got[a:b].numpy(), np.asarray(ref),
                                           **GEMM_TOL)
    elif c.w.ndim == 3:
        got = tops.packed_mixed_matmul(_t(c.x), tw)
        for e in range(c.w.shape[0]):
            ref = jops.packed_mixed_matmul(jnp.asarray(c.x[e]), expert(e))
            np.testing.assert_allclose(got[e].numpy(), np.asarray(ref),
                                       **GEMM_TOL)
    else:
        got = tops.packed_mixed_matmul(_t(c.x), tw)
        ref = jops.packed_mixed_matmul(jnp.asarray(c.x), jw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GEMM_TOL)
