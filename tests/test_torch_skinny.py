"""The dispatch of K2's and K3's skinny launch (``csrc/gemm_tiles.cuh``:
gemm_stream) on the CPU.

For M <= 8 rows the kernel streams the stored weight once, in one launch:
its packed rows are cut into S K splits (``quant_matmul.skinny_splits``,
from shapes alone) whose sums a thread-block cluster adds in split order,
then scales.  Here: the split count reads shapes only and stays inside
the cluster and occupancy limits; the cut (``quant_matmul.skinny_cut``)
covers every packed row exactly once, for K = 2304, 9216 and 1001 and
F = 1, 2, 4 values a byte; and the split sums, with the fields past K
of the last packed row masked and the scale applied to the finished sum,
hold the reference's ``quant_matmul_ref`` / ``packed_matmul_ref`` at
rtol = atol = 1e-4 (test_packed.py).  The route by M is held in
test_torch_split_tf32.py::test_paged_decode_splits_rule.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import pack as jpack  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels.pack import unpack_sub8  # noqa: E402

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES_N = (160, 1044, 2304, 9216, 256000)   # bucket widths and full layers


@pytest.mark.parametrize("F", [1, 2, 4])
@pytest.mark.parametrize("K", [2304, 9216, 1001])
def test_skinny_cut_covers_every_packed_row_once(K, F):
    rows = -(-K // F)
    for N in SHAPES_N:
        for n_sm in (132, 114, 16):
            S = tqm.skinny_splits(rows, N, n_sm)
            assert 1 <= S <= tqm.MAX_SPLITS
            assert S <= -(-rows // tqm.SKINNY_CHUNK)
            cols = -(-N // tqm.SKINNY_COLS)
            assert S == 1 or S * cols <= 2 * n_sm
            cut = tqm.skinny_cut(rows, S)
            assert len(cut) == S and cut[0][0] == 0 and cut[-1][1] == rows
            covered = [r for a, b in cut for r in range(a, b)]
            assert covered == list(range(rows))
            assert all(b > a for a, b in cut)


def test_skinny_splits_at_the_path_shapes():
    """An H100's 132 SMs: the decode GEMMs of gemma2-2b in int8 (wg / wu
    2304 x 9216, wd 9216 x 2304) split 3 and 8 ways, the unembedding
    (256000 columns, 2000 tiles) not at all; a narrow bucket (160
    columns of 576 int2 rows) splits as far as its chunks allow."""
    assert tqm.skinny_splits(2304, 9216, 132) == 3
    assert tqm.skinny_splits(9216, 2304, 132) == 8
    assert tqm.skinny_splits(2304, 256000, 132) == 1
    assert tqm.skinny_splits(576, 160, 132) == 5
    assert tqm.skinny_splits(100, 160, 132) == 1
    assert tqm.skinny_splits(0, 160, 132) == 1


@pytest.mark.parametrize("bits,K,N", [(8, 2304, 300), (4, 1001, 333),
                                      (2, 1001, 96), (4, 9216, 40)])
def test_skinny_split_sums_match_reference(bits, K, N):
    """gemm_stream's arithmetic, stated in numpy: each split sums x times
    the unpacked fields of its packed rows (fields past K masked by zero
    x), the splits add in order, the scale multiplies the finished sum."""
    rng = np.random.default_rng(K + N + bits)
    M, F, lv = 2, 8 // bits, 2 ** (bits - 1) - 1
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw = rng.integers(-lv, lv + 1, size=(K, N)).astype(np.int8)
    s = ((rng.random(N) + 0.5) / (lv * np.sqrt(K))).astype(np.float32)
    if bits == 8:
        w = qw
        want = np.asarray(jref.quant_matmul_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)))
    else:
        w = np.asarray(jpack.pack_sub8(jnp.asarray(qw), bits, axis=0))
        want = np.asarray(jref.packed_matmul_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), bits))
    rows = w.shape[0]
    fields = (w if bits == 8 else unpack_sub8(
        torch.from_numpy(w.copy()), bits, k=rows * F, axis=0).numpy()
              ).astype(np.float32)
    xp = np.zeros((M, rows * F), np.float32)
    xp[:, :K] = x                                  # zeros past K
    S = tqm.skinny_splits(rows, N, 132)
    total = np.zeros((M, N), np.float32)
    for a, b in tqm.skinny_cut(rows, S):
        total = total + xp[:, a * F:b * F] @ fields[a * F:b * F]
    np.testing.assert_allclose(total * s, want, **GEMM_TOL)
    assert np.array_equal(fields[:K], qw)
