"""One tensor-core launch per mixed-QBN PackedWeight
(``packed_matmul.mixed_matmul``, ``csrc/gemm_tiles.cuh::gemm_tc_mixed``).

On the CPU: the host-side table that feeds the launch (every output
channel covered once, the parts' column tiles end to end, each bucket's
stage and VEC flag as ``gemm_tiles.cuh::with_stage`` picks them) at the
benchmark cells' bucket widths, and the rule that picks the launch.

On the card (tests marked ``card``, skipped without one), on the numpy
inputs of ``_mixed_cases``: the fused launch against the per-bucket path
(``ops.bucket_matmul``: one K2 / K3 launch a bucket scattered by
``index_copy_``) bit for bit, and against the plain version on the CPU
within the GEMM tolerance, dense, expert-batched and grouped, fp32 and
bf16 x; one launch a call, by the route counter and by a captured CUDA
graph.  ``tests/test_torch_mixed_reference.py`` holds that plain version
to the JAX package's on the same inputs (this file imports no JAX, so
that it runs on the card).  Run there with ``python -m pytest -m card
tests/test_torch_mixed_launch.py``.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _mixed_cases import GROUPS, NAMES, channel_bits, mixed_case  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packed_matmul as pm  # noqa: E402
from repro_torch.kernels.pack import STORE_BITS, PackedWeight  # noqa: E402
from repro_torch.quant.linear_quant import quant_pack_sub8  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the fused launch against the plain version: tests/test_packed.py's GEMM
# tolerance; a bf16 result also rounds once to bf16
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
# (int2, int4, int8) bucket widths of the cells' sites: granite-4.0-h-small's
# w_xz, its d-4096 projections, w_bc; granite-moe's d-1536 projections,
# its experts' 512 and granite-4.0-h-small's experts' 768 (and the shared
# expert's 1536 at d 1536's shape), granite-moe's kv heads
CELL_WIDTHS = [(2304, 4608, 6912), (576, 1152, 1728), (36, 72, 108),
               (216, 432, 648), (108, 216, 324), (72, 144, 216)]


def make_store(bits, k: int, lead=(), seed: int = 0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(tuple(lead) + (k, len(bits)), generator=g).to(dtype)
    return quant_pack_sub8(w, bits)


def with_stage_pick(bits: int, n: int, ptr: int):
    """gemm_tiles.cuh::with_stage: the weight source of a `bits`-wide
    bucket of n channels stored at `ptr` (bits, VEC)."""
    return bits, n % 16 == 0 and ptr % 16 == 0


def check_table(w):
    """The table of ``w``: returns it after holding it to the launch's
    contract."""
    parts = pm.mixed_table(w)
    chans = torch.cat([w.index(p.name) for p in parts])
    assert torch.equal(chans.sort().values, torch.arange(w.n)), \
        "every output channel once"
    tile = 0
    for p in parts:
        assert w.buckets[p.bucket][0] == p.name
        assert p.n == len(w.buckets[p.bucket][1]) > 0
        assert (p.tile0, p.tiles) == (tile, math.ceil(p.n / pm.TILE_N))
        tile += p.tiles
        if p.name == "pruned":
            assert p.stage == 0
            continue
        data = w.parts[p.bucket][0]
        assert pm.MIXED_STAGES[p.stage - 1] == with_stage_pick(
            STORE_BITS[p.name], p.n, data.data_ptr())
    names = [p.name for p in parts]
    assert "pruned" not in names[:-1], "pruned channels last"
    assert names == sorted(names, key=["int8", "int4", "int2",
                                       "pruned"].index), "costliest first"
    return parts


@pytest.mark.parametrize("widths", CELL_WIDTHS,
                         ids=["x".join(map(str, w)) for w in CELL_WIDTHS])
def test_table_covers_the_cells_bucket_widths(widths):
    u = widths[0] // 9
    bits = channel_bits(GROUPS * u)
    w = make_store(bits, k=8)
    parts = check_table(w)
    assert {p.name: p.n for p in parts} == dict(
        int2=widths[0], int4=widths[1], int8=widths[2], pruned=10 * u)
    for p in parts[:-1]:     # fresh contiguous buffers: VEC iff n % 16 == 0
        assert pm.MIXED_STAGES[p.stage - 1][1] == (p.n % 16 == 0)


@pytest.mark.parametrize("widths", [(36, 72, 108), (2304, 4608, 6912)],
                         ids=["w_bc", "w_xz"])
def test_table_of_a_stacked_store_view(widths):
    """Repeat 1 of a stacked store starts rows x n bytes into the buffer:
    VEC follows that view's alignment, as with_stage reads its pointer."""
    bits = channel_bits(GROUPS * (widths[0] // 9))
    stack = make_store(bits, k=6, lead=(2,))
    for r in (0, 1):
        check_table(stack.take(r))
    check_table(stack)                 # the whole stack: experts by stride


def test_table_of_one_bucket_and_of_an_all_pruned_store():
    one = check_table(make_store(np.full(300, 8), k=5))
    assert [(p.name, p.tile0, p.tiles) for p in one] == [("int8", 0, 3)]
    none = check_table(make_store(np.zeros(200), k=5))
    assert [(p.name, p.n, p.stage) for p in none] == [("pruned", 200, 0)]


def test_table_and_rule_refuse_a_full_bucket():
    bits = np.array([16, 8, 4, 2, 0] * 20)
    w = make_store(bits, k=4)
    with pytest.raises(ValueError, match="full"):
        pm.mixed_table(w)
    assert not pm.mixed_applies(w, 384, False)


@pytest.mark.parametrize("rows,grouped,want", [
    (1, False, False), (8, False, False), (9, False, True),
    (384, False, True), (1, True, True)])
def test_mixed_applies_on_the_tensor_core_route(rows, grouped, want):
    w = make_store(channel_bits(GROUPS * 2), k=4)
    assert pm.mixed_applies(w, rows, grouped) is want


def test_cpu_bf16_result_is_the_dequantized_product():
    g = torch.Generator().manual_seed(4)
    w = make_store(channel_bits(GROUPS * 2, seed=2), 29,
                   dtype=torch.bfloat16)
    x = torch.randn(12, 29, generator=g).to(torch.bfloat16)
    got = ops.packed_mixed_matmul(x, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (x.float() @ w.dequant().float()).to(
        torch.bfloat16))


def test_mixed_matmul_runs_on_the_card_only():
    w = make_store(channel_bits(GROUPS * 2), k=4)
    with pytest.raises(ValueError, match="no mixed launch"):
        pm.mixed_matmul(torch.randn(9, 4), w)


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused launch has no CPU form)")
    return torch.device("cuda", 0)


def _dirty_pool(like):
    """Free a NaN-filled block of ``like``'s size into the caching
    allocator, which hands it to the next allocation of that size: an
    element the launch leaves unwritten then reads NaN, not zero."""
    t = torch.full_like(like, float("nan"))
    del t


def _graph_launches(fn) -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.graph_launches(torch, fn)


def _on(w: PackedWeight, dev) -> PackedWeight:
    """The store ``w`` on ``dev``, its bytes as they are."""
    return PackedWeight(parts=tuple(tuple(a.to(dev) for a in p)
                                    for p in w.parts),
                        k=w.k, n=w.n, buckets=w.buckets,
                        out_dtype=w.out_dtype)


def _case(name, dev, x_dtype):
    """Case ``name``'s call, (x, w, offsets, cap), on the CPU and on the
    card: the store packed on the CPU from the case's weights in x's dtype
    (a bf16 store's product is bf16: the kernels then take a bf16 x as it
    is), its bytes copied to the card."""
    c = mixed_case(name)
    w = quant_pack_sub8(torch.from_numpy(c.w).to(x_dtype), c.bits)
    x = torch.from_numpy(c.x).to(x_dtype)
    off = None if c.counts is None else torch.from_numpy(c.offsets)
    cap = None if c.counts is None else c.cap
    cpu = (x, w, off, cap)
    return cpu, (x.to(dev), _on(w, dev), None if off is None else
                 off.to(dev), cap)


def _fused_holds(cpu, dev, route):
    """The fused launch (ops.packed_mixed_matmul on the card) counted once
    under ``route``, equal bit for bit to the per-bucket launches, zero on
    the pruned channels, and within the tolerance of the plain version on
    the CPU: for an fp32 x ``ops.packed_mixed_matmul`` there, which
    tests/test_torch_mixed_reference.py holds to the JAX package's; for a
    bf16 x the fp32 plain versions of the same store, as the kernels
    accumulate, rounded once."""
    x, w = dev[:2]
    want = ops.bucket_matmul(*dev)
    _dirty_pool(want)
    pm.COUNT.reset()
    got = ops.packed_mixed_matmul(*dev)
    torch.cuda.synchronize()
    assert pm.COUNT.routes == {route: 1}
    assert got.dtype == x.dtype
    assert torch.equal(got, want)
    assert not got[..., w.index("pruned")].any()
    xc, wc, off, cap = cpu
    if x.dtype == torch.float32:
        plain, tol = ops.packed_mixed_matmul(xc, wc, off, cap), GEMM_TOL
    else:
        plain, tol = ops.bucket_matmul(xc.float(), wc, off, cap), BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(), plain.numpy(),
                               **tol)


def _route(x_dtype, grouped=False):
    return ("grouped_" if grouped else "") + "mixed_" + (
        "tc_1xtf32" if x_dtype == torch.bfloat16 else "tc_2xtf32")


X_DTYPES = pytest.mark.parametrize("x_dtype", [torch.float32,
                                               torch.bfloat16],
                                   ids=["fp32", "bf16"])


@pytest.mark.card
@X_DTYPES
@pytest.mark.parametrize("name", [n for n in NAMES if n.startswith("dense")])
def test_card_dense_fused_equals_per_bucket(card, name, x_dtype):
    _fused_holds(*_case(name, card, x_dtype), _route(x_dtype))


@pytest.mark.card
@X_DTYPES
@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.startswith("experts")])
def test_card_expert_stack_fused_equals_per_bucket(card, name, x_dtype):
    _fused_holds(*_case(name, card, x_dtype), _route(x_dtype))


@pytest.mark.card
@X_DTYPES
@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.startswith("grouped")])
def test_card_grouped_fused_equals_per_bucket(card, name, x_dtype):
    _fused_holds(*_case(name, card, x_dtype), _route(x_dtype, True))


@pytest.mark.card
def test_card_skinny_calls_keep_the_per_bucket_launches(card):
    w = _on(make_store(channel_bits(GROUPS * 12), 1001), card)
    x = torch.randn(8, w.k, device=card)
    pm.COUNT.reset()
    got = ops.packed_mixed_matmul(x, w)
    assert "mixed" not in "".join(pm.COUNT.routes)
    assert torch.equal(got, ops.bucket_matmul(x, w))


@pytest.mark.card
def test_card_one_graph_node_a_call(card):
    w = _on(make_store(channel_bits(GROUPS * 16), 1001), card)
    x = torch.randn(384, w.k, device=card)
    ops.packed_mixed_matmul(x, w)
    torch.cuda.synchronize()
    assert _graph_launches(lambda: ops.packed_mixed_matmul(x, w)) == 1
