"""The compacted token-budget step on the CPU: ``LM.model_step`` over a
step layout whose cells are its real ones (``LM.step_layout``) runs its
row-wise layers on those rows alone, and every real cell gets the bits
the whole grid's layout gives it -- its logits, the K/V written into its
pages and their positions, and the mamba state and conv window written
back to its slot.

* The ladder (``transformer.compact_rows``) and when a step compacts
  (``LM.step_layout``): never at or above R x w, never with a
  capacity-limited MoE.
* One step of 4 x 128 cells holding 1, 127, 128, 129 or 400 real ones
  (a fresh prompt chunk, chunks that continue, a decode token, an empty
  row) on granite-moe (packed store, activation QBN 8), granite-4.0-h
  (packed), mamba2 (conv over x alone) and gemma2 (dense GQA), over its
  cells and over the whole grid; the zeroed-state fault reaches the
  compacted step's scan.
* Served at 4 slots x 64 columns: overlap on == off == the whole-grid
  loop == speculative decode, ``trace_counts["model_step"]`` one shape
  per width and rung, each compacted call's rows a rung; a
  capacity-limited MoE serves the whole grid.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.layers import POS_SENTINEL  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.transformer import compact_rows  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

R, W, PAGE = 4, 128, 4
STARTS = (0, 24, 7, 50)          # row 0 a fresh prompt, row 3 a decode lane
N_BLOCKS = (max(STARTS) + W) // PAGE + 1
PRESETS = ("granite-moe-3b-a800m", "granite-4.0-h-small", "mamba2-780m",
           "gemma2-2b")
PACKED = ("granite-moe-3b-a800m", "granite-4.0-h-small")
_ENG = {}


def _cells(m, pos):
    """The cells of the step layout over ``pos`` (None: the whole
    grid)."""
    R = pos.shape[0]
    return m.step_layout(pos, np.arange(R), np.zeros((R, 1), np.int32)).cells


def _cfg(arch):
    return get(arch).smoke if arch == "granite-4.0-h-small" else \
        ARCHS[arch].smoke


def _policy(m, seed=1, act=8.0):
    graph = m.graph(seq_len=1, batch=1)
    rng = np.random.default_rng(seed)
    return QuantPolicy(
        QuantMode.QUANT,
        {l.name: rng.choice([0, 2, 4, 8], size=l.n_groups).astype(
            np.float32) for l in graph.layers},
        {l.name: act for l in graph.layers})


def _engine(arch, cfg=None):
    """A CPU engine over the preset's smoke weights: a kernel-wise policy
    on the packed store (grouped experts on K2 / K3's plain versions) for
    the granite presets, the dense store otherwise."""
    key = (arch, cfg)
    if key not in _ENG:
        m = LM(cfg or _cfg(arch))
        params = m.init(0, device="cpu")
        if arch in PACKED:
            _ENG[key] = ServeEngine(m, params, policy=_policy(m),
                                    weight_store="packed", max_len=512,
                                    device="cpu")
        else:
            _ENG[key] = ServeEngine(m, params, max_len=512, device="cpu")
    return _ENG[key]


# ------------------------------------------------------------- the ladder
def test_ladder_rungs_and_when_a_step_compacts():
    assert [compact_rows(n) for n in (0, 1, 127, 128, 129, 1024, 1025,
                                      1536, 1537, 4096)] == \
        [128, 128, 128, 128, 256, 1024, 1536, 1536, 2048, 4096]
    rungs = {compact_rows(n) for n in range(1, 4097)}
    assert len(rungs) == 14 and all(r % 128 == 0 for r in rungs)
    m = LM(_cfg("granite-moe-3b-a800m"))

    def rows(n, R, w):
        pos = np.full((R, w), POS_SENTINEL, np.int32)
        pos.reshape(-1)[:n] = np.arange(n)
        cells = _cells(m, pos)
        return None if cells is None else len(cells)
    assert rows(350, 16, 256) == 384
    assert rows(16, 16, 1) is None                # pure decode: whole grid
    assert rows(20, 3, 8) is None                 # a small grid: whole
    assert rows(129, 4, 64) is None               # the rung reaches R x w
    cfg = m.cfg
    capped = LM(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25)))
    pos = np.full((16, 256), POS_SENTINEL, np.int32)
    pos[:, 0] = 7
    assert len(_cells(m, pos)) == 128
    assert _cells(capped, pos) is None


def test_compact_cells_are_the_real_cells_then_the_first_sentinels():
    """``step_layout``: every real cell, then the first sentinel cells up
    to the rung, ascending; the real count, the rows' slots and tables;
    the host's positions are left as they are."""
    m = LM(_cfg("mamba2-780m"))
    pos = np.full((3, 64), POS_SENTINEL, np.int32)
    pos[0, :2] = [5, 6]
    pos[2, :1] = [9]
    before = pos.copy()
    tables = np.arange(12, dtype=np.int32).reshape(4, 3)
    layout = m.step_layout(pos, np.array([3, 0, 2], np.int32), tables)
    np.testing.assert_array_equal(pos, before)
    cells = layout.cells
    assert cells.dtype == np.int64 and len(cells) == 128
    np.testing.assert_array_equal(cells, np.r_[0:127, 128])
    assert layout.real == 3 and layout.n_rows == 128
    np.testing.assert_array_equal(layout.slot_map, [3, 0, 2])
    np.testing.assert_array_equal(layout.tables, tables[[3, 0, 2]])
    pos[1, :] = np.arange(64)                     # 67 real of 192
    np.testing.assert_array_equal(_cells(m, pos), np.r_[0:63, 64:129])


# --------------------------------------------------------- one step, bits
def _layout(n):
    """Real-cell counts per row: row 3's decode token first, then rows 0,
    1, 2 up to W, then row 3."""
    lens = [0, 0, 0, min(n, 1)]
    left = n - lens[3]
    for r in (0, 1, 2, 3):
        take = min(W - lens[r], left)
        lens[r] += take
        left -= take
    assert left == 0
    return lens


def _step_inputs(m, n, seed):
    """(tokens, positions, tables, logit_cols, pool) of one step with
    ``n`` real cells; the pool holds each row's earlier positions (random
    K/V) and random mamba state and windows."""
    rng = np.random.default_rng(seed)
    lens = _layout(n)
    pos = np.full((R, W), POS_SENTINEL, np.int32)
    for r, (s, c) in enumerate(zip(STARTS, lens)):
        pos[r, :c] = np.arange(s, s + c)
    tables = (1 + np.arange(R)[:, None] * N_BLOCKS +
              np.arange(N_BLOCKS)[None]).astype(np.int32)
    pool = m.init_paged_cache(R, 1 + R * N_BLOCKS, PAGE,
                              dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for entry in pool:
        for key, t in entry.items():
            if key != "pos":
                t.copy_(torch.randn(t.shape, generator=g))
        if "pos" in entry:
            for r, s in enumerate(STARTS):
                for p in range(s):
                    entry["pos"][:, tables[r, p // PAGE], p % PAGE] = p
    toks = rng.integers(0, m.cfg.vocab, (R, W))
    cols = np.maximum(np.asarray(lens) - 1, 0)
    return toks, pos, tables, cols, pool, lens


@pytest.mark.parametrize("n", [1, 127, 128, 129, 400])
@pytest.mark.parametrize("arch", PRESETS)
def test_compact_step_equals_padded_step_bit_for_bit(arch, n):
    eng = _engine(arch)
    m = eng.model
    toks, pos, tables, cols, pool, lens = _step_inputs(m, n, seed=n)
    layout = m.step_layout(pos, np.arange(R), tables)
    if n == 400:                    # the rung reaches R x w: whole grid
        assert layout.cells is None
        return
    rows = compact_rows(n)
    assert rows < R * W and layout.cells.shape == (rows,)
    toks, cols = torch.tensor(toks), torch.tensor(cols)
    pool_c = copy.deepcopy(pool)
    want, pool = m.model_step(eng.params, toks,
                              layout._replace(cells=None).upload("cpu"),
                              pool, cols, eng.act_bits, attn_impl="cuda")
    got, pool_c = m.model_step(eng.params, toks, layout.upload("cpu"),
                               pool_c, cols, eng.act_bits, attn_impl="cuda")
    assert got.shape == want.shape
    for r in range(R):
        if lens[r]:
            assert torch.equal(got[r], want[r]), f"logits of row {r}"
    for i, (a, b) in enumerate(zip(pool, pool_c)):
        for key in a:
            # page 0 is the trash page: sentinel cells write there
            x, y = (a[key], b[key]) if key in ("state", "conv") else \
                (a[key][:, 1:], b[key][:, 1:])
            assert torch.equal(x, y), f"entry {i}: {key}"


def test_zeroed_state_reaches_the_compacted_step(monkeypatch):
    """The zeroed-state fault (``tests/test_torch_granite_hybrid.py``'s
    control) wraps the one ``mamba_step`` call that every layout makes,
    so it changes a compacted step's logits too."""
    eng = _engine("granite-4.0-h-small")
    m = eng.model
    toks, pos, tables, cols, pool, lens = _step_inputs(m, 129, seed=3)
    layout = m.step_layout(pos, np.arange(R), tables).upload("cpu")
    toks, cols = torch.tensor(toks), torch.tensor(cols)
    sound, _ = m.model_step(eng.params, toks, layout, copy.deepcopy(pool),
                            cols, eng.act_bits, attn_impl="cuda")
    step, seen = ssm_mod.mamba_step, []

    def forgetful(params, x, cache, layout, cfg, d_model):
        seen.append(layout.cells)
        cache = {k: torch.zeros_like(v) for k, v in cache.items()}
        return step(params, x, cache, layout, cfg, d_model)
    monkeypatch.setattr(ssm_mod, "mamba_step", forgetful)
    faulty, _ = m.model_step(eng.params, toks, layout, pool, cols,
                             eng.act_bits, attn_impl="cuda")
    assert seen and all(c is not None for c in seen)
    for r in range(R):
        if lens[r] and STARTS[r]:           # a row that carries state
            assert not torch.equal(faulty[r], sound[r]), r


# ------------------------------------------------------------- served
SERVE_SHAPES = [(90, 3), (40, 4), (130, 2), (70, 3), (20, 5), (150, 2)]
SLOTS, CHUNK = 4, 64


def _serve(eng, **kw):
    """Serve SERVE_SHAPES at SLOTS x CHUNK with a budget of the whole
    grid (``kw``: ``run``'s other arguments); returns (streams, [(real
    tokens, cells or None, grid)])."""
    calls = []
    step = eng._model_step

    def spy(*a, **kw):
        cells = a[2].cells
        calls.append((a[2].real, None if cells is None else
                      int(cells.shape[0]), a[1].numel()))
        return step(*a, **kw)

    eng._model_step = spy
    try:
        rng = np.random.default_rng(11)
        reqs = [(rng.integers(0, eng.model.cfg.vocab, size=s).astype(
            np.int32), k) for s, k in SERVE_SHAPES]
        res = eng.run(reqs, page_size=PAGE, max_slots=SLOTS,
                      chunk_tokens=CHUNK, token_budget=SLOTS * CHUNK, **kw)
    finally:
        eng._model_step = step
    return res["outputs"], calls


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "granite-4.0-h-small"])
def test_served_compacted_streams(arch, monkeypatch):
    eng = _engine(arch)
    on, calls = _serve(eng)
    off, _ = _serve(eng, overlap=False)
    # a shape per width (R x 1, R x CHUNK) and, at the wide one, per rung
    # below it: the compacted rows are one more input of the call
    wide = SLOTS * CHUNK
    most = 1 + len({min(compact_rows(n), wide) for n in range(1, wide + 1)})
    assert eng.trace_counts["model_step"] <= most
    assert len({(grid, rows) for _, rows, grid in calls}) <= most
    compacted = [c for c in calls if c[1] is not None]
    assert compacted and any(c[1] is None and c[2] > SLOTS for c in calls)
    for real, rows, grid in calls:
        if rows is None:
            assert compact_rows(real) >= grid
        else:
            assert rows == compact_rows(real) < grid
    build = LM.step_layout
    monkeypatch.setattr(LM, "step_layout", lambda self, *a: build(
        self, *a)._replace(cells=None))
    padded, calls_p = _serve(eng)
    assert all(c[1] is None for c in calls_p)
    for a, b, c in zip(on, off, padded):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_speculative_compacted_run_equals_plain_run():
    """The verify steps compact (the draft passes compute their whole
    grids) and emit the plain streams."""
    eng = _engine("granite-moe-3b-a800m")
    plain, _ = _serve(eng)
    spec, calls = _serve(eng, speculative=True, draft_k=3, draft_layers=1)
    assert any(rows is not None for _, rows, _ in calls)
    for a, b in zip(plain, spec):
        np.testing.assert_array_equal(a, b)


def test_capacity_limited_moe_serves_padded():
    cfg = _cfg("granite-moe-3b-a800m")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    eng = _engine("granite-moe-3b-a800m", cfg)
    outs, calls = _serve(eng)
    assert [len(o) for o in outs] == [k for _, k in SERVE_SHAPES]
    assert any(compact_rows(real) < grid for real, _, grid in calls)
    assert all(rows is None for _, rows, _ in calls)
