"""The port's span recorder (``repro_torch.spans``) on the CPU: off without
a profiler, on the profiler's clock under one, and the counts of the
serving step's and the MoE FFN's spans on a small granite-style MoE
served through ``ServeEngine.serve``."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serve import FrontEnd, ServeEngine  # noqa: E402

ARCH = "granite-moe-3b-a800m"
# (prompt_len, n_new): more requests than slots, prompts over several
# chunks and inside one
SHAPES = [(13, 4), (5, 6), (9, 3), (3, 5), (17, 2)]
SLOTS, CHUNK, PAGE = 3, 8, 4
STEP_CHILDREN = {"step.plan", "step.upload", "step.launch", "step.sample",
                 "step.wait", "step.emit"}

_MODEL = {}


def _engine():
    if not _MODEL:
        m = LM(ARCHS[ARCH].smoke)
        _MODEL["m"] = (m, m.init(0, device="cpu"))
    m, p = _MODEL["m"]
    return m, ServeEngine(m, p, device="cpu", max_len=32)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, size=s).astype(np.int32), n)
            for s, n in SHAPES]


def _serve(profiled: bool, overlap: bool = True, **extra):
    """Serve SHAPES once; returns (streams by request, the records,
    ServeStats)."""
    m, eng = _engine()
    fe = FrontEnd()
    rids = [fe.submit(r).rid for r in _prompts(m.cfg.vocab)]
    spans.clear()
    kw = dict(page_size=PAGE, max_slots=SLOTS, chunk_tokens=CHUNK,
              token_budget=SLOTS * 3 + CHUNK - 1, overlap=overlap, **extra)
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            res = eng.serve(fe, **kw)
    else:
        res = eng.serve(fe, **kw)
    recs = spans.records()
    spans.clear()
    return [res["outputs"][r] for r in rids], recs, res["stats"]


@pytest.fixture(scope="module")
def served():
    return _serve(profiled=True)


# ------------------------------------------------------------ the recorder
def test_off_without_profiler_records_nothing_and_enters_no_range(
        monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    spans.clear()
    with spans.span("outer", rows=3) as counts:
        assert counts is None
        with spans.span("inner"):
            torch.ones(2) @ torch.ones(2)
    assert spans.records() == [] and entered == []
    # a whole serving session, MoE layers included
    _, recs, _ = _serve(profiled=False)
    assert recs == [] and entered == []


def test_span_encloses_the_profilers_own_events():
    a = torch.randn(64, 64)
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("outer", rows=7) as counts:
            assert counts == {"rows": 7}
            counts["real_rows"] = 2
            torch.mm(a, a)
    (rec,) = spans.records()
    spans.clear()
    name, t0, t1, parent, counts = rec
    assert (name, parent, counts) == ("outer", -1, {"rows": 7,
                                                    "real_rows": 2})
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("aten::mm", "outer")]
    assert {e.name() for e in events} == {"aten::mm", "outer"}
    for e in events:
        assert t0 <= e.start_ns() <= e.start_ns() + e.duration_ns() <= t1


def test_nesting_exceptions_and_the_cap(monkeypatch):
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("a"):
            with spans.span("b"):
                pass
            with pytest.raises(ValueError):
                with spans.span("c"):
                    raise ValueError
        monkeypatch.setattr(spans, "CAP", 4)
        with spans.span("d"):
            with spans.span("e"):       # past the cap
                pass
    recs = spans.records()
    assert [(r[0], r[3]) for r in recs] == [("a", -1), ("b", 0), ("c", 0),
                                             ("d", -1)]
    assert all(r[1] <= r[2] for r in recs) and spans.dropped() == 1
    a, b, c, d = recs
    assert a[1] <= b[1] <= b[2] <= c[1] <= c[2] <= a[2] <= d[1]
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_unannotated_span_is_recorded_without_a_range():
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("bare", annotate=False, rows=2):
            with spans.span("inner"):
                torch.ones(3) + 1
    recs = spans.records()
    spans.clear()
    assert [(r[0], r[3], r[4]) for r in recs] == [("bare", -1, {"rows": 2}),
                                                   ("inner", 0, {})]
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert "inner" in names and "bare" not in names


def test_profiler_changed_at_a_model_call_inside_a_step():
    """A caller that stops one profiler and starts the next at a model
    call (inside ``step`` and ``step.launch``), as a traced benchmark
    does, leaves a sound process (run apart: a fault here crashes it)."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = textwrap.dedent(f"""
        import gc, sys
        sys.path.insert(0, {str(src)!r})
        import numpy as np, torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch import spans
        from repro_torch.configs import ARCHS
        from repro_torch.models import LM
        from repro_torch.serve import FrontEnd, ServeEngine
        m = LM(ARCHS[{ARCH!r}].smoke)
        eng = ServeEngine(m, m.init(0, device="cpu"), device="cpu",
                          max_len=32)
        profs = [profile(activities=[ProfilerActivity.CPU])]
        profs[0].start()
        step = eng._model_step
        def switching(*a, **kw):
            if len(profs) < 4:
                profs[-1].stop()
                profs.append(profile(activities=[ProfilerActivity.CPU]))
                profs[-1].start()
            return step(*a, **kw)
        eng._model_step = switching
        fe = FrontEnd()
        rng = np.random.default_rng(1)
        for s, n in {SHAPES!r}:
            fe.submit((rng.integers(0, 256, size=s).astype(np.int32), n))
        eng.serve(fe, page_size=4, max_slots=3, chunk_tokens=8)
        profs[-1].stop()
        for p in profs:
            list(p.profiler.kineto_results.events())
        del profs
        gc.collect()
        print("sound", len(spans.records()))
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2] == "sound"
    assert int(out.stdout.split()[-1]) > 0


def test_moe_span_opens_no_range_and_its_children_do():
    """``moe`` is recorded without its ``record_function`` (nothing reads
    that range); ``moe_dispatch`` and ``moe_gather`` keep theirs, which
    ``moe_ms_per_step`` reads."""
    from repro_torch.models import layers
    cfg = ARCHS[ARCH].smoke
    _engine()
    _, params = _MODEL["m"]
    blk = params["blocks"][0]
    p = {k: blk[k][0] for k in ("router", "wg", "wu", "wd")}
    x = torch.randn(2, 5, cfg.d_model)
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        layers.moe_ffn(x, p, n_experts=cfg.moe.n_experts,
                       top_k=cfg.moe.top_k, capacity_factor=0)
    recs = spans.records()
    spans.clear()
    assert [(r[0], r[3]) for r in recs] == [
        (layers.MOE, -1), (layers.MOE_DISPATCH, 0), (layers.MOE_GATHER, 0)]
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert sorted(names) == sorted([layers.MOE_DISPATCH, layers.MOE_GATHER])


def test_span_cost_script_times_the_recorder_off_and_on():
    """``scripts/span_split.py``'s cost of one span: the recorder keeps
    exactly the two profiled loops' spans and nothing from the off one."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "scripts" / "span_split.py"
    spec = importlib.util.spec_from_file_location("span_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cost = mod.span_cost_us(n=50)
    assert cost["on_kept"] == 100 and spans.records() == []
    assert all(cost[k] > 0 for k in ("off_us", "on_us", "on_unannotated_us"))


# ------------------------------------------------------- the serving step
def _children(recs, i):
    return [j for j, r in enumerate(recs) if r[3] == i]


def test_step_rows_are_the_model_calls_rows(served):
    _, recs, _ = served
    steps = [i for i, r in enumerate(recs) if r[0] == "step"]
    assert steps
    for i in steps:
        rows = recs[i][4]["rows"]
        assert rows in (SLOTS * CHUNK, SLOTS)          # R x w, w in {chunk, 1}
        kids = _children(recs, i)
        assert {recs[j][0] for j in kids} <= STEP_CHILDREN
        (launch,) = [j for j in kids if recs[j][0] == "step.launch"]
        moe = [j for j in _children(recs, launch) if recs[j][0] == "moe"]
        # the model call's T is the step's R x w
        assert {recs[j][4]["pairs"] for j in moe} == {rows * 4}


def test_real_rows_sum_to_prefilled_and_decoded_tokens(served):
    outs, recs, stats = served
    steps = [r for r in recs if r[0] == "step"]
    assert stats.requeues == 0
    assert sum(r[4]["real_rows"] for r in steps) == \
        sum(p + n - 1 for p, n in SHAPES)
    assert [len(o) for o in outs] == [n for _, n in SHAPES]
    assert all(r[4]["real_rows"] <= r[4]["rows"] for r in steps)


def test_one_moe_span_a_layer_a_model_call(served):
    _, recs, _ = served
    cfg = ARCHS[ARCH].smoke
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    launches = [i for i, r in enumerate(recs) if r[0] == "step.launch"]
    assert len(launches) == sum(r[0] == "step" for r in recs)
    for i in launches:
        moe = [j for j in _children(recs, i) if recs[j][0] == "moe"]
        assert len(moe) == cfg.n_layers
        for j in moe:
            c = recs[j][4]
            T = c["pairs"] // K
            # the fake store's dense stacks keep the capacity layout (the
            # grouped one, T x K rows, takes K2 / K3 stacks alone), and
            # dropless C = T
            assert c == {"pairs": T * K, "rows": E * T}
            kids = [recs[x][0] for x in _children(recs, j)]
            assert kids == ["moe_dispatch", "moe_gather"]


def test_step_wait_is_a_child_of_step(served):
    _, recs, _ = served
    steps = [i for i, r in enumerate(recs) if r[0] == "step"]
    waits = [r for r in recs if r[0] == "step.wait"]
    in_steps = [r for r in waits if r[3] in steps]
    # overlapped: each step retires the one before it, the loop's exit
    # retires the last
    assert len(in_steps) == len(steps) - 1
    assert [r[3] for r in waits if r[3] not in steps] == [-1]
    for r in recs:
        if r[0] in STEP_CHILDREN and r[3] >= 0:
            parent = recs[r[3]]
            assert parent[0] == "step"
            assert parent[1] <= r[1] <= r[2] <= parent[2]


@pytest.mark.parametrize("overlap", [True, False])
def test_streams_equal_with_the_recorder_on_and_off(overlap):
    off, recs_off, _ = _serve(profiled=False, overlap=overlap)
    on, recs_on, _ = _serve(profiled=True, overlap=overlap)
    assert recs_off == [] and recs_on
    assert len(off) == len(on)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    if not overlap:                     # each step retires itself
        steps = [i for i, r in enumerate(recs_on) if r[0] == "step"]
        assert sum(r[0] == "step.wait" and r[3] in steps
                   for r in recs_on) == len(steps)


def test_speculative_step_spans_and_streams():
    kw = dict(speculative=True, draft_k=2, draft_layers=1)
    off, _, _ = _serve(profiled=False, **kw)
    on, recs, stats = _serve(profiled=True, **kw)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert stats.spec_steps > 0
    steps = [r for r in recs if r[0] == "step"]
    # a decode lane's verify span counts all its columns
    assert sum(r[4]["real_rows"] for r in steps) >= \
        sum(p + n - 1 for p, n in SHAPES)
    for r in recs:
        if r[0] in ("step.wait", "step.emit") and r[3] >= 0:
            assert recs[r[3]][0] == "step.sample"
            assert recs[recs[r[3]][3]][0] == "step"


def test_mamba_span_counts_a_known_chunked_step():
    """One token-budget step of granite-h-smoke over three slots: a prompt
    chunk of 5 at position 0, a decode token at position 7 and an empty
    row, at width 8.  Each of the nine mamba blocks records a ``mamba``
    span (no range) with ``rows`` 3 x 8 and ``tokens`` 6, the model call's
    real tokens; the ``ssd_chunk_scan`` range is its child.  The one
    attention block records none."""
    from repro_torch.configs.registry import get
    from repro_torch.models import ssm
    m = LM(get("granite-4.0-h-small").smoke)
    params = m.init(0, device="cpu")
    pool = m.init_paged_cache(3, 8, 4, dtype=torch.float32, device="cpu")
    R, w = 3, 8
    sent = 2 ** 31 - 1
    pos = torch.full((R, w), sent, dtype=torch.int32)
    pos[0, :5] = torch.arange(5)
    pos[1, 0] = 7
    tables = torch.zeros((R, 4), dtype=torch.int32)
    tables[0, :2] = torch.tensor([1, 2])
    tables[1, :2] = torch.tensor([3, 4])
    toks = torch.randint(0, m.cfg.vocab, (R, w))
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        layout = m.step_layout(pos.numpy(), np.arange(R), tables.numpy())
        m.model_step(params, toks, layout.upload("cpu"), pool,
                     torch.tensor([4, 0, 0]))
    recs = spans.records()
    spans.clear()
    mamba = [i for i, r in enumerate(recs) if r[0] == ssm.MAMBA]
    assert len(mamba) == sum(b.kind == "mamba" for b in m.cfg.pattern)
    for i in mamba:
        assert recs[i][4] == {"rows": R * w, "tokens": 6}
        kids = [recs[j][0] for j in _children(recs, i)]
        assert kids.count(ssm.SSD_SCAN) == 1
    scans = [r for r in recs if r[0] == ssm.SSD_SCAN]
    assert len(scans) == len(mamba) and all(r[3] in mamba for r in scans)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert ssm.MAMBA not in names and ssm.SSD_SCAN in names


# ------------------------------------------- a step wide enough to compact
WIDE_SHAPES = [(90, 3), (40, 4), (130, 2), (70, 3), (20, 5)]
WIDE_SLOTS, WIDE_CHUNK = 4, 64


@pytest.fixture(scope="module")
def served_wide():
    """granite-h-smoke served at 4 slots x 64 columns under a budget of
    the whole grid, profiled: chunk steps of 256 cells that compact to a
    rung of 128 and steps whose rung reaches 256 (padded); returns the
    model and the records."""
    from repro_torch.configs.registry import get
    m = LM(get("granite-4.0-h-small").smoke)
    eng = ServeEngine(m, m.init(0, device="cpu"), device="cpu", max_len=256)
    fe = FrontEnd()
    rng = np.random.default_rng(3)
    for s, n in WIDE_SHAPES:
        fe.submit((rng.integers(0, m.cfg.vocab, size=s).astype(np.int32), n))
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.serve(fe, page_size=PAGE, max_slots=WIDE_SLOTS,
                  chunk_tokens=WIDE_CHUNK,
                  token_budget=WIDE_SLOTS * WIDE_CHUNK)
    recs = spans.records()
    spans.clear()
    return m, recs


def test_compacted_step_counts_its_rung(served_wide):
    """``step``'s ``rows`` is the rows the row-wise layers computed: the
    rung that holds ``real_rows`` where it is below R x w, else R x w;
    each ``moe`` span inside routes that many rows, K pairs each; each
    ``mamba`` span counts the R x w cells its scan computes, the grid
    the step's rows are held to."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import compact_rows
    m, recs = served_wide
    K = m.cfg.moe.top_k
    grids = {WIDE_SLOTS * WIDE_CHUNK, WIDE_SLOTS}
    steps = [i for i, r in enumerate(recs) if r[0] == "step"]
    compacted = 0
    for i in steps:
        c = recs[i][4]
        assert set(c) == {"rows", "real_rows"}
        real, rows = c["real_rows"], c["rows"]
        (launch,) = [j for j in _children(recs, i)
                     if recs[j][0] == "step.launch"]
        inner = _children(recs, launch)
        moe = [recs[j][4] for j in inner if recs[j][0] == "moe"]
        mamba = [recs[j][4] for j in inner if recs[j][0] == ssm.MAMBA]
        assert mamba
        (grid,) = {c["rows"] for c in mamba}
        assert grid in grids                  # R x w, w in {chunk, 1}
        assert real <= rows <= grid
        assert rows == min(compact_rows(real), grid)
        compacted += rows < grid
        assert moe and {c["pairs"] for c in moe} == {rows * K}
        assert {c["tokens"] for c in mamba} == {real}
    assert compacted and compacted < len(steps)
