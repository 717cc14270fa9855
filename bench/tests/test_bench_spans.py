"""The readers of the program's spans (``bench/harness/program_spans.py``,
``real_row_share``, ``expert_pair_share``, ``idle_host_share``) on hand-
made kernels and spans, and in a traced smoke run."""
import sys

import pytest

from bench.harness import common, program_spans
from bench.harness.trace import Phase
from bench.tests import smoke

NEW = ("real_row_share", "expert_pair_share", "idle_host_share")


class _Readings:
    def __init__(self, ph):
        self._ph = ph

    def phase(self, name):
        return self._ph if name == "device" else None


def _phase(kernels, lo=0, hi=100):
    ph = Phase("device")
    ph.ns_start, ph.ns_end = lo, hi
    ph.kernels = sorted((s, e - s, "k") for s, e in kernels)
    return ph


@pytest.fixture
def records(monkeypatch):
    """Hand-made spans in place of the recorder's."""
    from repro_torch import spans
    recs = []
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    return recs


def _read(name, ph):
    return common.module("metrics", name).read(_Readings(ph))


# ----------------------------------------------------------- intervals
def test_interval_arithmetic():
    m = program_spans.merged([(5, 9), (0, 2), (1, 3), (9, 10), (4, 4)])
    assert m == [(0, 3), (5, 10)]
    assert program_spans.subtract([(0, 10), (20, 30)],
                                  [(2, 4), (8, 22), (25, 26)]) == \
        [(0, 2), (4, 8), (22, 25), (26, 30)]
    assert program_spans.overlap_ns([(0, 10), (20, 30)],
                                    [(5, 25), (29, 40)]) == 5 + 5 + 1
    assert program_spans.length([(0, 3), (5, 10)]) == 8


def test_idle_host_share_by_hand(records):
    # the phase [0, 100); kernels leave the gaps [10, 20), [30, 50),
    # [60, 70) and [90, 100)
    ph = _phase([(0, 10), (20, 30), (50, 60), (70, 90)])
    records += [
        ("step", 5, 45, -1, {}),          # holds [10, 20) and [30, 45)
        ("step.wait", 12, 18, 0, {}),     # a gap inside step.wait: 6 out
        ("step.launch", 35, 40, 0, {}),
        ("step", 65, 80, -1, {}),         # across the gap's edge: [65, 70)
        ("moe", 66, 68, 3, {}),
    ]
    # inside a step, outside its wait: 4 + 15 + 5; [45, 50), [60, 65) and
    # [90, 100) lie outside every step
    assert _read("idle_host_share", ph) == pytest.approx(24.0)
    split = program_spans.idle_by_span(ph, list(enumerate(records)))
    assert split == {"step": 4 + 10 + 3, "step.wait": 6, "step.launch": 5,
                     "moe": 2, "": 5 + 5 + 10}
    assert sum(split.values()) == program_spans.length(
        program_spans.idle(ph))


def test_spans_outside_the_phase_are_left_out(records):
    ph = _phase([(0, 10)], lo=0, hi=100)
    records += [("step", 20, 30, -1, {"rows": 10, "real_rows": 5}),
                ("step", 150, 160, -1, {"rows": 10, "real_rows": 10}),
                ("step", 40, 0, -1, {"rows": 10, "real_rows": 10})]  # open
    assert _read("real_row_share", ph) == pytest.approx(50.0)
    assert _read("idle_host_share", ph) == pytest.approx(10.0)


def test_share_readers_by_hand(records):
    ph = _phase([(0, 100)])
    records += [
        ("step", 1, 50, -1, {"rows": 48, "real_rows": 7, "lanes": 3}),
        ("step.launch", 2, 40, 0, {}),
        ("moe", 3, 10, 1, {"pairs": 192, "rows": 384}),
        ("moe", 11, 20, 1, {"pairs": 192, "rows": 384}),
        ("step", 51, 99, -1, {"rows": 3, "real_rows": 3, "lanes": 3}),
        ("step.launch", 52, 90, 4, {}),
        ("moe", 53, 60, 5, {"pairs": 12, "rows": 24}),
    ]
    assert _read("real_row_share", ph) == pytest.approx(100.0 * 10 / 51)
    assert _read("expert_pair_share", ph) == pytest.approx(
        100.0 * 396 / 792)
    # the card never idled
    assert _read("idle_host_share", ph) == 0.0


def test_readers_without_spans_return_none(records, monkeypatch):
    ph = _phase([(0, 10)])
    for name in NEW:
        assert _read(name, ph) is None
    # a program without the recorder (the parent of this change)
    records.append(("step", 1, 5, -1, {"rows": 4, "real_rows": 1}))
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    for name in NEW:
        assert _read(name, ph) is None


# ----------------------------------------------------------- a smoke run
def test_traced_smoke_run_reports_the_span_metrics(capsys):
    from repro_torch import spans
    spans.clear()
    res = smoke.run("granite-chat", seed=2 ** 31 + 5, trace=1,
                    capsys=capsys)
    m = res["metrics"]
    assert set(NEW) <= set(m)
    ffn = smoke.DIMS["granite-moe-3b-a800m"]["ffn"]
    assert m["expert_pair_share"]["value"] == pytest.approx(
        100.0 * ffn["top_k"] / ffn["n_experts"])
    assert 0 < m["real_row_share"]["value"] <= 100
    assert 0 <= m["idle_host_share"]["value"] <= 100
    assert "moe_ms_per_step" in m
    assert spans.dropped() == 0
    spans.clear()


def test_untraced_smoke_run_records_no_spans(capsys):
    from repro_torch import spans
    spans.clear()
    res = smoke.run("granite-chat", seed=3, trace=0, capsys=capsys)
    assert not set(NEW) & set(res["metrics"])
    assert spans.records() == []
