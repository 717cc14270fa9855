"""BENCHMARK.json against the benchmark's contract, and every part it
names present under ``bench/``."""
import json
import re

import pytest

from bench.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|experts_per_tok|d_model|d_ff)")
MAN = common.manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_and_size():
    assert set(MAN) == TOP
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    for w in MAN["command"]:
        assert 1 <= len(w) <= 200 and "\n" not in w and "\t" not in w
        assert not w.startswith("/") and ".." not in w
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert len(c["reduced"]) <= 16 and all(
            NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        cfg = json.loads((common.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        names.append(w["name"])
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)
    mnames = []
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        mnames.append(m["name"])
    assert len(set(mnames)) == len(mnames)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


def _cells(m):
    return m.get("workloads", [w["name"] for w in MAN["workloads"]])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "output_tok_s" in e2e
    for w in MAN["workloads"]:
        got = [m["name"] for m in MAN["end_to_end"] if w["name"] in _cells(m)]
        assert "setup_s" in got and len(got) >= 2
        layer = [m for m in MAN["per_layer"] if w["name"] in _cells(m)]
        assert layer
        for m in layer:                    # it moves a metric the cell has
            assert m["moves"] in got


def test_every_part_is_present():
    cfgs = {c["name"] for c in MAN["configs"]}
    assert cfgs == {w["config"] for w in MAN["workloads"]}
    for w in MAN["workloads"]:
        assert (common.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        wl = common.part("workloads", w["name"])
        assert (common.BENCH / "drivers" / f"{wl['driver']}.py").exists()
    for m in MAN["per_layer"]:
        assert hasattr(common.module("metrics", m["name"]), "read")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers) >= 5


@pytest.mark.parametrize("n_cells", [24])
def test_budget_fits(n_cells):
    runs = 2 + 14 * n_cells
    total = runs * (MAN["run_seconds"] + 60) + n_cells * 2 * 90 + 1200
    assert total <= 43200
