"""Small stand-ins for the benchmark's files, for CPU tests: the smoke
presets of the configurations' architectures, short traffic and a manifest
that names them."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import common  # noqa: E402

DIMS = {
    "granite-moe-3b-a800m": {
        "d_model": 48, "n_layers": 3, "n_heads": 3, "n_kv_heads": 1,
        "head_dim": 16, "vocab": 256, "vocab_padded": 256,
        "rope_theta": 10000.0, "norm_eps": 1e-05,
        "ffn": {"kind": "moe", "n_experts": 8, "top_k": 4, "d_ff": 32}},
    "mamba2-780m": {
        "d_model": 64, "n_layers": 4, "d_state": 16, "d_conv": 4,
        "expand": 2, "head_dim": 16, "chunk": 8, "vocab": 256,
        "vocab_padded": 256, "norm_eps": 1e-05},
}
MIX = {
    "chat": {"sessions": 3, "set_size": 6,
             "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                        "min": 4, "max": 60},
             "output": {"dist": "lognormal", "median": 5, "sigma": 0.7,
                        "min": 2, "max": 12}},
    "docs": {"batch": 4, "set_size": 4,
             "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                        "min": 12, "max": 80},
             "output": {"dist": "uniform", "min": 2, "max": 5}},
}
SERVER = {
    "granite-chat": {"max_len": 80, "max_slots": 3, "page_size": 4,
                     "chunk_tokens": 8, "token_budget": 24},
    "mamba2-docs": {"max_len": 96, "max_slots": 2, "page_size": 4},
}


# cells whose files are kept under bench/ though BENCHMARK.json does not
# list them (PERF.md, Open questions); their runs are tested all the same
KEPT = {"mamba2-docs": {"config": "mamba2-780m", "traffic": "docs",
                        "chips": 1}}


def files(cell: str):
    """The cell's configuration, traffic and workload at smoke size, with a
    manifest that lists the cell."""
    man = copy.deepcopy(common.manifest())
    w = next((w for w in man["workloads"] if w["name"] == cell), None)
    if w is None:
        w = dict(KEPT[cell], name=cell, why="kept as data")
        man["workloads"].append(w)
    cfg = copy.deepcopy(common.part("configs", w["config"]))
    cfg["dims"] = copy.deepcopy(DIMS[w["config"]])
    cfg["port"]["variant"] = "smoke"
    cfg["port"]["overrides"] = {}
    mix = {**common.part("traffic", w["traffic"]), **MIX[w["traffic"]]}
    wl = copy.deepcopy(common.part("workloads", cell))
    wl["server"] = SERVER[cell]
    wl["check"].update(requests=6, min_tokens=3)
    return {"manifest": man, "config": cfg, "traffic": mix, "workload": wl}


def run(cell: str, seed: int = 1, seconds: float = 2.0, trace: int = 0,
        fault=None, limit=None, capsys=None):
    """One CPU run of ``cell``; returns the result's JSON object.
    ``limit`` replaces the check's limits (name -> limit)."""
    from bench import run as bench_run
    f = files(cell)
    if limit is not None:
        f["workload"]["check"]["limits"] = limit
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        require_card=False, configs=f, fault=fault)
    assert rc == 0
    out = capsys.readouterr().out if capsys else None
    return json.loads(out.strip().splitlines()[-1]) if out else None
