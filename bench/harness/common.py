"""Shared pieces of the benchmark: where its files are, how a part is found
by name, the card's published peaks and the spread of a set of runs."""
from __future__ import annotations

import importlib.util
import json
import statistics
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_TF32_FLOP_S = 495e12
PEAK_HBM_BYTES_S = 3.35e12


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(ROOT / "BENCHMARK.json")


def part(kind: str, name: str) -> Dict:
    """The data file ``bench/<kind>/<name>.json``."""
    path = BENCH / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return load_json(path)


def module(kind: str, name: str) -> ModuleType:
    """The Python file ``bench/<kind>/<name>.py``, loaded by its path (a
    metric's name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_groups() -> Dict[str, Dict]:
    """Every kernel group in ``bench/kernel_groups/``, by file name."""
    return {p.stem: load_json(p)
            for p in sorted((BENCH / "kernel_groups").glob("*.json"))}


def spread(values: List[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles``' default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = (len(v) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)
