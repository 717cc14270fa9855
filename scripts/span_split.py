#!/usr/bin/env python3
"""One traced benchmark run of a cell, with the idle time of the window's
first phase split by the program span (``repro_torch.spans``) that holds
it, and the span recorder's own cost, on one GPU.

    python3 scripts/span_split.py --workload <cell> --seed <n> --seconds <s>

The run is ``bench/run.py --trace 1`` as it stands; the script keeps the
traced phases that the run reduces, and prints one JSON object: the run's
``correct``, metrics and device, the phase's length and idle seconds, the
idle seconds by the innermost span that holds them (``bench/harness/
program_spans.py::idle_by_span``), the spans a step, and the host
microseconds of one empty span with the recorder off and on, with and
without its ``record_function`` (:func:`span_cost_us`).  The same run
without the recorder is ``bench/run.py --trace 1`` on a checkout that
predates it, which annotates the same three profiler ranges.
"""
from __future__ import annotations

import argparse
import io
import json
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]


def span_cost_us(n: int = 20000) -> Dict[str, float]:
    """Host microseconds one empty span takes, with the recorder off and
    (under a profiler of the card alone, or of the CPU without one) on,
    with and without its ``record_function``; ``on_kept`` is the records
    the two profiled loops left."""
    import torch
    from repro_torch import spans
    from torch.profiler import ProfilerActivity, profile

    def per_span(annotate=True):
        t = time.perf_counter()
        for _ in range(n):
            with spans.span("cost", annotate=annotate, rows=1):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    spans.clear()
    off = per_span()
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else \
        [ProfilerActivity.CPU]
    with profile(activities=acts):
        on = per_span()
        bare = per_span(annotate=False)
    kept = len(spans.records())
    spans.clear()
    return {"off_us": off, "on_us": on, "on_unannotated_us": bare,
            "on_kept": kept}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from bench import run as bench_run
    bench_run._environment()
    from bench.harness import program_spans as ps
    from bench.harness import trace
    from repro_torch import spans

    phases = {}
    reduce = trace.Tracer.reduce

    def keep(self, names):
        reduce(self, names)
        phases.update((ph.name, ph) for ph in self.phases)
    trace.Tracer.reduce = keep
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(args.seed), "--seconds", str(args.seconds),
                             "--trace", "1"])
    if rc:
        print(out.getvalue()[-4000:])
        return rc
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    ph = phases["device"]
    got = ps.in_phase(ph)
    steps = sum(s[0] == "step" for _, s in got)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "correct": res["correct"],
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "device": res["device"],
        "phase_s": (ph.ns_end - ph.ns_start) / 1e9,
        "idle_s": ps.length(ps.idle(ph)) / 1e9,
        "idle_s_by_span": {k or "outside every span": v / 1e9 for k, v in
                           sorted(ps.idle_by_span(ph, got).items())},
        "steps": steps, "spans_per_step": len(got) / steps if steps else 0,
        "dropped": spans.dropped(), "span_cost": span_cost_us()}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
