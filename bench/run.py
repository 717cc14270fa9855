"""Benchmark of repro_torch on one NVIDIA H100: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``bench/configs/<name>.json``) and a traffic mix
(``bench/traffic/<name>.json``); ``bench/workloads/<cell>.json`` gives the
server's settings, the driver (``bench/drivers/<driver>.py``) and the
correctness check.  Set-up draws the weights and the kernel-wise policy on
the card from the seed, builds ``repro_torch``'s ServeEngine, and warms up
every shape the window uses; then the driver serves the traffic for
``--seconds``.  ``--trace 0`` reports the end-to-end metrics, ``--trace 1``
the per-layer ones (``bench/metrics/<name>.py``) from a profiled window.
After the window the plain reference (``bench/reference/``) judges a
sample of the served requests.  The last line of standard output is the
result, one JSON object; the numbers compared are also the last lines of
standard error.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package was loaded, 3.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RANGES = ("moe_dispatch", "moe_gather", "ssd_chunk_scan")


def _environment() -> None:
    """Kernel caches at fixed paths inside the checkout; the checkout's
    ``src`` and root on the import path."""
    build = ROOT / "build" / "bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host loop is single-threaded, and
    # idle intra-op threads only compete with it for the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control of the correctness check (bench/tests): the reference in
    # TF32 put in the program's place at the served positions, judged as
    # the program is; not part of a benchmark run
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(torch):
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def main(argv=None, *, require_card: bool = True, configs=None,
         fault=None) -> int:
    """One run.  Tests pass ``require_card=False`` with ``configs`` (data
    that stands in for the cell's files) and ``fault`` (a function that
    breaks the engine under the window)."""
    _environment()
    args = parse(argv)
    import torch
    torch.set_num_threads(1)
    from bench.harness import check, common, system, trace
    from bench.harness.readings import Readings
    from bench.harness.record import Record, watch_calls
    from bench.harness.traffic import Stream

    given = configs or {}
    bench = given.get("manifest") or common.manifest()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    on_card = torch.cuda.is_available()
    if require_card and (not on_card or
                         torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if on_card else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    cfg = given.get("config") or common.part("configs", cell["config"])
    mix = given.get("traffic") or common.part("traffic", cell["traffic"])
    wl = given.get("workload") or common.part("workloads", cell["name"])
    driver = importlib.import_module(f"bench.drivers.{wl['driver']}")
    seed, server = args.seed, wl["server"]

    # ------------------------------------------------------------ set-up
    if on_card:                  # the program's kernels, built in parallel
        from repro_torch.kernels.build import build
        build(cfg["serve"]["kernels"])
    policy = system.make_policy(cfg, seed)
    params = system.make_weights(cfg, seed, device)
    engine = system.build_engine(cfg, wl, params, policy, device,
                                 cfg["port"].get("variant", "config"))
    del params
    if fault is not None:
        fault(engine)
    vocab = cfg["dims"]["vocab"]
    driver.warm(engine, server, Stream(mix, seed, vocab))
    record = Record()
    tracer = trace.Tracer(bool(args.trace), on_card)
    tracer.warm()
    watch_calls(engine, record, tracer)
    stream = Stream(mix, seed, vocab)
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------------------------------------ window
    # (a driver may keep set-up that its traffic needs, and opens the
    # window itself: ``record.t0``)
    driver.drive(engine, server, mix, stream, args.seconds, tracer, record)
    setup_s = record.t0 - T_PROCESS
    tracer.stop()
    if on_card:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ metrics
    t_after = time.perf_counter()
    device_info = card_info(torch) if on_card else \
        {"platform": "cpu", "kind": "cpu", "count": 0}
    device_info["memory_peak_bytes"] = peak
    window = record.window_s
    tokens, counted_s = record.counted()
    out_metrics, breakdown = {}, None
    if args.trace:
        tracer.reduce(RANGES)
        r = Readings(cfg, record, tracer,
                     system.bucket_widths(cfg, policy), system.work(cfg))
        for m in bench["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = common.module("metrics", m["name"]).read(r)
            if value is not None:
                out_metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
        dev = r.phase("device")
        device_info["busy_s"] = r.busy_s("device")
        device_info["window_s"] = dev.seconds
        breakdown = {"device_ops": trace.top_ops(dev.kernels),
                     "idle_gaps": trace.idle_gaps(r.phase("ranges")
                                                  or dev)}
        del tracer
    else:
        e2e = {"output_tok_s": tokens / counted_s if counted_s else 0.0,
               "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            out_metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}

    # ------------------------------------------------------- correctness
    t_metrics = time.perf_counter()
    chk = wl["check"]
    rids = check.sample(record, seed, chk["requests"])
    res = check.judge(cfg, seed, policy, record, rids, device,
                      control=bool(args.control))
    numbers = {name: {"value": res[name], "limit": lim,
                      "rule": "value <= limit"}
               for name, lim in chk["limits"].items()}
    numbers["served_tokens_checked"] = {"value": res["tokens"],
                                        "limit": chk["min_tokens"],
                                        "rule": "value >= limit"}
    correct = bool(rids) and res["tokens"] >= chk["min_tokens"] and all(
        res[name] <= lim for name, lim in chk["limits"].items())
    # the checked requests that served (or, under the control, picked) a
    # token other than the reference's best, when the run is not correct
    failed = 0 if correct else sum(q["flips"] > 0 for q in res["requests"])
    result = {"correct": correct, "attempted": len(record.reqs),
              "failed": int(failed), "metrics": out_metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"seconds": window, "tokens": tokens,
                        "counted_s": counted_s,
                        "requests_finished": sum(
                            q.done for q in record.reqs.values()),
                        "setup_s": setup_s,
                        "batch_s": [b - a for a, b, _, _ in record.batches],
                        "metrics_s": t_metrics - t_after,
                        "reference_s": time.perf_counter() - t_metrics,
                        "checked": res["requests"]}
    result["check"] = numbers
    for name, n in numbers.items():
        print(f"check {name} = {n['value']!r} ({n['rule']}, limit "
              f"{n['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
