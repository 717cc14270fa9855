"""Roofline over the dry-run records, with H100 constants (port of
``repro/launch/roofline.py``).

Per (arch x shape x mesh) cell, the three roofline terms from what
``launch/dryrun.py`` counted for one rank:

  compute    = flops_per_device / peak (the step's dtype, below)
  memory     = bytes_traffic_per_device / HBM bandwidth
  collective = sum over mesh axes of that axis's per-chip link bytes /
               the axis's link bandwidth

plus MODEL_FLOPS = 6 * N_active * D (train) / 2 * N_active * D (prefill,
decode) and the usefulness ratio MODEL_FLOPS / flops_global.

Constants, NVIDIA H100 SXM5 data sheet (dense rates, no sparsity, at the
card's 700 W limit): the compute peaks and the HBM3 bandwidth that
``core/roofline.py`` states (``H100_BF16``, ``H100_TF32``, ``H100_FP32``,
``H100_HBM_BW``); NVLink 4 900 GB/s per GPU in both directions together,
450 GB/s per direction; a 400 Gb/s NIC (ConnectX-7, one per GPU in a DGX
H100) 50 GB/s.  The compute peak follows the step's dtype (bf16; fp32
with TF32 matmuls on or off).  A mesh axis whose group fits in one 8-GPU
node (its size times the sizes of the axes inside it at most 8) takes
the NVLink figure; a wider one the NIC's.  Each cell's record says which
each axis takes.

Usage: python -m repro_torch.launch.roofline [--dir build/dryrun]
       [--mesh single] [--out build/roofline.json]
Writes the JSON rows and a markdown table beside them (``.md``).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
from typing import Dict

from repro_torch.core.roofline import (H100_BF16, H100_FP32, H100_HBM_BW,
                                       H100_TF32)

NVLINK_BW = 450e9          # per direction per GPU
NIC_BW = 50e9              # 400 Gb/s per GPU
NODE_GPUS = 8

_ADVICE = {
    ("compute", "train"): "fewer recompute FLOPs: loosen the remat policy "
    "(remat_dots) and keep DTensor from replicating projections across "
    "'model' (weight_gather); the rest is useful math",
    ("compute", "prefill"): "attention tiles sized for the tensor cores "
    "(wgmma on Hopper); flops here are mostly useful",
    ("compute", "decode"): "batch more decode requests per step to amortize "
    "weight reads into tensor-core work",
    ("memory", "train"): "reduce materialized temporaries: fuse the "
    "elementwise chains and the optimizer update, chunk the vocab loss, "
    "drop f32 logit buffers",
    ("memory", "prefill"): "stream KV-cache writes and keep attention "
    "workspaces in shared memory (228 KB per SM on the H100)",
    ("memory", "decode"): "quantize weights/KV (AutoQ int8/int4 policies) -- "
    "decode is weight/KV-bandwidth bound, exactly the term AutoQ shrinks",
    ("collective", "train"): "re-balance FSDP vs TP: gather weights once per "
    "layer (not per matmul), keep TP inside an NVLink node, overlap "
    "all-gathers with compute, compress the pod-level gradient exchange "
    "to int8 (compress_pod)",
    ("collective", "prefill"): "shard sequence instead of gathering KV; "
    "combine partial softmax across shards",
    ("collective", "decode"): "keep decode activations model-sharded end-to-"
    "end; avoid per-step re-gathering of the KV cache and small tensors",
}


def count_params(cfg) -> Dict[str, float]:
    """Total and active parameter counts: expert tensors (4-d wg / wu /
    wd leaves) count top_k / n_experts of themselves as active."""
    from repro_torch.launch.specs import params_struct
    from repro_torch.models.transformer import LM
    from repro_torch.train.checkpoint import tree_flatten_with_path
    total = expert = 0
    for path, leaf in tree_flatten_with_path(params_struct(LM(cfg))):
        n = math.prod(leaf.shape)
        total += n
        if len(leaf.shape) == 4 and any(k in ("wg", "wu", "wd")
                                        for k in path):
            expert += n
    active = total - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k / cfg.moe.n_experts
    return {"total": float(total), "active": float(active)}


def model_flops(cfg, shape, n_params: Dict[str, float]) -> float:
    """6 N_active D for a train step, 2 N_active D for prefill / decode
    (D the step's tokens)."""
    toks = shape.global_batch * (1 if shape.mode == "decode" else
                                 shape.seq_len)
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n_params["active"] * toks


def compute_peak(dtype: str, tf32: bool = False) -> float:
    if dtype == "bfloat16":
        return H100_BF16
    return H100_TF32 if tf32 else H100_FP32


def axis_links(mesh_axes: Dict[str, int]) -> Dict[str, str]:
    """Each mesh axis's link: "nvlink" when its group fits in one
    8-GPU node (its size times the sizes of the axes inside it, to its
    right, at most 8), else "nic"."""
    names = list(mesh_axes)
    out = {}
    for i, n in enumerate(names):
        span = math.prod(mesh_axes[m] for m in names[i:])
        out[n] = "nvlink" if span <= NODE_GPUS else "nic"
    return out


def analyze_cell(r: dict, cfg, shape) -> dict:
    st = r.get("stats", {})
    flops_dev = st.get("flops_per_device", 0.0)
    traffic_dev = st.get("bytes_traffic_per_device", 0.0)
    n_dev = r.get("devices", 256)
    links = axis_links(r.get("mesh_axes", {}))
    t_coll = 0.0
    for ax, b in r.get("collectives", {}).get("per_axis_bytes", {}).items():
        t_coll += b / (NVLINK_BW if links.get(ax) == "nvlink" else NIC_BW)
    peak = compute_peak(r.get("dtype", "bfloat16"), r.get("tf32", False))
    t_compute = flops_dev / peak
    t_memory = traffic_dev / H100_HBM_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dom = max(terms, key=terms.get)
    npar = count_params(cfg)
    mf = model_flops(cfg, shape, npar)
    flops_global = flops_dev * n_dev
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "mode": shape.mode, "devices": n_dev, "peak_flops": peak,
        "links": links,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dom,
        "bound_s": terms[dom],
        "bound_frac": terms[dom] / max(sum(terms.values()), 1e-30),
        "roofline_frac": t_compute / max(max(terms.values()), 1e-30),
        "model_flops": mf, "flops_global": flops_global,
        "useful_ratio": mf / flops_global if flops_global else 0.0,
        "params_total": npar["total"], "params_active": npar["active"],
        "advice": _ADVICE[(dom, shape.mode)],
    }


def table(rows) -> str:
    lines = ["| arch | shape | flops/dev | bytes/dev | coll B/dev | "
             "compute s | memory s | collective s | dom | useful |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for c in rows:
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['flops_dev']:.3g} | "
            f"{c['bytes_dev']:.3g} | {c['coll_dev']:.3g} | "
            f"{c['t_compute_s']:.3g} | {c['t_memory_s']:.3g} | "
            f"{c['t_collective_s']:.3g} | {c['dominant'][:4]} | "
            f"{c['useful_ratio']:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import cut_depth
    from repro_torch.models.api import shape_by_name

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="build/roofline.json")
    args = ap.parse_args(argv)

    rows = []
    for f in sorted(pathlib.Path(args.dir).glob(f"*__{args.mesh}.json")):
        r = json.loads(f.read_text())
        if r.get("status") != "ok":
            continue
        cfg = cut_depth(ARCHS[r["arch"]].config, r.get("n_layers"))
        row = analyze_cell(r, cfg, shape_by_name(r["shape"]))
        row.update(flops_dev=r["stats"]["flops_per_device"],
                   bytes_dev=r["stats"]["bytes_traffic_per_device"],
                   coll_dev=r["collectives"]["per_chip_bytes"])
        rows.append(row)

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    md = table(rows)
    out.with_suffix(".md").write_text(md + "\n")
    print(md)


if __name__ == "__main__":
    main()
