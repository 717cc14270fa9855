"""The system under test, made from a configuration file and a seed.

The benchmark draws the weights and the kernel-wise policy itself, on the
device, and hands the same to ``repro_torch``'s ``ServeEngine`` and, after
the window, to the plain reference.  The configuration file names the
reference's module (``bench/reference/<family>.py``), which owns the
parameter layout; ``port`` names the program's architecture and the
settings the harness passes to it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import math
from typing import Any, Dict

import numpy as np
import torch

from bench.reference.quant import channel_bits


def family(cfg: Dict):
    """The configuration's plain reference, ``bench/reference/<family>.py``."""
    return importlib.import_module(f"bench.reference.{cfg['family']}")


def work(cfg: Dict):
    """The configuration's work counter, ``bench/work/<family>.py``."""
    return importlib.import_module(f"bench.work.{cfg['family']}")


def seed_stream(seed: int, what: str) -> np.random.Generator:
    """A numpy generator for one use (``what``) of the run's seed."""
    tag = int.from_bytes(hashlib.sha256(what.encode()).digest()[:8], "little")
    return np.random.default_rng([int(seed), tag])


def torch_seed(seed: int, what: str) -> int:
    return int(seed_stream(seed, what).integers(0, 2 ** 62))


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, Any]:
    """The parameter tree of ``cfg``'s layout, fp32, drawn on ``device``
    from one generator: one call a leaf, N(0, 1) / sqrt(fan_in), zeros or
    ones.  The same seed gives the same bits."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, "weights"))
    tree: Dict[str, Any] = {}
    for path, shape, init, fan_in in family(cfg).layout(cfg["dims"]):
        if init == "normal":
            t = torch.randn(shape, generator=g, device=device,
                            dtype=torch.float32).div_(math.sqrt(fan_in))
        elif init in ("zeros", "ones"):
            t = torch.full(shape, 0.0 if init == "zeros" else 1.0,
                           dtype=torch.float32, device=device)
        else:
            raise ValueError(f"unknown init {init!r}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    if "blocks" in tree:
        tree["blocks"] = tuple(tree["blocks"][i]
                               for i in range(len(tree["blocks"])))
    return tree


def make_policy(cfg: Dict, seed: int) -> Dict[str, Dict]:
    """Per site, the weight QBN of each channel group and the activation
    QBN.  Every seed gives each site the same multiset of QBNs (the
    configured values in turn, ``min(max_groups, c_out)`` groups), in its
    own order, so that the buckets' sizes, and with them the work, are the
    same for every seed."""
    pol = cfg["policy"]
    rng = seed_stream(seed, "policy")
    groups, act = {}, {}
    for name, _, c_out in family(cfg).sites(cfg["dims"]):
        n = min(pol["max_groups"], c_out)
        vals = np.asarray([pol["weight_qbns"][i % len(pol["weight_qbns"])]
                           for i in range(n)], np.float32)
        groups[name] = rng.permutation(vals)
        act[name] = float(pol["act_qbn"])
    return {"groups": groups, "act": act}


def site_channel_bits(cfg: Dict, policy: Dict) -> Dict[str, np.ndarray]:
    return {name: channel_bits(policy["groups"][name], c_out)
            for name, _, c_out in family(cfg).sites(cfg["dims"])}


def port_lm(cfg: Dict, variant: str = "config"):
    """The program's model for ``cfg``: its architecture's preset with the
    configuration's overrides (``"moe.capacity_factor"``: a field of a
    nested config), checked against the configuration's widths."""
    from repro_torch.configs.registry import get
    from repro_torch.models.transformer import LM
    lmc = getattr(get(cfg["port"]["arch"]), variant)
    for key, val in cfg["port"].get("overrides", {}).items():
        head, _, field = key.partition(".")
        if field:
            lmc = dataclasses.replace(
                lmc, **{head: dataclasses.replace(getattr(lmc, head),
                                                  **{field: val})})
        else:
            lmc = dataclasses.replace(lmc, **{head: val})
    d = cfg["dims"]
    want = {"d_model": lmc.d_model, "n_layers": lmc.n_layers,
            "vocab": lmc.vocab, "vocab_padded": lmc.vocab_padded}
    bad = {k: (v, d[k]) for k, v in want.items() if d[k] != v}
    if bad:
        raise ValueError(f"{cfg['name']}: the program's preset and the "
                         f"configuration differ: {bad}")
    return LM(lmc)


def program_policy(cfg: Dict, model, policy: Dict):
    """``policy`` as the program's QuantPolicy, its sites checked against
    the program's graph."""
    from repro_torch.quant.policy import QuantMode, QuantPolicy
    graph = model.graph(seq_len=1, batch=1)
    ours = {name: c_out for name, _, c_out in family(cfg).sites(cfg["dims"])}
    theirs = {l.name: l.c_out for l in graph.layers}
    if ours != theirs:
        raise ValueError(f"policy sites differ from the program's graph: "
                         f"{ours} against {theirs}")
    for l in graph.layers:
        if l.n_groups != policy["groups"][l.name].size:
            raise ValueError(f"{l.name}: {l.n_groups} groups in the "
                             "program's graph")
    return graph, QuantPolicy(QuantMode.QUANT, dict(policy["groups"]),
                              dict(policy["act"]))


def build_engine(cfg: Dict, workload: Dict, params, policy, device,
                 variant: str = "config"):
    """``repro_torch``'s ServeEngine over ``params`` with ``policy``."""
    from repro_torch.serve import ServeEngine
    model = port_lm(cfg, variant)
    graph, qp = program_policy(cfg, model, policy)
    s = cfg["serve"]
    return ServeEngine(model, params, policy=qp, graph=graph,
                       max_len=workload["server"]["max_len"],
                       weight_store=s["weight_store"],
                       attn_impl=s["attn_impl"],
                       cache_dtype=getattr(torch, s["cache_dtype"]),
                       device=device)


def bucket_widths(cfg: Dict, policy: Dict) -> Dict[str, Dict[int, int]]:
    """Per site, output channels stored at each width in bits (0: pruned):
    QBN 2 at 2 bits, 3-4 at 4, 5-8 at 8."""
    out: Dict[str, Dict[int, int]] = {}
    for name, bits in site_channel_bits(cfg, policy).items():
        b = np.rint(bits)
        width = np.select([b <= 0, b <= 2, b <= 4, b <= 8], [0, 2, 4, 8], 32)
        out[name] = {int(w): int((width == w).sum()) for w in np.unique(width)}
    return out

