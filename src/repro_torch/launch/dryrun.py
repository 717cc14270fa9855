"""Dry run: every (arch x shape x mesh) cell at full size, on the meta
device, under a ``fake`` process group of 256 / 512 ranks (port of
``repro/launch/dryrun.py``, which also does the work of the reference's
``launch/hlo.py``).

This is the one entry point of the port that does not default to the
card: it runs on the ``meta`` device by nature (shapes and dtypes, no
allocation), as the reference lowers against placeholder host devices.

Per cell this driver:
  1. builds the full-size model config and meta stand-ins for the step's
     arguments (``launch/specs.py``; ``--layers`` cuts the depth),
  2. makes them DTensors on the production mesh with the specs'
     placements (``launch/steps.shardings_for``) and runs the step once,
     under ``sharding_rules`` and the counting mode :class:`DeviceCounter`
     (and ``CommDebugMode``),
  3. records what one rank computes: ``flops_per_device`` (the
     ``torch.utils.flop_counter`` formulas over the local shards,
     replicated work included), ``bytes_traffic_per_device`` (reads +
     writes of every op that is not a view, on local shards: eager
     PyTorch fuses nothing, so each op is a kernel), the argument bytes
     (the sum of the local shards), and the collectives by op: counts,
     bytes and per-chip link bytes by the reference's ring factors
     (:func:`_ring_factor`), per mesh axis too.  A cell that fails is
     recorded as ``"status": "fail"`` with its traceback.

Where DTensor has no sharding strategy for an op of the step, the model
gathers explicitly (``sharding.ctx``: ``unshard``, ``settle``,
``pin_unsharded``, ``full_tensor`` in the MoE routing); those gathers are
counted here as the collectives they are.  On a CPU mesh DTensor runs an
all-to-all as an all-gather and a chunk, so such reshards count as
all-gathers.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-780m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both [--layers 2]
      [--out build/dryrun] [--opt moe_local,ep_pad]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc
import json
import pathlib
import time
import traceback
from collections import defaultdict
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get
from repro_torch.core.ddpg import tree_leaves
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import step_structs
from repro_torch.launch.steps import (hidden_rules, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      moe_local_rules, shardings_for)
from repro_torch.models.api import SHAPES, shape_by_name
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.sharding import specs as sh
from repro_torch.sharding.ctx import is_dtensor, sharding_rules

OPTS = ("ep_pad", "moe_local", "logits_sharded", "weight_gather",
        "quant_serve", "kv8", "compress_pod", "remat_dots")

# ops that move no bytes: allocation, views and aliases, metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "_unsafe_view",
               "_local_scalar_dense", "is_same_size", "wait_tensor",
               "_wrap_tensor_autograd", "resolve_conj", "resolve_neg",
               "sym_size", "sym_stride", "sym_numel", "dim"}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_to_all_single": "all-to-all"}


def _ring_factor(kind: str, n: int) -> float:
    """Link bytes per chip over the op's bytes, ring model (copied from the
    reference's ``launch/hlo.py``): all-gather / all-to-all move (n-1)/n
    of the result, reduce-scatter (n-1)x the scattered result, all-reduce
    2(n-1)/n."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "collective-permute":
        return 1.0
    return (n - 1) / n          # all-gather, all-to-all


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


class DeviceCounter(TorchDispatchMode):
    """Counts what one rank computes, op by op on local tensors: a DTensor
    op is handed back (``NotImplemented``) so that DTensor runs it, and its
    local ops and collectives come back through this mode.  ``axes`` maps
    a process group's name to its mesh axis name."""

    def __init__(self, axes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.axes = axes or {}
        self.flops = 0
        self.bytes_traffic = 0
        self.op_counts: Dict[str, int] = defaultdict(int)
        self.op_bytes: Dict[str, float] = defaultdict(float)
        self.axis_bytes: Dict[str, float] = defaultdict(float)
        self.per_chip_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in pytree.tree_leaves(args)):
            return out        # DTensor's shape propagation, not a kernel
        pkt = func._overloadpacket
        name = pkt.__name__
        if pkt in flop_registry:
            self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
        kind = _COLLECTIVES.get(name) \
            if "c10d_functional" in str(pkt) else None
        if kind is not None:
            group = next(a for a in reversed(args) if isinstance(a, str))
            n = dist.distributed_c10d._resolve_process_group(group).size()
            moved = _nbytes(out) * _ring_factor(kind, n)
            self.op_counts[kind] += 1
            self.op_bytes[kind] += moved
            self.axis_bytes[self.axes.get(group, "other")] += moved
            self.per_chip_bytes += moved
        elif name not in _NO_TRAFFIC and not _is_view(func):
            self.bytes_traffic += sum(_nbytes(a) for a in args) + \
                sum(_nbytes(v) for v in kwargs.values()) + _nbytes(out)
        return out


def mesh_group_axes(mesh) -> Dict[str, str]:
    """Process-group name -> mesh axis name of every dim of ``mesh``."""
    return {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}


def count_step(step, args, mesh=None, rules=None, axes=None) -> dict:
    """Run ``step(*args)`` once under :class:`DeviceCounter` (and, on a
    mesh, ``CommDebugMode`` and ``sharding_rules(mesh, rules)``); returns
    the counts of one rank.  ``axes``: group name -> axis name
    (:func:`mesh_group_axes` of ``mesh`` when None)."""
    if axes is None:
        axes = mesh_group_axes(mesh) if mesh is not None else {}
    counter = DeviceCounter(axes)
    with contextlib.ExitStack() as stack:
        comm = None
        if mesh is not None:
            from torch.distributed.tensor.debug import CommDebugMode
            comm = stack.enter_context(CommDebugMode())
            stack.enter_context(sharding_rules(mesh, rules or {}))
        stack.enter_context(counter)
        step(*args)
    arg_bytes = sum(_nbytes(t.to_local() if is_dtensor(t) else t)
                    for t in tree_leaves(list(args))
                    if isinstance(t, torch.Tensor))
    out = {"stats": {"flops_per_device": float(counter.flops),
                     "bytes_traffic_per_device": float(
                         counter.bytes_traffic),
                     "argument_bytes_per_device": float(arg_bytes)},
           "collectives": {"per_chip_bytes": counter.per_chip_bytes,
                           "op_counts": dict(counter.op_counts),
                           "op_bytes": dict(counter.op_bytes),
                           "per_axis_bytes": dict(counter.axis_bytes),
                           "warnings": []}}
    if comm is not None:
        out["collectives"]["comm_debug_counts"] = {
            str(k).rsplit(".", 1)[-1].rstrip("'>)"): v
            for k, v in comm.get_comm_counts().items()}
    return out


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` default process group of ``size`` ranks (this process is
    rank 0; collectives move nothing), torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _apply_opts(cfg, opts, mesh):
    """Optimization-variant transforms, as the reference's."""
    axes = sh.mesh_axes(mesh).shape
    rules = hidden_rules(mesh)
    dp = ("pod", "data") if "pod" in axes else "data"
    if "ep_pad" in opts and cfg.moe is not None:
        dsz = axes.get("data", 1)
        pad = -(-cfg.moe.n_experts // dsz) * dsz
        cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, pad_to=pad))
    if "moe_local" in opts and cfg.moe is not None:
        cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, local_dispatch=True))
        rules.update(moe_local_rules(mesh))
    if "logits_sharded" in opts:
        rules["logits"] = (dp, None, "model")
    if "weight_gather" in opts:
        # weight-stationary: gather FSDP shards at use, keep the TP shard
        rules["w_col"] = (None, "model")
        rules["w_row"] = ("model", None)
    if "compress_pod" in opts:
        # the step runs inside one pod: constraints name its axes only
        rules["hidden"] = ("data", None, None)
        if "logits" in rules:
            rules["logits"] = ("data", None, "model")
    return cfg, rules


def cut_depth(cfg, n_layers: Optional[int]):
    """``cfg`` with its depth cut to ``n_layers`` rounded down to whole
    periods of its pattern, at least one period (widths unchanged)."""
    if not n_layers:
        return cfg
    period = len(cfg.pattern)
    return dc.replace(cfg, n_layers=max(period,
                                        n_layers // period * period))


def _distribute(tree, specs, mesh):
    from torch.distributed.tensor import distribute_tensor

    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        spec = specs if sh.is_spec(specs) else sh.spec_at(specs, path)
        return distribute_tensor(t, mesh, sh.to_placements(spec, mesh))
    return sh.tree_map_with_path(one, tree)


def build_cell(arch_id: str, shape_name: str, mesh, opts=(),
               n_layers: Optional[int] = None):
    """(step, DTensor args, step mesh, rules, cfg) of one cell on
    ``mesh`` (a production or any other ``("pod",) "data", "model"``
    DeviceMesh).

    "pod" is pure DP (the specs replicate params over it), so on a
    multi-pod mesh the step runs on one pod's ``("data", "model")`` mesh
    with the pod's share of the batch (the whole batch when the
    reference's ``batch_specs`` does not split it over pods), and a train
    step averages its loss and gradients over the pod group
    (int8-compressed under ``compress_pod``): each rank's counts are
    those of the 3-d mesh's step.  DTensor on the 3-d mesh itself plans
    reshards of the (pod, data)-sharded batch by a graph search that
    takes minutes a step."""
    spec = get(arch_id)
    shape = shape_by_name(shape_name)
    opts = set(opts)
    step_mesh, group = mesh, None
    if "pod" in mesh.mesh_dim_names:
        step_mesh, group = mesh["data", "model"], mesh.get_group("pod")
        pods, dsz = mesh.mesh.shape[0], mesh.mesh.shape[1]
        if shape.global_batch % (pods * dsz) == 0:
            shape = dc.replace(shape, global_batch=shape.global_batch // pods)
    cfg, rules = _apply_opts(spec.config, opts, step_mesh)
    cfg = cut_depth(cfg, n_layers)
    model = LM(cfg)
    optimizer = AdamW(state_bits=8)
    structs = step_structs(spec, shape, optimizer, cfg_override=cfg,
                           quant_serve="quant_serve" in opts,
                           kv_bits=8 if "kv8" in opts else None)
    in_specs, _ = shardings_for(structs, shape.mode, cfg, shape, step_mesh)
    args = tuple(_distribute(s, ps, step_mesh) if ps is not None else s
                 for s, ps in zip(structs, in_specs))
    if shape.mode == "train":
        step = make_train_step(
            model, optimizer, compress_pod="compress_pod" in opts and
            group is not None, group=group,
            remat="dots" if "remat_dots" in opts else "full")
    elif shape.mode == "prefill":
        step = make_prefill_step(model)
    else:
        step = make_decode_step(model)
    return step, args, step_mesh, rules, cfg


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[pathlib.Path] = None, opts: tuple = (),
             n_layers: Optional[int] = None) -> dict:
    spec = get(arch_id)
    shape = shape_by_name(shape_name)
    tag = "" if not opts else "__" + "+".join(sorted(opts))
    result = {"arch": arch_id, "shape": shape_name,
              "mesh": mesh_kind + tag, "opts": sorted(opts),
              "mode": shape.mode, "status": "skip"}
    if shape_name in spec.skip_shapes:
        result["reason"] = spec.skip_reason
        _write(out_dir, result)
        return result
    unknown = set(opts) - set(OPTS)
    if unknown:
        raise ValueError(f"unknown options {sorted(unknown)}; known {OPTS}")

    t0 = time.time()
    multi = mesh_kind == "multi"
    try:
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            step, args, step_mesh, rules, cfg = build_cell(
                arch_id, shape_name, mesh, opts, n_layers)
            result.update(count_step(step, args, step_mesh, rules,
                                     axes=mesh_group_axes(mesh)))
            dts = {str(t.dtype).replace("torch.", "")
                   for t in tree_leaves(args[0])
                   if isinstance(t, torch.Tensor) and t.is_floating_point()}
            result.update(status="ok", devices=mesh.size(),
                          n_layers=cfg.n_layers,
                          dtype="bfloat16" if "bfloat16" in dts else
                          "float32",
                          tf32=bool(torch.backends.cuda.matmul.allow_tf32),
                          mesh_axes=dict(zip(mesh.mesh_dim_names,
                                             mesh.mesh.shape)))
    except Exception as e:         # recorded per cell; the run goes on
        result.update(status="fail", error=repr(e),
                      traceback=traceback.format_exc()[-4000:])
    result["wall_s"] = round(time.time() - t0, 1)
    _write(out_dir, result)
    return result


def _write(out_dir: Optional[pathlib.Path], result: dict):
    if out_dir is None:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    (out_dir / name).write_text(json.dumps(result, indent=1, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every model to this many layers (whole "
                         "periods, at least one)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list of " + ",".join(OPTS))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    opts = tuple(o for o in args.opt.split(",") if o)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or args.shape is None) \
        else [args.shape]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                f = out_dir / f"{arch}__{shape}__{mesh_kind}.json"
                if args.skip_done and f.exists():
                    prev = json.loads(f.read_text())
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[cached] {arch} {shape} {mesh_kind}: "
                              f"{prev['status']}", flush=True)
                        continue
                r = run_cell(arch, shape, mesh_kind, out_dir, opts=opts,
                             n_layers=args.layers)
                msg = r["status"]
                if r["status"] == "ok":
                    msg += (f" wall={r['wall_s']}s "
                            f"flops/dev={r['stats']['flops_per_device']:.3g}"
                            f" coll={r['collectives']['per_chip_bytes']:.3g}B")
                elif r["status"] == "fail":
                    n_fail += 1
                    msg += f" error={r['error'][:200]}"
                print(f"{arch} {shape} {mesh_kind}: {msg}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
