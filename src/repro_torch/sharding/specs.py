"""Partition specs for params / optimizer state / batches / caches (port of
``repro/sharding/specs.py``), and their DTensor placements.

Layout, as in the reference:

* every 2-D+ weight is sharded FSDP x TP: contraction/input dim over
  "data", output dim over "model".  Row-parallel partners (wo, wd,
  w_out) are transposed.
* MoE expert dim shards over "data" (EP) when divisible; with
  ``cfg.moe.local_dispatch`` experts are replicated over DP and TP-sharded
  on their hidden width.
* the "pod" axis is pure DP: params/opt replicated across pods, batch split.
* decode KV caches shard batch over "data" and sequence over "model";
  long_500k (batch=1) shards sequence over both.

Every dim is sharded only when divisible by the axis size; otherwise that
dim is replicated.  The rules are pure functions of (tree path, shape, mesh
axis sizes): ``mesh`` is anything with a ``.shape`` dict of axis sizes (a
``DeviceMesh`` through :func:`mesh_axes`, or a stand-in).  A spec is a
plain tuple with one entry per tensor dim: ``None``, an axis name, or a
tuple of axis names (the reference's ``PartitionSpec`` padded with
``None`` to the tensor's rank).  :func:`to_placements` turns one into
DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import types
from typing import Any, Callable, Optional, Tuple

from repro_torch.models.api import LMConfig

Spec = Tuple[Any, ...]


def mesh_axes(mesh):
    """``mesh`` as the rules read it: an object whose ``.shape`` maps axis
    name -> size.  A ``DeviceMesh`` (whose ``.shape`` is a tuple) is
    wrapped; anything else is returned as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return types.SimpleNamespace(shape=dict(zip(names, mesh.mesh.shape)))


def _axis_size(mesh, name) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def _fit(dim: int, size: int, axis: str) -> Optional[str]:
    return axis if size > 1 and dim % size == 0 else None


def _full(spec, nd: int) -> Spec:
    """``spec`` padded with None to one entry per dim."""
    spec = tuple(spec)
    return spec + (None,) * (nd - len(spec))


def tree_map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over a dict / tuple / list tree whose leaves have
    ``.shape``; the path joins dict keys and sequence indices with ``/``,
    as the reference's ``_path_str`` does."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, sub(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               cfg: Optional[LMConfig] = None) -> Spec:
    """Spec of one parameter by its tree path + shape."""
    mesh = mesh_axes(mesh)
    dsz, msz = _axis_size(mesh, "data"), _axis_size(mesh, "model")
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "q":                 # int8 serving weight: use base rules
        return param_spec(path.rsplit("/", 1)[0], shape, mesh, cfg)
    if (leaf == "s" and path.count("/")) or nd <= 1:  # scales, vectors
        return (None,) * nd

    if leaf == "embed":
        return (_fit(shape[0], msz, "model"), _fit(shape[1], dsz, "data"))
    if leaf == "unembed":
        return (_fit(shape[0], dsz, "data"), _fit(shape[1], msz, "model"))

    stacked = "blocks/" in path or path.startswith("blocks")
    lead = (None,) * (1 if stacked else 0)   # the n_repeat stack dim

    # MoE expert tensors (R, E, in, out)
    if nd - len(lead) == 3 and leaf in ("wg", "wu", "wd"):
        e, i, o = shape[len(lead):]
        if cfg is not None and cfg.moe is not None and \
                cfg.moe.local_dispatch:
            if leaf == "wd":
                return lead + (None, _fit(i, msz, "model"), None)
            return lead + (None, None, _fit(o, msz, "model"))
        e_ax = _fit(e, dsz, "data")
        if leaf == "wd":   # row-parallel: contraction (ff) over model
            i_ax = _fit(i, msz, "model")
            o_ax = None if e_ax else _fit(o, dsz, "data")
        else:
            i_ax = None if e_ax else _fit(i, dsz, "data")
            o_ax = _fit(o, msz, "model")
        return lead + (e_ax, i_ax, o_ax)

    # plain 2-D matmul weights (R, in, out)
    if nd - len(lead) == 2:
        i, o = shape[len(lead):]
        if leaf in ("wo", "wd", "w_out"):      # row-parallel
            return lead + (_fit(i, msz, "model"), _fit(o, dsz, "data"))
        if leaf == "router":                   # tiny; keep E replicated
            return lead + (_fit(i, dsz, "data"), None)
        return lead + (_fit(i, dsz, "data"), _fit(o, msz, "model"))

    # conv kernels (R, K, di): last dim on model
    if nd - len(lead) == 2 + 1 and leaf == "conv_w":
        return lead + (None, _fit(shape[-1], msz, "model"))
    spec = [None] * nd
    spec[-1] = _fit(shape[-1], msz, "model")
    spec[-2] = _fit(shape[-2], dsz, "data")
    return tuple(spec)


def param_specs(params_shape: Any, mesh, cfg: Optional[LMConfig] = None):
    """Tree of specs matching a params (shape) tree."""
    mesh = mesh_axes(mesh)
    return tree_map_with_path(
        lambda p, leaf: param_spec(p, tuple(leaf.shape), mesh, cfg),
        params_shape)


def spec_at(tree, path: str):
    """The spec at ``path`` (``a/0/b``) of a spec tree, or None."""
    node = tree
    for k in path.split("/"):
        if isinstance(node, dict):
            if k not in node:
                return None
            node = node[k]
        elif isinstance(node, (tuple, list)) and not is_spec(node):
            node = node[int(k)]
        else:
            return None
    return node if is_spec(node) else None


def is_spec(x) -> bool:
    """Whether ``x`` is a spec (a tuple of None, axis names, or tuples of
    axis names), not a tree node."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def opt_specs(opt_shape: Any, pspecs: Any, mesh):
    """Optimizer-state specs: moments inherit the param spec; 8-bit scale
    tensors (``param.shape[:-1] + (1,)``) inherit it minus the last axis."""
    def from_param(ps, shape) -> Spec:
        names = list(_full(ps, len(shape)))[: len(shape)]
        if shape and shape[-1] == 1:    # a size-1 dim cannot stay sharded
            names[-1] = None
        return tuple(names)

    def one(path, leaf):
        p = path.split("/", 1)[1]          # drop the "m" / "v" prefix
        for suffix in ("/q", "/s"):
            if p.endswith(suffix):
                p = p[: -len(suffix)]
                break
        ps = spec_at(pspecs, p)
        return from_param(ps if ps is not None else (), tuple(leaf.shape))

    return {"m": tree_map_with_path(one, opt_shape["m"], "m"),
            "v": tree_map_with_path(one, opt_shape["v"], "v"), "t": ()}


def batch_specs(batch_shape: Any, mesh) -> Any:
    """Token batches: batch dim over (pod, data) when divisible."""
    mesh = mesh_axes(mesh)
    pods, dsz = _axis_size(mesh, "pod"), _axis_size(mesh, "data")

    def one(_, leaf):
        b = leaf.shape[0]
        if pods > 1 and b % (pods * dsz) == 0:
            ax = ("pod", "data")
        elif b % dsz == 0 and dsz > 1:
            ax = "data"
        else:
            ax = None
        return (ax,) + (None,) * (len(leaf.shape) - 1)

    return tree_map_with_path(one, batch_shape)


def cache_specs(cache_shape: Any, cfg: LMConfig, mesh, long_context: bool):
    """Decode/prefill cache specs.

    Stacked attn caches: (R, B, S, Hkv, hd) -> B over data, S over model;
    long-context (B not divisible): S over (data, model).
    Mamba states: (R, B, H, P, N) -> B over data, H over model.
    Cross-attn:   (R, B, Si, Hkv, hd) -> B over data, Si over model.
    """
    mesh = mesh_axes(mesh)
    dsz, msz = _axis_size(mesh, "data"), _axis_size(mesh, "model")

    def seq_first(b, s, rest):
        if long_context or (dsz > 1 and b % dsz != 0):
            seq_ax = ("data", "model") if s % (dsz * msz) == 0 else \
                _fit(s, msz, "model")
            return (None, None, seq_ax) + rest
        return (None, _fit(b, dsz, "data"), _fit(s, msz, "model")) + rest

    def one(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v") and nd == 5:
            return seq_first(shape[1], shape[2], (None, None))
        if name in ("pos", "k_s", "v_s") and nd in (3, 4):
            return seq_first(shape[1], shape[2], (None,) * (nd - 3))
        if name == "state" and nd == 5:    # (R, B, H, P, N)
            return (None, _fit(shape[1], dsz, "data"),
                    _fit(shape[2], msz, "model"), None, None)
        if name == "conv" and nd == 4:     # (R, B, K-1, di)
            return (None, _fit(shape[1], dsz, "data"), None,
                    _fit(shape[3], msz, "model"))
        spec = [None] * nd
        if nd >= 2:
            spec[1] = _fit(shape[1], dsz, "data")
        return tuple(spec)

    return tree_map_with_path(one, cache_shape)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``, one per
    mesh dim: ``Shard(d)`` on every mesh dim whose axis name sits on
    tensor dim ``d`` (each axis of a tuple such as ``("pod", "data")``,
    which shard the dim in that order, outermost first), ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = getattr(getattr(mesh, "mesh", None), "shape", None)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        last = -1
        for a in axes:
            i = names.index(a)
            if i <= last:
                raise ValueError(f"spec {spec}: axes {axes} out of the "
                                 f"mesh's order {tuple(names)}")
            if sizes is None or sizes[i] > 1:   # one shard is a replica
                out[i] = Shard(d)
            last = i
    return tuple(out)


def tree_placements(tree_of_specs, mesh):
    """:func:`to_placements` over a tree of specs."""
    if is_spec(tree_of_specs):
        return to_placements(tree_of_specs, mesh)
    if isinstance(tree_of_specs, dict):
        return {k: tree_placements(v, mesh) for k, v in tree_of_specs.items()}
    return type(tree_of_specs)(tree_placements(v, mesh)
                               for v in tree_of_specs)
