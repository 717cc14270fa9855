"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``), on
disk in the reference's format, so that either package restores the
other's checkpoints.

* **atomic**: write to ``<dir>/tmp.<step>`` then ``os.replace`` to
  ``<dir>/step_XXXXXXXXXX`` -- a killed writer never corrupts the latest
  checkpoint;
* **logical layout**: ``data.npz`` holds leaf ``i`` as ``a<i>``, and
  ``manifest.json`` maps each leaf's tree-path name (dict key -> key,
  sequence index -> index, joined by ``/``, leaves in JAX's order: dict
  keys sorted) to its key, dtype and shape; restore maps onto a
  *template* tree by those names;
* **bf16-safe**: numpy cannot serialize bfloat16; such leaves are stored
  as their uint16 bit patterns with the dtype recorded in the manifest;
* **keep-k** garbage collection + auto-resume from the newest complete
  step.

``restore(shardings=)`` places each leaf on a ``DeviceMesh`` of any shape
(``distribute_tensor``), whatever mesh, if any, saved it; ``save`` takes
DTensor leaves too (gathered, written by rank 0).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import backend
from repro_torch.core.ddpg import tree_unflatten
from repro_torch.sharding.ctx import is_dtensor

# dtypes numpy cannot store, kept as bit patterns of this width
_BITCAST = {"bfloat16": (torch.int16, np.uint16),
            "float8_e4m3fn": (torch.int8, np.uint8)}


def tree_flatten_with_path(tree: Any, path: Tuple = ()
                           ) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's order: dict keys sorted, sequences
    in index order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def path_str(path) -> str:
    """A leaf's name: the reference's ``_path_str`` of the same path."""
    return "/".join(str(k) for k in path)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (stored array, dtype name); a DTensor is gathered whole
    first (a collective: every rank of its mesh calls ``save``)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if name in _BITCAST:
            as_int, store = _BITCAST[name]
            return t.view(as_int).numpy().view(store), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str,
                device: torch.device) -> torch.Tensor:
    if dtype in _BITCAST:
        as_int, _ = _BITCAST[dtype]
        signed = np.dtype(str(as_int).replace("torch.", ""))
        return torch.from_numpy(np.array(arr).view(signed)).view(
            getattr(torch, dtype)).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Write ``tree`` as step ``step``.  With DTensor leaves every rank
        calls this; the leaves are gathered and rank 0 writes (the others
        return None)."""
        leaves = [(path, _to_numpy(leaf))
                  for path, leaf in tree_flatten_with_path(tree)]
        if dist.is_initialized() and dist.get_rank() != 0 and any(
                is_dtensor(leaf) for _, leaf in tree_flatten_with_path(tree)):
            return None
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": int(step), "leaves": {}, "extra": extra or {}}
        arrays = {}
        for i, (path, (arr, dt)) in enumerate(leaves):
            key = f"a{i}"
            arrays[key] = arr
            manifest["leaves"][path_str(path)] = {
                "key": key, "dtype": dt, "shape": list(arr.shape)}
        np.savez(tmp / "data.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device: backend.DeviceLike = None, shardings: Any = None,
                mesh=None):
        """Restore onto the structure of ``like`` (a template tree whose
        leaves have ``.shape``), as tensors on ``device`` (the card when
        None).  ``shardings``: a tree like ``like`` of DTensor placements
        (with ``mesh``, a ``DeviceMesh``) or of ``DTensorSpec``s (which
        carry their mesh); each leaf is then loaded whole on its mesh's
        device and ``distribute_tensor``-ed onto it, each rank keeping its
        own shards (no communication), on a mesh of any shape.  Returns
        (step, tree, extra)."""
        if shardings is None:
            device = backend.resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = []
        with np.load(d / "data.npz") as data:
            for path, leaf in tree_flatten_with_path(like):
                name = path_str(path)
                if name not in manifest["leaves"]:
                    raise KeyError(f"checkpoint missing leaf {name}")
                meta = manifest["leaves"][name]
                arr = data[meta["key"]]
                want = tuple(leaf.shape)
                if tuple(arr.shape) != want:
                    raise ValueError(f"shape mismatch for {name}: ckpt "
                                     f"{arr.shape} vs {want}")
                if shardings is None:
                    leaves.append(_from_numpy(arr, meta["dtype"], device))
                else:
                    leaves.append(_distribute(
                        arr, meta["dtype"], _at(shardings, path), mesh))
        return step, tree_unflatten(like, leaves), manifest.get("extra", {})


def _at(tree, path):
    """The node of ``tree`` at ``path`` (a placements tuple or a
    ``DTensorSpec`` stops the walk)."""
    for k in path:
        tree = tree[k]
    return tree


def _distribute(arr, dtype: str, sharding, mesh):
    from torch.distributed.tensor import distribute_tensor
    placements = getattr(sharding, "placements", sharding)
    mesh = getattr(sharding, "mesh", mesh)
    if mesh is None:
        raise ValueError("placements without a mesh: pass mesh= or "
                         "DTensorSpecs")
    t = _from_numpy(arr, dtype, torch.device(mesh.device_type))
    return distribute_tensor(t, mesh, placements, src_data_rank=None)
