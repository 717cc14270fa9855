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

``restore`` takes ``device=`` where the reference takes ``shardings=``:
re-sharding onto another mesh is not ported (ROADMAP.md A11).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core.ddpg import tree_unflatten

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
    """A leaf as (stored array, dtype name)."""
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
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": int(step), "leaves": {}, "extra": extra or {}}
        arrays = {}
        for i, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
            arr, dt = _to_numpy(leaf)
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
                device: backend.DeviceLike = None, shardings: Any = None):
        """Restore onto the structure of ``like`` (a template tree whose
        leaves have ``.shape``), as tensors on ``device`` (the card when
        None).  Returns (step, tree, extra)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto shardings is not ported yet: ROADMAP.md A11 "
                "(sharding); pass device= instead")
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
                leaves.append(_from_numpy(arr, meta["dtype"], device))
        return step, tree_unflatten(like, leaves), manifest.get("extra", {})
