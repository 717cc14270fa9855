"""Ambient sharding context (port of ``repro/sharding/ctx.py``).

Model code calls ``constrain(x, role)`` at block boundaries; outside a
mesh context, or on a plain tensor, this does nothing; inside one it
redistributes a DTensor to the placements of the spec registered for that
role.  This keeps model code mesh-agnostic while the launcher pins the
activation layout (``launch/steps.hidden_rules``).

:func:`unshard` is the port's explicit gather: where DTensor has no
sharding strategy for an op of the model on a sharded dim (a head split
that does not divide the shard, say), the model first gathers those dims,
as GSPMD would insert the gather itself.  The dry run counts that gather
as a collective.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

_state = threading.local()


def _rules() -> Optional[Dict[str, tuple]]:
    return getattr(_state, "rules", None)


def current_mesh():
    """The ambient ``DeviceMesh``, or None outside a sharding_rules
    context."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Dict[str, tuple]):
    """Activate activation-sharding rules (role -> spec) for model code
    under this context, on the ``DeviceMesh`` ``mesh``.  Inside it, a
    plain tensor that meets a DTensor (positions, masks and index tensors
    the model makes) counts as replicated on the DTensor's mesh
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev_r, prev_m = _rules(), current_mesh()
    _state.rules, _state.mesh = rules, mesh
    try:
        with implicit_replication():
            yield
    finally:
        _state.rules, _state.mesh = prev_r, prev_m


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False                   # the no-mesh path's cheap answer
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, role: str):
    """``x`` redistributed to the placements of ``role``'s spec, when a
    mesh and its rules are active, the role has a spec, and ``x`` is a
    DTensor; else ``x`` itself."""
    rules, mesh = _rules(), current_mesh()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    spec = rules.get(role)
    if spec is None:
        return x
    from repro_torch.sharding.specs import to_placements
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def replicated(t, mesh):
    """``t`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    replicated on every mesh dim (no communication)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shards_on(x, dim: int) -> int:
    """How many shards tensor dim ``dim`` of ``x`` is split into (1 for a
    plain tensor)."""
    if not is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard
    dim %= x.ndim
    n = 1
    for size, p in zip(x.device_mesh.mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= size
    return n


def pin_unsharded(x, dim: int, size: int):
    """``x``, whose gradient is gathered on ``dim`` in the backward when
    some mesh axis does not divide ``size`` (the head or expert count
    behind that dim): a gradient sharded there unevenly could not be
    split or flattened by the backward of the reshape that made ``x``.
    Forward, ``dim`` is gathered too (it is the same redistribution)."""
    if is_dtensor(x) and any(size % m for m in x.device_mesh.mesh.shape):
        return unshard(x, [dim], force=True)
    return x


def unshard_uneven(x):
    """``x`` with every dim that its shards do not divide evenly gathered
    (:func:`unshard`): DTensor cannot flatten or split such a dim."""
    if not is_dtensor(x):
        return x
    return unshard(x, [d for d in range(x.ndim)
                       if x.shape[d] % shards_on(x, d)])


def unshard(x, dims, force: bool = False):
    """``x`` with every tensor dim in ``dims`` (negative counts from the
    end) replicated: the explicit gather before an op that has no sharding
    strategy for those dims.  ``force`` redistributes even when nothing
    changes, so that the backward gathers the gradient of those dims to
    the same placements.  A plain tensor passes through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % x.ndim for d in dims}
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims
                 else p for p in x.placements)
    if want == tuple(x.placements) and not force:
        return x
    return x.redistribute(x.device_mesh, want)


def settle(x):
    """``x`` with every pending reduction (a ``Partial`` placement, such
    as the masked partial sums of a vocab-sharded lookup) carried out, so
    that later ops, which have no strategy for such a placement, see a
    replicated value.  A plain tensor passes through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    want = tuple(Replicate() if isinstance(p, Partial) else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)
