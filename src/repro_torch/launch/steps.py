"""Train / prefill / decode steps and their sharding trees (port of
``repro/launch/steps.py``).

A step is a plain function; the caller runs it under
``sharding_rules(mesh, rules)`` on DTensor arguments placed by
:func:`shardings_for` (``sharding.specs.tree_placements``), as the
reference jits it with those shardings.  On plain tensors it is the
unsharded step.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

from repro_torch.models.api import LMConfig, ShapeCfg
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.sharding import specs as sh
from repro_torch.train.loop import value_and_grad


def _dp(mesh):
    return ("pod", "data") if "pod" in sh.mesh_axes(mesh).shape else "data"


def hidden_rules(mesh) -> dict:
    """Activation constraints model code applies at block boundaries."""
    return {"hidden": (_dp(mesh), None, None)}


def moe_local_rules(mesh) -> dict:
    """Local MoE dispatch: pin the per-DP-shard token groups
    (``models.layers.moe_ffn``).  Right for small-expert MoE (granite),
    where replicating experts across DP is cheap; large-expert MoE (jamba)
    keeps EP sharding instead."""
    return {"moe_group": (_dp(mesh), None, None)}


def make_train_step(model: LM, optimizer: AdamW, lr: float = 1e-4,
                    compress_pod: bool = False, group=None,
                    remat="full") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``LM.loss`` and its gradient, then
    ``AdamW.update``.  ``compress_pod``: each rank's loss and gradient
    are of its local batch, and ``sharding.collectives
    .compressed_allreduce`` over ``group`` (the pod group; the default
    group when None) is the step's only exchange of gradients and loss.
    Without ``compress_pod``, a ``group`` averages them with a plain
    all-reduce (the pure-DP pod axis), and no group means no exchange
    beyond what the step's DTensors do.  ``remat``: "full" checkpoints
    each repeat, "dots" keeps its matmul outputs (``LM.loss``)."""
    remat_arg = "dots" if remat == "dots" else True

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: model.loss(p, batch, remat=remat_arg), params)
        if compress_pod or group is not None:
            from repro_torch.sharding.collectives import mean_allreduce
            out = mean_allreduce({"g": grads, "l": loss}, group,
                                 compress=compress_pod)
            loss, grads = out["l"], out["g"]
        params, opt_state, om = optimizer.update(params, grads, opt_state,
                                                 lr=lr)
        return params, opt_state, {"loss": loss, **om}
    return train_step


def make_prefill_step(model: LM) -> Callable:
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model: LM) -> Callable:
    def decode_step(params, tokens, cache, pos):
        return model.decode_step(params, tokens, cache, pos)
    return decode_step


def shardings_for(spec_structs: Tuple[Any, ...], mode: str, cfg: LMConfig,
                  shape: ShapeCfg, mesh):
    """(in_specs, out_specs) spec trees, the reference's jit shardings;
    ``sharding.specs.tree_placements`` turns them into placements."""
    axes = sh.mesh_axes(mesh).shape
    long_ctx = shape.name == "long_500k" or (
        shape.mode == "decode" and
        shape.global_batch % max(axes.get("data", 1), 1) != 0)
    if mode == "train":
        p_sds, o_sds, b_sds = spec_structs
        ps = sh.param_specs(p_sds, mesh, cfg)
        os_ = sh.opt_specs(o_sds, ps, mesh)
        bs = sh.batch_specs(b_sds, mesh)
        return (ps, os_, bs), (ps, os_, None)
    if mode == "prefill":
        p_sds, b_sds, c_sds = spec_structs
        ps = sh.param_specs(p_sds, mesh, cfg)
        bs = sh.batch_specs(b_sds, mesh)
        cs = sh.cache_specs(c_sds, cfg, mesh, long_context=long_ctx)
        return (ps, bs, cs), (None, cs)
    p_sds, t_sds, c_sds, _ = spec_structs
    ps = sh.param_specs(p_sds, mesh, cfg)
    ts = sh.batch_specs(t_sds, mesh)
    cs = sh.cache_specs(c_sds, cfg, mesh, long_context=long_ctx)
    return (ps, ts, cs, None), (None, cs)
