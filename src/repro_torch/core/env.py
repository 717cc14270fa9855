# Port of src/repro/core/env.py: numpy throughout, as there; weights are
# copied to the host once, when the env is built (group_weight_vars).
# ``roofline`` is a core.roofline.TPURoofline or H100Roofline, used by
# RewardCfg(kind="roofline").
"""The kernel-wise quantization environment.

Wraps a model (via its QuantizableGraph + an evaluator) as the MDP the
hierarchical agent explores: states are the paper's Eq. 1 feature vectors,
one decision step per activation layer + per weight output-channel group,
and the extrinsic reward is NetScore on the quantized model's validation
accuracy (evaluated without fine-tuning, as the paper prescribes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.bound import LayerBounder
from repro_torch.core.reward import RewardCfg, extrinsic_reward, reward_summary
from repro_torch.quant.apply import get_path
from repro_torch.quant.policy import (LayerInfo, QuantMode, QuantPolicy,
                                      QuantizableGraph)

STATE_DIM = 17


def group_weight_vars(graph: QuantizableGraph, params) -> Dict[str, np.ndarray]:
    """Per-channel-group weight variance (the wvar_i state feature, also used
    by the variance-ordering action constraint)."""
    out = {}
    for layer in graph.layers:
        w = get_path(params, layer.param_path).detach().float().cpu() \
            .numpy()
        axis = layer.channel_axis % w.ndim
        w = np.moveaxis(w, axis, -1).reshape(-1, w.shape[axis])
        var = w.var(axis=0)                                   # (c_out,)
        gsz = layer.group_size
        pad = (-len(var)) % gsz
        if pad:
            var = np.pad(var, (0, pad), mode="edge")
        gv = var.reshape(-1, gsz).mean(axis=1)[: layer.n_groups]
        out[layer.name] = gv
    return out


@dataclasses.dataclass
class StepCtx:
    """Mutable episode context for building Eq. 1 states."""
    rdc: float = 0.0             # reduced logic ops so far
    gw: float = 32.0
    ga: float = 32.0
    aw_prev: float = 32.0
    aa_prev: float = 32.0


class QuantEnv:
    def __init__(self, graph: QuantizableGraph, params,
                 evaluator: Callable[[QuantPolicy], float],
                 reward_cfg: RewardCfg,
                 mode: QuantMode = QuantMode.QUANT,
                 roofline: Optional[Any] = None,
                 bounder: Optional[LayerBounder] = None):
        self.graph = graph
        self.evaluator = evaluator
        self.reward_cfg = reward_cfg
        self.mode = mode
        self.roofline = roofline
        self.bounder = bounder
        self.group_vars = group_weight_vars(graph, params)
        self._logic_full = graph.total_macs * 32.0 * 32.0
        self._cmax = float(max(max(l.c_in, l.c_out) for l in graph.layers))
        self._logic_max = float(max(l.macs for l in graph.layers))
        g_idx = 0
        self._global_idx = {}
        for layer in graph.layers:
            self._global_idx[layer.name] = g_idx
            g_idx += layer.n_groups
        self._total_groups = g_idx

    @property
    def state_dim(self) -> int:
        return STATE_DIM

    @property
    def n_layers(self) -> int:
        return len(self.graph.layers)

    def make_state(self, t: int, layer: LayerInfo, group_idx: int,
                   ctx: StepCtx, is_act_step: bool) -> np.ndarray:
        """Eq. 1 state vector, normalized to O(1) ranges."""
        gi = self._global_idx[layer.name] + min(group_idx, layer.n_groups - 1)
        rst = sum(l.macs for l in self.graph.layers[t:]) * 32.0 * 32.0
        wvar = self.group_vars[layer.name]
        wv = wvar[min(group_idx, layer.n_groups - 1)] / (wvar.max() + 1e-9)
        return np.array([
            gi / max(self._total_groups, 1),                  # i
            t / max(self.n_layers, 1),                        # t
            layer.c_in / self._cmax,                          # c_in
            layer.c_out / self._cmax,                         # c_out
            1.0,                                              # w (fmap, 1 for LM)
            1.0,                                              # h
            layer.stride / 2.0,                               # str
            layer.k / 7.0,                                    # k
            layer.macs / self._logic_max,                     # logic_t
            ctx.rdc / self._logic_full,                       # rdc
            rst / self._logic_full,                           # rst
            ctx.gw / 32.0,                                    # gw_t
            ctx.ga / 32.0,                                    # ga_t
            ctx.aw_prev / 32.0,                               # aw_{i-1}
            ctx.aa_prev / 32.0,                               # aa_i
            wv,                                               # wvar_i
            1.0 if is_act_step else 0.0,                      # step kind
        ], np.float32)

    def apply_var_ordering(self, layer: LayerInfo,
                           actions: np.ndarray) -> np.ndarray:
        """Project actions onto the paper's constraint: for any two channels,
        (aw_x/aw_y - 1)(wvar_x/wvar_y - 1) > 0 -- i.e. bit-width order follows
        weight-variance order.  Implemented as sorting the action multiset by
        the variance ranking."""
        var = self.group_vars[layer.name]
        order = np.argsort(var)                 # low variance first
        sorted_actions = np.sort(actions)       # low bits first
        out = np.empty_like(actions)
        out[order] = sorted_actions
        return out

    def account_rdc(self, layer: LayerInfo, ctx: StepCtx, wbits: np.ndarray,
                    abits: float):
        full = layer.macs * 32.0 * 32.0
        used = layer.macs * float(np.mean(wbits)) * abits
        ctx.rdc += full - used

    def episode_reward(self, policy: QuantPolicy):
        acc = float(self.evaluator(policy))
        r = extrinsic_reward(acc, self.graph, policy, self.reward_cfg,
                             roofline=self.roofline)
        summary = reward_summary(acc, self.graph, policy, self.reward_cfg)
        return acc, r, summary
