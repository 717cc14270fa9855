# Port of src/repro/core/flat.py: the DDPG is seeded from a torch.Generator
# in place of a jax.random key; the rest is the reference's.
"""Flat (non-hierarchical) DDPG baselines.

* granularity="layer": one (wbits, abits) action per layer -- the HAQ-style
  layer-level search the paper compares against (X-L rows).
* granularity="channel": one action per channel group without goals -- the
  "traditional DDPG-based AutoQB" of Fig. 8, showing why the huge flat
  channel-level space needs the hierarchy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch import backend
from repro_torch.core.agent import EpisodeLog
from repro_torch.core.ddpg import DDPG, DDPGConfig, ReplayBuffer
from repro_torch.core.env import QuantEnv, StepCtx
from repro_torch.quant.policy import QuantPolicy


class FlatAgent:
    def __init__(self, env: QuantEnv, seed: int = 0, gamma: float = 0.95,
                 granularity: str = "channel", max_bits: float = 8.0,
                 updates_per_episode=None,
                 device: backend.DeviceLike = None):
        assert granularity in ("layer", "channel")
        self.env = env
        self.granularity = granularity
        self.max_bits = max_bits
        sd = env.state_dim
        adim = 2 if granularity == "layer" else 1
        self.ddpg = DDPG(DDPGConfig(state_dim=sd, action_dim=adim,
                                    gamma=gamma, action_scale=max_bits),
                         seed, device)
        self.buf = ReplayBuffer(sd, adim)
        self.rng = np.random.default_rng(seed)
        self.updates_per_episode = updates_per_episode

    def run_episode(self, noise: float, train: bool = True
                    ) -> Tuple[EpisodeLog, QuantPolicy]:
        env = self.env
        graph = env.graph
        if env.bounder is not None:
            env.bounder.reset()
        ctx = StepCtx()
        policy = QuantPolicy(mode=env.mode, weight_bits={}, act_bits={})
        transitions = []

        for t, layer in enumerate(graph.layers):
            if self.granularity == "layer":
                s = env.make_state(t, layer, 0, ctx, is_act_step=True)
                a = self.ddpg.act(s, noise, self.rng)
                a = np.clip(np.round(a), 0, self.max_bits)
                if env.bounder is not None:
                    gw, ga = env.bounder.bound_pair(t, float(a[0]),
                                                    float(a[1]))
                    a = np.round([gw, ga])
                wbits = np.full(layer.n_groups, float(a[0]), np.float32)
                aa = float(a[1])
                transitions.append([s, a.astype(np.float32), 0.0, s, 0.0])
            else:
                s = env.make_state(t, layer, 0, ctx, is_act_step=True)
                aa = float(np.clip(np.round(
                    self.ddpg.act(s, noise, self.rng)[0]), 0, self.max_bits))
                transitions.append([s, np.array([aa], np.float32), 0.0, s,
                                    0.0])
                wbits = np.zeros(layer.n_groups, np.float32)
                for gi in range(layer.n_groups):
                    si = env.make_state(t, layer, gi, ctx, is_act_step=False)
                    aw = float(np.clip(np.round(
                        self.ddpg.act(si, noise, self.rng)[0]), 0,
                        self.max_bits))
                    wbits[gi] = aw
                    ctx.aw_prev = aw
                    transitions.append([si, np.array([aw], np.float32), 0.0,
                                        si, 0.0])
                wbits = env.apply_var_ordering(layer, wbits)
            ctx.aa_prev = aa
            policy.weight_bits[layer.name] = wbits
            policy.act_bits[layer.name] = aa
            env.account_rdc(layer, ctx, wbits, aa)

        acc, R, summary = env.episode_reward(policy)
        transitions[-1][2] = R
        transitions[-1][4] = 1.0
        for j in range(len(transitions) - 1):
            transitions[j][3] = transitions[j + 1][0]
        for s, a, r, s2, d in transitions:
            self.buf.push(s, a, r, s2, d)
        if train and len(self.buf) >= 64:
            n = self.updates_per_episode or max(8, len(graph.layers))
            for _ in range(n):
                self.ddpg.update(self.buf.sample(self.rng, 64))
        return EpisodeLog(reward=R, acc=acc,
                          avg_wbits=summary["avg_wbits"],
                          avg_abits=summary["avg_abits"],
                          logic_ratio=summary["logic_ratio"]), policy
