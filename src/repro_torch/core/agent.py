# Port of src/repro/core/agent.py: the two DDPGs are seeded from one
# torch.Generator in place of jax.random keys; everything else, the numpy
# rng for noise, relabel samples and replay included, is the reference's.
"""Hierarchical DRL agent (HIRO-style HLC + LLC) for kernel-wise quantization.

* HLC: one decision per layer -- a 2-d goal (gw_t, ga_t) = average weight /
  activation QBN for the layer, optionally clamped by Algorithm 1.
* LLC: goal-conditioned; one activation action per layer then one weight
  action per output-channel group, each an integer in [0, 32] (0 = prune).
* Intrinsic reward (section 3.3): r_i = zeta * (-|goal - realized mean|) +
  (1 - zeta) * R_i, deviation assigned at layer completion (normalized per
  group so reward scales are architecture-independent).
* HLC off-policy correction: transitions are re-labeled with a goal chosen
  among {g_t, G_t, 8 Gaussian samples around G_t}; the paper selects the
  *minimal* candidate ("min", default); "ml" implements the original HIRO
  max-likelihood selection under the current LLC (ablation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core.ddpg import (ACTION_SCALE, DDPG, DDPGConfig,
                                   ReplayBuffer, _sigmoid_scale, mlp_apply)
from repro_torch.core.env import QuantEnv, StepCtx
from repro_torch.quant.policy import QuantMode, QuantPolicy


@dataclasses.dataclass
class EpisodeLog:
    reward: float
    acc: float
    avg_wbits: float
    avg_abits: float
    logic_ratio: float


class HierarchicalAgent:
    def __init__(self, env: QuantEnv, seed: int = 0, zeta: float = 0.5,
                 relabel: str = "min", gamma: float = 0.95,
                 updates_per_episode: Optional[int] = None,
                 max_bits: float = 8.0, device: backend.DeviceLike = None):
        """max_bits: upper clamp of emitted goals/actions.  The paper's space
        is [0, 32]; for quantization searches it converges in [0, 8] and the
        clamp only speeds exploration (set 32.0 for the unrestricted space).
        The controllers run on ``device`` (the card unless it says
        otherwise).
        """
        self.env = env
        self.zeta = zeta
        self.relabel = relabel
        self.max_bits = max_bits
        sd = env.state_dim
        device = backend.resolve_device(device)
        g = backend.make_generator(seed, device)
        self.hlc = DDPG(DDPGConfig(state_dim=sd, action_dim=2, gamma=gamma,
                                   action_scale=max_bits), g, device)
        self.llc = DDPG(DDPGConfig(state_dim=sd + 2, action_dim=1,
                                   gamma=gamma, action_scale=max_bits), g,
                        device)
        self.hlc_buf = ReplayBuffer(sd, 2)
        self.llc_buf = ReplayBuffer(sd + 2, 1)
        self.rng = np.random.default_rng(seed)
        self.updates_per_episode = updates_per_episode

    # ------------------------------------------------------------ one episode
    def run_episode(self, noise: float, train: bool = True
                    ) -> Tuple[EpisodeLog, QuantPolicy]:
        env = self.env
        graph = env.graph
        if env.bounder is not None:
            env.bounder.reset()
        ctx = StepCtx()
        policy = QuantPolicy(mode=env.mode, weight_bits={}, act_bits={})

        hlc_transitions = []   # (s, g, [llc states], [llc actions], s_next)
        llc_transitions = []   # (s+g, a, r_placeholder_idx, s2+g, done)

        for t, layer in enumerate(graph.layers):
            s_t = env.make_state(t, layer, 0, ctx, is_act_step=True)
            g = self.hlc.act(s_t, noise, self.rng)            # (gw, ga)
            g = np.clip(g, 0.0, self.max_bits)
            if env.bounder is not None:
                gw, ga = env.bounder.bound_pair(t, float(g[0]), float(g[1]))
                g = np.array([gw, ga], np.float32)
            ctx.gw, ctx.ga = float(g[0]), float(g[1])

            # --- activation action (one per layer) ---
            sa = env.make_state(t, layer, 0, ctx, is_act_step=True)
            sga = np.concatenate([sa, g / ACTION_SCALE])
            aa = self.llc.act(sga, noise, self.rng)[0]
            aa = float(np.clip(np.round(aa), 0, self.max_bits))
            ctx.aa_prev = aa

            # --- weight actions (one per output-channel group) ---
            states, actions = [sga], [aa]
            raw = np.zeros(layer.n_groups, np.float32)
            for gi in range(layer.n_groups):
                s_i = env.make_state(t, layer, gi, ctx, is_act_step=False)
                sgi = np.concatenate([s_i, g / ACTION_SCALE])
                aw = self.llc.act(sgi, noise, self.rng)[0]
                aw = float(np.clip(np.round(aw), 0, self.max_bits))
                ctx.aw_prev = aw
                raw[gi] = aw
                states.append(sgi)
                actions.append(aw)
            wbits = env.apply_var_ordering(layer, raw)
            policy.weight_bits[layer.name] = wbits
            policy.act_bits[layer.name] = aa
            env.account_rdc(layer, ctx, wbits, aa)

            # LLC transitions for this layer; deviation reward at layer end.
            dev_w = abs(float(g[0]) - float(np.mean(wbits)))
            dev_a = abs(float(g[1]) - aa)
            intrinsic = -self.zeta * (dev_w + dev_a) / 2.0
            for j in range(len(states)):
                s2 = states[j + 1] if j + 1 < len(states) else states[j]
                r = intrinsic if j == len(states) - 1 else 0.0
                llc_transitions.append(
                    [states[j], np.array([actions[j]], np.float32), r, s2,
                     0.0])
            hlc_transitions.append([s_t, g.copy(), states, actions])

        # --- extrinsic reward at episode end ---
        acc, R, summary = env.episode_reward(policy)
        llc_transitions[-1][2] += (1.0 - self.zeta) * R
        llc_transitions[-1][4] = 1.0
        for j, (s, a, r, s2, d) in enumerate(llc_transitions):
            self.llc_buf.push(s, a, r, s2, d)

        for t, (s_t, g, states, actions) in enumerate(hlc_transitions):
            r = R if t == len(hlc_transitions) - 1 else 0.0
            s_next = hlc_transitions[t + 1][0] \
                if t + 1 < len(hlc_transitions) else s_t
            done = 1.0 if t == len(hlc_transitions) - 1 else 0.0
            g_used = self._relabel(g, states, actions)
            self.hlc_buf.push(s_t, g_used, r, s_next, done)

        if train:
            self._train()
        return EpisodeLog(reward=R, acc=acc,
                          avg_wbits=summary["avg_wbits"],
                          avg_abits=summary["avg_abits"],
                          logic_ratio=summary["logic_ratio"]), policy

    # ------------------------------------------------------------- relabeling
    def _relabel(self, g: np.ndarray, states: List[np.ndarray],
                 actions: List[float]) -> np.ndarray:
        """Goal re-labeling for off-policy HLC training (section 3.2)."""
        aw = np.asarray(actions[1:], np.float32)
        G = np.array([aw.mean() if len(aw) else actions[0], actions[0]],
                     np.float32)
        cands = [g, G] + [np.clip(G + self.rng.normal(0, 1.0, 2), 0,
                                  self.max_bits) for _ in range(8)]
        if self.relabel == "min":
            # Paper: "selects the minimal goal to re-label the experience".
            stack = np.stack(cands)
            return stack[np.argmin(stack.sum(axis=1))]
        # "ml": HIRO max-likelihood -- candidate minimizing sum_i
        # ||a_i - mu_lo(s_i, g~)||^2 under the current LLC.
        base = np.stack([s[:-2] for s in states])              # strip goal dims
        acts = np.asarray(actions, np.float32)[:, None]
        errs = []
        for cand in cands:
            sg = np.concatenate(
                [base, np.tile(cand / ACTION_SCALE, (len(base), 1))], axis=1)
            with torch.no_grad():
                mu = mlp_apply(self.llc.state["actor"],
                               backend.upload(sg.astype(np.float32),
                                              self.llc.device),
                               final_act=_sigmoid_scale).cpu().numpy()
            errs.append(float(((mu - acts) ** 2).sum()))
        return cands[int(np.argmin(errs))]

    # ---------------------------------------------------------------- training
    def _train(self):
        n = self.updates_per_episode or max(8, len(self.env.graph.layers))
        if len(self.llc_buf) >= 64:
            for _ in range(n):
                self.llc.update(self.llc_buf.sample(self.rng, 64))
        if len(self.hlc_buf) >= 64:
            for _ in range(max(4, n // 4)):
                self.hlc.update(self.hlc_buf.sample(self.rng, 64))
