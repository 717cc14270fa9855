"""DDPG actor-critic in PyTorch (port of ``repro/core/ddpg.py``).

Paper hyperparameters (section 4): actors and critics have two hidden layers
of 300 units; the actor's output layer is a sigmoid scaled by 32; soft target
updates with tau = 0.01; batch size 64; replay buffer 2000.

The networks are plain lists of ``{"w", "b"}`` dicts, the reference's
tree, so its state carries across (:meth:`DDPG.load_state`).  Adam is the
reference's formula, step for step (``torch.optim.Adam`` rounds
differently); gradients come from ``torch.autograd``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch import backend
from repro_torch.interop import params_from_numpy

HIDDEN = 300
ACTION_SCALE = 32.0


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of same-shaped dict / list / tuple
    trees.  Dict keys are visited in sorted order, as JAX visits them, so
    :func:`tree_leaves` lines up with ``jax.tree.leaves``."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves`
    order) in place of its tensors."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# ------------------------------------------------------------------ MLP core
def init_mlp(generator: torch.Generator, sizes, device: torch.device):
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=device) * math.sqrt(2.0 / fan_in)
        params.append({"w": w, "b": torch.zeros(fan_out, device=device)})
    return params


def mlp_apply(params, x, final_act=None):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    if final_act is not None:
        x = final_act(x)
    return x


# ----------------------------------------------------------------- pure Adam
def adam_init(params):
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device)}


def adam_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
    bc1 = 1 - b1 ** t.to(torch.float32)
    bc2 = 1 - b2 ** t.to(torch.float32)
    new = tree_map(
        lambda p, m_, v_: p - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps),
        params, m, v)
    return new, {"m": m, "v": v, "t": t}


# -------------------------------------------------------------------- agent
@dataclasses.dataclass
class DDPGConfig:
    state_dim: int
    action_dim: int
    gamma: float = 0.95
    tau: float = 0.01
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    hidden: int = HIDDEN
    action_scale: float = ACTION_SCALE   # sigmoid output x scale


def _sigmoid_scale(x, scale=ACTION_SCALE):
    return torch.sigmoid(x) * scale


def _grad(loss, tree):
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, torch.autograd.grad(loss, leaves))


def _requiring_grad(tree):
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


class DDPG:
    """One deterministic actor-critic controller (used for both HLC & LLC).

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed.
    Runs on the card unless ``device`` says otherwise."""

    def __init__(self, cfg: DDPGConfig, generator=0,
                 device: backend.DeviceLike = None):
        self.cfg = cfg
        self.device = backend.resolve_device(device)
        g = generator if isinstance(generator, torch.Generator) else \
            backend.make_generator(generator, self.device)
        h = cfg.hidden
        actor = init_mlp(g, (cfg.state_dim, h, h, cfg.action_dim),
                         self.device)
        critic = init_mlp(g, (cfg.state_dim + cfg.action_dim, h, h, 1),
                          self.device)
        self.state = {
            "actor": actor, "critic": critic,
            "actor_t": tree_map(torch.clone, actor),
            "critic_t": tree_map(torch.clone, critic),
            "opt_a": adam_init(actor), "opt_c": adam_init(critic),
        }

    def load_state(self, tree: Dict[str, Any]) -> None:
        """Take a state tree of numpy arrays (the reference's
        ``jax.tree.map(np.asarray, ddpg.state)``) onto this controller's
        device."""
        self.state = params_from_numpy(tree, self.device)

    def _final(self, x):
        return _sigmoid_scale(x, self.cfg.action_scale)

    # ------------------------------------------------------------- policies
    def act(self, s: np.ndarray, noise_scale: float, rng) -> np.ndarray:
        """Noisy action in [0, action_scale].  s: (state_dim,).  Reads the
        action back to the host (one device sync), as the reference does."""
        scale = self.cfg.action_scale
        st = backend.upload(np.asarray(s, np.float32)[None], self.device)
        with torch.no_grad():
            a = mlp_apply(self.state["actor"], st, final_act=self._final)
        a = a.cpu().numpy()[0]
        if noise_scale > 0:
            a = a + rng.normal(0.0, noise_scale * scale, size=a.shape)
        return np.clip(a, 0.0, scale)

    # --------------------------------------------------------------- update
    def _update_impl(self, state, batch):
        cfg = self.cfg
        s, a, r, s2, done = (batch["s"], batch["a"], batch["r"], batch["s2"],
                             batch["done"])
        with torch.no_grad():
            a2 = mlp_apply(state["actor_t"], s2, final_act=self._final)
            q2 = mlp_apply(state["critic_t"], torch.cat([s2, a2], -1))[:, 0]
            target = r + cfg.gamma * (1.0 - done) * q2

        critic_in = _requiring_grad(state["critic"])
        q = mlp_apply(critic_in, torch.cat([s, a], -1))[:, 0]
        cl = torch.mean((q - target) ** 2)
        critic, opt_c = adam_update(state["critic"], _grad(cl, critic_in),
                                    state["opt_c"], cfg.critic_lr)

        actor_in = _requiring_grad(state["actor"])
        pa = mlp_apply(actor_in, s, final_act=self._final)
        al = -torch.mean(mlp_apply(critic, torch.cat([s, pa], -1))[:, 0])
        actor, opt_a = adam_update(state["actor"], _grad(al, actor_in),
                                   state["opt_a"], cfg.actor_lr)

        def soft(t, p):
            return tree_map(lambda tp, pp: (1 - cfg.tau) * tp + cfg.tau * pp,
                            t, p)

        new_state = {
            "actor": actor, "critic": critic,
            "actor_t": soft(state["actor_t"], actor),
            "critic_t": soft(state["critic_t"], critic),
            "opt_a": opt_a, "opt_c": opt_c,
        }
        return new_state, {"critic_loss": cl, "actor_loss": al}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        tb = {k: backend.upload(np.asarray(v, np.float32), self.device)
              for k, v in batch.items()}
        self.state, metrics = self._update_impl(self.state, tb)
        return {k: float(v.detach()) for k, v in metrics.items()}


class ReplayBuffer:
    """Fixed-size ring buffer (paper: size 2000, batch 64)."""

    def __init__(self, state_dim: int, action_dim: int, size: int = 2000):
        self.size = size
        self.n = 0
        self.idx = 0
        self.s = np.zeros((size, state_dim), np.float32)
        self.a = np.zeros((size, action_dim), np.float32)
        self.r = np.zeros((size,), np.float32)
        self.s2 = np.zeros((size, state_dim), np.float32)
        self.done = np.zeros((size,), np.float32)

    def push(self, s, a, r, s2, done):
        i = self.idx
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i] = s2, float(done)
        self.idx = (i + 1) % self.size
        self.n = min(self.n + 1, self.size)

    def sample(self, rng: np.random.Generator, batch: int = 64):
        idx = rng.integers(0, self.n, size=batch)
        return {"s": self.s[idx], "a": self.a[idx], "r": self.r[idx],
                "s2": self.s2[idx], "done": self.done[idx]}

    def __len__(self):
        return self.n
