"""Training loop with checkpoint/restart, deterministic data skip-ahead,
and a straggler watchdog (port of ``repro/train/loop.py``).

Fault model: any step may die (preemption, node loss).  Recovery =
restart the job; the Trainer auto-resumes from the newest complete
checkpoint and replays the data stream from the restored step (the
synthetic pipeline is deterministic in (seed, index), so no data state is
checkpointed).  A watchdog records per-step wall time and flags outliers
(> straggler_factor x median).

A step runs eagerly on ``device`` (the card unless ``"cpu"`` is asked):
the batch goes up through ``backend.upload`` (pinned, non-blocking), the
gradient comes from ``torch.autograd`` and the update is the functional
AdamW.  Nothing is read back to the host except at logging steps (the
history's floats) and checkpoint steps, as the reference's asynchronous
dispatch reads nothing back; so a step's wall time is its host time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core.ddpg import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import AdamW
from repro_torch.train.checkpoint import CheckpointManager


class SimulatedPreemption(RuntimeError):
    pass


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    lr: float = 1e-3
    keep: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


def value_and_grad(loss_fn: Callable, params: Any, *args):
    """``(loss_fn(params, *args), d loss / d params)`` with the loss
    detached and the gradients in a tree shaped like ``params`` (zeros
    for a leaf the loss does not use, as ``jax.grad`` gives)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    loss = loss_fn(p, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(p, grads)


def upload_batch(batch: Dict[str, Any], device: torch.device):
    """Every array of ``batch`` on ``device`` in its own dtype (a bf16
    batch for a bf16 model stays bf16, as ``jnp.asarray`` keeps it)."""
    return {k: backend.upload(v, device) for k, v in batch.items()}


class Trainer:
    """model: exposes .loss(params, batch); data_fn(step)->batch of numpy
    arrays."""

    def __init__(self, model, params, optimizer: AdamW,
                 data_fn: Callable[[int], Dict[str, Any]],
                 ckpt_dir: str, cfg: TrainConfig = TrainConfig(),
                 loss_kwargs: Optional[dict] = None,
                 preempt_at: Optional[int] = None,
                 device: backend.DeviceLike = None):
        self.device = backend.resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.data_fn = data_fn
        self.cfg = cfg
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep)
        self.preempt_at = preempt_at
        self.history: List[Dict[str, float]] = []
        self.step_times: List[float] = []
        self.straggler_events: List[int] = []
        lk = loss_kwargs or {}

        def _step(params, opt_state, batch):
            loss, grads = value_and_grad(
                lambda p: model.loss(p, batch, **lk), params)
            params, opt_state, om = optimizer.update(params, grads, opt_state,
                                                     lr=cfg.lr)
            return params, opt_state, {"loss": loss, **om}

        self._step = _step

        # resume or fresh start
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.opt_state = optimizer.init(self.params)
        self.start_step = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            s, tree, _ = self.ckpt.restore(
                {"params": self.params, "opt": self.opt_state}, step=latest,
                device=self.device)
            self.params, self.opt_state = tree["params"], tree["opt"]
            self.start_step = s
            print(f"[trainer] resumed from step {s}", flush=True)

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        step = self.start_step
        while step < cfg.total_steps:
            if self.preempt_at is not None and step == self.preempt_at:
                raise SimulatedPreemption(f"preempted at step {step}")
            t0 = time.time()
            batch = upload_batch(self.data_fn(step), self.device)
            self.params, self.opt_state, m = self._step(
                self.params, self.opt_state, batch)
            dt = time.time() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > cfg.straggler_factor * med:
                self.straggler_events.append(step)
            step += 1
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                self.history.append(
                    {"step": step, **{k: float(v) for k, v in m.items()}})
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                self.ckpt.save(step, {"params": self.params,
                                      "opt": self.opt_state})
        return {"params": self.params, "opt": self.opt_state,
                "history": self.history,
                "stragglers": self.straggler_events}
