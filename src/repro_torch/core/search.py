# Copied from src/repro/core/search.py; imports the port's modules.
"""Search driver: explore / exploit episode schedule (paper section 4).

AutoQ first explores `n_explore` episodes with constant Gaussian noise
delta=0.5, then exploits `n_exploit` episodes with exponentially decayed
noise, tracking the best policy by extrinsic reward.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

from repro_torch.core.agent import EpisodeLog
from repro_torch.quant.policy import QuantPolicy


@dataclasses.dataclass
class SearchResult:
    best_policy: Optional[QuantPolicy]
    best_log: Optional[EpisodeLog]
    history: List[EpisodeLog]
    wall_s: float

    def reward_curve(self):
        return [h.reward for h in self.history]

    def acc_curve(self):
        return [h.acc for h in self.history]


def run_search(agent, n_explore: int = 100, n_exploit: int = 300,
               noise0: float = 0.5, decay: float = 0.99,
               callback: Optional[Callable[[int, EpisodeLog], None]] = None,
               select: str = "reward") -> SearchResult:
    """agent: HierarchicalAgent or FlatAgent (both expose run_episode)."""
    t0 = time.time()
    history: List[EpisodeLog] = []
    best_log, best_policy = None, None
    noise = noise0
    for ep in range(n_explore + n_exploit):
        if ep >= n_explore:
            noise *= decay
        log, policy = agent.run_episode(noise=noise)
        history.append(log)
        key = log.reward if select == "reward" else log.acc
        best_key = None if best_log is None else (
            best_log.reward if select == "reward" else best_log.acc)
        if best_log is None or key > best_key:
            best_log, best_policy = log, policy.copy()
        if callback is not None:
            callback(ep, log)
    return SearchResult(best_policy=best_policy, best_log=best_log,
                        history=history, wall_s=time.time() - t0)
