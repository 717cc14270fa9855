# Copied from src/repro/core/reward.py; the roofline variant takes a
# core.roofline.TPURoofline or H100Roofline (any object with
# ``latency(graph, policy)`` and ``latency_full(graph)``).
"""Extrinsic rewards: NetScore (Eq. 2), FLOP-based baseline, and the
roofline-informed variant.

NetScore: Omega(N) = 20 * log10( a(N)^alpha / (p(N)^beta * m(N)^gamma) ).
We use normalized ingredients (a in (0, 100]; p = avg weight bits / 32;
m = logic ops / full-precision logic ops), which is a monotone reparametrization
of the paper's absolute counts and keeps Omega architecture-comparable.

Search protocols (section 3.3):
* resource-constrained: alpha=1, beta=0, gamma=0 -- pure accuracy; the bit
  budget is enforced by Algorithm 1 action-space limiting (core/bound.py).
* accuracy-guaranteed:  alpha=2, beta=0.5, gamma=0.5 -- rewards shrinking
  p and m; accuracy enters squared.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

from repro_torch.quant.policy import QuantPolicy, QuantizableGraph


@dataclasses.dataclass(frozen=True)
class RewardCfg:
    alpha: float
    beta: float
    gamma: float
    kind: str = "netscore"           # netscore | flop | roofline

    @staticmethod
    def resource_constrained() -> "RewardCfg":
        return RewardCfg(alpha=1.0, beta=0.0, gamma=0.0)

    @staticmethod
    def accuracy_guaranteed() -> "RewardCfg":
        return RewardCfg(alpha=2.0, beta=0.5, gamma=0.5)

    @staticmethod
    def flop_based() -> "RewardCfg":
        """Section 4.3 baseline [AMC-style]: only the logic-op term."""
        return RewardCfg(alpha=2.0, beta=0.0, gamma=1.0, kind="flop")


def netscore(acc_pct: float, p: float, m: float, cfg: RewardCfg) -> float:
    """acc_pct in (0, 100]; p, m normalized to (0, 1]."""
    a = max(acc_pct, 1e-3)
    # physical floors: p >= 1/32 (1-bit weights), m >= 1/1024 (1x1-bit MACs);
    # without them a degenerate all-pruned policy games the log terms.
    p = max(p, 1.0 / 32.0)
    m = max(m, 1.0 / 1024.0)
    return 20.0 * math.log10(a ** cfg.alpha / (p ** cfg.beta * m ** cfg.gamma))


def extrinsic_reward(acc_pct: float, graph: QuantizableGraph,
                     policy: QuantPolicy, cfg: RewardCfg,
                     roofline: Optional[Any] = None) -> float:
    p = policy.avg_weight_bits(graph) / 32.0
    m = policy.logic_ops(graph) / max(graph.total_macs * 32.0 * 32.0, 1.0)
    if cfg.kind == "flop":
        # FLOP-based reward ignores the weight-count term entirely.
        return netscore(acc_pct, 1.0, m, cfg)
    if cfg.kind == "roofline" and roofline is not None:
        # Replace m with the roofline latency estimate (normalized to the
        # full-precision model) so beta/gamma trade memory vs compute
        # bottlenecks of the actual target device.
        lat = roofline.latency(graph, policy) / roofline.latency_full(graph)
        return netscore(acc_pct, p, lat, cfg)
    return netscore(acc_pct, p, m, cfg)


def reward_summary(acc_pct: float, graph: QuantizableGraph,
                   policy: QuantPolicy, cfg: RewardCfg) -> Dict[str, float]:
    return {
        "acc_pct": acc_pct,
        "avg_wbits": policy.avg_weight_bits(graph),
        "avg_abits": policy.avg_act_bits(graph),
        "logic_ratio": policy.logic_ops(graph) /
        max(graph.total_macs * 32.0 * 32.0, 1.0),
        "reward": extrinsic_reward(acc_pct, graph, policy, cfg),
    }
