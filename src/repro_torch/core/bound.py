# Copied from src/repro/core/bound.py; imports the port's policy module.
"""Algorithm 1: resource-constrained goal bounding (action-space limiting).

In resource-constrained searches the reward carries no incentive to shrink
bit-widths (alpha=1, beta=gamma=0), so the budget is enforced structurally:
the HLC may emit any goal for early layers, but once the remaining budget
could not be met even if every following layer used the minimum goal, the
goal is clamped.

Fidelity note: the paper's printed line 16, g_t = min(g_t, (1 -
logic_duty/logic_t) * 32), clamps *harder* when more budget remains, which
contradicts the surrounding text ("bound g_t if it is too large to meet
BBN-bar").  We implement the evident intent: layer t may spend at most
logic_duty, so g_t <= (logic_duty / logic_t) * 32 (per-goal fraction).  The
budget itself (line 5) is quadratic in the two goal fractions, so each goal
is bounded assuming its partner takes the target average.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.quant.policy import QuantizableGraph


@dataclasses.dataclass
class LayerBounder:
    """Tracks the logic-op budget across one episode (weights x activations).

    budget = sum_l logic_l * (bits_w/32) * (bits_a/32)        (Alg. 1 line 5)
    Layer t with goals (gw, ga) consumes (gw/32)(ga/32) logic_t (line 18,
    extended to the two-goal form the HLC actually emits).
    """
    graph: QuantizableGraph
    avg_bits_w: float            # target network-average weight bits
    avg_bits_a: float            # target network-average activation bits
    g_min: float = 1.0

    def __post_init__(self):
        self.logic = [l.macs for l in self.graph.layers]
        self.budget = sum(self.logic) * (self.avg_bits_w / 32.0) * \
            (self.avg_bits_a / 32.0)
        self.current = 0.0

    def reset(self):
        self.current = 0.0

    def _duty(self, t: int) -> float:
        """Logic ops layer t may still spend, leaving g_min feasible later."""
        logic_rest = sum(self.logic[t + 1:])
        return self.budget - (self.g_min / 32.0) ** 2 * logic_rest \
            - self.current

    def bound_pair(self, t: int, gw: float, ga: float) -> Tuple[float, float]:
        """Clamp the HLC's (weight, activation) goals for layer t.

        gw is bounded assuming the activation goal sits at the target
        average; ga is then bounded *exactly* against the remaining duty
        given the chosen gw, so the layer's consumed logic never exceeds
        its duty (up to the g_min floor)."""
        gw = max(gw, self.g_min)
        ga = max(ga, self.g_min)
        duty = max(self._duty(t), 0.0)
        lt = self.logic[t]
        if lt > 0:
            cap_w = duty / lt * 32.0 / max(self.avg_bits_a / 32.0, 1e-6)
            gw = min(gw, max(self.g_min, cap_w))
            cap_a = duty * 32.0 * 32.0 / (lt * max(gw, 1e-6))
            ga = min(ga, max(self.g_min, cap_a))
        self.current += (gw / 32.0) * (ga / 32.0) * lt
        return gw, ga
