"""AdamW with optional 8-bit block-quantized moments (port of
``repro/optim/adam.py``).

The 8-bit mode stores both moments as int8 with an f32 absmax scale per
parameter *row* (the last axis is the quantization block).  The second
moment is stored in the sqrt domain: linear-absmax int8 zeroes small v
entries whose rsqrt then explodes; sqrt halves the dynamic range in the
exponent and recovers fp32-grade convergence.  Gradient clipping (global
norm) and decoupled weight decay included.

``init`` and ``update`` are functional, as in the reference: they return
new trees and never write into a leaf.  The state tree is the
reference's, ``{"m", "v", "t"}`` with ``{"q", "s"}`` leaves in 8-bit mode,
so a reference checkpoint restores into it.  Trees are visited with
``core.ddpg.tree_map`` / ``tree_leaves`` (dict keys sorted, as JAX visits
them), so the global grad norm sums the leaves in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.ddpg import tree_leaves, tree_map


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last axis: (int8, f32 scale[..., 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = (x / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _is_cell(x) -> bool:
    return isinstance(x, dict) and "__p" in x


def _pick(tree, key):
    """The ``key`` entry of every per-leaf result cell of ``tree``."""
    if _is_cell(tree):
        return tree[key]
    if isinstance(tree, dict):
        return {k: _pick(v, key) for k, v in tree.items()}
    return type(tree)(_pick(v, key) for v in tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    state_bits: int = 32          # 32 (fp32 moments) or 8 (block-quantized)

    def init(self, params: Any) -> Any:
        dev = tree_leaves(params)[0].device
        if self.state_bits == 8:
            def zero8(p):
                s = p.shape[:-1] + (1,) if p.ndim else (1,)
                return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                         device=p.device),
                        "s": torch.zeros(s, dtype=torch.float32,
                                         device=p.device)}
            zero = zero8
        else:
            def zero(p):
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
        return {"m": tree_map(zero, params), "v": tree_map(zero, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, params: Any, grads: Any, state: Any,
               lr=None) -> Tuple[Any, Any, Any]:
        """Returns (new_params, new_state, metrics); ``lr`` a float or a
        0-d tensor (``cosine_warmup``), ``self.lr`` when None.  Nothing is
        read back to the host."""
        lr = self.lr if lr is None else lr
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        gf = tree_map(lambda g: g.to(torch.float32), grads)
        gnorm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(gf)))
        clip = None if self.grad_clip is None else \
            torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        t = state["t"] + 1
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        # Leaf by leaf, as the reference's tree.map: the clipped gradient
        # and every full-size intermediate exist for one leaf at a time,
        # and the in-place ops act only on those fresh intermediates (the
        # same operations, in the same order, as the reference's).
        def clipped(g):
            return g if clip is None else g * clip

        def step_of(p, m, v):
            den = (v / bc2).sqrt_().add_(eps)
            step = (m / bc1).mul_(lr).div_(den)
            if wd:
                step = step + lr * wd * p.to(torch.float32)
            return (p.to(torch.float32) - step).to(p.dtype)

        if self.state_bits == 8:
            def upd(p, g, m8, v8):
                g = clipped(g)
                m = _dq8(m8["q"], m8["s"]).reshape(p.shape).mul_(b1) \
                    .add_((1 - b1) * g)
                v = _dq8(v8["q"], v8["s"]).reshape(p.shape).square_() \
                    .mul_(b2).add_((1 - b2) * g * g)
                new_p = step_of(p, m, v)
                mq, ms = _q8(m)
                vq, vs = _q8(v.sqrt_())      # sqrt-domain storage
                return {"__p": new_p, "__m": {"q": mq, "s": ms},
                        "__v": {"q": vq, "s": vs}}
        else:
            def upd(p, g, m, v):
                g = clipped(g)
                m = (b1 * m).add_((1 - b1) * g)
                v = (b2 * v).add_((1 - b2) * g * g)
                return {"__p": step_of(p, m, v), "__m": m, "__v": v}

        out = tree_map(upd, params, gf, state["m"], state["v"])
        new_state = {"m": _pick(out, "__m"), "v": _pick(out, "__v"), "t": t}
        return _pick(out, "__p"), new_state, {"grad_norm": gnorm}
