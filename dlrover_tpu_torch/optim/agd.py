"""AGD (NeurIPS'23), counterpart of ``dlrover_tpu/optim/agd.py``.

"AGD: an Auto-switchable Optimizer using Stepwise Gradient Difference
as Preconditioning Matrix", with the JAX package's rule::

    m_t   = b1 m_{t-1} + (1-b1) g_t
    u_t   = m_t/(1-b1^t) - m_{t-1}/(1-b1^{t-1})      (u_1 = m_1/(1-b1))
    v_t   = b2 v_{t-1} + (1-b2) u_t^2
    denom = max(sqrt(v_t  or amsgrad-max), delta*sqrt(1-b2^t))
    p_t   = p_{t-1} - lr (sqrt(1-b2^t)/(1-b1^t) * m_t/denom + wd p_{t-1})

as ``optax.chain(scale_by_agd, add_decayed_weights(wd),
scale_by_learning_rate(lr))``: the preconditioned step (clipped to
``+-clip`` when given) is scaled by sqrt(bc2)/bc1, then ``+ wd * p``,
``* -lr`` and ``(p + u)`` cast back to p's dtype. Moments are f32; the
bias corrections and the scalars built from them are f32, as JAX
computes them from the f32 step count. No kernel: AGD's work is a
handful of elementwise passes.

Functional like ``AdamW``: ``init(params)`` and ``update(grads, state,
params) -> (params, state)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.tree import (
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from dlrover_tpu_torch.optim.adamw import _true_div, _weak


def _f32(x) -> np.float32:
    return np.float32(x)


@dataclasses.dataclass(frozen=True)
class AGD:
    learning_rate: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    delta: float = 1e-5
    weight_decay: float = 0.0
    amsgrad: bool = False
    clip: Optional[float] = None

    def init(self, params) -> Dict[str, Any]:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {
            "count": 0,
            "exp_avg": tree_map(zeros, params),
            "exp_avg_sq": tree_map(zeros, params),
            "max_exp_avg_sq": (
                tree_map(zeros, params) if self.amsgrad else None
            ),
        }

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        """One step: (new params, new state)."""
        b1, b2 = self.betas
        count = state["count"] + 1
        t = _f32(count)
        bc1_old = float(_f32(1.0) - _f32(b1) ** (t - _f32(1.0)))
        bc1 = float(_f32(1.0) - _f32(b1) ** t)
        sqrt_bc2 = np.sqrt(_f32(1.0) - _f32(b2) ** t)
        delta_adjust = float(_f32(self.delta) * sqrt_bc2)
        step_scale = float(sqrt_bc2 / _f32(bc1))
        p_leaves, struct = tree_flatten(params)
        g_leaves = tree_flatten(grads)[0]
        m_leaves = tree_flatten(state["exp_avg"])[0]
        v_leaves = tree_flatten(state["exp_avg_sq"])[0]
        max_leaves = (
            tree_flatten(state["max_exp_avg_sq"])[0] if self.amsgrad
            else [None] * len(p_leaves)
        )
        new_p, new_m, new_v, new_max = [], [], [], []
        for p, g, m_old, v, max_v in zip(
            p_leaves, g_leaves, m_leaves, v_leaves, max_leaves
        ):
            p = p.detach()
            m = b1 * m_old + (1.0 - b1) * g.float()
            if count == 1:
                u = _true_div(m, bc1)
            else:
                u = _true_div(m, bc1) - _true_div(m_old, bc1_old)
            v = b2 * v + (1.0 - b2) * u * u
            if self.amsgrad:
                max_v = torch.maximum(max_v, v)
            denom = torch.sqrt(max_v if self.amsgrad else v).clamp(
                min=delta_adjust
            )
            out = m / denom
            if self.clip is not None:
                out = out.clamp(-self.clip, self.clip)
            out = out * step_scale
            if self.weight_decay:
                out = out + _weak(self.weight_decay, p) * p
            out = out * -self.learning_rate
            new_p.append((p + out).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
            new_max.append(max_v)
        return tree_unflatten(struct, new_p), {
            "count": count,
            "exp_avg": tree_unflatten(struct, new_m),
            "exp_avg_sq": tree_unflatten(struct, new_v),
            "max_exp_avg_sq": (
                tree_unflatten(struct, new_max) if self.amsgrad else None
            ),
        }


def agd(
    learning_rate: float = 1e-3,
    betas: Tuple[float, float] = (0.9, 0.999),
    delta: float = 1e-5,
    weight_decay: float = 0.0,
    amsgrad: bool = False,
    clip: Optional[float] = None,
) -> AGD:
    """Full AGD with decoupled weight decay (p -= lr * wd * p)."""
    return AGD(learning_rate, tuple(betas), delta, weight_decay, amsgrad, clip)
