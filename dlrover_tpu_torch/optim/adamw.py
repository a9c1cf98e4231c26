"""AdamW that matches ``optax.adamw`` step for step.

``optax.adamw(lr, weight_decay=wd)`` as the JAX package's bench and
trainer build it is ``scale_by_adam(b1, b2, eps) ->
add_decayed_weights(wd) -> scale_by_learning_rate(lr)``:

* moments start as zeros in the parameter's dtype and are updated with
  the same expressions, so they take the dtype that the gradient and
  the moment promote to (f32 gradients accumulated by ``ElasticTrainer``
  turn bf16 moments f32 after the first step, as in optax);
* the bias corrections ``1 - b**count`` are computed in f32 and cast to
  the moment's dtype before the division, as optax does; every other
  constant (b1, b2, eps, the decay, -lr) is rounded to the dtype of the
  array it multiplies, as JAX applies a weakly typed Python scalar;
* weight decay is decoupled and has no mask: LayerNorm gains and biases
  decay too;
* the new parameter is ``(p + update)`` cast back to p's dtype.

``torch.optim.AdamW`` differs on each of these points (it casts the
gradient to the parameter's dtype, corrects the bias in f64 and keeps
its moments in the parameter's dtype), so the port has its own. It is
functional, like optax: ``update`` returns new parameters and state and
leaves its inputs untouched.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.tree import (
    tree_flatten,
    tree_map,
    tree_unflatten,
)


class AdamW:
    def __init__(
        self,
        learning_rate: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p).detach()  # noqa: E731
        return {
            "count": 0,
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
        }

    @staticmethod
    def _bias_correction(b: float, count: int) -> float:
        """``1 - b**count`` in f32, as optax computes it."""
        return float(np.float32(1.0) - np.float32(b) ** np.float32(count))

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        """One step: (new params, new state)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        wd, lr = self.weight_decay, self.learning_rate
        count = state["count"] + 1
        bc1 = self._bias_correction(b1, count)
        bc2 = self._bias_correction(b2, count)
        p_leaves, struct = tree_flatten(params)
        g_leaves = tree_flatten(grads)[0]
        mu_leaves = tree_flatten(state["mu"])[0]
        nu_leaves = tree_flatten(state["nu"])[0]
        new_p, new_mu, new_nu = [], [], []
        for p, g, mu, nu in zip(p_leaves, g_leaves, mu_leaves, nu_leaves):
            p = p.detach()
            mu = _weak(1 - b1, g) * g + _weak(b1, mu) * mu
            nu = _weak(1 - b2, g) * (g * g) + _weak(b2, nu) * nu
            mu_hat = mu / _weak(bc1, mu)
            nu_hat = nu / _weak(bc2, nu)
            u = mu_hat / (torch.sqrt(nu_hat) + _weak(eps, nu_hat))
            u = u + _weak(wd, p) * p
            u = u * _weak(-lr, u)
            new_p.append((p + u).to(p.dtype))
            new_mu.append(mu)
            new_nu.append(nu)
        return tree_unflatten(struct, new_p), {
            "count": count,
            "mu": tree_unflatten(struct, new_mu),
            "nu": tree_unflatten(struct, new_nu),
        }


def _weak(x: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX applies it to an array: weakly typed, so
    rounded to the array's dtype first (in bf16, b2 = 0.999 becomes 1.0
    and lr = 3e-4 becomes 3.004e-4). optax's bias corrections are cast
    to the moment's dtype explicitly, with the same effect."""
    return _rounded(x, like.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def _true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value by true division, as JAX divides by a traced scalar:
    PyTorch's CUDA kernels turn a Python-scalar divisor into a multiply
    by its reciprocal, so the divisor goes in as a 0-dim tensor (a fill
    kernel, no host sync)."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)
