"""Train-step factory (counterpart of ``dlrover_tpu/trainer/step.py``
``make_train_step`` and ``make_eval_step``).

The JAX package jits ``value_and_grad`` plus an optax update over a
sharded mesh. The port runs one process on one device eagerly: the
step differentiates the loss with autograd and hands the gradients,
in the parameters' dtypes as ``jax.grad`` gives them, to the functional
optimizer (``optim/adamw.py``). Data parallelism arrives with the
parallelism slice (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from dlrover_tpu_torch.common.tree import (
    tree_flatten,
    tree_leaves,
    tree_unflatten,
)


def value_and_grad(loss_fn: Callable) -> Callable:
    """``loss_fn(params, *args) -> scalar`` becomes ``f(params, *args)
    -> (loss, grads)``, grads a tree like params. The caller's leaves
    are not modified: the step differentiates detached views of them."""

    def f(params, *args) -> Tuple[torch.Tensor, dict]:
        leaves, struct = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(tree_unflatten(struct, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(struct, list(grads))

    return f


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(
        sum(g.float().square().sum() for g in tree_leaves(tree))
    )


def make_train_step(loss_fn: Callable, optimizer):
    """``step(params, opt_state, tokens, targets) -> (params, opt_state,
    {"loss", "grad_norm"})`` with ``loss_fn(params, tokens, targets)``.
    The metrics stay on the device: read them with
    ``async_metrics.materialize``."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, tokens, targets):
        loss, grads = vg(params, tokens, targets)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {
            "loss": loss, "grad_norm": global_norm(grads),
        }

    return step


def make_eval_step(loss_fn: Callable):
    @torch.no_grad()
    def step(params, tokens, targets):
        return loss_fn(params, tokens, targets)

    return step
