"""The optimizer choice of ``auto_accelerate``, counterpart of
``dlrover_tpu/accelerate/api.py`` ``_make_optimizer``.

The rest of ``auto_accelerate`` (strategy search, analyser, remat
policies beyond "none" and "full") is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from dlrover_tpu_torch.common.tree import tree_map
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.optim.agd import agd
from dlrover_tpu_torch.optim.low_bit import adam_4bit, adam_8bit

OPTIMIZERS = ("adamw", "agd", "adam8bit", "adam4bit", "sgd")


class SGD:
    """``optax.sgd(lr)`` without momentum: ``p - lr * g``, cast back to
    p's dtype (the update ``-lr * g`` takes g's dtype, as in optax)."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params) -> Dict[str, Any]:
        return {}

    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        def step(p, g):
            p = p.detach()
            return (p + g * -self.learning_rate).to(p.dtype)

        return tree_map(step, params, grads), state


def make_optimizer(name: str, learning_rate: float):
    """An optimizer with the port's ``init``/``update`` interface, by the
    names the JAX package's ``Strategy.optimizer`` takes."""
    if name == "adamw":
        return AdamW(learning_rate)  # optax.adamw's default decay, 1e-4
    if name == "agd":
        return agd(learning_rate)
    if name == "adam8bit":
        return adam_8bit(learning_rate)
    if name == "adam4bit":
        return adam_4bit(learning_rate)
    if name == "sgd":
        return SGD(learning_rate)
    raise ValueError(f"unknown optimizer {name!r}")
