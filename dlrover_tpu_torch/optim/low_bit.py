"""Adam with blockwise-quantized moments, on the kernels of
``ops/quantization.py``.

Counterpart of ``dlrover_tpu/optim/low_bit.py``: the moments of every
leaf with at least ``min_quantize_size`` values live as int8 (or packed
int4) codes with one f32 scale per block, ~2 (8-bit) or ~1 (4-bit)
bytes a parameter instead of AdamW's 8. Each update dequantizes the
moments, applies the Adam rule in f32 and quantizes them again, as the
JAX package's ``optax.chain(core, add_decayed_weights(wd),
scale_by_learning_rate(lr))`` does, without a general chain framework:

* leaves under ``min_quantize_size`` keep f32 moments;
* the gradient goes to f32;
* v is stored as sqrt(v) and squared on dequantize; at 4 bits m uses
  the signed levels (-7..7) and sqrt(v) the unsigned ones (0..15); at 8
  bits both use the int8 levels;
* the update ``(m / bc1) / (sqrt(v / bc2) + eps)`` is clipped to
  ``+-update_clip`` before weight decay and the learning rate;
* then ``+ wd * p`` (when the decay is not 0), ``* -lr``, and the new
  parameter ``(p + u)`` cast back to p's dtype, as
  ``optax.apply_updates``;
* the bias corrections are f32 ``1 - b**t``, as ``AdamW`` computes
  them, and the divisions by them are true divisions on every device.

The optimizer is functional, like ``AdamW``: ``init(params)`` and
``update(grads, state, params) -> (params, state)``; the state is
``{"count": int, "mu": tree, "nu": tree}`` whose quantized leaves are
:class:`QTensor`. ``quant="plain"`` runs the plain quantizers on any
device, for reference runs on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.tree import (
    tree_flatten,
    tree_leaves,
    tree_unflatten,
)
from dlrover_tpu_torch.ops import quantization as Q
from dlrover_tpu_torch.optim.adamw import AdamW, _true_div, _weak


class QTensor(NamedTuple):
    q: torch.Tensor  # int8 [n_blocks, block] | uint8 [n_blocks, block/2]
    scales: torch.Tensor  # f32 [n_blocks, 1]


@dataclasses.dataclass(frozen=True)
class LowBitAdam:
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    block_size: int = Q.DEFAULT_BLOCK
    min_quantize_size: int = 4096
    update_clip: Optional[float] = 2.0
    bits: int = 8
    quant: str = "auto"  # "plain": the plain quantizers on any device

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.quant not in ("auto", "plain"):
            raise ValueError(f"quant must be auto or plain, got {self.quant}")

    def _big(self, p: torch.Tensor) -> bool:
        return p.numel() >= self.min_quantize_size

    def _quant(self, x: torch.Tensor, signed: bool) -> QTensor:
        plain = self.quant == "plain"
        if self.bits == 4:
            fn = (Q.quantize_blockwise_4bit_plain if plain
                  else Q.quantize_blockwise_4bit)
            q, scales, _ = fn(x, self.block_size, signed)
        else:  # int8 levels for both moments: ``signed`` does not apply
            fn = Q.quantize_blockwise_plain if plain else Q.quantize_blockwise
            q, scales, _ = fn(x, self.block_size)
        return QTensor(q, scales)

    def _dequant(self, qt: QTensor, shape, signed: bool) -> torch.Tensor:
        plain, shape = self.quant == "plain", tuple(shape)
        if self.bits == 4:
            fn = (Q.dequantize_blockwise_4bit_plain if plain
                  else Q.dequantize_blockwise_4bit)
            return fn(qt.q, qt.scales, shape, signed)
        fn = Q.dequantize_blockwise_plain if plain else Q.dequantize_blockwise
        return fn(qt.q, qt.scales, shape)

    def init(self, params) -> Dict[str, Any]:
        leaves, struct = tree_flatten(params)
        mu, nu = [], []
        for p in leaves:
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if self._big(p):
                mu.append(self._quant(zeros, signed=True))
                nu.append(self._quant(zeros, signed=False))
            else:
                mu.append(zeros)
                nu.append(torch.zeros_like(zeros))
        return {
            "count": 0,
            "mu": tree_unflatten(struct, mu),
            "nu": tree_unflatten(struct, nu),
        }

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        """One step: (new params, new state)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        count = state["count"] + 1
        bc1 = AdamW._bias_correction(b1, count)
        bc2 = AdamW._bias_correction(b2, count)
        p_leaves, struct = tree_flatten(params)
        g_leaves = tree_flatten(grads)[0]
        # a QTensor is one leaf: the tree helpers descend only into dicts
        mu_leaves = tree_leaves(state["mu"])
        nu_leaves = tree_leaves(state["nu"])
        new_p, new_mu, new_nu = [], [], []
        for p, g, mu, nu in zip(p_leaves, g_leaves, mu_leaves, nu_leaves):
            p = p.detach()
            g = g.float()
            quantized = isinstance(mu, QTensor)
            if quantized:
                m = self._dequant(mu, g.shape, signed=True)
                v = torch.square(self._dequant(nu, g.shape, signed=False))
            else:
                m, v = mu, nu
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            u = _true_div(m, bc1) / (
                torch.sqrt(_true_div(v, bc2)) + eps
            )
            if self.update_clip is not None:
                u = u.clamp(-self.update_clip, self.update_clip)
            if quantized:
                m = self._quant(m, signed=True)
                v = self._quant(torch.sqrt(v), signed=False)
            if self.weight_decay:
                u = u + _weak(self.weight_decay, p) * p
            u = u * -self.learning_rate
            new_p.append((p + u).to(p.dtype))
            new_mu.append(m)
            new_nu.append(v)
        return tree_unflatten(struct, new_p), {
            "count": count,
            "mu": tree_unflatten(struct, new_mu),
            "nu": tree_unflatten(struct, new_nu),
        }


def adam_8bit(
    learning_rate: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    block_size: int = Q.DEFAULT_BLOCK,
    min_quantize_size: int = 4096,
    update_clip: Optional[float] = 2.0,
    bits: int = 8,
    quant: str = "auto",
) -> LowBitAdam:
    """AdamW with blockwise-quantized moments (int8, or packed int4 with
    ``bits=4``). ``update_clip`` bounds the preconditioned update per
    coordinate: m and sqrt(v) quantize against different block absmax
    values, so a coordinate's v can round to zero while its m survives."""
    return LowBitAdam(
        learning_rate, b1, b2, eps, weight_decay, block_size,
        min_quantize_size, update_clip, bits, quant,
    )


def adam_4bit(learning_rate: float = 1e-3, **kw) -> LowBitAdam:
    """AdamW with packed-int4 moments (~1 byte/param of optimizer
    state): signed 4-bit first moment, unsigned 4-bit sqrt(v)."""
    return adam_8bit(learning_rate, bits=4, **kw)


def optimizer_state_bytes(opt_state) -> Tuple[int, int]:
    """(actual_bytes, f32_equivalent_bytes) of every array of an
    optimizer state, counted as the JAX package counts its chain state:
    the step count is an int32 scalar (4 and 4), a uint8 array holds
    packed int4 codes (two values a byte, so 8 f32-equivalent bytes a
    byte), every other array its size times 4 as f32."""
    actual = f32_equiv = 0
    for leaf in tree_leaves(opt_state):
        arrays = leaf if isinstance(leaf, QTensor) else (leaf,)
        for a in arrays:
            if isinstance(a, int):  # the step count, int32 in JAX
                actual += 4
                f32_equiv += 4
                continue
            if a is None:
                continue
            actual += a.numel() * a.element_size()
            logical = a.numel() * (2 if a.dtype == torch.uint8 else 1)
            f32_equiv += logical * 4
    return actual, f32_equiv


def state_from_jax(tree, device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX chain state of ``adam_8bit``/``adam_4bit``, as numpy
    arrays (``(Adam8bitState(count, mu, nu), ...)`` with ``_QTensor(q,
    scales)`` leaves), -> the port's state on ``device`` (CUDA unless the
    caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    core = tree[0]

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if hasattr(x, "q") and hasattr(x, "scales"):
            return QTensor(_tensor(x.q, dev), _tensor(x.scales, dev))
        return _tensor(x, dev)

    return {
        "count": int(np.asarray(core.count)),
        "mu": leaf(core.mu),
        "nu": leaf(core.nu),
    }


def _tensor(a, dev: torch.device) -> torch.Tensor:
    # torch.tensor copies: numpy views of JAX arrays are read-only
    return torch.tensor(np.asarray(a)).to(dev)
