"""Mixture-of-experts feed-forward (counterpart of
``dlrover_tpu/models/moe.py``).

The same router, the same routing and the same losses as the JAX
package, on one device (its expert-parallel mesh waits for the
parallelism slice, ROADMAP queue 1 item 6):

* top-k routing (``top_k_gating``; ``switch_gating`` is top-1) with a
  float32 router: for each of the k choices in order, every token takes
  its best expert not chosen yet (logits of earlier choices masked with
  -1e30), and claims the next slot of that expert's queue by its
  position among the tokens that chose it, after the slots earlier
  choices filled. A token past the expert's capacity
  ``ceil(capacity_factor * top_k * n / n_experts)`` is dropped for that
  choice (the residual carries it);
* GShard's load-balance loss and the router z-loss, weighted and summed
  into the returned aux loss;
* ``renorm_top_k``: a token's kept gates divided by their sum (Mixtral).

The JAX package dispatches with one-hot ``[n, E, C]`` einsums. Here the
same sums are a gather and a weighted add: expert e's slot c holds the
one token that claimed it (or a zero row), and a token's output is the
sum of its kept choices' expert rows times their gates, added in
choice order with no atomics, so a rerun gives the same bits. A one-hot
product adds exact zeros, so both compute the same function
(:func:`_gating` still builds the dense tensors; the tests hold
``moe_mlp`` to the einsums over them). The expert FFN is one batched
product over the experts with f32 products and f32 output
(``dot_f32``, JAX's ``preferred_element_type``), cast to ``cfg.dtype``
after the activation, as in the JAX package, where XLA computes it
outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.cross_entropy import dot_f32


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_embd: int
    n_experts: int = 8
    expert_hidden: int = 0  # 0 -> 4 * n_embd
    top_k: int = 2
    capacity_factor: float = 1.25
    # loss weights (GShard defaults)
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    dtype: Any = torch.bfloat16
    # gated=True: SwiGLU experts (wg/wi/wo), Mixtral's expert shape,
    # instead of the two-product GELU FFN.
    gated: bool = False
    # renorm_top_k=True: a token's combine weights are renormalized over
    # its kept choices (Mixtral's softmax over the top k) instead of the
    # raw full-softmax probabilities (GShard).
    renorm_top_k: bool = False

    @property
    def hidden(self) -> int:
        return self.expert_hidden or 4 * self.n_embd


def capacity(n: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n`` routed tokens, in Python floats as the
    JAX package computes it."""
    return int(math.ceil(cfg.capacity_factor * cfg.top_k * n / cfg.n_experts))


def init_moe_params(
    cfg: MoEConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    lead: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """Router [D, E] in f32 and experts wi [E, D, H], wo [E, H, D] (and
    wg [E, D, H] when gated) in ``cfg.dtype``, each normal(0, 0.02),
    drawn on ``device`` (CUDA unless the caller passes ``device="cpu"``)
    from ``generator``, a generator of that device (seed 0 by default).
    ``lead`` prepends dims to every leaf (``(n_layer,)`` for the stacked
    blocks of ``models/llama.py``). The numbers are PyTorch's, not
    ``jax.random``'s: the tests carry JAX weights over."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    E, D, H = cfg.n_experts, cfg.n_embd, cfg.hidden
    std = 0.02

    def norm(shape, dtype):
        x = torch.randn(lead + shape, generator=gen, device=dev)
        return x.mul_(std).to(dtype)

    params = {
        # The router stays f32: it is small, and routing decisions are
        # sensitive to its precision.
        "router": norm((D, E), torch.float32),
        "wi": norm((E, D, H), cfg.dtype),
        "wo": norm((E, H, D), cfg.dtype),
    }
    if cfg.gated:
        params["wg"] = norm((E, D, H), cfg.dtype)
    return params


def moe_logical_axes(gated: bool = False) -> Dict[str, Tuple]:
    axes = {
        "router": (None, None),
        "wi": ("expert", "embed", "mlp"),
        "wo": ("expert", "mlp", "embed"),
    }
    if gated:
        axes["wg"] = ("expert", "embed", "mlp")
    return axes


class Routing(NamedTuple):
    """Each token's choices, one row per choice in order: ``expert``,
    ``slot`` (its position in the expert's queue; >= capacity when
    dropped), ``keep`` and ``gate`` (its probability, 0 when dropped),
    all [top_k, n]."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor


def _route(
    logits: torch.Tensor, top_k: int, capacity: int
) -> Tuple[Routing, Dict[str, torch.Tensor]]:
    """The routing of ``_gating`` in compact form, and its metrics."""
    n, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    fill = torch.zeros(E, dtype=torch.long, device=logits.device)
    masked = logits
    rows = []
    top1 = None
    for _ in range(top_k):
        idx = masked.argmax(dim=-1)  # the first maximum, as jnp.argmax
        onehot = F.one_hot(idx, E)
        if top1 is None:
            top1 = onehot
        # position of each token within its chosen expert's queue
        ahead = (onehot.cumsum(0) - onehot).gather(1, idx[:, None])[:, 0]
        pos = ahead + fill[idx]
        keep = pos < capacity
        gate = probs.gather(1, idx[:, None])[:, 0] * keep
        rows.append((idx, pos, keep, gate))
        fill = fill + (onehot * keep[:, None]).sum(0)
        # mask this choice out for the next round
        masked = masked.masked_fill(onehot.bool(), -1e30)
    routing = Routing(*(torch.stack(x) for x in zip(*rows)))
    # GShard load-balance loss: E * sum_e mean_prob_e * frac_tokens_e
    frac_tokens = top1.float().mean(0)
    aux_loss = E * (frac_tokens * probs.mean(0)).sum()
    # router z-loss (keeps the logits' scale in check)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    metrics = {
        "aux_loss": aux_loss,
        "z_loss": z_loss,
        "dropped_fraction": 1.0 - (routing.gate > 0).sum() / (n * top_k),
    }
    return routing, metrics


def _gating(
    logits: torch.Tensor,  # [n, E] float32
    top_k: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(dispatch [n, E, C] bool, combine [n, E, C] f32, metrics), the
    JAX package's dense form: a kept choice sets its (expert, slot) in
    the token's dispatch row and its gate in the combine row; a dropped
    one leaves both all zero."""
    n, E = logits.shape
    r, metrics = _route(logits, top_k, capacity)
    dispatch = torch.zeros(
        (n, E, capacity), dtype=torch.bool, device=logits.device
    )
    combine = torch.zeros(
        (n, E, capacity), dtype=torch.float32, device=logits.device
    )
    tok = torch.arange(n, device=logits.device)
    for k in range(top_k):
        kept = r.keep[k]
        at = (tok[kept], r.expert[k][kept], r.slot[k][kept])
        dispatch[at] = True  # a token's choices name distinct experts
        combine[at] = r.gate[k][kept]
    return dispatch, combine, metrics


def top_k_gating(logits, top_k, capacity):
    return _gating(logits, top_k, capacity)


def switch_gating(logits, capacity):
    """Top-1 Switch-Transformer routing."""
    return _gating(logits, 1, capacity)


def moe_mlp(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, T, D]
    cfg: MoEConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward: (y [B, T, D] in x's dtype, aux loss, already
    weighted). Every row of ``x`` is routed: the caller's padding
    competes for capacity as in the JAX package."""
    B, T, D = x.shape
    n, E = B * T, cfg.n_experts
    C = capacity(n, cfg)
    flat = x.reshape(n, D)
    logits = dot_f32(flat, params["router"])  # [n, E]
    r, metrics = _route(logits, cfg.top_k, C)
    gate = r.gate
    if cfg.renorm_top_k:
        # Mixtral: weights renormalized over the token's kept choices
        # (the softmax over its top-k logits when nothing is dropped).
        gate = gate / gate.sum(0).clamp(min=1e-9)
    # Dispatch: slot (e, c) of the [E, C, D] buffer holds the row of the
    # token that claimed it, or the zero row n. Each slot is claimed at
    # most once; dropped choices write the spare last entry.
    tok = torch.arange(n, device=x.device).expand(cfg.top_k, n)
    where = torch.where(r.keep, r.expert * C + r.slot, E * C)
    slot_token = torch.full((E * C + 1,), n, dtype=torch.long,
                            device=x.device)
    slot_token[where.reshape(-1)] = tok.reshape(-1)
    rows = flat.to(cfg.dtype)
    rows = torch.cat([rows, rows.new_zeros((1, D))])
    buf = rows[slot_token[: E * C]].view(E, C, D)
    # expert FFN, batched over the experts
    h = dot_f32(buf, params["wi"])  # [E, C, H] f32
    if cfg.gated:
        h = (F.silu(dot_f32(buf, params["wg"])) * h).to(cfg.dtype)
    else:
        h = F.gelu(h, approximate="tanh").to(cfg.dtype)
    out = dot_f32(h, params["wo"]).view(E * C, D)
    # Combine: each token's kept expert rows times their gates, added
    # in choice order (a gather per choice: no atomics).
    y = None
    for k in range(cfg.top_k):
        row = out[torch.where(r.keep[k], r.expert[k] * C + r.slot[k], 0)]
        term = gate[k][:, None] * row
        y = term if y is None else y + term
    aux = (
        cfg.aux_loss_weight * metrics["aux_loss"]
        + cfg.z_loss_weight * metrics["z_loss"]
    )
    return y.reshape(B, T, D).to(x.dtype), aux

