"""Named rematerialization policies (counterpart of
``dlrover_tpu/accelerate/remat.py``).

The JAX package names six ``jax.checkpoint`` policies. The port has the
two that GPT uses:

  "none"  keep every activation (fastest, most memory)
  "full"  recompute each block in the backward: the block runs under
          ``torch.utils.checkpoint`` (non-reentrant), so only its input
          is kept, and its flash forward kernel runs a second time
          in the backward.

Booleans keep working: True == "full", False == "none". The other
policies ("attention", "dots", "offload", "save_attn") are named but
raise ``NotImplementedError`` until the auto-acceleration slice ports
them (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from typing import Any, Callable

from torch.utils.checkpoint import checkpoint

POLICY_NAMES = (
    "none", "full", "attention", "dots", "offload", "save_attn"
)
PORTED = ("none", "full")


def canonical(policy: Any) -> str:
    if policy is True:
        return "full"
    if policy in (False, None):
        return "none"
    if policy in POLICY_NAMES:
        return str(policy)
    raise ValueError(
        f"unknown remat policy {policy!r}; choose from "
        f"{POLICY_NAMES} (or True/False)"
    )


def wire_block(inner_block: Callable, policy: Any,
               attn_fn: Callable) -> Callable:
    """The block callable ``(x, layer_params) -> out`` with the named
    policy applied; ``inner_block(x, layer_params, attn_fn)``. ``out``
    is whatever the inner block returns: ``x`` for GPT, the tuple
    ``(x, aux)`` for Llama, which ``checkpoint`` carries as it is."""
    name = canonical(policy)
    if name not in PORTED:
        raise NotImplementedError(
            f"remat policy {name!r} is not ported yet (ROADMAP queue 1, "
            f"item 11, auto-acceleration); the port has {PORTED}"
        )
    if name == "none":
        return lambda x, lp: inner_block(x, lp, attn_fn)

    def block(x, lp):
        # The models here draw no random numbers (dropout is not
        # implemented, as in the JAX package), so there is no RNG state
        # to replay in the recompute.
        return checkpoint(
            inner_block, x, lp, attn_fn,
            use_reentrant=False, preserve_rng_state=False,
        )

    return block
