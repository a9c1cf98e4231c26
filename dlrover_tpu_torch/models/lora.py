"""LoRA fine-tuning as a transform of the parameter tree (counterpart of
``dlrover_tpu/models/lora.py``).

The LoRA factors are a separate nested dict that mirrors the targeted
weight leaves, ``{path: {"a": [..., in, r], "b": [..., r, out]}}``, and
:func:`apply` builds the effective weights ``W + (alpha / r) * A @ B``
in the leaf's dtype for each step. The model code is unchanged, and
only the LoRA tree is differentiated and given to the optimizer, so the
base weights stay frozen and carry no optimizer state::

    lcfg = LoraConfig(rank=8)
    lora_p = init_lora(params, lcfg, generator)
    def loss(lora_p, tokens, targets):
        return llama.loss_fn_fused(apply(params, lora_p, lcfg), ...)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.common.tree import tree_leaves

Params = Dict[str, Any]

# weight leaves LoRA attaches to by default (attention and MLP
# projections of both model families; never biases or norms)
DEFAULT_TARGETS = (
    "wqkv", "wo", "wi", "wo2",            # gpt
    "wq", "wk", "wv", "w_gate", "w_up", "w_down",  # llama (wo shared)
)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _is_target(name: str, leaf, cfg: LoraConfig) -> bool:
    return (
        name in cfg.targets
        and isinstance(leaf, torch.Tensor)
        and leaf.dim() >= 2
    )


def init_lora(
    params: Params,
    cfg: LoraConfig,
    generator: Optional[torch.Generator] = None,
) -> Params:
    """For each targeted leaf [..., in, out] (leading dims = stacked
    layers): A ~ normal with std 1/sqrt(in), [..., in, r], and B = 0,
    [..., r, out], both in the leaf's dtype and on its device. B = 0
    makes step 0 the base model. A is drawn in f32 from ``generator``
    (a generator of the leaves' device; seed 1 by default), leaf by
    leaf in the order of the flattened tree."""
    flat = _flatten_named(params)
    out: Dict[Tuple[str, ...], Any] = {}
    for path, leaf in flat.items():
        if not _is_target(path[-1], leaf, cfg):
            continue
        if generator is None:
            generator = torch.Generator(device=leaf.device).manual_seed(1)
        *lead, n_in, n_out = leaf.shape
        a = torch.randn(
            (*lead, n_in, cfg.rank), generator=generator,
            device=leaf.device,
        ) / (n_in ** 0.5)
        b = torch.zeros(
            (*lead, cfg.rank, n_out), dtype=leaf.dtype, device=leaf.device
        )
        out[path] = {"a": a.to(leaf.dtype), "b": b}
    return _unflatten_named(out)


def apply(params: Params, lora_params: Params, cfg: LoraConfig) -> Params:
    """Effective params: W + scaling * A@B on the targeted leaves, in
    the leaf's dtype; the other leaves are the base tensors
    themselves."""
    lora_flat = _flatten_named(lora_params, leaf_keys=("a", "b"))
    merged = dict(_flatten_named(params))
    for path, ab in lora_flat.items():
        w = merged[path]
        delta = torch.matmul(ab["a"], ab["b"]) * cfg.scaling
        merged[path] = w + delta.to(w.dtype)
    return _unflatten_named(merged)


def merge(params: Params, lora_params: Params, cfg: LoraConfig) -> Params:
    """Bake LoRA into the base weights for export or serving."""
    with torch.no_grad():
        return apply(params, lora_params, cfg)


def num_trainable(lora_params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(lora_params))


# ---------------------------------------------------------------------------
# named flatten/unflatten helpers (nested dicts only, as both model
# families use)
# ---------------------------------------------------------------------------


def _flatten_named(tree: Params, leaf_keys=None, prefix=()) -> dict:
    out = {}
    if isinstance(tree, dict):
        if leaf_keys is not None and set(tree) == set(leaf_keys):
            out[prefix] = tree
            return out
        for k, v in tree.items():
            out.update(_flatten_named(v, leaf_keys, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def _unflatten_named(flat: dict) -> Params:
    root: Params = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root
