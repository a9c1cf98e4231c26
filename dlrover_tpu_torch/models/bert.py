"""Bidirectional encoder (BERT family) on the GPT backbone (counterpart
of ``dlrover_tpu/models/bert.py``).

The encoder is ``models/gpt.py``'s backbone with ``causal=False``:
learned positions, pre-LN blocks, the GELU MLP, and on the card the
flash kernels without a mask (K1/K2) and the fused LayerNorm kernels
(K3/K4). It adds BERT's two training surfaces:

* the masked-language-model objective (:func:`mask_tokens` and
  :func:`mlm_loss_fn`), with 80/10/10 corruption;
* a sequence classifier over the mean of the final hiddens
  (:func:`init_classifier_params`, :func:`classifier_loss_fn`), the
  fine-tuning path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models import gpt

Params = Any


def bert_base(**overrides) -> gpt.GPTConfig:
    """BERT-base shape (L12 H12 E768, 30522 WordPiece vocab) as a
    non-causal GPTConfig."""
    cfg = gpt.GPTConfig(
        vocab_size=30522, block_size=512, n_layer=12, n_head=12,
        n_embd=768, causal=False,
    )
    return dataclasses.replace(cfg, **overrides)


def bert_large(**overrides) -> gpt.GPTConfig:
    cfg = gpt.GPTConfig(
        vocab_size=30522, block_size=512, n_layer=24, n_head=16,
        n_embd=1024, causal=False,
    )
    return dataclasses.replace(cfg, **overrides)


def tiny(**overrides) -> gpt.GPTConfig:
    """Test-size encoder."""
    cfg = gpt.GPTConfig(
        vocab_size=256, block_size=64, n_layer=2, n_head=4, n_embd=64,
        causal=False, dtype=torch.float32, remat=False,
    )
    return dataclasses.replace(cfg, **overrides)


# Parameter init and axes are the backbone's own.
init_params = gpt.init_params
param_logical_axes = gpt.param_logical_axes


def mask_tokens(
    generator: torch.Generator,
    tokens: torch.Tensor,
    vocab_size: int,
    mask_id: int,
    mask_rate: float = 0.15,
) -> tuple:
    """BERT corruption: select ``mask_rate`` of the positions; replace
    80% of those with ``mask_id``, 10% with a random token, keep 10%.
    Returns (corrupted [B, T], labels [B, T] = the original tokens,
    weights [B, T] f32, 1.0 at selected positions). The draws come from
    ``generator``, a generator of the tokens' device, in this order:
    the selection, the operation, the random tokens. They are not
    ``jax.random``'s: the tests hand both packages the same corruption."""
    dev = tokens.device
    sel = torch.rand(tokens.shape, generator=generator, device=dev) < mask_rate
    op = torch.rand(tokens.shape, generator=generator, device=dev)
    rand_tok = torch.randint(
        0, vocab_size, tokens.shape, generator=generator, device=dev
    ).to(tokens.dtype)
    corrupted = torch.where(
        sel & (op < 0.8),
        torch.full_like(tokens, mask_id),
        torch.where(sel & (op >= 0.9), rand_tok, tokens),
    )
    return corrupted, tokens, sel.float()


def mlm_loss_fn(
    params: Params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    cfg: gpt.GPTConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Mean cross-entropy over the selected (weight > 0) positions, the
    logits through the tied embedding."""
    logits = gpt.forward(params, tokens, cfg, attn_fn)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -(ll * weights).sum() / weights.sum().clamp(min=1.0)


def init_classifier_params(
    cfg: gpt.GPTConfig,
    n_classes: int,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Params:
    """The backbone's parameters (``gpt.init_params``) plus a mean-pool
    classification head: ``cls_w`` [E, n_classes] normal(0, 0.02) and
    ``cls_b`` zeros, both f32, drawn after the backbone from the same
    CPU ``generator`` (seed 0 by default) and moved to ``device``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    params = gpt.init_params(cfg, generator=gen, device=dev)
    params["cls_w"] = (
        torch.randn((cfg.n_embd, n_classes), generator=gen) * 0.02
    ).to(dev)
    params["cls_b"] = torch.zeros((n_classes,), device=dev)
    return params


def classifier_logits(
    params: Params,
    tokens: torch.Tensor,
    cfg: gpt.GPTConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """[B, T] -> [B, n_classes] f32 logits from the mean-pooled final
    hiddens."""
    x = gpt.backbone(params, tokens, cfg, attn_fn)  # [B, T, E]
    pooled = x.float().mean(dim=1)
    return pooled @ params["cls_w"] + params["cls_b"]


def classifier_loss_fn(
    params: Params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    cfg: gpt.GPTConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    logits = classifier_logits(params, tokens, cfg, attn_fn)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def classifier_logical_axes(cfg: gpt.GPTConfig, n_classes: int):
    axes = gpt.param_logical_axes(cfg)
    axes["cls_w"] = ("embed", None)
    axes["cls_b"] = (None,)
    return axes
