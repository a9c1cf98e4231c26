"""GLM family (ChatGLM2/3) on the Llama backbone (counterpart of
``dlrover_tpu/models/glm.py``).

ChatGLM2/3 is the Llama backbone of ``models/llama.py`` with three
config switches: a bias on the q/k/v projections (``qkv_bias``), rotary
embedding over half of each head's dims (``rotary_pct=0.5``), and
grouped-query attention with 2 kv groups (``n_kv_head=2``).

What GLM adds is its training objective, blank infilling: a prefix of
context tokens attends both ways, the suffix that is generated attends
causally (``ops/prefix_lm.py``: a non-causal flash call on the prefix
square and a causal rectangular call of the suffix queries at their
global offset). :func:`prefix_attention_for` binds a prefix length into
an attention function the backbone takes unchanged, and
:func:`prefix_lm_loss_fn` scores only the positions that predict suffix
tokens. Generation prefills the prompt bidirectionally
(``cfg.prefix_lm``, ``generate.llama_prefill(causal=False)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from dlrover_tpu_torch.models import gpt, llama
from dlrover_tpu_torch.ops.prefix_lm import (
    prefix_lm_attention,
    prefix_lm_attention_reference,
)

Params = llama.Params


def chatglm2_6b(**overrides) -> llama.LlamaConfig:
    """ChatGLM2-6B shape: L28 H32 E4096, 2 kv groups, ffn 13696,
    65024-token vocab, half-dim RoPE, qkv bias."""
    cfg = llama.LlamaConfig(
        vocab_size=65024, block_size=32768, n_layer=28, n_head=32,
        n_kv_head=2, n_embd=4096, intermediate=13696, rope_theta=10000.0,
        qkv_bias=True, rotary_pct=0.5, prefix_lm=True,
    )
    return dataclasses.replace(cfg, **overrides)


def chatglm3_6b(**overrides) -> llama.LlamaConfig:
    """ChatGLM3-6B: ChatGLM2's architecture with an 8k context."""
    return chatglm2_6b(block_size=8192, **overrides)


def tiny(**overrides) -> llama.LlamaConfig:
    """Test-size GLM: qkv bias, partial rotary and GQA."""
    cfg = llama.LlamaConfig(
        vocab_size=256, block_size=64, n_layer=2, n_head=4, n_kv_head=2,
        n_embd=64, intermediate=128, qkv_bias=True, rotary_pct=0.5,
        prefix_lm=True, dtype=torch.float32, remat=False,
    )
    return dataclasses.replace(cfg, **overrides)


# Parameter init, axes and the forward are the backbone's own.
init_params = llama.init_params
param_logical_axes = llama.param_logical_axes
forward = llama.forward
loss_fn = llama.loss_fn


def prefix_attention_for(
    cfg: llama.LlamaConfig, prefix_len: int, mesh=None, device=None
) -> Callable:
    """Attention with GLM's prefix-LM mask bound in, for ``device``: the
    flash composition where ``gpt.use_flash_attention`` picks the
    kernels (CUDA from 512 context up, or as the config forces), the
    dense masked reference otherwise. A ``mesh`` (its ``shape`` a
    mapping of axis names to sizes, as the JAX package's meshes have)
    whose ``seq`` axis is larger than 1 raises: the sequence-sharded
    prefix ring is not ported (ROADMAP queue 1, item 6)."""
    if mesh is not None and dict(getattr(mesh, "shape", {})).get("seq", 1) > 1:
        raise NotImplementedError(
            "sequence-sharded prefix-LM attention (the prefix ring) is not "
            "ported yet (ROADMAP queue 1, item 6)"
        )
    if gpt.use_flash_attention(cfg, device):
        blocks = cfg.attn_blocks
        return lambda q, k, v: prefix_lm_attention(
            q, k, v, prefix_len, attn_blocks=blocks
        )
    return lambda q, k, v: prefix_lm_attention_reference(q, k, v, prefix_len)


def prefix_lm_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: llama.LlamaConfig,
    prefix_len: int,
) -> torch.Tensor:
    return llama.forward(
        params, tokens, cfg,
        prefix_attention_for(cfg, prefix_len, device=tokens.device),
    )


def prefix_lm_loss_fn(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: llama.LlamaConfig,
    prefix_len: int,
) -> torch.Tensor:
    """Blank-infilling objective: next-token cross-entropy over the
    positions that predict suffix tokens, the band [prefix_len - 1,
    T - 1). The last prefix position is in it (its head generates the
    first suffix token); position T - 1 is not (its target would wrap
    around under the ``roll(tokens, -1)`` convention). Plus the MoE
    aux loss, 0 for dense configs."""
    t = tokens.shape[1]
    lo = max(prefix_len - 1, 0)
    if lo >= t - 1:
        raise ValueError(
            f"prefix_len={prefix_len} leaves no supervised positions in a "
            f"length-{t} sequence (band [{lo}, {t - 1}) is empty) — a "
            "mis-bucketed batch would train on nothing"
        )
    x, aux = llama.backbone_with_aux(
        params, tokens, cfg,
        prefix_attention_for(cfg, prefix_len, device=tokens.device),
    )
    logp = torch.log_softmax(llama.head_logits(params, x), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    pos = torch.arange(t, device=tokens.device)
    band = ((pos >= lo) & (pos < t - 1)).to(ll.dtype)
    denom = band.sum().clamp(min=1.0)
    return -(ll * band[None, :]).sum() / (denom * tokens.shape[0]) + aux
