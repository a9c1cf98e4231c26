"""Prefix-LM attention composed from the flash-attention kernels
(counterpart of ``dlrover_tpu/ops/prefix_lm.py``).

GLM trains by blank infilling: the prefix's tokens attend to each other
both ways, the suffix's attend to the whole prefix and causally to the
suffix before them. The mask splits exactly onto calls of the flash
kernels (``ops/flash_attention.py``), with no masking code of its own:

* a suffix row i >= p sees {j <= i} and {j < p}, which is {j <= i}:
  plain causal rows at their global offset;
* a prefix row i < p sees {j <= i} and {j < p}, which is {j < p}: full
  attention within the p x p prefix square.

So one non-causal ``flash_attention`` on the prefix, and one causal
``flash_attention_rect`` of the t - p suffix queries against all t keys
at ``q_offset = p``. On a CUDA tensor both reach K1 forward and K2
backward, or raise; there is no fallback. The backward runs through
ordinary slicing: the prefix keys' dK and dV add up over the two calls.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dlrover_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_rect,
)


def prefix_lm_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prefix_len: int,
    scale: Optional[float] = None,
    attn_blocks: Optional[tuple] = None,
) -> torch.Tensor:
    """Prefix-LM attention on [B, T, H, D] inputs: the first
    ``prefix_len`` positions attend bidirectionally among themselves,
    the rest to the whole prefix and causally within the suffix.
    ``prefix_len == 0`` is causal attention, ``prefix_len == T`` full
    attention, each one kernel call."""
    if attn_blocks is not None:
        raise NotImplementedError(
            "attn_blocks tunes the TPU kernel's tiles; the CUDA kernels "
            "choose their own tiles for each head_dim"
        )
    t = q.shape[1]
    p = int(prefix_len)
    if not 0 <= p <= t:
        raise ValueError(f"prefix_len={p} outside [0, {t}]")
    if p == 0:
        return flash_attention(q, k, v, causal=True, scale=scale)
    if p == t:
        return flash_attention(q, k, v, causal=False, scale=scale)
    o_pre = flash_attention(
        q[:, :p], k[:, :p], v[:, :p], causal=False, scale=scale
    )
    o_suf = flash_attention_rect(
        q[:, p:], k, v, causal=True, q_offset=p, scale=scale
    )
    return torch.cat([o_pre, o_suf], dim=1)


def prefix_lm_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prefix_len: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense reference (and the non-flash path): the same mask
    materialized, scores and softmax in f32, the output in q's dtype."""
    t, d = q.shape[1], q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pos = torch.arange(t, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < prefix_len)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
