"""GPT language model (counterpart of ``dlrover_tpu/models/gpt.py``).

The same model and the same parameter tree as the JAX package, as plain
functions on a nested dict of tensors:

* block leaves stacked on a leading ``[n_layer, ...]`` axis;
* bf16 weights, f32 LayerNorm gains and biases; no bias on the qkv or
  output projections, biases ``bi``/``bo2`` on the MLP; tied ``wte``;
* weights in the JAX orientation ``[in, out]``, applied as ``x @ w``.

Numerics follow the reference where the frameworks could differ:
LayerNorm statistics in f32 with ``correction=0`` and the result cast
back to x's dtype; the embedding add in the parameter dtype; tanh GELU
(``jax.nn.gelu``'s default); f32 logits from bf16 operands.

On a CUDA device attention runs the flash-attention kernels
(``ops/flash_attention.py``) from 512 context up; the dense masked
softmax otherwise or when ``use_flash_attention=False``. The norms run
the fused LayerNorm kernels (``ops/layer_norm.py``) for a bf16 model on
CUDA, with the attention residual add fused into the second norm; the
plain LayerNorm otherwise or when ``use_fused_norm=False``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.accelerate.remat import wire_block
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.ops.cross_entropy import dot_f32, fused_cross_entropy
from dlrover_tpu_torch.ops.flash_attention import flash_attention
from dlrover_tpu_torch.ops.layer_norm import (
    fused_add_layer_norm,
    fused_layer_norm,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The JAX package's ``GPTConfig``, field for field. ``attn_blocks``
    and ``scan_unroll`` tune the TPU kernel's tiles and XLA's layer
    scan; the port's kernels have fixed tiles and its layers run as a
    Python loop, so the port accepts ``scan_unroll`` and ignores it, and
    raises on ``attn_blocks``."""

    vocab_size: int = 50304
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0  # not implemented, as in the JAX package
    dtype: Any = torch.bfloat16
    remat: Any = True  # accelerate/remat.py policy; True = "full"
    # None = flash kernels on CUDA from 512 context up; True/False force.
    use_flash_attention: Optional[bool] = None
    # None = fused norm kernels for bf16 on CUDA, plain LayerNorm
    # otherwise; True/False force.
    use_fused_norm: Optional[bool] = None
    causal: bool = True
    attn_blocks: Optional[tuple] = None
    scan_unroll: int = 1

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def nano() -> "GPTConfig":
        """The reference nanoGPT 'baby GPT' demo size."""
        return GPTConfig(
            vocab_size=50304, block_size=256, n_layer=6, n_head=6,
            n_embd=384,
        )

    @staticmethod
    def gpt2() -> "GPTConfig":
        return GPTConfig()


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: GPTConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Params:
    """GPT-2-style init (normal 0.02, residual projections scaled by
    1/sqrt(2 n_layer)), drawn in f32 on the CPU from ``generator``
    (seed 0 by default), cast to ``cfg.dtype`` and moved to ``device``
    (CUDA unless the caller passes ``device="cpu"``). The numbers are
    PyTorch's, not ``jax.random``'s: the tests carry JAX weights over
    with ``models/convert.py``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    E, L = cfg.n_embd, cfg.n_layer
    std = 0.02
    resid_std = 0.02 / math.sqrt(2 * cfg.n_layer)

    def norm(shape, s=std):
        return (torch.randn(shape, generator=gen) * s).to(cfg.dtype)

    params: Params = {
        "wte": norm((cfg.vocab_size, E)),
        "wpe": norm((cfg.block_size, E)),
        "blocks": {
            "ln1_g": torch.ones(L, E),
            "ln1_b": torch.zeros(L, E),
            "wqkv": norm((L, E, 3 * E)),
            "wo": norm((L, E, E), resid_std),
            "ln2_g": torch.ones(L, E),
            "ln2_b": torch.zeros(L, E),
            "wi": norm((L, E, 4 * E)),
            "bi": torch.zeros(L, 4 * E, dtype=cfg.dtype),
            "wo2": norm((L, 4 * E, E), resid_std),
            "bo2": torch.zeros(L, E, dtype=cfg.dtype),
        },
        "lnf_g": torch.ones(E),
        "lnf_b": torch.zeros(E),
    }
    return _to(params, dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x, g, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps) * g + b
    return out.to(x.dtype)


def use_fused_norm(cfg, device=None) -> bool:
    """Whether the blocks run the fused norm kernels (K3/K4,
    ``ops/layer_norm.py``): ``cfg.use_fused_norm`` when set, else for a
    bf16 model (the kernels' type) on CUDA and not on the CPU. The JAX
    package defaults to off from a v5e measurement, which does not
    carry over to this card."""
    if cfg.use_fused_norm is not None:
        return bool(cfg.use_fused_norm)
    return (
        torch.device(device or "cpu").type == "cuda"
        and cfg.dtype == torch.bfloat16
    )


def _default_attention(q, k, v, causal=True, window=None):
    """Plain masked softmax attention on [B, T, H, D] (the JAX
    package's ``_default_attention``): f32 scores, softmax, P cast to
    v's dtype for the value product. ``window`` is the Mistral sliding
    window: query i sees keys (i - window, i]."""
    if window is not None and not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True"
        )
    lq, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal or window is not None:
        pos = torch.arange(lq, device=q.device)
        hidden = pos[:, None] < pos[None, :]
        if window is not None:
            hidden |= (pos[:, None] - pos[None, :]) >= window
        s = s.masked_fill(hidden, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _block(x, lp, cfg: GPTConfig, attn_fn):
    """One transformer block; ``lp`` is this layer's slice of the
    stacked block parameters."""
    B, T, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    fused = use_fused_norm(cfg, x.device)
    if fused:
        h = fused_layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    else:
        h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    qkv = h @ lp["wqkv"]  # [B, T, 3E]
    q, k, v = qkv.split(E, dim=-1)
    att = attn_fn(
        q.reshape(B, T, H, D), k.reshape(B, T, H, D), v.reshape(B, T, H, D)
    ).reshape(B, T, E)
    att_out = att @ lp["wo"]
    if fused:
        # The attention residual add rides inside the norm kernel.
        h, x = fused_add_layer_norm(att_out, x, lp["ln2_g"], lp["ln2_b"])
    else:
        x = x + att_out
        h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    h = F.gelu(h @ lp["wi"] + lp["bi"], approximate="tanh")
    x = x + h @ lp["wo2"] + lp["bo2"]
    return x


def use_flash_attention(cfg, device=None) -> bool:
    """Whether attention runs the flash kernels (K1/K2,
    ``ops/flash_attention.py``): ``cfg.use_flash_attention`` when set,
    else on CUDA from 512 context up."""
    if cfg.use_flash_attention is not None:
        return bool(cfg.use_flash_attention)
    return (
        torch.device(device or "cpu").type == "cuda"
        and cfg.block_size >= 512
    )


def default_attention_for(cfg: GPTConfig, device=None) -> Callable:
    """The attention implementation for this config on ``device``:
    the flash kernels on CUDA from 512 context up (None), or as
    ``cfg.use_flash_attention`` forces; with the config's sliding
    window where it has one (the Llama family)."""
    if cfg.attn_blocks is not None:
        raise NotImplementedError(
            "attn_blocks tunes the TPU kernel's tiles; the CUDA kernels "
            "choose their own tiles for each head_dim"
        )
    window = getattr(cfg, "sliding_window", None)
    fn = (
        flash_attention if use_flash_attention(cfg, device)
        else _default_attention
    )
    return functools.partial(fn, causal=cfg.causal, window=window)


def backbone(
    params: Params,
    tokens: torch.Tensor,
    cfg: GPTConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """[B, T] tokens -> final hidden [B, T, E], without the
    unembedding (the fused cross-entropy starts here). The final norm
    is the plain LayerNorm, as in the JAX package."""
    if attn_fn is None:
        attn_fn = default_attention_for(cfg, tokens.device)
    T = tokens.shape[1]
    x = F.embedding(tokens, params["wte"]) + params["wpe"][:T][None]
    x = x.to(cfg.dtype)
    block = wire_block(
        lambda x, lp, af: _block(x, lp, cfg=cfg, attn_fn=af),
        cfg.remat,
        attn_fn,
    )
    # One unbind per stacked leaf: its backward stacks the per-layer
    # gradients once, where indexing each layer would scatter each one
    # into a full [L, ...] zero tensor.
    names = sorted(params["blocks"])
    per_layer = [params["blocks"][n].unbind(0) for n in names]
    for i in range(cfg.n_layer):
        x = block(x, {n: per_layer[j][i] for j, n in enumerate(names)})
    return _layer_norm(x, params["lnf_g"], params["lnf_b"])


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: GPTConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """[B, T] tokens -> [B, T, vocab] f32 logits (tied embedding)."""
    x = backbone(params, tokens, cfg, attn_fn)
    return dot_f32(x, params["wte"].t())


def loss_fn(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: GPTConfig,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    logits = forward(params, tokens, cfg, attn_fn)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets[..., None].long())
    return -ll.mean()


def loss_fn_fused(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: GPTConfig,
    attn_fn: Optional[Callable] = None,
    num_chunks: int = 8,
    save_logits: bool = False,
) -> torch.Tensor:
    """The same loss through the chunked fused cross-entropy
    (``ops/cross_entropy.py``): no [B*T, V] log-softmax is held."""
    x = backbone(params, tokens, cfg, attn_fn)
    n = x.shape[0] * x.shape[1]
    return fused_cross_entropy(
        x.reshape(n, -1), params["wte"], targets.reshape(n).long(),
        num_chunks, save_logits,
    )


def num_params(params: Params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def flops_per_token(cfg: GPTConfig) -> float:
    """Training FLOPs per token, PaLM's MFU convention:
    6 N_matmul + 12 L T E (attention, no causal discount)."""
    E, L = cfg.n_embd, cfg.n_layer
    n_matmul = 12 * L * E * E + cfg.vocab_size * E
    attn = 12 * L * cfg.block_size * E
    return 6.0 * n_matmul + attn
