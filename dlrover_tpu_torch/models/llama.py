"""Llama-family language model (counterpart of
``dlrover_tpu/models/llama.py``).

The same model and parameter tree as the JAX package, as plain
functions on a nested dict of tensors:

* block leaves stacked on a leading ``[n_layer, ...]`` axis, weights in
  the JAX orientation ``[in, out]``; bf16 weights, f32 RMSNorm gains;
* RoPE tables in f32 computed once per forward (split-halves
  convention, cast to the activations' dtype before the multiply, as
  the JAX ``apply_rope`` does), optional partial rotary
  (``rotary_pct``) and q/k/v biases (``qkv_bias``);
* grouped-query attention by repeating each kv head over its query
  group (``repeat_interleave``, JAX's ``jnp.repeat``), SwiGLU MLP;
* an untied ``lm_head`` with f32 logits, and the final ``rmsf`` norm
  always the plain RMSNorm.

On a CUDA device the blocks run the flash-attention kernels from 512
context up (``ops/flash_attention.py``, head_dim 64 or 128) and the
fused RMSNorm kernels (``ops/layer_norm.py``), the attention residual
add fused into the second norm. Mixture-of-experts blocks
(``n_experts > 0``) are not ported (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.accelerate.remat import wire_block
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models import gpt
from dlrover_tpu_torch.ops.cross_entropy import dot_f32, fused_cross_entropy
from dlrover_tpu_torch.ops.layer_norm import (
    fused_add_rms_norm,
    fused_rms_norm,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's ``LlamaConfig``, field for field.
    ``attn_blocks`` tunes the TPU kernel's tiles and raises here, as on
    GPT; ``prefix_lm`` is read by the decode paths, which are not
    ported yet."""

    vocab_size: int = 32000
    block_size: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32  # < n_head enables grouped-query attention
    n_embd: int = 4096
    intermediate: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: Any = True  # accelerate/remat.py policy; True = "full"
    # None = flash kernels on CUDA from 512 context up; True/False force.
    use_flash_attention: Optional[bool] = None
    # None = fused norm kernels for bf16 on CUDA, plain RMSNorm
    # otherwise; True/False force.
    use_fused_norm: Optional[bool] = None
    causal: bool = True
    n_experts: int = 0  # > 0: mixture-of-experts MLP (not ported)
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # Mistral sliding window: query i sees keys (i - window, i].
    sliding_window: Optional[int] = None
    attn_blocks: Optional[tuple] = None
    qkv_bias: bool = False
    prefix_lm: bool = False
    # Fraction of head_dim that receives the rotary embedding.
    rotary_pct: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_kv_head

    def __post_init__(self):
        if self.n_head % self.n_kv_head:
            raise ValueError(
                f"n_head={self.n_head} not divisible by "
                f"n_kv_head={self.n_kv_head}"
            )
        rot = int(self.head_dim * self.rotary_pct)
        if not 0 < rot <= self.head_dim or rot % 2:
            raise ValueError(
                f"rotary_pct={self.rotary_pct} gives {rot} rotary "
                f"dims of head_dim={self.head_dim}; need an even "
                "count in (0, head_dim]"
            )
        if self.prefix_lm and self.sliding_window is not None:
            raise ValueError(
                "prefix_lm and sliding_window are mutually "
                "exclusive: the bidirectional prefix has no causal "
                "band to window"
            )

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, block_size=8192, n_layer=32, n_head=32,
            n_kv_head=8, n_embd=4096, intermediate=14336,
            rope_theta=500000.0,
        )

    @staticmethod
    def tiny() -> "LlamaConfig":
        """Test-size config (GQA on, so tests cover the kv repeat)."""
        return LlamaConfig(
            vocab_size=256, block_size=64, n_layer=2, n_head=4,
            n_kv_head=2, n_embd=64, intermediate=128,
            dtype=torch.float32, remat=False,
        )

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        """Mistral-7B-v0.1: Llama backbone + GQA + 4k sliding window
        over an 8k context."""
        return LlamaConfig(
            vocab_size=32000, block_size=8192, n_layer=32, n_head=32,
            n_kv_head=8, n_embd=4096, intermediate=14336,
            rope_theta=10000.0, sliding_window=4096,
        )


def _no_moe(cfg: LlamaConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "n_experts > 0 needs models/moe.py, not ported yet (ROADMAP "
            "queue 1, item 12)"
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Params:
    """Llama init: normal(0, 0.02), residual-output projections scaled
    by 1/sqrt(2 n_layer). Each leaf is drawn on ``device`` (CUDA unless
    the caller passes ``device="cpu"``) from ``generator``, a generator
    of that device (seed 0 by default), so no full-model copy is built
    on the host. The numbers are PyTorch's, not ``jax.random``'s: the
    tests carry JAX weights over with ``models/convert.py``."""
    _no_moe(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    E, L, I = cfg.n_embd, cfg.n_layer, cfg.intermediate
    kv = cfg.n_kv_head * cfg.head_dim
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def norm(shape, s=std):
        x = torch.randn(shape, generator=gen, device=dev)
        return x.mul_(s).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    wte = norm((cfg.vocab_size, E))
    blocks = {
        "rms1": ones((L, E)),
        "wq": norm((L, E, E)),
        "wk": norm((L, E, kv)),
        "wv": norm((L, E, kv)),
        "wo": norm((L, E, E), resid_std),
        "rms2": ones((L, E)),
    }
    if cfg.qkv_bias:
        blocks.update(bq=zeros((L, E)), bk=zeros((L, kv)), bv=zeros((L, kv)))
    blocks.update(
        w_gate=norm((L, E, I)),
        w_up=norm((L, E, I)),
        w_down=norm((L, I, E), resid_std),
    )
    return {
        "wte": wte,
        "blocks": blocks,
        "rmsf": ones((E,)),
        "lm_head": norm((cfg.vocab_size, E)),
    }


def param_logical_axes(cfg: LlamaConfig) -> Params:
    """Logical sharding axes per leaf, as the JAX package names them
    (read by the parallelism slice, ROADMAP queue 1 item 10)."""
    _no_moe(cfg)
    blocks = {
        "rms1": ("layers", None),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "heads"),
        "wv": ("layers", "embed", "heads"),
        "wo": ("layers", "heads", "embed"),
        "rms2": ("layers", None),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    if cfg.qkv_bias:
        blocks.update(
            bq=("layers", "heads"), bk=("layers", "heads"),
            bv=("layers", "heads"),
        )
    return {
        "wte": ("vocab", "embed"),
        "blocks": blocks,
        "rmsf": (None,),
        "lm_head": ("vocab", "embed"),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _rms_norm(x, g, eps):
    x32 = x.float()
    scale = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * scale * g).to(x.dtype)


def rope_table(
    cfg: LlamaConfig, t: int, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [T, rot/2] in f32, rot = head_dim * rotary_pct."""
    d2 = int(cfg.head_dim * cfg.rotary_pct) // 2
    inv_freq = 1.0 / (
        cfg.rope_theta ** (np.arange(0, d2, dtype=np.float32) / d2)
    )
    inv_freq = torch.tensor(inv_freq, dtype=torch.float32, device=device)
    pos = torch.arange(t, dtype=torch.float32, device=device)
    ang = pos[:, None] * inv_freq[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, T, H, D] rotated, split-halves convention (HF Llama); the
    trailing D - 2 * table dims pass through when rotary_pct < 1."""
    d2 = cos.shape[-1]
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    parts = [x1 * c - x2 * s, x2 * c + x1 * s]
    if 2 * d2 < x.shape[-1]:
        parts.append(x[..., 2 * d2:])
    return torch.cat(parts, dim=-1)


def _block(x, lp, cfg: LlamaConfig, attn_fn, cos, sin):
    """One block; returns (x, aux), aux a zero f32 scalar (the router
    loss of MoE blocks in the JAX package)."""
    B, T, E = x.shape
    H, Hkv, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    fused = gpt.use_fused_norm(cfg, x.device)
    if fused:
        h = fused_rms_norm(x, lp["rms1"], eps=cfg.rms_eps)
    else:
        h = _rms_norm(x, lp["rms1"], cfg.rms_eps)
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.reshape(B, T, H, D), cos, sin)
    k = apply_rope(k.reshape(B, T, Hkv, D), cos, sin)
    v = v.reshape(B, T, Hkv, D)
    if Hkv != H:
        # grouped-query: each kv head serves its group of query heads
        k = k.repeat_interleave(cfg.q_per_kv, dim=2)
        v = v.repeat_interleave(cfg.q_per_kv, dim=2)
    att = attn_fn(q, k, v).reshape(B, T, E)
    if fused:
        # The attention residual add rides inside the second norm: it
        # normalises the f32 sum and returns that sum rounded to bf16.
        h, x = fused_add_rms_norm(
            att @ lp["wo"], x, lp["rms2"], eps=cfg.rms_eps
        )
    else:
        x = x + att @ lp["wo"]
        h = _rms_norm(x, lp["rms2"], cfg.rms_eps)
    return mlp_tail(x, h, lp, cfg)


def mlp_tail(x, h, lp, cfg: LlamaConfig):
    """Dense SwiGLU tail of a block: (x + mlp(h), zero aux)."""
    _no_moe(cfg)
    gated = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + gated @ lp["w_down"], aux


def head_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """lm_head projection with f32 logits."""
    return dot_f32(x, params["lm_head"].t())


def default_attention_for(cfg: LlamaConfig, device=None) -> Callable:
    """The same selection as GPT (``gpt.default_attention_for`` reads
    only the fields both configs carry, the sliding window included)."""
    return gpt.default_attention_for(cfg, device)


def backbone_with_aux(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    attn_fn: Optional[Callable] = None,
) -> tuple:
    """Forward without the head: ([B, T, E] hidden, summed aux loss)."""
    if attn_fn is None:
        attn_fn = default_attention_for(cfg, tokens.device)
    T = tokens.shape[1]
    cos, sin = rope_table(cfg, T, tokens.device)
    x = F.embedding(tokens, params["wte"]).to(cfg.dtype)
    block = wire_block(
        lambda x, lp, af: _block(
            x, lp, cfg=cfg, attn_fn=af, cos=cos, sin=sin
        ),
        cfg.remat,
        attn_fn,
    )
    # One unbind per stacked leaf (see gpt.backbone).
    names = sorted(params["blocks"])
    per_layer = [params["blocks"][n].unbind(0) for n in names]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layer):
        x, a = block(x, {n: per_layer[j][i] for j, n in enumerate(names)})
        aux = aux + a
    return _rms_norm(x, params["rmsf"], cfg.rms_eps), aux


def backbone(params, tokens, cfg: LlamaConfig, attn_fn=None):
    return backbone_with_aux(params, tokens, cfg, attn_fn)[0]


def forward(params, tokens, cfg: LlamaConfig, attn_fn=None):
    """[B, T] tokens -> [B, T, vocab] f32 logits (untied lm_head)."""
    return head_logits(params, backbone(params, tokens, cfg, attn_fn))


def loss_fn(params, tokens, targets, cfg: LlamaConfig, attn_fn=None):
    x, aux = backbone_with_aux(params, tokens, cfg, attn_fn)
    logp = torch.log_softmax(head_logits(params, x), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())
    return -ll.mean() + aux


def loss_fn_fused(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: LlamaConfig,
    attn_fn: Optional[Callable] = None,
    num_chunks: int = 8,
    save_logits: bool = False,
) -> torch.Tensor:
    """The same loss through the chunked fused cross-entropy against
    the untied ``lm_head``."""
    x, aux = backbone_with_aux(params, tokens, cfg, attn_fn)
    n = x.shape[0] * x.shape[1]
    return fused_cross_entropy(
        x.reshape(n, -1), params["lm_head"], targets.reshape(n).long(),
        num_chunks, save_logits,
    ) + aux


def flops_per_token(cfg: LlamaConfig) -> float:
    """Training FLOPs per token, PaLM's convention: 6 x matmul params
    + attention's score and value products (no causal discount); MoE
    counts the active experts and the router."""
    E, L, I = cfg.n_embd, cfg.n_layer, cfg.intermediate
    kv = cfg.n_kv_head * cfg.head_dim
    if cfg.n_experts > 0:
        mlp = 3 * cfg.moe_top_k * E * I + E * cfg.n_experts
    else:
        mlp = 3 * E * I
    per_layer = E * E + 2 * E * kv + E * E + mlp
    n_matmul = L * per_layer + cfg.vocab_size * E
    attn = 12 * L * cfg.block_size * E
    return 6.0 * n_matmul + attn
