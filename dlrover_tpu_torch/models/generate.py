"""Autoregressive decoding with a KV cache, GPT and Llama (counterpart
of ``dlrover_tpu/models/generate.py``).

The same functions on the same cache, as eager PyTorch:

* the cache is preallocated, ``KVCache(k, v)`` of ``[layers, batch,
  max_len, kv_heads, head_dim]`` tensors on an explicit device. Each is
  a view of head-major storage ``[layers, batch, kv_heads, max_len,
  head_dim]``, so every (lane, head) is one contiguous ``[T, D]``
  matrix: the decode products against the cache run as one strided
  batched GEMM over lanes x heads and never copy the cache;
* the JAX functions return a new cache; these write the given one in
  place (slice assignments and one per-layer scatter, never a clone and
  never a ``where`` over the whole cache) and return it, so the two
  packages keep one signature;
* the layer scan is a Python loop over the stacked block leaves, and
  ``generate`` loops over positions in Python.

Where a kernel computes the same function, the path runs it, as the
training forwards do (``gpt.use_flash_attention``,
``gpt.use_fused_norm``): on CUDA every block norm is the fused K3
(``ops/layer_norm.py``, the attention residual add inside the second
norm), the one-shot and chunked prefills' attention is K1
(``ops/flash_attention.py``), and so is the serving lane prefill's
(``flash_attention_rect`` with ``q_offset`` = the chunk's start;
:func:`_rect_attention_dense` is its plain version). Decode attention
against the cache and the head stay plain products, as in the JAX
package, with bf16 products summed in f32 and written as f32 (torch's
``out_dtype`` overloads of ``mm``/``bmm`` on the card; off the card the
operands are upcast). Sampling draws from a ``torch.Generator`` where
the JAX package takes a ``key``. Mixture-of-experts configs raise, as
``llama.mlp_tail`` does.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models import gpt as gpt_mod
from dlrover_tpu_torch.models import llama as llama_mod
from dlrover_tpu_torch.ops.cross_entropy import dot_f32
from dlrover_tpu_torch.ops.flash_attention import flash_attention_rect
from dlrover_tpu_torch.ops.layer_norm import (
    fused_add_layer_norm,
    fused_add_rms_norm,
    fused_layer_norm,
    fused_rms_norm,
)


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, T_max, H_kv, D]
    v: torch.Tensor


def _cache_for(
    cfg, batch: int, max_len: int, n_kv: int, device: DeviceLike = None
) -> KVCache:
    """A zeroed cache on ``device`` (the GPU unless the caller passes
    ``device="cpu"``): [L, B, T, H_kv, D] views of head-major storage."""
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, n_kv, max_len, cfg.head_dim)

    def buf():
        return torch.zeros(shape, dtype=cfg.dtype, device=dev).transpose(2, 3)

    return KVCache(k=buf(), v=buf())


def _low_precision_on_card(a, b) -> bool:
    return (
        a.is_cuda and a.dtype in (torch.bfloat16, torch.float16)
        and b.dtype == a.dtype
    )


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (b 2-D) with f32 products summed and written in f32."""
    if _low_precision_on_card(a, b):
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return dot_f32(a, b)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (3-D) with f32 products summed and written in
    f32."""
    if _low_precision_on_card(a, b):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return dot_f32(a, b)


def _attend_cache(q, k_cache, v_cache, mask):
    """q [B,1,H,D] against cache [B,T,H_kv,D] under ``mask`` (bool,
    broadcast to [B, H_kv, group, T]). H may be a q_per_kv multiple of
    H_kv (grouped-query): query heads fold into a group dim and attend
    the UN-expanded cache. f32 scores, softmax, P cast to the cache's
    dtype for the value product."""
    b, t, hkv, d = k_cache.shape
    h = q.shape[2]
    g = h // hkv
    k3 = k_cache.permute(0, 2, 1, 3).reshape(b * hkv, t, d)
    v3 = v_cache.permute(0, 2, 1, 3).reshape(b * hkv, t, d)
    s = _bmm_f32(q.reshape(b * hkv, g, d), k3.transpose(1, 2))
    s = (s / math.sqrt(d)).view(b, hkv, g, t).masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).view(b * hkv, g, t)
    return torch.bmm(p, v3).view(b, 1, h, d)


def _cached_attention(q, k_cache, v_cache, pos, window=None):
    """q [B,1,H,D] against cache [B,T,H_kv,D]; positions > pos
    masked (``pos`` an int). ``window`` applies the Mistral sliding
    band: the decode step sees keys (pos-window, pos], matching the
    training mask."""
    idx = torch.arange(k_cache.shape[1], device=q.device)
    mask = idx <= pos
    if window is not None:
        mask &= (pos - idx) < window
    return _attend_cache(q, k_cache, v_cache, mask)


# ---------------------------------------------------------------------------
# Per-model blocks
# ---------------------------------------------------------------------------


def _layers(params):
    """The stacked block leaves as one dict of views per layer."""
    names = sorted(params["blocks"])
    per = [params["blocks"][n].unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per)]


def _gpt_block(x, lp, cfg, attend):
    """One GPT block on x [B, T, E]; ``attend(q, k, v)`` on [B, T, H, D]
    writes the cache and returns the attention output."""
    B, T, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    fused = gpt_mod.use_fused_norm(cfg, x.device)
    if fused:
        h = fused_layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    else:
        h = gpt_mod._layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    q, k, v = (h @ lp["wqkv"]).split(E, dim=-1)
    att = attend(
        q.reshape(B, T, H, D), k.reshape(B, T, H, D), v.reshape(B, T, H, D)
    ).reshape(B, T, E)
    if fused:
        h, x = fused_add_layer_norm(
            att @ lp["wo"], x, lp["ln2_g"], lp["ln2_b"]
        )
    else:
        x = x + att @ lp["wo"]
        h = gpt_mod._layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    h = F.gelu(h @ lp["wi"] + lp["bi"], approximate="tanh")
    return x + h @ lp["wo2"] + lp["bo2"]


def _gpt_head(params, x):
    x = gpt_mod._layer_norm(x, params["lnf_g"], params["lnf_b"])
    return _mm_f32(x, params["wte"].t())


def _llama_qkv(h, lp, cfg, B, T):
    """q/k/v projections incl. the optional GLM-style bias, reshaped
    to [B, T, heads, D]."""
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if getattr(cfg, "qkv_bias", False):
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    D = cfg.head_dim
    return (
        q.reshape(B, T, cfg.n_head, D),
        k.reshape(B, T, cfg.n_kv_head, D),
        v.reshape(B, T, cfg.n_kv_head, D),
    )


def _llama_block(x, lp, cfg, attend):
    """One Llama block on x [B, T, E]; ``attend(q, k, v)`` on the
    un-roped projections ropes, writes the cache and returns the
    attention output [B, T, H, D]. The MLP is the training block's
    tail (``llama.mlp_tail``), its aux loss dropped."""
    B, T, E = x.shape
    fused = gpt_mod.use_fused_norm(cfg, x.device)
    if fused:
        h = fused_rms_norm(x, lp["rms1"], eps=cfg.rms_eps)
    else:
        h = llama_mod._rms_norm(x, lp["rms1"], cfg.rms_eps)
    att = attend(*_llama_qkv(h, lp, cfg, B, T)).reshape(B, T, E)
    if fused:
        h, x = fused_add_rms_norm(
            att @ lp["wo"], x, lp["rms2"], eps=cfg.rms_eps
        )
    else:
        x = x + att @ lp["wo"]
        h = llama_mod._rms_norm(x, lp["rms2"], cfg.rms_eps)
    return llama_mod.mlp_tail(x, h, lp, cfg)[0]


def _llama_head(params, x, cfg):
    """The final RMSNorm (plain, as in ``llama.backbone``) and the
    untied head, f32 logits."""
    x = llama_mod._rms_norm(x, params["rmsf"], cfg.rms_eps)
    return _mm_f32(x, params["lm_head"].t())


# ---------------------------------------------------------------------------
# Per-model single-token steps and one-shot prefills
# ---------------------------------------------------------------------------


@torch.no_grad()
def gpt_decode_step(params, cache: KVCache, token, pos: int, cfg):
    """One token through GPT with cache. token [B] int, pos an int.
    Returns (logits [B, vocab] f32, cache written at ``pos``)."""
    x = params["wte"][token][:, None, :] + params["wpe"][pos][None, None]
    x = x.to(cfg.dtype)  # [B,1,E]
    for i, lp in enumerate(_layers(params)):
        k_c, v_c = cache.k[i], cache.v[i]

        def attend(q, k, v, k_c=k_c, v_c=v_c):
            k_c[:, pos] = k[:, 0]
            v_c[:, pos] = v[:, 0]
            return _cached_attention(q, k_c, v_c, pos)

        x = _gpt_block(x, lp, cfg, attend)
    return _gpt_head(params, x)[:, 0], cache


@torch.no_grad()
def gpt_prefill(params, cache: KVCache, tokens, cfg):
    """Batched prompt pass: one forward over [B, T0] fills cache
    positions 0..T0 and returns the last position's logits — the
    time-to-first-token path (vs T0 sequential decode steps)."""
    T0 = tokens.shape[1]
    x = (params["wte"][tokens] + params["wpe"][:T0][None]).to(cfg.dtype)
    attn = gpt_mod.default_attention_for(cfg, x.device)
    for i, lp in enumerate(_layers(params)):
        k_c, v_c = cache.k[i], cache.v[i]

        def attend(q, k, v, k_c=k_c, v_c=v_c):
            k_c[:, :T0] = k
            v_c[:, :T0] = v
            return attn(q, k, v)

        x = _gpt_block(x, lp, cfg, attend)
    return _gpt_head(params, x[:, -1:])[:, 0], cache


@torch.no_grad()
def llama_prefill(params, cache: KVCache, tokens, cfg, rope=None,
                  causal=True):
    """``causal=False`` runs the prompt bidirectionally — GLM
    prefix-LM generation: the prompt is the prefix, so its k/v (at
    EVERY layer — deeper layers' k/v depend on the mask through the
    hiddens) must be contextualized with the full bidirectional mask
    before causal decode steps extend it."""
    T0 = tokens.shape[1]
    cos_t, sin_t = rope if rope is not None else llama_mod.rope_table(
        cfg, cfg.block_size, tokens.device
    )
    cos, sin = cos_t[:T0], sin_t[:T0]
    x = params["wte"][tokens].to(cfg.dtype)
    attn = functools.partial(
        gpt_mod.default_attention_for(cfg, x.device), causal=causal
    )
    for i, lp in enumerate(_layers(params)):
        k_c, v_c = cache.k[i], cache.v[i]

        def attend(q, k, v, k_c=k_c, v_c=v_c):
            q = llama_mod.apply_rope(q, cos, sin)
            k = llama_mod.apply_rope(k, cos, sin)
            k_c[:, :T0] = k
            v_c[:, :T0] = v
            if cfg.n_kv_head != cfg.n_head:
                k = k.repeat_interleave(cfg.q_per_kv, dim=2)
                v = v.repeat_interleave(cfg.q_per_kv, dim=2)
            return attn(q, k, v)

        x = _llama_block(x, lp, cfg, attend)
    return _llama_head(params, x[:, -1:], cfg)[:, 0], cache


@torch.no_grad()
def llama_decode_step(params, cache: KVCache, token, pos: int, cfg,
                      rope=None):
    cos_t, sin_t = rope if rope is not None else llama_mod.rope_table(
        cfg, cfg.block_size, token.device
    )
    cos, sin = cos_t[pos:pos + 1], sin_t[pos:pos + 1]
    window = getattr(cfg, "sliding_window", None)
    x = params["wte"][token][:, None, :].to(cfg.dtype)  # [B,1,E]
    for i, lp in enumerate(_layers(params)):
        k_c, v_c = cache.k[i], cache.v[i]

        def attend(q, k, v, k_c=k_c, v_c=v_c):
            q = llama_mod.apply_rope(q, cos, sin)
            k = llama_mod.apply_rope(k, cos, sin)
            k_c[:, pos] = k[:, 0]
            v_c[:, pos] = v[:, 0]
            # GQA inside _cached_attention (grouped product): never a
            # q_per_kv-expanded cache copy per step.
            return _cached_attention(q, k_c, v_c, pos, window=window)

        x = _llama_block(x, lp, cfg, attend)
    return _llama_head(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Serving path: ragged (per-lane-position) decode + lane-granular
# prefill over one shared multi-lane cache. This is the model half of
# the continuous-batching scheduler (serving/scheduler.py): every batch
# lane hosts a DIFFERENT sequence at a DIFFERENT position, so positions
# are vectors, cache writes are per-lane scatters, and prompt prefill
# lands chunk-by-chunk into one lane without touching the others.
# Llama-family configs only (the serving fleet's family).
# ---------------------------------------------------------------------------


# The JAX package's _apply_rope_gathered and _cached_attention_ragged
# are split here into what a step computes once (the lanes' rope rows,
# the per-lane mask) and what each layer does with them
# (llama.apply_rope with the lanes on its time axis, _attend_cache):
# eager PyTorch would otherwise repeat the gathers and the mask in
# every layer.


def _ragged_mask(pos, t: int, window=None):
    """[B, 1, 1, T] bool with PER-LANE positions ``pos`` [B]: lane b
    sees keys idx <= pos[b] (band-clamped under a sliding window)."""
    idx = torch.arange(t, device=pos.device)[None, :]
    p = pos[:, None]
    mask = idx <= p
    if window is not None:
        mask &= (p - idx) < window
    return mask[:, None, None, :]


@torch.no_grad()
def llama_decode_step_ragged(params, cache: KVCache, token, pos, cfg,
                             rope=None, active=None):
    """One continuous-batching decode step: token [B] int, pos [B] int
    (device tensors) — every lane advances at its own position. Cache
    updates are one scatter per layer (lane b's slot ``pos[b]``); rope
    rows gather per lane; attention masks per lane. Returns (logits
    [B, vocab] f32, cache).

    ``active`` [B] bool masks the CACHE WRITES: an inactive lane (no
    sequence, or one still mid-prefill) must not have its own cache
    touched — without the mask, every decode step would scatter a
    garbage key at ``pos[b]`` of lane b (the scheduler passes 0 for
    idle lanes), clobbering position 0 of a lane whose chunked
    prefill is still in flight. The mask chooses, for each lane's one
    slot, between the new value and the old one. Inactive lanes still
    COMPUTE garbage logits the scheduler never reads — one shape for
    any active set; only their writes are suppressed.
    ``active=None`` means all lanes write (the all-decoding batch)."""
    B = token.shape[0]
    x = params["wte"][token][:, None, :].to(cfg.dtype)  # [B,1,E]
    cos_t, sin_t = rope if rope is not None else llama_mod.rope_table(
        cfg, cfg.block_size, token.device
    )
    lanes = torch.arange(B, device=token.device)
    keep = None if active is None else active[:, None, None]
    # Per step, not per layer: each lane's rope row at its OWN position
    # and the lanes' attention mask.
    cos, sin = cos_t[pos].to(cfg.dtype), sin_t[pos].to(cfg.dtype)
    mask = _ragged_mask(
        pos, cache.k.shape[2], getattr(cfg, "sliding_window", None)
    )

    def rotate(x):  # [B, 1, H, D]: the lanes ride apply_rope's time axis
        x = llama_mod.apply_rope(x.transpose(0, 1), cos, sin)
        return x.transpose(0, 1)

    for i, lp in enumerate(_layers(params)):
        k_c, v_c = cache.k[i], cache.v[i]

        def attend(q, k, v, k_c=k_c, v_c=v_c):
            q, k = rotate(q), rotate(k)
            k_w, v_w = k[:, 0], v[:, 0]
            if keep is not None:
                k_w = torch.where(keep, k_w, k_c[lanes, pos])
                v_w = torch.where(keep, v_w, v_c[lanes, pos])
            k_c.index_put_((lanes, pos), k_w)
            v_c.index_put_((lanes, pos), v_w)
            return _attend_cache(q, k_c, v_c, mask)

        x = _llama_block(x, lp, cfg, attend)
    return _llama_head(params, x, cfg)[:, 0], cache


def _rect_attention_dense(q, k, v, start, window=None):
    """Rectangular causal attention for a lane prefill chunk: q
    [1,C,H,D] at absolute positions start..start+C against the lane's
    keys [1,T,H_kv,D]; key j visible to chunk query i iff j <= start +
    i (band-clamped under a window). Dense masked product with f32
    scores: the plain version of the lane prefill's K1 call."""
    b, c, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, c, hkv, g, d)
    s = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.float(), k.float()
    ) / math.sqrt(d)
    qi = start + torch.arange(c, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    s = s.masked_fill(~mask, -1e30)
    att = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", att, v)
    return o.reshape(b, c, hq, d)


def _rect_attention(q, k, v, start, cfg, window=None):
    """The lane prefill's attention: K1 (``flash_attention_rect`` with
    ``q_offset`` = start) where ``gpt.use_flash_attention`` picks the
    kernels, else :func:`_rect_attention_dense`. Grouped-query without
    expanding the cache: q heads i*g+j use kv head i, so group j's
    strided head slice attends the raw cache."""
    if not gpt_mod.use_flash_attention(cfg, q.device):
        return _rect_attention_dense(q, k, v, start, window=window)
    g = q.shape[2] // k.shape[2]
    outs = [
        flash_attention_rect(
            q[:, :, j::g], k, v, causal=True, q_offset=start, window=window
        )
        for j in range(g)
    ]
    if g == 1:
        return outs[0]
    b, c, h, d = q.shape
    return torch.stack(outs, dim=3).reshape(b, c, h, d)


@torch.no_grad()
def llama_lane_prefill_chunk(params, cache: KVCache, tokens, lane: int,
                             start: int, cfg, rope=None):
    """Prefill ``tokens`` [1, C] of ONE sequence into lane ``lane`` of
    the shared multi-lane cache at positions [start, start+C), leaving
    every other lane untouched — the bounded prefill admission step of
    the continuous-batching scheduler.

    ``lane`` and ``start`` are ints; the scheduler pads ragged final
    chunks up to C (padded positions write garbage that the next chunk
    or decode step overwrites BEFORE any mask can expose it, and padded
    queries' outputs are discarded host-side). The chunk's queries see
    the lane's keys up to start + C, so padded queries see their own
    pad keys, as the JAX mask lets them.

    Returns (chunk logits [1, C, vocab] f32, cache) — all chunk
    positions, so the caller samples the first token from the last
    REAL position of a padded final chunk."""
    B, C = tokens.shape
    if B != 1:
        raise ValueError(
            f"lane prefill takes one sequence, got batch {B}"
        )
    cos_t, sin_t = rope if rope is not None else llama_mod.rope_table(
        cfg, cfg.block_size, tokens.device
    )
    end = start + C
    cos, sin = cos_t[start:end], sin_t[start:end]
    window = getattr(cfg, "sliding_window", None)
    x = params["wte"][tokens].to(cfg.dtype)  # [1,C,E]
    for i, lp in enumerate(_layers(params)):
        k_lane, v_lane = cache.k[i, lane:lane + 1], cache.v[i, lane:lane + 1]

        def attend(q, k, v, k_lane=k_lane, v_lane=v_lane):
            q = llama_mod.apply_rope(q, cos, sin)
            k = llama_mod.apply_rope(k, cos, sin)
            k_lane[:, start:end] = k
            v_lane[:, start:end] = v
            return _rect_attention(
                q, k_lane[:, :end], v_lane[:, :end], start, cfg,
                window=window,
            )

        x = _llama_block(x, lp, cfg, attend)
    return _llama_head(params, x, cfg), cache


def _fns_for(cfg, device: DeviceLike = None) -> tuple:
    """(prefill_fn, step_fn) with model-specific constants (rope
    tables, on ``device``) computed once."""
    if isinstance(cfg, llama_mod.LlamaConfig):
        rope = llama_mod.rope_table(cfg, cfg.block_size, device)
        return (
            functools.partial(
                llama_prefill, rope=rope,
                causal=not getattr(cfg, "prefix_lm", False),
            ),
            functools.partial(llama_decode_step, rope=rope),
        )
    if isinstance(cfg, gpt_mod.GPTConfig):
        return gpt_prefill, gpt_decode_step
    raise TypeError(f"unsupported config type {type(cfg).__name__}")


def _kv_heads(cfg) -> int:
    return getattr(cfg, "n_kv_head", cfg.n_head)


# ---------------------------------------------------------------------------
# Generation loop
# ---------------------------------------------------------------------------


@torch.no_grad()
def generate(
    params: Dict[str, Any],
    cfg,
    prompt: torch.Tensor,  # [B, T_prompt] int
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations. Greedy when
    ``temperature == 0``. Returns [B, T_prompt + max_new_tokens].

    The prompt fills the cache in ONE batched forward (prefill); each
    new token is then one cached decode step. Sampling draws from
    ``generator`` (a generator of the params' device, seed 0 by
    default); the tokens cannot equal ``jax.random``'s, greedy ones
    can."""
    device = params["wte"].device
    prefill_fn, step_fn = _fns_for(cfg, device)
    b, t_prompt = prompt.shape
    total = t_prompt + max_new_tokens
    if total > cfg.block_size:
        raise ValueError(
            f"prompt+new = {total} exceeds block_size {cfg.block_size}"
        )
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    prompt = prompt.to(device)
    cache = _cache_for(cfg, b, total, _kv_heads(cfg), device)
    logits, cache = prefill_fn(params, cache, prompt, cfg)

    def sample(logits):
        if temperature == 0.0:
            return logits.argmax(dim=-1)
        logits = logits / temperature
        if top_k is not None:
            kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
            logits = logits.masked_fill(logits < kth, -1e30)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    toks = []
    for i in range(max_new_tokens):
        tok = sample(logits)
        toks.append(tok)
        if i + 1 < max_new_tokens:  # the last token needs no step
            logits, cache = step_fn(params, cache, tok, t_prompt + i, cfg)
    out = torch.stack(toks, dim=1).to(prompt.dtype)
    return torch.cat([prompt, out], dim=1)


@torch.no_grad()
def decode_logits_sequential(params, cfg, tokens: torch.Tensor):
    """Teacher-forcing consistency helper (used by tests): run the
    cached decode step over ``tokens`` [B, T] and return the logits at
    every position [B, T, vocab] — must match the training forward."""
    device = tokens.device
    _, step_fn = _fns_for(cfg, device)
    b, t = tokens.shape
    cache = _cache_for(cfg, b, t, _kv_heads(cfg), device)
    logits = []
    for i in range(t):
        out, cache = step_fn(params, cache, tokens[:, i], i, cfg)
        logits.append(out)
    return torch.stack(logits, dim=1)


@torch.no_grad()
def llama_prefill_chunked(params, cache: KVCache, tokens, cfg,
                          chunk_size: int = 1024, rope=None):
    """Bounded-memory prefill for LONG prompts: query chunks of
    ``chunk_size`` run through all layers against the growing cache
    via the rectangular flash kernel (flash_attention_rect, q_offset
    = chunk start) — peak attention memory is O(chunk * T) with no
    [T, T] score tile, versus the one-shot prefill's full-prompt
    pass. Causal only (a bidirectional GLM prefix cannot be chunked:
    early chunks would need future prefix context — use
    ``llama_prefill(causal=False)``).

    Returns the same (last-position logits, filled cache) contract as
    :func:`llama_prefill`. On CUDA the attention is K1 (bf16, head_dim
    64 or 128); on the CPU its plain version."""
    if getattr(cfg, "prefix_lm", False):
        raise ValueError(
            "prefix-LM prompts prefill bidirectionally and cannot "
            "be chunked (early chunks would need future prefix "
            "context); use llama_prefill(causal=False)"
        )
    B, T0 = tokens.shape
    if T0 < 1:
        raise ValueError(
            "llama_prefill_chunked needs at least one prompt token "
            f"(got tokens of shape {tuple(tokens.shape)})"
        )
    g = cfg.q_per_kv
    win = getattr(cfg, "sliding_window", None)
    cos_t, sin_t = rope if rope is not None else llama_mod.rope_table(
        cfg, cfg.block_size, tokens.device
    )
    layers = _layers(params)
    x_last = None
    for start in range(0, T0, chunk_size):
        end = min(start + chunk_size, T0)
        c = end - start
        cos, sin = cos_t[start:end], sin_t[start:end]
        # Under a band, clamp visible keys to it: per-chunk key
        # traffic is O(chunk * window), not O(chunk * T).
        lo = 0 if win is None else max(0, start - win + 1)
        x = params["wte"][tokens[:, start:end]].to(cfg.dtype)
        for i, lp in enumerate(layers):
            k_c, v_c = cache.k[i], cache.v[i]

            def attend(q, k, v, k_c=k_c, v_c=v_c):
                q = llama_mod.apply_rope(q, cos, sin)
                k = llama_mod.apply_rope(k, cos, sin)
                k_c[:, start:end] = k
                v_c[:, start:end] = v
                k_vis, v_vis = k_c[:, lo:end], v_c[:, lo:end]
                # GQA without expanding the cache: g kernel calls over
                # a small q chunk instead of a q_per_kv-times K/V copy.
                outs = [
                    flash_attention_rect(
                        q[:, :, j::g], k_vis, v_vis, causal=True,
                        q_offset=start - lo, window=win,
                    )
                    for j in range(g)
                ]
                if g == 1:
                    return outs[0]
                return torch.stack(outs, dim=3).reshape(
                    B, c, cfg.n_head, cfg.head_dim
                )

            x = _llama_block(x, lp, cfg, attend)
        x_last = x[:, -1:]
    return _llama_head(params, x_last, cfg)[:, 0], cache
