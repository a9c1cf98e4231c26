"""HuggingFace checkpoints -> the port's parameter trees (counterpart of
``dlrover_tpu/models/hf_convert.py``).

Maps an HF ``state_dict`` (a mapping of tensors; numpy arrays are taken
too) and an HF config object, or any object with the same attributes,
onto the trees of ``models/llama.py`` and ``models/glm.py``. The port
keeps the JAX package's tree, so the conversion is the JAX package's:

* torch ``Linear.weight`` is [out, in], transposed to [in, out];
* per-layer tensors are stacked on a leading ``layers`` dim, Mixtral's
  experts on a second ``experts`` dim;
* HF Llama's ``rotate_half`` is the split-halves rotary the port
  applies, so Llama's q/k rows stay as they are; ChatGLM's interleaved
  rotary is permuted onto it.

It works on tensors (no round trip through numpy) and returns tensors
on an explicit device (CUDA unless the caller passes ``device="cpu"``),
in ``dtype`` (f32 by default, as the JAX converter) with the norm gains
and the router in f32. ``transformers`` is not imported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.llama import LlamaConfig


def _tensor(t, device) -> torch.Tensor:
    """A state-dict entry as an f32 tensor on ``device``."""
    return torch.as_tensor(t).detach().to(device, torch.float32)


def llama_config_from_hf(hf_config) -> LlamaConfig:
    """An HF Llama, Mistral or Mixtral config -> the port's. Mixtral's
    ``num_local_experts``/``num_experts_per_tok`` switch the model into
    MoE mode with the no-drop capacity factor ``n_experts / top_k``
    (HF Mixtral drops nothing; lower it to fine-tune with GShard-style
    dropping); Mistral's ``sliding_window`` carries through."""
    n_experts = getattr(hf_config, "num_local_experts", 0)
    top_k = getattr(hf_config, "num_experts_per_tok", 2)
    return LlamaConfig(
        sliding_window=getattr(hf_config, "sliding_window", None),
        vocab_size=hf_config.vocab_size,
        block_size=hf_config.max_position_embeddings,
        n_layer=hf_config.num_hidden_layers,
        n_head=hf_config.num_attention_heads,
        n_kv_head=getattr(
            hf_config, "num_key_value_heads", hf_config.num_attention_heads
        ),
        n_embd=hf_config.hidden_size,
        intermediate=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rms_eps=hf_config.rms_norm_eps,
        n_experts=n_experts,
        moe_top_k=top_k,
        moe_capacity_factor=(
            float(n_experts) / max(top_k, 1) if n_experts else 1.25
        ),
    )


def llama_params_from_hf(
    state_dict: Mapping[str, Any],
    cfg: LlamaConfig,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """HF Llama(ForCausalLM) or Mixtral ``state_dict`` -> the port's
    tree. Takes the ``model.``-prefixed dict or a bare model's. A
    checkpoint with tied embeddings (no ``lm_head.weight``) gets a copy
    of ``wte`` as its head: two independent leaves, so the tie does not
    survive training (see the JAX converter). Tensors the converter does
    not map raise, rather than converting into another function."""
    if hasattr(state_dict, "state_dict"):
        raise TypeError("pass model.state_dict(), not the model")
    dev = resolve_device(device)
    sd = dict(state_dict)
    used = set()

    def get(name) -> torch.Tensor:
        for key in (name, f"model.{name}"):
            if key in sd:
                used.add(key)
                return _tensor(sd[key], dev)
        raise KeyError(
            f"HF state_dict is missing {name!r} (have e.g. {list(sd)[:4]})"
        )

    L = cfg.n_layer

    def stack(fmt, transpose=True, out=dtype):
        mats = [get(fmt.format(i=i)) for i in range(L)]
        return torch.stack([m.t() if transpose else m for m in mats]).to(out)

    wte = get("embed_tokens.weight")
    head = (
        _tensor(sd["lm_head.weight"], dev) if "lm_head.weight" in sd
        else wte  # tie_word_embeddings
    )
    blocks = {
        "rms1": stack("layers.{i}.input_layernorm.weight", False,
                      torch.float32),
        "wq": stack("layers.{i}.self_attn.q_proj.weight"),
        "wk": stack("layers.{i}.self_attn.k_proj.weight"),
        "wv": stack("layers.{i}.self_attn.v_proj.weight"),
        "wo": stack("layers.{i}.self_attn.o_proj.weight"),
        "rms2": stack("layers.{i}.post_attention_layernorm.weight", False,
                      torch.float32),
    }
    if cfg.n_experts > 0:
        # Mixtral's block_sparse_moe: gate -> router; expert j's w1 is
        # the SwiGLU gate, w3 the up projection, w2 the down projection.
        def stack_experts(fmt):
            return torch.stack([
                torch.stack([
                    get(fmt.format(i=i, j=j)).t()
                    for j in range(cfg.n_experts)
                ])
                for i in range(L)
            ]).to(dtype)  # [L, E, in, out]

        moe = "layers.{i}.block_sparse_moe"
        blocks["moe"] = {
            "router": stack(moe + ".gate.weight", out=torch.float32),
            "wg": stack_experts(moe + ".experts.{j}.w1.weight"),
            "wi": stack_experts(moe + ".experts.{j}.w3.weight"),
            "wo": stack_experts(moe + ".experts.{j}.w2.weight"),
        }
    else:
        blocks.update(
            w_gate=stack("layers.{i}.mlp.gate_proj.weight"),
            w_up=stack("layers.{i}.mlp.up_proj.weight"),
            w_down=stack("layers.{i}.mlp.down_proj.weight"),
        )
    params = {
        "wte": wte.to(dtype, copy=True),
        "blocks": blocks,
        "rmsf": get("norm.weight").clone(),
        "lm_head": head.to(dtype, copy=True),
    }
    used.add("lm_head.weight")
    leftover = {
        k for k in sd
        if k not in used and not k.endswith("rotary_emb.inv_freq")
    }
    if leftover:
        raise ValueError(
            "HF state_dict contains tensors this converter does not map "
            f"(unsupported architecture variant?): {sorted(leftover)[:6]}"
        )
    return params


# ---------------------------------------------------------------------------
# ChatGLM2/3 (GLM family, models/glm.py)
# ---------------------------------------------------------------------------


def _interleaved_to_halves_perm(rot: int) -> torch.Tensor:
    """Index permutation from ChatGLM's interleaved rotary layout (pairs
    (x_2j, x_2j+1) rotate together) onto the split-halves layout (x_j
    with x_j+rot/2): perm[j] is the interleaved source of position j."""
    half = rot // 2
    return torch.cat([2 * torch.arange(half), 2 * torch.arange(half) + 1])


def glm_config_from_hf(hf_config) -> LlamaConfig:
    """A ChatGLM2/3 HF config -> the port's GLM shape (Llama backbone,
    qkv bias, half-dim rotary). ``rope_ratio`` scales the rotary base
    (HF: ``base = 10000 * rope_ratio``); a non-standard
    ``original_rope=False`` layout raises rather than converting
    wrong."""
    if not getattr(hf_config, "original_rope", True):
        raise ValueError(
            "ChatGLM config has original_rope=False (non-standard rotary "
            "layout); the interleaved->split-halves rotary permutation in "
            "glm_params_from_hf assumes the standard layout and would "
            "convert this checkpoint incorrectly"
        )
    return LlamaConfig(
        vocab_size=hf_config.padded_vocab_size,
        block_size=hf_config.seq_length,
        n_layer=hf_config.num_layers,
        n_head=hf_config.num_attention_heads,
        n_kv_head=(
            hf_config.multi_query_group_num
            if getattr(hf_config, "multi_query_attention", False)
            else hf_config.num_attention_heads
        ),
        n_embd=hf_config.hidden_size,
        intermediate=hf_config.ffn_hidden_size,
        rms_eps=hf_config.layernorm_epsilon,
        qkv_bias=getattr(hf_config, "add_qkv_bias", True),
        rotary_pct=0.5,
        rope_theta=10000.0 * getattr(hf_config, "rope_ratio", 1.0),
        # prompts prefill bidirectionally, as the native presets do
        prefix_lm=True,
    )


def glm_params_from_hf(
    state_dict: Mapping[str, Any],
    cfg: LlamaConfig,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """ChatGLM2/3 ``state_dict`` -> the port's tree. On top of the Llama
    mapping: the fused ``query_key_value`` weight and bias split into
    wq/wk/wv (rows q, then k, then v); the fused SwiGLU
    ``dense_h_to_4h`` ([2I, E]: silu of the first half times the
    second) splits into w_gate/w_up; and each head's rotary slice of the
    q/k columns is permuted from ChatGLM's interleaved pairs onto the
    split halves, so both compute the same function."""
    if hasattr(state_dict, "state_dict"):
        raise TypeError("pass model.state_dict(), not the model")
    dev = resolve_device(device)
    sd = dict(state_dict)
    used = set()

    def get(name) -> torch.Tensor:
        for key in (name, f"transformer.{name}"):
            if key in sd:
                used.add(key)
                return _tensor(sd[key], dev)
        raise KeyError(f"ChatGLM state_dict is missing {name!r}")

    E, D, I = cfg.n_embd, cfg.head_dim, cfg.intermediate
    kv = cfg.n_kv_head * D
    rot = int(D * cfg.rotary_pct)
    perm = torch.cat([
        _interleaved_to_halves_perm(rot), torch.arange(rot, D)
    ]).to(dev)

    def permute_heads(w: torch.Tensor, n_heads: int) -> torch.Tensor:
        """Permute each head's rotary slice of the last (output) dim."""
        shaped = w.reshape(w.shape[:-1] + (n_heads, D))
        return shaped[..., perm].reshape(w.shape)

    layers = {n: [] for n in (
        "wq", "wk", "wv", "bq", "bk", "bv", "wo", "w_gate", "w_up",
        "w_down", "rms1", "rms2",
    )}
    for i in range(cfg.n_layer):
        pre = f"encoder.layers.{i}"
        qkv_w = get(f"{pre}.self_attention.query_key_value.weight")
        layers["wq"].append(permute_heads(qkv_w[:E].t(), cfg.n_head))
        layers["wk"].append(
            permute_heads(qkv_w[E:E + kv].t(), cfg.n_kv_head)
        )
        layers["wv"].append(qkv_w[E + kv:].t())
        if cfg.qkv_bias:
            qkv_b = get(f"{pre}.self_attention.query_key_value.bias")
            layers["bq"].append(permute_heads(qkv_b[:E], cfg.n_head))
            layers["bk"].append(
                permute_heads(qkv_b[E:E + kv], cfg.n_kv_head)
            )
            layers["bv"].append(qkv_b[E + kv:])
        layers["wo"].append(get(f"{pre}.self_attention.dense.weight").t())
        h4 = get(f"{pre}.mlp.dense_h_to_4h.weight")
        layers["w_gate"].append(h4[:I].t())
        layers["w_up"].append(h4[I:].t())
        layers["w_down"].append(get(f"{pre}.mlp.dense_4h_to_h.weight").t())
        layers["rms1"].append(get(f"{pre}.input_layernorm.weight"))
        layers["rms2"].append(get(f"{pre}.post_attention_layernorm.weight"))

    blocks = {
        name: torch.stack(mats).to(
            torch.float32 if name.startswith("rms") else dtype
        )
        for name, mats in layers.items() if mats
    }
    params = {
        "wte": get("embedding.word_embeddings.weight").to(dtype, copy=True),
        "blocks": blocks,
        "rmsf": get("encoder.final_layernorm.weight").clone(),
        "lm_head": get("output_layer.weight").to(dtype, copy=True),
    }
    leftover = {
        k for k in sd if k not in used and "rotary_pos_emb" not in k
    }
    if leftover:
        raise ValueError(
            "ChatGLM state_dict contains tensors this converter does not "
            f"map: {sorted(leftover)[:6]}"
        )
    return params
