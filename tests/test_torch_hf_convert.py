"""The port's HF checkpoint bridge against the JAX package's, on the CPU.

No checkpoint is in the repository, so every state dict is synthetic:
tiny HF Llama, Mixtral and Mistral models built by ``transformers``
from a seed (skipped where ``transformers`` is not installed, as
``tests/test_hf_convert.py`` is), and a ChatGLM2-layout state dict made
with numpy. For each, the port's converter gives the JAX converter's
tree: the same keys, shapes and dtypes, and the same values bitwise
(both transpose and stack the same f32 numbers). The port's configs
equal the JAX converter's (the Mixtral no-drop capacity
``n_experts / top_k``, ChatGLM's ``rope_ratio``, Mistral's window), the
port's logits equal HF's on the tiny Llama and Mixtral (atol 2e-4 and
5e-4, rtol 2e-3 and 5e-3, as the JAX package's test holds its own), the
ChatGLM rotary permutation equals JAX's, and a tensor neither converter
maps raises in both.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import glm as tglm
from dlrover_tpu_torch.models import hf_convert as thf
from dlrover_tpu_torch.models import llama as tllama

jhf = importlib.import_module("dlrover_tpu.models.hf_convert")
jglm = importlib.import_module("dlrover_tpu.models.glm")


@pytest.fixture(scope="module")
def transformers():
    return pytest.importorskip("transformers")


def _same_tree(got, want):
    """The port's tree (tensors) equals the JAX converter's (numpy)
    bitwise, leaf for leaf."""
    got = convert.params_to_numpy(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, j), t in zip(
        jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)
    ):
        assert t.shape == j.shape and t.dtype == j.dtype, path
        np.testing.assert_array_equal(t, j, err_msg=str(path))


def _same_config(got, want):
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def _llama_model(transformers, seed=0, **kw):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager", **kw,
    )
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


def _logits_match(model, params, cfg, atol, rtol):
    cfg = dataclasses.replace(
        cfg, dtype=torch.float32, remat=False, use_flash_attention=False
    )
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    with torch.no_grad():
        want = model(torch.from_numpy(tok)).logits.float().numpy()
        got = tllama.forward(params, torch.from_numpy(tok), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_llama_tree_config_and_logits(transformers):
    model = _llama_model(transformers)
    cfg = thf.llama_config_from_hf(model.config)
    _same_config(cfg, jhf.llama_config_from_hf(model.config))
    sd = model.state_dict()
    params = thf.llama_params_from_hf(sd, cfg, device="cpu")
    _same_tree(params, jhf.llama_params_from_hf(sd, cfg))
    # the tree never aliases the state dict
    src = sd["model.embed_tokens.weight"]
    assert params["wte"].data_ptr() != src.data_ptr()
    _logits_match(model, params, cfg, 2e-4, 2e-3)
    bf16 = thf.llama_params_from_hf(sd, cfg, torch.bfloat16, device="cpu")
    assert bf16["blocks"]["wq"].dtype == torch.bfloat16
    assert bf16["blocks"]["rms1"].dtype == torch.float32


def test_mixtral_tree_config_and_logits(transformers):
    hf_cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
        router_aux_loss_coef=0.0,
    )
    torch.manual_seed(1)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    cfg = thf.llama_config_from_hf(hf_cfg)
    _same_config(cfg, jhf.llama_config_from_hf(hf_cfg))
    assert cfg.n_experts == 4 and cfg.moe_capacity_factor == 2.0
    sd = model.state_dict()
    params = thf.llama_params_from_hf(sd, cfg, device="cpu")
    _same_tree(params, jhf.llama_params_from_hf(sd, cfg))
    moe = params["blocks"]["moe"]
    assert moe["wi"].shape == (2, 4, 64, 96)
    assert moe["router"].dtype == torch.float32
    # the no-drop capacity the converter sets: HF Mixtral drops nothing
    _logits_match(model, params, cfg, 5e-4, 5e-3)


def test_tied_embeddings_and_mistral_window(transformers):
    model = _llama_model(transformers)
    cfg = thf.llama_config_from_hf(model.config)
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    params = thf.llama_params_from_hf(sd, cfg, device="cpu")
    assert torch.equal(params["lm_head"], params["wte"])
    assert params["lm_head"].data_ptr() != params["wte"].data_ptr()
    _same_tree(params, jhf.llama_params_from_hf(sd, cfg))
    mistral = transformers.MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, sliding_window=8,
    )
    got = thf.llama_config_from_hf(mistral)
    assert got.sliding_window == 8
    _same_config(got, jhf.llama_config_from_hf(mistral))
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(64)
    with pytest.raises(ValueError, match="does not map"):
        thf.llama_params_from_hf(sd, cfg, device="cpu")
    with pytest.raises(TypeError, match="state_dict"):
        thf.llama_params_from_hf(model, cfg, device="cpu")


def _glm_state_dict(cfg, seed=1):
    rng = np.random.default_rng(seed)
    E, D, I = cfg.n_embd, cfg.head_dim, cfg.intermediate
    kv = cfg.n_kv_head * D
    sd = {
        "transformer.embedding.word_embeddings.weight":
            rng.standard_normal((cfg.vocab_size, E)) * 0.02,
        "transformer.encoder.final_layernorm.weight":
            1.0 + 0.1 * rng.standard_normal(E),
        "transformer.output_layer.weight":
            rng.standard_normal((cfg.vocab_size, E)) * 0.02,
        "transformer.rotary_pos_emb.inv_freq": np.ones(D // 4),
    }
    for i in range(cfg.n_layer):
        p = f"transformer.encoder.layers.{i}"
        sd[f"{p}.self_attention.query_key_value.weight"] = (
            rng.standard_normal((E + 2 * kv, E)) * 0.02
        )
        sd[f"{p}.self_attention.query_key_value.bias"] = (
            rng.standard_normal(E + 2 * kv) * 0.02
        )
        sd[f"{p}.self_attention.dense.weight"] = (
            rng.standard_normal((E, E)) * 0.02
        )
        sd[f"{p}.mlp.dense_h_to_4h.weight"] = (
            rng.standard_normal((2 * I, E)) * 0.02
        )
        sd[f"{p}.mlp.dense_4h_to_h.weight"] = (
            rng.standard_normal((E, I)) * 0.02
        )
        sd[f"{p}.input_layernorm.weight"] = 1.0 + 0.1 * rng.standard_normal(E)
        sd[f"{p}.post_attention_layernorm.weight"] = (
            1.0 + 0.1 * rng.standard_normal(E)
        )
    return sd


def test_glm_tree_from_numpy_and_tensors():
    """A ChatGLM2-layout state dict (numpy, then the same as torch
    tensors) converts to JAX's tree bitwise: fused qkv and biases split,
    the fused SwiGLU split, each head's rotary columns permuted; the
    result runs through the port's GLM forward; an unmapped tensor
    raises."""
    cfg = tglm.tiny()
    sd = _glm_state_dict(cfg)
    want = jhf.glm_params_from_hf(sd, cfg)
    _same_tree(thf.glm_params_from_hf(sd, cfg, device="cpu"), want)
    as_torch = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    params = thf.glm_params_from_hf(as_torch, cfg, device="cpu")
    _same_tree(params, want)
    logits = tglm.forward(params, torch.zeros((1, 8), dtype=torch.long), cfg)
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    sd["transformer.encoder.layers.0.mystery.weight"] = np.ones(3)
    with pytest.raises(ValueError, match="does not map"):
        thf.glm_params_from_hf(sd, cfg, device="cpu")


def test_glm_config_and_rotary_permutation():
    def hf_cfg(**extra):
        return SimpleNamespace(
            padded_vocab_size=64, seq_length=128, num_layers=2,
            num_attention_heads=4, multi_query_attention=True,
            multi_query_group_num=2, hidden_size=32, ffn_hidden_size=96,
            layernorm_epsilon=1e-5, add_qkv_bias=True, **extra,
        )

    for extra in ({}, {"rope_ratio": 50.0}):
        got = thf.glm_config_from_hf(hf_cfg(**extra))
        _same_config(got, jhf.glm_config_from_hf(hf_cfg(**extra)))
    assert thf.glm_config_from_hf(hf_cfg(rope_ratio=50.0)).rope_theta == (
        500000.0
    )
    assert thf.glm_config_from_hf(hf_cfg()).prefix_lm
    with pytest.raises(ValueError, match="original_rope"):
        thf.glm_config_from_hf(hf_cfg(original_rope=False))
    for rot in (2, 8, 64):
        np.testing.assert_array_equal(
            thf._interleaved_to_halves_perm(rot).numpy(),
            jhf._interleaved_to_halves_perm(rot),
        )
    # ChatGLM's interleaved rotary == the port's split halves on the
    # permuted dims (the property glm_params_from_hf relies on)
    cfg = tglm.tiny(n_embd=64, n_head=4)  # head_dim 16, 8 rotary dims
    t, d, rot = 6, 16, 8
    cos, sin = tllama.rope_table(cfg, t)
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, t, 1, d)),
                     dtype=torch.float32)
    pairs = x[..., :rot].reshape(1, t, 1, rot // 2, 2)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    inter = torch.stack([
        pairs[..., 0] * c - pairs[..., 1] * s,
        pairs[..., 1] * c + pairs[..., 0] * s,
    ], dim=-1).reshape(1, t, 1, rot)
    inter = torch.cat([inter, x[..., rot:]], dim=-1)
    ext = torch.cat([thf._interleaved_to_halves_perm(rot),
                     torch.arange(rot, d)])
    ours = tllama.apply_rope(x[..., ext], cos, sin)
    torch.testing.assert_close(ours, inter[..., ext], atol=1e-6, rtol=0)
    assert jglm.tiny().rotary_pct == cfg.rotary_pct
