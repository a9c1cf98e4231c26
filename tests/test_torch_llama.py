"""The port's Llama against the JAX package's, at the tiny size.

Parameters come from ``dlrover_tpu.models.llama.init_params`` on
``LlamaConfig.tiny()`` (2 layers, 4 query heads over 2 kv heads, E 64,
T 64, V 256) and reach the port through ``models/convert.py``. Logits,
``loss_fn``, ``loss_fn_fused`` and every gradient leaf must match, with
the plain RMSNorm and with the fused norm (the JAX Pallas kernels in
interpret mode against the port's kernels' plain versions), with a
sliding window, and with q/k/v biases and half-width rotary embedding.

Tolerances, on the largest difference over max(1, the largest value):
f32 1e-5 (the same f32 arithmetic in another order; measured 2.6e-7).
The bf16 case is held by its loss (1e-3; measured 2.1e-5) and its
gradient norm (1e-3 relative; measured 4.0e-5), as the GPT bf16 train
steps are: the two frameworks round bf16 activations at different
points inside fused ops, so single gradient elements are no measure.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import layer_norm as tln
from dlrover_tpu_torch.trainer.step import global_norm, value_and_grad

jllama = importlib.import_module("dlrover_tpu.models.llama")

F32_TOL = 1e-5
B = 2

VARIANTS = {
    "gqa_plain_norm": dict(use_fused_norm=False),
    "gqa_fused_norm": dict(use_fused_norm=True),
    "window16": dict(use_fused_norm=False, sliding_window=16),
    "qkv_bias_rotary_half": dict(
        use_fused_norm=True, qkv_bias=True, rotary_pct=0.5
    ),
}


def _configs(dtype="float32", **kw):
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(),
        dtype={"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype],
        **kw,
    )
    tcfg = dataclasses.replace(
        tllama.LlamaConfig.tiny(),
        dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype],
        **kw,
    )
    return jcfg, tcfg


def _params(jcfg, seed=0):
    """JAX init; q/k/v biases (zero at init) made random so that they
    reach the outputs."""
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for n in ("bq", "bk", "bv"):
            leaf = jp["blocks"][n]
            jp["blocks"][n] = jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.1, leaf.dtype
            )
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, cfg.block_size))
    return tok.astype(np.int32), np.roll(tok, -1, axis=1).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_losses_match_jax(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    jp, tp = _params(jcfg)
    tok, tgt = _batch(jcfg)
    ttok, ttgt = torch.tensor(tok).long(), torch.tensor(tgt).long()
    _close(
        tllama.forward(tp, ttok, tcfg), jllama.forward(jp, tok, jcfg),
        F32_TOL, "logits",
    )
    _close(
        tllama.loss_fn(tp, ttok, ttgt, tcfg),
        jllama.loss_fn(jp, tok, tgt, jcfg), F32_TOL, "loss_fn",
    )
    _close(
        tllama.loss_fn_fused(tp, ttok, ttgt, tcfg, num_chunks=4),
        jllama.loss_fn_fused(jp, tok, tgt, jcfg, num_chunks=4),
        F32_TOL, "loss_fn_fused",
    )


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_gradient_leaf_matches_jax(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    jp, tp = _params(jcfg, seed=1)
    tok, tgt = _batch(jcfg, seed=1)
    jl, jg = jax.value_and_grad(jllama.loss_fn_fused)(jp, tok, tgt, jcfg)
    tl, tg = value_and_grad(
        lambda p, a, b: tllama.loss_fn_fused(p, a, b, tcfg)
    )(tp, torch.tensor(tok).long(), torch.tensor(tgt).long())
    _close(tl, jl, F32_TOL, "loss")
    jleaves = jax.tree.leaves(jg)  # sorted keys, as tree_leaves
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 12 + 3 * jcfg.qkv_bias
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        _close(t, j, F32_TOL, f"grad leaf {i}")


def test_fused_norm_path_runs_the_norm_wrappers(monkeypatch):
    """use_fused_norm=True goes through ops/layer_norm's functions, two
    per block (the plain RMSNorm and the add variant)."""
    calls = []
    for name in ("fused_rms_norm", "fused_add_rms_norm"):
        fn = getattr(tllama, name)
        monkeypatch.setattr(
            tllama, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k),
        )
    _, tcfg = _configs(use_fused_norm=True)
    tp = tllama.init_params(tcfg, device="cpu")
    tllama.forward(tp, torch.zeros(1, 8, dtype=torch.long), tcfg)
    assert calls == ["fused_rms_norm", "fused_add_rms_norm"] * tcfg.n_layer
    assert tln.FWD_LAUNCHES == 0  # the CPU runs the plain versions


def test_bf16_loss_and_gradient_norm_match_jax():
    jcfg, tcfg = _configs("bfloat16", use_fused_norm=True)
    jp, tp = _params(jcfg, seed=2)
    tok, tgt = _batch(jcfg, seed=2)
    jl, jg = jax.value_and_grad(jllama.loss_fn_fused)(jp, tok, tgt, jcfg)
    tl, tg = value_and_grad(
        lambda p, a, b: tllama.loss_fn_fused(p, a, b, tcfg)
    )(tp, torch.tensor(tok).long(), torch.tensor(tgt).long())
    assert abs(float(tl) - float(jl)) <= 1e-3
    jnorm = float(jnp.sqrt(sum(
        jnp.sum(jnp.square(x.astype(jnp.float32)))
        for x in jax.tree.leaves(jg)
    )))
    tnorm = float(global_norm(tg))
    assert abs(tnorm - jnorm) <= 1e-3 * jnorm


def test_remat_full_equals_none_through_tuple_blocks():
    """The Llama block returns (x, aux); full remat carries the tuple
    through torch.utils.checkpoint and changes no number."""
    _, tcfg = _configs(use_fused_norm=True)
    _, tp = _params(_configs()[0], seed=3)
    tok, tgt = (torch.tensor(a).long() for a in _batch(tcfg, seed=3))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = value_and_grad(
            lambda p, a, b: tllama.loss_fn_fused(p, a, b, cfg)
        )(tp, tok, tgt)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, b)


def test_rope_matches_jax():
    jcfg, tcfg = _configs(rotary_pct=0.5)
    jcos, jsin = jllama.rope_table(jcfg, 32)
    tcos, tsin = tllama.rope_table(tcfg, 32)
    _close(tcos, jcos, 1e-6, "cos")
    _close(tsin, jsin, 1e-6, "sin")
    x = np.random.default_rng(4).standard_normal((2, 32, 3, 16))
    x = x.astype(np.float32)
    _close(
        tllama.apply_rope(torch.tensor(x), tcos, tsin),
        jllama.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6, "apply_rope",
    )


def test_param_tree_counts_and_presets_match_jax():
    for kw in ({}, dict(qkv_bias=True)):
        jcfg, tcfg = _configs(**kw)
        jp, tp = _params(jcfg)
        # convert.py carries the Llama tree both ways bit for bit
        back = convert.params_to_numpy(tp)
        for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(j, np.float32), t)
        own = tllama.init_params(tcfg, device="cpu")
        assert jax.tree.structure(jp) == jax.tree.structure(
            convert.params_to_numpy(own)
        )
        for j, t in zip(jax.tree.leaves(jp), tree_leaves(own)):
            assert tuple(j.shape) == tuple(t.shape)
            assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
        assert tgpt.num_params(tp) == sum(
            x.size for x in jax.tree.leaves(jp)
        )
        assert jax.tree.structure(jllama.param_logical_axes(jcfg)) == (
            jax.tree.structure(tllama.param_logical_axes(tcfg))
        )
    for name in ("llama2_7b", "llama3_8b", "mistral_7b", "tiny"):
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(tllama.LlamaConfig, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), (name, f)
        assert tllama.flops_per_token(t) == jllama.flops_per_token(j)


def test_unported_options_raise():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="item 12"):
        tllama.init_params(
            dataclasses.replace(tcfg, n_experts=4), device="cpu"
        )
    tp = tllama.init_params(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tllama.forward(
            tp, torch.zeros(1, 8, dtype=torch.long),
            dataclasses.replace(tcfg, n_experts=4),
        )
    with pytest.raises(NotImplementedError):
        tllama.forward(
            tp, torch.zeros(1, 8, dtype=torch.long),
            dataclasses.replace(tcfg, attn_blocks=(64, 64, 64, 64)),
        )
    with pytest.raises(ValueError, match="requires causal"):
        tllama.forward(
            tp, torch.zeros(1, 8, dtype=torch.long),
            dataclasses.replace(tcfg, causal=False, sliding_window=4),
        )
