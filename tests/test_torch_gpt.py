"""The port's GPT against the JAX package's, at smoke size.

Parameters come from ``dlrover_tpu.models.gpt.init_params`` (L2 H2
E128 T128 V1024, the bench's smoke dims) and reach the port through
``models/convert.py``. Logits, ``loss_fn``, ``loss_fn_fused`` and every
gradient leaf must match, with the JAX flash kernel (interpret mode)
against the port's flash path (its plain versions on the CPU), and with
both dense attention paths.

Tolerances, on the largest difference over max(1, the largest value):
f32 1e-6 (the same f32 arithmetic in another order; measured ~6e-8).
bf16 1e-2 (measured ~1.5e-3): both sides round activations to bf16
after every matmul, but at different points inside fused ops, and those
roundings compound through the layers.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.trainer.step import value_and_grad

jgpt = importlib.import_module("dlrover_tpu.models.gpt")

DIMS = dict(vocab_size=1024, block_size=128, n_layer=2, n_head=2, n_embd=128)
B = 2
TOL = {"float32": 1e-6, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, DIMS["vocab_size"], (B, DIMS["block_size"]))
    tgt = rng.integers(0, DIMS["vocab_size"], (B, DIMS["block_size"]))
    return tok.astype(np.int32), tgt.astype(np.int32)


def _configs(dtype, flash, remat=False):
    jcfg = jgpt.GPTConfig(
        dtype=JDT[dtype], remat=remat, use_flash_attention=flash, **DIMS
    )
    tcfg = tgpt.GPTConfig(
        dtype=TDT[dtype], remat=remat, use_flash_attention=flash, **DIMS
    )
    return jcfg, tcfg


def _jax_params(dtype):
    jcfg, _ = _configs(dtype, False)
    return jgpt.init_params(jax.random.PRNGKey(0), jcfg)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, dtype, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= TOL[dtype] * scale, f"{what}: {err} > {TOL[dtype]} x {scale}"


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_losses_match_jax(dtype, flash):
    jcfg, tcfg = _configs(dtype, flash)
    jp = _jax_params(dtype)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok, tgt = _batch()
    ttok, ttgt = torch.tensor(tok).long(), torch.tensor(tgt).long()
    _close(
        tgpt.forward(tp, ttok, tcfg), jgpt.forward(jp, tok, jcfg), dtype,
        "logits",
    )
    _close(
        tgpt.loss_fn(tp, ttok, ttgt, tcfg), jgpt.loss_fn(jp, tok, tgt, jcfg),
        dtype, "loss_fn",
    )
    _close(
        tgpt.loss_fn_fused(tp, ttok, ttgt, tcfg),
        jgpt.loss_fn_fused(jp, tok, tgt, jcfg), dtype, "loss_fn_fused",
    )


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_gradient_leaf_matches_jax(dtype, flash):
    jcfg, tcfg = _configs(dtype, flash)
    jp = _jax_params(dtype)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok, tgt = _batch(1)
    jl, jg = jax.value_and_grad(jgpt.loss_fn_fused)(jp, tok, tgt, jcfg)
    tl, tg = value_and_grad(
        lambda p, a, b: tgpt.loss_fn_fused(p, a, b, tcfg)
    )(tp, torch.tensor(tok).long(), torch.tensor(tgt).long())
    _close(tl, jl, dtype, "loss")
    jleaves = jax.tree.leaves(jg)  # sorted keys, as tree_leaves
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 14
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        assert t.dtype == TDT[dtype] or t.dtype == torch.float32
        _close(t, j, dtype, f"grad leaf {i}")


def test_fused_norm_loss_and_gradients_match_jax():
    """The fused-norm block (K3/K4 through their plain versions here)
    against the JAX block with its Pallas norms in interpret mode: the
    LayerNorm before attention, and the residual add fused into the
    second norm."""
    jcfg, tcfg = _configs("float32", False)
    jcfg = jgpt.GPTConfig(**{**jcfg.__dict__, "use_fused_norm": True})
    tcfg = tgpt.GPTConfig(**{**tcfg.__dict__, "use_fused_norm": True})
    jp = _jax_params("float32")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok, tgt = _batch(3)
    jl, jg = jax.value_and_grad(jgpt.loss_fn_fused)(jp, tok, tgt, jcfg)
    tl, tg = value_and_grad(
        lambda p, a, b: tgpt.loss_fn_fused(p, a, b, tcfg)
    )(tp, torch.tensor(tok).long(), torch.tensor(tgt).long())
    _close(tl, jl, "float32", "loss")
    for i, (j, t) in enumerate(zip(jax.tree.leaves(jg), tree_leaves(tg))):
        _close(t, j, "float32", f"grad leaf {i}")


@pytest.mark.parametrize("flash", [True, False])
def test_remat_full_equals_none(flash):
    _, tcfg = _configs("float32", flash)
    tp = convert.params_from_jax(
        jax.tree.map(np.asarray, _jax_params("float32")), device="cpu"
    )
    tok, tgt = (torch.tensor(a).long() for a in _batch(2))
    out = {}
    for remat in (True, False):
        cfg = tgpt.GPTConfig(**{**tcfg.__dict__, "remat": remat})
        out[remat] = value_and_grad(
            lambda p, a, b: tgpt.loss_fn_fused(p, a, b, cfg)
        )(tp, tok, tgt)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, b)


def test_param_tree_and_counts_match_jax():
    jcfg, tcfg = _configs("bfloat16", None)
    jp = _jax_params("bfloat16")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    back = convert.params_to_numpy(tp)
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(j, np.float32), t)
    assert tgpt.num_params(tp) == jgpt.num_params(jp)
    assert tgpt.flops_per_token(tcfg) == jgpt.flops_per_token(jcfg)
    own = tgpt.init_params(tcfg, device="cpu")
    for a, b in zip(tree_leaves(own), tree_leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_configs_and_unported_options():
    for name in ("gpt2", "nano"):
        j, t = getattr(jgpt.GPTConfig, name)(), getattr(tgpt.GPTConfig, name)()
        for f in ("vocab_size", "block_size", "n_layer", "n_head", "n_embd"):
            assert getattr(j, f) == getattr(t, f)
    # On the CPU, auto attention is the dense path even at 1024 context.
    assert tgpt.default_attention_for(tgpt.GPTConfig(), "cpu").func is (
        tgpt._default_attention
    )
    assert tgpt.default_attention_for(tgpt.GPTConfig(), "cuda").func is not (
        tgpt._default_attention
    )
    _, tcfg = _configs("float32", False)
    tp = tgpt.init_params(tcfg, device="cpu")
    tok = torch.zeros(1, 8, dtype=torch.long)
    # The fused norm kernels are on by default for bf16 on CUDA only;
    # forcing them on the CPU runs their plain versions.
    bf16 = tgpt.GPTConfig(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    assert tgpt.use_fused_norm(bf16, "cpu") is False
    assert tgpt.use_fused_norm(bf16, "cuda") is True
    assert tgpt.use_fused_norm(tcfg, "cuda") is False  # f32
    forced = tgpt.GPTConfig(**{**tcfg.__dict__, "use_fused_norm": True})
    assert tgpt.use_fused_norm(forced, "cpu") is True
    assert tgpt.forward(tp, tok, forced).shape == (1, 8, tcfg.vocab_size)
    for bad in (
        dict(remat="dots"), dict(attn_blocks=(64, 64, 64, 64)),
    ):
        cfg = tgpt.GPTConfig(**{**tcfg.__dict__, **bad})
        with pytest.raises(NotImplementedError):
            tgpt.forward(tp, tok, cfg)
