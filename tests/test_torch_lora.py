"""The port's LoRA transform against the JAX package's.

* ``init_lora`` targets, shapes and dtypes equal JAX's on the Llama
  tiny tree and the GPT smoke tree (the port draws its own A: the
  numbers differ by design, the statistics do not);
* ``apply``/``merge`` on the same base and the same non-zero A and B
  (numpy, from a seed) equal JAX's;
* three LoRA steps of the port's ``make_train_step`` + ``AdamW(1e-3)``
  against ``optax.adamw(1e-3)`` over the LoRA tree in f32 on the tiny
  Llama, with the base left bitwise unchanged. Both start from the
  same non-zero A and B (numpy): from the standard init (B = 0) the
  second step's A gradients are A's input times a B of ~1e-3, so small
  that the two frameworks' f32 rounding is a visible share of them, and
  Adam, which divides by sqrt(nu) + eps, turns that share into a share
  of a full step (25% of one, measured).

Tolerances, on the largest difference over max(1, the largest value):
apply/merge 1e-6 in f32 (one rank-r product), one bf16 ulp (2^-7) in
bf16. Train steps: losses and the LoRA factors after three steps 1e-5,
1% of one step of the learning rate (measured 9.5e-7 and 9.1e-7).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.trainer.step import make_train_step

jllama = importlib.import_module("dlrover_tpu.models.llama")
jgpt = importlib.import_module("dlrover_tpu.models.gpt")
jlora = importlib.import_module("dlrover_tpu.models.lora")


def _llama(seed=0):
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


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


def _shapes(tree):
    return {
        path: (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
        for path, leaf in jlora._flatten_named(tree).items()
    }


def test_init_targets_shapes_and_dtypes_match_jax():
    jcfg, _, jp, tp = _llama()
    gcfg = jgpt.GPTConfig(
        vocab_size=1024, block_size=128, n_layer=2, n_head=2, n_embd=128
    )
    gp = jgpt.init_params(jax.random.PRNGKey(0), gcfg)
    tgp = convert.params_from_jax(jax.tree.map(np.asarray, gp), device="cpu")
    for jtree, ttree in ((jp, tp), (gp, tgp)):
        lcfg = jlora.LoraConfig(rank=4)
        jl = jlora.init_lora(jtree, lcfg, jax.random.PRNGKey(1))
        tl = tlora.init_lora(
            ttree, tlora.LoraConfig(rank=4), torch.Generator().manual_seed(1)
        )
        assert _shapes(tl) == _shapes(jl)
        assert tlora.num_trainable(tl) == jlora.num_trainable(jl)
        for path, ab in tlora._flatten_named(tl, leaf_keys=("a", "b")).items():
            assert not ab["b"].any(), path
            # A ~ N(0, 1/fan_in): its std over the leaf, within 10%
            fan_in = ab["a"].shape[-2]
            std = ab["a"].float().std().item() * fan_in ** 0.5
            assert 0.9 < std < 1.1, (path, std)
    assert set(tl["blocks"]) == {"wqkv", "wo", "wi", "wo2"}
    # B = 0: the effective tree is the base
    for a, b in zip(
        tree_leaves(tlora.apply(tp, tlora.init_lora(tp, tlora.LoraConfig()),
                                tlora.LoraConfig())),
        tree_leaves(tp),
    ):
        assert torch.equal(a, b)


def _random_lora(jp, rank, seed):
    """The same non-zero LoRA tree for both sides, from numpy."""
    rng = np.random.default_rng(seed)
    shaped = jlora.init_lora(jp, jlora.LoraConfig(rank=rank),
                             jax.random.PRNGKey(0))
    jl = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05, x.dtype),
        shaped,
    )
    tl = convert.params_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    # convert.py carries the LoRA tree ({"a", "b"} leaves) both ways
    back = convert.params_to_numpy(tl)
    for j, t in zip(jax.tree.leaves(jl), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(j, np.float32), t)
    return jl, tl


def test_apply_and_merge_match_jax():
    for dtype in ("float32", "bfloat16"):
        jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jdt)
        jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"
        )
        jl, tl = _random_lora(jp, 4, seed=5)
        lcfg_j, lcfg_t = jlora.LoraConfig(rank=4), tlora.LoraConfig(rank=4)
        for jfn, tfn in ((jlora.apply, tlora.apply),
                         (jlora.merge, tlora.merge)):
            jeff, teff = jfn(jp, jl, lcfg_j), tfn(tp, tl, lcfg_t)
            jleaves, tleaves = jax.tree.leaves(jeff), tree_leaves(teff)
            assert len(jleaves) == len(tleaves)
            for j, t in zip(jleaves, tleaves):
                assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
                _close(t, j, 1e-6 if dtype == "float32" else 2.0 ** -7,
                       f"{jfn.__name__} {dtype}")


def test_three_lora_adamw_steps_match_optax():
    jcfg, tcfg, jp, tp = _llama(seed=3)
    lcfg_j, lcfg_t = jlora.LoraConfig(rank=8), tlora.LoraConfig(rank=8)
    jl, tl = _random_lora(jp, 8, seed=6)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (4, jcfg.block_size))
    tgt = np.roll(tok, -1, axis=1)
    tok, tgt = tok.astype(np.int32), tgt.astype(np.int32)

    def jloss(lp_):
        eff = jlora.apply(jp, lp_, lcfg_j)
        return jllama.loss_fn_fused(eff, tok, tgt, jcfg, num_chunks=4)

    jvg = jax.jit(jax.value_and_grad(jloss))
    opt = optax.adamw(1e-3)
    jstate = opt.init(jl)
    step = make_train_step(
        lambda lp_, a, b: tllama.loss_fn_fused(
            tlora.apply(tp, lp_, lcfg_t), a, b, tcfg, num_chunks=4
        ),
        AdamW(1e-3),
    )
    tstate = AdamW(1e-3).init(tl)
    base = [x.clone() for x in tree_leaves(tp)]
    ttok, ttgt = torch.tensor(tok).long(), torch.tensor(tgt).long()
    for i in range(3):
        jval, jg = jvg(jl)
        updates, jstate = opt.update(jg, jstate, jl)
        jl = optax.apply_updates(jl, updates)
        tl, tstate, metrics = step(tl, tstate, ttok, ttgt)
        _close(metrics["loss"], jval, 1e-5, f"loss {i}")
    flat_t = tlora._flatten_named(tl)
    for path, j in jlora._flatten_named(jl).items():
        _close(flat_t[path], j, 1e-5, f"{path} after 3 steps")
    for a, b in zip(base, tree_leaves(tp)):
        assert torch.equal(a, b)
