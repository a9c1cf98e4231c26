"""The port's BERT family against the JAX package's, on the CPU.

* ``mlm_loss_fn`` and every gradient leaf on one corruption (made by the
  port's ``mask_tokens`` from a ``torch.Generator`` and handed to both
  packages), from the JAX init of ``bert.tiny()``, with the plain
  LayerNorm and with the fused norm (the JAX Pallas kernels in
  interpret mode against the port's kernels' plain versions);
* ``classifier_logits``/``classifier_loss_fn`` and every gradient leaf
  from JAX's ``init_classifier_params``;
* ``mask_tokens``: the shares (15% selected, of those 80% [MASK], 10%
  random, 10% kept), unselected positions untouched, one corruption
  per generator seed and another for another seed;
* the encoder is bidirectional; presets and the axes trees.

Tolerances, on the largest difference over max(1, the largest value):
f32 1e-5 (the same f32 arithmetic in another order).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.models import bert as tbert
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.trainer.step import value_and_grad

jbert = importlib.import_module("dlrover_tpu.models.bert")
jgpt = importlib.import_module("dlrover_tpu.models.gpt")

F32_TOL = 1e-5
MASK_ID = 3


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


def _tokens(seed, cfg, b=4):
    rng = np.random.default_rng(seed)
    return rng.integers(8, cfg.vocab_size, (b, cfg.block_size)).astype(
        np.int32
    )


def _grads_match(jfn, tfn, jp, tp, what):
    jl, jg = jax.value_and_grad(jfn)(jp)
    tl, tg = value_and_grad(tfn)(tp)
    _close(tl, jl, F32_TOL, f"{what} loss")
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        _close(t, j, F32_TOL, f"{what} grad leaf {i}")
    return float(tl)


@pytest.mark.parametrize("fused", [False, True])
def test_mlm_loss_and_gradients_match_jax(fused):
    jcfg = jbert.tiny(use_fused_norm=fused)
    tcfg = tbert.tiny(use_fused_norm=fused)
    jp = jbert.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok = torch.tensor(_tokens(1, tcfg)).long()
    corrupted, labels, w = tbert.mask_tokens(
        torch.Generator().manual_seed(2), tok, tcfg.vocab_size, MASK_ID
    )
    assert float(w.sum()) > 0
    jc, jlab, jw = (np.asarray(x) for x in (corrupted, labels, w))
    _close(tgpt.forward(tp, corrupted, tcfg),
           jgpt.forward(jp, jc.astype(np.int32), jcfg), F32_TOL, "logits")
    loss = _grads_match(
        lambda p: jbert.mlm_loss_fn(p, jc.astype(np.int32),
                                    jlab.astype(np.int32), jw, jcfg),
        lambda p: tbert.mlm_loss_fn(p, corrupted, labels, w, tcfg),
        jp, tp, "mlm",
    )
    assert abs(loss - np.log(tcfg.vocab_size)) < 0.1  # at init


def test_classifier_loss_and_gradients_match_jax():
    jcfg, tcfg = jbert.tiny(), tbert.tiny()
    jp = jbert.init_classifier_params(jax.random.PRNGKey(3), jcfg, 3)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok = _tokens(4, tcfg)
    labels = np.array([0, 2, 1, 2], np.int32)
    _close(tbert.classifier_logits(tp, torch.tensor(tok).long(), tcfg),
           jbert.classifier_logits(jp, tok, jcfg), F32_TOL, "cls logits")
    _grads_match(
        lambda p: jbert.classifier_loss_fn(p, tok, labels, jcfg),
        lambda p: tbert.classifier_loss_fn(
            p, torch.tensor(tok).long(), torch.tensor(labels).long(), tcfg
        ),
        jp, tp, "classifier",
    )
    own = tbert.init_classifier_params(tcfg, 3, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == (
        jax.tree.structure(convert.params_to_numpy(own))
    )
    for j, t in zip(jax.tree.leaves(jp), tree_leaves(own)):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
    assert jbert.classifier_logical_axes(jcfg, 3) == (
        tbert.classifier_logical_axes(tcfg, 3)
    )


def test_mask_tokens_shares_and_determinism():
    cfg = tbert.tiny()
    tok = torch.tensor(_tokens(5, cfg, b=64)).long()
    tok = torch.cat([tok] * 4, dim=1)  # [64, 256]

    def corrupt(seed):
        return tbert.mask_tokens(
            torch.Generator().manual_seed(seed), tok, cfg.vocab_size,
            MASK_ID,
        )

    corrupted, labels, w = corrupt(6)
    assert torch.equal(labels, tok) and w.dtype == torch.float32
    sel = w > 0
    assert 0.14 < float(sel.float().mean()) < 0.16
    masked, orig = corrupted[sel], tok[sel]
    frac_mask = float((masked == MASK_ID).float().mean())
    frac_kept = float((masked == orig).float().mean())
    assert 0.77 < frac_mask < 0.83
    assert 0.08 < frac_kept < 0.125  # 10%, and random tokens that hit
    assert torch.equal(corrupted[~sel], tok[~sel])
    again = corrupt(6)
    assert all(torch.equal(a, b) for a, b in zip(again, (corrupted, labels,
                                                           w)))
    other = corrupt(7)
    assert not torch.equal(other[2], w)


def test_encoder_is_bidirectional_and_presets_match():
    cfg = tbert.tiny()
    tp = tbert.init_params(cfg, device="cpu")
    tok = torch.tensor(_tokens(8, cfg, b=1)).long()
    changed = tok.clone()
    changed[0, -1] = 4
    h0 = tgpt.backbone(tp, tok, cfg)
    h1 = tgpt.backbone(tp, changed, cfg)
    assert (h0[0, 0] - h1[0, 0]).abs().max() > 1e-6
    causal = dataclasses.replace(cfg, causal=True)
    assert torch.equal(tgpt.backbone(tp, tok, causal)[0, 0],
                       tgpt.backbone(tp, changed, causal)[0, 0])
    for name in ("bert_base", "bert_large", "tiny"):
        j, t = getattr(jbert, name)(), getattr(tbert, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), (name, f)
    assert jbert.param_logical_axes(jbert.tiny()) == (
        tbert.param_logical_axes(cfg)
    )
