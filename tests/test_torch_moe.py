"""The port's mixture of experts against the JAX package's, on the CPU.

* ``_gating`` from the same f32 logits: the dispatch tensor bitwise
  equal to JAX's at top-2 and top-1, with and without dropped tokens;
  the combine tensor nonzero at the same places, holding the port's own
  softmax probabilities there bitwise, and within 2 ulps of 1.0 of
  JAX's (torch's and XLA's CPU ``exp`` differ in the last bit on ~7% of
  elements, so the probabilities themselves cannot be bitwise equal).
  Ties take the lower expert index in both (``torch.argmax`` and
  ``jnp.argmax`` return the first maximum).
* ``moe_mlp``: output and aux loss, and every gradient, against JAX
  from the JAX init, and against the one-hot einsums over the port's
  own ``_gating`` tensors; gated (Mixtral) and GELU experts, drops and
  no drops.
* Llama with MoE blocks (``LlamaConfig.moe_tiny()``): logits, losses
  and every gradient leaf; LoRA over the experts' [L, E, in, out]
  leaves; presets, the parameter tree and its axes; remat.

Routing is discrete, so a logit near-tie between two experts could
flip between the frameworks once the router's product is computed by
each. The routers are widened 50x, and every ``moe_mlp`` case asserts
that its seed has a gap of at least 1e-4 between each token's ranked
logits; the Llama cases' seeds route alike in both (their logits and
losses agree to 1e-5).

Tolerances, on the largest difference over max(1, the largest value):
f32 1e-5 (the same f32 arithmetic in another order); bf16 2^-7 (one
bf16 ulp of the output: both sides take f32 products and round once).
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
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora
from dlrover_tpu_torch.models import moe as tmoe
from dlrover_tpu_torch.trainer.step import value_and_grad

jmoe = importlib.import_module("dlrover_tpu.models.moe")
jllama = importlib.import_module("dlrover_tpu.models.llama")
jlora = importlib.import_module("dlrover_tpu.models.lora")

F32_TOL = 1e-5
ULP1 = 2.0 ** -23  # one f32 ulp at 1.0


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


def _logits(seed, n, e):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, e)) * 2.0).astype(np.float32)


def _min_gap(logits, top_k):
    """Smallest gap between consecutive sorted logits over the first
    top_k + 1 ranks of every row."""
    s = -np.sort(-logits, axis=-1)[:, : top_k + 1]
    return float(np.diff(-s, axis=-1).min())


# name: (top_k, n, E, capacity)
GATING = {
    "top2_no_drop": (2, 64, 4, 64),
    "top2_drops": (2, 64, 4, 20),
    "top1_drops": (1, 48, 8, 4),
    "top2_e8_tight": (2, 96, 8, 12),
}


@pytest.mark.parametrize("case", sorted(GATING))
def test_gating_dispatch_bitwise_and_combine_to_an_ulp(case):
    top_k, n, e, cap = GATING[case]
    logits = _logits(10 + len(case), n, e)
    jd, jc, jm = jmoe._gating(jnp.asarray(logits), top_k, cap)
    td, tc, tm = tmoe._gating(torch.tensor(logits), top_k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy() > 0, np.asarray(jc) > 0)
    probs = torch.softmax(torch.tensor(logits), -1)
    nz = tc > 0
    tok, exp_ = nz.nonzero(as_tuple=True)[:2]
    assert torch.equal(tc[nz], probs[tok, exp_])  # gates are the probs
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 2 * ULP1
    for k in ("aux_loss", "z_loss", "dropped_fraction"):
        _close(tm[k], jm[k], 1e-6, k)
    if "drops" in case or "tight" in case:
        assert float(tm["dropped_fraction"]) > 0
    else:
        assert float(tm["dropped_fraction"]) == 0
    # the switch router is top-1 gating
    if top_k == 1:
        sd, sc, _ = tmoe.switch_gating(torch.tensor(logits), cap)
        assert torch.equal(sd, td) and torch.equal(sc, tc)


def test_argmax_ties_take_the_lower_expert_in_both():
    """Rows built with exact ties: experts 1, 2 and 3 tie for the first
    choice, 2 and 3 for the second; both frameworks take the lower index
    each time."""
    logits = np.tile(
        np.array([[0.5, 2.0, 2.0, 2.0]], np.float32), (6, 1)
    )
    jd, _, _ = jmoe._gating(jnp.asarray(logits), 2, 12)
    td, _, _ = tmoe._gating(torch.tensor(logits), 2, 12)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    chosen = td.any(-1)  # [n, E]
    assert chosen[:, 1].all() and chosen[:, 2].all()
    assert not chosen[:, 0].any() and not chosen[:, 3].any()
    r, _ = tmoe._route(torch.tensor(logits), 2, 12)
    assert r.expert[0].eq(1).all() and r.expert[1].eq(2).all()


def _moe_case(gated, renorm, factor, dtype=jnp.float32, seed=0):
    jcfg = jmoe.MoEConfig(
        n_embd=32, n_experts=4, expert_hidden=48, top_k=2,
        capacity_factor=factor, dtype=dtype, gated=gated,
        renorm_top_k=renorm,
    )
    tcfg = tmoe.MoEConfig(
        n_embd=32, n_experts=4, expert_hidden=48, top_k=2,
        capacity_factor=factor,
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16,
        gated=gated, renorm_top_k=renorm,
    )
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    # a wider router spreads the logits, so the seeds have no near-tie
    jp["router"] = jp["router"] * 50.0
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal((2, 16, 32))
    x = x.astype(np.float32)
    logits = x.reshape(32, 32) @ np.asarray(jp["router"])
    assert _min_gap(logits, 2) > 1e-4, "pick a seed without near-ties"
    return jcfg, tcfg, jp, tp, x


MOE = {
    "gated_renorm_drops": (True, True, 1.0),
    "gated_renorm_no_drop": (True, True, 2.0),
    "gelu_drops": (False, False, 0.75),
}


@pytest.mark.parametrize("case", sorted(MOE))
def test_moe_mlp_matches_jax_and_the_einsums(case):
    jcfg, tcfg, jp, tp, x = _moe_case(*MOE[case])
    jy, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_mlp(tp, torch.tensor(x), tcfg)
    _close(ty, jy, F32_TOL, "y")
    _close(taux, jaux, F32_TOL, "aux")
    # the JAX package's dense dispatch and combine over the port's own
    # _gating give the same output
    flat = torch.tensor(x).reshape(32, 32)
    cap = tmoe.capacity(32, tcfg)
    d, c, m = tmoe._gating(flat @ tp["router"], 2, cap)
    if tcfg.renorm_top_k:
        c = c / c.sum((1, 2), keepdim=True).clamp(min=1e-9)
    buf = torch.einsum("nec,nd->ecd", d.float(), flat)
    h = torch.einsum("ecd,edh->ech", buf, tp["wi"])
    if tcfg.gated:
        h = torch.nn.functional.silu(
            torch.einsum("ecd,edh->ech", buf, tp["wg"])
        ) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    out = torch.einsum("ech,ehd->ecd", h, tp["wo"])
    _close(ty.reshape(32, 32), torch.einsum("nec,ecd->nd", c, out),
           F32_TOL, "einsum form")
    dropped = float(m["dropped_fraction"])
    assert (dropped > 0) == ("drops" in case), dropped


@pytest.mark.parametrize("case", sorted(MOE))
def test_moe_mlp_gradients_match_jax(case):
    jcfg, tcfg, jp, tp, x = _moe_case(*MOE[case], seed=3)
    w = np.random.default_rng(5).standard_normal((2, 16, 32))
    w = w.astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_mlp(p, x, jcfg)
        return jnp.sum(y * w) + aux

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x)
    )
    tw = torch.tensor(w)

    def tloss(tree):
        y, aux = tmoe.moe_mlp(tree["p"], tree["x"], tcfg)
        return (y * tw).sum() + aux

    tl, tg = value_and_grad(tloss)({"p": tp, "x": torch.tensor(x)})
    _close(tl, jl, F32_TOL, "loss")
    for name in sorted(jg):
        _close(tg["p"][name], jg[name], F32_TOL, f"grad {name}")
    _close(tg["x"], jgx, F32_TOL, "grad x")


def test_bf16_moe_mlp_is_within_an_ulp_of_jax():
    """bf16 activations and experts, f32 router and products: both
    route the same f32 logits and round the activation and the output
    once."""
    jcfg, tcfg, jp, tp, x = _moe_case(True, True, 1.0, jnp.bfloat16)
    jy, jaux = jmoe.moe_mlp(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, taux = tmoe.moe_mlp(tp, torch.tensor(x).to(torch.bfloat16), tcfg)
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, 2.0 ** -7, "bf16 y")
    _close(taux, jaux, F32_TOL, "bf16 aux")


def _llama(seed=0, **kw):
    jcfg = dataclasses.replace(jllama.LlamaConfig.moe_tiny(), **kw)
    tcfg = dataclasses.replace(tllama.LlamaConfig.moe_tiny(), **kw)
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    # a wider router, so the seeds route without near-ties
    jp["blocks"]["moe"]["router"] = jp["blocks"]["moe"]["router"] * 50.0
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, jcfg.vocab_size, (2, jcfg.block_size))
    return jcfg, tcfg, jp, tp, tok.astype(np.int32)


@pytest.mark.parametrize("factor", [1.25, 4.0])
def test_llama_moe_logits_loss_and_gradients_match_jax(factor):
    jcfg, tcfg, jp, tp, tok = _llama(
        seed=1, moe_capacity_factor=factor, use_fused_norm=True
    )
    tgt = np.roll(tok, -1, axis=1)
    ttok, ttgt = torch.tensor(tok).long(), torch.tensor(tgt).long()
    _close(tllama.forward(tp, ttok, tcfg), jllama.forward(jp, tok, jcfg),
           F32_TOL, "logits")
    _close(tllama.loss_fn(tp, ttok, ttgt, tcfg),
           jllama.loss_fn(jp, tok, tgt, jcfg), F32_TOL, "loss_fn")
    jl, jg = jax.value_and_grad(jllama.loss_fn_fused)(jp, tok, tgt, jcfg)
    tl, tg = value_and_grad(
        lambda p, a, b: tllama.loss_fn_fused(p, a, b, tcfg)
    )(tp, ttok, ttgt)
    _close(tl, jl, F32_TOL, "loss_fn_fused")
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 13  # 9 + the 4 moe leaves
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        _close(t, j, F32_TOL, f"grad leaf {i}")
    _, aux = tllama.backbone_with_aux(tp, ttok, tcfg)
    assert float(aux) > 0


def test_lora_over_the_experts_matches_jax():
    """LoRA's default targets reach the experts' stacked [L, E, D, H]
    wi and wo (not the router, nor wg); apply and the loss's gradient
    over the LoRA tree equal JAX's from the same non-zero A and B."""
    jcfg, tcfg, jp, tp, tok = _llama(seed=2)
    lcfg_j, lcfg_t = jlora.LoraConfig(rank=4), tlora.LoraConfig(rank=4)
    jl = jlora.init_lora(jp, lcfg_j, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    jl = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.05,
                              a.dtype), jl
    )
    tl = convert.params_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    own = tlora.init_lora(tp, lcfg_t)
    moe_own = own["blocks"]["moe"]
    assert sorted(moe_own) == sorted(jl["blocks"]["moe"]) == ["wi", "wo"]
    L, E, D, H = tp["blocks"]["moe"]["wi"].shape
    assert moe_own["wi"]["a"].shape == (L, E, D, 4)
    assert moe_own["wi"]["b"].shape == (L, E, 4, H)
    assert jax.tree.structure(convert.params_to_numpy(own)) == (
        jax.tree.structure(jax.tree.map(np.asarray, jl))
    )
    for j, t in zip(
        jax.tree.leaves(jlora.apply(jp, jl, lcfg_j)),
        tree_leaves(tlora.apply(tp, tl, lcfg_t)),
    ):
        _close(t, j, 1e-6, "apply")
    tgt = np.roll(tok, -1, axis=1)

    def jloss(lp):
        return jllama.loss_fn(jlora.apply(jp, lp, lcfg_j), tok, tgt, jcfg)

    jv, jg = jax.value_and_grad(jloss)(jl)
    tv, tg = value_and_grad(
        lambda lp, a, b: tllama.loss_fn(
            tlora.apply(tp, lp, lcfg_t), a, b, tcfg
        )
    )(tl, torch.tensor(tok).long(), torch.tensor(tgt).long())
    _close(tv, jv, F32_TOL, "lora loss")
    for i, (j, t) in enumerate(zip(jax.tree.leaves(jg), tree_leaves(tg))):
        _close(t, j, F32_TOL, f"lora grad leaf {i}")


def test_moe_tree_presets_and_axes_match_jax():
    jcfg, tcfg, jp, tp, _ = _llama()
    own = tllama.init_params(tcfg, device="cpu")
    assert jax.tree.structure(jp) == jax.tree.structure(
        convert.params_to_numpy(own)
    )
    for j, t in zip(jax.tree.leaves(jp), tree_leaves(own)):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
    assert own["blocks"]["moe"]["router"].dtype == torch.float32
    assert jllama.param_logical_axes(jcfg) == tllama.param_logical_axes(
        tcfg
    )
    assert jmoe.moe_logical_axes(True) == tmoe.moe_logical_axes(True)
    for name in ("moe_8x7b", "moe_tiny"):
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(tllama.LlamaConfig, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), (name, f)
        assert tllama.flops_per_token(t) == jllama.flops_per_token(j)
        jm, tm = j._moe_cfg(), t._moe_cfg()
        for f in dataclasses.fields(tm):
            if f.name != "dtype":
                assert getattr(jm, f.name) == getattr(tm, f.name), (name, f)
    for n in (1, 7, 4096, 4097):
        assert tmoe.capacity(n, tcfg._moe_cfg()) == int(
            np.ceil(1.25 * 2 * n / 4)
        )


def test_remat_full_equals_none_with_nested_moe_leaves():
    _, tcfg, _, tp, tok = _llama(seed=5)
    tok = torch.tensor(tok).long()
    tgt = torch.roll(tok, -1, 1)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = value_and_grad(
            lambda p, a, b: tllama.loss_fn(p, a, b, cfg)
        )(tp, tok, tgt)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, b)
    split = tllama.layer_params(tp["blocks"])
    assert len(split) == tcfg.n_layer
    assert split[1]["moe"]["wi"].data_ptr() == (
        tp["blocks"]["moe"]["wi"][1].data_ptr()
    )

