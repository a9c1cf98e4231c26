"""The port's low-bit Adam against the JAX package's.

``dlrover_tpu_torch.optim.low_bit.adam_8bit``/``adam_4bit`` (on the CPU:
the plain versions of the quantization kernels) against ``jax.jit`` of
the optax transformation from ``dlrover_tpu.optim.low_bit`` (its
quantizers are the Pallas kernels in interpret mode), for 3 steps on the
same f32 gradients, on a tree with a quantized leaf of a block multiple,
a ragged quantized leaf, a leaf under ``min_quantize_size`` (f32
moments) and a bf16 leaf, with weight decay 0 and 0.1 and once with an
``update_clip`` that binds.

Tolerances. Parameters: f32 within 1e-6 of the leaf's largest value;
bf16 within one bf16 ulp of the value (both sides round the same f32
sum once; an f32 update a hair apart can land on the neighbouring bf16
value). Quantized moments: codes equal in at least 99.9% of elements
and never more than one level apart (both sides do the Adam arithmetic
in f32, where XLA may contract into FMAs; an ulp of m can cross a
rounding edge of the code); scales within 1e-6 relative. f32 moments of
the small leaf within 1e-6 of their largest value. Measured: codes
equal everywhere, scales 1.3e-7 relative, f32 parameters 7.6e-8 of
their scale, bf16 parameters equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu_torch.optim import low_bit as tlb

jlb = importlib.import_module("dlrover_tpu.optim.low_bit")

# name -> (shape, dtype): a block multiple, a ragged leaf (5000 = 4
# blocks + 904), a leaf under min_quantize_size, a bf16 leaf
LEAVES = {
    "w": ((8, 1024), "float32"),
    "r": ((5000,), "float32"),
    "b": ((100,), "float32"),
    "e": ((64, 128), "bfloat16"),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        k: (0.05 * rng.standard_normal(shape)).astype(np.float32)
        for k, (shape, _) in LEAVES.items()
    }


def _grads(seed):
    rng = np.random.default_rng(100 + seed)
    out = {}
    for k, (shape, _) in LEAVES.items():
        # gradients over several decades, as in a real tree
        g = rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))
        out[k] = (1e-3 * g).astype(np.float32)
    return out


def _jax_tree(p):
    return {k: jnp.asarray(v, JDT[LEAVES[k][1]]) for k, v in p.items()}


def _torch_tree(p):
    return {k: torch.tensor(v).to(TDT[LEAVES[k][1]]) for k, v in p.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _codes(q, bits, signed):
    """Codes as levels: int8 as they are; packed nibbles unpacked (low
    half of the block, then high half) and unsigned to their level."""
    q = np.asarray(q)
    if bits == 8:
        return q.astype(np.int32)
    p = q.astype(np.int32)
    vals = np.concatenate([p & 15, (p >> 4) & 15], axis=1)
    return vals - 8 if signed else vals


def _check_params(tp, jp):
    for k, (_, dt) in LEAVES.items():
        t, j = _np(tp[k]), _np(jp[k])
        assert tp[k].dtype == TDT[dt] and t.shape == j.shape, k
        err = np.abs(t - j)
        if dt == "float32":
            scale = float(np.abs(j).max())
            assert err.max() <= 1e-6 * scale, (k, err.max(), scale)
        else:  # one bf16 ulp of the value
            assert (err <= 2.0 ** -7 * np.abs(j)).all(), (k, err.max())


def _check_moments(tstate, jstate, bits):
    core = jstate[0]
    assert tstate["count"] == int(core.count)
    for name, signed in (("mu", True), ("nu", False)):
        for k in LEAVES:
            t, j = tstate[name][k], getattr(core, name)[k]
            if isinstance(j, jlb._QTensor):
                assert isinstance(t, tlb.QTensor), (name, k)
                assert t.q.dtype == getattr(torch, str(j.q.dtype))
                assert tuple(t.q.shape) == j.q.shape
                tc = _codes(t.q.numpy(), bits, signed or bits == 8)
                jc = _codes(j.q, bits, signed or bits == 8)
                diff = np.abs(tc - jc)
                assert diff.max() <= 1, (name, k, diff.max())
                assert (diff == 0).mean() >= 0.999, (name, k)
                ts, js = t.scales.numpy(), np.asarray(j.scales)
                np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
            else:
                assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
                t, j = _np(t), _np(j)
                scale = max(float(np.abs(j).max()), 1e-30)
                assert np.abs(t - j).max() <= 1e-6 * scale, (name, k)


def _run(bits, wd, clip, steps=3):
    make_j = jlb.adam_8bit if bits == 8 else jlb.adam_4bit
    make_t = tlb.adam_8bit if bits == 8 else tlb.adam_4bit
    kw = dict(weight_decay=wd, update_clip=clip)
    jopt, topt = make_j(1e-3, **kw), make_t(1e-3, **kw)
    p0 = _params()
    jp, tp = _jax_tree(p0), _torch_tree(p0)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    update = jax.jit(jopt.update)
    for step in range(steps):
        g = _grads(step)
        u, jstate = update({k: jnp.asarray(v) for k, v in g.items()},
                           jstate, jp)
        jp = optax.apply_updates(jp, u)
        tp, tstate = topt.update(
            {k: torch.tensor(v) for k, v in g.items()}, tstate, tp
        )
    return jopt, topt, jp, tp, jstate, tstate


@pytest.mark.parametrize("wd,clip", [(0.0, 2.0), (0.1, 2.0), (0.0, 0.5)])
@pytest.mark.parametrize("bits", [8, 4])
def test_three_steps_match_optax(bits, wd, clip):
    _, _, jp, tp, jstate, tstate = _run(bits, wd, clip)
    _check_params(tp, jp)
    _check_moments(tstate, jstate, bits)


def test_update_clip_binds():
    """At update_clip 0.5 the clipped update differs from the unclipped
    one: the preconditioned step of a fresh Adam is ~1 per coordinate."""
    _, _, _, tp_clip, _, _ = _run(8, 0.0, 0.5, steps=1)
    _, _, _, tp_free, _, _ = _run(8, 0.0, None, steps=1)
    p0 = _torch_tree(_params())
    moved_clip = (tp_clip["w"] - p0["w"]).abs().max().item()
    moved_free = (tp_free["w"] - p0["w"]).abs().max().item()
    assert moved_clip == pytest.approx(0.5e-3, rel=1e-3)
    assert moved_free > 0.9e-3


@pytest.mark.parametrize("bits", [8, 4])
def test_state_from_jax_continues_the_jax_run(bits):
    jopt, topt, jp, _, jstate, _ = _run(bits, 0.1, 2.0, steps=2)
    tstate = tlb.state_from_jax(
        jax.tree.map(np.asarray, jstate), device="cpu"
    )
    _check_moments(tstate, jstate, bits)
    tp = _torch_tree(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    g = _grads(2)
    u, jstate = jax.jit(jopt.update)(
        {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp
    )
    jp = optax.apply_updates(jp, u)
    tp, tstate = topt.update(
        {k: torch.tensor(v) for k, v in g.items()}, tstate, tp
    )
    _check_params(tp, jp)
    _check_moments(tstate, jstate, bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_optimizer_state_bytes_match_jax(bits):
    _, _, _, _, jstate, tstate = _run(bits, 0.0, 2.0, steps=1)
    got = tlb.optimizer_state_bytes(tstate)
    assert got == jlb.optimizer_state_bytes(jstate)
    actual, f32_equiv = got
    assert actual < (0.27 if bits == 8 else 0.16) * f32_equiv


def test_init_quantizes_only_large_leaves():
    state = tlb.adam_4bit().init(_torch_tree(_params()))
    for name in ("mu", "nu"):
        assert isinstance(state[name]["b"], torch.Tensor)
        for k in ("w", "r", "e"):
            qt = state[name][k]
            assert isinstance(qt, tlb.QTensor)
            assert qt.q.dtype == torch.uint8 and qt.q.shape[1] == 512
            assert not qt.q.numel() or qt.scales.abs().max().item() == 0.0
    assert state["mu"]["r"].q.shape == (5, 512)


def test_bad_options_raise():
    with pytest.raises(ValueError, match="bits"):
        tlb.adam_8bit(bits=2)
    with pytest.raises(ValueError, match="quant"):
        tlb.adam_8bit(quant="fast")
