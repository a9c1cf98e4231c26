"""The port's AGD and optimizer choice against the JAX package's.

``dlrover_tpu_torch.optim.agd.agd`` against ``jax.jit`` of
``dlrover_tpu.optim.agd.agd``'s optax transformation for 3 steps on the
same f32 gradients (the first step takes AGD's t = 1 branch), with
amsgrad off and on, with a clip, and with weight decay; on f32 and bf16
leaves. ``make_optimizer`` builds each named optimizer, and ``sgd``
matches ``optax.sgd``.

Tolerances: f32 parameters within 1e-6 of the leaf's largest value
(the same f32 arithmetic; JAX's f32 powers and fused multiply-adds
differ from numpy's and PyTorch's by ulps); bf16 parameters within one
bf16 ulp of the value; moments within 1e-6 of their largest value.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu_torch.accelerate.api import OPTIMIZERS, make_optimizer
from dlrover_tpu_torch.optim import agd as tagd
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.optim.low_bit import LowBitAdam

jagd = importlib.import_module("dlrover_tpu.optim.agd")

LEAVES = {"w": ((32, 48), "float32"), "e": ((16, 8), "bfloat16")}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _params():
    rng = np.random.default_rng(0)
    return {
        k: (0.05 * rng.standard_normal(shape)).astype(np.float32)
        for k, (shape, _) in LEAVES.items()
    }


def _grads(step):
    rng = np.random.default_rng(10 + step)
    return {
        k: (1e-2 * rng.standard_normal(shape)).astype(np.float32)
        for k, (shape, _) in LEAVES.items()
    }


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, what):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, what
    scale = max(float(np.abs(j).max()), 1e-30)
    assert np.abs(t - j).max() <= 1e-6 * scale, (what, np.abs(t - j).max())


def _run_both(jopt, topt, steps=3):
    p0 = _params()
    jp = {k: jnp.asarray(v, JDT[LEAVES[k][1]]) for k, v in p0.items()}
    tp = {k: torch.tensor(v).to(TDT[LEAVES[k][1]]) for k, v in p0.items()}
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
    for k, (_, dt) in LEAVES.items():
        assert tp[k].dtype == TDT[dt]
        if dt == "float32":
            _close(tp[k], jp[k], k)
        else:
            err = np.abs(_np(tp[k]) - _np(jp[k]))
            assert (err <= 2.0 ** -7 * np.abs(_np(jp[k]))).all(), k
    return jstate, tstate


@pytest.mark.parametrize("amsgrad,clip,wd", [
    (False, None, 0.0), (True, None, 0.0), (False, 0.5, 0.0),
    (True, 0.5, 0.1),
])
def test_agd_three_steps_match_optax(amsgrad, clip, wd):
    kw = dict(amsgrad=amsgrad, clip=clip, weight_decay=wd)
    jstate, tstate = _run_both(
        jagd.agd(1e-2, **kw), tagd.agd(1e-2, **kw)
    )
    core = jstate[0]
    assert tstate["count"] == int(core.count) == 3
    for k in LEAVES:
        _close(tstate["exp_avg"][k], core.exp_avg[k], f"m {k}")
        _close(tstate["exp_avg_sq"][k], core.exp_avg_sq[k], f"v {k}")
        if amsgrad:
            _close(tstate["max_exp_avg_sq"][k], core.max_exp_avg_sq[k],
                   f"max v {k}")
    assert (tstate["max_exp_avg_sq"] is None) == (not amsgrad)


def test_sgd_matches_optax():
    _run_both(optax.sgd(1e-2), make_optimizer("sgd", 1e-2))


def test_make_optimizer_builds_each_name():
    kinds = {
        "adamw": AdamW, "agd": tagd.AGD, "adam8bit": LowBitAdam,
        "adam4bit": LowBitAdam,
    }
    for name in OPTIMIZERS:
        opt = make_optimizer(name, 2e-3)
        assert opt.learning_rate == 2e-3
        if name in kinds:
            assert isinstance(opt, kinds[name])
    assert make_optimizer("adamw", 1e-3).weight_decay == 1e-4  # optax's
    assert make_optimizer("adam8bit", 1e-3).bits == 8
    assert make_optimizer("adam4bit", 1e-3).bits == 4
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb", 1e-3)
