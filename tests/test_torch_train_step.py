"""The port's training step, AdamW and ElasticTrainer against the JAX
package's, on a smoke-size GPT (L2 H2 E128 T128 V1024, dense attention)
with parameters from the JAX init.

* AdamW against ``optax.adamw(3e-4, weight_decay=0.1)`` on the same
  gradients, for bf16 and f32 parameters and gradients;
* three steps of ``make_train_step`` with the port's AdamW against JAX
  ``make_train_step`` on a one-device mesh;
* three steps of ``ElasticTrainer`` with accumulation 2 against the JAX
  ``ElasticTrainer``;
* the samplers' order for the same seed and epoch.

Tolerances (largest difference over max(1, largest value)). AdamW on
the same gradients: bf16 parameters bitwise, f32 1e-8, moments 1e-6 of
their largest value. Train steps in f32: losses 1e-6; parameters 1e-5,
3% of one step of the learning rate, because Adam divides by sqrt(nu) +
eps and so magnifies the f32 rounding of gradients near eps (the q/k
projections at init; measured 2.7e-6); first moments 1e-6, second 1e-9
(squares of gradients of ~1e-3). Train steps in bf16 compare losses
(1e-3) and gradient norms (1e-3 relative) only: bf16 rounds the
gradients at different places on the two sides, and Adam turns the sign
of a gradient that is pure rounding noise into a full step either way.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.trainer import elastic_trainer as tet
from dlrover_tpu_torch.trainer.async_metrics import (
    HOST_SYNCS,
    AsyncScalarReporter,
)
from dlrover_tpu_torch.trainer.step import make_eval_step, make_train_step

jgpt = importlib.import_module("dlrover_tpu.models.gpt")
jstep = importlib.import_module("dlrover_tpu.trainer.step")
jet = importlib.import_module("dlrover_tpu.trainer.elastic_trainer")

DIMS = dict(vocab_size=1024, block_size=128, n_layer=2, n_head=2, n_embd=128)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(dtype):
    jcfg = jgpt.GPTConfig(
        dtype=JDT[dtype], remat=False, use_flash_attention=False, **DIMS
    )
    tcfg = tgpt.GPTConfig(
        dtype=TDT[dtype], remat=False, use_flash_attention=False, **DIMS
    )
    jp = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _batches(n, batch, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, DIMS["block_size"])
    return [
        (rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32),
         rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32))
        for _ in range(n)
    ]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    scale = max(1.0, float(np.abs(ref).max()))
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _close_params(tparams, jparams):
    for i, (t, j) in enumerate(
        zip(tree_leaves(tparams), jax.tree.leaves(jparams))
    ):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), f"param {i}"
        _close(t, j, 1e-5, f"param {i}")


def _close_moments(tstate, jstate):
    adam = jstate[0]  # optax.adamw = chain(scale_by_adam, decay, lr)
    assert tstate["count"] == int(adam.count)
    for name, tol in (("mu", 1e-6), ("nu", 1e-9)):
        for i, (t, j) in enumerate(zip(
            tree_leaves(tstate[name]), jax.tree.leaves(getattr(adam, name))
        )):
            assert str(t.dtype).split(".")[-1] == str(j.dtype), (name, i)
            _close(t, j, tol, f"{name} {i}")


def _one_device_mesh():
    return build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])


@pytest.mark.parametrize("pdt,gdt", [
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
    ("float32", "float32"),
])
def test_adamw_matches_optax_on_the_same_gradients(pdt, gdt):
    rng = np.random.default_rng(0)
    p0 = (0.02 * rng.standard_normal((64, 96))).astype(np.float32)
    jp = {"w": jnp.asarray(p0, JDT[pdt]), "b": jnp.zeros((96,), JDT[pdt])}
    tp = {"w": torch.tensor(p0).to(TDT[pdt]),
          "b": torch.zeros(96, dtype=TDT[pdt])}
    jopt, topt = optax.adamw(3e-4, weight_decay=0.1), AdamW(
        3e-4, weight_decay=0.1)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    update = jax.jit(jopt.update)
    for _ in range(3):
        g = {"w": 1e-3 * rng.standard_normal((64, 96)),
             "b": 1e-3 * rng.standard_normal(96)}
        u, jstate = update(
            {k: jnp.asarray(v, JDT[gdt]) for k, v in g.items()}, jstate, jp
        )
        jp = optax.apply_updates(jp, u)
        tp, tstate = topt.update(
            {k: torch.tensor(v).to(TDT[gdt]) for k, v in g.items()},
            tstate, tp,
        )
    for k in ("w", "b"):
        assert tp[k].dtype == TDT[pdt]
        if pdt == "bfloat16":
            np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]))
        else:
            _close(tp[k], jp[k], 1e-8, k)
        for name in ("mu", "nu"):
            t, j = tstate[name][k], getattr(jstate[0], name)[k]
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            scale = float(np.abs(_np(j)).max())
            _close(_np(t) / scale, _np(j) / scale, 1e-6, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_train_step_three_steps_match_optax(dtype):
    jcfg, tcfg, jp, tp = _setup(dtype)
    jopt = optax.adamw(3e-4, weight_decay=0.1)
    jfn = jstep.make_train_step(
        _one_device_mesh(),
        lambda p, a, b: jgpt.loss_fn_fused(p, a, b, jcfg),
        jopt, donate=False,
    )
    topt = AdamW(3e-4, weight_decay=0.1)
    tfn = make_train_step(
        lambda p, a, b: tgpt.loss_fn_fused(p, a, b, tcfg), topt
    )
    jstate, tstate = jopt.init(jp), topt.init(tp)
    loss_tol = 1e-6 if dtype == "float32" else 1e-3
    for tok, tgt in _batches(3, 2):
        jp, jstate, jm = jfn(jp, jstate, tok, tgt)
        tp, tstate, tm = tfn(
            tp, tstate, torch.tensor(tok).long(), torch.tensor(tgt).long()
        )
        _close(tm["loss"], jm["loss"], loss_tol, "loss")
        _close(
            tm["grad_norm"] / float(jm["grad_norm"]), 1.0, loss_tol,
            "grad_norm",
        )
    if dtype == "bfloat16":
        return
    _close_params(tp, jp)
    _close_moments(tstate, jstate)
    ev = make_eval_step(lambda p, a, b: tgpt.loss_fn(p, a, b, tcfg))
    tok, tgt = _batches(1, 2, seed=9)[0]
    _close(
        ev(tp, torch.tensor(tok).long(), torch.tensor(tgt).long()),
        jgpt.loss_fn(jp, tok, tgt, jcfg), loss_tol, "eval loss",
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elastic_trainer_accum2_three_steps_match_jax(dtype):
    jcfg, tcfg, jp, tp = _setup(dtype)
    jopt = optax.adamw(3e-4, weight_decay=0.1)
    jtr = jet.ElasticTrainer(
        _one_device_mesh(),
        lambda p, a, b: jgpt.loss_fn_fused(p, a, b, jcfg),
        jopt, global_batch_size=4, micro_batch_size=2,
        donate_state=False,
    )
    reports = []
    ttr = tet.ElasticTrainer(
        lambda p, a, b: tgpt.loss_fn_fused(p, a, b, tcfg),
        AdamW(3e-4, weight_decay=0.1), global_batch_size=4,
        micro_batch_size=2, device="cpu", report_fn=reports.append,
    )
    assert ttr.accum_steps == jtr.accum_steps == 2
    assert ttr.samples_per_step == jtr.samples_per_step == 4
    jstate, tstate = jopt.init(jp), ttr.optimizer.init(tp)
    loss_tol = 1e-6 if dtype == "float32" else 1e-3
    for tok, tgt in _batches(3, 4, seed=1):
        jp, jstate, jl = jtr.train_step(jp, jstate, tok, tgt)
        tp, tstate, tl = ttr.train_step(tp, tstate, tok, tgt)
        _close(tl, jl, loss_tol, "loss")
    ttr.flush_metrics()
    assert [r.step for r in reports] == [1, 2, 3]
    assert ttr.state_dict() == jtr.state_dict() == {"step_num": 3}
    if dtype == "float32":
        _close_params(tp, jp)
        _close_moments(tstate, jstate)


def test_elastic_trainer_checks_staged_shape():
    tr = tet.ElasticTrainer(
        lambda p, a, b: (p["w"] * a).sum(), AdamW(1e-3),
        global_batch_size=4, micro_batch_size=2, device="cpu",
    )
    with pytest.raises(ValueError, match="staged"):
        tr.train_step({"w": torch.ones(3)}, None, torch.ones(4, 3),
                      torch.ones(4, 3))


@pytest.mark.parametrize("shards,rank,drop_last", [
    (1, 0, False), (3, 1, False), (4, 3, True),
])
@pytest.mark.parametrize("epoch", [0, 2])
def test_sampler_order_matches_jax(shards, rank, drop_last, epoch):
    kw = dict(dataset_size=103, num_shards=shards, shard_rank=rank,
              seed=1337, drop_last=drop_last)
    js = jet.ElasticDistributedSampler(**kw)
    ts = tet.ElasticDistributedSampler(**kw)
    js.set_epoch(epoch)
    ts.set_epoch(epoch)
    assert len(js) == len(ts)
    jit, tit = iter(js), iter(ts)
    head = [next(jit) for _ in range(10)], [next(tit) for _ in range(10)]
    assert head[0] == head[1]
    assert js.state_dict() == ts.state_dict()
    # resume from the recorded position, as after a restart
    js2, ts2 = (cls(**kw) for cls in (
        jet.ElasticDistributedSampler, tet.ElasticDistributedSampler))
    js2.load_state_dict(js.state_dict())
    ts2.load_state_dict(ts.state_dict())
    assert list(js2) == list(ts2)


def test_data_loader_batches_match_jax():
    data = np.arange(200)

    class DS:
        def __len__(self):
            return 150

        def __getitem__(self, i):
            return data[i : i + 8], data[i + 1 : i + 9]

    def batches(mod):
        sampler = mod.ElasticDistributedSampler(150, seed=3)
        return list(mod.ElasticDataLoader(DS(), 16, sampler=sampler))

    jb, tb = batches(jet), batches(tet)
    assert len(jb) == len(tb) == 9
    for (ja, jb_), (ta, tb_) in zip(jb, tb):
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jb_, tb_)


def test_accumulation_steps_match_jax():
    for g in (1, 16, 100, 128):
        for m in (1, 4, 8):
            for s in (1, 2, 8):
                assert tet.gradient_accumulation_steps(g, m, s) == (
                    jet.gradient_accumulation_steps(g, m, s)
                )


def test_async_reporter_emits_in_order_exactly_once():
    got = []
    rep = AsyncScalarReporter(lambda s, v: got.append((s, v)), max_pending=2)
    before = HOST_SYNCS["metrics"]
    for step in range(5):
        rep.offer(step, torch.tensor(float(step)))
    rep.flush()
    assert got == [(s, float(s)) for s in range(5)]
    assert HOST_SYNCS["metrics"] - before == 5
