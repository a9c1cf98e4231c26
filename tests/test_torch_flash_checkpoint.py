"""The port's flash checkpoint against the JAX engine's, on the CPU.

* A checkpoint the JAX engine (``dlrover_tpu.trainer.flash_checkpoint``)
  writes of a smoke GPT and its optax AdamW state after one step loads
  into the port's ``(params, (adam_state,))``: every leaf bitwise equal
  to the JAX array, bf16 leaves included (their raw 16-bit words), from
  the JAX trainer's shared-memory segment and from storage; in f32 the
  port's loss on the restored parameters equals JAX's within 1e-6 of
  max(1, |loss|), the convention of ``test_torch_train_step.py``.
* The port's save -> restore roundtrip, saved through the ``Checkpointer``
  and its self-hosted saver and restored by a fresh engine (as a
  restarted trainer's), is bitwise for every leaf (bf16 parameters, f32
  moments, the step count) and its extras, from shm and from storage,
  and the JAX engine reads the port's checkpoint as the same arrays
  under the same names.
* A rank other than 0 stages nothing and restores from storage; a
  checkpoint that lacks a leaf or holds it in another shape, or a
  committed step whose shards are gone, is an error, not a fresh start.
"""

import importlib
import os
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.agent.ckpt_saver import AsyncCheckpointSaver as JaxSaver
from dlrover_tpu.trainer.flash_checkpoint.engine import (
    CheckpointEngine as JaxEngine,
)
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.trainer.elastic_trainer import ElasticTrainer
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    CheckpointEngine,
    flatten_named,
    step_dir,
    unlink_shm,
)

jgpt = importlib.import_module("dlrover_tpu.models.gpt")

DIMS = dict(vocab_size=256, block_size=64, n_layer=2, n_head=2, n_embd=64)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _isolated_job(monkeypatch):
    """A job name of its own: shm segments and sockets don't collide."""
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:8]}")
    monkeypatch.delenv("DLROVER_TPU_AGENT_PRESENT", raising=False)
    yield
    unlink_shm(0)


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    shape = (n, DIMS["block_size"])
    return (rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32),
            rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32))


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes, whatever the framework and dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view(-1).view(torch.uint8).numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32).reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return "int32" if isinstance(x, int) else str(np.asarray(x).dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, dtype):
    jcfg = jgpt.GPTConfig(dtype=JDT[dtype], remat=False,
                          use_flash_attention=False, **DIMS)
    tcfg = tgpt.GPTConfig(dtype=TDT[dtype], remat=False,
                          use_flash_attention=False, **DIMS)
    jp = jax.jit(lambda k: jgpt.init_params(k, jcfg))(jax.random.PRNGKey(0))
    jopt = optax.adamw(3e-4, weight_decay=0.1)
    tok, tgt = _batch()
    jloss = jax.jit(lambda p: jgpt.loss_fn(p, tok, tgt, jcfg))

    @jax.jit
    def step(p):
        state = jopt.init(p)
        updates, state = jopt.update(jax.grad(jloss)(p), state, p)
        return optax.apply_updates(p, updates), state

    jp, jstate = step(jp)
    ckdir = str(tmp_path / "ckpt")
    saver = JaxSaver(checkpoint_dir=ckdir, commit_timeout=20.0)
    saver.start()
    jengine = JaxEngine(ckdir, global_rank=0, world_size=1)
    try:
        assert jengine.save_to_storage(1, (jp, jstate))
        assert jengine.wait_persisted(1, timeout=30)
    finally:
        jengine.close()
        saver.close()
    want = dict(flatten_named(jax.tree.map(np.asarray, (jp, jstate))))
    tp = tgpt.init_params(tcfg, device="cpu")
    like = (tp, (AdamW(3e-4, weight_decay=0.1).init(tp),))
    for source in ("shm", "storage"):
        if source == "storage":
            unlink_shm(0)
        # a restarted trainer's engine
        engine = CheckpointEngine(ckdir, use_agent=False, global_rank=0,
                                  world_size=1)
        try:
            step, state, _ = engine.load(like)
        finally:
            engine.close()
        assert step == 1 and engine.last_load_source == source
        got = dict(flatten_named(state))
        # the JAX chain's two EmptyStates hold no leaves
        assert set(got) == set(want)
        for name, ref in want.items():
            assert _dtype_name(got[name]) == _dtype_name(ref), name
            np.testing.assert_array_equal(
                _bits(got[name]), _bits(ref), err_msg=name)
    if dtype == "float32":
        params = state[0]
        port_loss = float(tgpt.loss_fn(params, torch.as_tensor(tok),
                                       torch.as_tensor(tgt), tcfg))
        jax_loss = float(jloss(jp))
        assert abs(port_loss - jax_loss) <= 1e-6 * max(1.0, abs(jax_loss))


def _trained_state():
    """bf16 smoke parameters and their AdamW state after one step (f32
    moments: the trainer accumulates gradients in f32)."""
    cfg = tgpt.GPTConfig(dtype=torch.bfloat16, remat=False,
                         use_flash_attention=False, **DIMS)
    params = tgpt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    opt = AdamW(3e-4, weight_decay=0.1)
    trainer = ElasticTrainer(
        lambda p, a, b: tgpt.loss_fn_fused(p, a, b, cfg), opt,
        global_batch_size=4, micro_batch_size=2, device="cpu",
    )
    params, state, _ = trainer.train_step(params, opt.init(params), *_batch())
    return cfg, opt, params, state


def test_port_roundtrip_is_bitwise_and_jax_reads_it(tmp_path):
    cfg, opt, params, state = _trained_state()
    ckdir = str(tmp_path / "ckpt")
    extra = {"sampler": {"epoch": 0, "consumed": 20, "seed": 1337}}
    ckpt = Checkpointer(ckdir)
    try:
        assert ckpt.save_checkpoint(5, (params, (state,)),
                                    StorageType.DISK, extra=extra)
        assert ckpt.wait_latest_checkpoint(timeout=30)
    finally:
        ckpt.engine.close()  # the trainer is gone; its saver stays
    want = dict(flatten_named((params, (state,))))
    fresh = tgpt.init_params(cfg, device="cpu")
    like = (fresh, (opt.init(fresh),))
    for source in ("shm", "storage"):
        if source == "storage":
            unlink_shm(0)
        # a restarted trainer's engine
        engine = CheckpointEngine(ckdir, use_agent=False, global_rank=0,
                                  world_size=1)
        try:
            step, restored, got_extra = engine.load(like)
        finally:
            engine.close()
        assert step == 5 and engine.last_load_source == source
        assert got_extra == extra
        got = dict(flatten_named(restored))
        assert got.keys() == want.keys()
        for name, ref in want.items():
            assert _dtype_name(got[name]) == _dtype_name(ref), name
            np.testing.assert_array_equal(
                _bits(got[name]), _bits(ref), err_msg=name)
    ckpt.close()
    assert got["1/0/count"] == 1
    assert got["0/wte"].dtype == torch.bfloat16
    assert got["1/0/mu/wte"].dtype == torch.float32
    jengine = JaxEngine(ckdir, use_agent=False, global_rank=0, world_size=1)
    try:
        step, flat, jextra = jengine.load_flat()
    finally:
        jengine.close()
    assert step == 5 and jextra == extra and flat.keys() == want.keys()
    for name, ref in want.items():
        np.testing.assert_array_equal(_bits(flat[name]), _bits(ref),
                                      err_msg=name)


def test_only_rank_zero_stages(tmp_path):
    engine = CheckpointEngine(str(tmp_path), global_rank=1, world_size=2)
    try:
        assert not engine.stages and engine._lock is None
        assert engine.save_to_storage(3, {"w": torch.ones(4)})
        assert engine._shm._shm is None and engine._cached_step == -1
    finally:
        engine.close()


def test_restore_refuses_a_checkpoint_that_does_not_fit(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    try:
        assert ckpt.save_checkpoint(2, {"w": torch.ones(4), "n": 3})
        assert ckpt.wait_latest_checkpoint(timeout=30)
        got = ckpt.load_checkpoint({"w": torch.zeros(4), "n": 0})
        assert torch.equal(got["w"], torch.ones(4)) and got["n"] == 3
        with pytest.raises(KeyError, match="missing leaves"):
            ckpt.load_checkpoint({"w": torch.zeros(4), "v": torch.zeros(1)})
        with pytest.raises(ValueError, match="shape"):
            ckpt.load_checkpoint({"w": torch.zeros(5), "n": 0})
    finally:
        ckpt.close()


def test_restore_of_a_committed_step_reads_storage_or_raises(tmp_path):
    ckdir = str(tmp_path / "ckpt")
    like = {"w": torch.zeros(4), "n": 0}
    fresh = CheckpointEngine(ckdir, use_agent=False, global_rank=0,
                             world_size=1)
    try:
        assert fresh.load(like) is None  # nothing committed: a fresh start
    finally:
        fresh.close()
    ckpt = Checkpointer(ckdir)
    try:
        assert ckpt.save_checkpoint(2, {"w": torch.ones(4), "n": 3})
        assert ckpt.wait_latest_checkpoint(timeout=30)
        # A rank that does not stage reads storage, though shm holds it.
        other = CheckpointEngine(ckdir, use_agent=False, global_rank=1,
                                 world_size=2)
        try:
            step, got, _ = other.load(like)
        finally:
            other.close()
        assert step == 2 and other.last_load_source == "storage"
        assert torch.equal(got["w"], torch.ones(4)) and got["n"] == 3
        unlink_shm(0)
        sdir = step_dir(ckdir, 2)
        shards = [f for f in os.listdir(sdir) if f.endswith(".ckpt")]
        assert shards
        for fname in shards:
            os.remove(os.path.join(sdir, fname))
        engine = CheckpointEngine(ckdir, use_agent=False, global_rank=0,
                                  world_size=1)
        try:
            with pytest.raises(FileNotFoundError, match="step 2"):
                engine.load(like)
        finally:
            engine.close()
    finally:
        ckpt.close()
