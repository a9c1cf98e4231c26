"""nanoGPT pretraining on the PyTorch port (counterpart of
``examples/nanogpt/train.py``).

    python -m dlrover_tpu_torch.examples.nanogpt.train --model gpt2 --steps 10
    python -m dlrover_tpu_torch.examples.nanogpt.train --smoke --device cpu
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nproc_per_node 1 -m dlrover_tpu_torch.examples.nanogpt.train -- \
        --model gpt2 --steps 8 --checkpoint-every 3 --checkpoint-dir DIR

Builds the GPT (``models/gpt.py``), the optax-matching AdamW
(``optim/adamw.py``, lr 3e-4 and weight decay 0.1 as the JAX bench) and
the fixed-global-batch ``ElasticTrainer`` over synthetic tokens (a
Zipfian stream with bigram mixing, made from a seed, so the run needs
no download), and prints each step's loss, time and tokens per second.
It runs on the card unless ``--device cpu`` is given; ``--attention
dense`` and ``--norm plain`` take the plain attention and LayerNorm
instead of the kernels. ``--optimizer`` picks the JAX example's
optimizers by name (``accelerate/api.make_optimizer``: agd, adam8bit,
adam4bit, sgd, at ``--lr``); the low-bit ones quantize their moments
through the quantization kernels, or through the plain quantizers with
``--quant plain``.

Under the elastic launcher (``trainer/elastic_run.py``) each process
joins the agent's ``torch.distributed`` world (``trainer/torch_env.py``:
NCCL on the card, gloo with ``--device cpu``), reads its shard of every
global batch through the sampler, and averages gradients over the world.
``--checkpoint-dir`` turns on flash checkpoints
(``trainer/flash_checkpoint``): the state ``(params, (opt_state,))``
and the sampler's position are staged into shared memory every
``--checkpoint-every`` steps and after the last, persisted by the agent,
and restored before the loop, so a trainer the agent restarts resumes
at the checkpoint's step and sample. Without it, and outside the
launcher, the run is the one-process loop it always was; under it,
local rank 0 writes the agent's step-metrics file and phase marks.
``--checksums`` prints a checksum of every leaf staged and restored.
``auto_accelerate`` arrives with a later slice (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import signal
import sys
import time

import numpy as np
import torch

from dlrover_tpu_torch.accelerate.api import OPTIMIZERS, make_optimizer
from dlrover_tpu_torch.agent.monitor import TrainingMonitor
from dlrover_tpu_torch.models import gpt
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import layer_norm as ln
from dlrover_tpu_torch.ops import quantization as qz
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.optim.low_bit import LowBitAdam
from dlrover_tpu_torch.trainer import torch_env
from dlrover_tpu_torch.trainer.async_metrics import materialize
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticDataLoader,
    ElasticDistributedSampler,
    ElasticTrainer,
)
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer import AGENT_ENV
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import flatten_named
from dlrover_tpu_torch.trainer.profile import profiler, write_profile

# Drill hook: SIGKILL the trainer of global rank KILL_RANK_ENV (default
# 0) once every rank is done with step KILL_AT_STEP_ENV and its
# checkpoint, in the first incarnation only (the agent's restart count
# is 0).
KILL_AT_STEP_ENV = "DLROVER_TPU_KILL_AT_STEP"
KILL_RANK_ENV = "DLROVER_TPU_KILL_RANK"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="gpt2", choices=["gpt2", "nano"])
    p.add_argument("--smoke", action="store_true",
                   help="tiny f32 model (2 layers, T 128) and few steps")
    p.add_argument("--steps", type=int, default=0,
                   help="0 = default (50, or 8 with --smoke)")
    p.add_argument("--global-batch-size", type=int, default=16)
    p.add_argument("--micro-batch-size", type=int, default=8)
    p.add_argument("--attention", default="auto", choices=["auto", "dense"],
                   help="auto: flash kernels on CUDA from 512 context up; "
                   "dense: the plain masked softmax")
    p.add_argument("--norm", default="auto", choices=["auto", "plain"],
                   help="auto: fused LayerNorm kernels on CUDA; plain: "
                   "the plain LayerNorm")
    p.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS,
                   help="adamw: AdamW(3e-4, weight decay 0.1) as the JAX "
                   "bench; others by name at --lr")
    p.add_argument("--lr", type=float, default=3e-4,
                   help="learning rate of the optimizers other than adamw")
    p.add_argument("--quant", default="auto", choices=["auto", "plain"],
                   help="auto: quantization kernels on CUDA for adam8bit "
                   "and adam4bit; plain: the plain quantizers")
    p.add_argument("--device", default=None,
                   help="default cuda; cpu only when asked for")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", default="",
                   help="trace the last step with torch.profiler and "
                   "write its device time by kernel to this file")
    p.add_argument("--checkpoint-dir", default="",
                   help="flash checkpoints into this directory (none "
                   "when empty): restore before the loop, save after it")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N steps (0: only after "
                   "the last)")
    p.add_argument("--checksums", action="store_true",
                   help="print a checksum of every leaf staged and "
                   "restored")
    args = p.parse_args(argv)
    if args.steps <= 0:
        args.steps = 8 if args.smoke else 50
    return args


def model_config(args) -> gpt.GPTConfig:
    if args.smoke:
        cfg = gpt.GPTConfig(
            vocab_size=256, block_size=128, n_layer=2, n_head=2,
            n_embd=128, dtype=torch.float32, remat=False,
        )
    else:
        cfg = getattr(gpt.GPTConfig, args.model)()
    if args.attention == "dense":
        cfg = dataclasses.replace(cfg, use_flash_attention=False)
    if args.norm == "plain":
        cfg = dataclasses.replace(cfg, use_fused_norm=False)
    return cfg


def make_run_optimizer(args):
    """AdamW(3e-4, decay 0.1) as the JAX bench for ``adamw``, else
    ``make_optimizer``'s at ``--lr``; ``--quant plain`` gives the
    low-bit optimizers the plain quantizers."""
    if args.optimizer == "adamw":
        optimizer = AdamW(3e-4, weight_decay=0.1)  # as the JAX bench
    else:
        optimizer = make_optimizer(args.optimizer, args.lr)
    if args.quant == "plain":
        if not isinstance(optimizer, LowBitAdam):
            raise ValueError(
                f"--quant plain applies to adam8bit and adam4bit, not "
                f"{args.optimizer}"
            )
        optimizer = dataclasses.replace(optimizer, quant="plain")
    return optimizer


def synthetic_tokens(n_tokens: int, vocab: int, seed: int = 0):
    """The JAX example's token stream: Zipfian unigrams, 30% replaced
    by a function of the previous token."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=n_tokens).astype(np.int64) % vocab
    shifted = np.roll(base, 1)
    mix = rng.random(n_tokens) < 0.3
    return np.where(mix, (shifted * 7 + 3) % vocab, base).astype(np.int64)


class TokenWindows:
    """Map-style dataset of (tokens, next tokens) windows of a stream."""

    def __init__(self, data: np.ndarray, block_size: int):
        self.data, self.block_size = data, block_size

    def __len__(self):
        return len(self.data) - self.block_size - 1

    def __getitem__(self, i):
        t = self.block_size
        return self.data[i : i + t], self.data[i + 1 : i + t + 1]


def batch_checksum(tokens: np.ndarray) -> int:
    """Position-weighted sum of a host batch's token ids: equal for the
    same samples in the same order."""
    flat = np.asarray(tokens).reshape(-1).astype(np.int64)
    return int(flat @ (np.arange(1, flat.size + 1, dtype=np.int64) % 65521))


def state_checksums(state) -> dict:
    """{leaf name: position-weighted sum of the leaf's bits}, computed
    on the leaf's device; Python scalars as they are."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for name, leaf in flatten_named(state):
        if not isinstance(leaf, torch.Tensor):
            out[name] = leaf
            continue
        bits = leaf.detach().contiguous().view(-1)
        bits = bits.view(ints[bits.element_size()]).long()
        weight = torch.arange(
            1, bits.numel() + 1, device=bits.device
        ) % 65521
        out[name] = int((bits * weight).sum())
    return out


def kernel_launches() -> dict:
    """This process's kernel launch counters (``ops/*``), by kernel."""
    return {
        "flash_fwd": fa.FWD_LAUNCHES, "flash_bwd": fa.BWD_LAUNCHES,
        "norm_fwd": ln.FWD_LAUNCHES, "norm_bwd": ln.BWD_LAUNCHES,
        "quant": qz.QUANT_LAUNCHES, "dequant": qz.DEQUANT_LAUNCHES,
    }


def _record(kind: str, **fields) -> None:
    """One machine-readable line, ``<kind> {json}``."""
    print(f"{kind} {json.dumps(fields, sort_keys=True)}", flush=True)


def run(args) -> dict:
    """Train for ``args.steps`` optimizer steps (after the step a
    checkpoint restores, if any). Returns this run's per-step losses and
    seconds, tokens per second over its steps after the first (which
    pays for cuBLAS and allocator warm-up), the accumulation factor, the
    peak device memory and the final optimizer state."""
    # Step metrics and phase marks are the agent's: only its local rank
    # 0 writes them, and a run outside the launcher writes no file.
    lead = (
        os.getenv(AGENT_ENV, "") == "1"
        and os.getenv("LOCAL_RANK", "0") == "0"
    )
    if lead:
        TrainingMonitor.mark_phase("proc_start")
    device = torch_env.setup_distributed(args.device)
    rank = (
        torch.distributed.get_rank()
        if torch.distributed.is_initialized() else 0
    )
    if lead:
        TrainingMonitor.mark_phase("dist_ready")
    cfg = model_config(args)
    gen = torch.Generator().manual_seed(args.seed)
    params = gpt.init_params(cfg, generator=gen, device=device)
    optimizer = make_run_optimizer(args)
    opt_state = optimizer.init(params)
    loss = functools.partial(gpt.loss_fn_fused, cfg=cfg)
    trainer = ElasticTrainer(
        loss, optimizer,
        global_batch_size=args.global_batch_size,
        micro_batch_size=args.micro_batch_size,
        device=device,
    )
    # At least the tokens the run reads, and 200,000 for any shorter run
    # (the sampler wraps epochs), so runs of a few steps, such as an
    # 8-step launcher run and a 4-step run, read the same stream.
    n_tokens = max(
        200_000,
        (args.steps * trainer.samples_per_step + 1) * cfg.block_size,
    )
    dataset = TokenWindows(
        synthetic_tokens(n_tokens, cfg.vocab_size, args.seed),
        cfg.block_size,
    )
    sampler = ElasticDistributedSampler(
        len(dataset), num_shards=trainer.num_shards, shard_rank=rank,
        seed=1337,
    )
    if lead:
        TrainingMonitor.mark_phase("built")
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    start = 0
    if ckpt is not None:
        restored = ckpt.load_checkpoint((params, (opt_state,)))
        if restored is not None:
            params, (opt_state,) = restored
            start = trainer.step_num = ckpt.last_restored_step
            sampler.load_state_dict(ckpt.last_restored_extra["sampler"])
            _record(
                "ckpt_restored", step=start, rank=rank,
                source=ckpt.engine.last_load_source,
                restore_s=ckpt.engine.last_load_s,
                checksums=state_checksums(restored) if args.checksums
                else None,
            )
    if lead:
        TrainingMonitor.mark_phase("restore_done")
    batches = iter(ElasticDataLoader(
        dataset, trainer.local_samples_per_step, sampler=sampler
    ))
    name = "smoke" if args.smoke else args.model
    print(
        f"model {name}: {gpt.num_params(params) / 1e6:.1f}M params, "
        f"{cfg.n_layer} layers, T {cfg.block_size}, {cfg.dtype}, "
        f"remat {cfg.remat}, optimizer {args.optimizer}, global batch "
        f"{trainer.samples_per_step} = {trainer.num_shards} shards x "
        f"micro {args.micro_batch_size} x accum {trainer.accum_steps}, "
        f"device {device}",
        flush=True,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s, stage_s = [], [], []
    tokens_per_step = trainer.samples_per_step * cfg.block_size
    kill_at = int(os.getenv(KILL_AT_STEP_ENV, "0") or 0)
    saved = -1
    for step in range(start + 1, args.steps + 1):
        tok, tgt = next(batches)
        prof = profiler(args.profile if step == args.steps else "")
        with prof:
            t0 = time.perf_counter()
            params, opt_state, loss_dev = trainer.train_step(
                params, opt_state, tok, tgt
            )
            # Reading the loss is the step's one host sync: it makes the
            # clock time the step's work, not its launches.
            losses.append(materialize(loss_dev, reason="log"))
            dt = time.perf_counter() - t0
        if args.profile and step == args.steps:
            write_profile(prof, dt, args.profile)
        step_s.append(dt)
        print(
            f"step {step}: loss {losses[-1]:.6f} {dt:.3f} s "
            f"({tokens_per_step / dt:.0f} tok/s) batch_sum "
            f"{batch_checksum(tok)} rank {rank} restart "
            f"{torch_env.restart_count()} at {time.time():.3f}",
            flush=True,
        )
        if lead:
            if step == start + 1:
                TrainingMonitor.mark_phase("first_step_done")
            TrainingMonitor.write_metrics(
                step, tokens=(step - start) * tokens_per_step,
                step_time=dt,
            )
        if ckpt is not None and (
            step == args.steps
            or (args.checkpoint_every and step % args.checkpoint_every == 0)
        ):
            if step == args.steps:
                # The agent skips nothing it is persisting, so the last
                # checkpoint waits for the one before it to land.
                ckpt.wait_latest_checkpoint()
            blocked = _save(ckpt, step, params, opt_state, sampler, rank,
                            args.checksums)
            if blocked is not None:
                stage_s.append(blocked)
                saved = step
        if step == kill_at and torch_env.restart_count() == 0:
            if torch.distributed.is_initialized():
                torch.distributed.barrier()  # rank 0 has staged `step`
            if rank == int(os.getenv(KILL_RANK_ENV, "0")):
                _record("killing", step=step, rank=rank, time=time.time())
                os.kill(os.getpid(), signal.SIGKILL)
    persist_s = float("nan")
    if ckpt is not None:
        if saved < 0 and start > 0:
            saved = start  # fully resumed: nothing new to save
        t0 = time.perf_counter()
        if not ckpt.wait_latest_checkpoint():
            raise RuntimeError(f"checkpoint step {saved} was not persisted")
        persist_s = time.perf_counter() - t0
        _record("ckpt_persisted", step=saved, rank=rank,
                wait_s=persist_s)
        ckpt.close()
    timed = step_s[1:] or step_s
    tokens_per_s = (
        tokens_per_step * len(timed) / sum(timed) if timed else float("nan")
    )
    peak = (
        torch.cuda.max_memory_allocated(device) / 2**30
        if device.type == "cuda" else float("nan")
    )
    final = losses[-1] if losses else float("nan")
    print(f"done: {args.steps} steps, final loss {final:.6f}, "
          f"{tokens_per_s:.0f} tok/s", flush=True)
    _record("launches", rank=rank, restart=torch_env.restart_count(),
            **kernel_launches())
    torch_env.teardown_distributed()
    return {
        "losses": losses,
        "step_s": step_s,
        "tokens_per_s": tokens_per_s,
        "accum_steps": trainer.accum_steps,
        "peak_mem_gib": peak,
        "finite": all(math.isfinite(x) for x in losses),
        "opt_state": opt_state,
        "stage_s": stage_s,
        "persist_wait_s": persist_s,
    }


def _save(ckpt, step, params, opt_state, sampler, rank, checksums):
    """Stage a checkpoint of ``step`` and ask the agent to persist it;
    returns the seconds the loop was blocked, or None when the agent was
    still copying the previous one and the step was skipped."""
    t0 = time.perf_counter()
    if not ckpt.save_checkpoint(
        step, (params, (opt_state,)), storage_type=StorageType.DISK,
        extra={"sampler": sampler.state_dict()},
    ):
        _record("ckpt_skipped", step=step, rank=rank)
        return None
    blocked = time.perf_counter() - t0
    if ckpt.engine.stages:
        _record(
            "ckpt_staged", step=step, rank=rank, stage_s=blocked,
            checksums=state_checksums((params, (opt_state,)))
            if checksums else None,
        )
    return blocked


def main(argv=None) -> int:
    out = run(parse_args(argv))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
