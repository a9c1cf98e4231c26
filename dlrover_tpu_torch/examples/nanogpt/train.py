"""nanoGPT pretraining on the PyTorch port (counterpart of
``examples/nanogpt/train.py``).

    python -m dlrover_tpu_torch.examples.nanogpt.train --model gpt2 --steps 10
    python -m dlrover_tpu_torch.examples.nanogpt.train --smoke --device cpu

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
Elastic launch, flash checkpoint and ``auto_accelerate`` arrive with
later slices of the port (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import sys
import time

import numpy as np
import torch

from dlrover_tpu_torch.accelerate.api import OPTIMIZERS, make_optimizer
from dlrover_tpu_torch.models import gpt
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.optim.low_bit import LowBitAdam
from dlrover_tpu_torch.trainer.async_metrics import materialize
from dlrover_tpu_torch.trainer.elastic_trainer import (
    ElasticDataLoader,
    ElasticDistributedSampler,
    ElasticTrainer,
)
from dlrover_tpu_torch.trainer.profile import profiler, write_profile


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


def run(args) -> dict:
    """Train for ``args.steps`` optimizer steps. Returns the per-step
    losses and seconds, tokens per second over the steps after the
    first (which pays for cuBLAS and allocator warm-up), the
    accumulation factor, the peak device memory and the final optimizer
    state."""
    cfg = model_config(args)
    gen = torch.Generator().manual_seed(args.seed)
    params = gpt.init_params(cfg, generator=gen, device=args.device)
    device = params["wte"].device
    optimizer = make_run_optimizer(args)
    opt_state = optimizer.init(params)
    loss = functools.partial(gpt.loss_fn_fused, cfg=cfg)
    trainer = ElasticTrainer(
        loss, optimizer,
        global_batch_size=args.global_batch_size,
        micro_batch_size=args.micro_batch_size,
        device=device,
    )
    n_tokens = max(
        200_000, 2 * args.steps * trainer.samples_per_step * cfg.block_size
    )
    dataset = TokenWindows(
        synthetic_tokens(n_tokens, cfg.vocab_size, args.seed),
        cfg.block_size,
    )
    sampler = ElasticDistributedSampler(len(dataset), seed=1337)
    batches = iter(ElasticDataLoader(
        dataset, trainer.samples_per_step, sampler=sampler
    ))
    name = "smoke" if args.smoke else args.model
    print(
        f"model {name}: {gpt.num_params(params) / 1e6:.1f}M params, "
        f"{cfg.n_layer} layers, T {cfg.block_size}, {cfg.dtype}, "
        f"remat {cfg.remat}, optimizer {args.optimizer}, global batch "
        f"{trainer.samples_per_step} = "
        f"micro {args.micro_batch_size} x accum {trainer.accum_steps}, "
        f"device {device}",
        flush=True,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s = [], []
    tokens_per_step = trainer.samples_per_step * cfg.block_size
    for step in range(1, args.steps + 1):
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
            f"step {step}: loss {losses[-1]:.4f} {dt:.3f} s "
            f"({tokens_per_step / dt:.0f} tok/s)",
            flush=True,
        )
    timed = step_s[1:] or step_s
    tokens_per_s = tokens_per_step * len(timed) / sum(timed)
    peak = (
        torch.cuda.max_memory_allocated(device) / 2**30
        if device.type == "cuda" else float("nan")
    )
    print(f"done: {args.steps} steps, final loss {losses[-1]:.4f}, "
          f"{tokens_per_s:.0f} tok/s", flush=True)
    return {
        "losses": losses,
        "step_s": step_s,
        "tokens_per_s": tokens_per_s,
        "accum_steps": trainer.accum_steps,
        "peak_mem_gib": peak,
        "finite": all(math.isfinite(x) for x in losses),
        "opt_state": opt_state,
    }


def main(argv=None) -> int:
    out = run(parse_args(argv))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
