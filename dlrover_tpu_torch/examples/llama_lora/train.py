"""LoRA fine-tuning of a Llama model on the PyTorch port (counterpart of
``examples/llama_lora/train.py``).

    python -m dlrover_tpu_torch.examples.llama_lora.train --preset 7b --batch 2 --steps 4
    python -m dlrover_tpu_torch.examples.llama_lora.train --preset tiny --device cpu --steps 3

The same recipe as the JAX example: the model of ``models/llama.py``
sized by ``--preset`` (``tiny`` for CPU smoke runs, ``7b`` for
Llama-2-7B at full width and depth) with random frozen base weights
from a seed; the LoRA tree of ``models/lora.py`` on the attention and
MLP projections; ``AdamW(lr)`` (optax's default weight decay 1e-4) over
the LoRA tree only; the fused cross-entropy in 4 chunks; a fixed batch
of random tokens from ``np.random.default_rng(0)`` with targets shifted
by one. It runs on the card unless ``--device cpu`` is given.
``--attention dense`` and ``--norm plain`` take the plain attention and
RMSNorm instead of the kernels, for reference runs. The JAX example's
mesh (data and fsdp axes) arrives with the parallelism slice (ROADMAP
queue 1, item 10): this runs one process on one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.models import gpt, llama, lora
from dlrover_tpu_torch.ops import flash_attention, layer_norm
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.trainer.async_metrics import materialize
from dlrover_tpu_torch.trainer.profile import profiler, write_profile
from dlrover_tpu_torch.trainer.step import make_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="tiny", choices=["tiny", "7b"])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="default cuda; cpu only when asked for")
    p.add_argument("--attention", default="auto", choices=["auto", "dense"],
                   help="auto: flash kernels on CUDA from 512 context up; "
                   "dense: the plain masked softmax")
    p.add_argument("--norm", default="auto", choices=["auto", "plain"],
                   help="auto: fused norm kernels on CUDA; plain: the "
                   "plain RMSNorm")
    p.add_argument("--profile", default="",
                   help="trace the last step with torch.profiler and "
                   "write its device time by kernel to this file")
    return p.parse_args(argv)


def model_config(args) -> llama.LlamaConfig:
    cfg = (
        llama.LlamaConfig.tiny() if args.preset == "tiny"
        else llama.LlamaConfig.llama2_7b()
    )
    if args.attention == "dense":
        cfg = dataclasses.replace(cfg, use_flash_attention=False)
    if args.norm == "plain":
        cfg = dataclasses.replace(cfg, use_fused_norm=False)
    return cfg


def _fingerprints(params):
    """Per leaf: its version counter (bumped by any in-place write) and
    the sum of its raw bits, to show the frozen base is untouched."""
    out = []
    for p in tree_leaves(params):
        bits = p.view(torch.int16 if p.element_size() == 2 else torch.int32)
        out.append((p._version, int(bits.sum(dtype=torch.int64))))
    return out


def run(args) -> dict:
    """LoRA-train for ``args.steps`` steps. Returns the per-step losses
    and seconds, tokens per second over the steps after the first
    (which pays for cuBLAS and allocator warm-up), the peak device
    memory, the kernels' launch counters as they stand at the end (the
    caller zeroes them), whether the base weights came through
    unchanged and whether every LoRA ``b`` moved off zero."""
    cfg = model_config(args)
    dev = resolve_device(args.device)
    # Seeds 0 and 1, as the JAX example's PRNGKey(0) and PRNGKey(1).
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev
    )
    lcfg = lora.LoraConfig(rank=args.rank)
    lp = lora.init_lora(
        params, lcfg, torch.Generator(device=dev).manual_seed(1)
    )
    n_base, n_lora = gpt.num_params(params), lora.num_trainable(lp)
    print(
        f"llama {args.preset}: base params {n_base:,} (frozen), trainable "
        f"(LoRA r{args.rank}) {n_lora:,}; {cfg.n_layer} layers, T "
        f"{cfg.block_size}, batch {args.batch}, {cfg.dtype}, remat "
        f"{cfg.remat}, device {dev}",
        flush=True,
    )
    before = _fingerprints(params)
    optimizer = AdamW(args.lr)
    opt_state = optimizer.init(lp)

    def loss(lp_, tokens, targets):
        eff = lora.apply(params, lp_, lcfg)
        return llama.loss_fn_fused(eff, tokens, targets, cfg, num_chunks=4)

    step = make_train_step(loss, optimizer)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (args.batch, cfg.block_size))
    targets = np.roll(tokens, -1, axis=1)
    tokens = torch.as_tensor(tokens).to(dev)
    targets = torch.as_tensor(targets).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    tokens_per_step = args.batch * cfg.block_size
    for i in range(1, args.steps + 1):
        prof = profiler(args.profile if i == args.steps else "")
        with prof:
            t0 = time.perf_counter()
            lp, opt_state, metrics = step(lp, opt_state, tokens, targets)
            # Reading the loss is the step's one host sync.
            losses.append(materialize(metrics["loss"], reason="log"))
            dt = time.perf_counter() - t0
        if args.profile and i == args.steps:
            write_profile(prof, dt, args.profile)
        step_s.append(dt)
        print(
            f"step {i}: loss {losses[-1]:.4f} {dt:.3f} s "
            f"({tokens_per_step / dt:.0f} tok/s)",
            flush=True,
        )
    timed = step_s[1:] or step_s
    tokens_per_s = tokens_per_step * len(timed) / sum(timed)
    peak = (
        torch.cuda.max_memory_allocated(dev) / 2**30
        if dev.type == "cuda" else float("nan")
    )
    base_unchanged = _fingerprints(params) == before
    lora_b_nonzero = all(
        bool(ab["b"].abs().sum() > 0)
        for ab in lora._flatten_named(lp, leaf_keys=("a", "b")).values()
    )
    print(f"done: {args.steps} steps, final loss {losses[-1]:.4f}, "
          f"{tokens_per_s:.0f} tok/s", flush=True)
    return {
        "losses": losses,
        "step_s": step_s,
        "tokens_per_s": tokens_per_s,
        "peak_mem_gib": peak,
        "launches": {
            "flash_fwd": flash_attention.FWD_LAUNCHES,
            "flash_bwd": flash_attention.BWD_LAUNCHES,
            "norm_fwd": layer_norm.FWD_LAUNCHES,
            "norm_bwd": layer_norm.BWD_LAUNCHES,
        },
        "base_unchanged": base_unchanged,
        "lora_b_nonzero": lora_b_nonzero,
        "n_params": n_base,
        "n_trainable": n_lora,
        "flops_per_token": llama.flops_per_token(cfg),
        "finite": all(math.isfinite(x) for x in losses),
    }


def main(argv=None) -> int:
    out = run(parse_args(argv))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
