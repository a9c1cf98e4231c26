"""GLM blank-infilling training on the PyTorch port (counterpart of
``examples/glm_infill/train.py``).

    python -m dlrover_tpu_torch.examples.glm_infill.train --smoke --device cpu
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nproc_per_node 2 -m dlrover_tpu_torch.examples.glm_infill.train \
        -- --smoke --device cpu

The JAX example's recipe: ``glm.tiny(block_size=64)`` (qkv bias,
half-dim rotary, GQA), a prefix of 40 tokens, the prefix-LM objective
(``glm.prefix_lm_loss_fn``: bidirectional prefix, causal suffix, loss on
the suffix band only), Adam at ``--lr`` (``AdamW`` without weight
decay, as ``optax.adam``), and synthetic infill batches whose suffix is
the prefix's opening segment shifted by +3, so infilling is learnable
from the bidirectional context. It trains through the port's
``ElasticTrainer`` at a fixed global batch: every process draws the
same global batch from the seed and feeds its own slice, and under the
elastic launcher (``trainer/elastic_run.py``) the gradients are
averaged over the world (``trainer/torch_env.py``: NCCL on the card,
gloo with ``--device cpu``). Then it greedily generates the suffix of
fresh prefixes through ``generate.generate``, whose prefill runs the
prompt bidirectionally (``cfg.prefix_lm``), and prints the accuracy.
It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import functools
import math
import sys
import time

import numpy as np
import torch

from dlrover_tpu_torch.models import generate, glm
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.trainer import torch_env
from dlrover_tpu_torch.trainer.async_metrics import materialize
from dlrover_tpu_torch.trainer.elastic_trainer import ElasticTrainer

PREFIX = 40


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=0,
                   help="0 = default (400, or 8 with --smoke)")
    p.add_argument("--global-batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="default cuda; cpu only when asked for")
    args = p.parse_args(argv)
    if args.steps <= 0:
        args.steps = 8 if args.smoke else 400
    return args


def infill_batches(batch, t, prefix, vocab, seed=0):
    """Prefix: random tokens; suffix: the prefix's opening segment
    shifted by +3 (every suffix position copies from a constant offset,
    which a 2-layer model learns in a few hundred steps)."""
    rng = np.random.default_rng(seed)
    while True:
        pre = rng.integers(8, vocab, size=(batch, prefix))
        suf = (pre[:, : t - prefix] + 3) % vocab
        tokens = np.concatenate([pre, suf], axis=1).astype(np.int64)
        targets = np.roll(tokens, -1, axis=1)
        yield tokens, targets


def run(args) -> dict:
    """Train, then generate. Returns the per-step losses, the infill
    accuracy of the greedy suffixes and the rank."""
    device = torch_env.setup_distributed(args.device)
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = glm.tiny(block_size=64)
    params = glm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device
    )
    optimizer = AdamW(args.lr, weight_decay=0.0)  # optax.adam
    opt_state = optimizer.init(params)
    loss = functools.partial(
        glm.prefix_lm_loss_fn, cfg=cfg, prefix_len=PREFIX
    )
    # the global batch split over the world, no accumulation
    trainer = ElasticTrainer(
        loss, optimizer, global_batch_size=args.global_batch_size,
        micro_batch_size=-(-args.global_batch_size // world), device=device,
    )
    batches = infill_batches(
        trainer.samples_per_step, cfg.block_size, PREFIX, cfg.vocab_size
    )
    n = trainer.local_samples_per_step
    t0 = time.perf_counter()
    losses = []
    for step in range(1, args.steps + 1):
        tokens, targets = next(batches)  # the same global batch everywhere
        mine = slice(rank * n, (rank + 1) * n)
        params, opt_state, loss_dev = trainer.train_step(
            params, opt_state, tokens[mine], targets[mine]
        )
        losses.append(materialize(loss_dev, reason="log"))
        print(f"step {step}: loss {losses[-1]:.6f} rank {rank}", flush=True)
    print(
        f"done: {args.steps} steps in {time.perf_counter() - t0:.1f} s, "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True,
    )
    # Greedy infill of fresh prefixes: the prompt is the prefix, which
    # the prefill runs with the bidirectional mask the model learned.
    tokens, _ = next(batches)
    prompt = torch.as_tensor(tokens[:2, :PREFIX]).to(device)
    out = generate.generate(
        params, cfg, prompt, max_new_tokens=cfg.block_size - PREFIX,
        temperature=0.0,
    )
    acc = float((out[:, PREFIX:].cpu().numpy() == tokens[:2, PREFIX:]).mean())
    print(f"greedy infill accuracy on fresh prefixes: {acc:.2%} rank "
          f"{rank}", flush=True)
    torch_env.teardown_distributed()
    return {"losses": losses, "infill_accuracy": acc, "rank": rank,
            "finite": all(math.isfinite(x) for x in losses)}


def main(argv=None) -> int:
    out = run(parse_args(argv))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
