"""A/B of the nanoGPT example's optimizers on one card, GPT-2 124M.

    python -m dlrover_tpu_torch.tools.optimizer_ab   # adamw adam8bit adam4bit
    python -m dlrover_tpu_torch.tools.optimizer_ab --steps 10 adamw adam8bit

Two measurements, each in A B ... B A order so that a drift of the card
or the host over the run shows as a difference between the two rounds:

* the optimizer layer: one ``update`` of the whole GPT-2 tree (bf16
  parameters, f32 gradients as ``ElasticTrainer`` hands them over), its
  wall time to a synchronize (median of ``--reps``), and the device time
  of its kernels by family from ``torch.profiler`` (``quant`` is the
  quantization kernels, ``other`` PyTorch's elementwise kernels);
* end to end: the example's ``run()`` at the smoke test's settings
  (micro-batch 8, global batch 16, seed 0) for ``--steps`` steps: tokens
  per second over the steps after the first, the median step time, the
  peak device memory.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from dlrover_tpu_torch.common.tree import tree_map
from dlrover_tpu_torch.trainer.profile import kernel_family

GPT2_ARGS = [
    "--model", "gpt2", "--global-batch-size", "16",
    "--micro-batch-size", "8", "--seed", "0",
]


def _optimizer(name: str):
    from dlrover_tpu_torch.examples.nanogpt import train

    return train.make_run_optimizer(train.parse_args(["--optimizer", name]))


def update_times(name: str, params, grads, reps: int) -> str:
    opt = _optimizer(name)
    state = opt.init(params)
    # every call updates from the initial state: a step's work does not
    # depend on its count
    for _ in range(2):
        opt.update(grads, state, params)
    torch.cuda.synchronize()
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        opt.update(grads, state, params)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        opt.update(grads, state, params)
        torch.cuda.synchronize()
    families, launches = {}, 0
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CUDA:
            fam = kernel_family(a.key)
            families[fam] = (
                families.get(fam, 0.0) + a.self_device_time_total / 1e3
            )
            launches += a.count
    return (
        f"update wall {statistics.median(wall):.3f} ms (median of {reps}); "
        f"device {sum(families.values()):.3f} ms in {launches} kernels: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(families.items()))
    )


def end_to_end(name: str, steps: int) -> str:
    from dlrover_tpu_torch.examples.nanogpt import train

    out = train.run(train.parse_args(
        GPT2_ARGS + ["--steps", str(steps), "--optimizer", name]
    ))
    del out["opt_state"]
    return (
        f"tokens/s {out['tokens_per_s']:.1f} (steps 2..{steps}), median "
        f"step {1e3 * statistics.median(out['step_s'][1:]):.3f} ms, peak "
        f"{out['peak_mem_gib']:.3f} GiB, losses {out['losses']}"
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("optimizers", nargs="*",
                   default=["adamw", "adam8bit", "adam4bit"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("optimizer_ab: no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.models import gpt

    gen = torch.Generator().manual_seed(0)
    params = gpt.init_params(gpt.GPTConfig.gpt2(), generator=gen)
    ggen = torch.Generator(device="cuda").manual_seed(1)
    grads = tree_map(
        lambda p: 1e-3 * torch.randn(p.shape, generator=ggen, device=p.device),
        params,
    )
    order = args.optimizers + args.optimizers[::-1]
    for rnd, name in enumerate(order):
        print(f"{rnd} {name}: {update_times(name, params, grads, args.reps)}",
              flush=True)
    del params, grads
    torch.cuda.empty_cache()
    for rnd, name in enumerate(order):
        print(f"{rnd} {name}: {end_to_end(name, args.steps)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
