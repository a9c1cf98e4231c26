"""How far the ragged decode step's logits lie from the training
forward's, by depth and by route.

    python -m dlrover_tpu_torch.tools.decode_gap              # on the GPU
    python -m dlrover_tpu_torch.tools.decode_gap --layers 1 32

Llama-2-7B's width with random weights (seed 0, bf16) cut to each
``--layers`` depth: ``--lanes`` lanes of the serving cache are
prefilled through ``llama_lane_prefill_chunk`` to 100, 500, 900, ...
tokens, then ``--steps`` ragged decode steps run teacher-forced, and
each lane's logits are held against ``llama.forward`` on the same
tokens. For each depth it prints, per lane, the largest |gap| and the
rms gap of a row, each over the row's rms, three ways: the serving
route (bf16 products written as f32 by ``out_dtype``), the products
upcast to f32 instead, and the plain norm and attention on both sides.
The gap that grows with depth on every route is bf16 rounding of the
decode step's 8-row GEMMs against the forward's long ones, compounding
through the layers.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def gaps(params, cfg, lanes: int, steps: int, device) -> list:
    """[(max |gap|, rms gap) over rms(forward)] per lane."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models import generate, llama

    ref_cfg = dataclasses.replace(cfg, remat=False)
    rng = np.random.default_rng(30)
    lens = [100 + 400 * i for i in range(lanes)]
    seqs = [rng.integers(0, cfg.vocab_size, n + steps).tolist() for n in lens]
    # a multiple of the 512-token chunk, as the scheduler rounds it
    t = -(-(lens[-1] + steps) // 512) * 512
    cache = generate._cache_for(cfg, lanes, t, cfg.n_kv_head, device)
    rope = llama.rope_table(cfg, t, device)
    out = []
    with torch.no_grad():
        for lane, (n, seq) in enumerate(zip(lens, seqs)):
            for start in range(0, n, 512):
                c = min(512, n - start)
                buf = torch.zeros(1, 512, dtype=torch.long, device=device)
                buf[0, :c] = torch.tensor(seq[start:start + c])
                generate.llama_lane_prefill_chunk(
                    params, cache, buf, lane, start, cfg, rope=rope
                )
        got = []
        for s in range(steps):
            token = torch.tensor([q[n + s] for n, q in zip(lens, seqs)],
                                 device=device)
            pos = torch.tensor([n + s for n in lens], device=device)
            logits, _ = generate.llama_decode_step_ragged(
                params, cache, token, pos, cfg, rope=rope
            )
            got.append(logits)
        for lane, (n, seq) in enumerate(zip(lens, seqs)):
            ref = llama.forward(
                params, torch.tensor([seq], device=device), ref_cfg
            )[0, n:n + steps].float()
            mine = torch.stack([g[lane] for g in got]).float()
            rms = ref.square().mean(-1).sqrt()
            diff = mine - ref
            out.append((
                round((diff.abs().amax(-1) / rms).max().item(), 5),
                round((diff.square().mean(-1).sqrt() / rms).max().item(), 5),
            ))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("decode_gap")
    p.add_argument("--layers", type=int, nargs="+", default=[1, 4, 32])
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="default: the GPU (raises without one)")
    args = p.parse_args(argv)

    import torch

    from dlrover_tpu_torch.common.device import resolve_device
    from dlrover_tpu_torch.models import generate, llama
    from dlrover_tpu_torch.ops.cross_entropy import dot_f32

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(dev), flush=True)
    full = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(
        dataclasses.replace(full, n_layer=max(args.layers)),
        torch.Generator(device=dev).manual_seed(0), dev,
    )
    routes = (
        ("serving route", {}, {}),
        ("products upcast", {"_bmm_f32": dot_f32, "_mm_f32": dot_f32}, {}),
        ("plain norm and attention", {},
         {"use_fused_norm": False, "use_flash_attention": False}),
    )
    for n in args.layers:
        sliced = dict(params)
        sliced["blocks"] = {k: v[:n] for k, v in params["blocks"].items()}
        for name, patch, fields in routes:
            cfg = dataclasses.replace(full, n_layer=n, **fields)
            saved = {k: getattr(generate, k) for k in patch}
            try:
                for k, fn in patch.items():
                    setattr(generate, k, fn)
                res = gaps(sliced, cfg, args.lanes, args.steps, dev)
            finally:
                for k, fn in saved.items():
                    setattr(generate, k, fn)
            print(f"layers {n}, {name}: (max|gap|, rms gap) / rms(forward) "
                  f"per lane {res}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
