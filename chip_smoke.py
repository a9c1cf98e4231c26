#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dlrover_tpu_torch``).

    python3 chip_smoke.py            # every phase, one GPU

Phases, each of which fails the run (non-zero exit, no result line):

1. ``card``: the card's name and power limit from ``nvidia-smi``; build
   every CUDA kernel from ``dlrover_tpu_torch/csrc`` with ``nvcc``
   (timed as set-up, one ``nvcc`` per source, all started together).
2. ``kernels``: each kernel against its plain PyTorch version on the
   same inputs on the card.
   Flash attention (K1, K2) at head_dim 64 and 128: the main case at
   each path's shape (GPT-2: batch 8, T 1024, 12 heads, head_dim 64;
   Llama-2-7B: batch 2, T 4096, 32 heads, head_dim 128, scale
   1/sqrt(128) passed to the kernel; causal, bf16) and the variants
   (full attention, ragged T 1000, window 256, rectangular with
   ``q_offset`` 768 and with ``q_offset`` 700, which is not a multiple
   of the kernels' 128-row tiles, a window over T 1088, which is not
   either, lse with an lse cotangent, small and ragged shapes), and
   the forward at the serving lane prefill's shape (batch 1, a 512-row
   chunk at ``q_offset`` 1536 against 2048 keys, 32 heads, head_dim
   128); ``flash_attention``'s output and gradient through autograd on
   strided views of a fused qkv tensor at each main shape, against
   dense f32 attention; the backward's dq, dk and dv bitwise equal on
   two calls at each main shape (the kernels use no atomics); and a
   mask that drops keys of the last rows must fail the same limits.
   Fused norms (K3, K4): LayerNorm with bias at the GPT-2 shape (8192
   rows x 768), RMSNorm at the Llama shape (8192 x 4096), a ragged
   1000 x 128 LayerNorm, a 1024 x 8192 LayerNorm (the widest row the
   kernels take), LayerNorms at E 1024 and 1032 (each side of the
   kernels' warp/block width dispatch), one row at E 4096, row counts
   that are no multiple of the rows a warp or a block takes (8193 x
   768, 4099 x 4096), a small RMSNorm and the serving decode step's
   RMSNorm (8 x 4096, a row a lane), each plain and with the
   residual add; every output (out, resid, mu, rstd, dx, dg, db) held
   to its limit; every output bitwise equal on two calls at each main
   shape; and the LayerNorm case run through the RMS variant, on rows
   with a non-zero mean, must fail them.
   Blockwise quantization (K5 int8, K6 packed int4, signed and
   unsigned): quantize and dequantize at GPT-2's largest quantized leaf
   (wte, 38,633,472 values), a ragged 1000 x 1024 + 77 values, an
   all-zero block, a block with one non-zero value and lognormal values
   from 1e-30 to 1e4, each held bitwise to the plain versions (codes or
   packed bytes, scales, dequantized values); and the kernel's packed
   int4 read back with the adjacent-pair layout must fail the same
   comparison.
3. ``times``: each kernel's median time at each path's shape (one call
   between two events, so it holds host time where the card waits) and
   its device time by torch.profiler, beside its plain version's, the
   library call that computes the same function
   (``scaled_dot_product_attention``, ``F.layer_norm``,
   ``F.rms_norm``; yardsticks only: the port never calls them; the add
   variants and the quantizers have none; SDPA with the explicit mask
   at the serving rectangle) and the least time the card
   could take; for the quantizers also the sum over GPT-2's quantized
   leaves, as one low-bit Adam step launches them, beside its bound.
4. ``train``: GPT-2 124M at full width and depth (12 layers, 12 heads,
   n_embd 768, vocab 50304, T 1024, bf16, full remat, fused
   cross-entropy, AdamW 3e-4 / 0.1) takes optimizer steps through the
   nanoGPT example's ``ElasticTrainer`` on synthetic tokens from a
   seed, through the flash and fused LayerNorm kernels; the kernels'
   launch counters are zeroed just before and read just after. The
   first loss must be ln(50304) within 0.1, every loss finite, and the
   first loss must match the same step with dense attention and the
   plain LayerNorm.
5. ``elastic``: the same GPT-2 run under the port's elastic launcher,
   as a user starts it: ``python -m dlrover_tpu_torch.trainer.elastic_run
   --standalone --nproc_per_node 1 -m
   dlrover_tpu_torch.examples.nanogpt.train -- --model gpt2 --steps 8
   --checkpoint-every 3 --checkpoint-dir <dir>``, through the port's own
   job master and agent, one trainer on NCCL (a world of one). The
   example's drill hook SIGKILLs the trainer once step 4 is done; the
   agent flushes the step-3 checkpoint and restarts it, and it resumes
   from the checkpoint to step 8. Checks: launcher rc 0; exactly one
   restart; the restart restores step 3, every leaf's checksum equal to
   what was staged at step 3; its first batch's token checksum equal to
   the killed run's at step 4; every loss finite and within LOSS_TOL of
   phase ``train``'s at the same step; the flash and norm kernels
   launched in both incarnations; and no module of jax or of
   ``dlrover_tpu`` in the launcher's, the master's or a trainer's
   ``sys.modules`` (an import audit installed through ``sitecustomize``
   for these processes only). It prints the device-to-shm staging time,
   the agent's persist time, the restore time, the recovery time (kill to
   the first step done after the restore) with its phases, and tokens/s
   beside phase ``train``'s.
6. ``train_low_bit``: the same GPT-2 run with ``--optimizer adam8bit``
   and then ``--optimizer adam4bit`` (4 steps each), the counters zeroed
   just before each run and read just after. Every loss finite, the
   first loss equal to phase ``train``'s within LOSS_TOL, the last below
   the first, the quantization kernels launched for both moments of
   every quantized leaf each step (and at init), the state's bytes at
   most 0.252 (int8) and 0.127 (int4) of f32 moments, and a rerun with
   the plain quantizers (``--quant plain``) within 1e-3 at every step.
7. ``train_llama_lora``: LoRA fine-tuning of Llama-2-7B at full width
   and depth (32 layers, 32 heads, n_embd 4096, head_dim 128, SwiGLU
   11008, vocab 32000, T 4096, bf16, full remat; rank 8, AdamW 1e-3)
   through the LoRA example's ``run()`` at batch 2 for 4 steps, the
   counters zeroed just before and read just after. Every loss finite,
   the first loss equal to the plain path's (dense attention, plain
   RMSNorm, one step) within LOSS_TOL, the base weights unchanged, every
   LoRA ``b`` moved off zero, and the kernels launched at least as often
   as full remat implies.
8. ``serve``: Llama-2-7B at full width and depth (random weights from
   seed 0, bf16) answers requests through the port's control plane: a
   ``MasterClient`` submits 16 requests (prompts of 64-3000 tokens from
   a seeded generator, 32 new tokens each, 14 greedy and 2 at
   temperature 0.8) to a ``JobMaster`` (port 0), whose
   ``ServingRouter`` hands them to one mixed-role ``ReplicaWorker``
   (8 lanes, ``max_len`` 4096, KV blocks of 16, prefill chunks of 512,
   the default prefill budget); its ``ContinuousBatchingScheduler``
   runs the lane prefill (K1 rectangular, K3) and the ragged decode
   step (K3). Every request must finish by length with 32 tokens, and
   K1 and K3 must launch at least as often as the prompts' chunks and
   the decode ticks imply (counters zeroed just before the requests,
   read just after). The 14 greedy requests go again through a
   prefill-role and a decode-role ``ReplicaWorker`` sharing the
   weights; their tokens must equal the mixed run's bitwise (7B
   payloads, 512 KiB a prompt token, exceed the RPC's message cap, so
   they pass between the two in this process; the first crosses the
   wire form bitwise). Logits of the lane prefill (chunk by chunk, a
   padded last chunk), of ``llama_prefill_chunked`` (4096 tokens,
   chunks of 1024) and of 8 teacher-forced ragged decode steps (lanes
   at 100..1500) must match ``llama.forward`` within the limits in
   ``SERVE_LOGIT_*``, and logits of other positions must not. GPT-2
   124M ``generate.generate`` (greedy, prompt 4 x 512, 64 new) must
   give the teacher-forced forward's argmax or a token within
   ``GEN_MARGIN`` of it. ``python -m dlrover_tpu_torch.serving.replica``
   with its default tiny model, a subprocess on the card, must answer 2
   requests through another master with the in-process ``generate``'s
   greedy tokens. It prints TTFT and TPOT p50/p99, prefill and decode
   tokens/s, the decode step's device busy share and time by kernel
   family, peak memory, handoff bytes and install time.

Then it prints the card line, one ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, it exits non-zero before any result.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import uuid

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = (
    "card", "kernels", "times", "train", "elastic", "train_low_bit",
    "train_llama_lora", "serve",
)

# Flash attention's bf16 outputs, compared element by element:
#   |kernel - plain| <= RTOL * |plain| + ATOL * max(row_rms, rms / 16)
# where row_rms is the plain value's rms over the heads and head dims of
# the element's sequence position and rms is over the whole tensor, and
#   rms(kernel - plain) <= RMS_TOL * rms(plain).
# RTOL is one bf16 ulp (2^-7 of the value): both sides round once to
# bf16, so f32 results a hair apart can land an ulp apart. ATOL covers
# elements near zero, where the kernel's bf16 rounding of P and dS
# before the second product (the TPU kernel does the same; the plain
# version keeps f32) does not shrink with the element; per position,
# because |O| falls as 1/sqrt(position) under a causal mask, with a
# floor for positions whose exact value is ~0 (dq of a causal row 0).
RTOL = 2.0 ** -7
ATOL = 2.0 ** -4
RMS_TOL = 2.0 ** -7
LSE_TOL = 1e-5   # lse is f32 in both: exp/log approximations, sum order
# The norms' bf16 outputs (out, resid, dx): both sides compute in f32
# and round once, so they differ by at most an ulp where the f32 sums,
# taken in another order, straddle a rounding boundary:
#   |kernel - plain| <= NORM_RTOL * |plain| + NORM_ATOL * rms(plain),
#   rms(kernel - plain) <= NORM_RMS_TOL * rms(plain).
# The f32 outputs: mu and rstd within STAT_TOL of the largest plain
# value, dg and db (sums over every row, in another order) within
# PARAM_GRAD_TOL of the largest.
NORM_RTOL = 2.0 ** -7
NORM_ATOL = 2.0 ** -9
NORM_RMS_TOL = 2.0 ** -8
STAT_TOL = 1e-5
PARAM_GRAD_TOL = 1e-4
# The first loss with the kernels against the plain path (dense
# attention, plain norms): both run the model in bf16; attention's and
# the norms' rounding differ. At init (weights of std 0.02) attention
# barely moves the loss, so this gate checks the path end to end; the
# parity limits hold the kernels themselves.
LOSS_TOL = 2e-2

# The low-bit run's losses against the plain quantizers' at every step.
# The kernels equal the plain versions bitwise, so the runs are expected
# to agree exactly; the limit leaves room only for the order of the
# model's own sums.
LOW_BIT_LOSS_TOL = 1e-3
# optimizer_state_bytes actual / f32-equivalent on GPT-2 124M (scales,
# the step count and the two small f32 leaves count in full on both
# sides): 0.2507 at int8 and 0.1259 at int4 by count.
STATE_RATIO_MAX = {"adam8bit": 0.252, "adam4bit": 0.127}

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on
# the CUDA cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Each path's attention shape, by head_dim.
MAIN = {
    64: dict(b=8, t=1024, h=12, d=64),     # GPT-2 124M, micro-batch 8
    128: dict(b=2, t=4096, h=32, d=128),   # Llama-2-7B, batch 2
}
# Each path's norm shape: name, rows, width, rms, bias.
NORM_MAIN = {
    "gpt2": ("gpt2_ln_e768", 8 * 1024, 768, False, True),
    "llama": ("llama_rms_e4096", 2 * 4096, 4096, True, False),
}
NORM_CASES = list(NORM_MAIN.values()) + [
    ("ragged_n1000_e128", 1000, 128, False, True),
    # the widest row the kernels take (ops/layer_norm.MAX_WIDTH), in the
    # variant with the most registers a thread (LayerNorm with bias)
    ("max_width_n1024_e8192", 1024, 8192, False, True),
    # each side of the width dispatch (ops/layer_norm.WARP_MAX_WIDTH: a
    # warp a row up to it, a block a row above), one row, and row counts
    # that are no multiple of the rows a warp or a block takes
    ("warp_widest_n997_e1024", 997, 1024, False, True),
    ("block_narrowest_n997_e1032", 997, 1032, False, True),
    ("one_row_n1_e4096", 1, 4096, True, False),
    ("ragged_n8193_e768", 8193, 768, False, True),
    ("ragged_n4099_e4096", 4099, 4096, True, False),
    ("rms_n333_e256", 333, 256, True, False),
]
# The serving decode step's norms: a row a lane (Llama-2-7B, 8 lanes).
SERVE_NORM = ("decode_rms_n8_e4096", 8, 4096, True, False)
NORM_CASES.append(SERVE_NORM)
# The serving lane prefill's K1 call: Llama-2-7B, a 512-token chunk at
# position 1536 of its lane (neither the key count nor the offset a
# multiple of the kernel's tiles would need to be).
SERVE_RECT = dict(b=1, tq=512, tk=2048, h=32, d=128, q_offset=1536)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def free_memory() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    check(bool(out), "nvidia-smi reported no card")
    return out.splitlines()[0]


def phase_card(res: dict) -> None:
    from dlrover_tpu_torch.ops import _build

    res["card"] = card_line()
    log(f"# card: {res['card']}")
    names = sorted(p[:-3] for p in os.listdir(_build.CSRC)
                   if p.endswith(".cu"))
    t0 = time.perf_counter()
    outs = _build.build(names)
    res["build_s"] = time.perf_counter() - t0
    for name, out in outs.items():
        for fn, use in _build.ptxas_usage(out).items():
            log(f"# ptxas {name} {fn}: {use}")
    log(f"# built {names} in {res['build_s']:.2f} s")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _case_inputs(seed, b, tq, tk, h, d):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, (b, tq, h, d), torch.bfloat16)
    k = _randn(gen, (b, tk, h, d), torch.bfloat16)
    v = _randn(gen, (b, tk, h, d), torch.bfloat16)
    do = _randn(gen, (b, tq, h, d), torch.bfloat16)
    g_lse = _randn(gen, (b, h, tq), torch.float32)
    return q, k, v, do, g_lse


def _err(got, ref):
    """Errors of ``got`` against ``ref``, both [B, T, ...]: (max abs
    error, worst element's share of its limit, rms error over rms of the
    plain value); the limits hold when the shares are at most 1 and
    RMS_TOL."""
    import torch

    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rms = ref.square().mean().sqrt().item()
    row_rms = ref.square().mean(
        dim=tuple(range(2, ref.dim())), keepdim=True
    ).sqrt()
    limit = RTOL * ref.abs() + ATOL * row_rms.clamp(min=rms / 16)
    worst = torch.where(diff == 0, 0.0, diff / limit).max().item()
    rms_err = diff.square().mean().sqrt().item()
    return diff.max().item(), worst, rms_err / rms if rms_err else 0.0


def _within(err) -> bool:
    _, worst, rms_share = err
    return worst <= 1.0 and rms_share <= RMS_TOL


def _fmt(name, err) -> str:
    return (
        f"{name} abs {err[0]:.3e} limit-share {err[1]:.3f} "
        f"rms {err[2]:.3e}"
    )


# name, tq, tk, causal, window, q_offset, scale, with an lse cotangent.
# tq/tk None: the path's T; scale None: 1/sqrt(head_dim) as the model
# path applies it (folded into q at head_dim 64, passed to the kernel
# at 128).
CASES = [
    ("main_causal", None, None, True, None, 0, None, False),
    ("full", 1024, 1024, False, None, 0, 0.125, False),
    ("ragged_t1000", 1000, 1000, True, None, 0, 0.125, False),
    ("window256", 1024, 1024, True, 256, 0, 0.125, False),
    ("rect_q_offset", 256, 1024, True, None, 768, 0.125, False),
    ("rect_q_offset700_tq324", 324, 1024, True, None, 700, 0.125, False),
    ("window200_t1088", 1088, 1088, True, 200, 0, 0.125, True),
    ("lse_cotangent", 1024, 1024, True, None, 0, None, True),
    ("tiny_t65", 65, 65, True, None, 0, 0.125, False),
    ("window1_t200", 200, 200, True, 1, 0, 0.125, True),
    ("rect_full_tq192_tk100", 192, 100, False, None, 0, 0.125, False),
]


def _limits() -> str:
    return (
        f"flash limits: |err| <= {RTOL:.3g}|plain| + {ATOL:.3g} "
        "max(row_rms, rms/16)(plain), "
        f"rms(err) <= {RMS_TOL:.3g} rms(plain), lse {LSE_TOL}; "
        f"norm limits: |err| <= {NORM_RTOL:.3g}|plain| + "
        f"{NORM_ATOL:.3g} rms(plain), rms(err) <= {NORM_RMS_TOL:.3g} "
        f"rms(plain), mu/rstd {STAT_TOL} and dg/db {PARAM_GRAD_TOL} of "
        "max|plain|"
    )


def phase_kernels(res: dict) -> None:
    res["max_abs_err"] = {}
    for d in (64, 128):
        flash_cases(res, d)
        wrapper_autograd(d)
        free_memory()
    serve_rect_case(res)
    norm_cases(res)
    quant_cases(res)
    log(f"# {_limits()}; quantization: bitwise")


def flash_cases(res: dict, d: int) -> None:
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    main = MAIN[d]
    for i, (name, tq, tk, causal, window, q_off, scale, with_glse) in (
        enumerate(CASES)
    ):
        is_main = name == "main_causal"
        b = main["b"] if is_main else 2
        h = main["h"] if is_main else (12 if d == 64 else 8)
        tq = tq or main["t"]
        tk = tk or main["t"]
        q, k, v, do, g_lse = _case_inputs(100 + i + d, b, tq, tk, h, d)
        if scale is None:
            q, scale = fa._fold_scale(q, None, d)
        o_ref, lse_ref = fa.flash_attention_ref(
            q, k, v, causal, scale, window, q_off
        )
        o, lse = fa._fwd_cuda(q, k, v, causal, scale, window, q_off)
        torch.cuda.synchronize()
        o_err = _err(o, o_ref)
        lse_abs = (lse - lse_ref).abs().max().item()
        delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2)
        if with_glse:
            delta = delta - g_lse
        grads_ref = fa.flash_attention_bwd_ref(
            q, k, v, lse_ref, do, delta, causal, scale, window, q_off
        )
        grads = fa._bwd_cuda(
            q, k, v, lse_ref, do, delta, causal, scale, window, q_off
        )
        torch.cuda.synchronize()
        g_errs = [_err(g, r) for g, r in zip(grads, grads_ref)]
        log(
            f"# parity D{d} {name} (B={b} H={h} Tq={tq} Tk={tk} "
            f"scale={scale:.6g}): {_fmt('o', o_err)} | "
            f"lse abs {lse_abs:.3e} | "
            + " | ".join(_fmt(f"d{n}", e) for n, e in zip("qkv", g_errs))
        )
        check(
            _within(o_err) and lse_abs <= LSE_TOL,
            f"forward kernel disagrees with its plain version on {name} "
            f"at head_dim {d}",
        )
        check(
            all(_within(e) for e in g_errs),
            f"backward kernels disagree with the plain version on {name} "
            f"at head_dim {d}",
        )
        if is_main:
            res["max_abs_err"][f"fwd{d}"] = max(o_err[0], lse_abs)
            res["max_abs_err"][f"bwd{d}"] = max(e[0] for e in g_errs)
            again = fa._bwd_cuda(
                q, k, v, lse_ref, do, delta, causal, scale, window, q_off
            )
            torch.cuda.synchronize()
            same = [torch.equal(a, g) for a, g in zip(again, grads)]
            log(f"# repeatable D{d} backward (dq, dk, dv bitwise): {same}")
            check(all(same), f"the backward is not repeatable at head_dim {d}")
            del again
            wrong_mask_fails(
                q, k, v, do, o_ref, lse_ref, delta, grads_ref, scale
            )
        del q, k, v, do, o_ref, lse_ref, grads_ref, grads, o, lse, delta


def _serve_rect_inputs(seed):
    from dlrover_tpu_torch.ops import flash_attention as fa

    s = SERVE_RECT
    q, k, v, _, _ = _case_inputs(seed, s["b"], s["tq"], s["tk"], s["h"],
                                 s["d"])
    q, scale = fa._fold_scale(q, None, s["d"])  # as the model path calls it
    return q, k, v, scale


def serve_rect_case(res: dict) -> None:
    """K1 forward at the serving lane prefill's shape (SERVE_RECT)
    against its plain version, held to the flash limits."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    s = SERVE_RECT
    q, k, v, scale = _serve_rect_inputs(150)
    o_ref, lse_ref = fa.flash_attention_ref(
        q, k, v, True, scale, None, s["q_offset"]
    )
    o, lse = fa._fwd_cuda(q, k, v, True, scale, None, s["q_offset"])
    torch.cuda.synchronize()
    o_err = _err(o, o_ref)
    lse_abs = (lse - lse_ref).abs().max().item()
    log(f"# parity D128 serve_rect (B=1 H=32 Tq=512 Tk=2048 q_offset=1536 "
        f"scale={scale:.6g}): {_fmt('o', o_err)} | lse abs {lse_abs:.3e}")
    check(_within(o_err) and lse_abs <= LSE_TOL,
          "forward kernel disagrees with its plain version at the serving "
          "lane prefill's shape")
    res["max_abs_err"]["fwd128_serve"] = max(o_err[0], lse_abs)


def wrong_mask_fails(
    q, k, v, do, o_ref, lse_ref, delta, grads_ref, scale
) -> None:
    """The limits must see a mask error: the kernels run with a window
    of T - 64, so each of the last 64 rows drops its first 1..64 keys,
    and are held to the plain causal result."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    window = q.shape[1] - 64
    o, _ = fa._fwd_cuda(q, k, v, True, scale, window, 0)
    grads = fa._bwd_cuda(
        q, k, v, lse_ref, do, delta, True, scale, window, 0
    )
    torch.cuda.synchronize()
    o_err = _err(o, o_ref)
    g_errs = [_err(g, r) for g, r in zip(grads, grads_ref)]
    log(
        f"# wrong mask D{q.shape[-1]} (window T-64, must fail): "
        f"{_fmt('o', o_err)} | "
        + " | ".join(_fmt(f"d{n}", e) for n, e in zip("qkv", g_errs))
    )
    check(
        not _within(o_err) and not all(_within(e) for e in g_errs),
        "the parity limits pass kernels run with a wrong mask",
    )


def wrapper_autograd(d: int) -> None:
    """The model's call end to end on the card at the path's shape:
    ``flash_attention`` on strided q/k/v views of one fused qkv tensor
    (the scale folded into q or passed to the kernel, delta and the
    backward in the autograd Function) against autograd through dense
    f32 attention on the same bf16 values; the output and each of dq,
    dk, dv are held to the limits."""
    import torch

    from dlrover_tpu_torch.models.gpt import _default_attention
    from dlrover_tpu_torch.ops.flash_attention import flash_attention

    b, t, h = MAIN[d]["b"], MAIN[d]["t"], MAIN[d]["h"]
    gen = torch.Generator(device="cuda").manual_seed(11 + d)
    qkv = _randn(gen, (b, t, 3 * h * d), torch.bfloat16).requires_grad_(True)
    w = torch.randn((b, t, h, d), generator=gen, device="cuda")
    outs, grads = [], []
    for attn, cast in ((flash_attention, None), (_default_attention, "f32")):
        x = qkv.float() if cast else qkv
        q, k, v = (y.reshape(b, t, h, d) for y in x.split(h * d, dim=-1))
        out = attn(q, k, v, causal=True)
        (g,) = torch.autograd.grad((out.float() * w).sum(), qkv)
        outs.append(out.detach())
        grads.append(g.split(h * d, dim=-1))
        del x, q, k, v, out, g
    torch.cuda.synchronize()
    errs = [_err(outs[0], outs[1])] + [
        _err(g, r) for g, r in zip(grads[0], grads[1])
    ]
    log(
        f"# parity wrapper_autograd D{d} (qkv views, B={b} T={t} H={h}): "
        + " | ".join(_fmt(n, e) for n, e in zip(("o", "dq", "dk", "dv"), errs))
    )
    check(
        all(_within(e) for e in errs),
        f"flash_attention's output or gradient disagrees with dense f32 "
        f"attention at head_dim {d}",
    )


def _norm_inputs(seed, n, e):
    """Rows of x with a non-zero mean (so LayerNorm and RMSNorm
    differ), a residual, g, b, the output cotangent and a residual
    cotangent."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((n, e), generator=gen, device="cuda") + 1.0).to(
        torch.bfloat16
    )
    res = _randn(gen, (n, e), torch.bfloat16)
    g = 1.0 + 0.1 * torch.randn((e,), generator=gen, device="cuda")
    b = 0.1 * torch.randn((e,), generator=gen, device="cuda")
    dout = _randn(gen, (n, e), torch.bfloat16)
    return x, res, g, b, dout


def _norm_err(got, ref):
    """bf16 output: (max abs error, worst element's share of its limit,
    rms error over rms of the plain value)."""
    import torch

    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rms = ref.square().mean().sqrt().item()
    limit = NORM_RTOL * ref.abs() + NORM_ATOL * rms
    worst = torch.where(diff == 0, 0.0, diff / limit).max().item()
    rms_err = diff.square().mean().sqrt().item()
    return diff.max().item(), worst, rms_err / rms if rms_err else 0.0


def _norm_within(err) -> bool:
    return err[1] <= 1.0 and err[2] <= NORM_RMS_TOL


def _rel_err(got, ref):
    """f32 output: (max abs error, max abs error over max |plain|)."""
    diff = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return diff, (diff / top if top else (0.0 if diff == 0 else math.inf))


def _plain_fwd(x, res, g, b, eps, rms):
    """The plain forward with the kernels' outputs: (out, resid, stats
    [2, N]: mu, rstd)."""
    import torch

    from dlrover_tpu_torch.ops import layer_norm as ln

    out, resid, mu, rstd = ln.layer_norm_fwd_ref(x, res, g, b, eps, rms)
    return out, resid, torch.stack((mu, rstd))


def _plain_bwd(dout, y, g, stats, rms, has_bias):
    from dlrover_tpu_torch.ops import layer_norm as ln

    return ln.layer_norm_bwd_ref(dout, y, g, stats[0], stats[1], rms,
                                 has_bias)


def _norm_outputs(x, res, g, b, dout, rms, run_fwd, run_bwd):
    """Forward and backward outputs of one norm (plain variant, then
    the add variant), through the given forward and backward."""
    outs = {}
    eps = 1e-6 if rms else 1e-5
    for add in (False, True):
        out, resid, stats = run_fwd(x, res if add else None, g, b, eps, rms)
        y = resid if add else x
        dx, dg, db = run_bwd(dout, y, g, stats, rms, b is not None)
        tag = "add_" if add else ""
        outs.update({
            f"{tag}out": out, f"{tag}mu": stats[0], f"{tag}rstd": stats[1],
            f"{tag}dx": dx, f"{tag}dg": dg,
        })
        if add:
            outs["add_resid"] = resid
        if b is not None:
            outs[f"{tag}db"] = db
    return outs


def _compare_norm(got: dict, ref: dict):
    """Per output: (max abs error, share of its limit); all within?"""
    errs, ok = {}, True
    for key, r in ref.items():
        base = key.removeprefix("add_")
        if base in ("out", "resid", "dx"):
            e = _norm_err(got[key], r)
            errs[key] = (e[0], max(e[1], e[2] / NORM_RMS_TOL))
            ok &= _norm_within(e)
        else:
            tol = STAT_TOL if base in ("mu", "rstd") else PARAM_GRAD_TOL
            abs_err, rel = _rel_err(got[key], r)
            errs[key] = (abs_err, rel / tol)
            ok &= rel <= tol
    return errs, ok


def norm_cases(res: dict) -> None:
    import torch

    from dlrover_tpu_torch.ops import layer_norm as ln

    check(
        max(c[2] for c in NORM_CASES) == ln.MAX_WIDTH,
        f"no norm case at the kernels' widest row {ln.MAX_WIDTH}",
    )
    widths = {c[2] for c in NORM_CASES}
    check(
        {ln.WARP_MAX_WIDTH, ln.WARP_MAX_WIDTH + 8} <= widths,
        "no norm case on each side of the kernels' width dispatch",
    )
    # The plain versions run on the same CUDA tensors: they are called
    # directly, so the wrappers' dispatch does not apply.
    for i, (name, n, e, rms, bias) in enumerate(NORM_CASES):
        x, r, g, b, dout = _norm_inputs(300 + i, n, e)
        b = b if bias else None
        ref = _norm_outputs(x, r, g, b, dout, rms, _plain_fwd, _plain_bwd)
        got = _norm_outputs(
            x, r, g, b, dout, rms, ln._fwd_cuda, ln._bwd_cuda
        )
        torch.cuda.synchronize()
        errs, ok = _compare_norm(got, ref)
        log(
            f"# parity norm {name} (N={n} E={e} "
            f"{'rms' if rms else 'layer'}{' +bias' if bias else ''}): "
            + " | ".join(
                f"{k} abs {a:.3e} limit-share {s:.3f}"
                for k, (a, s) in errs.items()
            )
        )
        check(ok, f"norm kernels disagree with their plain versions on {name}")
        fwd_keys = [k for k in errs if k.split("_")[-1] in
                    ("out", "resid", "mu", "rstd")]
        bwd_keys = [k for k in errs if k not in fwd_keys]
        if name == SERVE_NORM[0]:
            res["max_abs_err"]["norm_fwd_serve"] = max(
                errs[k][0] for k in fwd_keys
            )
        for path, main in NORM_MAIN.items():
            if main[0] != name:
                continue
            res["max_abs_err"][f"norm_fwd_{path}"] = max(
                errs[k][0] for k in fwd_keys
            )
            res["max_abs_err"][f"norm_bwd_{path}"] = max(
                errs[k][0] for k in bwd_keys
            )
            # no atomics: a second call gives the same bits
            again = _norm_outputs(
                x, r, g, b, dout, rms, ln._fwd_cuda, ln._bwd_cuda
            )
            torch.cuda.synchronize()
            same = {k: torch.equal(again[k], v) for k, v in got.items()}
            log(f"# repeatable norm {name} (every output bitwise): {same}")
            check(all(same.values()),
                  f"the norm kernels are not repeatable on {name}")
            del again
        if name == NORM_MAIN["gpt2"][0]:
            wrong_norm_fails(x, r, g, b, dout, ref)
        del x, r, g, b, dout, ref, got


def wrong_norm_fails(x, r, g, b, dout, ref) -> None:
    """The limits must see a wrong kernel: the LayerNorm case run
    through the RMS variant (on rows whose mean is ~1) and held to the
    plain LayerNorm."""
    import torch

    from dlrover_tpu_torch.ops import layer_norm as ln

    def rms_fwd(x, res, g, b, eps, rms):
        return ln._fwd_cuda(x, res, g, b, eps, True)

    def rms_bwd(dout, y, g, stats, rms, has_bias):
        return ln._bwd_cuda(dout, y, g, stats, True, has_bias)

    got = _norm_outputs(x, r, g, b, dout, False, rms_fwd, rms_bwd)
    torch.cuda.synchronize()
    errs, ok = _compare_norm(got, ref)
    log(
        "# wrong norm (LayerNorm run as RMSNorm, must fail): "
        + " | ".join(
            f"{k} limit-share {s:.3g}" for k, (_, s) in errs.items()
            if k in ("out", "add_out", "dx", "add_dx")
        )
    )
    check(
        not ok and all(
            errs[k][1] > 1 for k in ("out", "add_out", "dx", "add_dx")
        ),
        "the norm parity limits pass the RMS kernel on the LayerNorm case",
    )


# Quantization variants of the low-bit Adam path: label, bits, signed.
QUANT_VARIANTS = (
    ("int8", 8, True), ("int4_signed", 4, True), ("int4_unsigned", 4, False),
)
# name, values (None: GPT-2's wte, the path's largest leaf), kind
QUANT_CASES = [
    ("wte", None, "normal"),
    ("ragged_1000x1024+77", 1000 * 1024 + 77, "normal"),
    ("zero_block", 1024, "zeros"),
    ("one_nonzero", 1024, "one_nonzero"),
    ("lognormal_1e-30_1e4", 256 * 1024, "lognormal"),
]


@functools.lru_cache(maxsize=None)
def gpt2_quantized_leaves() -> tuple:
    """(path, values) of each GPT-2 124M leaf that the low-bit Adam
    quantizes (at least its min_quantize_size values)."""
    from dlrover_tpu_torch.models import gpt
    from dlrover_tpu_torch.optim.low_bit import LowBitAdam

    params = gpt.init_params(gpt.GPTConfig.gpt2(), device="cpu")
    min_size = LowBitAdam().min_quantize_size
    out = []

    def walk(tree, prefix):
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            elif value.numel() >= min_size:
                out.append((f"{prefix}{key}", value.numel()))

    walk(params, "")
    return tuple(out)


def _quant_values(kind: str, n: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "normal":
        return torch.randn(n, generator=gen, device="cuda")
    x = torch.zeros(n, device="cuda")
    if kind == "one_nonzero":
        x[n // 3] = -2.5
    elif kind == "lognormal":
        # each block's magnitudes span 4 decades around a centre drawn
        # from 1e-28 .. 1e2, so values reach from 1e-30 (blocks whose
        # scale falls below the 1e-30 floor) to 1e4
        blocks = n // 1024
        centre = torch.empty((blocks, 1), device="cuda").uniform_(
            math.log(1e-28), math.log(1e2), generator=gen
        )
        spread = torch.empty((blocks, 1024), device="cuda").uniform_(
            -math.log(100.0), math.log(100.0), generator=gen
        )
        sign = torch.randint(
            0, 2, (blocks, 1024), generator=gen, device="cuda"
        ) * 2 - 1
        x = (sign * torch.exp(centre + spread)).reshape(-1)
    return x


def _quant_outputs(x, bits, signed, kernel: bool):
    """(codes, scales, dequantized values) of x through the kernels or
    the plain versions (called directly: the dispatch does not apply)."""
    import torch

    from dlrover_tpu_torch.ops import quantization as Q

    shape = tuple(x.shape)
    if kernel:
        q, s, _ = Q._quantize_cuda(x, Q.KERNEL_BLOCK, bits, signed)
        d = Q._dequantize_cuda(q, s, shape, bits, signed, torch.float32)
    elif bits == 8:
        q, s, _ = Q.quantize_blockwise_plain(x)
        d = Q.dequantize_blockwise_plain(q, s, shape)
    else:
        q, s, _ = Q.quantize_blockwise_4bit_plain(x, signed=signed)
        d = Q.dequantize_blockwise_4bit_plain(q, s, shape, signed)
    return q, s, d


def _bitwise(got, ref):
    """(elements whose bits differ, or -1 on a shape or dtype mismatch;
    max abs difference)."""
    import torch

    if got.shape != ref.shape or got.dtype != ref.dtype:
        return -1, math.inf
    if got.is_floating_point():
        differ = got.view(torch.int32) != ref.view(torch.int32)
    else:
        differ = got != ref
    diff = (got.float() - ref.float()).abs()
    worst = diff.max().item() if diff.numel() else 0.0
    return int(differ.sum().item()), worst


def quant_cases(res: dict) -> None:
    import torch

    wte = dict(gpt2_quantized_leaves())["wte"]
    for i, (name, n, kind) in enumerate(QUANT_CASES):
        n = n or wte
        x = _quant_values(kind, n, 500 + i)
        for label, bits, signed in QUANT_VARIANTS:
            ref = _quant_outputs(x, bits, signed, kernel=False)
            got = _quant_outputs(x, bits, signed, kernel=True)
            torch.cuda.synchronize()
            errs = {
                key: _bitwise(g, r)
                for key, g, r in zip(("codes", "scales", "values"), got, ref)
            }
            log(
                f"# parity quant {name} {label} (n={n}): " + " | ".join(
                    f"{k} mismatches {m} abs {a:.3e}"
                    for k, (m, a) in errs.items()
                )
            )
            check(
                all(m == 0 for m, _ in errs.values()),
                f"quantization kernels disagree with their plain versions "
                f"on {name} {label}",
            )
            if name == "wte":
                res["max_abs_err"][f"quant_{label}"] = max(
                    errs["codes"][1], errs["scales"][1]
                )
                res["max_abs_err"][f"dequant_{label}"] = errs["values"][1]
                if label == "int4_signed":
                    adjacent_pairs_fail(got, ref)
            del ref, got
        del x
    free_memory()


def adjacent_pairs_fail(got, ref) -> None:
    """The comparison must see a wrong layout: the kernel's packed int4
    read back as adjacent pairs (byte i holding elements 2i and 2i + 1)
    and held to the plain dequantized values."""
    import torch

    q, s, _ = got
    p = q.to(torch.int32)
    pairs = torch.stack([(p & 15) - 8, ((p >> 4) & 15) - 8], dim=2)
    wrong = (pairs.reshape(q.shape[0], -1).float() * s).reshape(-1)
    wrong = wrong[: ref[2].numel()].reshape(ref[2].shape)
    mismatches, abs_err = _bitwise(wrong, ref[2])
    log(
        f"# wrong int4 layout (adjacent pairs, must fail): values "
        f"mismatches {mismatches} of {wrong.numel()} abs {abs_err:.3e}"
    )
    check(
        mismatches > 0,
        "the quantization comparison passes the adjacent-pair layout",
    )


# ---------------------------------------------------------------------------
# phase 3: times
# ---------------------------------------------------------------------------


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Device time (ms) of one call of ``fn``: every kernel it launches,
    summed, by torch.profiler. ``median_ms`` also holds the host's time
    where the card waits for the launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return total / reps / 1e3


def _bound(nbytes, flops, peak_flops=PEAK_BF16_FLOPS):
    """Least time (ms) and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"
    )


def attention_bounds(b, t, h, d):
    """Least times (ms) of causal attention at these shapes: bytes each
    input read once and each output written once, over the memory rate;
    operations on the visible (query, key) pairs, over the bf16 rate."""
    pairs = b * h * t * (t + 1) // 2
    elems = b * t * h * d
    # forward: q k v o in bf16, lse in f32; QK^T and PV
    fwd_bytes = 4 * elems * 2 + b * h * t * 4
    fwd_flops = 2 * 2 * d * pairs
    # backward: q k v do dq dk dv in bf16, lse and delta in f32;
    # QK^T, dO V^T, P^T dO, dS^T Q and dS K
    bwd_bytes = 7 * elems * 2 + 2 * b * h * t * 4
    bwd_flops = 5 * 2 * d * pairs
    return _bound(fwd_bytes, fwd_flops), _bound(bwd_bytes, bwd_flops)


def norm_bounds(n, e, bias):
    """Least times (ms) of the norm kernels on [n, e] bf16 rows: the
    forward reads x (and the residual) and writes out (and resid), g/b
    and the f32 mu/rstd; the backward reads dout, y, g, mu and rstd and
    writes dx and dg/db. About 10 operations per element: bytes bound
    every one of them."""
    from dlrover_tpu_torch.ops import layer_norm as ln

    fwd = _bound(ln.io_bytes(n, e, "fwd", bias), 10 * n * e)
    add = _bound(ln.io_bytes(n, e, "add", bias), 11 * n * e)
    bwd = _bound(ln.io_bytes(n, e, "bwd", bias), 12 * n * e)
    return fwd, add, bwd


def flash_times(d: int) -> dict:
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import flash_attention as fa

    b, t, h = MAIN[d]["b"], MAIN[d]["t"], MAIN[d]["h"]
    q, k, v, do, _ = _case_inputs(7 + d, b, t, t, h, d)
    q, scale = fa._fold_scale(q, None, d)  # as the model path calls it
    o, lse = fa._fwd_cuda(q, k, v, True, scale, None, 0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    plain_reps = 5 if d == 64 else 3
    def fwd():
        return fa._fwd_cuda(q, k, v, True, scale, None, 0)

    def bwd():
        return fa._bwd_cuda(q, k, v, lse, do, delta, True, scale, None, 0)

    times = {
        "fwd": median_ms(fwd),
        "fwd_device": device_ms(fwd),
        "fwd_plain": median_ms(
            lambda: fa.flash_attention_ref(q, k, v, True, scale),
            reps=plain_reps,
        ),
        "bwd": median_ms(bwd),
        "bwd_device": device_ms(bwd),
        "bwd_plain": median_ms(
            lambda: fa.flash_attention_bwd_ref(
                q, k, v, lse, do, delta, True, scale
            ),
            reps=plain_reps,
        ),
    }
    # Library yardstick on the same inputs ([B, H, T, D] views).
    qt, kt, vt = (
        x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)
    )
    times["fwd_library"] = median_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale
        )
    )
    out = F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale
    )
    dot = do.transpose(1, 2)
    times["bwd_library"] = median_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    )
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = attention_bounds(b, t, h, d)
    times.update(
        fwd_bound=fwd_bound, fwd_bound_by=fwd_by,
        bwd_bound=bwd_bound, bwd_bound_by=bwd_by,
    )
    log(
        f"# times flash D{d} (ms, median, B={b} T={t} H={h} causal bf16): "
        + json.dumps(times)
    )
    return times


def norm_times(path: str) -> dict:
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import layer_norm as ln

    name, n, e, rms, bias = NORM_MAIN[path]
    x, r, g, b, dout = _norm_inputs(9, n, e)
    b = b if bias else None
    eps = 1e-6 if rms else 1e-5
    _, _, stats = ln._fwd_cuda(x, None, g, b, eps, rms)
    mu, rstd = stats
    kernels = {
        "fwd": lambda: ln._fwd_cuda(x, None, g, b, eps, rms),
        "add": lambda: ln._fwd_cuda(x, r, g, b, eps, rms),
        # the backward kernel and the sum of its dg/db partials
        "bwd": lambda: ln._bwd_cuda(dout, x, g, stats, rms, bias),
    }
    times = {
        "fwd_plain": median_ms(
            lambda: ln.layer_norm_fwd_ref(x, None, g, b, eps, rms)
        ),
        "add_plain": median_ms(
            lambda: ln.layer_norm_fwd_ref(x, r, g, b, eps, rms)
        ),
        "add_library": None,  # no single PyTorch call adds and norms
        "bwd_plain": median_ms(
            lambda: ln.layer_norm_bwd_ref(dout, x, g, mu, rstd, rms, bias)
        ),
    }
    for key, call in kernels.items():
        times[key] = median_ms(call)
        times[f"{key}_device"] = device_ms(call)
    # Library yardsticks on the same values (weights in x's dtype, as
    # the library's bf16 kernels take them).
    xl = x.detach().requires_grad_(True)
    gl = g.to(x.dtype).requires_grad_(True)
    bl = b.to(x.dtype).requires_grad_(True) if bias else None
    if rms:
        lib = lambda: F.rms_norm(xl, (e,), gl, eps)  # noqa: E731
    else:
        lib = lambda: F.layer_norm(xl, (e,), gl, bl, eps)  # noqa: E731
    times["fwd_library"] = median_ms(lib)
    times["fwd_library_device"] = device_ms(lib)
    out = lib()
    wrt = (xl, gl) + ((bl,) if bias else ())

    def lib_bwd():
        return torch.autograd.grad(out, wrt, dout, retain_graph=True)

    times["bwd_library"] = median_ms(lib_bwd)
    times["bwd_library_device"] = device_ms(lib_bwd)
    fwd, add, bwd = norm_bounds(n, e, bias)
    times.update(
        fwd_bound=fwd[0], fwd_bound_by=fwd[1],
        add_bound=add[0], add_bound_by=add[1],
        bwd_bound=bwd[0], bwd_bound_by=bwd[1],
    )
    log(f"# times norm {name} (ms, median, N={n} E={e} bf16): "
        + json.dumps(times))
    return times


def quant_bounds(n: int) -> dict:
    """Least times (ms) of each quantization kernel on n f32 values in
    1024-value blocks: quantize reads the values and writes the codes
    (1 byte a value at int8, half a byte at int4) and one f32 scale a
    block, dequantize the reverse; ~8 f32 operations a value to
    quantize, 2 to dequantize, over the f32 rate. Bytes bound them."""
    rows = -(-n // 1024)
    out = {}
    for key, code_bytes in (("8", rows * 1024), ("4", rows * 512)):
        moved = 4 * n + code_bytes + 4 * rows
        out[f"q{key}"] = _bound(moved, 8 * n, PEAK_F32_FLOPS)
        out[f"dq{key}"] = _bound(moved, 2 * n, PEAK_F32_FLOPS)
    return out


def _quant_kernels(x) -> dict:
    """key -> (kernel call, plain call) for the six kernel variants on
    x (the dequantize calls on x's own codes)."""
    import torch

    from dlrover_tpu_torch.ops import quantization as Q

    shape, f32, blk = tuple(x.shape), torch.float32, Q.KERNEL_BLOCK
    calls = {}
    for key, bits, signed in (
        ("8", 8, True), ("4s", 4, True), ("4u", 4, False),
    ):
        q, s, _ = Q._quantize_cuda(x, blk, bits, signed)
        if bits == 8:
            plain_q = functools.partial(Q.quantize_blockwise_plain, x)
            plain_dq = functools.partial(
                Q.dequantize_blockwise_plain, q, s, shape
            )
        else:
            plain_q = functools.partial(
                Q.quantize_blockwise_4bit_plain, x, blk, signed
            )
            plain_dq = functools.partial(
                Q.dequantize_blockwise_4bit_plain, q, s, shape, signed
            )
        calls[f"q{key}"] = (
            functools.partial(Q._quantize_cuda, x, blk, bits, signed), plain_q,
        )
        calls[f"dq{key}"] = (
            functools.partial(
                Q._dequantize_cuda, q, s, shape, bits, signed, f32
            ),
            plain_dq,
        )
    return calls


def quant_times() -> dict:
    """Each variant's median time at GPT-2's wte beside its plain
    version and its bound (q4 / dq4: the mean of the signed and unsigned
    variants, which a 4-bit step launches equally often), then one
    low-bit Adam step's launches over GPT-2's quantized leaves (quantize
    or dequantize of m and sqrt v for every leaf), back to back, beside
    their bound."""
    import torch

    leaves = gpt2_quantized_leaves()
    n = dict(leaves)["wte"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(n, generator=gen, device="cuda")
    bounds = quant_bounds(n)
    times = {}
    for key, (kernel, plain) in _quant_kernels(x).items():
        times[key] = median_ms(kernel)
        times[f"{key}_device"] = device_ms(kernel)
        times[f"{key}_plain"] = median_ms(plain, reps=5)
        times[f"{key}_library"] = None  # no single PyTorch call does it
        times[f"{key}_bound"], times[f"{key}_bound_by"] = (
            bounds[key.rstrip("su")]
        )
    for key in ("q4", "dq4"):
        for suffix in ("", "_device", "_plain", "_bound"):
            times[f"{key}{suffix}"] = (
                times[f"{key}s{suffix}"] + times[f"{key}u{suffix}"]
            ) / 2
        times[f"{key}_bound_by"] = times[f"{key}s_bound_by"]
        times[f"{key}_library"] = None
    del x
    # one step's launches back to back: m and sqrt(v) of every leaf
    calls = [
        _quant_kernels(torch.randn(n_leaf, generator=gen, device="cuda"))
        for _, n_leaf in leaves
    ]

    def step(*keys):
        return median_ms(lambda: [c[k][0]() for c in calls for k in keys])

    def bound(key):
        return 2 * sum(quant_bounds(n_leaf)[key][0] for _, n_leaf in leaves)

    times["step"] = {
        "adam8bit_quantize": step("q8", "q8"),
        "adam8bit_dequantize": step("dq8", "dq8"),
        "adam4bit_quantize": step("q4s", "q4u"),
        "adam4bit_dequantize": step("dq4s", "dq4u"),
        "adam8bit_quantize_bound": bound("q8"),
        "adam8bit_dequantize_bound": bound("dq8"),
        "adam4bit_quantize_bound": bound("q4"),
        "adam4bit_dequantize_bound": bound("dq4"),
        "leaves": len(leaves),
        "values": sum(n_leaf for _, n_leaf in leaves),
    }
    del calls
    log(
        f"# times quant wte (ms, median, n={n} f32, block 1024): "
        + json.dumps({k: v for k, v in times.items() if k != "step"})
    )
    log(
        f"# times quant gpt2 step (ms, median of a step's launches back "
        f"to back: m and sqrt v of {len(leaves)} leaves): "
        + json.dumps(times["step"])
    )
    free_memory()
    return times


def serve_times() -> dict:
    """The serving path's two kernel calls at their shapes: K1 at the
    lane prefill's (SERVE_RECT; library: SDPA with the explicit mask)
    and K3's RMSNorm on the decode step's 8 x 4096 rows (library:
    ``F.rms_norm``). Bounds: K1 reads q, k, v and writes o and the f32
    lse, and does 4 D operations on each visible (query, key) pair; K3
    as ``norm_bounds``."""
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import layer_norm as ln

    s = SERVE_RECT
    q, k, v, scale = _serve_rect_inputs(151)
    off, tq, tk, h, d = s["q_offset"], s["tq"], s["tk"], s["h"], s["d"]

    def fwd():
        return fa._fwd_cuda(q, k, v, True, scale, None, off)

    mask = fa.attention_mask(tq, tk, True, None, off, q.device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = h * (tq * off + tq * (tq + 1) // 2)
    bound, by = _bound(
        (2 * tq + 2 * tk) * h * d * 2 + h * tq * 4, 4 * d * pairs
    )
    rect = {
        "fwd": median_ms(fwd), "fwd_device": device_ms(fwd),
        "fwd_plain": median_ms(
            lambda: fa.flash_attention_ref(q, k, v, True, scale, None, off),
            reps=5,
        ),
        "fwd_library": median_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale
            )
        ),
        "fwd_bound": bound, "fwd_bound_by": by,
    }
    log("# times flash serve_rect (ms, median, B=1 Tq=512 Tk=2048 "
        "q_offset=1536 H=32 D=128 bf16): " + json.dumps(rect))
    name, n, e, rms, _ = SERVE_NORM
    x, _, g, _, _ = _norm_inputs(10, n, e)
    eps = 1e-5  # Llama's rms_eps

    def norm():
        return ln._fwd_cuda(x, None, g, None, eps, True)

    gl = g.to(x.dtype)
    bound = norm_bounds(n, e, False)[0]
    norm_t = {
        "fwd": median_ms(norm), "fwd_device": device_ms(norm),
        "fwd_plain": median_ms(
            lambda: ln.layer_norm_fwd_ref(x, None, g, None, eps, True)
        ),
        "fwd_library": median_ms(lambda: F.rms_norm(x, (e,), gl, eps)),
        "fwd_bound": bound[0], "fwd_bound_by": bound[1],
    }
    log(f"# times norm {name} (ms, median, N={n} E={e} bf16): "
        + json.dumps(norm_t))
    return {"serve_rect": rect, "serve_norm": norm_t}


def phase_times(res: dict) -> None:
    res["times"] = {
        "flash64": flash_times(64),
        "flash128": flash_times(128),
        "norm_gpt2": norm_times("gpt2"),
        "norm_llama": norm_times("llama"),
        "quant": quant_times(),
        **serve_times(),
    }


# ---------------------------------------------------------------------------
# phase 4: the GPT-2 training path
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import layer_norm as ln
    from dlrover_tpu_torch.ops import quantization as qz

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    ln.reset_launch_counts()
    qz.reset_launch_counts()


def read_counts() -> dict:
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import layer_norm as ln
    from dlrover_tpu_torch.ops import quantization as qz

    torch.cuda.synchronize()
    return {
        "flash_fwd": fa.FWD_LAUNCHES, "flash_bwd": fa.BWD_LAUNCHES,
        "norm_fwd": ln.FWD_LAUNCHES, "norm_bwd": ln.BWD_LAUNCHES,
        "quant": qz.QUANT_LAUNCHES, "dequant": qz.DEQUANT_LAUNCHES,
    }


GPT2_ARGS = [
    "--model", "gpt2", "--global-batch-size", "16",
    "--micro-batch-size", "8", "--seed", "0",
]


def phase_train(res: dict) -> None:
    from dlrover_tpu_torch.examples.nanogpt import train

    common = GPT2_ARGS
    steps = 4
    reset_counts()
    run = train.run(train.parse_args(common + ["--steps", str(steps)]))
    launches = read_counts()
    del run["opt_state"]
    res["launches_gpt2"] = launches
    losses = run["losses"]
    log(
        f"# train gpt2: losses {losses} | step_s {run['step_s']} | "
        f"tokens/s {run['tokens_per_s']:.1f} (steps 2..{steps}) | "
        f"accum {run['accum_steps']} | launches {launches} | "
        f"peak_mem_GiB {run['peak_mem_gib']:.2f}"
    )
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(
        abs(losses[0] - math.log(50304)) <= 0.1,
        f"first loss {losses[0]} is not ln(50304) within 0.1",
    )
    layers, accum = 12, run["accum_steps"]
    per = layers * accum * steps
    # Full remat runs each layer's forward twice per microbatch; each
    # layer has two norms (ln1, and ln2 with the residual add).
    want = {"flash_fwd": 2 * per, "flash_bwd": per,
            "norm_fwd": 4 * per, "norm_bwd": 2 * per}
    check(
        all(launches[k] >= n for k, n in want.items()),
        f"kernel launches {launches} below {want} over {steps} steps x "
        f"{accum} microbatches x {layers} layers",
    )
    ref = train.run(train.parse_args(
        common + ["--steps", "1", "--attention", "dense", "--norm", "plain"]
    ))
    del ref["opt_state"]
    diff = abs(ref["losses"][0] - losses[0])
    log(
        f"# train gpt2 dense attention, plain norm: first loss "
        f"{ref['losses'][0]} vs kernels {losses[0]} (|diff| {diff:.3e}, "
        f"tol {LOSS_TOL})"
    )
    check(diff <= LOSS_TOL, "first loss differs from the plain path")
    res["train"] = run


# ---------------------------------------------------------------------------
# phase 5: the elastic launch, a kill and a restart
# ---------------------------------------------------------------------------

ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_KILL = 8, 3, 4
ELASTIC_TIMEOUT_S = 600
# Installed through PYTHONPATH for the launcher's processes only: reports
# every process it runs in, and every module of jax or the JAX package
# that such a process loads (found on the path, so the import succeeds).
IMPORT_AUDIT = r"""
import importlib.abc, importlib.machinery, importlib.util, os, sys

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dlrover_tpu")


class _Audit(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if not any(name == f or name.startswith(f + ".")
                   for f in _FORBIDDEN):
            return None
        for finder in sys.meta_path:
            if finder is self or not hasattr(finder, "find_spec"):
                continue
            spec = finder.find_spec(name, path, target)
            if spec is not None:
                sys.stderr.write(f"IMPORT_AUDIT_LOADED {os.getpid()} {name}\n")
                sys.stderr.flush()
                return spec
        return None


sys.meta_path.insert(0, _Audit())
sys.stderr.write(f"IMPORT_AUDIT_ON {os.getpid()}\n")
_here = os.path.dirname(os.path.abspath(__file__))
_next = importlib.machinery.PathFinder.find_spec(
    "sitecustomize",
    [p for p in sys.path if os.path.abspath(p or ".") != _here],
)
if _next is not None:  # the interpreter's own sitecustomize, if any
    _mod = importlib.util.module_from_spec(_next)
    _next.loader.exec_module(_mod)
"""
STEP_LINE = re.compile(
    r"step (\d+): loss (\S+) (\S+) s [^\n]*? batch_sum (-?\d+) rank (\d+) "
    r"restart (\d+) at (\S+)"
)
RECORD_LINE = re.compile(r"(ckpt_\w+|killing|launches) (\{.*\})")


def _elastic_run(work: str) -> dict:
    """Run the launcher once; its exit code, output, steps and records."""
    audit = os.path.join(work, "audit")
    os.makedirs(audit)
    with open(os.path.join(audit, "sitecustomize.py"), "w") as f:
        f.write(IMPORT_AUDIT)
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": os.pathsep.join(
            [audit, REPO] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p]),
        "DLROVER_TPU_JOB_NAME": f"smoke{uuid.uuid4().hex[:8]}",
        "DLROVER_TPU_PHASES_FILE": os.path.join(work, "phases.json"),
        "DLROVER_TPU_KILL_AT_STEP": str(ELASTIC_KILL),
        "DLROVER_TPU_KILL_RANK": "0",
    })
    cmd = [
        sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
        "--standalone", "--nproc_per_node", "1",
        "-m", "dlrover_tpu_torch.examples.nanogpt.train", "--",
        *GPT2_ARGS, "--steps", str(ELASTIC_STEPS),
        "--checkpoint-every", str(ELASTIC_EVERY),
        "--checkpoint-dir", os.path.join(work, "ckpt"), "--checksums",
    ]
    log(f"# elastic: {' '.join(cmd[1:])}")
    t0 = time.time()
    proc = subprocess.Popen(
        cmd, cwd=work, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=ELASTIC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise SmokeFailure(
            f"elastic launcher timed out:\n{out[-3000:]}\n{err[-3000:]}"
        )
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    steps = [
        dict(step=int(m[1]), loss=float(m[2]), step_s=float(m[3]),
             batch_sum=int(m[4]), rank=int(m[5]), restart=int(m[6]),
             at=float(m[7]))
        for m in STEP_LINE.finditer(out)
    ]
    records: dict = {}
    for m in RECORD_LINE.finditer(out):
        records.setdefault(m[1], []).append(json.loads(m[2]))
    for line in out.splitlines():  # the launcher's output, checksums cut
        log(f"#   | {line[:240]}")
    phases = {}
    if os.path.exists(env["DLROVER_TPU_PHASES_FILE"]):
        with open(env["DLROVER_TPU_PHASES_FILE"]) as f:
            phases = json.load(f)
    return dict(rc=proc.returncode, out=out, err=err, steps=steps,
                records=records, phases=phases, wall_s=time.time() - t0)


def _log_time(text: str, needle: str):
    """Epoch seconds of the first log line holding ``needle``, or None
    (log lines start with the local ``[YYYY-MM-DD HH:MM:SS,mmm]``)."""
    import datetime

    for line in text.splitlines():
        if needle in line and line.startswith("[20"):
            stamp = line[1:24]
            return datetime.datetime.strptime(
                stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp()
    return None


def phase_elastic(res: dict) -> None:
    free_memory()
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        run = _elastic_run(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tail = f"\n{run['out'][-4000:]}\n{run['err'][-4000:]}"
    check(run["rc"] == 0, f"elastic launcher exited {run['rc']}{tail}")
    steps, rec = run["steps"], run["records"]
    first = [s for s in steps if s["restart"] == 0]
    second = [s for s in steps if s["restart"] == 1]
    check(
        {s["restart"] for s in steps} == {0, 1}
        and [s["step"] for s in first] == list(range(1, ELASTIC_KILL + 1))
        and [s["step"] for s in second]
        == list(range(ELASTIC_EVERY + 1, ELASTIC_STEPS + 1)),
        f"want steps 1..{ELASTIC_KILL}, one restart, then steps "
        f"{ELASTIC_EVERY + 1}..{ELASTIC_STEPS}; got "
        f"{[(s['step'], s['restart']) for s in steps]}{tail}",
    )
    killed = rec.get("killing", [])
    check(len(killed) == 1 and killed[0]["step"] == ELASTIC_KILL,
          f"want one kill at step {ELASTIC_KILL}, got {killed}")
    staged = {r["step"]: r for r in rec.get("ckpt_staged", [])}
    restored = rec.get("ckpt_restored", [])
    check(len(restored) == 1 and restored[0]["step"] == ELASTIC_EVERY,
          f"want one restore of step {ELASTIC_EVERY}, got {restored}")
    restored = restored[0]
    want_sums = staged[ELASTIC_EVERY]["checksums"]
    bad = sorted(k for k in want_sums
                 if restored["checksums"].get(k) != want_sums[k])
    check(not bad and restored["checksums"].keys() == want_sums.keys(),
          f"restored leaves differ from the staged step {ELASTIC_EVERY}: "
          f"{bad}")
    resumed, killed_step = second[0], first[-1]
    check(
        resumed["batch_sum"] == killed_step["batch_sum"],
        f"the first batch after the restore ({resumed['batch_sum']}) is not "
        f"the killed run's step-{ELASTIC_KILL} batch "
        f"({killed_step['batch_sum']})",
    )
    ref = res["train"]["losses"]
    losses = [(s["step"], s["restart"], s["loss"]) for s in steps]
    check(all(math.isfinite(l) for _, _, l in losses),
          f"non-finite loss {losses}")
    diffs = [
        (step, restart, abs(loss - ref[step - 1]))
        for step, restart, loss in losses if step <= len(ref)
    ]
    check(all(d <= LOSS_TOL for _, _, d in diffs),
          f"losses differ from phase train's by more than {LOSS_TOL}: "
          f"{diffs}")
    # The restarted trainer's counters (the killed one printed none), as
    # phase train counts them: full remat runs each layer's forward
    # twice a microbatch, and each layer has two norms.
    launches = {r["restart"]: r for r in rec.get("launches", [])}.get(1, {})
    per = 12 * res["train"]["accum_steps"] * len(second)
    want = {"flash_fwd": 2 * per, "flash_bwd": per,
            "norm_fwd": 4 * per, "norm_bwd": 2 * per}
    check(all(launches.get(k, 0) >= n for k, n in want.items()),
          f"restarted trainer's kernel launches {launches} below {want}")
    audited = set(re.findall(r"IMPORT_AUDIT_ON (\d+)", run["err"]))
    loaded = re.findall(r"IMPORT_AUDIT_LOADED (\d+) (\S+)", run["err"])
    # launcher (the agent), master, and one trainer an incarnation
    check(len(audited) >= 4, f"import audit ran in {len(audited)} "
          "processes, want the launcher, the master and two trainers")
    check(not loaded, f"modules of jax or dlrover_tpu loaded: {loaded}")
    tokens = 16 * 1024  # GPT2_ARGS' global batch x T
    tok_s = {
        "killed run, steps 2..4": tokens * (len(first) - 1)
        / sum(s["step_s"] for s in first[1:]),
        "restarted run, steps 5..8": tokens * (len(second) - 1)
        / sum(s["step_s"] for s in second[1:]),
    }
    persisted = rec.get("ckpt_persisted", [{}])[-1]
    marks = run["phases"]
    kill_t = killed[0]["time"]
    # Recovery, from the agent's and the master's logs (their clock is
    # this host's) and the restarted trainer's phase marks: the agent
    # notices the exit, stops the group, collects forensics and tells the
    # master, flushes the staged checkpoint, joins a new rendezvous and
    # spawns; the new process starts the interpreter and imports, joins
    # NCCL, builds the model, restores, and takes its first step.
    flush = re.findall(r"checkpoint flush before restart took (\S+) s",
                       run["err"])
    agent = {
        "noticed": _log_time(run["err"], "exited with code"),
        "reported": _log_time(run["err"], "training process failed"),
        "flushed": _log_time(run["err"], "checkpoint flush before restart"),
        "spawned": _log_time(run["err"], "restart=1)"),
    }
    recovery = {"total": resumed["at"] - kill_t}
    if flush and all(agent.values()):
        flush_start = agent["flushed"] - float(flush[0])
        recovery.update(
            kill_to_noticed=agent["noticed"] - kill_t,
            noticed_to_master_told=agent["reported"] - agent["noticed"],
            master_told_to_flush_start=flush_start - agent["reported"],
            flush=float(flush[0]),
            flush_end_to_spawn=agent["spawned"] - agent["flushed"],
            spawn_to_proc_start=marks.get("proc_start", 0.0)
            - agent["spawned"],
        )
    order = ["proc_start", "dist_ready", "built", "restore_done",
             "first_step_done"]
    for a, b in zip(order, order[1:]):
        if a in marks and b in marks:
            recovery[f"{a}_to_{b}"] = marks[b] - marks[a]
    res["elastic"] = dict(
        stage_s={k: v["stage_s"] for k, v in staged.items()},
        persist_s=persisted.get("wait_s"),
        flush_s=[float(x) for x in flush],
        restore_s=restored["restore_s"], restore_source=restored["source"],
        recovery_s=recovery, tokens_per_s=tok_s,
        launches=launches, wall_s=run["wall_s"],
    )
    log(
        f"# elastic gpt2: losses {losses} | |loss - train| {diffs} (tol "
        f"{LOSS_TOL}) | resumed at step {resumed['step']} from step "
        f"{restored['step']} ({restored['source']}), batch_sum "
        f"{resumed['batch_sum']} | launches after restart "
        f"{launches} | import audit: {len(audited)} processes, "
        f"none loaded jax or dlrover_tpu"
    )
    log(
        f"# elastic times ({res['card']}): device->shm stage blocking s by "
        f"step {res['elastic']['stage_s']} | agent persist (trainer's wait "
        f"from staging step {persisted.get('step')} to its commit) s "
        f"{persisted.get('wait_s')} | agent flush before restart s {flush} "
        f"| restore s {restored['restore_s']} ({restored['source']}) | "
        f"recovery s {recovery} | tokens/s {tok_s} vs phase train "
        f"{res['train']['tokens_per_s']:.1f} | launcher wall s "
        f"{run['wall_s']:.1f}"
    )


# ---------------------------------------------------------------------------
# phase 6: GPT-2 with the low-bit optimizers
# ---------------------------------------------------------------------------


def phase_train_low_bit(res: dict) -> None:
    from dlrover_tpu_torch.examples.nanogpt import train
    from dlrover_tpu_torch.optim.low_bit import optimizer_state_bytes

    steps = 4
    adamw = res["train"]["losses"]
    per_step = 2 * len(gpt2_quantized_leaves())  # m and sqrt(v) a leaf
    res["low_bit"] = {}
    for name in ("adam8bit", "adam4bit"):
        args = GPT2_ARGS + ["--steps", str(steps), "--optimizer", name]
        free_memory()
        reset_counts()
        run = train.run(train.parse_args(args))
        launches = read_counts()
        actual, f32_equiv = optimizer_state_bytes(run.pop("opt_state"))
        ratio = actual / f32_equiv
        losses = run["losses"]
        log(
            f"# train gpt2 {name}: losses {losses} | step_s "
            f"{run['step_s']} | tokens/s {run['tokens_per_s']:.1f} (steps "
            f"2..{steps}) | launches {launches} | peak_mem_GiB "
            f"{run['peak_mem_gib']:.2f} | state bytes {actual:,} of "
            f"{f32_equiv:,} f32-equivalent ({ratio:.4f}) | loss - adamw "
            f"{[a - b for a, b in zip(losses, adamw)]}"
        )
        check(
            all(math.isfinite(x) for x in losses), f"non-finite loss {losses}"
        )
        check(
            abs(losses[0] - adamw[0]) <= LOSS_TOL,
            f"{name}'s first loss {losses[0]} is not phase train's "
            f"{adamw[0]} within {LOSS_TOL}",
        )
        check(losses[-1] < losses[0], f"{name}'s loss did not fall: {losses}")
        want = {"quant": per_step * (steps + 1), "dequant": per_step * steps}
        check(
            all(launches[k] >= n for k, n in want.items()),
            f"quantization launches {launches} below {want}: {per_step} "
            f"a step over {steps} steps, and {per_step} at init",
        )
        check(
            ratio <= STATE_RATIO_MAX[name],
            f"{name}'s state is {ratio:.4f} of f32 moments, above "
            f"{STATE_RATIO_MAX[name]}",
        )
        free_memory()
        plain = train.run(train.parse_args(args + ["--quant", "plain"]))
        del plain["opt_state"]
        diffs = [abs(a - b) for a, b in zip(plain["losses"], losses)]
        log(
            f"# train gpt2 {name} plain quantizers: losses "
            f"{plain['losses']} | |diff| {diffs} (tol {LOW_BIT_LOSS_TOL})"
        )
        check(
            len(diffs) == steps and max(diffs) <= LOW_BIT_LOSS_TOL,
            f"{name}'s losses differ from the plain quantizers' run",
        )
        run.update(launches=launches, state_bytes=[actual, f32_equiv])
        res["low_bit"][name] = run
    free_memory()


# ---------------------------------------------------------------------------
# phase 7: the Llama-2-7B LoRA path
# ---------------------------------------------------------------------------


def phase_train_llama_lora(res: dict) -> None:
    from dlrover_tpu_torch.examples.llama_lora import train
    from dlrover_tpu_torch.models import llama

    common = ["--preset", "7b", "--batch", "2"]
    steps = 4
    free_memory()
    reset_counts()
    run = train.run(train.parse_args(common + ["--steps", str(steps)]))
    launches = read_counts()
    res["launches_llama"] = launches
    losses = run["losses"]
    tokens_per_s = run["tokens_per_s"]
    tflops = tokens_per_s * run["flops_per_token"] / 1e12
    log(
        f"# train llama2-7b lora: losses {losses} | step_s {run['step_s']} "
        f"| tokens/s {tokens_per_s:.1f} (steps 2..{steps}) | TFLOP/s "
        f"{tflops:.1f} by llama.flops_per_token "
        f"({run['flops_per_token'] / 1e9:.3f} GFLOP/token) | launches "
        f"{launches} | peak_mem_GiB {run['peak_mem_gib']:.2f} | base "
        f"{run['n_params']:,} trainable {run['n_trainable']:,}"
    )
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(run["base_unchanged"], "the frozen base weights changed")
    check(run["lora_b_nonzero"], "a LoRA b is still zero after training")
    layers = llama.LlamaConfig.llama2_7b().n_layer
    per = layers * steps
    # The first block's first norm takes the embedding of the frozen
    # wte and its gain is frozen: nothing upstream of it takes a
    # gradient, so autograd skips its backward (2 L - 1 a step).
    want = {"flash_fwd": 2 * per, "flash_bwd": per,
            "norm_fwd": 4 * per, "norm_bwd": (2 * layers - 1) * steps}
    check(
        all(launches[k] >= n for k, n in want.items()),
        f"kernel launches {launches} below {want} over {steps} steps x "
        f"{layers} layers",
    )
    run["tflops"] = tflops
    res["train_llama"] = run
    free_memory()
    ref = train.run(train.parse_args(
        common + ["--steps", "1", "--attention", "dense", "--norm", "plain"]
    ))
    diff = abs(ref["losses"][0] - losses[0])
    log(
        f"# train llama2-7b lora dense attention, plain norm: first loss "
        f"{ref['losses'][0]} vs kernels {losses[0]} (|diff| {diff:.3e}, "
        f"tol {LOSS_TOL}) | peak_mem_GiB {ref['peak_mem_gib']:.2f}"
    )
    check(diff <= LOSS_TOL, "first loss differs from the plain path")


# ---------------------------------------------------------------------------
# phase 8: serving Llama-2-7B through the port's control plane
# ---------------------------------------------------------------------------

SERVE = dict(lanes=8, max_len=4096, block_size=16, prefill_chunk=512)
SERVE_REQUESTS, SERVE_SAMPLED, SERVE_NEW = 16, 2, 32
SERVE_PROMPT = (64, 3000)  # prompt lengths, drawn from a seeded generator
SERVE_TIMEOUT_S = 300
# Logits of a serving program against the training forward
# (``llama.forward``, K1/K3) on the same tokens. Per compared row:
#   max|got - ref| <= ATOL * rms(ref),  rms(got - ref) <= RMS * rms(ref).
# The prefills run the forward's kernels on GEMMs of hundreds of rows
# and agree to ~3e-5 of rms on the H100; their limits are
# SERVE_LOGIT_ATOL and SERVE_LOGIT_RMS. The decode step's GEMMs have 8
# rows (a row a lane) where the forward's have thousands: cuBLAS runs
# other kernels, every bf16 projection rounds differently, and with
# random weights the gap compounds with depth (NVIDIA H100 80GB HBM3,
# 700 W, by tools/decode_gap.py: rms of the gap 0.6-0.7% at 1 layer,
# 1.3-1.5% at 4, 4.2-5.2% at 32, 3.6-4.4% with the plain norm and
# attention on both sides; this phase reads 4.7-5.4%); its limits are
# SERVE_DECODE_ATOL and SERVE_DECODE_RMS. Logits of a wrong position,
# mask or cache slot are off by O(rms) (the must-fail comparisons:
# 1.4x rms).
SERVE_LOGIT_ATOL = 2.0 ** -2
SERVE_LOGIT_RMS = 2.0 ** -5
SERVE_DECODE_ATOL = 2.0 ** -1
SERVE_DECODE_RMS = 2.0 ** -3
# A greedy GPT-2 token that is not the teacher-forced forward's argmax
# must lie within this share of the row's logit rms of that argmax:
# random weights give near-ties, which the decode steps' rounding (as
# above, 12 layers) may flip; a wrong decode gives gaps of O(rms).
GEN_MARGIN = 2.0 ** -2
GEN = dict(batch=4, prompt=512, new=64)


def _pct(xs, q):
    """Nearest-rank percentile (q in [0, 100])."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)] if xs else 0.0


def _logit_err(got, ref):
    """(max abs error and rms error, each over rms(ref)), the worst row."""
    got, ref = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(
        -1, ref.shape[-1])
    rms = ref.square().mean(-1).sqrt()
    diff = got - ref
    worst = (diff.abs().amax(-1) / rms).max().item()
    rms_err = (diff.square().mean(-1).sqrt() / rms).max().item()
    return worst, rms_err


def _logits_within(err, atol=SERVE_LOGIT_ATOL, rms=SERVE_LOGIT_RMS) -> bool:
    return err[0] <= atol and err[1] <= rms


def _serve_tokens(seed: int, n: int, vocab: int, lo: int, hi: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
        for _ in range(n)
    ]


def serve_logit_checks(params, cfg) -> dict:
    """The serving programs' logits against ``llama.forward`` on the
    same tokens, each held to the SERVE_LOGIT limits: the lane-chunk
    prefill chunk by chunk (a 1300-token prompt in lane 3 of an 8-lane
    cache: chunks of 512, 512 and a final 276 padded to 512), with a
    must-fail comparison of chunk 2 against chunk 1's rows;
    ``llama_prefill_chunked`` (chunk 1024) on a 4096-token prompt, its
    last logits; and 8 ragged decode steps, teacher-forced, with the 8
    lanes at positions 100..1500 apart."""
    import dataclasses

    import torch

    from dlrover_tpu_torch.models import generate, llama

    ref_cfg = dataclasses.replace(cfg, remat=False)
    dev = params["wte"].device
    out = {}
    chunk, lanes = SERVE["prefill_chunk"], SERVE["lanes"]
    rope = llama.rope_table(cfg, 4096, dev)
    with torch.no_grad():
        # lane-chunk prefill
        (prompt,) = _serve_tokens(21, 1, cfg.vocab_size, 1300, 1300)
        toks = torch.tensor([prompt], device=dev)
        ref = llama.forward(params, toks, ref_cfg)[0]
        cache = generate._cache_for(cfg, lanes, 4096, cfg.n_kv_head, dev)
        errs = []
        for start in range(0, len(prompt), chunk):
            c = min(chunk, len(prompt) - start)
            buf = torch.zeros(1, chunk, dtype=torch.long, device=dev)
            buf[0, :c] = toks[0, start:start + c]
            logits, cache = generate.llama_lane_prefill_chunk(
                params, cache, buf, 3, start, cfg, rope=rope
            )
            errs.append(_logit_err(logits[0, :c], ref[start:start + c]))
            if start == chunk:
                wrong = _logit_err(logits[0, :c], ref[:c])
        log(
            "# serve logits lane prefill vs forward (chunks of 512, the "
            f"last padded): {[(round(a, 5), round(b, 5)) for a, b in errs]}"
            f" | chunk 2 held to chunk 1's rows (must fail): "
            f"({wrong[0]:.4f}, {wrong[1]:.4f})"
        )
        check(all(_logits_within(e) for e in errs),
              "lane prefill logits disagree with the forward")
        check(not _logits_within(wrong),
              "the serving logit limits pass logits of other positions")
        out["lane_prefill"] = max(max(e) for e in errs)
        del ref, cache
        free_memory()
        # chunked prefill, last logits
        (long_prompt,) = _serve_tokens(22, 1, cfg.vocab_size, 4096, 4096)
        toks = torch.tensor([long_prompt], device=dev)
        ref = llama.forward(params, toks, ref_cfg)[0, -1]
        cache = generate._cache_for(cfg, 1, 4096, cfg.n_kv_head, dev)
        last, cache = generate.llama_prefill_chunked(
            params, cache, toks, cfg, chunk_size=1024, rope=rope
        )
        err = _logit_err(last[0], ref)
        log(f"# serve logits chunked prefill (4096, chunk 1024) last row "
            f"vs forward: ({err[0]:.5f}, {err[1]:.5f})")
        check(_logits_within(err),
              "chunked prefill logits disagree with the forward")
        out["chunked_prefill"] = max(err)
        del ref, cache, last
        free_memory()
        # ragged decode, teacher-forced
        steps = 8
        lens = [100 + 200 * i for i in range(lanes)]
        seqs = [
            _serve_tokens(30 + i, 1, cfg.vocab_size, n + steps, n + steps)[0]
            for i, n in enumerate(lens)
        ]
        cache = generate._cache_for(cfg, lanes, 2048, cfg.n_kv_head, dev)
        for lane, (n, seq) in enumerate(zip(lens, seqs)):
            for start in range(0, n, chunk):
                c = min(chunk, n - start)
                buf = torch.zeros(1, chunk, dtype=torch.long, device=dev)
                buf[0, :c] = torch.tensor(seq[start:start + c])
                generate.llama_lane_prefill_chunk(
                    params, cache, buf, lane, start, cfg, rope=rope
                )
        got = []
        for s in range(steps):
            token = torch.tensor([seq[n + s] for n, seq in zip(lens, seqs)],
                                 device=dev)
            pos = torch.tensor([n + s for n in lens], device=dev)
            logits, cache = generate.llama_decode_step_ragged(
                params, cache, token, pos, cfg, rope=rope,
                active=torch.ones(lanes, dtype=torch.bool, device=dev),
            )
            got.append(logits)
        errs, wrong = [], []
        for lane, (n, seq) in enumerate(zip(lens, seqs)):
            ref = llama.forward(
                params, torch.tensor([seq], device=dev), ref_cfg
            )[0, n - 1:n + steps]
            lane_logits = torch.stack([g[lane] for g in got])
            errs.append(_logit_err(lane_logits, ref[1:]))
            wrong.append(_logit_err(lane_logits, ref[:-1]))
        wrong = min(wrong)
        log("# serve logits ragged decode (8 lanes at 100..1500, 8 steps) "
            f"vs forward: {[(round(a, 5), round(b, 5)) for a, b in errs]}"
            " | held to the rows one position back (must fail): "
            f"({wrong[0]:.4f}, {wrong[1]:.4f})")
        decode_limits = (SERVE_DECODE_ATOL, SERVE_DECODE_RMS)
        check(all(_logits_within(e, *decode_limits) for e in errs),
              "ragged decode logits disagree with the forward")
        check(not _logits_within(wrong, *decode_limits),
              "the decode logit limits pass logits one position back")
        out["ragged_decode"] = max(max(e) for e in errs)
        del cache, got
    free_memory()
    log(f"# serve logit limits per row: prefill max|err| <= "
        f"{SERVE_LOGIT_ATOL} rms(ref), rms(err) <= {SERVE_LOGIT_RMS} "
        f"rms(ref); decode {SERVE_DECODE_ATOL} and {SERVE_DECODE_RMS}")
    return out


def _serve_master():
    from dlrover_tpu_torch.master.master import JobMaster

    master = JobMaster(
        port=0, node_num=1, rdzv_timeout=1.0, heartbeat_timeout=120.0,
        monitor_interval=0.5, collect_interval=999.0,
        health_interval=9999.0,
        remediation_config={"interval_s": 9999.0},
        serving_config={"progress_timeout_s": 120.0,
                        "scale_cooldown_s": 9999.0},
    )
    master.prepare()
    return master


def _await_replicas(master, n: int, timeout_s: float, proc=None) -> None:
    deadline = time.monotonic() + timeout_s
    while sum(
        r["state"] == "ready" for r in master.serving.snapshot()["replicas"]
    ) < n:
        check(time.monotonic() < deadline,
              f"{n} replica(s) did not register in {timeout_s} s")
        check(proc is None or proc.poll() is None,
              "the replica process exited before it registered")
        time.sleep(0.1)


def _serve_requests(params_vocab: int) -> list:
    """(request id, prompt, temperature) of the 16 served requests."""
    prompts = _serve_tokens(8, SERVE_REQUESTS, params_vocab, *SERVE_PROMPT)
    return [
        (f"s{i}", p, 0.8 if i >= SERVE_REQUESTS - SERVE_SAMPLED else 0.0)
        for i, p in enumerate(prompts)
    ]


def _await_results(client, ids, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        results = {rid: client.serve_result(rid) for rid in ids}
        if all(r.state in ("done", "failed") for r in results.values()):
            return results
        check(time.monotonic() < deadline,
              f"requests unfinished after {timeout_s} s: " + str({
                  k: r.state for k, r in results.items()
                  if r.state != "done"}))
        time.sleep(0.2)


def serve_mixed(params, cfg, res: dict) -> tuple:
    """The 16 requests through the port's JobMaster, its ServingRouter
    and one mixed-role ReplicaWorker; the launch counts of this run."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.serving.replica import ReplicaWorker

    master = _serve_master()
    worker = ReplicaWorker(
        master.addr, 0, params, cfg, pull_batch=SERVE["lanes"], **SERVE
    )
    client = MasterClient(master.addr, node_id=-1)
    try:
        worker.start()
        _await_replicas(master, 1, 60)
        reqs = _serve_requests(cfg.vocab_size)
        reset_counts()
        t0 = time.perf_counter()
        for rid, prompt, temp in reqs:
            check(client.serve_submit(
                prompt, max_new_tokens=SERVE_NEW, temperature=temp,
                request_id=rid,
            ).accepted, f"request {rid} refused")
        results = _await_results(client, [r[0] for r in reqs],
                                 SERVE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        launches = read_counts()
        stats = worker.scheduler.stats()
    finally:
        worker.stop()
        client.close()
        master.stop()
    for rid, prompt, temp in reqs:
        r = results[rid]
        check(r.state == "done" and r.finish_reason == "length"
              and len(r.tokens) == SERVE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {rid} ended {r.state}/{r.finish_reason} "
              f"{r.error} with {len(r.tokens)} tokens")
    chunk = SERVE["prefill_chunk"]
    chunks = sum(-(-len(p) // chunk) for _, p, _ in reqs)
    decode_ticks = -(-SERVE_REQUESTS * (SERVE_NEW - 1) // SERVE["lanes"])
    want = {"flash_fwd": cfg.n_layer * chunks,
            "norm_fwd": 2 * cfg.n_layer * (chunks + decode_ticks)}
    log(f"# serve llama2-7b mixed: {SERVE_REQUESTS} requests "
        f"({sum(len(p) for _, p, _ in reqs)} prompt tokens in {chunks} "
        f"chunks, {SERVE_NEW} new each, {SERVE_SAMPLED} at temperature "
        f"0.8) in {wall:.2f} s | launches {launches} (at least {want}) | "
        "scheduler " + json.dumps({k: stats[k] for k in (
            "steps", "preempted_total", "completed_total",
            "tokens_generated")}))
    check(all(launches[k] >= n for k, n in want.items()),
          f"serving launches {launches} below {want}")
    ttft = [results[r[0]].ttft_s for r in reqs]
    tpot = [results[r[0]].tpot_s for r in reqs]
    latency = [results[r[0]].latency_s for r in reqs]
    res["serve"] = {
        "wall_s": wall, "launches": launches,
        "ttft_p50_s": _pct(ttft, 50), "ttft_p99_s": _pct(ttft, 99),
        "tpot_p50_s": _pct(tpot, 50), "tpot_p99_s": _pct(tpot, 99),
        "latency_p50_s": _pct(latency, 50), "latency_p99_s": _pct(latency, 99),
    }
    greedy = {rid: results[rid].tokens for rid, _, t in reqs if t == 0.0}
    return worker.scheduler, reqs, greedy


def serve_disaggregated(params, cfg, reqs, greedy, res: dict) -> None:
    """The greedy requests again through a prefill-role and a
    decode-role ReplicaWorker sharing the parameter tensors; their
    tokens must equal the mixed leg's bitwise. At 7B a handoff carries
    512 KiB of KV a prompt token (up to ~1.5 GB here), past the RPC's
    256 MB message cap and the router's 64 MB staging budget, so the
    payloads go from one scheduler to the other in this process; the
    first crosses the wire form (pack, unpack) and must come back
    bitwise."""
    import torch

    from dlrover_tpu_torch.serving import handoff
    from dlrover_tpu_torch.serving.replica import ReplicaWorker
    from dlrover_tpu_torch.serving.scheduler import ServeRequest

    kw = {k: v for k, v in SERVE.items() if k != "lanes"}
    pre = ReplicaWorker("127.0.0.1:1", 1, params, cfg, lanes=2,
                        role="prefill", **kw)
    dec = ReplicaWorker("127.0.0.1:1", 2, params, cfg, lanes=SERVE["lanes"],
                        role="decode", **kw)
    todo = [r for r in reqs if r[0] in greedy]
    for rid, prompt, _ in todo:
        pre.scheduler.submit(ServeRequest(
            request_id=rid, prompt=prompt, max_new_tokens=SERVE_NEW))
    done, nbytes, largest, wired = {}, 0, None, False
    t0 = time.perf_counter()
    for _ in range(20000):
        for c in pre.scheduler.step():
            check(c.finish_reason == "handoff", f"{c.request_id} {c.error}")
            p = c.handoff
            nbytes += p.nbytes()
            if largest is None or p.nbytes() > largest.nbytes():
                largest = p
            if not wired:
                back = handoff.unpack(handoff.pack(p))
                check(torch.equal(back.k.view(torch.int16),
                                  p.k.view(torch.int16))
                      and torch.equal(back.v.view(torch.int16),
                                      p.v.view(torch.int16)),
                      "a 7B handoff does not cross the wire form bitwise")
                p, wired = back, True
            dec.scheduler.submit_handoff(p)
        for c in dec.scheduler.step():
            done[c.request_id] = c
        if len(done) == len(todo):
            break
    wall = time.perf_counter() - t0
    same = sum(done[rid].tokens == greedy[rid] for rid, _, _ in todo)
    # The install of the largest payload, timed alone.
    dev = params["wte"].device
    sched = dec.scheduler
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k = torch.as_tensor(largest.k).to(dev, sched._cache.k.dtype)
    v = torch.as_tensor(largest.v).to(dev, sched._cache.v.dtype)
    sched._install_fn(sched._cache, k, v, 0)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t1
    log(f"# serve llama2-7b disaggregated (prefill lanes 2, decode lanes "
        f"{SERVE['lanes']}): {len(done)}/{len(todo)} done in {wall:.2f} s, "
        f"{same} bitwise equal to the mixed leg | handoff bytes {nbytes} "
        f"({nbytes / len(todo) / 2**20:.1f} MiB a request) | install of "
        f"the largest ({largest.nbytes() / 2**20:.1f} MiB, prompt "
        f"{largest.prompt_len}) {install_s * 1e3:.2f} ms host-to-device "
        "and copy")
    check(same == len(todo) == len(done),
          "disaggregated tokens differ from the mixed leg's")
    res["serve"].update(handoff_bytes=nbytes, install_ms=install_s * 1e3,
                        install_bytes=largest.nbytes())
    pre.client.close()
    dec.client.close()


def serve_rates(params, cfg, sched, res: dict) -> None:
    """Prefill tokens/s (a 4096-token prompt in chunks of 512 into one
    lane), decode tokens/s with all 8 lanes busy (at the served mix's
    positions, each step ending in its token copy, as the loop does),
    and the decode step's device busy share and time by kernel family
    (torch.profiler over 8 steps; busy = device time a step over the
    unprofiled step's wall time)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.trainer.profile import kernel_family

    dev = params["wte"].device
    chunk, lanes = SERVE["prefill_chunk"], SERVE["lanes"]
    (prompt,) = _serve_tokens(40, 1, cfg.vocab_size, 4096, 4096)
    toks = torch.tensor([prompt], device=dev)
    with torch.no_grad():
        def prefill_all():
            for start in range(0, 4096, chunk):
                sched._prefill_fn(params, sched._cache,
                                  toks[:, start:start + chunk], 0, start)
        prefill_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_all()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        rng = np.random.default_rng(41)
        pos = torch.tensor(rng.integers(*SERVE_PROMPT, size=lanes),
                           device=dev)
        token = torch.tensor(rng.integers(0, cfg.vocab_size, size=lanes),
                             device=dev)
        temps = torch.zeros(lanes, device=dev)
        active = torch.ones(lanes, dtype=torch.bool, device=dev)

        def step():
            tok, _ = sched._decode_fn(params, sched._cache, token, pos,
                                      temps, active)
            return tok.cpu()

        for _ in range(3):
            step()
        n = 16
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        step_s = (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                step()
        # The host's side: operators by self CPU time (the profiler's
        # own cost inflates it; the shares are what it shows).
        with profile(activities=[ProfilerActivity.CPU]) as host:
            for _ in range(4):
                step()
    fams, busy = {}, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.self_device_time_total / 1e3 / 8
            busy += t
            fams[kernel_family(e.key)] = fams.get(kernel_family(e.key), 0) + t
    ops = sorted(
        (e for e in host.key_averages() if e.key.startswith("aten::")),
        key=lambda e: -e.self_cpu_time_total,
    )
    host_ms = sum(e.self_cpu_time_total for e in ops) / 1e3 / 4
    top = {
        e.key: [e.count // 4, round(e.self_cpu_time_total / 1e3 / 4, 3)]
        for e in ops[:8]
    }
    calls = sum(e.count for e in ops) // 4
    log(f"# serve decode step host (profiled, a step): {calls} aten calls, "
        f"{host_ms:.3f} ms of their self time; the top [calls, ms]: "
        + json.dumps(top))
    res["serve"].update(
        prefill_tokens_per_s=4096 / prefill_s,
        decode_tokens_per_s=lanes / step_s, decode_step_ms=step_s * 1e3,
        decode_device_ms=busy, decode_busy_share=busy / (step_s * 1e3),
        decode_family_ms=fams,
    )
    log(f"# serve llama2-7b rates: prefill {4096 / prefill_s:.1f} tokens/s "
        f"(4096 tokens, chunks of {chunk}, one lane) | decode "
        f"{lanes / step_s:.1f} tokens/s (8 lanes busy, step "
        f"{step_s * 1e3:.3f} ms) | decode step device {busy:.3f} ms, "
        f"busy share {busy / (step_s * 1e3):.3f} | by family (ms): "
        + json.dumps({k: round(v, 4) for k, v in sorted(fams.items())}))


def serve_gpt2_generate(res: dict) -> None:
    """GPT-2 124M ``generate.generate``, greedy, prompt [4, 512], 64 new
    tokens, through K1 (prefill) and K3 (every block norm); each token
    the teacher-forced ``gpt.forward`` argmax, or within GEN_MARGIN x
    rms(row) of it."""
    import dataclasses

    import torch

    from dlrover_tpu_torch.models import generate, gpt

    cfg = gpt.GPTConfig.gpt2()
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (GEN["batch"], GEN["prompt"]),
                           generator=gen, device="cuda")
    t0 = time.perf_counter()
    out = generate.generate(params, cfg, prompt, GEN["new"], temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(out.shape == (GEN["batch"], GEN["prompt"] + GEN["new"]),
          f"generate returned {tuple(out.shape)}")
    with torch.no_grad():
        logits = gpt.forward(params, out[:, :-1],
                             dataclasses.replace(cfg, remat=False))
    rows = logits[:, GEN["prompt"] - 1:]
    new = out[:, GEN["prompt"]:]
    best = rows.argmax(-1)
    gap = rows.gather(-1, best[..., None]) - rows.gather(-1, new[..., None])
    rms = rows.square().mean(-1, keepdim=True).sqrt()
    share = (gap / rms).max().item()
    exact = int((best == new).sum())
    log(f"# serve gpt2 generate (greedy, prompt {GEN['batch']}x"
        f"{GEN['prompt']}, {GEN['new']} new) in {gen_s:.2f} s: {exact}/"
        f"{new.numel()} tokens the forward's argmax, the worst gap "
        f"{share:.5f} of the row's rms (limit {GEN_MARGIN})")
    check(share <= GEN_MARGIN, "generated tokens stray from the forward")
    res["serve"]["gpt2_exact"] = exact


def _spawn_tiny_replica(addr: str, work: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    log_path = os.path.join(work, "replica.log")
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.serving.replica",
             "--master", addr, "--replica_id", "1"],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT,
        )
    return proc, log_path


def serve_cli(master, proc, log_path) -> None:
    """``python -m dlrover_tpu_torch.serving.replica --master ...
    --replica_id 1``, its default tiny model on the card, answers 2
    requests through the master: the in-process ``generate``'s greedy
    tokens on the same seed's model."""
    import torch

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.models import generate
    from dlrover_tpu_torch.serving.replica import build_tiny_model

    client = MasterClient(master.addr, node_id=-1)
    try:
        _await_replicas(master, 1, 120, proc)
        prompts = {"cli-a": [5, 1, 7], "cli-b": [9, 9, 2, 4, 8, 3]}
        for rid, p in prompts.items():
            check(client.serve_submit(p, max_new_tokens=8,
                                      request_id=rid).accepted,
                  f"{rid} refused")
        results = _await_results(client, list(prompts), 120)
    finally:
        client.close()
    params, cfg = build_tiny_model(0, block_size=64, device="cuda")
    for rid, p in prompts.items():
        want = generate.generate(params, cfg, torch.tensor([p]).cuda(), 8,
                                 temperature=0.0)[0, len(p):].tolist()
        check(results[rid].state == "done" and results[rid].tokens == want,
              f"the replica CLI answered {rid} with {results[rid].tokens} "
              f"({results[rid].state} {results[rid].error}), want {want}")
    log(f"# serve replica CLI (tiny Llama on the card, pid {proc.pid}): "
        f"{len(prompts)} requests answered, greedy tokens the in-process "
        "generate's")


def phase_serve(res: dict) -> None:
    import torch

    from dlrover_tpu_torch.models import llama

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    cli_master = _serve_master()
    proc, log_path = _spawn_tiny_replica(cli_master.addr, work)
    try:
        cfg = llama.LlamaConfig.llama2_7b()
        params = llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"
        )
        res["serve_logits"] = serve_logit_checks(params, cfg)
        sched, reqs, greedy = serve_mixed(params, cfg, res)
        serve_rates(params, cfg, sched, res)
        del sched
        free_memory()
        serve_disaggregated(params, cfg, reqs, greedy, res)
        del params
        free_memory()
        serve_gpt2_generate(res)
        serve_cli(cli_master, proc, log_path)
    except BaseException:
        with open(log_path) as f:
            log("# replica CLI log tail:\n" + f.read()[-3000:])
        raise
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        cli_master.stop()
        shutil.rmtree(work, ignore_errors=True)
    s = res["serve"]
    s["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("# serve llama2-7b: " + json.dumps({
        k: s[k] for k in (
            "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
            "latency_p50_s", "latency_p99_s", "prefill_tokens_per_s",
            "decode_tokens_per_s", "decode_step_ms", "decode_device_ms",
            "decode_busy_share", "peak_mem_gib", "handoff_bytes",
            "install_ms", "launches")
    }))
    free_memory()


# ---------------------------------------------------------------------------


def kernels_line(res: dict) -> dict:
    times, errs = res["times"], res["max_abs_err"]
    flash_src = "dlrover_tpu_torch/csrc/flash_attention.cu"
    norm_src = "dlrover_tpu_torch/csrc/layer_norm.cu"
    entries = []

    def entry(name, src, replaces, launches, err, t, key):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": t[key],
            "device_ms": t[f"{key}_device"],
            "plain_ms": t[f"{key}_plain"],
            "bound_ms": t[f"{key}_bound"],
            "bound_by": t[f"{key}_bound_by"],
            "library_ms": t[f"{key}_library"],
        })

    for d, path in ((64, "gpt2"), (128, "llama")):
        launches = res[f"launches_{path}"]
        t = times[f"flash{d}"]
        entry(
            f"flash_attention_fwd D{d} ({path})", flash_src,
            "dlrover_tpu/ops/flash_attention.py:148",
            launches["flash_fwd"], errs[f"fwd{d}"], t, "fwd",
        )
        entry(
            f"flash_attention_bwd D{d} (dkdv + dq, {path})", flash_src,
            "dlrover_tpu/ops/flash_attention.py:299",
            launches["flash_bwd"], errs[f"bwd{d}"], t, "bwd",
        )
    for path in ("gpt2", "llama"):
        launches = res[f"launches_{path}"]
        t = times[f"norm_{path}"]
        label = NORM_MAIN[path][0]
        entry(
            f"layer_norm_fwd {label} ({path})", norm_src,
            "dlrover_tpu/ops/layer_norm.py:65", launches["norm_fwd"],
            errs[f"norm_fwd_{path}"], t, "fwd",
        )
        entry(
            f"layer_norm_bwd + dg/db sum {label} ({path})", norm_src,
            "dlrover_tpu/ops/layer_norm.py:88", launches["norm_bwd"],
            errs[f"norm_bwd_{path}"], t, "bwd",
        )
    served = res["serve"]["launches"]
    entry(
        "flash_attention_fwd rect D128 B1 tq512 tk2048 q_offset1536 "
        "(serve lane prefill)", flash_src,
        "dlrover_tpu/ops/flash_attention.py:148", served["flash_fwd"],
        errs["fwd128_serve"], times["serve_rect"], "fwd",
    )
    entry(
        f"layer_norm_fwd {SERVE_NORM[0]} (serve decode)", norm_src,
        "dlrover_tpu/ops/layer_norm.py:65", served["norm_fwd"],
        errs["norm_fwd_serve"], times["serve_norm"], "fwd",
    )
    quant_src = "dlrover_tpu_torch/csrc/quantization.cu"
    q_file = "dlrover_tpu/ops/quantization.py"
    # name, optimizer, counter, times key, error keys, TPU kernel line
    for name, opt, count, key, err_keys, line in (
        ("quantize int8", "adam8bit", "quant", "q8", ["quant_int8"], 113),
        ("dequantize int8", "adam8bit", "dequant", "dq8",
         ["dequant_int8"], 123),
        ("quantize int4", "adam4bit", "quant", "q4",
         ["quant_int4_signed", "quant_int4_unsigned"], 162),
        ("dequantize int4", "adam4bit", "dequant", "dq4",
         ["dequant_int4_signed", "dequant_int4_unsigned"], 179),
    ):
        # int4 times: the mean of the signed (m) and unsigned (sqrt v)
        # variants, which each step launches equally often
        entry(
            f"{name} wte ({opt})", quant_src, f"{q_file}:{line}",
            res["low_bit"][opt]["launches"][count],
            max(errs[k] for k in err_keys), times["quant"], key,
        )
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(
            "chip_smoke: torch.cuda.is_available() is false; this test "
            "needs an NVIDIA GPU", file=sys.stderr,
        )
        return 2
    sys.path.insert(0, REPO)
    import dlrover_tpu_torch  # noqa: F401  (fails outside the checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res: dict = {}
    t_all = time.perf_counter()
    for name in PHASES:
        t0 = time.perf_counter()
        globals()[f"phase_{name}"](res)
        log(f"# phase {name} passed in {time.perf_counter() - t0:.1f} s")
    log(f"# total {time.perf_counter() - t_all:.1f} s")
    print(res["card"])
    print(json.dumps(kernels_line(res)))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
