#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dlrover_tpu_torch``).

    python3 chip_smoke.py            # every phase, one GPU

Phases, each of which fails the run (non-zero exit, no result line):

1. ``card``: the card's name and power limit from ``nvidia-smi``; build
   every CUDA kernel from ``dlrover_tpu_torch/csrc`` with ``nvcc``
   (timed as set-up, one ``nvcc`` per source, all started together).
2. ``kernels``: each kernel against its plain PyTorch version on the
   same inputs on the card, at the training path's shape (batch 8,
   T 1024, 12 heads, head_dim 64, causal, bf16) and at the variants
   (full attention, ragged T 1000, window 256, rectangular with
   ``q_offset``, lse with an lse cotangent, small and ragged shapes);
   then ``flash_attention``'s output and gradient through autograd on
   strided views of a fused qkv tensor at the training shape, against
   dense f32 attention; and a mask that drops keys of the last rows must
   fail the same limits.
3. ``times``: each kernel's median time at the training shape beside
   its plain version's, the library call that computes the same
   function (``scaled_dot_product_attention``, a yardstick only: the
   port never calls it) and the least time the card could take.
4. ``train``: GPT-2 124M at full width and depth (12 layers, 12 heads,
   n_embd 768, vocab 50304, T 1024, bf16, full remat, fused
   cross-entropy, AdamW 3e-4 / 0.1) takes optimizer steps through the
   nanoGPT example's ``ElasticTrainer`` on synthetic tokens from a
   seed; the kernels' launch counters are zeroed just before and read
   just after. The first loss must be ln(50304) within 0.1, every loss
   finite, and the first loss must match the same step with the dense
   attention path.

Then it prints the card line, one ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, it exits non-zero before any result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("card", "kernels", "times", "train")

# bf16 outputs, compared element by element:
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
# The first loss with the kernels against the dense attention path:
# both run the model in bf16; attention's rounding differs. At init
# (weights of std 0.02) attention barely moves the loss, so this gate
# checks the path end to end; the parity limits hold attention itself.
LOSS_TOL = 2e-2

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

MAIN = dict(b=8, t=1024, h=12, d=64)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


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
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"# ptxas {name}: {line.strip()}")
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


# name, tq, tk, causal, window, q_offset, scale (None: 1/8 folded into q
# as the model path does), with an lse cotangent
CASES = [
    ("main_causal", 1024, 1024, True, None, 0, None, False),
    ("full", 1024, 1024, False, None, 0, 0.125, False),
    ("ragged_t1000", 1000, 1000, True, None, 0, 0.125, False),
    ("window256", 1024, 1024, True, 256, 0, 0.125, False),
    ("rect_q_offset", 256, 1024, True, None, 768, 0.125, False),
    ("lse_cotangent", 1024, 1024, True, None, 0, None, True),
    ("tiny_t65", 65, 65, True, None, 0, 0.125, False),
    ("window1_t200", 200, 200, True, 1, 0, 0.125, True),
    ("rect_full_tq192_tk100", 192, 100, False, None, 0, 0.125, False),
]


def _limits() -> str:
    return (
        f"limits: |err| <= {RTOL:.3g}|plain| + {ATOL:.3g} "
        "max(row_rms, rms/16)(plain), "
        f"rms(err) <= {RMS_TOL:.3g} rms(plain), lse {LSE_TOL}"
    )


def phase_kernels(res: dict) -> None:
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    worst = {"fwd": 0.0, "bwd": 0.0}
    for i, (name, tq, tk, causal, window, q_off, scale, with_glse) in (
        enumerate(CASES)
    ):
        b = MAIN["b"] if name == "main_causal" else 2
        q, k, v, do, g_lse = _case_inputs(
            100 + i, b, tq, tk, MAIN["h"], MAIN["d"]
        )
        if scale is None:
            q, scale = q * 0.125, 1.0
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
            f"# parity {name} (B={b} Tq={tq} Tk={tk}): {_fmt('o', o_err)} | "
            f"lse abs {lse_abs:.3e} | "
            + " | ".join(_fmt(f"d{n}", e) for n, e in zip("qkv", g_errs))
        )
        check(
            _within(o_err) and lse_abs <= LSE_TOL,
            f"forward kernel disagrees with its plain version on {name}",
        )
        check(
            all(_within(e) for e in g_errs),
            f"backward kernels disagree with the plain version on {name}",
        )
        if name == "main_causal":
            worst["fwd"] = max(o_err[0], lse_abs)
            worst["bwd"] = max(e[0] for e in g_errs)
            wrong_mask_fails(q, k, v, do, o_ref, lse_ref, delta, grads_ref)
    log(f"# {_limits()}")
    res["max_abs_err"] = worst
    wrapper_autograd()


def wrong_mask_fails(q, k, v, do, o_ref, lse_ref, delta, grads_ref) -> None:
    """The limits must see a mask error: the kernels run with a window
    of T - 64, so each of the last 64 rows drops its first 1..64 keys,
    and are held to the plain causal result."""
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    window = q.shape[1] - 64
    o, _ = fa._fwd_cuda(q, k, v, True, 1.0, window, 0)
    grads = fa._bwd_cuda(q, k, v, lse_ref, do, delta, True, 1.0, window, 0)
    torch.cuda.synchronize()
    o_err = _err(o, o_ref)
    g_errs = [_err(g, r) for g, r in zip(grads, grads_ref)]
    log(
        f"# wrong mask (window T-64, must fail): {_fmt('o', o_err)} | "
        + " | ".join(_fmt(f"d{n}", e) for n, e in zip("qkv", g_errs))
    )
    check(
        not _within(o_err) and not all(_within(e) for e in g_errs),
        "the parity limits pass kernels run with a wrong mask",
    )


def wrapper_autograd() -> None:
    """The model's call end to end on the card at the training shape:
    ``flash_attention`` on strided q/k/v views of one fused qkv tensor
    (scale folded into q, delta and the backward in the autograd
    Function) against autograd through dense f32 attention on the same
    bf16 values; the output and each of dq, dk, dv are held to the
    limits."""
    import torch

    from dlrover_tpu_torch.models.gpt import _default_attention
    from dlrover_tpu_torch.ops.flash_attention import flash_attention

    b, t, h, d = MAIN["b"], MAIN["t"], MAIN["h"], MAIN["d"]
    gen = torch.Generator(device="cuda").manual_seed(11)
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
    torch.cuda.synchronize()
    errs = [_err(outs[0], outs[1])] + [
        _err(g, r) for g, r in zip(grads[0], grads[1])
    ]
    log(
        f"# parity wrapper_autograd (qkv views, B={b} T={t}): "
        + " | ".join(_fmt(n, e) for n, e in zip(("o", "dq", "dk", "dv"), errs))
    )
    check(
        all(_within(e) for e in errs),
        "flash_attention's output or gradient disagrees with dense f32 "
        "attention",
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

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
        return 1e3 * max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "operations"
        )

    return bound(fwd_bytes, fwd_flops), bound(bwd_bytes, bwd_flops)


def phase_times(res: dict) -> None:
    import torch
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import flash_attention as fa

    b, t, h, d = MAIN["b"], MAIN["t"], MAIN["h"], MAIN["d"]
    q, k, v, do, _ = _case_inputs(7, b, t, t, h, d)
    q = q * 0.125  # the path folds the 1/sqrt(64) scale into q
    o, lse = fa._fwd_cuda(q, k, v, True, 1.0, None, 0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

    times = {
        "fwd": median_ms(lambda: fa._fwd_cuda(q, k, v, True, 1.0, None, 0)),
        "fwd_plain": median_ms(
            lambda: fa.flash_attention_ref(q, k, v, True, 1.0), reps=5
        ),
        "bwd": median_ms(
            lambda: fa._bwd_cuda(q, k, v, lse, do, delta, True, 1.0, None, 0)
        ),
        "bwd_plain": median_ms(
            lambda: fa.flash_attention_bwd_ref(
                q, k, v, lse, do, delta, True, 1.0
            ),
            reps=5,
        ),
    }
    # Library yardstick on the same inputs ([B, H, T, D] views).
    qt, kt, vt = (
        x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)
    )
    times["fwd_library"] = median_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=1.0
        )
    )
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0)
    dot = do.transpose(1, 2)
    times["bwd_library"] = median_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    )
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = attention_bounds(b, t, h, d)
    times.update(
        fwd_bound=fwd_bound, fwd_bound_by=fwd_by,
        bwd_bound=bwd_bound, bwd_bound_by=bwd_by,
    )
    res["times"] = times
    log(
        "# times (ms, median, B=8 T=1024 H=12 D=64 causal bf16): "
        + json.dumps(times)
    )


# ---------------------------------------------------------------------------
# phase 4: the training path
# ---------------------------------------------------------------------------


def phase_train(res: dict) -> None:
    import torch

    from dlrover_tpu_torch.examples.nanogpt import train
    from dlrover_tpu_torch.ops import flash_attention as fa

    common = [
        "--model", "gpt2", "--global-batch-size", "16",
        "--micro-batch-size", "8", "--seed", "0",
    ]
    steps = 4
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    run = train.run(train.parse_args(common + ["--steps", str(steps)]))
    torch.cuda.synchronize()
    launches = {"fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
    res["launches"] = launches
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
    # Full remat runs each layer's forward kernel twice per microbatch.
    check(
        launches["fwd"] >= 2 * layers * accum * steps
        and launches["bwd"] >= layers * accum * steps,
        f"kernel launches {launches} below 24 fwd / 12 bwd per layer "
        f"stack and microbatch over {steps} steps x {accum} microbatches",
    )
    ref = train.run(
        train.parse_args(common + ["--steps", "1", "--attention", "dense"])
    )
    diff = abs(ref["losses"][0] - losses[0])
    log(
        f"# train gpt2 dense attention: first loss {ref['losses'][0]} vs "
        f"kernels {losses[0]} (|diff| {diff:.3e}, tol {LOSS_TOL})"
    )
    check(diff <= LOSS_TOL, "first loss differs from the dense path")
    res["train"] = run


# ---------------------------------------------------------------------------


def kernels_line(res: dict) -> dict:
    times, errs = res["times"], res["max_abs_err"]
    src = "dlrover_tpu_torch/csrc/flash_attention.cu"
    entries = []
    for key, name, replaces in (
        ("fwd", "flash_attention_fwd",
         "dlrover_tpu/ops/flash_attention.py:148"),
        ("bwd", "flash_attention_bwd (dkdv + dq)",
         "dlrover_tpu/ops/flash_attention.py:299"),
    ):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": res["launches"][key],
            "max_abs_err": errs[key],
            "ms": times[key],
            "plain_ms": times[f"{key}_plain"],
            "bound_ms": times[f"{key}_bound"],
            "bound_by": times[f"{key}_bound_by"],
            "library_ms": times[f"{key}_library"],
        })
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
