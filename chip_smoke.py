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
   ``q_offset``, lse with an lse cotangent, small and ragged shapes);
   ``flash_attention``'s output and gradient through autograd on
   strided views of a fused qkv tensor at each main shape, against
   dense f32 attention; and a mask that drops keys of the last rows
   must fail the same limits.
   Fused norms (K3, K4): LayerNorm with bias at the GPT-2 shape (8192
   rows x 768), RMSNorm at the Llama shape (8192 x 4096), a ragged
   1000 x 128 LayerNorm and a 1024 x 8192 LayerNorm (the widest row the
   kernels take), each plain and with the residual add; every
   output (out, resid, mu, rstd, dx, dg, db) held to its limit; and the
   LayerNorm case run through the RMS variant, on rows with a non-zero
   mean, must fail them.
3. ``times``: each kernel's median time at each path's shape beside its
   plain version's, the library call that computes the same function
   (``scaled_dot_product_attention``, ``F.layer_norm``,
   ``F.rms_norm``; yardsticks only: the port never calls them; the add
   variants have none) and the least time the card could take.
4. ``train``: GPT-2 124M at full width and depth (12 layers, 12 heads,
   n_embd 768, vocab 50304, T 1024, bf16, full remat, fused
   cross-entropy, AdamW 3e-4 / 0.1) takes optimizer steps through the
   nanoGPT example's ``ElasticTrainer`` on synthetic tokens from a
   seed, through the flash and fused LayerNorm kernels; the kernels'
   launch counters are zeroed just before and read just after. The
   first loss must be ln(50304) within 0.1, every loss finite, and the
   first loss must match the same step with dense attention and the
   plain LayerNorm.
5. ``train_llama_lora``: LoRA fine-tuning of Llama-2-7B at full width
   and depth (32 layers, 32 heads, n_embd 4096, head_dim 128, SwiGLU
   11008, vocab 32000, T 4096, bf16, full remat; rank 8, AdamW 1e-3)
   through the LoRA example's ``run()`` at batch 2 for 4 steps, the
   counters zeroed just before and read just after. Every loss finite,
   the first loss equal to the plain path's (dense attention, plain
   RMSNorm, one step) within LOSS_TOL, the base weights unchanged, every
   LoRA ``b`` moved off zero, and the kernels launched at least as often
   as full remat implies.

Then it prints the card line, one ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, it exits non-zero before any result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("card", "kernels", "times", "train", "train_llama_lora")

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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
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
]


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
    norm_cases(res)
    log(f"# {_limits()}")


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
            wrong_mask_fails(
                q, k, v, do, o_ref, lse_ref, delta, grads_ref, scale
            )
        del q, k, v, do, o_ref, lse_ref, grads_ref, grads, o, lse, delta


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


def _norm_outputs(x, res, g, b, dout, rms, run_fwd, run_bwd):
    """Forward and backward outputs of one norm (plain variant, then
    the add variant), through the given forward and backward."""
    outs = {}
    eps = 1e-6 if rms else 1e-5
    for add in (False, True):
        out, resid, mu, rstd = run_fwd(
            x, res if add else None, g, b, eps, rms
        )
        y = resid if add else x
        dx, dg, db = run_bwd(dout, y, g, mu, rstd, rms, b is not None)
        tag = "add_" if add else ""
        outs.update({
            f"{tag}out": out, f"{tag}mu": mu, f"{tag}rstd": rstd,
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
    # The plain versions run on the same CUDA tensors: they are called
    # directly, so the wrappers' dispatch does not apply.
    for i, (name, n, e, rms, bias) in enumerate(NORM_CASES):
        x, r, g, b, dout = _norm_inputs(300 + i, n, e)
        b = b if bias else None
        ref = _norm_outputs(
            x, r, g, b, dout, rms, ln.layer_norm_fwd_ref,
            ln.layer_norm_bwd_ref,
        )
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
        for path, main in NORM_MAIN.items():
            if main[0] == name:
                fwd_keys = [k for k in errs if k.split("_")[-1] in
                            ("out", "resid", "mu", "rstd")]
                bwd_keys = [k for k in errs if k not in fwd_keys]
                res["max_abs_err"][f"norm_fwd_{path}"] = max(
                    errs[k][0] for k in fwd_keys
                )
                res["max_abs_err"][f"norm_bwd_{path}"] = max(
                    errs[k][0] for k in bwd_keys
                )
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

    def rms_bwd(dout, y, g, mu, rstd, rms, has_bias):
        return ln._bwd_cuda(dout, y, g, mu, rstd, True, has_bias)

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


def _bound(nbytes, flops):
    """Least time (ms) and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
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
    act = n * e * 2
    params = e * 4 * (2 if bias else 1)
    stats = n * 8
    fwd = _bound(2 * act + params + stats, 10 * n * e)
    add = _bound(4 * act + params + stats, 11 * n * e)
    bwd = _bound(3 * act + e * 4 + stats + params, 12 * n * e)
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
    times = {
        "fwd": median_ms(
            lambda: fa._fwd_cuda(q, k, v, True, scale, None, 0)
        ),
        "fwd_plain": median_ms(
            lambda: fa.flash_attention_ref(q, k, v, True, scale),
            reps=plain_reps,
        ),
        "bwd": median_ms(
            lambda: fa._bwd_cuda(
                q, k, v, lse, do, delta, True, scale, None, 0
            )
        ),
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
    _, _, mu, rstd = ln._fwd_cuda(x, None, g, b, eps, rms)
    times = {
        "fwd": median_ms(lambda: ln._fwd_cuda(x, None, g, b, eps, rms)),
        "fwd_plain": median_ms(
            lambda: ln.layer_norm_fwd_ref(x, None, g, b, eps, rms)
        ),
        "add": median_ms(lambda: ln._fwd_cuda(x, r, g, b, eps, rms)),
        "add_plain": median_ms(
            lambda: ln.layer_norm_fwd_ref(x, r, g, b, eps, rms)
        ),
        "add_library": None,  # no single PyTorch call adds and norms
        "bwd": median_ms(
            lambda: ln._bwd_cuda(dout, x, g, mu, rstd, rms, bias)
        ),
        "bwd_plain": median_ms(
            lambda: ln.layer_norm_bwd_ref(dout, x, g, mu, rstd, rms, bias)
        ),
    }
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
    out = lib()
    wrt = (xl, gl) + ((bl,) if bias else ())
    times["bwd_library"] = median_ms(
        lambda: torch.autograd.grad(out, wrt, dout, retain_graph=True)
    )
    fwd, add, bwd = norm_bounds(n, e, bias)
    times.update(
        fwd_bound=fwd[0], fwd_bound_by=fwd[1],
        add_bound=add[0], add_bound_by=add[1],
        bwd_bound=bwd[0], bwd_bound_by=bwd[1],
    )
    log(f"# times norm {name} (ms, median, N={n} E={e} bf16): "
        + json.dumps(times))
    return times


def phase_times(res: dict) -> None:
    res["times"] = {
        "flash64": flash_times(64),
        "flash128": flash_times(128),
        "norm_gpt2": norm_times("gpt2"),
        "norm_llama": norm_times("llama"),
    }


# ---------------------------------------------------------------------------
# phase 4: the GPT-2 training path
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import layer_norm as ln

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    ln.reset_launch_counts()


def read_counts() -> dict:
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import layer_norm as ln

    torch.cuda.synchronize()
    return {
        "flash_fwd": fa.FWD_LAUNCHES, "flash_bwd": fa.BWD_LAUNCHES,
        "norm_fwd": ln.FWD_LAUNCHES, "norm_bwd": ln.BWD_LAUNCHES,
    }


def phase_train(res: dict) -> None:
    from dlrover_tpu_torch.examples.nanogpt import train

    common = [
        "--model", "gpt2", "--global-batch-size", "16",
        "--micro-batch-size", "8", "--seed", "0",
    ]
    steps = 4
    reset_counts()
    run = train.run(train.parse_args(common + ["--steps", str(steps)]))
    launches = read_counts()
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
    diff = abs(ref["losses"][0] - losses[0])
    log(
        f"# train gpt2 dense attention, plain norm: first loss "
        f"{ref['losses'][0]} vs kernels {losses[0]} (|diff| {diff:.3e}, "
        f"tol {LOSS_TOL})"
    )
    check(diff <= LOSS_TOL, "first loss differs from the plain path")
    res["train"] = run


# ---------------------------------------------------------------------------
# phase 5: the Llama-2-7B LoRA path
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
            f"layer_norm_bwd {label} ({path})", norm_src,
            "dlrover_tpu/ops/layer_norm.py:88", launches["norm_bwd"],
            errs[f"norm_bwd_{path}"], t, "bwd",
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
