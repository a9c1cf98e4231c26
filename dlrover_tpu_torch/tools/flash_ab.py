"""A/B of flash-attention kernel sources on one card: registers and
spills from ``ptxas``, the count of each kernel's Hopper tensor-core
(``HGMMA``), TMA load (``UTMALDG``) and older tensor-core (``HMMA``)
instructions in the built library (``cuobjdump -sass``), and each
variant's forward and backward median time, each kernel's device time
(torch.profiler) and the forward's error against the plain version, at
each path's shape (GPT-2: B 8, T 1024, H 12,
D 64; Llama-2-7B: B 2, T 4096, H 32, D 128; causal, bf16).

    git show <rev>:dlrover_tpu_torch/csrc/flash_attention.cu > build/ab/old.cu
    python -m dlrover_tpu_torch.tools.flash_ab build/ab/old.cu \\
        dlrover_tpu_torch/csrc/flash_attention.cu

Each source is built with the port's nvcc flags into ``build/ab/``.
The variants are timed in A B ... B A order, so a drift of the card's
clock over the run shows as a difference between the two rounds. A
source that was not compiled for a head_dim reports that and goes on.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import flash_attention as fa

SHAPES = {64: (8, 1024, 12), 128: (2, 4096, 32)}  # b, t, h by head_dim
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(sass: str) -> dict:
    """{kernel: {op: count}} for the SASS_OPS instructions of each
    function in ``cuobjdump -sass`` output, keyed by the readable names
    of ``_build.ptxas_usage``."""
    counts, fn = {}, None
    op_re = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _build._kernel_name(m.group(1))
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = op_re.search(line)
        if m and fn:
            counts[fn][m.group(1)] += 1
    return counts


def library_sass(lib: Path) -> str:
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    return subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True,
        check=True,
    ).stdout


def build(sources):
    """{stem: (library path, ptxas usage)}, one nvcc per source, all
    started together."""
    out_dir = _build.CSRC.parent.parent / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        lib = out_dir / f"lib{Path(src).stem}.so"
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(lib), src]
        procs[Path(src).stem] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    built = {}
    for stem, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}:\n{out}")
        built[stem] = (lib, _build.ptxas_usage(out))
    return built


def median_ms(fn, reps: int) -> float:
    for _ in range(3):
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


def measure(lib_path: Path, d: int) -> str:
    # The wrappers load the library through _build.load, which returns
    # what _build._loaded holds for the name.
    _build._loaded["flash_attention"] = ctypes.CDLL(str(lib_path))
    b, t, h = SHAPES[d]
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (
        torch.randn((b, t, h, d), generator=gen, device="cuda").to(
            torch.bfloat16
        )
        for _ in range(4)
    )
    q, scale = fa._fold_scale(q, None, d)
    try:
        o, lse = fa._fwd_cuda(q, k, v, True, scale, None, 0)
    except RuntimeError as exc:
        return f"not run: {exc}"
    ref, _ = fa.flash_attention_ref(q, k, v, True, scale)
    err = (o.float() - ref.float()).abs().max().item()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

    def fwd_call():
        return fa._fwd_cuda(q, k, v, True, scale, None, 0)

    def bwd_call():
        return fa._bwd_cuda(q, k, v, lse, do, delta, True, scale, None, 0)

    fwd = median_ms(fwd_call, 50)
    bwd = median_ms(bwd_call, 30)
    return (
        f"fwd {fwd:.5f} ms, bwd {bwd:.5f} ms, fwd max_abs_err vs plain "
        f"{err:.3e}, device ms {device_ms(fwd_call, bwd_call)}"
    )


def device_ms(*calls, reps: int = 10) -> dict:
    """Mean device time (ms) of each flash kernel over ``reps`` rounds of
    ``calls``, from torch.profiler: the medians above time one call
    between two events, so they also hold the host's launch time where
    the card waits for it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for call in calls:
                call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(flash_\w+_kernel<\d+>)", e.key)
        if m:
            out[m.group(1)] = round(e.device_time_total / e.count / 1e3, 5)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("sources", nargs="+", help="flash_attention.cu variants")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    built = build(args.sources)
    for stem, (lib, usage) in built.items():
        ops = sass_counts(library_sass(lib))
        for fn in sorted(usage):
            print(f"kernel {stem} {fn}: {usage[fn]} {ops.get(fn, {})}",
                  flush=True)
    stems = list(built)
    for rnd, order in enumerate((stems, stems[::-1])):
        for stem in order:
            for d in SHAPES:
                print(
                    f"round {rnd} {stem} D{d}: "
                    f"{measure(built[stem][0], d)}",
                    flush=True,
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
