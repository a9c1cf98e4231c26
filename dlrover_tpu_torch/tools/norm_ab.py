"""A/B of fused-norm kernel sources (``csrc/layer_norm.cu``) on one card.

    git show <rev>:dlrover_tpu_torch/csrc/layer_norm.cu > build/ab/old.cu
    python -m dlrover_tpu_torch.tools.norm_ab build/ab/old.cu \\
        dlrover_tpu_torch/csrc/layer_norm.cu

Each source is built with the port's nvcc flags into ``build/ab/`` and
its registers and spill bytes (``-Xptxas -v``) are printed per kernel
instance. Then, in A B ... B A order (so a drift of the card's clock
shows as a difference between the two rounds), at each path's shape
(GPT-2: LayerNorm with bias, 8192 x 768; Llama-2-7B: RMSNorm, 8192 x
4096; bf16 rows, f32 g and b) and for the plain forward, the forward
with the residual add and the backward, it prints:

* ``median``: the median of one call between two CUDA events. The card
  waits while the host prepares the launch, so this holds host time;
* ``device``: the device time of the call's kernels by torch.profiler
  (every kernel the call launches, summed), warm (the call's inputs were
  just used, and at GPT-2's shape they fit the 50 MB L2) and cold (a
  128 MB write between calls evicts them);
* ``host``: median minus warm device time, and ``host_call``: the
  median time from the call to its return on the host's clock (the
  wrapper's Python and the launches; the card runs behind it), which
  host noise on a shared CPU moves less than it moves the median;
* ``bound``: bytes each input read once and each output written once
  over 3.35 TB/s, and its share of the cold device time.

``F.layer_norm`` / ``F.rms_norm`` forward and backward (weights in bf16,
as the library's kernels take them) get the same lines in each round.

A library is driven through its own entry points: a source that exports
``dlrover_norm_fwd`` goes through the port's wrappers
(``ops/layer_norm._fwd_cuda``/``_bwd_cuda``, with that library loaded
under them); an older source with the earlier C interface
(``dlrover_layer_norm_fwd``/``_bwd``, partial dg/db summed by PyTorch)
goes through a copy of the earlier wrapper's steps kept here. The
results also go to ``build/ab/norm_ab.json``, beside the builds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import layer_norm as ln
from dlrover_tpu_torch.tools.flash_ab import build, median_ms

PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# name: (rows, width, rms, bias)
SHAPES = {
    "gpt2_ln_e768": (8 * 1024, 768, False, True),
    "llama_rms_e4096": (2 * 4096, 4096, True, False),
}
VARIANTS = ("fwd", "add", "bwd")
_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def bound_ms(n: int, e: int, variant: str, bias: bool) -> float:
    """The call's bytes (``ops/layer_norm.io_bytes``) over the memory
    rate."""
    return 1e3 * ln.io_bytes(n, e, variant, bias) / PEAK_BYTES


class CurrentDriver:
    """A library with the current C interface, through the wrappers."""

    def __init__(self, lib_path: Path):
        self.lib = ctypes.CDLL(str(lib_path))

    def _load(self):
        # The wrappers load the library through _build.load, which
        # returns what _build._loaded holds for the name.
        _build._loaded["layer_norm"] = self.lib

    def fwd(self, x, res, g, b, eps, rms):
        self._load()
        return ln._fwd_cuda(x, res, g, b, eps, rms)

    def stats(self, fwd_out):
        return fwd_out[2]

    def bwd(self, dout, y, g, stats, rms, bias):
        self._load()
        return ln._bwd_cuda(dout, y, g, stats, rms, bias)


class LegacyDriver:
    """A library with the earlier C interface, driven by the earlier
    wrapper's steps: four allocations, a device switch, the stream, the
    ctypes call, and the partial dg/db summed by PyTorch."""

    def __init__(self, lib_path: Path):
        lib = ctypes.CDLL(str(lib_path))
        lib.dlrover_layer_norm_fwd.argtypes = [_P] * 8 + [_I, _I, _F, _I, _P]
        lib.dlrover_layer_norm_bwd.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        lib.dlrover_layer_norm_fwd.restype = _I
        lib.dlrover_layer_norm_bwd.restype = _I
        self.lib = lib

    def fwd(self, x2, res2, g, b, eps, rms):
        x2 = _legacy_rows(x2)
        n, e = x2.shape
        if res2 is not None:
            res2 = _legacy_rows(res2)
            assert res2.shape == x2.shape and res2.dtype == x2.dtype
            assert res2.device == x2.device
        g = _legacy_param(g, e, x2.device)
        b = _legacy_param(b, e, x2.device)
        out = torch.empty_like(x2)
        resid = torch.empty_like(x2) if res2 is not None else None
        mu = torch.empty(n, dtype=torch.float32, device=x2.device)
        rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
        with torch.cuda.device(x2.device):
            stream = torch.cuda.current_stream(x2.device).cuda_stream
            err = self.lib.dlrover_layer_norm_fwd(
                x2.data_ptr(), _ptr(res2), g.data_ptr(), _ptr(b),
                out.data_ptr(), _ptr(resid), mu.data_ptr(), rstd.data_ptr(),
                n, e, float(eps), int(rms), stream,
            )
        assert err == 0, err
        return out, resid, mu, rstd

    def stats(self, fwd_out):
        return fwd_out[2:]

    def bwd(self, dout2, y2, g, stats, rms, has_bias):
        dout2, y2 = _legacy_rows(dout2), _legacy_rows(y2)
        assert y2.shape == dout2.shape and y2.dtype == dout2.dtype
        n, e = dout2.shape
        g = _legacy_param(g, e, dout2.device)
        mu, rstd = (s.contiguous() for s in stats)
        rows = max(1, -(-n // (3 * 132)))
        blocks = -(-n // rows)
        dx = torch.empty_like(dout2)
        dg_part = torch.empty(
            (blocks, e), dtype=torch.float32, device=dout2.device
        )
        db_part = torch.empty_like(dg_part) if has_bias else None
        with torch.cuda.device(dout2.device):
            stream = torch.cuda.current_stream(dout2.device).cuda_stream
            err = self.lib.dlrover_layer_norm_bwd(
                dout2.data_ptr(), y2.data_ptr(), g.data_ptr(), mu.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), dg_part.data_ptr(),
                _ptr(db_part), n, e, rows, int(rms), stream,
            )
        assert err == 0, err
        db = db_part.sum(0) if has_bias else None
        return dx, dg_part.sum(0), db


def _ptr(t):
    return None if t is None else t.data_ptr()


def _legacy_rows(x):
    # the earlier wrapper's checks of an activation, as cheap as they were
    assert x.dtype == torch.bfloat16
    e = x.shape[-1]
    assert x.dim() == 2 and not e % 8 and 0 < e <= 8192 and x.shape[0] >= 1
    return x.contiguous()


def _legacy_param(p, e, device):
    if p is None:
        return None
    assert p.dtype == torch.float32 and p.shape == (e,)
    assert p.device == device
    return p.contiguous()


def driver(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    if hasattr(lib, "dlrover_norm_fwd"):
        return CurrentDriver(lib_path)
    return LegacyDriver(lib_path)


_FLUSH = None


def _flush() -> None:
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _FLUSH.bitwise_not_()


def device_ms(call, cold: bool, reps: int = 20) -> tuple:
    """(device ms of one call, {kernel: ms a call}) from torch.profiler:
    every kernel the call launches, without the L2 flush's."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if cold:
                _flush()
            call()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "bitwise_not" in e.key or e.self_device_time_total <= 0:
            continue
        kernels[e.key[:120]] = e.self_device_time_total / reps / 1e3
    return sum(kernels.values()), kernels


def _inputs(n, e, seed=9):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((n, e), generator=gen, device="cuda") + 1.0).to(
        torch.bfloat16
    )
    res = torch.randn((n, e), generator=gen, device="cuda").to(torch.bfloat16)
    g = 1.0 + 0.1 * torch.randn((e,), generator=gen, device="cuda")
    b = 0.1 * torch.randn((e,), generator=gen, device="cuda")
    dout = torch.randn((n, e), generator=gen, device="cuda").to(
        torch.bfloat16
    )
    return x, res, g, b, dout


def _calls(drv, shape):
    n, e, rms, bias = SHAPES[shape]
    x, r, g, b, dout = _inputs(n, e)
    b = b if bias else None
    eps = 1e-6 if rms else 1e-5
    stats = drv.stats(drv.fwd(x, None, g, b, eps, rms))
    return {
        "fwd": lambda: drv.fwd(x, None, g, b, eps, rms),
        "add": lambda: drv.fwd(x, r, g, b, eps, rms),
        "bwd": lambda: drv.bwd(dout, x, g, stats, rms, bias),
    }


def _library_calls(shape):
    import torch.nn.functional as F

    n, e, rms, bias = SHAPES[shape]
    x, _, g, b, dout = _inputs(n, e)
    eps = 1e-6 if rms else 1e-5
    xl = x.detach().requires_grad_(True)
    gl = g.to(x.dtype).requires_grad_(True)
    bl = b.to(x.dtype).requires_grad_(True) if bias else None
    if rms:
        lib = lambda: F.rms_norm(xl, (e,), gl, eps)  # noqa: E731
    else:
        lib = lambda: F.layer_norm(xl, (e,), gl, bl, eps)  # noqa: E731
    out = lib()
    wrt = (xl, gl) + ((bl,) if bias else ())
    return {
        "fwd": lib,
        "bwd": lambda: torch.autograd.grad(out, wrt, dout, retain_graph=True),
    }


def host_ms(call, reps: int = 200) -> float:
    """Median host time (ms) from a call to its return."""
    times = []
    for i in range(reps):
        if i % 20 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def measure(call, n, e, variant, bias) -> dict:
    med = median_ms(call, 100)
    host_call = host_ms(call)
    warm, _ = device_ms(call, cold=False)
    cold, kernels = device_ms(call, cold=True)
    bound = bound_ms(n, e, variant, bias)
    return {
        "median_ms": med, "device_ms": warm, "device_cold_ms": cold,
        "host_ms": med - warm, "host_call_ms": host_call, "bound_ms": bound,
        "bound_share_cold": bound / cold if cold else None,
        "kernels_cold": kernels,
    }


def _line(tag, r) -> str:
    return (
        f"{tag}: median {r['median_ms']:.5f} ms, device {r['device_ms']:.5f}"
        f" warm / {r['device_cold_ms']:.5f} cold, host "
        f"{r['host_ms']:.5f} ({r['host_ms'] / r['median_ms']:.0%} of the "
        f"median), host_call {r['host_call_ms']:.5f}, bound {r['bound_ms']:.5f} ({r['bound_share_cold']:.0%} "
        f"of cold device); kernels {json.dumps(r['kernels_cold'])}"
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("sources", nargs="+", help="layer_norm.cu variants")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_ab: no CUDA device", file=sys.stderr)
        return 1
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    built = build(args.sources)
    for stem, (_, usage) in built.items():
        for fn in sorted(usage):
            print(f"kernel {stem} {fn}: {usage[fn]}", flush=True)
    drivers = {stem: driver(lib) for stem, (lib, _) in built.items()}
    stems = list(built)
    results = []
    for rnd, order in enumerate((stems, stems[::-1])):
        for shape, (n, e, _, bias) in SHAPES.items():
            for stem in order:
                calls = _calls(drivers[stem], shape)
                for variant in VARIANTS:
                    r = measure(calls[variant], n, e, variant, bias)
                    results.append(dict(r, round=rnd, source=stem,
                                        shape=shape, variant=variant))
                    print(_line(f"round {rnd} {stem} {shape} {variant}", r),
                          flush=True)
                del calls
            for variant, call in _library_calls(shape).items():
                r = measure(call, n, e, variant, bias)
                results.append(dict(r, round=rnd, source="library",
                                    shape=shape, variant=variant))
                print(_line(f"round {rnd} library {shape} {variant}", r),
                      flush=True)
    out = _build.CSRC.parent.parent / "build" / "ab" / "norm_ab.json"
    out.write_text(json.dumps({
        "card": card,
        "ptxas": {stem: usage for stem, (_, usage) in built.items()},
        "results": results,
    }, indent=1))
    print(f"results in {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
