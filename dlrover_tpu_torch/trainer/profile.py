"""Device time of one training step by kernel and by kernel family,
from ``torch.profiler``: the ``--profile FILE`` option of the examples.

    with profiler(path):   # a no-op context when path is empty
        ...one step...
    write_profile(prof, step_seconds, path)
"""

from __future__ import annotations

import contextlib
import os

import torch


def profiler(path: str):
    """A ``torch.profiler.profile`` of CPU and CUDA activity, or a
    no-op context when ``path`` is empty."""
    if not path:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


# Kernel families of the profile summary, by a fragment of the kernel's
# name; the first family that matches takes the kernel.
KERNEL_FAMILIES = (
    ("flash", ("flash_fwd_kernel", "flash_bwd_")),
    ("norm", ("layer_norm_fwd_kernel", "layer_norm_bwd_kernel",
              "layer_norm_dgdb_kernel")),
    # quantize_kernel, dequantize_kernel and their nibble variants
    ("quant", ("quantize_kernel", "quantize_nibble_kernel")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
)


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, frags in KERNEL_FAMILIES:
        if any(f in low for f in frags):
            return family
    return "other"  # PyTorch's elementwise, copy and reduction kernels


def write_profile(prof, step_s: float, path: str) -> None:
    """Device time by kernel for the profiled step, and by family
    (flash, norm, quant, gemm, other). The profiler slows the host side, so
    the step's wall time here is longer than an unprofiled step's; the
    kernels' times are their own."""
    kernels = [
        a for a in prof.key_averages()
        if a.device_type == torch.autograd.DeviceType.CUDA
    ]
    kernels.sort(key=lambda a: -a.self_device_time_total)
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    families = {}
    for a in kernels:
        fam = kernel_family(a.key)
        families[fam] = families.get(fam, 0.0) + a.self_device_time_total / 1e3
    head = (
        f"profiled step: wall {step_s * 1e3:.3f} ms, device busy "
        f"{busy_ms:.3f} ms in {sum(a.count for a in kernels)} kernels; "
        "by family (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(families.items())
        )
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(head + "\n  device_ms  calls  kernel\n")
        for a in kernels:
            f.write(
                f"{a.self_device_time_total / 1e3:11.3f} {a.count:6d}  "
                f"{a.key[:160]}\n"
            )
    print(f"profile: {head}; table in {path}", flush=True)
