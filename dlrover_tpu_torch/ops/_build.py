"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into ``lib<name>.so`` for ``sm_90a`` (Hopper), then loaded with
``ctypes``. The source includes no PyTorch header, so a build takes
seconds; the wrappers pass pointers from ``tensor.data_ptr()`` and the
current stream's handle.

Libraries go to ``build/dlrover_tpu_torch/<hash>/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.
A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("build")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "dlrover_tpu_torch"


def nvcc() -> str:
    cuda_home = os.getenv("CUDA_HOME", "/usr/local/cuda")
    for cand in (
        shutil.which("nvcc"),
        os.path.join(cuda_home, "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "CUDA kernels of dlrover_tpu_torch are built from source at "
        "first use"
    )


def _sources(name: str) -> List[Path]:
    main = CSRC / f"{name}.cu"
    if not main.exists():
        raise FileNotFoundError(f"no kernel source {main}")
    return [main] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built.
    Returns (process or None, library path, temporary output path)."""
    lib = _lib_path(name)
    if lib.exists():
        return None, lib, None
    compiler = nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    logger.info("building %s: %s", name, " ".join(cmd))
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, lib, tmp


def _finish(name: str, proc, lib: Path, tmp) -> str:
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} (rc {proc.returncode}):\n{out}"
        )
    os.replace(tmp, lib)  # atomic: a reader never sees half a library
    return out


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build every named kernel library, one ``nvcc`` per source, all
    started together. Returns each build's compiler output (register
    and shared-memory use from ``-Xptxas -v``; empty when the library
    was already built)."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        return _loaded[name]


def ptxas_usage(out: str) -> Dict[str, dict]:
    """Registers and spill bytes per kernel from a build's ``-Xptxas -v``
    output, keyed by a readable kernel name: ``flash_fwd_kernel<128>``,
    ``layer_norm_fwd_kernel<4,1,0,1>`` (the template arguments)."""
    usage, fn = {}, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = _kernel_name(m.group(1))
            usage[fn] = {}
        r = re.search(r"Used (\d+) registers", line)
        if r and fn:
            usage[fn]["registers"] = int(r.group(1))
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if sp and fn:
            usage[fn]["spill_bytes"] = int(sp.group(1)) + int(sp.group(2))
    return usage


def _kernel_name(mangled: str) -> str:
    m = re.search(r"([a-z][a-z_]*_kernel)I(.*)EEv", mangled)
    if m:  # a template: integer and bool arguments Li<n>E / Lb<n>E
        args = re.sub(r"L[ib](\d+)E", r"\1,", m.group(2))
        return f"{m.group(1)}<{args.rstrip(',')}>"
    m = re.search(r"([a-z][a-z_]*_kernel)E", mangled)
    return m.group(1) if m else mangled
