"""Fused LayerNorm / RMSNorm (+ residual add), forward and backward, on
the CUDA kernels of ``csrc/layer_norm.cu``.

Counterpart of ``dlrover_tpu/ops/layer_norm.py``, with the same public
functions::

    out = fused_layer_norm(x, g, b)             # b optional
    out = fused_rms_norm(x, g)
    out, resid = fused_add_layer_norm(x, residual, g, b)
    out, resid = fused_add_rms_norm(x, residual, g)
      resid = x + residual  (the next residual branch point)
      out   = norm(resid)

Statistics are f32. The add variants normalise the f32 sum and return
it rounded to x's dtype, as the TPU kernel does (so ``out`` is not
``norm(round(x + residual))``). The forward keeps mu and rstd as one
f32 [2, N] ``stats`` tensor for the backward. Two
``torch.autograd.Function``\\ s mirror the JAX package's custom VJPs:
the backward gives dx, dg and db (its C entry point launches the kernel
and the fixed-order sum of its per-block dg/db partials, so no PyTorch
kernel runs here); the add variant returns dy for both x and residual,
with the downstream cotangent of ``resid`` added.

On a CUDA tensor the wrappers launch the kernels, or raise when the
kernels do not take the input (bf16 activations, f32 g and b, a last
axis that is a multiple of 8 up to ``MAX_WIDTH``, 16-byte aligned
data). On a CPU tensor they run the plain versions in this module
(:func:`layer_norm_fwd_ref`, :func:`layer_norm_bwd_ref`), which is what
the tests here use. Nothing falls back from the card to the plain
versions. :func:`launch_shape` decides how the kernels cover the rows;
the C entry points check what it gives them. A call does the least
Python it can before its launch (the wrappers' time on the host is what
the card waits for at GPT-2's width): three or four allocations, the
launch record cached per shape, the stream's raw handle, one ctypes
call; the C side switches device only when the tensors' device is not
current.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count launches (one a forward or
backward call), so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from dlrover_tpu_torch.ops import _build

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_WIDTH = 8192  # the widest row the kernels take (kMaxWidth)
# Rows up to this width are reduced by one warp each, wider ones by one
# block (kWarpMaxWidth).
WARP_MAX_WIDTH = 1024
THREADS = 256  # a block's threads at most (kMaxThreads)
MAX_STAGES = 8  # ring stages a group (kMaxStages)
BAR_BYTES = (THREADS // 32) * MAX_STAGES * 8  # the blocks' mbarriers
# An SM's shared memory, and what each block on it takes besides its
# dynamic shared memory (the card's 1 KB and the reduction's 512 bytes).
SM_SMEM = 228 * 1024
BLOCK_SMEM_EXTRA = 1024 + 512
# Blocks an SM of the forward with a block a row (kFwdBlocksPerSM).
FWD_BLOCKS_PER_SM = 3
H100_SMS = 132
# Input rows in a ring stage, and output rows a block stages, by call.
_STREAMS = {"fwd": 1, "add": 2, "bwd": 2}
_OUTS = {"fwd": 1, "add": 2, "bwd": 0}

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class _Shape(ctypes.Structure):
    """A launch of the kernels (``NormShape`` in ``csrc/layer_norm.cu``)."""

    _fields_ = [
        (name, _I) for name in (
            "n", "e", "warp", "nv", "threads", "blocks", "rows", "stages",
            "smem", "device", "rms",
        )
    ] + [("eps", _F)]


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    if not getattr(lib, "_dlrover_typed", False):
        shape = ctypes.POINTER(_Shape)
        lib.dlrover_norm_fwd.argtypes = [_P] * 7 + [shape, _P]
        lib.dlrover_norm_bwd.argtypes = [_P] * 8 + [shape, _P]
        lib.dlrover_norm_fwd.restype = _I
        lib.dlrover_norm_bwd.restype = _I
        lib._dlrover_typed = True
    return lib


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------


def layer_norm_fwd_ref(x2, res2, g, b, eps: float, rms: bool):
    """Forward on [N, E] rows: (out, resid or None, mu [N] f32,
    rstd [N] f32). The add path normalises the f32 sum and returns it
    rounded to x's dtype."""
    xf = x2.float()
    resid = None
    if res2 is not None:
        xf = xf + res2.float()
        resid = xf.to(x2.dtype)
    if rms:
        mu = torch.zeros(xf.shape[0], device=xf.device)
        var = xf.square().mean(-1)
    else:
        mu = xf.mean(-1)
        var = (xf - mu[:, None]).square().mean(-1)
    rstd = torch.rsqrt(var + eps)
    out = (xf - mu[:, None]) * rstd[:, None] * g.float()
    if b is not None:
        out = out + b.float()
    return out.to(x2.dtype), resid, mu, rstd


def layer_norm_bwd_ref(dout2, y2, g, mu, rstd, rms: bool, has_bias: bool):
    """Backward on [N, E] rows from the forward's statistics: (dx in
    dout's dtype, dg f32 [E], db f32 [E] or None). ``y2`` is the
    normalised input (x, or resid on the add path)."""
    dy = dout2.float()
    xhat = (y2.float() - mu[:, None]) * rstd[:, None]
    dg = (dy * xhat).sum(0)
    db = dy.sum(0) if has_bias else None
    wdy = dy * g.float()
    c2 = (wdy * xhat).mean(-1, keepdim=True)
    if rms:
        dx = (wdy - xhat * c2) * rstd[:, None]
    else:
        c1 = wdy.mean(-1, keepdim=True)
        dx = (wdy - c1 - xhat * c2) * rstd[:, None]
    return dx.to(dout2.dtype), dg, db


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _aligned(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.data_ptr() % 16:
        raise ValueError(
            f"the CUDA norm kernels read {name} in 16-byte pieces; it "
            f"starts {x.data_ptr() % 16} bytes past a 16-byte boundary"
        )
    return x


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """Check an [N, E] activation for the kernels; contiguous rows."""
    if x.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA norm kernels take bfloat16; {name} is {x.dtype}"
        )
    e = x.shape[-1]
    if x.dim() != 2 or e % 8 or not 0 < e <= MAX_WIDTH or x.shape[0] < 1:
        raise ValueError(
            f"the CUDA norm kernels take [N >= 1, E] rows with E a "
            f"multiple of 8 up to {MAX_WIDTH}; {name} has shape "
            f"{tuple(x.shape)}"
        )
    return _aligned(x.contiguous(), name)


def _param(p: Optional[torch.Tensor], e: int, device, name: str):
    if p is None:
        return None
    if p.dtype != torch.float32 or p.shape != (e,):
        raise ValueError(
            f"the CUDA norm kernels take {name} as float32 [{e}]; got "
            f"{p.dtype} {tuple(p.shape)}"
        )
    if p.device != device:
        raise ValueError(f"{name} must be on the activations' device")
    return _aligned(p.contiguous(), name)


def _stats(stats: torch.Tensor, n: int, device) -> torch.Tensor:
    if stats.dtype != torch.float32 or stats.shape != (2, n):
        raise ValueError(
            f"the CUDA norm backward takes stats (mu, rstd) as float32 "
            f"[2, {n}]; got {stats.dtype} {tuple(stats.shape)}"
        )
    if stats.device != device:
        raise ValueError("stats must be on the activations' device")
    return stats.contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


class LaunchShape(NamedTuple):
    """How the kernels cover n rows of width e: ``warp`` (one warp
    reduces a row) or one block a row; ``nv`` 8-element chunks a thread;
    ``threads`` a block; ``blocks``; ``rows`` a group (warp or block),
    each group owning rows [group * rows, + rows) clipped to n;
    ``stages`` rows a group has in its ring; ``smem`` a block's dynamic
    shared memory, bytes. The backward writes one row of dg (and db)
    partials a block: ``blocks`` rows."""

    warp: bool
    nv: int
    threads: int
    blocks: int
    rows: int
    stages: int
    smem: int

    @property
    def groups_per_block(self) -> int:
        return self.threads // 32 if self.warp else 1


def launch_shape(n: int, e: int, kind: str, sms: int = H100_SMS):
    """The launch for n rows of width e of a ``kind`` call ("fwd", "add"
    or "bwd") on a card of ``sms`` SMs: a persistent grid of two blocks
    an SM (``FWD_BLOCKS_PER_SM`` for a forward with a block a row, one
    where a thread holds four chunks), its groups taking equal
    contiguous row ranges, each block's ring as deep as its share of the
    SM's shared memory allows."""
    streams = _STREAMS[kind]
    chunks = e // 8
    out_bytes = 0
    if e <= WARP_MAX_WIDTH:
        warp, nv, threads, per_sm = True, -(-chunks // 32), THREADS, 2
    else:
        warp = False
        nv = next(v for v in (1, 2, 4) if -(-chunks // v) <= THREADS)
        threads = -(-(-(-chunks // nv)) // 32) * 32
        per_sm = 2 if kind == "bwd" else FWD_BLOCKS_PER_SM
        # the forward stages two rows of its outputs for bulk copies
        out_bytes = 2 * _OUTS[kind] * e * 2
    if nv == 4:
        per_sm = 1  # a thread needs the registers of four chunks
    gpb = THREADS // 32 if warp else 1
    stage_bytes = gpb * streams * e * 2
    budget = SM_SMEM // per_sm - BLOCK_SMEM_EXTRA - BAR_BYTES - out_bytes
    rows = -(-n // (sms * per_sm * gpb))
    stages = max(1, min(MAX_STAGES, budget // stage_bytes, rows))
    blocks = -(-(-(-n // rows)) // gpb)
    smem = BAR_BYTES + stages * stage_bytes + out_bytes
    return LaunchShape(warp, nv, threads, blocks, rows, stages, smem)


def io_bytes(n: int, e: int, kind: str, bias: bool) -> int:
    """Bytes a ``kind`` call on [n, e] bf16 rows must move, each input
    read once and each output written once: the forward reads x (and
    the residual), g (and b) and writes out (and resid) and the f32
    stats; the backward reads dout, y, g and the stats and writes dx
    and dg (and db)."""
    act = n * e * 2
    params = e * 4 * (2 if bias else 1)
    stats = n * 8
    if kind == "bwd":
        return 3 * act + e * 4 + stats + params
    return (4 if kind == "add" else 2) * act + params + stats


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _shape(n, e, kind, eps, rms, index) -> _Shape:
    ls = launch_shape(n, e, kind, _sm_count(index))
    return _Shape(
        n, e, ls.warp, ls.nv, ls.threads, ls.blocks, ls.rows, ls.stages,
        ls.smem, index, rms, eps,
    )


def _stream(index: int) -> int:
    """The raw handle of the device's current stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _fwd_cuda(x2, res2, g, b, eps, rms):
    """(out, resid or None, stats [2, N] f32: mu, then rstd)."""
    global FWD_LAUNCHES
    x2 = _rows(x2, "x")
    n, e = x2.shape
    dev = x2.device
    if res2 is not None:
        res2 = _rows(res2, "residual")
        if res2.shape != x2.shape:
            raise ValueError(
                f"residual {tuple(res2.shape)} must match x "
                f"{tuple(x2.shape)}"
            )
        if res2.device != dev:
            raise ValueError("residual must be on x's device")
    g = _param(g, e, dev, "g")
    b = _param(b, e, dev, "b")
    add = res2 is not None
    kind = "add" if add else "fwd"
    shape = _shape(n, e, kind, float(eps), bool(rms), dev.index)
    out = torch.empty_like(x2)
    resid = torch.empty_like(x2) if add else None
    stats = g.new_empty(2, n)
    err = _lib().dlrover_norm_fwd(
        x2.data_ptr(), _ptr(res2), g.data_ptr(), _ptr(b), out.data_ptr(),
        _ptr(resid), stats.data_ptr(), shape, _stream(dev.index),
    )
    _check(err, "norm forward")
    FWD_LAUNCHES += 1
    return out, resid, stats


def _bwd_cuda(dout2, y2, g, stats, rms, has_bias):
    """(dx, dg f32 [E], db f32 [E] or None): the backward kernel and the
    sum of its partials, both launched by the one C entry point."""
    global BWD_LAUNCHES
    dout2 = _rows(dout2, "dout")
    y2 = _rows(y2, "y")
    if y2.shape != dout2.shape:
        raise ValueError(
            f"dout {tuple(dout2.shape)} must match the saved input "
            f"{tuple(y2.shape)}"
        )
    n, e = dout2.shape
    dev = dout2.device
    if y2.device != dev:
        raise ValueError("y must be on dout's device")
    g = _param(g, e, dev, "g")
    stats = _stats(stats, n, dev)
    shape = _shape(n, e, "bwd", 0.0, bool(rms), dev.index)
    dx = torch.empty_like(dout2)
    dg = torch.empty_like(g)
    db = torch.empty_like(g) if has_bias else None
    part = g.new_empty(2 if has_bias else 1, shape.blocks, e)
    err = _lib().dlrover_norm_bwd(
        dout2.data_ptr(), y2.data_ptr(), g.data_ptr(), stats.data_ptr(),
        dx.data_ptr(), dg.data_ptr(), _ptr(db), part.data_ptr(), shape,
        _stream(dev.index),
    )
    _check(err, "norm backward")
    BWD_LAUNCHES += 1
    return dx, dg, db


def _fwd(x2, res2, g, b, eps, rms):
    """(out, resid or None, stats [2, N] f32: mu, then rstd)."""
    if x2.is_cuda:
        return _fwd_cuda(x2, res2, g, b, eps, rms)
    out, resid, mu, rstd = layer_norm_fwd_ref(x2, res2, g, b, eps, rms)
    return out, resid, torch.stack((mu, rstd))


def _bwd(dout2, y2, g, stats, rms, has_bias):
    if dout2.is_cuda:
        return _bwd_cuda(dout2, y2, g, stats, rms, has_bias)
    mu, rstd = stats
    return layer_norm_bwd_ref(dout2, y2, g, mu, rstd, rms, has_bias)


class _Norm(torch.autograd.Function):
    """norm(x) with the kernels' backward (the JAX ``_norm`` VJP)."""

    @staticmethod
    def forward(ctx, x, g, b, eps, rms):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        out, _, stats = _fwd(x2, None, g, b, eps, rms)
        ctx.save_for_backward(x2, g, stats)
        ctx.rms, ctx.has_bias = rms, b is not None
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, dout):
        x2, g, stats = ctx.saved_tensors
        dx, dg, db = _bwd(
            dout.reshape(x2.shape), x2, g, stats, ctx.rms, ctx.has_bias
        )
        db = db.to(g.dtype) if ctx.has_bias else None
        return dx.reshape(dout.shape), dg.to(g.dtype), db, None, None


class _AddNorm(torch.autograd.Function):
    """(norm(x + res), x + res) with the kernels' backward (the JAX
    ``_add_norm`` VJP): y = x + res feeds both the norm and the second
    output, so its cotangent is the norm's dx plus the downstream
    cotangent of ``resid``, and x and res both receive it."""

    @staticmethod
    def forward(ctx, x, res, g, b, eps, rms):
        shape = x.shape
        e = shape[-1]
        out, resid2, stats = _fwd(
            x.reshape(-1, e), res.reshape(-1, e), g, b, eps, rms
        )
        ctx.save_for_backward(resid2, g, stats)
        ctx.rms, ctx.has_bias = rms, b is not None
        return out.reshape(shape), resid2.reshape(shape)

    @staticmethod
    def backward(ctx, dout, dresid):
        resid2, g, stats = ctx.saved_tensors
        dy, dg, db = _bwd(
            dout.reshape(resid2.shape), resid2, g, stats, ctx.rms,
            ctx.has_bias,
        )
        dy = dy.reshape(dout.shape) + dresid
        db = db.to(g.dtype) if ctx.has_bias else None
        return dy, dy, dg.to(g.dtype), db, None, None


def fused_layer_norm(
    x: torch.Tensor,
    g: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics."""
    return _Norm.apply(x, g, b, eps, False)


def fused_rms_norm(
    x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """RMSNorm over the last axis (Llama family)."""
    return _Norm.apply(x, g, None, eps, True)


def fused_add_layer_norm(
    x: torch.Tensor,
    residual: torch.Tensor,
    g: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(layer_norm(x + residual), x + residual) in one pass: the
    pre-norm residual branch point. The second output is the input to
    the next residual add."""
    return _AddNorm.apply(x, residual, g, b, eps, False)


def fused_add_rms_norm(
    x: torch.Tensor,
    residual: torch.Tensor,
    g: torch.Tensor,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rms_norm(x + residual), x + residual): the Llama residual
    spine."""
    return _AddNorm.apply(x, residual, g, None, eps, True)
