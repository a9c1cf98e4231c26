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
``norm(round(x + residual))``). Two ``torch.autograd.Function``\\ s mirror
the JAX package's custom VJPs: the backward kernel gives dx and per-row-
block partial dg/db, summed here; the add variant returns dy for both x
and residual, with the downstream cotangent of ``resid`` added.

On a CUDA tensor the wrappers launch the kernels, or raise when the
kernels do not take the input (bf16 activations, f32 g and b, a last
axis that is a multiple of 8 up to ``MAX_WIDTH``). On a CPU tensor they
run the plain versions in this module (:func:`layer_norm_fwd_ref`,
:func:`layer_norm_bwd_ref`), which is what the tests here use. Nothing
falls back from the card to the plain versions.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches, so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_WIDTH = 8192  # the widest row the kernels take (kMaxWidth)
# The backward kernel's blocks: about three per SM of an H100 (132 SMs),
# each owning a contiguous range of rows.
BWD_TARGET_BLOCKS = 3 * 132

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    from dlrover_tpu_torch.ops import _build

    lib = _build.load("layer_norm")
    if not getattr(lib, "_dlrover_typed", False):
        lib.dlrover_layer_norm_fwd.argtypes = (
            [_P] * 8 + [_I, _I, _F, _I, _P]
        )
        lib.dlrover_layer_norm_bwd.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        lib.dlrover_layer_norm_fwd.restype = _I
        lib.dlrover_layer_norm_bwd.restype = _I
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
    return x.contiguous()


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
    return p.contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _fwd_cuda(x2, res2, g, b, eps, rms):
    global FWD_LAUNCHES
    x2 = _rows(x2, "x")
    n, e = x2.shape
    if res2 is not None:
        res2 = _rows(res2, "residual")
        if res2.shape != x2.shape or res2.dtype != x2.dtype:
            raise ValueError(
                f"residual {res2.dtype} {tuple(res2.shape)} must match x "
                f"{x2.dtype} {tuple(x2.shape)}"
            )
        if res2.device != x2.device:
            raise ValueError("residual must be on x's device")
    g = _param(g, e, x2.device, "g")
    b = _param(b, e, x2.device, "b")
    out = torch.empty_like(x2)
    resid = torch.empty_like(x2) if res2 is not None else None
    mu = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _lib().dlrover_layer_norm_fwd(
            x2.data_ptr(), _ptr(res2), g.data_ptr(), _ptr(b),
            out.data_ptr(), _ptr(resid), mu.data_ptr(), rstd.data_ptr(),
            n, e, float(eps), int(rms), stream,
        )
    _check(err, "norm forward")
    FWD_LAUNCHES += 1
    return out, resid, mu, rstd


def bwd_blocks(n: int) -> Tuple[int, int]:
    """(rows per block, blocks) of the backward kernel for n rows."""
    rows = max(1, -(-n // BWD_TARGET_BLOCKS))
    return rows, -(-n // rows)


def _bwd_cuda(dout2, y2, g, mu, rstd, rms, has_bias):
    global BWD_LAUNCHES
    dout2 = _rows(dout2, "dout")
    y2 = _rows(y2, "y")
    if y2.shape != dout2.shape or y2.dtype != dout2.dtype:
        raise ValueError(
            f"dout {dout2.dtype} {tuple(dout2.shape)} must match the "
            f"saved input {y2.dtype} {tuple(y2.shape)}"
        )
    n, e = dout2.shape
    g = _param(g, e, dout2.device, "g")
    mu, rstd = mu.contiguous(), rstd.contiguous()
    rows, blocks = bwd_blocks(n)
    dx = torch.empty_like(dout2)
    dg_part = torch.empty(
        (blocks, e), dtype=torch.float32, device=dout2.device
    )
    db_part = torch.empty_like(dg_part) if has_bias else None
    with torch.cuda.device(dout2.device):
        stream = torch.cuda.current_stream(dout2.device).cuda_stream
        err = _lib().dlrover_layer_norm_bwd(
            dout2.data_ptr(), y2.data_ptr(), g.data_ptr(), mu.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), dg_part.data_ptr(),
            _ptr(db_part), n, e, rows, int(rms), stream,
        )
    _check(err, "norm backward")
    BWD_LAUNCHES += 1
    db = db_part.sum(0) if has_bias else None
    return dx, dg_part.sum(0), db


def _fwd(x2, res2, g, b, eps, rms):
    if x2.is_cuda:
        return _fwd_cuda(x2, res2, g, b, eps, rms)
    return layer_norm_fwd_ref(x2, res2, g, b, eps, rms)


def _bwd(dout2, y2, g, mu, rstd, rms, has_bias):
    if dout2.is_cuda:
        return _bwd_cuda(dout2, y2, g, mu, rstd, rms, has_bias)
    return layer_norm_bwd_ref(dout2, y2, g, mu, rstd, rms, has_bias)


class _Norm(torch.autograd.Function):
    """norm(x) with the kernels' backward (the JAX ``_norm`` VJP)."""

    @staticmethod
    def forward(ctx, x, g, b, eps, rms):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        out, _, mu, rstd = _fwd(x2, None, g, b, eps, rms)
        ctx.save_for_backward(x2, g, mu, rstd)
        ctx.rms, ctx.has_bias = rms, b is not None
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, dout):
        x2, g, mu, rstd = ctx.saved_tensors
        dx, dg, db = _bwd(
            dout.reshape(x2.shape), x2, g, mu, rstd, ctx.rms, ctx.has_bias
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
        out, resid2, mu, rstd = _fwd(
            x.reshape(-1, e), res.reshape(-1, e), g, b, eps, rms
        )
        ctx.save_for_backward(resid2, g, mu, rstd)
        ctx.rms, ctx.has_bias = rms, b is not None
        return out.reshape(shape), resid2.reshape(shape)

    @staticmethod
    def backward(ctx, dout, dresid):
        resid2, g, mu, rstd = ctx.saved_tensors
        dy, dg, db = _bwd(
            dout.reshape(resid2.shape), resid2, g, mu, rstd, ctx.rms,
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
