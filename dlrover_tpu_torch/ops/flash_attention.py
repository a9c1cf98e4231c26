"""Flash attention (forward and backward) on the CUDA kernels of
``csrc/flash_attention.cu``.

Counterpart of ``dlrover_tpu/ops/flash_attention.py``: the same public
functions on the same ``[batch, seq, heads, head_dim]`` layout, the same
masks (causal, Mistral sliding window, ragged key edge, ``q_offset`` for
rectangular calls) and the same differentiable logsumexp. Power-of-two
softmax scales (1/8 at head_dim 64) are folded into q before the kernel,
as the JAX wrapper does, so autograd routes the q-gradient's scale
through that multiply; any other scale (1/sqrt(128) at head_dim 128)
reaches the kernel's ``scale`` argument.

On a CUDA tensor the wrappers launch the kernels, or raise when the
kernel does not take the input (it takes bf16 with head_dim 64 or 128).
On a CPU tensor they run the plain versions in this module
(:func:`flash_attention_ref` and :func:`flash_attention_bwd_ref`), which
is what the tests here use. Nothing falls back from the card to the
plain versions.

``FWD_LAUNCHES`` counts forward kernel launches and ``BWD_LAUNCHES``
backward launches (each launches the dk/dv and the dq kernel), so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

HEAD_DIMS = (64, 128)  # the head_dims the CUDA kernels are compiled for

_I, _LL, _F, _P = (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
)
_STRIDES = [_LL] * 3
# scale, causal, window, q_offset, seq_len, stream
_MASK = [_F, _I, _I, _I, _I, _P]


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    from dlrover_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_dlrover_typed", False):
        lib.dlrover_flash_fwd.argtypes = (
            [_P] * 5 + [_I] * 5 + _STRIDES * 3 + _MASK
        )
        lib.dlrover_flash_bwd_dkdv.argtypes = (
            [_P] * 8 + [_I] * 5 + _STRIDES * 4 + _MASK
        )
        lib.dlrover_flash_bwd_dq.argtypes = (
            [_P] * 7 + [_I] * 5 + _STRIDES * 4 + _MASK
        )
        for fn in (
            lib.dlrover_flash_fwd,
            lib.dlrover_flash_bwd_dkdv,
            lib.dlrover_flash_bwd_dq,
        ):
            fn.restype = _I
        lib._dlrover_typed = True
    return lib


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------


def attention_mask(
    tq: int, tk: int, causal: bool, window: Optional[int], q_offset: int,
    device=None,
) -> torch.Tensor:
    """[tq, tk] bool: which keys each query row sees. Query row i sits
    at key position ``q_offset + i``; under ``window`` it sees keys
    (pos - window, pos]."""
    qp = q_offset + torch.arange(tq, device=device)[:, None]
    kp = torch.arange(tk, device=device)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    return mask


def flash_attention_ref(
    q, k, v, causal: bool, scale: float, window: Optional[int] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked softmax attention with f32 statistics: (o in q's
    dtype [B, Tq, H, D], lse f32 [B, H, Tq]). Rows that see no key get
    o = 0 and lse = -inf, as the kernel gives them."""
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    s = qf @ kf.transpose(-1, -2) * scale
    mask = attention_mask(
        q.shape[1], k.shape[1], causal, window, q_offset, q.device
    )
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    o = (p @ vf).transpose(1, 2).to(q.dtype)
    return o, lse


def flash_attention_bwd_ref(
    q, k, v, lse, do, delta, causal: bool, scale: float,
    window: Optional[int] = None, q_offset: int = 0,
):
    """(dq, dk, dv) of attention from the forward's lse, recomputing
    P = exp(S - lse) densely in f32. ``delta`` [B, H, Tq] is
    rowsum(dO * O) minus the lse cotangent."""
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    dof = do.float().transpose(1, 2)
    mask = attention_mask(
        q.shape[1], k.shape[1], causal, window, q_offset, q.device
    )
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    return tuple(
        g.transpose(1, 2).to(x.dtype) for g, x in ((dq, q), (dk, k), (dv, v))
    )


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _kernel_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """Check a [B, T, H, D] input for the kernel, which reads it with TMA
    through its strides: bf16, head_dim in HEAD_DIMS, unit stride on the
    head dim, and a base and strides that are multiples of 16 bytes."""
    if x.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA flash-attention kernel takes bfloat16; {name} is "
            f"{x.dtype}"
        )
    if x.dim() != 4 or x.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash-attention kernel takes [B, T, H, D] with "
            f"head_dim D in {HEAD_DIMS}; {name} has shape {tuple(x.shape)}"
        )
    if x.stride(-1) != 1:
        raise ValueError(
            f"{name} must have unit stride on its head dim (strides "
            f"{x.stride()})"
        )
    if x.data_ptr() % 16:
        raise ValueError(
            f"{name}'s base address is not 16-byte aligned, as the "
            "kernel's TMA loads need"
        )
    if any(s % 8 for s in _strides(x)):
        raise ValueError(
            f"{name}'s strides {x.stride()} are not multiples of 16 bytes, "
            "as the kernel's TMA loads need"
        )
    return x


def _check_kv(q, k, v) -> None:
    if k.shape != v.shape or k.shape[0] != q.shape[0] or (
        k.shape[2] != q.shape[2]
    ):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must share q's "
            f"batch and heads ({tuple(q.shape)}) and one length"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _strides(x: torch.Tensor):
    """Element strides of B, T and H. A dim of size 1 is never stepped
    over, so its stride (which PyTorch leaves arbitrary) is given as 8."""
    return tuple(
        x.stride(i) if x.shape[i] > 1 else 8 for i in range(3)
    )


def _mask_args(x, causal, scale, window, q_offset, seq_len):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return (
        float(scale), int(bool(causal)), int(window or 0), int(q_offset),
        int(seq_len), stream,
    )


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _fwd_cuda(q, k, v, causal, scale, window, q_offset):
    global FWD_LAUNCHES
    q, k, v = (_kernel_input(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v")))
    _check_kv(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().dlrover_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, tq, tk, h, d,
            *_strides(q), *_strides(k), *_strides(v),
            *_mask_args(q, causal, scale, window, q_offset, tk),
        )
    _check(err, "flash attention forward")
    FWD_LAUNCHES += 1
    return o, lse


def _bwd_cuda(q, k, v, lse, do, delta, causal, scale, window, q_offset):
    global BWD_LAUNCHES
    # autograd's dO can arrive with any strides
    q, k, v, do = (
        _kernel_input(x, n)
        for x, n in ((q, "q"), (k, "k"), (v, "v"), (do.contiguous(), "do"))
    )
    _check_kv(q, k, v)
    if do.shape != q.shape:
        raise ValueError(
            f"do {tuple(do.shape)} must match q {tuple(q.shape)}"
        )
    lse, delta = lse.contiguous(), delta.contiguous()
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=q.device)
    strides = (*_strides(q), *_strides(k), *_strides(v), *_strides(do))
    mask = _mask_args(q, causal, scale, window, q_offset, tk)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.dlrover_flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, tq, tk, h, d, *strides, *mask,
        )
        _check(err, "flash attention backward (dk, dv)")
        err = lib.dlrover_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, tq, tk, h, d, *strides, *mask,
        )
        _check(err, "flash attention backward (dq)")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def _fwd(q, k, v, causal, scale, window, q_offset):
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal, scale, window, q_offset)
    return flash_attention_ref(q, k, v, causal, scale, window, q_offset)


def _bwd(q, k, v, lse, do, delta, causal, scale, window, q_offset):
    if q.is_cuda:
        return _bwd_cuda(
            q, k, v, lse, do, delta, causal, scale, window, q_offset
        )
    return flash_attention_bwd_ref(
        q, k, v, lse, do, delta, causal, scale, window, q_offset
    )


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with the kernels' backward. The lse output is
    differentiable: its cotangent folds into delta (dlse/ds_j = p_j)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, q_offset):
        o, lse = _fwd(q, k, v, causal, scale, window, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window, q_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        delta = (g_o.float() * o.float()).sum(-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse
        dq, dk, dv = _bwd(q, k, v, lse, g_o, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def _fold_scale(q, scale, d):
    """Default scale 1/sqrt(d); a power of two multiplies q exactly in
    any float dtype, so it is folded into q and the kernel runs with 1."""
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if scale != 1.0 and math.frexp(scale)[0] == 0.5:
        return q * scale, 1.0
    return q, scale


def _check_window(window, causal):
    if window is None:
        return
    if not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True"
        )
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    return_lse: bool = False,
):
    """Flash attention on [batch, seq, heads, head_dim] inputs.

    ``return_lse=True`` also returns the per-row logsumexp [B, H, T]
    (f32, differentiable). ``window`` is Mistral's sliding window:
    query i attends to keys (i - window, i]; it requires ``causal``.
    """
    t, d = q.shape[1], q.shape[-1]
    _check_window(window, causal)
    if window is not None and window >= t:
        window = None  # the band covers the whole sequence
    q, scale = _fold_scale(q, scale, d)
    o, lse = _FlashAttention.apply(q, k, v, causal, scale, window, 0)
    return (o, lse) if return_lse else o


def flash_attention_rect(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: Optional[int] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    return_lse: bool = False,
):
    """Rectangular flash attention: q [B, Tq, H, D] against
    k/v [B, Tk, H, D]. ``q_offset`` is the key position of query row 0
    (causal: row i attends keys j <= q_offset + i); it defaults to
    ``Tk - Tq``, the queries being the last Tq positions."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    if q_offset is None:
        q_offset = tk - tq
    if causal and q_offset < 0:
        raise ValueError(
            f"causal rectangular attention needs q_offset >= 0 (got "
            f"{q_offset}): q rows before key 0 would attend nothing"
        )
    _check_window(window, causal)
    if window is not None and window > q_offset + tq:
        window = None  # the band covers every visible key
    q, scale = _fold_scale(q, scale, d)
    o, lse = _FlashAttention.apply(q, k, v, causal, scale, window, q_offset)
    return (o, lse) if return_lse else o
