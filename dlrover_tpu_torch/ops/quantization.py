"""Blockwise int8 and packed int4 quantization on the CUDA kernels of
``csrc/quantization.cu``.

Counterpart of ``dlrover_tpu/ops/quantization.py``, with the same public
functions, signatures and output shapes::

    q, scales, shape = quantize_blockwise(x, block_size)
      q int8 [n_blocks, block], scales f32 [n_blocks, 1]
    q, scales, shape = quantize_blockwise_4bit(x, block_size, signed)
      q uint8 [n_blocks, block / 2]: byte i holds element i of the block
      in its low nibble and element i + block / 2 in its high nibble
    x = dequantize_blockwise(q, scales, shape)
    x = dequantize_blockwise_4bit(q, scales, shape, signed)

Each block of ``block_size`` consecutive values of the flattened input
shares one f32 scale; the tail is zero-padded to a block multiple. The
arithmetic is the TPU kernels' as XLA compiles them, not the JAX
package's eager ``*_ref`` functions: the scale is ``absmax * (1/L)``
with 1/L rounded to f32 first (L = 127, 7 signed, 15 unsigned; XLA turns
``absmax / L`` into that product, which differs from a true division by
one ulp in some blocks), the code is ``round(x / max(scale, 1e-30))`` by
true division, half to even, clipped to the levels.

On a CUDA tensor the functions launch the kernels, or raise when the
kernels do not take the input (f32 values, block 1024, f32 output). On a
CPU tensor they run the plain versions in this module
(``*_plain``), which the tests here use; the ``*_plain`` functions take
tensors on any device, so a reference run on the card can call them
directly. Nothing falls back from the card to the plain versions.

``QUANT_LAUNCHES`` and ``DEQUANT_LAUNCHES`` count kernel launches, so a
run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

DEFAULT_BLOCK = 1024
KERNEL_BLOCK = 1024  # the only block size the kernels take (kBlock)

QUANT_LAUNCHES = 0
DEQUANT_LAUNCHES = 0

# 1/L rounded once to f32, by level count.
_RECIP = {L: float(np.float32(1.0) / np.float32(L)) for L in (127, 7, 15)}
_MIN_SCALE = 1e-30

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

Shape = Tuple[int, ...]


def reset_launch_counts() -> None:
    global QUANT_LAUNCHES, DEQUANT_LAUNCHES
    QUANT_LAUNCHES = 0
    DEQUANT_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    from dlrover_tpu_torch.ops import _build

    lib = _build.load("quantization")
    if not getattr(lib, "_dlrover_typed", False):
        for fn, extra in (
            (lib.dlrover_quantize, []),
            (lib.dlrover_dequantize, []),
            (lib.dlrover_quantize_nibble, [_I]),
            (lib.dlrover_dequantize_nibble, [_I]),
        ):
            fn.argtypes = [_P] * 3 + [_L, _L] + extra + [_P]
            fn.restype = _I
        lib._dlrover_typed = True
    return lib


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------


def _block_rows(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """x (any shape) -> f32 [n_blocks, block], the tail zero-padded."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block_size)


def _codes(x2: torch.Tensor, levels: int, lo: int, hi: int):
    """(codes as f32 [rows, block], scales f32 [rows, 1])."""
    scale = x2.abs().amax(dim=1, keepdim=True) * _RECIP[levels]
    safe = scale.clamp(min=_MIN_SCALE)
    return torch.round(x2 / safe).clamp(lo, hi), scale


def _unflatten(out: torch.Tensor, shape: Shape) -> torch.Tensor:
    return out.reshape(-1)[: math.prod(shape)].reshape(shape)


def quantize_blockwise_plain(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, Shape]:
    codes, scales = _codes(_block_rows(x, block_size), 127, -127, 127)
    return codes.to(torch.int8), scales, tuple(x.shape)


def dequantize_blockwise_plain(
    q: torch.Tensor, scales: torch.Tensor, shape: Shape,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    return _unflatten(q.float() * scales, shape).to(dtype)


def quantize_blockwise_4bit_plain(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK, signed: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, Shape]:
    x2 = _block_rows(x, block_size)
    if signed:
        codes, scales = _codes(x2, 7, -7, 7)
        codes = codes + 8.0  # 1..15
    else:
        codes, scales = _codes(x2, 15, 0, 15)
    codes = codes.to(torch.int32)
    half = block_size // 2
    packed = codes[:, :half] | (codes[:, half:] << 4)
    return packed.to(torch.uint8), scales, tuple(x.shape)


def dequantize_blockwise_4bit_plain(
    q: torch.Tensor, scales: torch.Tensor, shape: Shape,
    signed: bool = True, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    p = q.to(torch.int32)
    lo, hi = p & 15, (p >> 4) & 15
    if signed:
        lo, hi = lo - 8, hi - 8
    vals = torch.cat([lo, hi], dim=1).float()
    return _unflatten(vals * scales, shape).to(dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_block(block_size: int) -> None:
    if block_size != KERNEL_BLOCK:
        raise ValueError(
            f"the CUDA quantization kernels take block_size "
            f"{KERNEL_BLOCK}; got {block_size}"
        )


def _kernel_values(x: torch.Tensor) -> torch.Tensor:
    """x flattened for the quantize kernels, which read it as 16-byte
    vectors: f32, contiguous, 16-byte aligned. Nothing is padded."""
    if x.dtype != torch.float32:
        raise TypeError(
            f"the CUDA quantization kernels take float32 values; got "
            f"{x.dtype}"
        )
    flat = x.reshape(-1)
    if flat.data_ptr() % 16:
        raise ValueError(
            "the CUDA quantization kernels take 16-byte aligned values; "
            "this view starts inside a vector"
        )
    return flat


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _quantize_cuda(x, block_size, bits, signed):
    global QUANT_LAUNCHES
    _check_block(block_size)
    flat = _kernel_values(x)
    n = flat.numel()
    rows = -(-n // block_size)
    width = block_size if bits == 8 else block_size // 2
    q = torch.empty(
        (rows, width), dtype=torch.int8 if bits == 8 else torch.uint8,
        device=x.device,
    )
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows:
        with torch.cuda.device(x.device):
            lib = _lib()
            args = (flat.data_ptr(), q.data_ptr(), scales.data_ptr(), n, rows)
            if bits == 8:
                err = lib.dlrover_quantize(*args, _stream(x))
            else:
                err = lib.dlrover_quantize_nibble(
                    *args, int(signed), _stream(x)
                )
        _check(err, "quantize")
        QUANT_LAUNCHES += 1
    return q, scales, tuple(x.shape)


def _dequantize_cuda(q, scales, shape, bits, signed, dtype):
    global DEQUANT_LAUNCHES
    if dtype != torch.float32:
        raise TypeError(
            f"the CUDA dequantize kernels write float32; got {dtype}"
        )
    want = (torch.int8, 1) if bits == 8 else (torch.uint8, 2)
    rows = q.shape[0] if q.dim() == 2 else -1
    if (q.dtype != want[0] or q.dim() != 2
            or q.shape[1] * want[1] != KERNEL_BLOCK):
        raise ValueError(
            f"the CUDA dequantize kernels take {want[0]} codes "
            f"[n_blocks, {KERNEL_BLOCK // want[1]}]; got {q.dtype} "
            f"{tuple(q.shape)}"
        )
    if scales.dtype != torch.float32 or tuple(scales.shape) != (rows, 1):
        raise ValueError(
            f"scales must be float32 [{rows}, 1]; got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    if scales.device != q.device:
        raise ValueError("scales must be on the codes' device")
    n = math.prod(shape)
    if n > rows * KERNEL_BLOCK:
        raise ValueError(
            f"shape {tuple(shape)} holds more than the {rows} blocks given"
        )
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if rows and n:
        with torch.cuda.device(q.device):
            lib = _lib()
            args = (q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, rows)
            if bits == 8:
                err = lib.dlrover_dequantize(*args, _stream(q))
            else:
                err = lib.dlrover_dequantize_nibble(
                    *args, int(signed), _stream(q)
                )
        _check(err, "dequantize")
        DEQUANT_LAUNCHES += 1
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Public functions: the kernels on CUDA tensors, the plain versions on CPU
# ---------------------------------------------------------------------------


def quantize_blockwise(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, Shape]:
    """x (any shape) -> (int8 values [n_blocks, block], f32 scales
    [n_blocks, 1], original shape)."""
    if x.is_cuda:
        return _quantize_cuda(x, block_size, 8, True)
    return quantize_blockwise_plain(x, block_size)


def dequantize_blockwise(
    q: torch.Tensor, scales: torch.Tensor, shape: Shape,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    if q.is_cuda:
        return _dequantize_cuda(q, scales, shape, 8, True, dtype)
    return dequantize_blockwise_plain(q, scales, shape, dtype)


def quantize_blockwise_4bit(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK, signed: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, Shape]:
    """x (any shape) -> (uint8 packed [n_blocks, block/2], f32 scales
    [n_blocks, 1], original shape). signed: levels -7..7 stored +8
    (scale absmax/7); unsigned: 0..15 (absmax/15)."""
    if x.is_cuda:
        return _quantize_cuda(x, block_size, 4, signed)
    return quantize_blockwise_4bit_plain(x, block_size, signed)


def dequantize_blockwise_4bit(
    q: torch.Tensor, scales: torch.Tensor, shape: Shape,
    signed: bool = True, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    if q.is_cuda:
        return _dequantize_cuda(q, scales, shape, 4, signed, dtype)
    return dequantize_blockwise_4bit_plain(q, scales, shape, signed, dtype)
