"""Carry parameter trees between the JAX package and the port.

The port keeps the JAX tree as it is (the same keys, stacked block
leaves, weights in the ``[in, out]`` orientation), so conversion is
per leaf and needs no transposes. The trees travel as nested dicts of
numpy arrays: ``np.asarray`` on each JAX leaf gives one, and this
module imports nothing of JAX.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they go through float32 (exact) and then
to ``torch.bfloat16``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
}


def params_from_jax(tree: Dict[str, Any], device: DeviceLike = None):
    """Nested dict of numpy arrays (JAX leaves) -> nested dict of
    tensors of the same dtypes on ``device`` (CUDA unless the caller
    passes ``device="cpu"``)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        dtype = _DTYPES.get(a.dtype.name)
        if dtype is None:
            raise TypeError(f"no torch dtype for a {a.dtype} leaf")
        if dtype in (torch.bfloat16, torch.float16):
            a = a.astype(np.float32)
        # torch.tensor copies: numpy views of JAX arrays are read-only
        return torch.tensor(a).to(dev, dtype)

    return _map(leaf, tree)


def cache_from_jax(cache, device: DeviceLike = None):
    """A JAX ``KVCache`` (numpy ``k``/``v`` of ``[L, B, T, H_kv, D]``)
    -> the port's ``generate.KVCache`` of the same values, on its
    head-major storage."""
    from dlrover_tpu_torch.models.generate import KVCache

    def leaf(a):
        t = params_from_jax({"a": a}, device)["a"]
        return t.transpose(2, 3).contiguous().transpose(2, 3)

    return KVCache(k=leaf(cache.k), v=leaf(cache.v))


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays. bf16 and
    f16 leaves come back as float32 (exact); ``jnp.asarray(x, dtype)``
    restores the JAX dtype."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()

    return _map(leaf, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
