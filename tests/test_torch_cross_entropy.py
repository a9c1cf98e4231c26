"""The port's fused cross-entropy against the JAX package's.

Loss, dx and dwte of ``dlrover_tpu_torch.ops.cross_entropy`` against
``dlrover_tpu.ops.cross_entropy.fused_cross_entropy`` on the same numpy
inputs, with ``save_logits`` off and on.

Tolerances: f32 1e-5 (the same f32 arithmetic in another sum order).
bf16 2e-2 relative to the largest value: both sides cast the cotangent
to bf16 before the unembedding matmuls, but round inside those matmuls
at different places; ``save_logits`` also rounds the logits to bf16.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops.cross_entropy import dot_f32, fused_cross_entropy

jce = importlib.import_module("dlrover_tpu.ops.cross_entropy")

N, E, V, CHUNKS = 64, 128, 256, 4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, E)).astype(np.float32)
    wte = (0.1 * rng.standard_normal((V, E))).astype(np.float32)
    targets = rng.integers(0, V, size=N).astype(np.int32)
    return x, wte, targets


def _close(got, ref, dtype):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("save_logits", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype, save_logits):
    x, wte, targets = _inputs(0)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def jloss(x, wte):
        return jce.fused_cross_entropy(
            x, wte, jnp.asarray(targets), CHUNKS, save_logits
        )

    jl, (jdx, jdwte) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x, jdt), jnp.asarray(wte, jdt)
    )
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    tw = torch.tensor(wte).to(tdt).requires_grad_(True)
    tl = fused_cross_entropy(
        tx, tw, torch.tensor(targets).long(), CHUNKS, save_logits
    )
    tdx, tdw = torch.autograd.grad(tl, (tx, tw))
    assert tdx.dtype == tdt and tdw.dtype == tdt
    _close(tl.item(), float(jl), dtype)
    _close(tdx.float().numpy(), jnp.asarray(jdx, jnp.float32), dtype)
    _close(tdw.float().numpy(), jnp.asarray(jdwte, jnp.float32), dtype)


def test_matches_plain_log_softmax_loss():
    x, wte, targets = _inputs(1)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(wte, requires_grad=True)
    t = torch.tensor(targets).long()
    fused = fused_cross_entropy(tx, tw, t, CHUNKS)
    plain = torch.nn.functional.cross_entropy(tx @ tw.t(), t)
    g_fused = torch.autograd.grad(fused, (tx, tw))
    g_plain = torch.autograd.grad(plain, (tx, tw))
    torch.testing.assert_close(fused, plain, atol=1e-5, rtol=1e-5)
    for a, b in zip(g_fused, g_plain):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_dot_f32_keeps_exact_bf16_products():
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.standard_normal((8, 16)), dtype=torch.bfloat16)
    b = torch.tensor(rng.standard_normal((16, 4)), dtype=torch.bfloat16)
    out = dot_f32(a, b)
    assert out.dtype == torch.float32
    want = a.double() @ b.double()
    torch.testing.assert_close(out.double(), want, atol=1e-5, rtol=1e-6)


def test_chunks_must_divide_tokens():
    x, wte, targets = _inputs(3)
    with pytest.raises(ValueError, match="num_chunks"):
        fused_cross_entropy(
            torch.tensor(x), torch.tensor(wte),
            torch.tensor(targets).long(), 5,
        )
