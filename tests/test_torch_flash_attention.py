"""The port's flash attention against the JAX package's.

The same inputs, made with numpy from a seed, go through
``dlrover_tpu.ops.flash_attention`` (the Pallas kernels in interpret
mode, as tests/test_flash_attention.py runs them on the CPU) and
``dlrover_tpu_torch.ops.flash_attention`` (on the CPU, the plain
versions of the CUDA kernels): outputs, lse and the gradients of q, k
and v, at both head_dims the CUDA kernels are compiled for (64, GPT-2;
128, Llama, whose softmax scale 1/sqrt(128) is not folded into q).

Tolerances: f32 2e-5 (both sides compute in f32; only the order of the
sums differs). bf16 2e-2 relative to the largest value: the Pallas
kernel rounds P and dS to bf16 before its second products, the plain
version keeps them f32, and both round the outputs to bf16 (2^-8).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import flash_attention as tfa

# dlrover_tpu.ops re-exports the function under the module's name.
jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(seed, b, tq, tk, h=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    g_lse = rng.standard_normal((b, h, tq)).astype(np.float32)
    return q, k, v, do, g_lse


def _run_both(jax_fn, torch_fn, arrays, cotangents, dtype):
    """Outputs and input gradients of both sides, as f32 numpy."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jin = [jnp.asarray(a, jdt) for a in arrays]
    jout, vjp = jax.vjp(jax_fn, *jin)
    jout = jout if isinstance(jout, tuple) else (jout,)
    jcot = tuple(
        jnp.asarray(c, o.dtype) for c, o in zip(cotangents, jout)
    )
    jgrads = vjp(jcot if len(jcot) > 1 else jcot[0])
    tin = [torch.tensor(a).to(tdt).requires_grad_(True) for a in arrays]
    tout = torch_fn(*tin)
    tout = tout if isinstance(tout, tuple) else (tout,)
    tcot = [torch.tensor(c).to(o.dtype) for c, o in zip(cotangents, tout)]
    tgrads = torch.autograd.grad(tout, tin, tcot)

    def np32(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().numpy()
        return np.asarray(jnp.asarray(x, jnp.float32))

    return (
        [np32(x) for x in jout], [np32(x) for x in tout],
        [np32(x) for x in jgrads], [np32(x) for x in tgrads],
    )


def _assert_close(ref, got, dtype):
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=F32_TOL, rtol=F32_TOL)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            assert float(np.abs(g - r).max()) <= BF16_TOL * scale


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU the wrappers run the plain versions: no launches."""
    tfa.reset_launch_counts()
    yield
    assert tfa.FWD_LAUNCHES == 0 and tfa.BWD_LAUNCHES == 0


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 256])
def test_square_forward_and_grads(causal, t, d):
    q, k, v, do, _ = _inputs(t + causal, 2, t, t, d=d)
    jo, to, jg, tg = _run_both(
        lambda q, k, v: jfa.flash_attention(
            q, k, v, causal=causal, interpret=True
        ),
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal),
        (q, k, v), (do,), "float32",
    )
    _assert_close(jo, to, "float32")
    _assert_close(jg, tg, "float32")


def test_key_padding_t120():
    # JAX pads 120 to its block multiple and masks the pad keys; the
    # port masks the ragged edge with no pad.
    q, k, v, do, _ = _inputs(3, 2, 120, 120)
    jo, to, jg, tg = _run_both(
        lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True),
        lambda q, k, v: tfa.flash_attention(q, k, v),
        (q, k, v), (do,), "float32",
    )
    _assert_close(jo, to, "float32")
    _assert_close(jg, tg, "float32")


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_sliding_window_48(d):
    q, k, v, do, _ = _inputs(4, 2, 128, 128, d=d)
    jo, to, jg, tg = _run_both(
        lambda q, k, v: jfa.flash_attention(
            q, k, v, window=48, interpret=True
        ),
        lambda q, k, v: tfa.flash_attention(q, k, v, window=48),
        (q, k, v), (do,), "float32",
    )
    _assert_close(jo, to, "float32")
    _assert_close(jg, tg, "float32")


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize(
    "causal,q_offset", [(True, None), (True, 64), (False, 0)]
)
def test_rect_q_offset(causal, q_offset, d):
    q, k, v, do, _ = _inputs(5, 2, 64, 192, d=d)
    jo, to, jg, tg = _run_both(
        lambda q, k, v: jfa.flash_attention_rect(
            q, k, v, causal=causal, q_offset=q_offset, interpret=True
        ),
        lambda q, k, v: tfa.flash_attention_rect(
            q, k, v, causal=causal, q_offset=q_offset
        ),
        (q, k, v), (do,), "float32",
    )
    _assert_close(jo, to, "float32")
    _assert_close(jg, tg, "float32")


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("rect", [False, True])
def test_return_lse_with_lse_cotangent(rect, d):
    tq = 64 if rect else 128
    q, k, v, do, g_lse = _inputs(6, 2, tq, 128, d=d)
    if rect:
        jf = lambda q, k, v: jfa.flash_attention_rect(  # noqa: E731
            q, k, v, return_lse=True, interpret=True
        )
        tf = lambda q, k, v: tfa.flash_attention_rect(  # noqa: E731
            q, k, v, return_lse=True
        )
    else:
        jf = lambda q, k, v: jfa.flash_attention(  # noqa: E731
            q, k, v, return_lse=True, interpret=True
        )
        tf = lambda q, k, v: tfa.flash_attention(  # noqa: E731
            q, k, v, return_lse=True
        )
    jo, to, jg, tg = _run_both(jf, tf, (q, k, v), (do, g_lse), "float32")
    assert to[1].shape == (2, 2, tq)
    _assert_close(jo, to, "float32")
    _assert_close(jg, tg, "float32")


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_and_grads(causal, d):
    q, k, v, do, _ = _inputs(7, 2, 128, 128, d=d)
    jo, to, jg, tg = _run_both(
        lambda q, k, v: jfa.flash_attention(
            q, k, v, causal=causal, interpret=True
        ),
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal),
        (q, k, v), (do,), "bfloat16",
    )
    _assert_close(jo, to, "bfloat16")
    _assert_close(jg, tg, "bfloat16")


def test_plain_backward_matches_autograd_of_plain_forward():
    """The plain version of the backward kernels (dense recompute from
    lse, delta folded outside) against autograd through the plain
    forward: the identity the CUDA backward relies on."""
    q, k, v, do, g_lse = _inputs(8, 2, 96, 96)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = tfa.flash_attention_ref(tq, tk, tv, True, 0.125, 40, 0)
    want = torch.autograd.grad(
        (o, lse), (tq, tk, tv), (torch.tensor(do), torch.tensor(g_lse))
    )
    delta = (torch.tensor(do) * o).sum(-1).transpose(1, 2) - torch.tensor(
        g_lse
    )
    got = tfa.flash_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), lse.detach(),
        torch.tensor(do), delta.detach(), True, 0.125, 40, 0,
    )
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)


def test_argument_checks_match_jax():
    q = torch.zeros(1, 16, 1, 64)
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="window must be"):
        tfa.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="q_offset >= 0"):
        tfa.flash_attention_rect(q, q[:, :8], q[:, :8], q_offset=None)
