"""The port's blockwise quantizers against the JAX package's kernels.

The same inputs, made with numpy from a seed, go through
``dlrover_tpu.ops.quantization`` (the Pallas kernels in interpret mode,
as tests/test_optim.py runs them on the CPU) and
``dlrover_tpu_torch.ops.quantization`` (on the CPU, the plain versions
of the CUDA kernels): int8, signed int4 and unsigned int4, on a
one-block-multiple shape, a ragged 2-D shape, a multi-block 2-D shape,
at block sizes 256 and 1024, and on an all-zero input, a single
non-zero value and lognormal magnitudes from 1e-30 up. Compared
bitwise: codes or packed bytes, scales, and the dequantized values.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import quantization as tq

jq = importlib.import_module("dlrover_tpu.ops.quantization")

SHAPES = [(4096,), (3, 1000), (6, 2048)]
VARIANTS = [(8, True), (4, True), (4, False)]  # (bits, signed)
LEVELS = {(8, True): 127, (4, True): 7, (4, False): 15}


def _values(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if kind == "normal":
        x = rng.standard_normal(n)
    elif kind == "zeros":
        x = np.zeros(n)
    elif kind == "one_nonzero":
        x = np.zeros(n)
        x[n // 3] = -2.5
    elif kind == "lognormal":
        # magnitudes from ~1e-30 to ~1e4, random signs
        mag = np.exp(rng.uniform(np.log(1e-30), np.log(1e4), n))
        x = mag * rng.choice([-1.0, 1.0], n)
    else:
        raise ValueError(kind)
    return x.reshape(shape).astype(np.float32)


def _jax(x, block, bits, signed):
    if bits == 8:
        q, s, sh = jq.quantize_blockwise(jnp.asarray(x), block)
        d = jq.dequantize_blockwise(q, s, sh)
    else:
        q, s, sh = jq.quantize_blockwise_4bit(jnp.asarray(x), block, signed)
        d = jq.dequantize_blockwise_4bit(q, s, sh, signed)
    return np.asarray(q), np.asarray(s), tuple(sh), np.asarray(d)


def _port(x, block, bits, signed):
    t = torch.tensor(x)
    if bits == 8:
        q, s, sh = tq.quantize_blockwise(t, block)
        d = tq.dequantize_blockwise(q, s, sh)
    else:
        q, s, sh = tq.quantize_blockwise_4bit(t, block, signed)
        d = tq.dequantize_blockwise_4bit(q, s, sh, signed)
    return q.numpy(), s.numpy(), sh, d.numpy()


def _assert_bitwise(x, block, bits, signed):
    jqv, js, jsh, jd = _jax(x, block, bits, signed)
    tqv, ts, tsh, td = _port(x, block, bits, signed)
    assert tqv.dtype == jqv.dtype and tqv.shape == jqv.shape
    assert ts.dtype == js.dtype == np.float32 and ts.shape == js.shape
    np.testing.assert_array_equal(tqv, jqv)
    np.testing.assert_array_equal(ts.view(np.uint32), js.view(np.uint32))
    assert tsh == jsh == x.shape
    assert td.shape == jd.shape == x.shape
    np.testing.assert_array_equal(td.view(np.uint32), jd.view(np.uint32))


@pytest.mark.parametrize("bits,signed", VARIANTS)
@pytest.mark.parametrize("block", [256, 1024])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantizers_match_the_jax_kernels_bitwise(shape, block, bits, signed):
    _assert_bitwise(_values("normal", shape, seed=1), block, bits, signed)


@pytest.mark.parametrize("bits,signed", VARIANTS)
@pytest.mark.parametrize("kind", ["zeros", "one_nonzero", "lognormal"])
def test_edge_values_match_the_jax_kernels_bitwise(kind, bits, signed):
    _assert_bitwise(_values(kind, (3, 1000), seed=2), 1024, bits, signed)


@pytest.mark.parametrize("bits,signed", VARIANTS)
def test_scale_is_absmax_times_the_f32_reciprocal(bits, signed):
    """The scale is absmax * f32(1/L), as the TPU kernel computes it
    under jit, not absmax / L: XLA folds the division by the constant L
    into a multiply by its f32 reciprocal, which differs from the true
    quotient by one ulp in some blocks (most of them at 4 bits). The
    JAX package's eager ``quantize_blockwise_ref`` divides exactly, so
    it is not what the optimizer state holds; the port follows the
    kernel. The codes, in turn, are a true division by the scale."""
    x = _values("normal", (256, 1024), seed=3)
    L = LEVELS[(bits, signed)]
    absmax = np.abs(x).max(axis=1, keepdims=True)
    if bits == 8:
        _, s, _ = tq.quantize_blockwise(torch.tensor(x), 1024)
    else:
        _, s, _ = tq.quantize_blockwise_4bit(torch.tensor(x), 1024, signed)
    np.testing.assert_array_equal(s.numpy(), absmax * np.float32(1.0 / L))
    # the convention matters: true division differs in some blocks
    assert (s.numpy() != absmax / np.float32(L)).any()


def test_int4_pairs_element_i_with_i_plus_half_a_block():
    x = np.zeros((1, 1024), np.float32)
    x[0, 0], x[0, 512], x[0, 1] = 7.0, -7.0, 1.0
    q, s, _ = tq.quantize_blockwise_4bit(torch.tensor(x), 1024, True)
    assert s.item() == np.float32(7.0) * np.float32(1.0 / 7)
    # element 0: code 7 + 8 = 15 low; element 512: -7 + 8 = 1 high
    assert q[0, 0].item() == 15 | (1 << 4)
    assert q[0, 1].item() == 9 | (8 << 4)  # element 1 low, 513 (0) high


def test_cpu_tensors_take_the_plain_path_without_launches():
    tq.reset_launch_counts()
    x = torch.tensor(_values("normal", (2, 1500)))
    for bits in (8, 4):
        if bits == 8:
            q, s, sh = tq.quantize_blockwise(x)
            tq.dequantize_blockwise(q, s, sh)
        else:
            q, s, sh = tq.quantize_blockwise_4bit(x, signed=False)
            tq.dequantize_blockwise_4bit(q, s, sh, signed=False)
    assert tq.QUANT_LAUNCHES == 0 and tq.DEQUANT_LAUNCHES == 0


def test_dequantize_casts_to_the_requested_dtype():
    x = torch.tensor(_values("normal", (4096,)))
    q, s, sh = tq.quantize_blockwise(x)
    out = tq.dequantize_blockwise(q, s, sh, dtype=torch.bfloat16)
    ref = tq.dequantize_blockwise(q, s, sh).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def test_profile_puts_the_kernels_in_the_quant_family():
    from dlrover_tpu_torch.trainer.profile import kernel_family

    for name in (
        "(anonymous namespace)::quantize_kernel(float const*, signed "
        "char*, float*, long long, long long)",
        "(anonymous namespace)::dequantize_kernel(signed char const*, "
        "float const*, float*, long long, long long)",
        "void (anonymous namespace)::quantize_nibble_kernel<true>(float "
        "const*, unsigned char*, float*, long long, long long)",
        "void (anonymous namespace)::dequantize_nibble_kernel<false>("
        "unsigned char const*, float const*, float*, long long, long long)",
    ):
        assert kernel_family(name) == "quant", name
    assert kernel_family("void at::native::vectorized_elementwise_kernel"
                         "<4, at::native::AbsFunctor<float>>") == "other"
