"""The port's fused norms against the JAX package's.

The same inputs, made with numpy from a seed, go through
``dlrover_tpu.ops.layer_norm`` (the Pallas kernels in interpret mode, as
tests/test_layer_norm.py runs them on the CPU) and
``dlrover_tpu_torch.ops.layer_norm`` (on the CPU, the plain versions of
the CUDA kernels): the four public functions, in f32 and bf16, on
(3, 70, 64) inputs (210 rows: not a multiple of the TPU's row block),
with and without bias. Compared: the outputs, ``resid`` of the add
variants, and the gradients of x, residual, g and b under an output
cotangent and a downstream ``resid`` cotangent.

Tolerances, on the largest difference over max(1, the largest value):
f32 1e-5 (the same f32 arithmetic with sums in another order; measured
1.8e-7). bf16 outputs and dx 2^-7 (one bf16 ulp: both sides
compute in f32 and round once; an f32 result a hair apart can round to
the neighbouring bf16 value; measured 1.3e-8); dg and db are f32 sums
on both sides, 1e-5 as in f32 (measured 2.2e-7).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import layer_norm as tln

jln = importlib.import_module("dlrover_tpu.ops.layer_norm")

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name, add variant, rms, bias
VARIANTS = [
    ("layer_norm", False, False, True),
    ("layer_norm_no_bias", False, False, False),
    ("rms_norm", False, True, False),
    ("add_layer_norm", True, False, True),
    ("add_layer_norm_no_bias", True, False, False),
    ("add_rms_norm", True, True, False),
]


def _data(seed=0, shape=(3, 70, 64)):
    rng = np.random.default_rng(seed)
    e = shape[-1]
    return dict(
        x=rng.standard_normal(shape).astype(np.float32) + 0.5,
        res=rng.standard_normal(shape).astype(np.float32),
        g=(rng.standard_normal(e) + 1.0).astype(np.float32),
        b=(rng.standard_normal(e) * 0.1).astype(np.float32),
        dout=rng.standard_normal(shape).astype(np.float32),
        dresid=rng.standard_normal(shape).astype(np.float32),
    )


def _fns(add, rms, bias):
    """(jax fn, torch fn) over (x[, res], g[, b])."""
    if add and rms:
        return (
            lambda x, r, g: jln.fused_add_rms_norm(x, r, g, interpret=True),
            tln.fused_add_rms_norm,
        )
    if add:
        if bias:
            return (
                lambda x, r, g, b: jln.fused_add_layer_norm(
                    x, r, g, b, interpret=True
                ),
                tln.fused_add_layer_norm,
            )
        return (
            lambda x, r, g: jln.fused_add_layer_norm(
                x, r, g, None, interpret=True
            ),
            lambda x, r, g: tln.fused_add_layer_norm(x, r, g, None),
        )
    if rms:
        return (
            lambda x, g: jln.fused_rms_norm(x, g, interpret=True),
            tln.fused_rms_norm,
        )
    if bias:
        return (
            lambda x, g, b: jln.fused_layer_norm(x, g, b, interpret=True),
            tln.fused_layer_norm,
        )
    return (
        lambda x, g: jln.fused_layer_norm(x, g, None, interpret=True),
        lambda x, g: tln.fused_layer_norm(x, g, None),
    )


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On the CPU the wrappers run the plain versions: no launches."""
    tln.reset_launch_counts()
    yield
    assert tln.FWD_LAUNCHES == 0 and tln.BWD_LAUNCHES == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,add,rms,bias", VARIANTS, ids=[v[0] for v in VARIANTS]
)
def test_outputs_and_grads_match_jax(name, add, rms, bias, dtype):
    d = _data()
    names = ["x"] + (["res"] if add else []) + ["g"] + (["b"] if bias else [])
    acts = {"x", "res"}
    jfn, tfn = _fns(add, rms, bias)
    jin = [
        jnp.asarray(d[n], JDT[dtype] if n in acts else jnp.float32)
        for n in names
    ]
    tin = [
        torch.tensor(d[n])
        .to(TDT[dtype] if n in acts else torch.float32)
        .requires_grad_(True)
        for n in names
    ]
    jout, vjp = jax.vjp(jfn, *jin)
    tout = tfn(*tin)
    cot = ["dout"] + (["dresid"] if add else [])
    jouts = jout if add else (jout,)
    touts = tout if add else (tout,)
    jgrads = vjp(
        tuple(jnp.asarray(d[c], JDT[dtype]) for c in cot) if add
        else jnp.asarray(d["dout"], JDT[dtype])
    )
    tgrads = torch.autograd.grad(
        touts, tin, [torch.tensor(d[c]).to(TDT[dtype]) for c in cot]
    )
    act_tol = F32_TOL if dtype == "float32" else BF16_TOL
    for what, j, t in zip(("out", "resid"), jouts, touts):
        assert t.dtype == TDT[dtype]
        _close(t, j, act_tol, what)
    for n, j, t in zip(names, jgrads, tgrads):
        assert t.dtype == tin[names.index(n)].dtype
        _close(t, j, act_tol if n in acts else F32_TOL, f"d{n}")


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("rms", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(rms, add):
    """The plain version of the backward kernel against autograd
    through the plain forward (both in f32): the identity the CUDA
    backward relies on."""
    d = _data(1)
    x2 = torch.tensor(d["x"]).reshape(-1, 64).requires_grad_(True)
    r2 = torch.tensor(d["res"]).reshape(-1, 64)
    g = torch.tensor(d["g"]).requires_grad_(True)
    b = None if rms else torch.tensor(d["b"]).requires_grad_(True)
    dout = torch.tensor(d["dout"]).reshape(-1, 64)
    out, resid, mu, rstd = tln.layer_norm_fwd_ref(
        x2, r2 if add else None, g, b, 1e-5, rms
    )
    wrt = (x2, g) + (() if rms else (b,))
    want = torch.autograd.grad(out, wrt, dout)
    y = resid if add else x2
    dx, dg, db = tln.layer_norm_bwd_ref(
        dout, y.detach(), g.detach(), mu.detach(), rstd.detach(), rms,
        not rms,
    )
    got = (dx, dg) + (() if rms else (db,))
    for w, g_ in zip(want, got):
        _close(g_, w, F32_TOL, "plain backward")


def test_add_variant_normalises_the_unrounded_sum():
    """In bf16 the add variant normalises the f32 sum x + residual and
    returns that sum rounded: not the norm of the rounded sum."""
    d = _data(2)
    x = torch.tensor(d["x"]).to(torch.bfloat16)
    r = torch.tensor(d["res"]).to(torch.bfloat16)
    g = torch.tensor(d["g"])
    out, resid = tln.fused_add_rms_norm(x, r, g)
    s32 = x.float() + r.float()
    assert torch.equal(resid, s32.to(torch.bfloat16))
    want = (s32 * torch.rsqrt(s32.square().mean(-1, keepdim=True) + 1e-6)
            * g).to(torch.bfloat16)
    assert torch.equal(out, want)


def test_backward_blocks_cover_every_row():
    for n in (1, 210, 395, 396, 397, 1000, 8192, 100_000):
        rows, blocks = tln.bwd_blocks(n)
        assert blocks <= tln.BWD_TARGET_BLOCKS
        assert (blocks - 1) * rows < n <= blocks * rows


def test_kernel_input_checks_raise():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    g = torch.ones(64)
    for dtype in (torch.float16, torch.float32):
        with pytest.raises(TypeError, match="take bfloat16"):
            tln._rows(x.to(dtype), "x")
    with pytest.raises(ValueError, match="multiple of 8"):
        tln._rows(torch.zeros(4, 60, dtype=torch.bfloat16), "x")
    with pytest.raises(ValueError, match="multiple of 8"):
        tln._rows(torch.zeros(4, 2 * tln.MAX_WIDTH, dtype=torch.bfloat16), "x")
    with pytest.raises(ValueError, match="float32"):
        tln._param(g.to(torch.bfloat16), 64, x.device, "g")
    with pytest.raises(ValueError, match="float32"):
        tln._param(torch.ones(32), 64, x.device, "g")
    assert tln._rows(x.t().contiguous().t(), "x").is_contiguous()
