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

import ctypes
import importlib
import re

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


ROW_COUNTS = (1, 210, 395, 396, 397, 1000, 8192, 100_000)
KINDS = ("fwd", "add", "bwd")
# each side of the warp/block dispatch, GPT-2's and Llama's widths, and
# the widest row
WIDTHS = (8, 64, 768, 1024, 1032, 2048, 4096, 6144, 8192)


def _groups(ls, n):
    """The row ranges of every group of a launch, in launch order."""
    groups = ls.blocks * ls.groups_per_block
    return [
        range(min(n, k * ls.rows), min(n, (k + 1) * ls.rows))
        for k in range(groups)
    ]


def test_backward_blocks_cover_every_row():
    """Every row falls in exactly one group of the backward's launch
    (and of the forwards'), and the backward's partial dg/db rows are
    one a block."""
    for e in WIDTHS:
        for kind in KINDS:
            for n in ROW_COUNTS:
                ls = tln.launch_shape(n, e, kind)
                rows = [r for g in _groups(ls, n) for r in g]
                assert rows == list(range(n)), (n, e, kind)
                # no block without a row: the last block holds row n - 1
                first_of_last = (ls.blocks - 1) * ls.groups_per_block
                assert first_of_last * ls.rows < n


@pytest.mark.parametrize("e", WIDTHS)
def test_launch_shape_dispatches_by_width(e):
    """A warp reduces a row up to WARP_MAX_WIDTH (eight warps a block,
    every chunk of 8 in some lane and no lane without one at E 768);
    above it a block of at most THREADS threads does, with 1, 2 or 4
    chunks a thread."""
    chunks = e // 8
    for kind in KINDS:
        ls = tln.launch_shape(8192, e, kind)
        assert ls.warp == (e <= tln.WARP_MAX_WIDTH)
        if ls.warp:
            assert ls.threads == tln.THREADS and ls.groups_per_block == 8
            assert ls.nv == -(-chunks // 32) and ls.nv in (1, 2, 3, 4)
        else:
            assert ls.groups_per_block == 1 and ls.nv in (1, 2, 4)
            assert ls.threads % 32 == 0 and ls.threads <= tln.THREADS
            assert ls.nv * ls.threads >= chunks
            assert (ls.threads - 32) * ls.nv < chunks  # no idle warp
    assert tln.launch_shape(8192, 768, "fwd").nv * 32 == 768 // 8
    assert tln.launch_shape(8192, 4096, "fwd")[:3] == (False, 2, 256)


def _blocks_per_sm(ls, kind):
    if ls.nv == 4:
        return 1
    if ls.warp or kind == "bwd":
        return 2
    return tln.FWD_BLOCKS_PER_SM


@pytest.mark.parametrize("e", WIDTHS)
def test_launch_shape_is_a_persistent_grid_that_fits(e):
    """A few blocks an SM (one where a thread holds four chunks), all
    resident at once: each block's ring (and staged output rows) fits
    its share of the SM's shared memory, and the kernels' own checks
    (``bad_shape`` in csrc/layer_norm.cu) hold."""
    for sms in (132, 114):
        for kind in KINDS:
            for n in ROW_COUNTS:
                ls = tln.launch_shape(n, e, kind, sms)
                per_sm = _blocks_per_sm(ls, kind)
                assert ls.blocks <= per_sm * sms
                if n >= per_sm * sms * ls.groups_per_block:
                    assert ls.blocks > (per_sm * sms) // 2
                assert 1 <= ls.stages <= min(tln.MAX_STAGES, ls.rows)
                streams = tln._STREAMS[kind]
                ring = ls.groups_per_block * ls.stages * streams * e * 2
                staged = 0 if ls.warp else 2 * tln._OUTS[kind] * e * 2
                assert ls.smem == tln.BAR_BYTES + ring + staged
                assert per_sm * (ls.smem + tln.BLOCK_SMEM_EXTRA) <= (
                    tln.SM_SMEM
                )
                lanes = 32 if ls.warp else ls.threads
                assert ls.nv * lanes * 8 >= e
                assert ls.blocks * ls.groups_per_block * ls.rows >= n
    # GPT-2's 8192 rows: 4 rows a warp, 8 warps a block, 256 blocks
    assert tln.launch_shape(8192, 768, "bwd")[3:5] == (256, 4)


def _cu_source() -> str:
    from dlrover_tpu_torch.ops import _build

    return (_build.CSRC / "layer_norm.cu").read_text()


def test_launch_record_matches_the_c_struct():
    """``_Shape`` is read by the C entry points as ``NormShape``: the
    same fields in the same order, and the constants both sides share."""
    src = _cu_source()
    body = re.search(r"struct NormShape \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"(int|float)\s+([^;]+);", body):
        fields += [(decl[0], f.strip()) for f in decl[1].split(",")]
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    assert [(n, t) for n, t in tln._Shape._fields_] == [
        (name, ctype[t]) for t, name in fields
    ]
    for const, value in (
        ("kMaxWidth", tln.MAX_WIDTH), ("kWarpMaxWidth", tln.WARP_MAX_WIDTH),
        ("kMaxThreads", tln.THREADS), ("kMaxStages", tln.MAX_STAGES),
    ):
        assert re.search(rf"constexpr int {const} = {value};", src), const


def test_every_norm_kernel_is_in_the_norm_family():
    """Each ``__global__`` function of csrc/layer_norm.cu, under the name
    the profiler prints, counts in the profile's ``norm`` family."""
    from dlrover_tpu_torch.trainer.profile import kernel_family

    names = [
        re.search(r"(\w+_kernel)\(", decl).group(1)
        for decl in _cu_source().split("__global__")[1:]
    ]
    assert set(names) == {
        "layer_norm_fwd_kernel", "layer_norm_bwd_kernel",
        "layer_norm_dgdb_kernel",
    }
    for name in names:
        printed = f"void (anonymous namespace)::{name}<true, 3, false>(int)"
        assert kernel_family(printed) == "norm", name


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


def test_kernel_input_checks_raise_after_the_rewrite():
    """The wrappers name the tensor the kernels cannot take, before any
    allocation or launch: misaligned rows or parameters, a residual, y
    or stats of another shape."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    g = torch.ones(64)
    flat = torch.zeros(1 + 4 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="read x in 16-byte pieces"):
        tln._rows(flat[1:].view(4, 64), "x")
    with pytest.raises(ValueError, match="read b in 16-byte pieces"):
        tln._param(torch.ones(65)[1:], 64, x.device, "b")
    with pytest.raises(ValueError, match="residual .* must match x"):
        tln._fwd_cuda(x, x[:2], g, None, 1e-5, False)
    with pytest.raises(TypeError, match="residual is torch.float32"):
        tln._fwd_cuda(x, x.float(), g, None, 1e-5, False)
    with pytest.raises(ValueError, match="take g as float32"):
        tln._fwd_cuda(x, None, g[:32], None, 1e-5, False)
    with pytest.raises(ValueError, match="must match the saved input"):
        tln._bwd_cuda(x, x[:2], g, torch.zeros(2, 4), True, False)
    for bad in (torch.zeros(2, 3), torch.zeros(4, 2), torch.zeros(8).double()):
        with pytest.raises(ValueError, match=r"stats \(mu, rstd\)"):
            tln._bwd_cuda(x, x, g, bad, True, False)
    stats = torch.zeros(2, 4)
    assert tln._stats(stats, 4, x.device) is stats
    assert tln._param(g, 64, x.device, "g") is g
    assert tln._rows(x, "x") is x


def test_io_bytes_counts_each_input_and_output_once():
    """The bytes behind the kernels' bounds: bf16 rows, f32 g/b, stats
    and dg/db; the Llama backward moves 201 MB (60 us at 3.35 TB/s)."""
    n, e = 8192, 4096
    act, stats = n * e * 2, n * 8
    assert tln.io_bytes(n, e, "fwd", False) == 2 * act + e * 4 + stats
    assert tln.io_bytes(n, e, "add", True) == 4 * act + 2 * e * 4 + stats
    assert tln.io_bytes(n, e, "bwd", False) == 3 * act + 2 * e * 4 + stats
    assert tln.io_bytes(n, e, "bwd", True) == 3 * act + 3 * e * 4 + stats
    assert round(tln.io_bytes(n, e, "bwd", False) / 3.35e12 * 1e6) == 60
