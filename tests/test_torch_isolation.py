"""The PyTorch port stands alone and never falls back quietly.

* No module of ``dlrover_tpu_torch`` (nor ``chip_smoke.py``) imports
  jax, jaxlib, flax, optax or anything of ``dlrover_tpu``, checked on
  the source and by importing every module with those made
  unimportable, and none names a module of theirs to spawn.
* Without a GPU, entry points given no device raise instead of running
  on the CPU, ``chip_smoke.py`` exits non-zero with no result line, and
  a kernel build without ``nvcc`` raises.
* A kernel wrapper hands a CUDA tensor to the kernel, never to the
  plain version.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import dlrover_tpu_torch
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import layer_norm as tln
from dlrover_tpu_torch.ops import quantization as tq
from dlrover_tpu_torch.tools import flash_ab

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = pathlib.Path(dlrover_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dlrover_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [
                f"{path}:{node.lineno} {n}" for n in names if _forbidden(n)
            ]
    assert not bad, bad
    assert len(_sources()) > 15


def test_no_source_spawns_a_module_of_the_jax_package():
    """No string in the port names a ``dlrover_tpu`` module, as a
    ``python -m`` target (the launcher's master, the agent's trainer
    commands) or an ``importlib`` name would."""
    module = re.compile(r"^(dlrover_tpu|jax|optax|flax)(\.\w+)*$")
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [
            f"{path}:{node.lineno} {node.value}"
            for node in ast.walk(tree)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and module.match(node.value)
        ]
    assert not bad, bad


def test_every_module_imports_with_jax_unimportable():
    modules = sorted(
        "dlrover_tpu_torch." + ".".join(
            p.relative_to(PKG).with_suffix("").parts
        ).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = f"""
import importlib, importlib.abc, sys
FORBIDDEN = {FORBIDDEN!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("blocked: " + name)
        return None
for name in list(sys.modules):
    if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
        del sys.modules[name]
sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
print("imported", len({modules!r}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert f"imported {len(modules)}" in out.stdout


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks CPU-only hosts")


def test_entry_points_without_device_raise(no_gpu):
    from dlrover_tpu_torch.common.device import resolve_device
    from dlrover_tpu_torch.examples.llama_lora import train as lora_train
    from dlrover_tpu_torch.examples.nanogpt import train
    from dlrover_tpu_torch.models import convert, gpt, llama
    from dlrover_tpu_torch.optim.adamw import AdamW
    from dlrover_tpu_torch.optim.low_bit import state_from_jax
    from dlrover_tpu_torch.serving import replica
    from dlrover_tpu_torch.trainer.elastic_trainer import ElasticTrainer

    tiny = gpt.GPTConfig(
        vocab_size=64, block_size=8, n_layer=1, n_head=1, n_embd=64
    )
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: gpt.init_params(tiny),
        lambda: convert.params_from_jax({"w": torch.zeros(2).numpy()}),
        lambda: ElasticTrainer(lambda p, a, b: 0, AdamW(1e-3), 2, 1),
        lambda: train.main(["--smoke", "--steps", "1"]),
        lambda: llama.init_params(llama.LlamaConfig.tiny()),
        lambda: lora_train.main(["--preset", "tiny", "--steps", "1"]),
        lambda: train.main(["--smoke", "--steps", "1", "--optimizer",
                            "adam8bit"]),
        lambda: state_from_jax(({"count": 0, "mu": {}, "nu": {}},)),
        lambda: replica.build_tiny_model(0),
        lambda: replica.main(["--master", "127.0.0.1:1", "--replica_id",
                              "0"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


def test_chip_smoke_fails_fast_without_gpu(no_gpu, tmp_path):
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    # alone in a directory, without the package beside it
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text()
    )
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "b")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_attention", "layer_norm", "quantization"])
    # nvcc is looked up before the build directory is made
    assert not (tmp_path / "b").exists()
    lib = _build._lib_path("flash_attention")
    assert lib.parent.parent == tmp_path / "b" and lib.name.endswith(".so")


class _CudaLike:
    """Stands in for a CUDA tensor: only ``is_cuda`` is read before the
    wrapper dispatches."""

    is_cuda = True


def test_wrappers_send_cuda_tensors_to_the_kernels(monkeypatch):
    calls = []
    monkeypatch.setattr(
        tfa, "_fwd_cuda", lambda *a: calls.append("fwd") or ("o", "lse")
    )
    monkeypatch.setattr(
        tfa, "_bwd_cuda", lambda *a: calls.append("bwd") or (1, 2, 3)
    )

    def plain(*a):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tfa, "flash_attention_ref", plain)
    monkeypatch.setattr(tfa, "flash_attention_bwd_ref", plain)
    monkeypatch.setattr(
        tln, "_fwd_cuda", lambda *a: calls.append("norm_fwd") or "nf"
    )
    monkeypatch.setattr(
        tln, "_bwd_cuda", lambda *a: calls.append("norm_bwd") or "nb"
    )
    monkeypatch.setattr(tln, "layer_norm_fwd_ref", plain)
    monkeypatch.setattr(tln, "layer_norm_bwd_ref", plain)
    monkeypatch.setattr(
        tq, "_quantize_cuda",
        lambda x, b, bits, s: calls.append(f"q{bits}{s:d}") or "q",
    )
    monkeypatch.setattr(
        tq, "_dequantize_cuda",
        lambda q, sc, sh, bits, s, dt: calls.append(f"dq{bits}{s:d}") or "d",
    )
    for name in ("quantize_blockwise_plain", "dequantize_blockwise_plain",
                 "quantize_blockwise_4bit_plain",
                 "dequantize_blockwise_4bit_plain"):
        monkeypatch.setattr(tq, name, plain)
    x = _CudaLike()
    assert tfa._fwd(x, x, x, True, 1.0, None, 0) == ("o", "lse")
    assert tfa._bwd(x, x, x, x, x, x, True, 1.0, None, 0) == (1, 2, 3)
    assert tln._fwd(x, None, x, None, 1e-5, False) == "nf"
    assert tln._bwd(x, x, x, x, True, False) == "nb"
    assert tq.quantize_blockwise(x) == "q"
    assert tq.dequantize_blockwise(x, x, (4,)) == "d"
    assert tq.quantize_blockwise_4bit(x, signed=False) == "q"
    assert tq.dequantize_blockwise_4bit(x, x, (4,), signed=False) == "d"
    assert calls == ["fwd", "bwd", "norm_fwd", "norm_bwd",
                     "q81", "dq81", "q40", "dq40"]


def test_kernel_input_checks_raise():
    with pytest.raises(TypeError, match="bfloat16"):
        tfa._kernel_input(torch.zeros(1, 8, 1, 64), "q")
    for d in (32, 96, 256):
        with pytest.raises(ValueError, match=r"head_dim D in \(64, 128\)"):
            tfa._kernel_input(
                torch.zeros(1, 8, 1, d, dtype=torch.bfloat16), "q"
            )
    for d in tfa.HEAD_DIMS:
        x = torch.zeros(1, 8, 1, d, dtype=torch.bfloat16)
        assert tfa._kernel_input(x, "q") is x
    q = torch.zeros(2, 8, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="share q's"):
        tfa._check_kv(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="share q's"):
        tfa._check_kv(q, q, q[:, :4])


def test_kernel_input_refuses_what_tma_cannot_read():
    """The kernels read q, k, v and dO with TMA: a base or a stride that
    is not a multiple of 16 bytes, or a head dim that is not contiguous,
    is refused with the tensor's name instead of copied."""
    flat = torch.zeros(1 + 8 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k's base address is not 16-byte"):
        tfa._kernel_input(flat[1:].view(1, 8, 1, 64), "k")
    wide = torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"v's strides .* multiples of 16"):
        tfa._kernel_input(wide[..., :64], "v")
    with pytest.raises(ValueError, match="do must have unit stride"):
        tfa._kernel_input(
            torch.zeros(1, 8, 64, 2, dtype=torch.bfloat16).transpose(2, 3),
            "do",
        )


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_kernel_input_accepts_views_tma_can_read(d):
    """The q/k/v views of a fused qkv projection go to the kernel as
    they are; a dim of size 1 may carry any stride."""
    b, t, h = 2, 8, 3
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.bfloat16)
    for part in qkv.split(h * d, dim=-1):
        x = part.view(b, t, h, d)
        assert tfa._kernel_input(x, "q") is x
        assert tfa._strides(x) == (t * 3 * h * d, 3 * h * d, d)
    odd = torch.zeros(8 * 2 * d, dtype=torch.bfloat16).as_strided(
        (1, 8, 1, d), (3, 2 * d, 5, 1)
    )
    assert tfa._kernel_input(odd, "k") is odd
    assert tfa._strides(odd) == (8, 2 * d, 8)


def test_quantization_kernel_checks_raise():
    """The quantization wrappers raise on what the kernels do not take
    (checked before anything touches the card)."""
    with pytest.raises(TypeError, match="float32 values"):
        tq._kernel_values(torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="block_size 1024"):
        tq._quantize_cuda(torch.zeros(8), 256, 8, True)
    with pytest.raises(TypeError, match="write float32"):
        tq._dequantize_cuda(None, None, (8,), 8, True, torch.bfloat16)
    codes = torch.zeros(2, 1024, dtype=torch.int8)
    with pytest.raises(ValueError, match="uint8 codes"):
        tq._dequantize_cuda(codes, None, (8,), 4, True, torch.float32)
    with pytest.raises(ValueError, match=r"scales must be float32 \[2, 1\]"):
        tq._dequantize_cuda(codes, torch.zeros(2), (8,), 8, True,
                            torch.float32)
    with pytest.raises(ValueError, match="more than the 2 blocks"):
        tq._dequantize_cuda(codes, torch.zeros(2, 1), (2049,), 8, True,
                            torch.float32)
    x = torch.zeros(9)
    assert tq._kernel_values(x).data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tq._kernel_values(x[1:])


def test_build_dir_is_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert os.path.relpath(_build.CSRC, REPO) == os.path.join(
        "dlrover_tpu_torch", "csrc"
    )


def test_ptxas_usage_reads_registers_and_spills():
    out = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEvPK13__nv_bfloat16S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEvPK13__nv_bfloat16S3_
    32 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121layer_norm_bwd_kernelILi4ELb0ELb1EEEvNS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121layer_norm_bwd_kernelILi4ELb0ELb1EEEvNS_7BwdArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 176 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers, 528 bytes cmem[0]
"""
    assert _build.ptxas_usage(out) == {
        "flash_fwd_kernel<64>": {"spill_bytes": 32, "registers": 128},
        "layer_norm_bwd_kernel<4,0,1>": {"spill_bytes": 0, "registers": 176},
        "flash_bwd_dq_kernel": {"registers": 168},
    }


def test_sass_counts_reads_tensor_core_and_tma_instructions():
    sass = """\
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116flash_fwd_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16PfifNS_8MaskArgsE
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0a30*/                   UTMALDG.4D [UR8], [UR4] ;                         /* 0x00000008040075b4 */
                                                                                     /* 0x0001e20008019000 */
        /*0a40*/                   WARPGROUP.ARRIVE ;                                /* 0x00000000000079c5 */
        /*0a50*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT, gsb0 ; /* 0x01e00000081879f0 */
        /*0a60*/                   HGMMA.64x128x16.F32.BF16 R24, R180, gdesc[UR16].tnspB, R24, gsb0 ; /* 0x41e00010b4187df0 */
		Function : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64EEEvPK13__nv_bfloat16
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;             /* 0x0000000c0804723c */
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;           /* 0x0000000e0810723c */
"""
    assert flash_ab.sass_counts(sass) == {
        "flash_fwd_kernel<128>": {"HGMMA": 2, "UTMALDG": 1, "HMMA": 0},
        "flash_bwd_dq_kernel<64>": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 2},
    }
