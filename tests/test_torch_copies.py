"""The port's copies of the JAX package's framework-free control-plane
modules, held to their sources so that later drift shows.

The port may not import ``dlrover_tpu``, so the modules its launcher,
master, agent and flash checkpoint need are copied into
``dlrover_tpu_torch`` with ``dlrover_tpu.`` renamed to
``dlrover_tpu_torch.`` and nothing else changed:

* ``VERBATIM``: the copy equals its source after the rename;
* ``PARTIAL``: the places that touch JAX became the port's own code;
  every other definition (function, class member, module statement)
  equals its source after the rename, and each changed or left-out one
  is listed with the reason;
* ``PORTS``: modules rewritten for torch; the port keeps the public
  names of its source, except those listed as not ported yet.
"""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "dlrover_tpu"
PORT_PKG = REPO / "dlrover_tpu_torch"
RENAME = re.compile(r"\bdlrover_tpu\b(?=\.|\s+import\b|\s*$)", re.M)

VERBATIM = [
    "common/constants.py", "common/config.py", "common/node.py",
    "common/messages.py", "common/comm.py", "common/chaos.py",
    "common/multi_process.py", "common/storage.py", "common/ckpt_shm.py",
    "master/__init__.py", "master/main.py", "master/master.py",
    "master/servicer.py", "master/job_manager.py", "master/rendezvous.py",
    "master/kv_store.py", "master/task_manager.py",
    "master/dataset_splitter.py", "master/speed_monitor.py",
    "master/metrics.py", "master/state_store.py", "master/ps_manager.py",
    "master/remediation.py", "master/auto_scaler.py",
    "brain/__init__.py", "brain/service.py", "sparse/partition.py",
    "agent/__init__.py", "agent/master_client.py",
    "agent/hang_detector.py", "agent/paral_config_tuner.py",
    "agent/ckpt_saver.py", "agent/sharding_client.py",
    "obs/__init__.py", "obs/metrics.py", "obs/tracer.py",
    "obs/trace_store.py", "obs/beacon.py", "obs/fleet.py",
    "obs/goodput.py", "obs/timeseries.py", "obs/health.py",
    "obs/capacity.py", "obs/stall.py", "obs/exposition.py",
    "serving/router.py", "serving/kv_pool.py",
    "agent/replica_supervisor.py",
]

# module: (changed definitions, left-out definitions, added, reason)
PARTIAL = {
    "agent/monitor.py": (
        {"current_resource_stats"}, set(), {"stmt:import subprocess"},
        "device memory comes from nvidia-smi, not jax.local_devices(): "
        "the agent must not open a CUDA context on its trainers' card",
    ),
    "obs/flight_recorder.py": (
        {"_process_info"}, set(), set(),
        "reports the CUDA device only when the process already "
        "initialised CUDA (the JAX copy asks jax.default_backend()); a "
        "crash handler never opens a device context",
    ),
    "obs/profiling.py": (
        {"<module docstring>", "peak_flops_per_s", "step_flops",
         "MfuMeter.__init__", "StepPhaseProfiler",
         "StepPhaseProfiler.start_capture",
         "StepPhaseProfiler._finish_capture"},
        set(), {"H100_PEAK_BF16_TFLOPS"},
        "the MFU peak is the H100's bf16 989 TFLOP/s (the JAX copy reads "
        "the TPU table of utils/profiler); traces come from "
        "torch.profiler instead of jax.profiler; step_flops (XLA cost "
        "analysis) raises until ROADMAP queue 1 item 7",
    ),
    "serving/scheduler.py": (
        {"<module docstring>",
         "ContinuousBatchingScheduler._build_programs",
         "ContinuousBatchingScheduler._admit_handoffs",
         "ContinuousBatchingScheduler._prefill_tick",
         "ContinuousBatchingScheduler._decode_tick"},
        set(), set(),
        "the prefill, ragged decode and install programs are eager "
        "torch on the parameters' device (sampling from a "
        "torch.Generator there, no PRNG key to split); the chunk and "
        "token vectors cross as torch tensors, the sampled tokens and "
        "a finished prompt's logits row come back through .cpu()",
    ),
    "serving/handoff.py": (
        {"<module docstring>", "HandoffPayload", "HandoffPayload.k",
         "HandoffPayload.v", "export_handoff", "_pack_array",
         "_unpack_array", "make_install_fn"},
        {"stmt:from typing import Dict, List, Optional"},
        {"_BF16", "stmt:from typing import TYPE_CHECKING, Dict, List, "
         "Optional", "stmt:if TYPE_CHECKING:\n    import torch"},
        "payload KV are CPU tensors (export copies with .cpu(), which a "
        "bf16 or CUDA cache needs); bf16 crosses the wire as raw 16-bit "
        "words named 'bfloat16', unpacked by a bit cast without "
        "ml_dtypes; the install is an in-place copy into one lane; "
        "torch is imported only where used (the master never needs it)",
    ),
}

# port: (source, public names not ported yet, reason)
PORTS = {
    "common/log.py": (
        "common/log.py", {"reconfigure"},
        "PR 1's trimmed copy: rank from RANK, torch.distributed's name",
    ),
    "trainer/torch_env.py": (
        "trainer/jax_env.py", set(),
        "torch.distributed.init_process_group (NCCL on the card, gloo on "
        "the CPU) instead of jax.distributed.initialize",
    ),
    "agent/agent.py": (
        "agent/agent.py", set(),
        "one training process per GPU, watched and restarted as a group; "
        "process ids count the processes of lower-ranked nodes",
    ),
    "trainer/elastic_run.py": (
        "trainer/elastic_run.py", set(),
        "torch.cuda.device_count() instead of jax.local_devices(), no "
        "quiet CPU world, the port's master",
    ),
    "trainer/flash_checkpoint/engine.py": (
        "trainer/flash_checkpoint/engine.py", set(),
        "stages torch trees through pinned shm on global rank 0; reads "
        "shm or storage; streaming reshard-on-load waits for FSDP",
    ),
    "trainer/flash_checkpoint/checkpointer.py": (
        "trainer/flash_checkpoint/checkpointer.py", set(),
        "ranks from torch.distributed instead of jax.process_index()",
    ),
    "trainer/flash_checkpoint/__init__.py": (
        "trainer/flash_checkpoint/__init__.py", set(),
        "the port's engine and checkpointer",
    ),
    "models/generate.py": (
        "models/generate.py", set(),
        "eager torch: the cache is written in place on head-major "
        "storage, the layers and positions loop in Python, prefill and "
        "the lane prefill run K1/K3 on CUDA, sampling takes a "
        "torch.Generator",
    ),
    "serving/replica.py": (
        "serving/replica.py", set(),
        "the model on a device the caller names (--device, the GPU by "
        "default); restart_in_place frees the old KV cache first",
    ),
}


def renamed(text: str) -> str:
    return RENAME.sub("dlrover_tpu_torch", text)


def _named(node) -> list:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                      ast.Name):
        return [node.target.id]
    return []


def definitions(text: str) -> dict:
    """{key: source}: the module docstring, each top-level definition
    (a class as its header and docstring, and each member by
    ``Class.member``), and every other top-level statement keyed by its
    own source."""
    tree = ast.parse(text)
    out = {"<module docstring>": ast.get_docstring(tree, clean=False)}
    for i, node in enumerate(tree.body):
        if i == 0 and out["<module docstring>"] is not None:
            continue
        names = _named(node)
        src = ast.get_source_segment(text, node)
        if not names:
            out[f"stmt:{src}"] = src
            continue
        if isinstance(node, ast.ClassDef):
            out[node.name] = (
                [ast.unparse(b) for b in node.bases],
                [ast.unparse(d) for d in node.decorator_list],
                ast.get_docstring(node, clean=False),
            )
            for member in node.body:
                for m in _named(member):
                    out[f"{node.name}.{m}"] = ast.get_source_segment(
                        text, member
                    )
            continue
        for name in names:
            out[name] = src
    return out


def _public(text: str) -> set:
    return {
        k for k in definitions(text)
        if not k.startswith(("stmt:", "<", "_")) and "." not in k
    }


@pytest.mark.parametrize(
    "module", sorted(VERBATIM) + sorted(PARTIAL) + sorted(PORTS)
)
def test_copy_matches_its_source(module):
    port = (PORT_PKG / module).read_text()
    if module in VERBATIM:
        source = renamed((JAX_PKG / module).read_text())
        assert port == source, f"{module} drifted from dlrover_tpu/{module}"
        return
    if module in PARTIAL:
        changed, left_out, added, reason = PARTIAL[module]
        assert reason
        want = definitions(renamed((JAX_PKG / module).read_text()))
        got = definitions(port)
        for key, src in want.items():
            if key.split(".")[0] in left_out:
                assert key not in got, f"{module}: {key} is left out"
            elif key in changed:
                assert key in got and got[key] != src, (
                    f"{module}: {key} is listed as changed but is not"
                )
            else:
                assert got.get(key) == src, f"{module}: {key} drifted"
        extra = set(got) - set(want)
        assert extra == added, f"{module}: unlisted additions {extra - added}"
        return
    source, not_ported, reason = PORTS[module]
    assert reason
    missing = _public((JAX_PKG / source).read_text()) - _public(port)
    assert missing == not_ported, (
        f"{module} lacks {missing - not_ported} of dlrover_tpu/{source}"
    )


def test_every_copy_is_listed():
    """Each module the port shares with the JAX package is held here or
    is one of the port's own slices (models, ops, optimizers, trainer
    pieces earlier slices ported and test against JAX directly)."""
    own = {
        "__init__.py", "accelerate/__init__.py", "accelerate/api.py",
        "accelerate/remat.py", "common/__init__.py", "models/__init__.py",
        "models/bert.py", "models/convert.py", "models/glm.py",
        "models/gpt.py", "models/hf_convert.py", "models/llama.py",
        "models/lora.py", "models/moe.py", "ops/__init__.py",
        "ops/cross_entropy.py", "ops/flash_attention.py",
        "ops/layer_norm.py", "ops/prefix_lm.py",
        "ops/quantization.py", "optim/__init__.py", "optim/agd.py",
        "optim/low_bit.py", "serving/__init__.py", "sparse/__init__.py",
        "trainer/__init__.py", "trainer/async_metrics.py",
        "trainer/elastic_trainer.py", "trainer/step.py",
    }
    shared = {
        str(p.relative_to(PORT_PKG)) for p in PORT_PKG.rglob("*.py")
        if (JAX_PKG / p.relative_to(PORT_PKG)).exists()
    }
    listed = set(VERBATIM) | set(PARTIAL) | set(PORTS)
    assert shared - own == {m for m in listed if (JAX_PKG / m).exists()}
