"""The elastic launcher CLI of the port (counterpart of
``dlrover_tpu/trainer/elastic_run.py``).

Parity: dlrover/trainer/torch/elastic_run.py (dlrover-run, a superset of
torchrun): spawns a local job master (``dlrover_tpu_torch.master.main``)
when none is given (standalone or rank-0), then runs the per-host
:class:`ElasticAgent`, which spawns one training process per GPU and
supervises them as a group.

Usage:
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nproc_per_node 1 -m dlrover_tpu_torch.examples.nanogpt.train \
        -- --model gpt2 --steps 8 --checkpoint-every 3
    python -m dlrover_tpu_torch.trainer.elastic_run --standalone \
        --nproc_per_node 2 -m dlrover_tpu_torch.examples.nanogpt.train \
        -- --smoke --device cpu            # two gloo workers on the CPU

``--nproc_per_node 0`` takes one process per visible GPU; with no GPU it
raises unless the script is asked to run on the CPU (``--device cpu``,
one process). The launcher never opens a CUDA context. Files the agent
and its trainers share (IPC sockets, step metrics, progress beacon,
forensics, profile requests) default to the temporary directory. The
network check (``--network-check``) is not ported yet (ROADMAP queue 1
item 2).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("elastic_run")


def parse_nnodes(value: str) -> Tuple[int, int]:
    if ":" in value:
        lo, hi = value.split(":", 1)
        return int(lo), int(hi)
    n = int(value)
    return n, n


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        "dlrover-tpu-run", allow_abbrev=False
    )
    parser.add_argument(
        "--nnodes",
        type=str,
        default="1",
        help="number of nodes, or elastic range 'min:max'",
    )
    parser.add_argument(
        "--nproc_per_node",
        type=int,
        default=0,
        help="training processes (GPUs) per node (0 = one per GPU)",
    )
    parser.add_argument("--node_rank", type=int, default=-1)
    parser.add_argument("--node_unit", type=int, default=1)
    parser.add_argument("--max_restarts", type=int, default=3)
    parser.add_argument(
        "--standalone",
        action="store_true",
        help="single-node mode with an auto-spawned local master",
    )
    parser.add_argument(
        "--master",
        type=str,
        default="",
        help="job master address (spawned locally when empty on rank 0)",
    )
    parser.add_argument(
        "--network-check",
        action="store_true",
        dest="network_check",
        help="run the collective+matmul health check before training "
        "(not ported yet)",
    )
    parser.add_argument(
        "--exclude-straggler",
        action="store_true",
        dest="exclude_straggler",
        help="with --network-check: exit (and get replaced) when the "
        "master judges this node a straggler (>2x median check time)",
    )
    parser.add_argument("--rdzv_timeout", type=float, default=600.0)
    parser.add_argument(
        "--heartbeat_interval", type=float, default=15.0,
        help="agent->master heartbeat cadence (drills tighten this "
        "together with the master's --heartbeat_timeout)",
    )
    parser.add_argument(
        "--role",
        type=str,
        default="worker",
        choices=["worker", "evaluator"],
        help="node role: workers join the elastic rendezvous; an "
        "evaluator runs its script standalone (world of one) while "
        "the master owns its lifecycle",
    )
    parser.add_argument(
        "-m",
        "--module",
        action="store_true",
        help="treat training_script as a python module (python -m)",
    )
    parser.add_argument(
        "training_script",
        type=str,
        help="training script path (or module name with -m)",
    )
    parser.add_argument(
        "training_script_args", nargs=argparse.REMAINDER
    )
    return parser.parse_args(argv)


def _launch_local_master(
    node_num: int, min_nodes: int, node_unit: int
) -> Tuple[subprocess.Popen, str]:
    """Spawn the job master as a subprocess; returns (proc, addr)."""
    from dlrover_tpu_torch.common.config import ensure_framework_on_pythonpath

    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.master.main",
            "--node_num",
            str(node_num),
            "--min_nodes",
            str(min_nodes),
            "--node_unit",
            str(node_unit),
        ],
        stdout=subprocess.PIPE,  # binary: non-blocking reads below
        env=ensure_framework_on_pythonpath(dict(os.environ)),
    )
    # The master prints DLROVER_TPU_MASTER_PORT=N once bound. Read it
    # with a hard deadline: readline() on a silent-but-alive master
    # would otherwise block forever.
    deadline = time.time() + 30
    port: Optional[int] = None
    os.set_blocking(proc.stdout.fileno(), False)
    buf = b""
    while time.time() < deadline:
        chunk = proc.stdout.read()  # None when no data (non-blocking)
        if chunk:
            buf += chunk
            m = re.search(rb"DLROVER_TPU_MASTER_PORT=(\d+)", buf)
            if m:
                port = int(m.group(1))
                break
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    if port is None:
        proc.kill()
        raise RuntimeError("local master failed to start within 30s")
    addr = f"127.0.0.1:{port}"
    logger.info("local job master running at %s", addr)
    return proc, addr


def _asks_for_cpu(script_args: List[str]) -> bool:
    """Whether the training script is told ``--device cpu``."""
    for i, arg in enumerate(script_args):
        if arg == "--device=cpu" or (
            arg == "--device" and script_args[i + 1 : i + 2] == ["cpu"]
        ):
            return True
    return False


def _local_process_count(script_args: List[str]) -> int:
    """One training process per visible GPU. ``device_count`` asks NVML
    and opens no CUDA context, so the launcher leaves the card to its
    trainers. With no GPU, one CPU process when the script asks for the
    CPU; otherwise an error, never a quiet CPU world."""
    import torch

    n = torch.cuda.device_count()
    if n:
        return n
    if _asks_for_cpu(script_args):
        return 1
    raise SystemExit(
        "no CUDA device is visible: pass --nproc_per_node, and --device "
        "cpu to the training script, to train on the CPU"
    )


# Files the agent and its trainers share, by the variable that places
# each (the copied modules default them to /tmp).
_RUNTIME_FILES = {
    "DLROVER_TPU_SOCK_DIR": "dlrover_tpu_sock",
    "DLROVER_TPU_METRICS_FILE": "dlrover_tpu_train_metrics_{job}.json",
    "DLROVER_TPU_PARAL_CONFIG_FILE": "dlrover_tpu_paral_config_{job}.json",
    "DLROVER_TPU_BEACON_FILE": "dlrover_tpu_beacon_{job}.json",
    "DLROVER_TPU_FORENSICS_DIR": "dlrover_tpu_forensics_{job}",
    "DLROVER_TPU_PROFILE_REQUEST_FILE": "dlrover_tpu_profile_request_{job}.json",
    "DLROVER_TPU_PROFILE_DIGEST_FILE": "dlrover_tpu_profile_digest_{job}.json",
}


def _place_runtime_files(environ=os.environ) -> None:
    """Default every shared runtime file to the temporary directory
    (``TMPDIR``). Runs before the IPC module is imported: it reads its
    socket directory once, at import."""
    job = environ.get("DLROVER_TPU_JOB_NAME", "default")
    tmp = tempfile.gettempdir()
    for var, name in _RUNTIME_FILES.items():
        environ.setdefault(var, os.path.join(tmp, name.format(job=job)))


def run(args) -> int:
    from dlrover_tpu_torch.agent.agent import AgentConfig, ElasticAgent
    from dlrover_tpu_torch.agent.master_client import MasterClient

    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    if args.standalone:
        min_nodes = max_nodes = 1
    nproc = args.nproc_per_node or _local_process_count(
        args.training_script_args
    )
    node_rank = (
        args.node_rank
        if args.node_rank >= 0
        else int(os.getenv(NodeEnv.NODE_RANK, "0"))
    )

    master_proc = None
    master_addr = args.master or os.getenv(NodeEnv.MASTER_ADDR, "")
    if not master_addr:
        if node_rank == 0:
            master_proc, master_addr = _launch_local_master(
                max_nodes, min_nodes, args.node_unit
            )
        else:
            raise SystemExit(
                "--master is required on non-rank-0 nodes"
            )

    # Evaluator ids live in their own namespace (like PS ids): the
    # agent keys every RPC (register/heartbeat/failure) by node_id, so
    # evaluator rank 0 must not collide with worker 0 in the master's
    # node table — and it claims the PENDING node a master started
    # with --evaluator_count pre-scheduled under the same id.
    node_id = node_rank
    if args.role == "evaluator":
        from dlrover_tpu_torch.common.constants import evaluator_node_id

        node_id = evaluator_node_id(max(node_rank, 0))

    os.environ[NodeEnv.MASTER_ADDR] = master_addr
    os.environ[NodeEnv.NODE_ID] = str(node_id)
    os.environ[NodeEnv.NODE_RANK] = str(node_rank)
    # Role/rank tag for logs (common/log.py) and obs trace events —
    # inherited by the agent's trainer subprocesses.
    os.environ["DLROVER_TPU_ROLE"] = args.role
    # The agent process's black box (crash bundles, hang forensics
    # assembly). Installed at the CLI entry, not ElasticAgent.run(),
    # so in-process test agents never rewire pytest's excepthooks.
    from dlrover_tpu_torch import obs

    obs.install_flight_recorder("agent", rank=node_rank)
    MasterClient.reset()

    if args.module:
        entry_cmd = [sys.executable, "-m", args.training_script]
    else:
        entry_cmd = [sys.executable, args.training_script]
    entry_cmd += list(args.training_script_args)

    config = AgentConfig(
        node_id=node_id,
        node_rank=node_rank,
        node_type=args.role,
        local_world_size=nproc,
        max_restarts=args.max_restarts,
        network_check=args.network_check,
        exclude_straggler=args.exclude_straggler,
        rdzv_timeout=args.rdzv_timeout,
        heartbeat_interval=args.heartbeat_interval,
    )
    agent = ElasticAgent(config, entry_cmd)
    try:
        return agent.run()
    finally:
        agent.stop()
        if master_proc is not None:
            master_proc.terminate()
            try:
                master_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                master_proc.kill()


def main(argv=None) -> int:
    args = parse_args(argv)
    _place_runtime_files()
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
