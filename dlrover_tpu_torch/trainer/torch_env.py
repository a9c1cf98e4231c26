"""torch.distributed bootstrap from the agent's environment (the port's
counterpart of ``dlrover_tpu/trainer/jax_env.py``).

The agent (``agent/agent.py``) hands every training process its world:
the coordinator address that global rank 0 binds, its rank, the world
size and its local rank (``DLROVER_TPU_COORDINATOR_ADDR``,
``DLROVER_TPU_PROCESS_ID``, ``DLROVER_TPU_NUM_PROCESSES``, and
torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``). :func:`setup_distributed` turns them into
``torch.distributed.init_process_group``: NCCL when the trainer runs on
the card, gloo when the caller asked for the CPU. A world of one
initialises too, so the card's path runs the same collectives as a
larger world. A process started outside the agent has no coordinator
and runs without a process group, as before.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("torch_env")

_initialized = False


def num_processes() -> int:
    return int(os.getenv(NodeEnv.NUM_PROCESSES, "1"))


def process_id() -> int:
    return int(os.getenv(NodeEnv.PROCESS_ID, "0"))


def coordinator_address() -> Optional[str]:
    return os.getenv(NodeEnv.COORDINATOR_ADDR) or None


def restart_count() -> int:
    return int(os.getenv(NodeEnv.RESTART_COUNT, "0"))


def local_rank() -> int:
    return int(os.getenv("LOCAL_RANK", "0"))


def setup_distributed(
    device: DeviceLike = None, timeout_s: float = 600.0
) -> torch.device:
    """Join the agent's world, when it gave one, and return the device
    this process trains on: ``cuda:LOCAL_RANK`` unless the caller asks
    for the CPU. Raises when CUDA is asked for and absent, or when the
    process group cannot form. Idempotent."""
    global _initialized
    # Black box before the backend: an agent-supervised training
    # process gets its flight recorder (crash bundles and the SIGUSR1
    # stack dump the agent's hang forensics rely on) before NCCL can
    # wedge or die. Standalone runs opt in with
    # DLROVER_TPU_FLIGHT_RECORDER=1.
    if (
        os.getenv("DLROVER_TPU_AGENT_PRESENT", "") == "1"
        or os.getenv("DLROVER_TPU_FLIGHT_RECORDER", "") == "1"
    ):
        from dlrover_tpu_torch import obs

        obs.install_flight_recorder(
            "trainer", rank=int(os.getenv(NodeEnv.NODE_RANK, "-1"))
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    addr = coordinator_address()
    if _initialized or addr is None:
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    n, rank = num_processes(), process_id()
    logger.info(
        "init_process_group(%s, tcp://%s, world_size=%d, rank=%d, "
        "local_rank=%d)", backend, addr, n, rank, local_rank(),
    )
    torch.distributed.init_process_group(
        backend,
        init_method=f"tcp://{addr}",
        world_size=n,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if dev.type == "cuda" else None,
    )
    _initialized = True
    return dev


def teardown_distributed() -> None:
    global _initialized
    if not _initialized:
        return
    try:
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001
        logger.warning("destroy_process_group failed", exc_info=True)
    _initialized = False
