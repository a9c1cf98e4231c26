"""High-level Checkpointer frontend (the port's counterpart of
``dlrover_tpu/trainer/flash_checkpoint/checkpointer.py``).

One frontend for the port's replicated data parallelism: the engine
stages the state on global rank 0 and restores it on every rank. The
process group, when there is one, comes from ``torch.distributed``
(``trainer/torch_env.py`` sets it up), where the JAX frontend asks
``jax.process_count()``/``jax.process_index()``.

When no host agent is present (a run outside ``elastic_run``), global
rank 0 hosts an AsyncCheckpointSaver thread in-process, the analogue of
dlrover-run's local-master fallback, and unlinks its shm segment when
it closes.
"""

from __future__ import annotations

import os
from enum import Enum
from typing import Optional

import torch

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    CheckpointEngine,
    unlink_shm,
)

logger = get_logger("flash_ckpt")

AGENT_ENV = "DLROVER_TPU_AGENT_PRESENT"


class StorageType(Enum):
    MEMORY = 0
    DISK = 1


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Checkpointer:
    def __init__(
        self,
        checkpoint_dir: str,
        local_rank: Optional[int] = None,
        save_timeout: float = 600.0,
    ):
        if local_rank is None:
            local_rank = int(os.getenv("LOCAL_RANK", "0"))
        self.checkpoint_dir = checkpoint_dir
        self._self_hosted_saver = None
        if os.getenv(AGENT_ENV, "") != "1" and _rank() == 0:
            if local_rank != 0:
                logger.warning(
                    "standalone Checkpointer forces local_rank 0 "
                    "(got %s)", local_rank)
                local_rank = 0
            # Standalone: host the async saver ourselves. One shard in
            # the job: only global rank 0 stages replicated state.
            from dlrover_tpu_torch.agent.ckpt_saver import (
                AsyncCheckpointSaver,
            )

            self._self_hosted_saver = (
                AsyncCheckpointSaver.start_async_saving_ckpt(
                    checkpoint_dir=checkpoint_dir,
                    local_shard_num=1,
                    global_shard_num=1,
                    is_commit_owner=True,
                    commit_timeout=save_timeout,
                )
            )
        self.engine = CheckpointEngine(
            checkpoint_dir, local_rank=local_rank
        )
        # Step of the checkpoint most recently restored by
        # load_checkpoint (-1 = none restored yet), and the extras
        # saved alongside it (sampler state, user metadata).
        self.last_restored_step = -1
        self.last_restored_extra: dict = {}

    def save_checkpoint(
        self,
        step: int,
        state,
        storage_type: StorageType = StorageType.DISK,
        extra: Optional[dict] = None,
    ) -> bool:
        """Stage ``state`` into host shm; for DISK also trigger async
        persistence. Returns once staging is done: storage IO never
        blocks the train loop."""
        if storage_type == StorageType.MEMORY:
            return self.engine.save_to_memory(step, state, extra)
        return self.engine.save_to_storage(step, state, extra)

    def load_checkpoint(self, like, step: Optional[int] = None):
        """Restore a committed checkpoint (the latest, or ``step=``)
        into a tree shaped like ``like``. Returns the restored state, or
        None if no step is committed, and raises when a committed step
        cannot be read; the step restored is in ``last_restored_step``."""
        res = self.engine.load(like, step=step)
        if res is None:
            return None
        found_step, state, extra = res
        self.last_restored_step = found_step
        self.last_restored_extra = extra
        return state

    def latest_step(self) -> int:
        return self.engine.latest_step()

    def wait_latest_checkpoint(self, timeout: float = 60.0) -> bool:
        """Block until the most recently staged step is committed (True
        at once on ranks that stage nothing)."""
        step = self.engine._cached_step
        if step < 0:
            return True
        return self.engine.wait_persisted(step, timeout)

    def close(self) -> None:
        self.engine.close()
        if self._self_hosted_saver is not None:
            self._self_hosted_saver.close()
            self._self_hosted_saver = None
            unlink_shm(self.engine.local_rank)
