"""Flash Checkpoint for the port: the training process stages its state
into host shared memory in a fraction of a second; the host agent
persists shm to storage asynchronously, on a failure signal, or right
before an elastic restart, so a crashed trainer never loses the last
in-memory checkpoint (counterpart of
``dlrover_tpu/trainer/flash_checkpoint``).
"""

from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    CheckpointEngine,
)

__all__ = ["CheckpointEngine", "Checkpointer", "StorageType"]
