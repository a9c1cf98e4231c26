"""Parallel-config tuner (agent side).

Parity with the reference's ParalConfigTuner
(dlrover/python/elastic_agent/config/paral_config_tuner.py:31): the
master's auto-tuner publishes a ParallelConfig; the agent polls it and
drops it as a JSON file the training process reads on (re)start —
micro batch size, grad-accum, remat policy, mesh shape. The file-drop
mechanism survives training-process restarts, which is exactly when a
new config takes effect.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("paral_tuner")

CONFIG_FILE_ENV = "DLROVER_TPU_PARAL_CONFIG_FILE"


def default_config_file() -> str:
    """Job-scoped path: a leftover file from another job on the same
    host must not leak its tuning into this one."""
    job = os.getenv("DLROVER_TPU_JOB_NAME", "default")
    return f"/tmp/dlrover_tpu_paral_config_{job}.json"


class ParalConfigTuner:
    def __init__(
        self,
        client,
        config_file: Optional[str] = None,
        interval: float = 30.0,
    ):
        self.client = client
        self.config_file = config_file or os.getenv(
            CONFIG_FILE_ENV, default_config_file()
        )
        self.interval = interval
        self._seen_version = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> bool:
        """Fetch the master's config; write the file when it changed.
        Returns True if a new version landed."""
        try:
            cfg = self.client.get_parallel_config()
        except Exception:  # noqa: BLE001
            logger.debug("paral config fetch failed", exc_info=True)
            return False
        if cfg is None or cfg.version <= self._seen_version:
            return False
        self._seen_version = cfg.version
        tmp = self.config_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
        os.replace(tmp, self.config_file)
        logger.info(
            "parallel config v%d staged to %s",
            cfg.version,
            self.config_file,
        )
        return True

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="paral-tuner", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.poll_once()


def read_parallel_config(path: Optional[str] = None) -> Optional[dict]:
    """Training-process side: the staged config, or None."""
    path = path or os.getenv(CONFIG_FILE_ENV, default_config_file())
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
