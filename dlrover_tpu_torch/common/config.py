"""Global job context (singleton) and env-driven configuration.

Parity: dlrover/python/common/global_context.py:190 ``Context``. Values
come from env vars first, then master-pushed overrides.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.constants import DefaultValues, NodeEnv, PlatformType


def env_int(name: str, default: int) -> int:
    v = os.getenv(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    return os.getenv(name, default)


def ensure_framework_on_pythonpath(env: Dict[str, str]) -> Dict[str, str]:
    """Make subprocesses able to ``import dlrover_tpu`` regardless of
    their cwd or script location.

    Python puts the *script's* directory — not the cwd — on
    ``sys.path``, so a training script living elsewhere would not find
    an uninstalled framework checkout. Prepend the package root to
    PYTHONPATH (launcher parity: torchrun relies on pip-installation
    instead; we support running straight from a checkout).
    """
    import dlrover_tpu_torch

    pkg_root = os.path.dirname(
        os.path.dirname(os.path.abspath(dlrover_tpu_torch.__file__))
    )
    existing = env.get("PYTHONPATH", "")
    parts = [p for p in existing.split(os.pathsep) if p]
    if pkg_root not in parts:
        env["PYTHONPATH"] = os.pathsep.join([pkg_root] + parts)
    return env


def env_bool(name: str, default: bool = False) -> bool:
    v = os.getenv(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


class Context:
    """Process-wide configuration singleton."""

    _instance: Optional["Context"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.job_name = env_str(NodeEnv.JOB_NAME, "local-job")
        self.master_addr = env_str(NodeEnv.MASTER_ADDR, "")
        self.node_id = env_int(NodeEnv.NODE_ID, 0)
        self.node_rank = env_int(NodeEnv.NODE_RANK, 0)
        self.node_num = env_int(NodeEnv.NODE_NUM, 1)
        self.platform = env_str(NodeEnv.PLATFORM, PlatformType.LOCAL)

        self.rdzv_timeout_secs = DefaultValues.RDZV_TIMEOUT_SECS
        self.pending_timeout_secs = DefaultValues.PENDING_TIMEOUT_SECS
        self.hang_timeout_secs = DefaultValues.HANG_TIMEOUT_SECS
        self.shard_timeout_secs = DefaultValues.SHARD_TIMEOUT_SECS
        self.relaunch_max = DefaultValues.RELAUNCH_MAX
        self.report_interval_secs = DefaultValues.REPORT_INTERVAL_SECS

        self.seconds_to_wait_pending_pod = 900
        self.master_port = DefaultValues.MASTER_PORT

        # Master-pushed overrides (e.g. from the brain/auto-tuner).
        self._overrides: Dict[str, Any] = {}

    @classmethod
    def singleton(cls) -> "Context":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Testing hook: drop the singleton so env changes take effect."""
        with cls._lock:
            cls._instance = None

    def apply_overrides(self, overrides: Dict[str, Any]) -> None:
        self._overrides.update(overrides)
        for k, v in overrides.items():
            if hasattr(self, k) and not k.startswith("_"):
                setattr(self, k, v)


def get_context() -> Context:
    return Context.singleton()
