"""Training-hang detection (agent side).

Parity with atorch's fault-tolerance hang detector
(atorch/fault_tolerance/hanging_detector.py:86 + custom_agent.py:19
LocalDetectHangingAgent): the torch version has every rank write a
heartbeat tensor through the c10d store and relaunches workers when it
stalls. Here the signal is the step-metrics file the training process
already writes (agent/monitor.py TrainingMonitor.write_metrics) — a
training process that is alive but making no step progress for
``hang_timeout`` seconds is hung (deadlocked collective, stuck host
callback, wedged TPU runtime) and gets restarted by the agent.

Distinct from the master's heartbeat timeout (job_manager.py): that
catches dead *agents*; this catches live agents whose *training
process* stopped stepping.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.monitor import (
    default_metrics_file,
    METRICS_FILE_ENV,
)
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("hang_detector")

_HANGS_TOTAL = obs.counter(
    "dlrover_hang_detect_total",
    "Training-process hangs detected by the agent (no step progress "
    "within hang_timeout)",
)


class HangDetector:
    """Tracks step progress; ``check()`` returns True when hung.

    ``startup_grace`` covers compilation: the first step legitimately
    takes minutes on TPU (cold jit), so the clock only starts after
    the first step lands or the grace expires.
    """

    def __init__(
        self,
        hang_timeout: float = 600.0,
        startup_grace: float = 1800.0,
        metrics_file: Optional[str] = None,
    ):
        self.hang_timeout = hang_timeout
        self.startup_grace = startup_grace
        self.metrics_file = metrics_file or os.getenv(
            METRICS_FILE_ENV, default_metrics_file()
        )
        self.reset()

    def reset(self) -> None:
        # Monotonic, NOT wall clock: an NTP step would otherwise fake
        # a hang (clock jumps forward) or mask a real one (clock jumps
        # back) — hang detection measures elapsed time, nothing else.
        self._started_at = time.monotonic()
        self._last_step = -1
        self._last_progress = time.monotonic()
        self._hang_reported = False

    def _read_step(self) -> Optional[int]:
        try:
            with open(self.metrics_file) as f:
                return int(json.load(f).get("step", -1))
        except (OSError, ValueError):
            return None

    def check(self) -> bool:
        """True when the training process should be considered hung."""
        now = time.monotonic()
        step = self._read_step()
        # ANY step change counts as progress: a resume may restart at
        # a LOWER step than the previous incarnation's high-water mark
        # (the agent also clears the file on spawn, belt and braces).
        if step is not None and step != self._last_step:
            self._last_step = step
            self._last_progress = now
            self._hang_reported = False
            return False
        if self._last_step < 0:
            # still compiling / warming up
            hung = now - self._started_at > self.startup_grace
        else:
            hung = now - self._last_progress > self.hang_timeout
        if hung and not self._hang_reported:
            # Once per hang (reset()/progress re-arms): the fleet view
            # and recovery timelines must see the hang, not just the
            # restart it triggers.
            self._hang_reported = True
            _HANGS_TOTAL.inc()
            obs.event(
                "agent.hang_detected",
                seconds_since_progress=round(
                    self.seconds_since_progress(), 3
                ),
                last_step=self._last_step,
            )
        return hung

    def seconds_since_progress(self) -> float:
        return time.monotonic() - self._last_progress

    @property
    def last_step(self) -> int:
        """Last step observed before the stall (-1: never stepped)."""
        return self._last_step
