"""Agent-side replica supervisor: process supervision for the
serving plane.

The training agent supervises a trainer process (restart budgets,
failure classification); this is the same idea for a serving replica:
spawn ``python -m dlrover_tpu_torch.serving.replica`` as a child process,
watch it, and relaunch on exit within a bounded budget — so the
remediation ladder's *restart* rung has a real executor on the host
(the master pushes ``restart_training`` on the replica's heartbeat;
the in-process worker bounces itself, and if the whole process died,
this supervisor brings a fresh incarnation up, which re-registers and
triggers the router's requeue-on-reregistration).

Kept deliberately simple (no exit classification — a replica crash
is always relaunchable until the budget runs out): serving has no
shard ledger to corrupt, the router's request ledger owns all
durable state.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import ensure_framework_on_pythonpath
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("agent.replica_supervisor")

_RESTARTS_TOTAL = obs.counter(
    "dlrover_serve_replica_restarts_total",
    "Replica process relaunches by the agent-side supervisor, by "
    "reason (exit / action)",
    ("reason",),
)


class ReplicaSupervisor:
    def __init__(
        self,
        master_addr: str,
        replica_id: int,
        seed: int = 0,
        max_restarts: int = 3,
        restart_backoff_s: float = 1.0,
        extra_args: Optional[List[str]] = None,
        env: Optional[dict] = None,
        poll_interval: float = 0.2,
        role: str = "mixed",
    ):
        self.master_addr = master_addr
        self.replica_id = replica_id
        self.seed = seed
        # Disaggregation role the spawned replica registers with
        # (prefill / decode / mixed) — a supervisor relaunch must
        # bring the SAME role back, or the fleet changes shape.
        self.role = role
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.extra_args = list(extra_args or [])
        self._env = env
        self.poll_interval = poll_interval
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _command(self) -> List[str]:
        return [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.serving.replica",
            "--master", self.master_addr,
            "--replica_id", str(self.replica_id),
            "--seed", str(self.seed),
            "--role", self.role,
            *self.extra_args,
        ]

    def spawn(self) -> subprocess.Popen:
        env = ensure_framework_on_pythonpath(
            dict(self._env if self._env is not None else os.environ)
        )
        env.setdefault("JAX_PLATFORMS", "cpu")
        self.proc = subprocess.Popen(
            self._command(),
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        obs.event(
            "serve.replica_spawn",
            replica_id=self.replica_id, pid=self.proc.pid,
        )
        logger.info(
            "replica %d spawned (pid %d)",
            self.replica_id, self.proc.pid,
        )
        return self.proc

    def restart(self, reason: str = "action") -> None:
        """Kill + respawn (the process-level restart rung). Counts
        against the same budget as crash relaunches."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.restarts += 1
        _RESTARTS_TOTAL.inc(reason=reason)
        self.spawn()

    # -- supervision loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        if self.proc is None:
            self.spawn()
        self._thread = threading.Thread(
            target=self._watch,
            name=f"replica-supervisor-{self.replica_id}",
            daemon=True,
        )
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            proc = self.proc
            if proc is None or proc.poll() is None:
                continue
            if self.restarts >= self.max_restarts:
                logger.error(
                    "replica %d exited rc=%s past its restart "
                    "budget (%d); giving up — the master's watchdog "
                    "will declare the node dead and requeue",
                    self.replica_id, proc.returncode,
                    self.max_restarts,
                )
                obs.event(
                    "serve.replica_budget_exhausted",
                    replica_id=self.replica_id,
                    rc=proc.returncode,
                )
                return
            logger.warning(
                "replica %d exited rc=%s; relaunching (%d/%d)",
                self.replica_id, proc.returncode,
                self.restarts + 1, self.max_restarts,
            )
            self._stop.wait(self.restart_backoff_s)
            if self._stop.is_set():
                return
            self.restarts += 1
            _RESTARTS_TOTAL.inc(reason="exit")
            self.spawn()

    def stop(self, kill: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if kill and self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def wait_until(
    predicate, timeout: float = 30.0, interval: float = 0.1
) -> bool:
    """Poll ``predicate`` until truthy or timeout (drill helper)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False
