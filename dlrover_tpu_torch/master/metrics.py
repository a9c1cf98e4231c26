"""Job metric collection and reporting.

Parity with the reference's stats layer
(dlrover/python/master/stats/job_collector.py JobMetricCollector +
reporter.py pluggable reporter backends): the master aggregates job
facts (runtime, node counts, speed, failures) and periodically hands a
snapshot to a reporter. Backends: log (default) and JSON-lines file;
the seam is where a metrics service / Brain datastore plugs in.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("metrics")


@dataclasses.dataclass
class JobSnapshot:
    timestamp: float
    job_name: str
    runtime_s: float
    global_step: int
    speed_steps_per_s: float
    token_throughput: float
    workers_alive: int
    workers_pending: int
    workers_failed: int
    total_relaunches: int
    failure_counts: Dict[str, int]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Reporter:
    def report(self, snapshot: JobSnapshot) -> None:
        raise NotImplementedError


class LogReporter(Reporter):
    def report(self, snapshot: JobSnapshot) -> None:
        logger.info("job metrics: %s", json.dumps(snapshot.to_dict()))


class JsonFileReporter(Reporter):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def report(self, snapshot: JobSnapshot) -> None:
        with self._lock, open(self.path, "a") as f:
            f.write(json.dumps(snapshot.to_dict()) + "\n")


class RegistryReporter(Reporter):
    """Mirrors each snapshot into the obs metrics registry, which the
    master exposes in Prometheus text format (HTTP /metrics and the
    MetricsRequest RPC). Event-driven counters (relaunches, rendezvous
    rounds) are incremented at their source; this reporter owns the
    sampled job-level gauges."""

    def __init__(self, registry=None):
        registry = registry or obs.get_registry()
        self._workers = registry.gauge(
            "dlrover_job_workers",
            "Worker nodes by state",
            ("state",),
        )
        self._relaunch_total = registry.gauge(
            "dlrover_job_worker_relaunches",
            "Cumulative relaunch count across current worker nodes",
        )
        self._step = registry.gauge(
            "dlrover_job_global_step", "Latest reported global step"
        )
        self._speed = registry.gauge(
            "dlrover_job_steps_per_second",
            "Training speed over the speed-monitor window",
        )
        self._tokens = registry.gauge(
            "dlrover_job_tokens_per_second",
            "Token throughput over the speed-monitor window",
        )
        self._runtime = registry.gauge(
            "dlrover_job_runtime_seconds", "Master-observed job runtime"
        )

    def report(self, snapshot: JobSnapshot) -> None:
        self._workers.set(snapshot.workers_alive, state="alive")
        self._workers.set(snapshot.workers_pending, state="pending")
        self._workers.set(snapshot.workers_failed, state="failed")
        self._relaunch_total.set(snapshot.total_relaunches)
        self._step.set(snapshot.global_step)
        self._speed.set(snapshot.speed_steps_per_s)
        self._tokens.set(snapshot.token_throughput)
        self._runtime.set(snapshot.runtime_s)


class JobMetricCollector:
    def __init__(
        self,
        job_name: str,
        job_manager,
        speed_monitor,
        reporters: Optional[List[Reporter]] = None,
        interval: float = 60.0,
    ):
        self.job_name = job_name
        self.job_manager = job_manager
        self.speed_monitor = speed_monitor
        self.reporters = reporters or [LogReporter()]
        self.interval = interval
        # Monotonic: only used for the runtime_s duration below.
        self.start_time = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def snapshot(self) -> JobSnapshot:
        nodes = self.job_manager.list_nodes(NodeType.WORKER)
        failure_counts: Dict[str, int] = {}
        for n in nodes:
            reason = n.exit_reason or n.relaunch_reason
            if reason:
                failure_counts[reason] = (
                    failure_counts.get(reason, 0) + 1
                )
        return JobSnapshot(
            timestamp=time.time(),
            job_name=self.job_name,
            runtime_s=time.monotonic() - self.start_time,
            global_step=self.speed_monitor.global_step,
            speed_steps_per_s=self.speed_monitor.running_speed(),
            token_throughput=self.speed_monitor.token_throughput(),
            workers_alive=sum(
                1 for n in nodes if n.status == NodeStatus.RUNNING
            ),
            workers_pending=sum(
                1 for n in nodes if n.status == NodeStatus.PENDING
            ),
            workers_failed=sum(
                1 for n in nodes if n.status == NodeStatus.FAILED
            ),
            total_relaunches=sum(n.relaunch_count for n in nodes),
            failure_counts=failure_counts,
        )

    def collect_once(self) -> JobSnapshot:
        snap = self.snapshot()
        for r in self.reporters:
            try:
                r.report(snap)
            except Exception:  # noqa: BLE001
                logger.warning("reporter failed", exc_info=True)
        return snap

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="metric-collector", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        """Stop and JOIN the collector thread so shutdown is
        deterministic — the loop wakes from its interval wait
        immediately on the stop event, so the join is prompt."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=10.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.collect_once()
            except Exception:  # noqa: BLE001
                logger.warning("metric collection failed", exc_info=True)
