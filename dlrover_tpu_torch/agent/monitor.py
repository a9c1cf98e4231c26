"""Agent-side monitors: node resources and training progress.

Parity with the reference's agent monitors
(dlrover/python/elastic_agent/monitor/resource.py:90 ResourceMonitor —
psutil + pynvml telemetry pushed to the master; monitor/training.py:79
TorchTrainingMonitor — global-step reports feeding the master's speed
monitor). TPU adaptation: chip telemetry comes from JAX's
``local_devices()[i].memory_stats()`` (HBM in use) instead of pynvml,
and the training side reads the metrics file the trainer process
writes (same file-drop mechanism as the reference's
ConfigPath.RUNTIME_METRICS).
"""

from __future__ import annotations

import collections
import json
import os
import socket
import subprocess
import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs import beacon as beacon_mod

logger = get_logger("agent_monitor")

# How many of the trainer's most recent per-step wall times ride the
# metrics file (and from there the master's fleet snapshot).
RECENT_STEP_TIMES = 32

METRICS_FILE_ENV = "DLROVER_TPU_METRICS_FILE"
PHASES_FILE_ENV = "DLROVER_TPU_PHASES_FILE"

# Local staleness threshold before the agent treats the co-hosted
# trainer's beacon as wedged and fires its forensics hook. Sits above
# any sane step time but well under the master's heartbeat timeout,
# so the host-local SIGUSR1 capture lands while the wedge is live.
BEACON_STALL_ENV = "DLROVER_TPU_BEACON_STALL_S"
DEFAULT_BEACON_STALL_S = 120.0


def default_metrics_file() -> str:
    """Job-scoped path (same rule as paral_config_tuner.
    default_config_file): two jobs on one host must not cross-talk the
    hang detector and step/speed reports."""
    job = os.getenv("DLROVER_TPU_JOB_NAME", "default")
    return f"/tmp/dlrover_tpu_train_metrics_{job}.json"


def current_resource_stats() -> dict:
    """One sample of host + TPU utilization."""
    stats = {
        "cpu_percent": 0.0,
        "memory_mb": 0,
        "hbm_used_gb": 0.0,
        "duty_cycle": 0.0,
    }
    try:
        import psutil

        stats["cpu_percent"] = psutil.cpu_percent(interval=None)
        stats["memory_mb"] = int(
            psutil.Process().memory_info().rss / (1 << 20)
        )
    except Exception:  # noqa: BLE001 — psutil optional
        pass
    # Device memory from nvidia-smi, never through torch.cuda: the agent
    # must not open a CUDA context on the card its trainers use.
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout
        used_mib = sum(
            float(line.split(",")[0]) for line in out.splitlines()
            if line.strip()
        )
        stats["hbm_used_gb"] = used_mib / 1024
    except (OSError, ValueError, subprocess.SubprocessError):
        pass  # no nvidia-smi (CPU host) or an unreadable answer
    return stats


class ResourceMonitor:
    """Samples resources and reports them to the master.

    Each report also ships a fleet-telemetry snapshot: this process's
    obs registry dump, the trainer's recent per-step wall times (read
    from the step-metrics file the training process writes), a derived
    tokens/s, and any tracer events new since the previous snapshot —
    the agent half of the master's FleetAggregator."""

    def __init__(
        self,
        client,
        interval: float = 30.0,
        metrics_file: Optional[str] = None,
        beacon_path: Optional[str] = None,
        on_stale_beacon=None,
    ):
        self.client = client
        self.interval = interval
        self.metrics_file = metrics_file or os.getenv(
            METRICS_FILE_ENV, default_metrics_file()
        )
        # Stall beacon: each snapshot ships the trainer's last
        # progress stamp + locally-computed staleness; a stamp older
        # than the stall threshold fires on_stale_beacon(stamp) once
        # per distinct wedge (the agent wires its SIGUSR1 forensics
        # capture here).
        self.beacon_path = beacon_path or beacon_mod.beacon_file()
        self.on_stale_beacon = on_stale_beacon
        try:
            self.beacon_stall_s = float(
                os.getenv(BEACON_STALL_ENV, "")
                or DEFAULT_BEACON_STALL_S
            )
        except ValueError:
            self.beacon_stall_s = DEFAULT_BEACON_STALL_S
        self._stall_fired_key: Optional[tuple] = None
        self.host = (
            os.getenv("DLROVER_TPU_HOST_IP", "")
            or socket.gethostname()
            or f"node{getattr(client, 'node_id', -1)}"
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # snapshot bookkeeping: send each step time / event only once
        self._last_snapshot_step = -1
        self._event_tracer = None
        self._event_cursor = 0
        # When the host traces to a file, EVERY process on the host
        # (this agent AND the training process it supervises) appends
        # to that one file — tailing it is how trainer-side spans
        # (steps, ckpt stages, prefetch waits, compile marks) reach
        # the master's goodput accountant.
        from dlrover_tpu_torch.obs.tracer import TRACE_FILE_ENV

        self._trace_path = os.getenv(TRACE_FILE_ENV, "")
        # Start at the file's CURRENT end: the sink appends across
        # agent restarts, and the previous incarnation already shipped
        # the history — replaying it would double-count goodput.
        self._trace_offset = 0
        if self._trace_path:
            try:
                self._trace_offset = os.path.getsize(self._trace_path)
            except OSError:
                pass
        self._last_tokens: Optional[tuple] = None  # (ts, tokens)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="resource-monitor", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _read_trainer_metrics(self) -> dict:
        try:
            with open(self.metrics_file) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        return data if isinstance(data, dict) else {}

    def _new_step_times(self, data: dict) -> list:
        step = int(data.get("step", -1))
        recent = [
            float(t)
            for t in data.get("recent_step_times", [])
            if isinstance(t, (int, float)) and t > 0
        ]
        if step < 0:
            return []
        if step <= self._last_snapshot_step:
            # Trainer restarted at a lower step: re-baseline.
            if step < self._last_snapshot_step:
                self._last_snapshot_step = step
            return []
        new = min(step - self._last_snapshot_step, len(recent))
        self._last_snapshot_step = step
        return recent[-new:] if new > 0 else []

    def _tokens_per_s(self, data: dict) -> Optional[float]:
        ts = data.get("ts")
        tokens = data.get("tokens")
        if ts is None or tokens is None:
            return None
        prev, self._last_tokens = self._last_tokens, (ts, tokens)
        if prev is None:
            return None
        dt = float(ts) - float(prev[0])
        dtok = float(tokens) - float(prev[1])
        if dt <= 0 or dtok < 0:
            return None
        return dtok / dt

    # Per-snapshot bound on tailed trace bytes / parsed events, so a
    # chatty trainer cannot balloon one RPC.
    MAX_TRACE_TAIL_BYTES = 1 << 20
    MAX_EVENTS_PER_SNAPSHOT = 5000

    def _tail_trace_events(self) -> list:
        """New complete JSONL lines of the shared trace file since the
        last snapshot (byte-offset cursor; resets on truncation)."""
        try:
            size = os.path.getsize(self._trace_path)
        except OSError:
            return []
        if size < self._trace_offset:
            self._trace_offset = 0  # file truncated/recreated
        if size <= self._trace_offset:
            return []
        try:
            with open(self._trace_path, "rb") as f:
                f.seek(self._trace_offset)
                chunk = f.read(self.MAX_TRACE_TAIL_BYTES)
        except OSError:
            return []
        last_nl = chunk.rfind(b"\n")
        if last_nl < 0:
            return []  # torn line in flight; retry next snapshot
        # Consume only as far as the event cap: the cursor must not
        # skip lines this snapshot didn't ship — the surplus waits
        # for the next snapshot instead of being dropped.
        data = chunk[: last_nl + 1]
        events = []
        consumed = 0
        while (
            consumed < len(data)
            and len(events) < self.MAX_EVENTS_PER_SNAPSHOT
        ):
            nl = data.index(b"\n", consumed)
            line = data[consumed:nl]
            consumed = nl + 1
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "name" in rec and "ts" in rec:
                events.append(rec)
        self._trace_offset += consumed
        return events

    def _new_events(self) -> list:
        if self._trace_path:
            # The in-memory ring would only cover this agent process;
            # the file covers every process on the host (no dupes:
            # agent events are in the file too, so the ring is
            # skipped entirely).
            return self._tail_trace_events()
        tracer = obs.get_tracer()
        if tracer is None:
            return []
        if tracer is not self._event_tracer:
            # configure_tracer replaced the instance: restart the
            # arrival cursor.
            self._event_tracer = tracer
            self._event_cursor = 0
        events, self._event_cursor = tracer.events_since(
            self._event_cursor
        )
        return events[-self.MAX_EVENTS_PER_SNAPSHOT:]

    def build_snapshot(self, stats: Optional[dict] = None) -> dict:
        """The MetricsSnapshotReport payload (sans node_id), exposed
        for tests and for trainers that report their own registry."""
        resource = dict(stats or current_resource_stats())
        data = self._read_trainer_metrics()
        tps = self._tokens_per_s(data)
        if tps is not None:
            resource["tokens_per_s"] = tps
        mfu = data.get("mfu")
        if isinstance(mfu, (int, float)) and mfu > 0:
            resource["mfu"] = float(mfu)
        return {
            "host": self.host,
            "registry": obs.get_registry().dump(),
            "resource": resource,
            "step_times": self._new_step_times(data),
            "events": self._new_events(),
            "beacon": self.beacon_payload(),
        }

    def beacon_payload(self) -> dict:
        """The trainer's last progress stamp plus its staleness age
        on this host's monotonic clock (the writer may be wedged —
        only the file is consulted). Empty when no beacon exists."""
        stamp = beacon_mod.read_beacon(self.beacon_path)
        if not stamp:
            return {}
        age = beacon_mod.stamp_age(stamp)
        out = dict(stamp)
        out["age_s"] = round(age, 3) if age is not None else -1.0
        return out

    def check_beacon_stall(self, stamp: dict) -> bool:
        """Fire the forensics hook when the local beacon is wedged;
        re-arms as soon as the stamp advances. Returns True when the
        hook fired this call."""
        if self.on_stale_beacon is None or not stamp:
            return False
        age = stamp.get("age_s")
        if not isinstance(age, (int, float)) or age < self.beacon_stall_s:
            self._stall_fired_key = None
            return False
        key = (stamp.get("pid"), stamp.get("seq"))
        if key == self._stall_fired_key:
            return False
        self._stall_fired_key = key
        try:
            self.on_stale_beacon(dict(stamp))
        except Exception:  # noqa: BLE001 — capture is best-effort
            logger.warning("stale-beacon hook failed", exc_info=True)
        return True

    def report_once(self) -> dict:
        stats = current_resource_stats()
        try:
            self.client.report_resource(**stats)
        except Exception:  # noqa: BLE001
            logger.debug("resource report failed", exc_info=True)
        snap = self.build_snapshot(stats)
        try:
            self.client.report_metrics_snapshot(**snap)
        except Exception:  # noqa: BLE001 — fleet telemetry is
            # best-effort (and test fakes may lack the method)
            logger.debug("metrics snapshot failed", exc_info=True)
        self.check_beacon_stall(snap.get("beacon") or {})
        return stats

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.report_once()


class TrainingMonitor:
    """Relays the trainer's step metrics file to the master speed
    monitor (ref TorchTrainingMonitor.report_resource_with_step,
    elastic_agent/monitor/training.py:79)."""

    def __init__(
        self,
        client,
        metrics_file: Optional[str] = None,
        interval: float = 15.0,
    ):
        self.client = client
        self.metrics_file = metrics_file or os.getenv(
            METRICS_FILE_ENV, default_metrics_file()
        )
        self.interval = interval
        self._last_step = -1
        self._last_tokens = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # Per-process rolling window of recent step wall times, keyed by
    # metrics-file path (write_metrics is a staticmethod; the trainer
    # process owns exactly one window per file).
    _recent_step_times: Dict[str, "collections.deque"] = {}

    @staticmethod
    def write_metrics(
        step: int,
        tokens: int = 0,
        path: Optional[str] = None,
        step_time: Optional[float] = None,
        mfu: Optional[float] = None,
    ) -> None:
        """Called from the TRAINING process each step (cheap: one
        tmp-file rename). ``step_time`` — this step's wall time, when
        the loop measures it — accumulates into a rolling
        ``recent_step_times`` window the agent forwards to the
        master's straggler scorer. ``mfu`` — the trainer's live
        model-FLOPs-utilisation — rides the same file into the
        agent's fleet snapshot (resource ``mfu``), so the master can
        aggregate utilisation across hosts."""
        obs.event("trainer.step", step=step, tokens=tokens)
        # Last-known-step into the black box: one dict update, so a
        # crash bundle can say how far training got even when the
        # metrics file is gone with the container.
        obs.recorder_note(step=step, tokens=tokens)
        path = path or os.getenv(METRICS_FILE_ENV, default_metrics_file())
        recent = TrainingMonitor._recent_step_times.setdefault(
            path, collections.deque(maxlen=RECENT_STEP_TIMES)
        )
        if step_time is not None and step_time > 0:
            recent.append(round(float(step_time), 6))
        data = {
            "step": step,
            "tokens": tokens,
            "ts": time.time(),
            "recent_step_times": list(recent),
        }
        if mfu is not None and mfu > 0:
            data["mfu"] = round(float(mfu), 6)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    @staticmethod
    def mark_phase(name: str, path: Optional[str] = None) -> None:
        """Timestamp a startup/recovery phase boundary from the
        TRAINING process (proc_start, dist_ready, built, restore_done,
        first_step_done, ...). Written only when
        DLROVER_TPU_PHASES_FILE is set (or ``path`` given) — chaos
        drills use the marks to break a recovery time into
        explainable, budget-checkable segments. Each trainer (re)start
        overwrites the file from its own proc_start, so the file
        always describes the LATEST attempt."""
        # Mirror every mark into the obs tracer (its own env gate,
        # DLROVER_TPU_TRACE_FILE): the recovery-timeline reconstructor
        # (obs/timeline.py) folds these "trainer.<mark>" events into
        # the canonical failure-detect/rendezvous/restore/first-step
        # breakdown. No-op when tracing is off.
        obs.event(f"trainer.{name}")
        path = path or os.getenv(PHASES_FILE_ENV)
        if not path:
            return
        marks = {}
        if name != "proc_start":
            try:
                with open(path) as f:
                    marks = json.load(f)
            except (OSError, ValueError):
                marks = {}
        marks[name] = time.time()
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(marks, f)
        os.replace(tmp, path)

    def report_once(self) -> Optional[int]:
        try:
            with open(self.metrics_file) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        step = int(data.get("step", -1))
        if step == self._last_step:
            return None
        if step < self._last_step:
            # Training process restarted at an earlier step (resume
            # from checkpoint / from scratch): re-baseline instead of
            # going silent until the old high-water mark is passed.
            self._last_tokens = 0
        self._last_step = step
        # The metrics file carries a CUMULATIVE token count; the
        # master's speed monitor accumulates per-report deltas.
        tokens = int(data.get("tokens", 0))
        delta = max(tokens - self._last_tokens, 0)
        self._last_tokens = tokens
        try:
            self.client.report_step(step, delta)
        except Exception:  # noqa: BLE001
            logger.debug("step report failed", exc_info=True)
        return step

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="training-monitor", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.report_once()
