"""Training speed monitor on the master.

Parity: dlrover/python/master/monitor/speed_monitor.py:43. Collects
per-node step/token reports, maintains a moving throughput window, and
exposes straggler/degradation signals used by the auto-scaler and the
judge of post-recovery throughput ("time to 90% of pre-failure speed").

Straggler scoring: every per-step wall time a host reports (direct
timings in metric snapshots, or derived from step-report deltas)
feeds a per-host EWMA; a host whose EWMA exceeds ``straggler_ratio``
times the fleet median — with at least ``min_straggler_hosts`` hosts
and ``min_straggler_samples`` samples each, so a 2-host job can never
out-vote itself — is a straggler. Transitions emit a
``node.straggler`` event and bump ``dlrover_straggler_total``; the
verdict backs the ``query_stragglers`` RPC and the auto-scaler.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from statistics import median
from typing import Deque, Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch import obs

STRAGGLER_RATIO_ENV = "DLROVER_TPU_STRAGGLER_RATIO"

_STRAGGLERS_TOTAL = obs.counter(
    "dlrover_straggler_total",
    "Hosts newly scored as stragglers (step-time EWMA above "
    "straggler_ratio x fleet median)",
    ("node",),
)
_HOST_STEP_EWMA = obs.gauge(
    "dlrover_host_step_seconds_ewma",
    "Per-host EWMA of reported per-step wall time",
    ("node",),
)


class SpeedMonitor:
    def __init__(
        self,
        window: int = 20,
        recovery_ratio: float = 0.9,
        straggler_ratio: Optional[float] = None,
        ewma_alpha: float = 0.3,
        min_straggler_hosts: int = 3,
        min_straggler_samples: int = 3,
    ):
        self._lock = threading.Lock()
        # (timestamp, global_step, tokens_since_last)
        self._samples: Deque[Tuple[float, int, int]] = deque(maxlen=window)
        self._global_step = 0
        self._global_tokens = 0
        # world size (chips) per sample window, to normalize per-chip
        self._alive_nodes: Set[int] = set()
        self._node_steps: Dict[int, int] = {}
        # last (timestamp, step) per node, to derive per-step time
        # from step reports when no direct timings arrive
        self._node_last_report: Dict[int, Tuple[float, int]] = {}
        # throughput recorded immediately before the last failure event
        self._pre_failure_tput: Optional[float] = None
        self._last_failure_time: Optional[float] = None
        # First sample timestamp whose window crossed
        # recovery_ratio * pre-failure throughput: recorded when the
        # crossing sample ARRIVES, so a late recovery_seconds() poll
        # reports the true recovery time, not the poll time.
        self._recovery_ratio = recovery_ratio
        self._recovery_crossed_at: Optional[float] = None
        # straggler scoring state
        if straggler_ratio is None:
            straggler_ratio = float(
                os.getenv(STRAGGLER_RATIO_ENV, "") or 2.0
            )
        self.straggler_ratio = straggler_ratio
        self._ewma_alpha = ewma_alpha
        self._min_straggler_hosts = min_straggler_hosts
        self._min_straggler_samples = min_straggler_samples
        self._host_step_ewma: Dict[int, float] = {}
        self._host_step_samples: Dict[int, int] = {}
        self._known_stragglers: Set[int] = set()
        # Called with a node_id when it is NEWLY scored a straggler —
        # the JobMaster wires this to push a `diagnose` action so a
        # host that went slow gets a stack-and-state snapshot while
        # it is still being slow. Exceptions are swallowed: a broken
        # trigger must not poison step accounting.
        self.on_straggler = None
        # Optional TimeSeriesStore (set by the JobMaster): every EWMA
        # update is also recorded as history, so the health plane's
        # straggler-persistence detector has an evidence window.
        self.timeseries = None

    # -- throughput window ---------------------------------------------------

    def _running_speed_locked(self) -> float:
        if len(self._samples) < 2:
            return 0.0
        t0, s0, _ = self._samples[0]
        t1, s1, _ = self._samples[-1]
        if t1 <= t0:
            return 0.0
        return (s1 - s0) / (t1 - t0)

    def _token_throughput_locked(self) -> float:
        if len(self._samples) < 2:
            return 0.0
        t0 = self._samples[0][0]
        t1 = self._samples[-1][0]
        if t1 <= t0:
            return 0.0
        tokens = sum(s[2] for s in list(self._samples)[1:])
        return tokens / (t1 - t0)

    def _window_tput_locked(self) -> float:
        return (
            self._token_throughput_locked()
            or self._running_speed_locked()
        )

    def _post_failure_tput_locked(self, since: float) -> Optional[float]:
        """Throughput over the window samples at/after ``since`` only
        — pre-failure samples still sitting in the deque must not
        vouch for a recovery they predate. None until two post-failure
        samples exist."""
        post = [s for s in self._samples if s[0] >= since]
        if len(post) < 2:
            return None
        t0, t1 = post[0][0], post[-1][0]
        if t1 <= t0:
            return 0.0
        tokens = sum(s[2] for s in post[1:])
        if tokens > 0:
            return tokens / (t1 - t0)
        return (post[-1][1] - post[0][1]) / (t1 - t0)

    def _note_recovery_crossing_locked(self, timestamp: float) -> None:
        """Record the first window that regains the recovery-ratio
        throughput. Called with the lock held, after the window moved."""
        if (
            self._pre_failure_tput is None
            or self._last_failure_time is None
            or self._recovery_crossed_at is not None
            or timestamp < self._last_failure_time
        ):
            return
        tput = self._post_failure_tput_locked(self._last_failure_time)
        if (
            tput is not None
            and tput >= self._recovery_ratio * self._pre_failure_tput
        ):
            self._recovery_crossed_at = timestamp

    def collect_global_step(
        self, step: int, timestamp: float, tokens: int = 0
    ) -> None:
        with self._lock:
            self._global_step = max(self._global_step, step)
            self._global_tokens += tokens
            self._samples.append((timestamp, step, tokens))
            self._note_recovery_crossing_locked(timestamp)

    def collect_node_step(
        self, node_id: int, step: int, timestamp: Optional[float] = None
    ) -> None:
        ts = timestamp if timestamp is not None else time.time()
        with self._lock:
            self._node_steps[node_id] = step
            prev = self._node_last_report.get(node_id)
            self._node_last_report[node_id] = (ts, step)
        if prev is not None:
            prev_ts, prev_step = prev
            if step > prev_step and ts > prev_ts:
                # Per-step wall time implied by the report cadence —
                # coarser than direct snapshot timings but keeps the
                # straggler score alive for agents that only send
                # step reports.
                self.observe_host_step_time(
                    node_id, (ts - prev_ts) / (step - prev_step)
                )

    @property
    def global_step(self) -> int:
        with self._lock:
            return self._global_step

    def running_speed(self) -> float:
        """Steps/sec over the sample window."""
        with self._lock:
            return self._running_speed_locked()

    def token_throughput(self) -> float:
        """Tokens/sec over the sample window."""
        with self._lock:
            return self._token_throughput_locked()

    # -- failure / recovery tracking ----------------------------------------

    def add_running_node(self, node_id: int) -> None:
        with self._lock:
            self._alive_nodes.add(node_id)

    def remove_running_node(self, node_id: int) -> None:
        """Record a failure event: snapshot throughput for recovery SLO."""
        with self._lock:
            if node_id in self._alive_nodes:
                self._alive_nodes.discard(node_id)
                self._last_failure_time = time.time()
                self._recovery_crossed_at = None
                # Snapshot under the SAME lock acquisition: reading
                # the window between two acquisitions let a racing
                # collect_global_step shift it first, baselining the
                # recovery SLO on post-failure throughput.
                tput = self._window_tput_locked()
                if self._pre_failure_tput is None and tput > 0:
                    self._pre_failure_tput = tput
            # A departed host's step-time EWMA must not skew the
            # straggler median (nor linger in the fleet gauge).
            if self._host_step_ewma.pop(node_id, None) is not None:
                self._host_step_samples.pop(node_id, None)
                self._known_stragglers.discard(node_id)
                try:
                    _HOST_STEP_EWMA.remove(node=str(node_id))
                except ValueError:
                    pass
                if self.timeseries is not None:
                    self.timeseries.drop_series(
                        "host.step_ewma", node=str(node_id)
                    )
            self._node_last_report.pop(node_id, None)

    def recovery_seconds(
        self, ratio: Optional[float] = None
    ) -> Optional[float]:
        """Seconds from the last failure until the throughput window
        first regained ``ratio`` (default: the constructor's
        ``recovery_ratio``) of the pre-failure throughput, or None if
        not yet recovered / no failure observed.

        The crossing is timestamped when the crossing SAMPLE arrives
        (collect_global_step) and only post-failure samples vouch for
        it, so polling late no longer overstates the recovery time and
        a window still dominated by pre-failure samples cannot claim
        an instant recovery. When no sample has arrived since the
        failure at all, the legacy full-window check answers (a
        throughput that never dropped recovers in ~0s) without caching
        a crossing.
        """
        with self._lock:
            pre = self._pre_failure_tput
            fail_t = self._last_failure_time
            crossed = self._recovery_crossed_at
            if pre is None or fail_t is None:
                return None
            use_ratio = (
                self._recovery_ratio if ratio is None else ratio
            )
            if crossed is not None and use_ratio == self._recovery_ratio:
                return max(crossed - fail_t, 0.0)
            if any(s[0] >= fail_t for s in self._samples):
                # Post-failure traffic exists: only it may vouch for
                # the recovery (None until >= 2 post-failure samples).
                post_tput = self._post_failure_tput_locked(fail_t)
                if (
                    post_tput is not None
                    and post_tput >= use_ratio * pre
                ):
                    last_ts = self._samples[-1][0]
                    if use_ratio == self._recovery_ratio:
                        self._recovery_crossed_at = max(last_ts, fail_t)
                    return max(last_ts - fail_t, 0.0)
                return None
            # No sample since the failure at all: the legacy
            # full-window answer (a throughput that never dropped
            # recovers in ~0s), deliberately not cached.
            if self._window_tput_locked() >= use_ratio * pre:
                last_ts = (
                    self._samples[-1][0] if self._samples else fail_t
                )
                return max(last_ts - fail_t, 0.0)
        return None

    # -- warm-restart snapshot ----------------------------------------------

    def to_snapshot(self) -> dict:
        """Progress facts worth surviving a master restart: the
        global step/token high-water marks and per-node steps. Window
        samples and EWMAs are deliberately dropped — throughput and
        straggler scores re-warm from live traffic in seconds, and
        stale samples would claim a throughput the restarted fleet
        has not demonstrated."""
        with self._lock:
            return {
                "global_step": self._global_step,
                "global_tokens": self._global_tokens,
                "node_steps": {
                    str(k): v for k, v in self._node_steps.items()
                },
                "alive_nodes": sorted(self._alive_nodes),
            }

    def restore_snapshot(self, state: dict) -> None:
        with self._lock:
            self._global_step = int(state.get("global_step", 0))
            self._global_tokens = int(state.get("global_tokens", 0))
            self._node_steps = {
                int(k): int(v)
                for k, v in state.get("node_steps", {}).items()
            }
            self._alive_nodes = {
                int(n) for n in state.get("alive_nodes", [])
            }

    def reset_failure_tracking(self) -> None:
        with self._lock:
            self._pre_failure_tput = None
            self._last_failure_time = None
            self._recovery_crossed_at = None

    def all_nodes_caught_up(self) -> bool:
        """True when every alive node reported the current global step."""
        with self._lock:
            if not self._alive_nodes:
                return False
            return all(
                self._node_steps.get(n, -1) >= self._global_step
                for n in self._alive_nodes
            )

    # -- straggler scoring ---------------------------------------------------

    def observe_host_step_time(
        self, node_id: int, step_time: float
    ) -> None:
        """Fold one per-step wall time into the host's EWMA."""
        if node_id < 0 or step_time <= 0:
            return
        with self._lock:
            prev = self._host_step_ewma.get(node_id)
            if prev is None:
                ewma = float(step_time)
            else:
                a = self._ewma_alpha
                ewma = a * float(step_time) + (1.0 - a) * prev
            self._host_step_ewma[node_id] = ewma
            self._host_step_samples[node_id] = (
                self._host_step_samples.get(node_id, 0) + 1
            )
        _HOST_STEP_EWMA.set(ewma, node=str(node_id))
        if self.timeseries is not None:
            self.timeseries.record(
                "host.step_ewma", ewma, node=str(node_id)
            )
        self._refresh_stragglers()

    def host_step_ewma(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._host_step_ewma)

    def straggler_scores(self) -> Dict[int, float]:
        """Per-host EWMA / fleet-median ratio, for hosts with enough
        samples. Empty below the minimum host count — relative
        slowness is meaningless for a fleet of one (or two, where the
        median IS one of the two hosts)."""
        with self._lock:
            scored = {
                n: e
                for n, e in self._host_step_ewma.items()
                if self._host_step_samples.get(n, 0)
                >= self._min_straggler_samples
            }
            if len(scored) < self._min_straggler_hosts:
                return {}
            fleet_median = median(scored.values())
            if fleet_median <= 0:
                return {}
            return {n: e / fleet_median for n, e in scored.items()}

    def stragglers(self) -> List[int]:
        """Node ids currently scored slower than ``straggler_ratio`` x
        the fleet median."""
        return sorted(
            n
            for n, score in self.straggler_scores().items()
            if score > self.straggler_ratio
        )

    def _refresh_stragglers(self) -> None:
        """Re-score and emit events/counters on transitions."""
        scores = self.straggler_scores()
        current = {
            n for n, s in scores.items() if s > self.straggler_ratio
        }
        with self._lock:
            fresh = current - self._known_stragglers
            recovered = self._known_stragglers - current
            self._known_stragglers = current
        for node_id in sorted(fresh):
            _STRAGGLERS_TOTAL.inc(node=str(node_id))
            obs.event(
                "node.straggler",
                node_id=node_id,
                score=round(scores[node_id], 3),
                ratio=self.straggler_ratio,
                ewma_s=round(
                    self._host_step_ewma.get(node_id, 0.0), 6
                ),
            )
            if self.on_straggler is not None:
                try:
                    self.on_straggler(node_id)
                except Exception:  # noqa: BLE001
                    pass
        for node_id in sorted(recovered):
            obs.event(
                "node.straggler_recovered",
                node_id=node_id,
                score=round(scores.get(node_id, 0.0), 3),
            )
