"""Fleet health plane: detectors over time-series history -> verdicts.

This is the interpretation layer between "we export metrics" and "the
control plane acts on them" (ROADMAP items 1 and 2): a master-side
:class:`HealthMonitor` periodically evaluates a set of detectors over
the :class:`~dlrover_tpu_torch.obs.timeseries.TimeSeriesStore` the
measurement plane feeds (fleet snapshots, goodput recomputes, speed
EWMAs, compile counters) and turns history into typed
:class:`HealthVerdict` s:

========================  =====================================================
detector                  fires when
========================  =====================================================
throughput_degradation    a host's recent step-time window is materially
                          slower than its own preceding baseline window
                          AND the robust slope confirms a worsening trend
goodput_slo               the job's goodput ratio sits below the SLO
                          (after a startup grace period)
data_starvation           a host spends more than a threshold fraction of
                          wall time blocked on input (data_wait rate)
recompile_storm           a host's compile counter is climbing at storm
                          rate (retracing in the steady state)
rss_growth                a host's RSS shows a sustained robust upward
                          slope plus material relative growth (leak)
straggler_persistence     the speed monitor has scored the same host a
                          straggler for N consecutive evaluations
heartbeat_gap             an alive node's last heartbeat is a large
                          fraction of the way to the timeout
replica_unhealthy         a serving replica holds dispatched requests
                          without progress past the router's timeout
                          (or is draining and never came back) — the
                          verdict the remediation ladder drains,
                          restarts, then replaces on
slo_burn                  a tenant SLO's error budget burns past the
                          fast (5m AND 1h, critical) or slow (6h AND
                          3d, warn) multi-window burn-rate threshold
========================  =====================================================

Each verdict carries a severity (``info``/``warn``/``critical``), the
evidence window of series samples that convicted it, and a suggested
:class:`~dlrover_tpu_torch.common.constants.EventAction`. Critical verdicts
with an action auto-queue it through the servicer's per-node action
FIFO (cooldown-limited), so a degrading host gets a PROFILE capture
*while it is still slow*. All verdicts land in a bounded history
served by the ``HealthQueryRequest`` RPC, are exported as
``dlrover_health_verdicts_total{detector,severity}`` plus the
composite ``dlrover_job_health_score`` gauge, and are persisted to
the brain datastore so the policy engine (ROADMAP item 2) consumes
the same channel.

On top of the detector suite sits the **SLO budget engine**
(ROADMAP item 5's accountability half): declarative per-tenant
:class:`SLOSpec` objectives (training goodput >= X, serving
TTFT/TPOT p99 <= Y) tracked as error budgets over the time-series
store, with Google-SRE-style multi-window burn-rate detection — the
fast pair (5m AND 1h) at >= 14.4x budget burn fires a ``critical``
``slo_burn`` verdict (page), the slow pair (6h AND 3d) at >= 1x
fires ``warn`` (ticket). Budget remaining over each SLO's period is
exported as ``dlrover_slo_budget_remaining{tenant,slo}`` every
evaluation, and :meth:`HealthMonitor.slo_snapshot` feeds the
``CapacityQueryRequest`` RPC / ``obs_report --capacity``.

Every threshold reads ``DLROVER_TPU_HEALTH_<KNOB>`` (see DEFAULTS),
overridable per-instance via the ``config`` dict; the clock is
injectable so detector tests drive simulated hours hermetically.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import EventAction
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs.timeseries import TimeSeriesStore

logger = get_logger("obs.health")

HEALTH_ENV_PREFIX = "DLROVER_TPU_HEALTH_"

SEVERITY_INFO = "info"
SEVERITY_WARN = "warn"
SEVERITY_CRITICAL = "critical"
SEVERITIES = (SEVERITY_INFO, SEVERITY_WARN, SEVERITY_CRITICAL)

# Composite-score penalty per ACTIVE verdict of each severity;
# score = max(0, 1 - sum(penalties)).
SEVERITY_PENALTY = {
    SEVERITY_INFO: 0.0,
    SEVERITY_WARN: 0.1,
    SEVERITY_CRITICAL: 0.3,
}

# How many evidence samples ride a verdict (the tail of the window).
EVIDENCE_POINTS = 32

_VERDICTS_TOTAL = obs.counter(
    "dlrover_health_verdicts_total",
    "Health verdicts emitted by the master's detector engine, "
    "by detector and severity",
    ("detector", "severity"),
)
_HEALTH_SCORE = obs.gauge(
    "dlrover_job_health_score",
    "Composite job health in [0, 1]: 1 minus severity-weighted "
    "penalties of the currently-active health verdicts",
)
_SLO_BUDGET_REMAINING = obs.gauge(
    "dlrover_slo_budget_remaining",
    "Fraction of each tenant SLO's error budget left over its "
    "period (1 = untouched, 0 = exhausted)",
    ("tenant", "slo"),
)

# Every knob a detector reads, with its default. Override per knob via
# DLROVER_TPU_HEALTH_<NAME-upper> or the HealthMonitor(config=) dict
# (config wins). Windows are seconds.
DEFAULTS: Dict[str, float] = {
    # engine
    "interval_s": 15.0,
    "window_s": 120.0,
    "min_points": 3.0,
    "action_cooldown_s": 300.0,
    "history": 256.0,
    # throughput degradation (per-host step time, recent vs baseline)
    "degradation_warn_ratio": 1.3,
    "degradation_crit_ratio": 1.8,
    # goodput SLO
    "goodput_slo": 0.75,
    "goodput_critical": 0.4,
    "goodput_grace_s": 300.0,
    # data starvation (fraction of wall time blocked on input)
    "starvation_warn_frac": 0.25,
    "starvation_crit_frac": 0.5,
    # recompile storm (compiles per minute in the steady state)
    "recompile_warn_per_min": 2.0,
    "recompile_crit_per_min": 6.0,
    # RSS growth (robust MB/s slope + relative growth over the window)
    "rss_warn_mb_per_s": 0.5,
    "rss_crit_mb_per_s": 4.0,
    "rss_min_growth_frac": 0.05,
    # straggler persistence (consecutive evaluations scored slow)
    "straggler_warn_ticks": 3.0,
    "straggler_crit_ticks": 6.0,
    # heartbeat gap (fraction of the heartbeat timeout)
    "heartbeat_warn_frac": 0.5,
    "heartbeat_crit_frac": 0.8,
    # replica_unhealthy: staleness as a multiple of the serving
    # router's progress timeout that escalates warn -> critical
    "replica_stall_crit_ratio": 2.0,
    # SLO burn-rate windows + thresholds (Google SRE multi-window
    # multi-burn-rate): the fast pair pages, the slow pair tickets.
    # 14.4x on a 30d budget spends ~2% of it in one hour.
    "slo_fast_burn": 14.4,
    "slo_slow_burn": 1.0,
    "slo_fast_short_s": 300.0,       # 5m
    "slo_fast_long_s": 3600.0,       # 1h
    "slo_slow_short_s": 21600.0,     # 6h
    "slo_slow_long_s": 259200.0,     # 3d
}


@dataclasses.dataclass
class SLOSpec:
    """One declarative per-tenant service-level objective.

    ``direction`` says which side of ``objective`` is good:
    ``"min"`` — the series must stay AT OR ABOVE the objective
    (training goodput >= 0.8); ``"max"`` — it must stay at or below
    (serving TTFT p99 <= 0.5s). ``budget`` is the allowed bad-sample
    fraction over ``period_s``; burn rate is bad_fraction / budget.
    ``labels`` scope the series query (e.g. ``{"tenant": "a"}``).
    """

    tenant: str
    slo: str
    series: str
    objective: float
    direction: str = "min"
    budget: float = 0.05
    period_s: float = 3.0 * 86400.0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def key(self) -> str:
        return f"{self.tenant}/{self.slo}"

    def to_dict(self) -> dict:
        return {
            "tenant": self.tenant,
            "slo": self.slo,
            "series": self.series,
            "objective": self.objective,
            "direction": self.direction,
            "budget": self.budget,
            "period_s": self.period_s,
            "labels": dict(self.labels),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        return cls(
            tenant=str(d.get("tenant", "default")),
            slo=str(d.get("slo", "slo")),
            series=str(d.get("series", "")),
            objective=float(d.get("objective", 0.0)),
            direction=str(d.get("direction", "min")),
            budget=float(d.get("budget", 0.05)),
            period_s=float(d.get("period_s", 3.0 * 86400.0)),
            labels={
                str(k): str(v)
                for k, v in (d.get("labels") or {}).items()
            },
        )


def slos_from_env() -> List["SLOSpec"]:
    """Parse ``DLROVER_TPU_HEALTH_SLOS`` (a JSON list of SLOSpec
    dicts) — the deploy-time way to declare objectives without code.
    Bad JSON degrades to no SLOs, never to a crash."""
    raw = os.getenv(HEALTH_ENV_PREFIX + "SLOS", "")
    if not raw:
        return []
    try:
        data = json.loads(raw)
        return [SLOSpec.from_dict(d) for d in data]
    except Exception:  # noqa: BLE001
        logger.warning(
            "bad %sSLOS JSON %r; ignoring", HEALTH_ENV_PREFIX, raw
        )
        return []


@dataclasses.dataclass
class HealthVerdict:
    """One detector's finding about one subject (a host or the job)."""

    detector: str
    severity: str
    message: str
    node_id: int = -1
    host: str = ""
    suggested_action: str = ""  # an EventAction value, or ""
    evidence_series: str = ""
    # The convicting samples: (ts, value) tail of the query window.
    evidence: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list
    )
    # Detector-specific numbers (baseline mean, recent mean, ratio,
    # slope, ...), for renderers and the policy engine.
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    timestamp: float = 0.0
    resolved: bool = False

    def key(self) -> Tuple[str, str, int]:
        return (self.detector, self.host, self.node_id)

    def to_dict(self) -> dict:
        return {
            "detector": self.detector,
            "severity": self.severity,
            "message": self.message,
            "node_id": self.node_id,
            "host": self.host,
            "suggested_action": self.suggested_action,
            "evidence_series": self.evidence_series,
            "evidence": [
                [round(ts, 3), round(v, 6)] for ts, v in self.evidence
            ],
            "metrics": {
                k: round(float(v), 6) for k, v in self.metrics.items()
            },
            "timestamp": round(self.timestamp, 3),
            "resolved": self.resolved,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HealthVerdict":
        """Inverse of :meth:`to_dict` — warm-restart snapshots and
        tools rebuild verdicts from the JSON shape."""
        return cls(
            detector=str(d.get("detector", "")),
            severity=str(d.get("severity", SEVERITY_INFO)),
            message=str(d.get("message", "")),
            node_id=int(d.get("node_id", -1)),
            host=str(d.get("host", "")),
            suggested_action=str(d.get("suggested_action", "")),
            evidence_series=str(d.get("evidence_series", "")),
            evidence=[
                (float(p[0]), float(p[1]))
                for p in d.get("evidence", [])
                if isinstance(p, (list, tuple)) and len(p) == 2
            ],
            metrics={
                str(k): float(v)
                for k, v in (d.get("metrics") or {}).items()
            },
            timestamp=float(d.get("timestamp", 0.0)),
            resolved=bool(d.get("resolved", False)),
        )


def _verdict_sort_key(v: HealthVerdict):
    return (-SEVERITIES.index(v.severity), v.detector, v.host, v.node_id)


class HealthMonitor:
    """Evaluates the detector suite on a cadence and owns the verdict
    lifecycle (transitions, history, score, action queueing, brain
    persistence).

    Everything is injectable so the engine is hermetically testable:
    ``clock`` drives windows, ``action_sink(node_id, action)`` receives
    auto-queued actions (the JobMaster wires ``servicer.push_action``),
    ``brain`` is any object with the BrainService persistence surface,
    and ``heartbeat_ages`` overrides the job-manager probe.
    """

    def __init__(
        self,
        store: TimeSeriesStore,
        speed_monitor=None,
        job_manager=None,
        fleet=None,
        goodput=None,
        action_sink: Optional[Callable[[int, str], None]] = None,
        serving=None,
        brain=None,
        job_name: str = "default",
        heartbeat_timeout: float = 180.0,
        heartbeat_ages: Optional[Callable[[], Dict[int, float]]] = None,
        clock: Callable[[], float] = time.time,
        config: Optional[Dict[str, float]] = None,
        interval: Optional[float] = None,
        slos: Optional[List[SLOSpec]] = None,
    ):
        self.store = store
        self.speed_monitor = speed_monitor
        self.job_manager = job_manager
        self.fleet = fleet
        self.goodput = goodput
        self.action_sink = action_sink
        # Serving router (or any provider of ``unhealthy_replicas()``
        # facts) — the replica_unhealthy detector's feed; None on
        # training-only masters.
        self.serving = serving
        self.brain = brain
        self.job_name = job_name
        self.heartbeat_timeout = heartbeat_timeout
        self._heartbeat_ages = heartbeat_ages
        self.clock = clock
        self.slos: List[SLOSpec] = (
            list(slos) if slos is not None else slos_from_env()
        )
        # spec.key() -> last computed budget/burn numbers, refreshed
        # every evaluation tick (read by slo_snapshot()).
        self._slo_last: Dict[str, dict] = {}
        self._config = dict(config or {})
        self.interval = (
            interval
            if interval is not None
            else self._cfg("interval_s")
        )
        self._lock = threading.Lock()
        self._active: Dict[Tuple[str, str, int], HealthVerdict] = {}
        self._history: deque = deque(maxlen=int(self._cfg("history")))
        self._last_action: Dict[Tuple[str, str, int], float] = {}
        self._straggler_ticks: Dict[int, int] = {}
        self._evaluations = 0
        # Per-tick caches populated by evaluate_once (None outside a
        # tick, so directly-invoked detectors still compute live).
        self._tick_hosts: Optional[List[str]] = None
        self._tick_nodes: Optional[Dict[str, int]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Fired after verdict transitions (new/severity-change/
        # resolution) so the master's state journal can snapshot the
        # active set + cooldown stamps — a warm restart must not
        # re-fire a sticky verdict's action.
        self.on_state_change = None
        # Stall correlator (obs/stall.py), attached via attach_stall:
        # runs as a detector on this tick and feeds the
        # heartbeat_gap DIAGNOSE upgrade its silent-suspect set.
        self.stall = None
        self.detectors: List[Callable[[], List[HealthVerdict]]] = [
            self._detect_throughput_degradation,
            self._detect_goodput_slo,
            self._detect_data_starvation,
            self._detect_recompile_storm,
            self._detect_rss_growth,
            self._detect_straggler_persistence,
            self._detect_heartbeat_gap,
            self._detect_replica_unhealthy,
            self._detect_slo_burn,
        ]
        _HEALTH_SCORE.set(1.0)

    def attach_stall(self, correlator) -> None:
        """Plug a stall correlator (obs/stall.py) into the tick: its
        evaluate() joins the detector list — so collective_stall /
        fleet_stall verdicts get the engine's full transition
        lifecycle, action cooldowns, and persistence — and it gains
        the silent-node probe (heartbeat ages already past the
        critical fraction) that backs fleet-stall attribution."""
        self.stall = correlator

        def _silent_nodes():
            crit = (
                self._cfg("heartbeat_crit_frac")
                * max(self.heartbeat_timeout, 1e-9)
            )
            return {
                node_id: age
                for node_id, age in self.heartbeat_ages().items()
                if age >= crit
            }

        if getattr(correlator, "silent_probe", None) is None:
            correlator.silent_probe = _silent_nodes
        self.detectors.append(correlator.evaluate)

    # -- config -----------------------------------------------------------

    def _cfg(self, knob: str) -> float:
        if knob in self._config:
            return float(self._config[knob])
        env = os.getenv(HEALTH_ENV_PREFIX + knob.upper(), "")
        if env:
            try:
                return float(env)
            except ValueError:
                logger.warning(
                    "bad %s%s=%r; using default %s",
                    HEALTH_ENV_PREFIX, knob.upper(), env,
                    DEFAULTS[knob],
                )
        return DEFAULTS[knob]

    # -- engine lifecycle --------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="health-monitor", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — a detector bug must
                # not kill the monitor thread (and with it all future
                # verdicts)
                logger.warning("health evaluation failed", exc_info=True)

    # -- helpers -----------------------------------------------------------

    def _hosts(self) -> List[str]:
        """Hosts with a step-time series (the subjects of per-host
        detectors). Served from the per-tick cache when
        :meth:`evaluate_once` populated one — five detectors plus the
        brain persist would otherwise each rescan the full series
        table under the store lock every tick."""
        if self._tick_hosts is not None:
            return self._tick_hosts
        return self._scan_hosts()

    def _scan_hosts(self) -> List[str]:
        hosts = {
            ls.get("host", "")
            for ls in self.store.series_labels("host.step_time")
        } | {
            ls.get("host", "")
            for ls in self.store.series_labels("host.memory_mb")
        }
        return sorted(hosts - {""})

    def _node_for_host(self, host: str) -> int:
        if self._tick_nodes is not None:
            return self._tick_nodes.get(host, -1)
        if self.fleet is not None:
            node = self.fleet.node_for_host(host)
            if node is not None:
                return node
        return -1

    def _evidence(
        self, name: str, window_s: float, **labels: str
    ) -> List[Tuple[float, float]]:
        pts = self.store.points(name, window_s, **labels)
        return pts[-EVIDENCE_POINTS:]

    # -- detectors ---------------------------------------------------------

    def _detect_throughput_degradation(self) -> List[HealthVerdict]:
        """Recent step-time window vs the host's own preceding
        baseline window, confirmed by the robust slope — a host that
        *became* slow, as opposed to one that always was."""
        w = self._cfg("window_s")
        min_pts = int(self._cfg("min_points"))
        warn_r = self._cfg("degradation_warn_ratio")
        crit_r = self._cfg("degradation_crit_ratio")
        out: List[HealthVerdict] = []
        for host in self._hosts():
            recent = self.store.query(
                "host.step_time", w, host=host
            )
            baseline = self.store.query(
                "host.step_time", w, end_offset_s=w, host=host
            )
            if (
                recent is None
                or baseline is None
                or recent.count < min_pts
                or baseline.count < min_pts
                or baseline.mean <= 0
            ):
                continue
            ratio = recent.mean / baseline.mean
            slope = self.store.slope(
                "host.step_time", 2 * w, host=host
            )
            if ratio < warn_r or not slope or slope <= 0:
                continue
            severity = (
                SEVERITY_CRITICAL if ratio >= crit_r else SEVERITY_WARN
            )
            out.append(
                HealthVerdict(
                    detector="throughput_degradation",
                    severity=severity,
                    message=(
                        f"host {host} step time {ratio:.2f}x its own "
                        f"baseline ({baseline.mean:.3f}s -> "
                        f"{recent.mean:.3f}s over {w:.0f}s, slope "
                        f"+{slope:.5f}s/s)"
                    ),
                    host=host,
                    node_id=self._node_for_host(host),
                    suggested_action=EventAction.PROFILE.value,
                    evidence_series=f'host.step_time{{host="{host}"}}',
                    evidence=self._evidence(
                        "host.step_time", 2 * w, host=host
                    ),
                    metrics={
                        "baseline_mean_s": baseline.mean,
                        "recent_mean_s": recent.mean,
                        "ratio": ratio,
                        "slope_s_per_s": slope,
                    },
                    timestamp=self.clock(),
                )
            )
        return out

    def _detect_goodput_slo(self) -> List[HealthVerdict]:
        slo = self._cfg("goodput_slo")
        crit = self._cfg("goodput_critical")
        grace = self._cfg("goodput_grace_s")
        first = self.store.first_ts("goodput.ratio")
        if first is None or self.clock() - first < grace:
            return []
        w = self._cfg("window_s")
        stats = self.store.query("goodput.ratio", w)
        if stats is None or stats.count < int(self._cfg("min_points")):
            return []
        if stats.mean >= slo:
            return []
        severity = SEVERITY_CRITICAL if stats.mean < crit else SEVERITY_WARN
        return [
            HealthVerdict(
                detector="goodput_slo",
                severity=severity,
                message=(
                    f"goodput ratio {stats.mean:.2f} below SLO "
                    f"{slo:.2f} over the last {w:.0f}s"
                ),
                suggested_action="",
                evidence_series="goodput.ratio",
                evidence=self._evidence("goodput.ratio", w),
                metrics={"ratio": stats.mean, "slo": slo},
                timestamp=self.clock(),
            )
        ]

    def _detect_data_starvation(self) -> List[HealthVerdict]:
        """Fraction of wall time a host's train loop spent blocked on
        input, from the rate of the cumulative data-wait counter."""
        w = self._cfg("window_s")
        warn_f = self._cfg("starvation_warn_frac")
        crit_f = self._cfg("starvation_crit_frac")
        out: List[HealthVerdict] = []
        for host in self._hosts():
            frac = self.store.rate("host.data_wait_s", w, host=host)
            if frac is None or frac < warn_f:
                continue
            severity = (
                SEVERITY_CRITICAL if frac >= crit_f else SEVERITY_WARN
            )
            out.append(
                HealthVerdict(
                    detector="data_starvation",
                    severity=severity,
                    message=(
                        f"host {host} blocked on input "
                        f"{100.0 * frac:.0f}% of wall time over the "
                        f"last {w:.0f}s"
                    ),
                    host=host,
                    node_id=self._node_for_host(host),
                    suggested_action=EventAction.PROFILE.value,
                    evidence_series=(
                        f'host.data_wait_s{{host="{host}"}}'
                    ),
                    evidence=self._evidence(
                        "host.data_wait_s", w, host=host
                    ),
                    metrics={"data_wait_frac": frac},
                    timestamp=self.clock(),
                )
            )
        return out

    def _detect_recompile_storm(self) -> List[HealthVerdict]:
        w = self._cfg("window_s")
        warn_pm = self._cfg("recompile_warn_per_min")
        crit_pm = self._cfg("recompile_crit_per_min")
        out: List[HealthVerdict] = []
        for host in self._hosts():
            rate = self.store.rate("host.compiles", w, host=host)
            if rate is None:
                continue
            per_min = rate * 60.0
            if per_min < warn_pm:
                continue
            severity = (
                SEVERITY_CRITICAL
                if per_min >= crit_pm
                else SEVERITY_WARN
            )
            out.append(
                HealthVerdict(
                    detector="recompile_storm",
                    severity=severity,
                    message=(
                        f"host {host} recompiling at "
                        f"{per_min:.1f}/min over the last {w:.0f}s "
                        "(steady state should be ~0)"
                    ),
                    host=host,
                    node_id=self._node_for_host(host),
                    suggested_action=EventAction.PROFILE.value,
                    evidence_series=f'host.compiles{{host="{host}"}}',
                    evidence=self._evidence(
                        "host.compiles", w, host=host
                    ),
                    metrics={"compiles_per_min": per_min},
                    timestamp=self.clock(),
                )
            )
        return out

    def _detect_rss_growth(self) -> List[HealthVerdict]:
        """Sustained robust RSS slope + material relative growth —
        the leak signature, filtered against benign one-off jumps by
        the Theil–Sen estimator."""
        w = 2 * self._cfg("window_s")
        warn_s = self._cfg("rss_warn_mb_per_s")
        crit_s = self._cfg("rss_crit_mb_per_s")
        min_frac = self._cfg("rss_min_growth_frac")
        min_pts = int(self._cfg("min_points"))
        out: List[HealthVerdict] = []
        for host in self._hosts():
            stats = self.store.query("host.memory_mb", w, host=host)
            if stats is None or stats.count < 2 * min_pts:
                continue
            slope = self.store.slope("host.memory_mb", w, host=host)
            if slope is None or slope < warn_s or stats.first <= 0:
                continue
            growth = (stats.last - stats.first) / stats.first
            if growth < min_frac:
                continue
            severity = (
                SEVERITY_CRITICAL if slope >= crit_s else SEVERITY_WARN
            )
            out.append(
                HealthVerdict(
                    detector="rss_growth",
                    severity=severity,
                    message=(
                        f"host {host} RSS climbing "
                        f"{slope:.2f} MB/s "
                        f"({stats.first:.0f} -> {stats.last:.0f} MB, "
                        f"+{100.0 * growth:.0f}% over {w:.0f}s)"
                    ),
                    host=host,
                    node_id=self._node_for_host(host),
                    suggested_action=EventAction.DIAGNOSE.value,
                    evidence_series=(
                        f'host.memory_mb{{host="{host}"}}'
                    ),
                    evidence=self._evidence(
                        "host.memory_mb", w, host=host
                    ),
                    metrics={
                        "slope_mb_per_s": slope,
                        "growth_frac": growth,
                    },
                    timestamp=self.clock(),
                )
            )
        return out

    def _detect_straggler_persistence(self) -> List[HealthVerdict]:
        """A straggler verdict that REFUSES to go away: the speed
        monitor scores instantaneous relative slowness; this detector
        adds the time dimension (N consecutive evaluations)."""
        if self.speed_monitor is None:
            return []
        warn_t = int(self._cfg("straggler_warn_ticks"))
        crit_t = int(self._cfg("straggler_crit_ticks"))
        try:
            scores = self.speed_monitor.straggler_scores()
            slow = set(self.speed_monitor.stragglers())
        except Exception:  # noqa: BLE001 — scoring must not kill
            # the evaluation tick
            return []
        for node_id in list(self._straggler_ticks):
            if node_id not in slow:
                del self._straggler_ticks[node_id]
        out: List[HealthVerdict] = []
        for node_id in slow:
            ticks = self._straggler_ticks.get(node_id, 0) + 1
            self._straggler_ticks[node_id] = ticks
            if ticks < warn_t:
                continue
            severity = (
                SEVERITY_CRITICAL if ticks >= crit_t else SEVERITY_WARN
            )
            out.append(
                HealthVerdict(
                    detector="straggler_persistence",
                    severity=severity,
                    message=(
                        f"node {node_id} scored a straggler for "
                        f"{ticks} consecutive evaluations "
                        f"(score {scores.get(node_id, 0.0):.2f}x "
                        "fleet median)"
                    ),
                    node_id=node_id,
                    suggested_action=EventAction.PROFILE.value,
                    evidence_series=(
                        f'host.step_ewma{{node="{node_id}"}}'
                    ),
                    evidence=self._evidence(
                        "host.step_ewma",
                        2 * self._cfg("window_s"),
                        node=str(node_id),
                    ),
                    metrics={
                        "score": scores.get(node_id, 0.0),
                        "ticks": float(ticks),
                    },
                    timestamp=self.clock(),
                )
            )
        return out

    def heartbeat_ages(self) -> Dict[int, float]:
        if self._heartbeat_ages is not None:
            return self._heartbeat_ages()
        if self.job_manager is None:
            return {}
        # Node heartbeat stamps are process-local monotonic (see the
        # PR-5 clock sweep), so the age probe must be too — the
        # engine's injectable wall clock only drives series windows.
        now = time.monotonic()
        ages: Dict[int, float] = {}
        for node in self.job_manager.alive_nodes():
            hb = getattr(node, "heartbeat_time", 0.0) or 0.0
            if hb > 0:
                ages[node.id] = max(now - hb, 0.0)
        return ages

    def _detect_heartbeat_gap(self) -> List[HealthVerdict]:
        """An alive node most of the way to its heartbeat timeout:
        the early warning BEFORE the watchdog declares it dead.
        Normally no suggested action — a node that is not
        heartbeating cannot be handed one — EXCEPT when the stall
        correlator attributes a live fleet-wide stall to this silent
        node: then the critical verdict carries DIAGNOSE, parked in
        the node's FIFO so the capture fires the moment the agent
        reconnects (cooldown-shared with every other action on this
        subject via the engine's stamps)."""
        warn_f = self._cfg("heartbeat_warn_frac")
        crit_f = self._cfg("heartbeat_crit_frac")
        timeout = max(self.heartbeat_timeout, 1e-9)
        suspects = (
            getattr(self.stall, "silent_suspects", None) or ()
            if self.stall is not None
            else ()
        )
        out: List[HealthVerdict] = []
        for node_id, age in sorted(self.heartbeat_ages().items()):
            frac = age / timeout
            if frac < warn_f:
                continue
            severity = (
                SEVERITY_CRITICAL if frac >= crit_f else SEVERITY_WARN
            )
            message = (
                f"node {node_id} last heartbeat {age:.0f}s "
                f"ago ({100.0 * frac:.0f}% of the "
                f"{timeout:.0f}s timeout)"
            )
            suggested = ""
            if severity == SEVERITY_CRITICAL and node_id in suspects:
                suggested = EventAction.DIAGNOSE.value
                message += (
                    "; fleet stall attributed to this silent node"
                )
            out.append(
                HealthVerdict(
                    detector="heartbeat_gap",
                    severity=severity,
                    message=message,
                    node_id=node_id,
                    suggested_action=suggested,
                    evidence_series="heartbeat_age_s",
                    evidence=[(self.clock(), age)],
                    metrics={"age_s": age, "timeout_frac": frac},
                    timestamp=self.clock(),
                )
            )
        return out

    def _detect_replica_unhealthy(self) -> List[HealthVerdict]:
        """A serving replica that is demonstrably not serving: READY
        with dispatched requests and no progress past the router's
        ``progress_timeout_s``, or DRAINING and never re-registered.
        No suggested heartbeat action — the remediation engine owns
        the response ladder (drain -> restart -> replace), keyed on
        this detector."""
        if self.serving is None:
            return []
        try:
            facts = self.serving.unhealthy_replicas()
        except Exception:  # noqa: BLE001 — a router bug must not
            # kill the evaluation tick
            logger.warning(
                "serving unhealthy_replicas probe failed",
                exc_info=True,
            )
            return []
        crit_ratio = self._cfg("replica_stall_crit_ratio")
        out: List[HealthVerdict] = []
        for f in facts:
            stale = float(f.get("stale_s", 0.0))
            timeout = max(float(f.get("timeout_s", 1.0)), 1e-9)
            severity = (
                SEVERITY_CRITICAL
                if stale >= crit_ratio * timeout
                or f.get("state") == "draining"
                else SEVERITY_WARN
            )
            role = str(f.get("role", "mixed"))
            out.append(
                HealthVerdict(
                    detector="replica_unhealthy",
                    severity=severity,
                    message=(
                        f"serving replica {f.get('replica_id')} "
                        f"({role}, {f.get('state')}) holds "
                        f"{f.get('dispatched', 0)} request(s) with "
                        f"no progress for {stale:.1f}s "
                        f"(timeout {timeout:.1f}s)"
                    ),
                    node_id=int(f.get("replica_id", -1)),
                    host=str(f.get("addr", "")),
                    suggested_action="",
                    evidence_series="serving.replica_progress_age_s",
                    evidence=[(self.clock(), stale)],
                    metrics={
                        "stale_s": stale,
                        "timeout_s": timeout,
                        "dispatched": float(
                            f.get("dispatched", 0)
                        ),
                    },
                    timestamp=self.clock(),
                )
            )
        return out

    def _slo_bad_frac(
        self, spec: SLOSpec, window_s: float
    ) -> Tuple[float, int]:
        """(bad-sample fraction, sample count) of the SLO's series
        over the trailing window. No samples = no burn — an idle
        tenant must not page."""
        pts = self.store.points(
            spec.series, window_s, **spec.labels
        )
        if not pts:
            return 0.0, 0
        if spec.direction == "max":
            bad = sum(1 for _, v in pts if v > spec.objective)
        else:
            bad = sum(1 for _, v in pts if v < spec.objective)
        return bad / len(pts), len(pts)

    def _detect_slo_burn(self) -> List[HealthVerdict]:
        """Multi-window multi-burn-rate error-budget detector (the
        Google SRE workbook shape): a pair fires only when BOTH its
        short and long windows burn past the threshold — the short
        window for fast resolution, the long one so a blip cannot
        page. The fast pair (5m/1h, 14.4x) is critical, the slow
        pair (6h/3d, 1x) is warn; each pair is its own verdict
        subject so a drill can watch fast fire critical while slow
        stays warn."""
        if not self.slos:
            return []
        pairs = (
            (
                "fast",
                self._cfg("slo_fast_short_s"),
                self._cfg("slo_fast_long_s"),
                self._cfg("slo_fast_burn"),
                SEVERITY_CRITICAL,
            ),
            (
                "slow",
                self._cfg("slo_slow_short_s"),
                self._cfg("slo_slow_long_s"),
                self._cfg("slo_slow_burn"),
                SEVERITY_WARN,
            ),
        )
        now = self.clock()
        out: List[HealthVerdict] = []
        for spec in self.slos:
            budget = max(spec.budget, 1e-9)
            period_bad, period_n = self._slo_bad_frac(
                spec, spec.period_s
            )
            remaining = max(0.0, 1.0 - period_bad / budget)
            _SLO_BUDGET_REMAINING.set(
                remaining, tenant=spec.tenant, slo=spec.slo
            )
            burns: Dict[str, float] = {}
            for name, short_s, long_s, threshold, severity in pairs:
                short_bad, short_n = self._slo_bad_frac(
                    spec, short_s
                )
                long_bad, long_n = self._slo_bad_frac(spec, long_s)
                # Both windows must burn: min() of the two rates.
                burn = min(short_bad, long_bad) / budget
                burns[name] = burn
                if not short_n or not long_n or burn < threshold:
                    continue
                out.append(
                    HealthVerdict(
                        detector="slo_burn",
                        severity=severity,
                        message=(
                            f"tenant {spec.tenant} {spec.slo} "
                            f"burning its error budget at "
                            f"{burn:.1f}x ({name} windows "
                            f"{short_s:.0f}s/{long_s:.0f}s, budget "
                            f"{budget:.3f}, "
                            f"{100.0 * remaining:.0f}% remaining)"
                        ),
                        host=f"{spec.key()}/{name}",
                        suggested_action="",
                        evidence_series=spec.series,
                        evidence=self._evidence(
                            spec.series, short_s, **spec.labels
                        ),
                        metrics={
                            "burn": burn,
                            "threshold": threshold,
                            "budget_remaining": remaining,
                            "short_bad_frac": short_bad,
                            "long_bad_frac": long_bad,
                        },
                        timestamp=now,
                    )
                )
            self._slo_last[spec.key()] = {
                **spec.to_dict(),
                "budget_remaining": remaining,
                "period_bad_frac": period_bad,
                "period_samples": period_n,
                "burn": dict(burns),
                "ts": now,
            }
        return out

    def slo_snapshot(self) -> List[dict]:
        """Per-SLO budget standing for the capacity RPC: the spec,
        budget remaining, last burn rates, and whether a burn verdict
        is currently active (and at what severity)."""
        with self._lock:
            active = dict(self._active)
        out = []
        for spec in self.slos:
            entry = dict(
                self._slo_last.get(
                    spec.key(),
                    {**spec.to_dict(), "budget_remaining": 1.0,
                     "burn": {}},
                )
            )
            severity = ""
            for name in ("fast", "slow"):
                v = active.get(
                    ("slo_burn", f"{spec.key()}/{name}", -1)
                )
                if v is not None and (
                    not severity
                    or SEVERITIES.index(v.severity)
                    > SEVERITIES.index(severity)
                ):
                    severity = v.severity
            entry["severity"] = severity
            entry["burning"] = bool(severity)
            out.append(entry)
        return out

    # -- verdict lifecycle -------------------------------------------------

    def evaluate_once(self) -> List[HealthVerdict]:
        """One evaluation tick: run every detector, reconcile the
        active set (transitions -> history/counters/events/actions/
        brain), refresh the score gauge. Returns the active verdicts,
        most severe first."""
        # Hoist the per-host scans for the whole tick: the host list
        # (two series-table walks under the store lock) and the
        # host->node map (one locked pass over the fleet's table)
        # would otherwise be recomputed by every detector.
        self._tick_hosts = self._scan_hosts()
        # Duck-typed fleets (test fakes) may only offer the per-host
        # node_for_host; without the bulk map the per-call fallback
        # in _node_for_host still works.
        mapper = getattr(self.fleet, "host_node_map", None)
        self._tick_nodes = mapper() if mapper is not None else None
        try:
            return self._evaluate_tick()
        finally:
            self._tick_hosts = None
            self._tick_nodes = None

    def _evaluate_tick(self) -> List[HealthVerdict]:
        fresh: List[HealthVerdict] = []
        for detector in self.detectors:
            try:
                fresh.extend(detector() or [])
            except Exception:  # noqa: BLE001 — one broken detector
                # must not silence the other six
                logger.warning(
                    "health detector %s failed",
                    getattr(detector, "__name__", detector),
                    exc_info=True,
                )
        now = self.clock()
        transitions: List[HealthVerdict] = []
        resolved: List[HealthVerdict] = []
        with self._lock:
            self._evaluations += 1
            previous = self._active
            current: Dict[Tuple[str, str, int], HealthVerdict] = {}
            for v in fresh:
                key = v.key()
                old = previous.get(key)
                current[key] = v
                if old is None or old.severity != v.severity:
                    transitions.append(v)
                    self._history.append(v)
            for key, old in previous.items():
                if key not in current:
                    res = dataclasses.replace(
                        old,
                        severity=SEVERITY_INFO,
                        resolved=True,
                        message=f"resolved: {old.message}",
                        suggested_action="",
                        timestamp=now,
                    )
                    resolved.append(res)
                    self._history.append(res)
            self._active = current
            score = self._score_locked()
        _HEALTH_SCORE.set(score)
        for v in transitions:
            _VERDICTS_TOTAL.inc(detector=v.detector, severity=v.severity)
            obs.event(
                "health.verdict",
                detector=v.detector,
                severity=v.severity,
                host=v.host,
                node_id=v.node_id,
                action=v.suggested_action,
            )
            logger.warning(
                "health verdict [%s] %s: %s",
                v.severity, v.detector, v.message,
            )
        for v in resolved:
            obs.event(
                "health.resolved",
                detector=v.detector,
                host=v.host,
                node_id=v.node_id,
            )
            logger.info("health resolved: %s %s", v.detector, v.host)
        self._queue_actions(transitions, now)
        self._persist(transitions + resolved, score, now)
        if transitions or resolved:
            cb = self.on_state_change
            if cb is not None:
                try:
                    cb()
                except Exception:  # noqa: BLE001
                    pass
        return sorted(
            self._active_list(), key=_verdict_sort_key
        )

    def _queue_actions(
        self, transitions: List[HealthVerdict], now: float
    ) -> None:
        """Critical verdicts with a suggested action auto-queue it on
        the subject node's heartbeat FIFO — at most once per
        ``action_cooldown_s`` per (detector, subject), so a sticky
        verdict cannot flood the agent with captures."""
        if self.action_sink is None:
            return
        cooldown = self._cfg("action_cooldown_s")
        for v in transitions:
            if (
                v.severity != SEVERITY_CRITICAL
                or not v.suggested_action
                or v.node_id < 0
            ):
                continue
            key = v.key()
            last = self.action_stamp(key)
            if last is not None and now - last < cooldown:
                continue
            self.stamp_action(key, now)
            try:
                self.action_sink(v.node_id, v.suggested_action)
                obs.event(
                    "health.action_queued",
                    detector=v.detector,
                    node_id=v.node_id,
                    action=v.suggested_action,
                )
            except Exception:  # noqa: BLE001 — the action channel
                # failing must not fail the evaluation
                logger.warning(
                    "queueing %s for node %d failed",
                    v.suggested_action, v.node_id, exc_info=True,
                )

    def _persist(
        self,
        new_verdicts: List[HealthVerdict],
        score: float,
        now: float,
    ) -> None:
        """Ship this tick's channel to the brain datastore: per-host
        runtime samples, the fleet aggregate + goodput sample, and
        every verdict transition — the history ROADMAP item 2's
        policy engine plans over. Best-effort by contract."""
        if self.brain is None:
            return
        try:
            self._persist_inner(new_verdicts, score, now)
        except Exception:  # noqa: BLE001 — a broken datastore must
            # not take the health plane down
            logger.warning("brain persistence failed", exc_info=True)

    def _persist_inner(
        self,
        new_verdicts: List[HealthVerdict],
        score: float,
        now: float,
    ) -> None:
        from dlrover_tpu_torch.brain.service import RuntimeSample

        persist_sample = getattr(
            self.brain, "persist_runtime_sample", None
        )
        if persist_sample is not None:
            for host in self._hosts():
                cpu = self.store.latest(
                    "host.cpu_percent", host=host
                )
                mem = self.store.latest("host.memory_mb", host=host)
                tps = self.store.latest(
                    "host.tokens_per_s", host=host
                )
                persist_sample(
                    RuntimeSample(
                        job_name=self.job_name,
                        node_type="worker",
                        node_id=self._node_for_host(host),
                        used_cpu=cpu[1] if cpu else 0.0,
                        used_memory_mb=int(mem[1]) if mem else 0,
                        config_cpu=0.0,
                        config_memory_mb=0,
                        speed=tps[1] if tps else 0.0,
                        timestamp=now,
                    )
                )
        persist_fleet = getattr(self.brain, "persist_fleet_sample", None)
        if persist_fleet is not None:
            aggregates = {}
            if self.fleet is not None:
                aggregates = self.fleet.aggregates()
            ratio = self.store.latest("goodput.ratio")
            persist_fleet(
                job_name=self.job_name,
                aggregates=aggregates,
                goodput_ratio=ratio[1] if ratio else 0.0,
                health_score=score,
                timestamp=now,
            )
        persist_verdict = getattr(
            self.brain, "persist_health_verdict", None
        )
        if persist_verdict is not None:
            import json

            for v in new_verdicts:
                persist_verdict(
                    job_name=self.job_name,
                    detector=v.detector,
                    severity=v.severity,
                    node_id=v.node_id,
                    message=v.message,
                    action=v.suggested_action,
                    evidence=json.dumps(v.to_dict()["evidence"]),
                    timestamp=v.timestamp or now,
                )

    # -- shared action-cooldown stamps ------------------------------------

    def action_stamp(
        self, key: Tuple[str, str, int]
    ) -> Optional[float]:
        """Wall stamp of the last action taken for a (detector, host,
        node_id) subject — shared between the capture path (PROFILE/
        DIAGNOSE auto-queue) and the remediation engine so the two
        never hammer the same subject independently."""
        with self._lock:
            return self._last_action.get(key)

    def stamp_action(
        self, key: Tuple[str, str, int], ts: float
    ) -> None:
        with self._lock:
            self._last_action[key] = ts

    # -- warm-restart snapshot ---------------------------------------------

    def to_snapshot(self) -> dict:
        """JSON-safe recoverable state: the ACTIVE verdict set, the
        transition history, action-cooldown stamps, and straggler
        streaks. Without this, a warm restart wipes the active set, so
        a still-firing (sticky) verdict re-registers as a brand-new
        transition and re-fires its action immediately — defeating the
        cooldown every time the master bounces. All stamps are wall
        clock, so they stay meaningful across processes."""
        with self._lock:
            return {
                "active": [v.to_dict() for v in self._active.values()],
                "history": [v.to_dict() for v in self._history],
                "last_action": [
                    [k[0], k[1], k[2], ts]
                    for k, ts in self._last_action.items()
                ],
                "straggler_ticks": {
                    str(k): v
                    for k, v in self._straggler_ticks.items()
                },
            }

    def restore_snapshot(self, state: dict) -> None:
        with self._lock:
            self._active = {}
            for d in state.get("active", []):
                v = HealthVerdict.from_dict(d)
                self._active[v.key()] = v
            self._history.clear()
            for d in state.get("history", []):
                self._history.append(HealthVerdict.from_dict(d))
            self._last_action = {
                (str(det), str(host), int(node_id)): float(ts)
                for det, host, node_id, ts in state.get(
                    "last_action", []
                )
            }
            self._straggler_ticks = {
                int(k): int(v)
                for k, v in state.get("straggler_ticks", {}).items()
            }
            score = self._score_locked()
        _HEALTH_SCORE.set(score)

    # -- read surface ------------------------------------------------------

    def _active_list(self) -> List[HealthVerdict]:
        with self._lock:
            return list(self._active.values())

    def active_verdicts(self) -> List[HealthVerdict]:
        """Currently-active verdicts, most severe first."""
        return sorted(self._active_list(), key=_verdict_sort_key)

    def history(self, limit: int = 0) -> List[HealthVerdict]:
        """Verdict transitions (including resolutions), oldest first,
        bounded by the engine's history ring."""
        with self._lock:
            items = list(self._history)
        return items[-limit:] if limit > 0 else items

    def _score_locked(self) -> float:
        penalty = sum(
            SEVERITY_PENALTY.get(v.severity, 0.0)
            for v in self._active.values()
        )
        return max(0.0, min(1.0, 1.0 - penalty))

    def health_score(self) -> float:
        with self._lock:
            return self._score_locked()

    def critical_count(self) -> int:
        with self._lock:
            return sum(
                1
                for v in self._active.values()
                if v.severity == SEVERITY_CRITICAL
            )

    def healthz_payload(self) -> dict:
        """The /healthz JSON body (obs/exposition.py): the readiness
        facts a deploy probe keys on."""
        with self._lock:
            active = list(self._active.values())
            score = self._score_locked()
        critical = sum(
            1 for v in active if v.severity == SEVERITY_CRITICAL
        )
        return {
            "ok": critical == 0,
            "health_score": round(score, 4),
            "critical_verdicts": critical,
            "active_verdicts": len(active),
            "evaluations": self._evaluations,
            "detectors": sorted(
                {v.detector for v in active}
            ),
        }

    def snapshot(self) -> dict:
        """Full health snapshot for tools (obs_report --health)."""
        return {
            "ts": self.clock(),
            "score": self.health_score(),
            "critical_verdicts": self.critical_count(),
            "active": [
                v.to_dict() for v in self.active_verdicts()
            ],
            "history": [v.to_dict() for v in self.history()],
        }


def render_health(payload: dict) -> str:
    """Human rendering of a health snapshot (``HealthMonitor.
    snapshot()`` or the assembled ``HealthQueryResponse``) — the
    ``obs_report --health`` body."""
    score = float(payload.get("score", 1.0))
    active = list(payload.get("active", []))
    history = list(payload.get("history", []))
    critical = payload.get(
        "critical_verdicts",
        sum(1 for v in active if v.get("severity") == SEVERITY_CRITICAL),
    )
    lines = [
        f"job health score {score:.2f} "
        f"({len(active)} active verdict"
        f"{'' if len(active) == 1 else 's'}, {critical} critical)"
    ]
    if not active:
        lines.append("  no active verdicts — fleet healthy")
    for v in active:
        head = f"  [{v.get('severity', '?'):<8}] {v.get('detector', '?')}"
        subject = v.get("host") or (
            f"node {v['node_id']}"
            if int(v.get("node_id", -1)) >= 0
            else "job"
        )
        lines.append(f"{head} ({subject}): {v.get('message', '')}")
        if v.get("suggested_action"):
            lines.append(
                f"             action: {v['suggested_action']}"
            )
        evidence = v.get("evidence") or []
        if evidence:
            vals = [float(p[1]) for p in evidence]
            tail = " ".join(f"{x:.4g}" for x in vals[-8:])
            lines.append(
                f"             evidence {v.get('evidence_series', '?')}"
                f" ({len(evidence)} pts, min {min(vals):.4g} "
                f"max {max(vals):.4g}): ... {tail}"
            )
    if history:
        lines.append(f"history (last {min(len(history), 10)}):")
        for v in history[-10:]:
            mark = "resolved" if v.get("resolved") else v.get(
                "severity", "?"
            )
            lines.append(
                f"  {v.get('timestamp', 0):.0f} [{mark}] "
                f"{v.get('detector', '?')} "
                f"{v.get('host') or v.get('node_id')}"
            )
    return "\n".join(lines)
