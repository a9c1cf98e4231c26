"""Self-healing control plane: verdict-driven remediation with
safety governors.

The health plane (obs/health.py) *diagnoses*: detectors over the
time-series history emit typed :class:`HealthVerdict` s. This engine
*acts* on them — DLRover's brain loop closed (PAPER.md §1.1, ROADMAP
item 2) — through the seams the control plane already has:

========================  ==================================================
critical verdict          remediation action
========================  ==================================================
throughput_degradation,   **cordon-then-replace**: mark the host cordoned
straggler_persistence     (it leaves the rendezvous at the next boundary,
                          its agent parks the trainer on the ``cordon``
                          heartbeat action), launch a replacement worker
                          via a ScalePlan, and only *retire* the cordoned
                          pod once probation confirms recovery — so a
                          wrong conviction is reversible.
recompile_storm,          **restart_training**: bounce the wedged/leaking
rss_growth,               trainer in place through the heartbeat action
data_starvation           FIFO (the agent restarts the process, the node
                          stays).
(sick past budget)        **shrink**: when replace didn't help (probation
                          rolled back) and the host is convicted again,
                          retire it without a replacement — the world
                          shrinks at the next rendezvous boundary, never
                          below ``min_nodes``.
replica_unhealthy         **serving ladder** (docs/SERVING.md): first
                          **drain_replica** (the router requeues its
                          in-flight requests — requests are safe within
                          one decision), then if the replica stays
                          convicted **restart_training** (its agent
                          bounces the replica process), then
                          **cordon_replace** (a fresh replica node via
                          ScalePlan). Training peers are never bounced
                          for a replica subject.
========================  ==================================================

The *governors* are the point of this module — every action must pass
all of them, and every decision (acted, blocked, dry-run) is an
auditable record:

* **hysteresis** — a subject must be critical for N *consecutive*
  engine ticks before any action (a flapping host is damped, never
  ping-pongs the world), and recovery needs M consecutive healthy
  ticks before probation declares success;
* **cooldown** — decorrelated (jittered) per-subject cooldowns shared
  with the health plane's PROFILE/DIAGNOSE action stamps
  (``HealthMonitor.action_stamp``), so capture and remediation never
  hammer the same subject together;
* **blast radius** — at most ``blast_max_actions`` (default 1) acted
  remediations per ``blast_window_s`` fleet-wide, and cordon/shrink
  never take the live world below ``min_nodes``;
* **probation** — after acting, the engine watches for
  ``probation_s``: recovery (verdict resolved + throughput back
  within ``recover_ratio``) finalizes the action; a failed probation
  *rolls back* (un-cordon, retire the replacement, stop relaunching)
  or *escalates* one rung (restart → cordon-replace → shrink →
  alert-only);
* **dry-run** — ``DLROVER_TPU_REMEDIATION_DRY_RUN=1`` evaluates the
  full pipeline and persists the decisions without mutating anything.

Decisions are exported as ``dlrover_remediation_*`` metrics, traced
as ``remediation.*`` events, persisted to the brain datastore
(``remediation_decisions`` table), served over the
``RemediationQueryRequest`` RPC, journaled into master state
snapshots (a warm restart keeps cordons, probations, and history),
and rendered by ``tools/obs_report.py --health``.

Every knob reads ``DLROVER_TPU_REMEDIATION_<KNOB>`` (see DEFAULTS),
overridable per-instance via ``config=``; the clock and RNG are
injectable so every governor is hermetically testable.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import (
    EventAction,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs import tracer as _trace
from dlrover_tpu_torch.obs.health import SEVERITY_CRITICAL, HealthVerdict

logger = get_logger("remediation")

REMEDIATION_ENV_PREFIX = "DLROVER_TPU_REMEDIATION_"

ACTION_RESTART_TRAINING = "restart_training"
ACTION_CORDON_REPLACE = "cordon_replace"
ACTION_SHRINK = "shrink"
ACTION_DRAIN_REPLICA = "drain_replica"
ACTION_ALERT_ONLY = "alert_only"

# Escalation ladder rungs, per subject: the base action, then
# cordon-replace, then shrink, then alert-only. A successful probation
# resets the subject to the base rung; a failed one advances it.
RUNG_BASE = 0
RUNG_CORDON = 1
RUNG_SHRINK = 2
RUNG_ALERT_ONLY = 3

# Which critical detector convicts into which base action. Detectors
# absent here (goodput_slo = job-wide, fleet_stall = nobody to
# convict, heartbeat_gap = a silent node cannot be handed an action)
# stay alert-only by design.
DETECTOR_ACTIONS: Dict[str, str] = {
    "throughput_degradation": ACTION_CORDON_REPLACE,
    "straggler_persistence": ACTION_CORDON_REPLACE,
    # The stall correlator's localized culprit: replace the one wedged
    # host, never blind-restart the fleet it parked.
    "collective_stall": ACTION_CORDON_REPLACE,
    "recompile_storm": ACTION_RESTART_TRAINING,
    "rss_growth": ACTION_RESTART_TRAINING,
    "data_starvation": ACTION_RESTART_TRAINING,
    "replica_unhealthy": ACTION_DRAIN_REPLICA,
}

# Serving subjects climb their OWN ladder, indexed by the same rung
# counter: drain (requests requeue) -> restart (the agent bounces the
# replica process) -> replace (fresh replica node via ScalePlan) ->
# alert-only.
SERVING_LADDER = (
    ACTION_DRAIN_REPLICA,
    ACTION_RESTART_TRAINING,
    ACTION_CORDON_REPLACE,
    ACTION_ALERT_ONLY,
)

OUTCOME_PENDING = "pending"
OUTCOME_ACTED = "acted"
OUTCOME_DRY_RUN = "dry_run"
OUTCOME_BLOCKED = "blocked"
OUTCOME_FAILED = "failed"
OUTCOME_RECOVERED = "recovered"
OUTCOME_ROLLED_BACK = "rolled_back"
OUTCOME_ESCALATED = "escalated"

_DECISIONS_TOTAL = obs.counter(
    "dlrover_remediation_decisions_total",
    "Remediation decisions recorded by the master's engine, by "
    "detector, action, and (transitioning) outcome",
    ("detector", "action", "outcome"),
)
_GOVERNOR_BLOCKS = obs.counter(
    "dlrover_remediation_governor_blocks_total",
    "Remediation actions vetoed by a safety governor",
    ("governor",),
)
_CORDONED_NODES = obs.gauge(
    "dlrover_remediation_cordoned_nodes",
    "Nodes currently cordoned (excluded from rendezvous, replacement "
    "in flight, retirement pending probation)",
)
_PROBATIONS_ACTIVE = obs.gauge(
    "dlrover_remediation_probations_active",
    "Remediation actions currently inside their post-action "
    "probation window",
)
_RECOVERY_SECONDS = obs.gauge(
    "dlrover_remediation_recovery_seconds",
    "Decision-to-recovery duration of the most recently RECOVERED "
    "remediation (verdict-convicted action through probation "
    "success)",
)

# Every governor knob, with its default. Override per knob via
# DLROVER_TPU_REMEDIATION_<NAME-upper> or the config= dict (config
# wins). Windows are seconds; tick counts are engine ticks.
DEFAULTS: Dict[str, float] = {
    "enabled": 1.0,
    "dry_run": 0.0,
    "interval_s": 15.0,
    # hysteresis: N consecutive critical ticks to act, M consecutive
    # healthy ticks for probation to declare recovery
    "hysteresis_ticks": 3.0,
    "recovery_ticks": 3.0,
    # blast radius: acted remediations per window, fleet-wide
    "blast_window_s": 600.0,
    "blast_max_actions": 1.0,
    # per-subject cooldown, shared with the health plane's action
    # stamps; jitter decorrelates subjects that got sick together
    "cooldown_s": 300.0,
    "cooldown_jitter": 0.5,
    # probation: how long to watch after acting, and how close to the
    # verdict's own pre-degradation baseline throughput must return
    "probation_s": 300.0,
    "recover_ratio": 1.25,
    "history": 256.0,
}


@dataclasses.dataclass
class RemediationDecision:
    """One engine decision — the auditable record the acceptance
    criteria demand: trigger verdict + evidence pointer, the result of
    every governor check, the action, and the eventual outcome."""

    decision_id: int
    detector: str
    severity: str
    node_id: int
    host: str
    action: str
    trigger: str  # the convicting verdict's message
    governors: Dict[str, str] = dataclasses.field(default_factory=dict)
    outcome: str = OUTCOME_PENDING
    dry_run: bool = False
    # The verdict's own healthy baseline (metrics["baseline_mean_s"]),
    # the yardstick probation measures recovery against.
    baseline_step_s: float = 0.0
    timestamp: float = 0.0
    probation_deadline: float = 0.0
    healthy_ticks: int = 0
    resolved_at: float = 0.0
    replacement_id: int = -1
    note: str = ""
    # Distributed trace: one trace per decision (verdict -> governors
    # -> action -> probation -> outcome spans; a drain's requeues link
    # in), span_id its root span.
    trace_id: str = ""
    span_id: str = ""

    def subject(self) -> Tuple[str, int]:
        return (self.host, self.node_id)

    def to_dict(self) -> dict:
        return {
            "decision_id": self.decision_id,
            "detector": self.detector,
            "severity": self.severity,
            "node_id": self.node_id,
            "host": self.host,
            "action": self.action,
            "trigger": self.trigger,
            "governors": dict(self.governors),
            "outcome": self.outcome,
            "dry_run": self.dry_run,
            "baseline_step_s": round(self.baseline_step_s, 6),
            "timestamp": round(self.timestamp, 3),
            "probation_deadline": round(self.probation_deadline, 3),
            "healthy_ticks": self.healthy_ticks,
            "resolved_at": round(self.resolved_at, 3),
            "replacement_id": self.replacement_id,
            "note": self.note,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RemediationDecision":
        return cls(
            decision_id=int(d.get("decision_id", 0)),
            detector=str(d.get("detector", "")),
            severity=str(d.get("severity", "")),
            node_id=int(d.get("node_id", -1)),
            host=str(d.get("host", "")),
            action=str(d.get("action", "")),
            trigger=str(d.get("trigger", "")),
            governors={
                str(k): str(v)
                for k, v in (d.get("governors") or {}).items()
            },
            outcome=str(d.get("outcome", OUTCOME_PENDING)),
            dry_run=bool(d.get("dry_run", False)),
            baseline_step_s=float(d.get("baseline_step_s", 0.0)),
            timestamp=float(d.get("timestamp", 0.0)),
            probation_deadline=float(d.get("probation_deadline", 0.0)),
            healthy_ticks=int(d.get("healthy_ticks", 0)),
            resolved_at=float(d.get("resolved_at", 0.0)),
            replacement_id=int(d.get("replacement_id", -1)),
            note=str(d.get("note", "")),
            trace_id=str(d.get("trace_id", "")),
            span_id=str(d.get("span_id", "")),
        )


GOVERNOR_OK = "ok"


class RemediationEngine:
    """Consumes the health plane's active verdicts on a cadence and
    drives governed, reversible recovery actions through the master's
    existing seams (job manager + scaler, servicer action FIFO,
    rendezvous managers).

    Everything is injectable for hermetic tests: ``clock`` drives
    windows/probations, ``rng_seed`` fixes the decorrelating jitter,
    and the collaborating components are plain constructor args.
    """

    def __init__(
        self,
        health,
        job_manager,
        servicer,
        fleet=None,
        store=None,
        speed_monitor=None,
        auto_scaler=None,
        rdzv_managers: Sequence = (),
        serving=None,
        brain=None,
        traces=None,
        min_nodes: int = 1,
        job_name: str = "default",
        clock: Optional[Callable[[], float]] = None,
        config: Optional[Dict[str, float]] = None,
        interval: Optional[float] = None,
        rng_seed: int = 0,
    ):
        self.health = health
        self.job_manager = job_manager
        self.servicer = servicer
        self.fleet = fleet
        self.store = store
        self.speed_monitor = speed_monitor
        self.auto_scaler = auto_scaler
        self.rdzv_managers = tuple(rdzv_managers)
        # Serving router: the drain rung of the replica_unhealthy
        # ladder calls its drain_replica; None on training-only
        # masters (the detector then never fires either).
        self.serving = serving
        self.brain = brain
        # Trace store: every decision assembles a causal timeline
        # (verdict -> governors -> action -> probation -> outcome)
        # queryable by decision trace id or node subject.
        self.traces = traces
        self.min_nodes = max(int(min_nodes), 1)
        self.job_name = job_name
        self.clock = clock if clock is not None else time.time
        self._config = dict(config or {})
        self.interval = (
            interval if interval is not None else self._cfg("interval_s")
        )
        self._rng_seed = rng_seed
        self._lock = threading.Lock()
        self._seq = 0
        self._decisions: deque = deque(maxlen=int(self._cfg("history")))
        # (detector, host, node_id) -> consecutive critical ticks
        self._sick: Dict[Tuple[str, str, int], int] = {}
        # node_id -> cordon record (host, detector, decision_id,
        # replacement_id, since)
        self._cordoned: Dict[int, dict] = {}
        # decision_id -> decision under probation
        self._probation: Dict[int, RemediationDecision] = {}
        # (host, node_id) -> escalation rung (RUNG_ALERT_ONLY is the
        # terminal rung: the subject never draws another action)
        self._ladder: Dict[Tuple[str, int], int] = {}
        # Wall stamps of acted remediations inside the blast window.
        self._window: List[float] = []
        # Dedup for repeated records while a subject stays sick:
        # dry-run decisions and blocked decisions log once per episode
        # (re-armed when the subject's verdict resolves).
        self._logged: Dict[Tuple[str, str, int], str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Fired after decision/cordon/probation state changes; the
        # JobMaster points this at the state journal.
        self.on_state_change = None

    # -- config -----------------------------------------------------------

    def _cfg(self, knob: str) -> float:
        if knob in self._config:
            return float(self._config[knob])
        env = os.getenv(REMEDIATION_ENV_PREFIX + knob.upper(), "")
        if env:
            try:
                return float(env)
            except ValueError:
                logger.warning(
                    "bad %s%s=%r; using default %s",
                    REMEDIATION_ENV_PREFIX, knob.upper(), env,
                    DEFAULTS[knob],
                )
        return DEFAULTS[knob]

    @property
    def enabled(self) -> bool:
        return bool(self._cfg("enabled"))

    @property
    def dry_run(self) -> bool:
        return bool(self._cfg("dry_run"))

    # -- engine lifecycle --------------------------------------------------

    def start(self) -> None:
        if not self.enabled:
            logger.info("remediation engine disabled; not starting")
            return
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="remediation", daemon=True
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
                self.tick_once()
            except Exception:  # noqa: BLE001 — an engine bug must not
                # kill the thread (and with it all future remediation)
                logger.warning("remediation tick failed", exc_info=True)

    def _changed(self) -> None:
        cb = self.on_state_change
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001
                pass

    # -- one evaluation tick ----------------------------------------------

    def tick_once(self) -> List[RemediationDecision]:
        """One engine tick: refresh hysteresis from the active verdict
        set, review probations (recovery / rollback / escalation),
        then evaluate new actions through the governor pipeline.
        Returns the decisions recorded this tick."""
        if not self.enabled:
            return []
        now = self.clock()
        critical = [
            v
            for v in self.health.active_verdicts()
            if v.severity == SEVERITY_CRITICAL
        ]
        crit_keys = {v.key() for v in critical}
        crit_subjects = {(v.host, v.node_id) for v in critical}
        with self._lock:
            for key in crit_keys:
                self._sick[key] = self._sick.get(key, 0) + 1
            for key in list(self._sick):
                if key not in crit_keys:
                    del self._sick[key]
                    self._logged.pop(key, None)
        recorded: List[RemediationDecision] = []
        recorded.extend(self._review_probations(now, crit_subjects))
        recorded.extend(self._decide(critical, now))
        _PROBATIONS_ACTIVE.set(len(self._probation))
        _CORDONED_NODES.set(len(self._cordoned))
        if recorded:
            self._changed()
        return recorded

    # -- governors ---------------------------------------------------------

    def _alive_workers(self) -> List:
        return self.job_manager.alive_workers()

    def _check_governors(
        self, v: HealthVerdict, action: str, now: float
    ) -> Dict[str, str]:
        """Every governor's verdict for this candidate action. All
        values ``"ok"`` means the action may proceed."""
        g: Dict[str, str] = {}
        key = v.key()
        sick = self._sick.get(key, 0)
        need = int(self._cfg("hysteresis_ticks"))
        g["hysteresis"] = (
            GOVERNOR_OK
            if sick >= need
            else f"blocked: {sick}/{need} consecutive sick ticks"
        )
        # Cooldown shared with the health plane's PROFILE/DIAGNOSE
        # stamps: one stamp map, decorrelated by jitter so subjects
        # convicted together do not act in lockstep.
        last = self.health.action_stamp(key)
        cooldown = self._cooldown_for(key)
        if last is not None and now - last < cooldown:
            g["cooldown"] = (
                f"blocked: {now - last:.0f}s since last action "
                f"< {cooldown:.0f}s cooldown"
            )
        else:
            g["cooldown"] = GOVERNOR_OK
        recent = [
            t for t in self._window
            if now - t < self._cfg("blast_window_s")
        ]
        max_actions = int(self._cfg("blast_max_actions"))
        g["blast_radius"] = (
            GOVERNOR_OK
            if len(recent) < max_actions
            else (
                f"blocked: {len(recent)} action(s) in the last "
                f"{self._cfg('blast_window_s'):.0f}s window "
                f"(cap {max_actions})"
            )
        )
        if action in (ACTION_CORDON_REPLACE, ACTION_SHRINK):
            if v.detector == "replica_unhealthy":
                # Replica subjects never shrink the TRAINING world
                # (min_nodes guards workers); serving capacity is
                # refilled by the replacement and requests queue at
                # the router meanwhile — the router's min_replicas
                # governs serving floor separately.
                g["min_nodes"] = GOVERNOR_OK
            else:
                alive = len(self._alive_workers())
                g["min_nodes"] = (
                    GOVERNOR_OK
                    if alive - 1 >= self.min_nodes
                    else (
                        f"blocked: {alive} alive worker(s) - 1 < "
                        f"min_nodes {self.min_nodes}"
                    )
                )
        if action == ACTION_CORDON_REPLACE:
            # Under a pool master this job's replacement must fit its
            # GRANT: cordon-then-replace briefly runs old + new side
            # by side, and the pool will not hand out a slice the
            # scheduler did not grant. Single-job masters (no grant)
            # pass unconditionally. getattr: embedded test doubles
            # predate the pool seam.
            headroom_fn = getattr(
                self.job_manager, "grant_headroom", None
            )
            headroom = headroom_fn() if headroom_fn else None
            g["pool_grant"] = (
                GOVERNOR_OK
                if headroom is None or headroom >= 1
                else (
                    "blocked: pool grant "
                    f"{self.job_manager.pool_grant} has no headroom "
                    "for a replacement"
                )
            )
        return g

    def _cooldown_for(self, key: Tuple[str, str, int]) -> float:
        """The subject's jittered cooldown threshold. Derived
        DETERMINISTICALLY from (rng_seed, subject key) — not re-rolled
        per tick: a fresh draw every governor check would let any
        subject pass as soon as one roll landed low (the min of
        repeated uniforms walks to zero), collapsing the promised
        decorrelation back into lockstep at ~cooldown_s. A stable
        per-subject draw also survives master restarts, so the
        spread keeps its meaning across a warm restart."""
        base = self._cfg("cooldown_s")
        jitter = self._cfg("cooldown_jitter")
        if jitter <= 0:
            return base
        digest = hashlib.sha256(
            f"{self._rng_seed}:{key!r}".encode()
        ).digest()
        r = int.from_bytes(digest[:8], "big") / 2.0**64
        return base * (1.0 + jitter * r)

    def _action_for(self, v: HealthVerdict) -> Optional[str]:
        subject = (v.host, v.node_id)
        base = DETECTOR_ACTIONS.get(v.detector)
        if base is None:
            return None
        rung = self._ladder.get(subject, RUNG_BASE)
        if v.detector == "replica_unhealthy":
            action = SERVING_LADDER[
                min(rung, len(SERVING_LADDER) - 1)
            ]
            return None if action == ACTION_ALERT_ONLY else action
        if rung >= RUNG_ALERT_ONLY:
            return None
        if rung >= RUNG_SHRINK:
            return ACTION_SHRINK
        if rung >= RUNG_CORDON or base == ACTION_CORDON_REPLACE:
            return ACTION_CORDON_REPLACE
        return base

    # -- decide + execute --------------------------------------------------

    def _decide(
        self, critical: List[HealthVerdict], now: float
    ) -> List[RemediationDecision]:
        recorded: List[RemediationDecision] = []
        for v in critical:
            if v.node_id < 0:
                continue  # job-wide or unmapped subject
            with self._lock:
                if v.node_id in self._cordoned:
                    continue  # already mid-remediation
                if any(
                    d.node_id == v.node_id
                    for d in self._probation.values()
                ):
                    continue
                action = self._action_for(v)
            if action is None:
                continue
            node = self.job_manager.get_node(v.node_id)
            if node is None or not node.is_alive():
                continue
            governors = self._check_governors(v, action, now)
            blocked = {
                name: why
                for name, why in governors.items()
                if why != GOVERNOR_OK
            }
            key = v.key()
            if blocked:
                # Hysteresis warming up is the normal path, not an
                # audit-worthy veto; other governors are.
                others = {
                    n for n in blocked if n != "hysteresis"
                }
                if not others or governors["hysteresis"] != GOVERNOR_OK:
                    continue
                mark = "blocked:" + ",".join(sorted(others))
                with self._lock:
                    if self._logged.get(key) == mark:
                        continue
                    self._logged[key] = mark
                for name in sorted(others):
                    _GOVERNOR_BLOCKS.inc(governor=name)
                d = self._new_decision(
                    v, action, governors, now,
                    outcome=OUTCOME_BLOCKED,
                )
                self._record(d)
                recorded.append(d)
                continue
            if self.dry_run:
                mark = "dry_run"
                with self._lock:
                    if self._logged.get(key) == mark:
                        continue
                    self._logged[key] = mark
                d = self._new_decision(
                    v, action, governors, now,
                    outcome=OUTCOME_DRY_RUN, dry_run=True,
                )
                self._record(d)
                recorded.append(d)
                logger.warning(
                    "remediation DRY RUN: would %s node %d (%s) for "
                    "%s — %s",
                    action, v.node_id, v.host, v.detector, v.message,
                )
                continue
            d = self._new_decision(v, action, governors, now)
            ok = self._execute(d)
            if ok:
                d.outcome = OUTCOME_ACTED
                d.probation_deadline = now + self._cfg("probation_s")
                self.health.stamp_action(key, now)
                with self._lock:
                    self._window.append(now)
                    self._window = [
                        t for t in self._window
                        if now - t < self._cfg("blast_window_s")
                    ]
                    self._probation[d.decision_id] = d
                    self._logged[key] = "acted"
            else:
                d.outcome = OUTCOME_FAILED
                # Rate-limit the retry like any acted decision: stamp
                # the shared cooldown and mark the episode, so a
                # persistently-failing action (cluster API down)
                # backs off instead of re-firing — and re-recording a
                # decision + brain row + metric — every single tick.
                self.health.stamp_action(key, now)
                with self._lock:
                    self._logged[key] = "failed"
            self._record(d)
            recorded.append(d)
        return recorded

    def _new_decision(
        self,
        v: HealthVerdict,
        action: str,
        governors: Dict[str, str],
        now: float,
        outcome: str = OUTCOME_PENDING,
        dry_run: bool = False,
    ) -> RemediationDecision:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return RemediationDecision(
            decision_id=seq,
            detector=v.detector,
            severity=v.severity,
            node_id=v.node_id,
            host=v.host,
            action=action,
            trigger=v.message,
            governors=governors,
            outcome=outcome,
            dry_run=dry_run,
            baseline_step_s=float(
                v.metrics.get("baseline_mean_s", 0.0)
            ),
            timestamp=now,
            trace_id=_trace.new_trace_id(),
            span_id=_trace.new_span_id(),
        )

    def _tspan(
        self,
        d: RemediationDecision,
        name: str,
        start: float,
        dur: float = 0.0,
        span_id: str = "",
        parent: Optional[str] = None,
        **tags,
    ) -> None:
        """One span of the decision's trace (no-op without a store).
        Default parent is the decision's root span."""
        if self.traces is None or not d.trace_id:
            return
        self.traces.add_span(
            d.trace_id,
            name,
            start,
            dur_s=max(dur, 0.0),
            span_id=span_id,
            parent_span_id=d.span_id if parent is None else parent,
            node_id=d.node_id,
            decision_id=d.decision_id,
            **tags,
        )

    def _execute(self, d: RemediationDecision) -> bool:
        try:
            if d.action == ACTION_RESTART_TRAINING:
                return self._exec_restart(d)
            if d.action == ACTION_CORDON_REPLACE:
                return self._exec_cordon_replace(d)
            if d.action == ACTION_SHRINK:
                return self._exec_shrink(d)
            if d.action == ACTION_DRAIN_REPLICA:
                return self._exec_drain_replica(d)
        except Exception:  # noqa: BLE001 — a failed action is an
            # outcome to record, never an engine crash
            logger.warning(
                "remediation action %s on node %d failed",
                d.action, d.node_id, exc_info=True,
            )
        return False

    def _dedupe_key(self, d: RemediationDecision, what: str) -> str:
        return f"remediation:{d.decision_id}:{what}"

    def _exec_restart(self, d: RemediationDecision) -> bool:
        self.servicer.push_action(
            d.node_id,
            EventAction.RESTART_TRAINING.value,
            dedupe_key=self._dedupe_key(d, "restart"),
        )
        return True

    def _exec_drain_replica(self, d: RemediationDecision) -> bool:
        """Serving ladder rung 0: the router stops dispatching to the
        replica and requeues everything it holds — the requests are
        safe within this one decision, whatever happens to the
        replica. The node itself is untouched (a recovered replica
        re-registers ready)."""
        if self.serving is None:
            return False
        # The drain's requeues join this decision's trace: the router
        # records a serve.requeue span per rescued request under the
        # decision root, so verdict -> drain -> requeue reads as one
        # causal chain. link= only when a trace store is wired —
        # duck-typed routers without the kwarg stay supported.
        if self.traces is not None and d.trace_id:
            self.serving.drain_replica(
                d.node_id,
                reason=d.detector,
                link=(d.trace_id, d.span_id),
            )
        else:
            self.serving.drain_replica(d.node_id, reason=d.detector)
        obs.event(
            "remediation.drain_replica",
            node_id=d.node_id, detector=d.detector,
            trace_id=d.trace_id, parent_span_id=d.span_id,
        )
        return True

    def _exec_cordon_replace(self, d: RemediationDecision) -> bool:
        node = self.job_manager.get_node(d.node_id)
        if node is None or not node.is_alive():
            return False
        if node.type == NodeType.REPLICA:
            return self._exec_replace_replica(d, node)
        if not self.job_manager.cordon_node(d.node_id, reason=d.detector):
            return False
        # From here on the node IS cordoned: every further step is
        # best-effort, and the engine must end up owning the cordon
        # record either way — a partial failure without a probation
        # would strand the pod parked forever with nothing to ever
        # roll it back or retire it.
        try:
            # Park the sick trainer (it keeps heartbeating; rollback
            # can un-cordon it) and pull it out of the next
            # rendezvous; survivors re-rendezvous without it.
            self.servicer.push_action(
                d.node_id,
                EventAction.CORDON.value,
                dedupe_key=self._dedupe_key(d, "cordon"),
            )
            for rdzv in self.rdzv_managers:
                rdzv.remove_alive_node(node.id, node_rank=node.rank)
            self.servicer.restart_peers(
                node.id, dedupe_prefix=self._dedupe_key(d, "peers")
            )
            # Purge the benched host's telemetry (same contract as a
            # departed host): its trainer is parked, so the stale
            # slow window — fleet series AND the speed monitor's
            # frozen step-time EWMA — would otherwise pin the verdict
            # active past any probation and guarantee a wrong
            # rollback. The convicting evidence already rides the
            # verdict and this decision record.
            if self.fleet is not None:
                self.fleet.remove_node(node.id)
            if self.speed_monitor is not None:
                self.speed_monitor.remove_running_node(node.id)
        except Exception:  # noqa: BLE001
            logger.warning(
                "cordon side-effects for node %d partially failed",
                d.node_id, exc_info=True,
            )
        repl = None
        try:
            repl = self.job_manager.launch_replacement(
                node, reason=d.detector
            )
        except Exception:  # noqa: BLE001 — a failed launch is NOT a
            # failed cordon: probation still governs the benched
            # node, and a failed probation rolls the cordon back.
            logger.warning(
                "replacement launch for cordoned node %d failed",
                d.node_id, exc_info=True,
            )
        d.replacement_id = repl.id if repl is not None else -1
        with self._lock:
            self._cordoned[d.node_id] = {
                "host": d.host,
                "detector": d.detector,
                "decision_id": d.decision_id,
                "replacement_id": d.replacement_id,
                "since": d.timestamp,
            }
        _CORDONED_NODES.set(len(self._cordoned))
        obs.event(
            "remediation.cordon",
            node_id=d.node_id, host=d.host, detector=d.detector,
            replacement_id=d.replacement_id,
        )
        return True

    def _exec_replace_replica(
        self, d: RemediationDecision, node
    ) -> bool:
        """Serving ladder rung 2: cordon the sick replica node (its
        fresh incarnations stay benched), drain any requests it
        re-acquired, and launch a replacement replica node through
        the ScalePlan seam. Deliberately does NOT touch the training
        world: no rendezvous removal, no peer restarts, no fleet
        telemetry purge — a sick replica must never bounce the
        trainers sharing the control plane."""
        if not self.job_manager.cordon_node(
            d.node_id, reason=d.detector
        ):
            return False
        if self.serving is not None:
            try:
                self.serving.drain_replica(
                    d.node_id, reason=d.detector
                )
            except Exception:  # noqa: BLE001
                logger.warning(
                    "drain during replica replace failed",
                    exc_info=True,
                )
        repl = None
        try:
            repl = self.job_manager.launch_replacement(
                node,
                reason=d.detector,
                node_id=self._free_replica_node_id(),
            )
        except Exception:  # noqa: BLE001 — same contract as the
            # worker path: a failed launch is governed by probation
            logger.warning(
                "replacement launch for replica %d failed",
                d.node_id, exc_info=True,
            )
        d.replacement_id = repl.id if repl is not None else -1
        with self._lock:
            self._cordoned[d.node_id] = {
                "host": d.host,
                "detector": d.detector,
                "decision_id": d.decision_id,
                "replacement_id": d.replacement_id,
                "since": d.timestamp,
            }
        _CORDONED_NODES.set(len(self._cordoned))
        # The replacement inherits the sick node's role labels
        # (launch_replacement copies node.labels), so a replaced
        # prefill replica comes back a prefill replica; record the
        # role on the decision for the audit trail.
        role = getattr(node, "labels", {}).get("serving_role", "")
        if not role and self.serving is not None:
            role_of = getattr(self.serving, "role_of", None)
            role = role_of(d.node_id) if role_of else ""
        obs.event(
            "remediation.cordon",
            node_id=d.node_id, host=d.host, detector=d.detector,
            replacement_id=d.replacement_id, replica=True,
            **({"role": role} if role else {}),
        )
        return True

    def _free_replica_node_id(self) -> int:
        """The lowest replica-namespaced node id with no LIVE node —
        the same lowest-free-index policy ``ensure_role`` uses for
        this namespace, so cordon-replace and autoscale share one
        id-allocation scheme. Replica workers register under
        base+index (constants.replica_node_id); a replacement
        launched under a plain worker-sequence id could never be
        claimed by the arriving process and would sit PENDING
        forever."""
        from dlrover_tpu_torch.common.constants import replica_node_id

        idx = 0
        while True:
            node = self.job_manager.get_node(replica_node_id(idx))
            if node is None or not node.is_alive():
                return replica_node_id(idx)
            idx += 1

    def _exec_shrink(self, d: RemediationDecision) -> bool:
        node = self.job_manager.get_node(d.node_id)
        if node is None or not node.is_alive():
            return False
        obs.event(
            "remediation.shrink",
            node_id=d.node_id, host=d.host, detector=d.detector,
        )
        # retire_node removes the pod and fires the DELETED listener:
        # rendezvous removal + peer restarts happen there, and the
        # world re-forms >= min_nodes at the next boundary.
        self.job_manager.retire_node(d.node_id)
        if self.auto_scaler is not None:
            # The shrink must STICK: an auto-scaler still chasing the
            # old worker target would count the deficit and launch a
            # replacement on its next pass, undoing the shrink.
            # (JobMaster wires no worker auto-scaler today — any
            # composer pairing AllreduceAutoScaler with this engine
            # must pass it as the `auto_scaler` collaborator.)
            self.auto_scaler.target_workers = max(
                self.min_nodes, self.auto_scaler.target_workers - 1
            )
        return True

    # -- probation ---------------------------------------------------------

    def _throughput_recovered(self, d: RemediationDecision) -> bool:
        """Throughput back within ``recover_ratio`` of the verdict's
        own healthy baseline. Falls back to True when the engine has
        no comparable series (verdict resolution then decides)."""
        if d.baseline_step_s <= 0:
            return True
        ratio = self._cfg("recover_ratio")
        if d.action == ACTION_RESTART_TRAINING and self.store is not None:
            stats = self.store.query(
                "host.step_time", 120.0, host=d.host
            )
            if stats is not None and stats.count > 0:
                return stats.mean <= d.baseline_step_s * ratio
            return True
        if self.fleet is not None:
            # The cordoned host's series is stale/purged: judge the
            # fleet median (robust to one lingering stale entry).
            try:
                agg = self.fleet.aggregates().get("step_time_s", {})
            except Exception:  # noqa: BLE001
                return True
            p50 = agg.get("p50")
            if p50 is not None:
                return p50 <= d.baseline_step_s * ratio
        return True

    def _replacement_ok(self, d: RemediationDecision) -> bool:
        """A cordon-replace may only succeed with its replacement
        actually alive. Without this, a failed launch looks RECOVERED:
        the cordon purged the sick host's telemetry, so its verdict
        resolves and the (shrunken) fleet reads healthy — and success
        would then retire the benched pod, leaving the job
        permanently a worker short. Forcing failure instead rolls the
        cordon back and restores capacity."""
        if d.action != ACTION_CORDON_REPLACE:
            return True
        if d.replacement_id < 0:
            return False
        # RUNNING, not merely alive: PENDING counts as alive, but an
        # unschedulable replacement that never registers must not let
        # probation retire the benched pod on the strength of a fleet
        # that reads healthy only because the sick host was purged.
        repl = self.job_manager.get_node(d.replacement_id)
        return repl is not None and repl.status == NodeStatus.RUNNING

    def _review_probations(
        self, now: float, crit_subjects: Set[Tuple[str, int]]
    ) -> List[RemediationDecision]:
        finalized: List[RemediationDecision] = []
        with self._lock:
            probations = list(self._probation.values())
        for d in probations:
            subject_sick = (
                d.subject() in crit_subjects
                or any(n == d.node_id for _, n in crit_subjects)
            )
            if (
                not subject_sick
                and self._replacement_ok(d)
                and self._throughput_recovered(d)
            ):
                d.healthy_ticks += 1
            else:
                d.healthy_ticks = 0
            if d.healthy_ticks >= int(self._cfg("recovery_ticks")):
                self._finalize_success(d, now)
                finalized.append(d)
            elif now >= d.probation_deadline:
                self._finalize_failure(d, now)
                finalized.append(d)
        return finalized

    def _finalize_success(
        self, d: RemediationDecision, now: float
    ) -> None:
        with self._lock:
            # Outcome + probation removal flip atomically w.r.t. the
            # journal thread's to_snapshot (same lock): a snapshot
            # never records a RECOVERED decision still in probation.
            d.outcome = OUTCOME_RECOVERED
            d.resolved_at = now
            self._probation.pop(d.decision_id, None)
            self._ladder.pop(d.subject(), None)
            self._logged.pop(
                (d.detector, d.host, d.node_id), None
            )
            rec = (
                self._cordoned.pop(d.node_id, None)
                if d.action == ACTION_CORDON_REPLACE
                else None
            )
        if rec is not None:
            # The replacement took over and the fleet recovered:
            # complete cordon-THEN-REPLACE by retiring the sick pod.
            # Retire FIRST (the DELETED listener sees the cordon and
            # skips the fleet bounce), then clear the flag so a
            # future incarnation of this node id starts un-benched.
            self.job_manager.retire_node(d.node_id)
            self.job_manager.uncordon_node(d.node_id)
        _CORDONED_NODES.set(len(self._cordoned))
        # The derived SLO surface: how long this decision took from
        # conviction to verified recovery.
        _RECOVERY_SECONDS.set(max(now - d.timestamp, 0.0))
        obs.event(
            "remediation.recovered",
            node_id=d.node_id, host=d.host, detector=d.detector,
            action=d.action, decision_id=d.decision_id,
            trace_id=d.trace_id, parent_span_id=d.span_id,
        )
        logger.info(
            "remediation recovered: %s on node %d (%s) for %s",
            d.action, d.node_id, d.host, d.detector,
        )
        self._record(d, created=False)

    def _finalize_failure(
        self, d: RemediationDecision, now: float
    ) -> None:
        d.resolved_at = now
        subject = d.subject()
        # Mutate ALL engine state under the lock BEFORE any side
        # effect: the journal thread snapshots concurrently, and a
        # snapshot taken mid-rollback must never record a finalized
        # decision still listed under probation — a warm restore
        # would re-enter it and re-run the rollback's side effects
        # (spurious trainer bounce) on a live node.
        with self._lock:
            if d.detector == "replica_unhealthy":
                # Serving ladder: the failed rung's successor. A
                # failed replace ends at alert-only (rollback still
                # un-cordons below for the replace rung).
                try:
                    rung = SERVING_LADDER.index(d.action) + 1
                except ValueError:
                    rung = RUNG_ALERT_ONLY
                self._ladder[subject] = min(rung, RUNG_ALERT_ONLY)
                if d.action == ACTION_CORDON_REPLACE:
                    d.outcome = OUTCOME_ROLLED_BACK
                    d.note = (
                        "replica replace probation failed; rolled "
                        "back (un-cordoned), alert-only"
                    )
                else:
                    d.outcome = OUTCOME_ESCALATED
                    d.note = (
                        f"probation failed after {d.action}; "
                        "escalating to "
                        f"{SERVING_LADDER[self._ladder[subject]]}"
                    )
            elif d.action == ACTION_RESTART_TRAINING:
                # The bounce did not help: escalate to cordon-replace
                # the next time the subject clears hysteresis again.
                d.outcome = OUTCOME_ESCALATED
                d.note = (
                    "probation failed; escalating to cordon_replace"
                )
                self._ladder[subject] = RUNG_CORDON
            elif d.action == ACTION_CORDON_REPLACE:
                # The host was not the problem: roll back (un-cordon,
                # take the replacement back out) and mark the subject
                # past budget — the next conviction shrinks instead.
                d.outcome = OUTCOME_ROLLED_BACK
                d.note = "probation failed; rolled back (un-cordoned)"
                self._ladder[subject] = RUNG_SHRINK
            else:  # shrink — nothing to roll back; stop acting on it
                d.outcome = OUTCOME_ESCALATED
                d.note = "probation failed after shrink; alert-only"
                self._ladder[subject] = RUNG_ALERT_ONLY
            self._probation.pop(d.decision_id, None)
            self._logged.pop(
                (d.detector, d.host, d.node_id), None
            )
        if d.outcome == OUTCOME_ROLLED_BACK:
            self._rollback_cordon(d)
        obs.event(
            "remediation.probation_failed",
            node_id=d.node_id, host=d.host, detector=d.detector,
            action=d.action, outcome=d.outcome,
            decision_id=d.decision_id,
        )
        logger.warning(
            "remediation probation FAILED: %s on node %d (%s) for "
            "%s -> %s",
            d.action, d.node_id, d.host, d.detector, d.outcome,
        )
        self._record(d, created=False)

    def _rollback_cordon(self, d: RemediationDecision) -> None:
        with self._lock:
            rec = self._cordoned.pop(d.node_id, None)
        _CORDONED_NODES.set(len(self._cordoned))
        repl_id = rec.get("replacement_id", -1) if rec else -1
        node = self.job_manager.get_node(d.node_id)
        self.job_manager.uncordon_node(d.node_id)
        if node is None or not node.is_alive():
            # The benched pod died during probation: there is nothing
            # to roll back INTO the world. Keep the live replacement —
            # it IS the job's capacity now; retiring it too would
            # leave the world a worker short with nothing refilling
            # the deficit.
            obs.event(
                "remediation.rollback",
                node_id=d.node_id, host=d.host,
                replacement_id=repl_id, decision_id=d.decision_id,
                replacement_kept=True,
            )
            return
        if node.type != NodeType.REPLICA:
            # Serving replicas were never rendezvous members or step
            # reporters: un-cordoning one must not inject it into the
            # TRAINING world.
            for rdzv in self.rdzv_managers:
                rdzv.add_alive_node(d.node_id)
            if self.speed_monitor is not None:
                # The host is back in the world: resume its step
                # accounting (the EWMA restarts clean, so the old
                # slow window cannot instantly re-convict it).
                self.speed_monitor.add_running_node(d.node_id)
        # Un-park the trainer: restart_training doubles as un-cordon
        # on the agent side (it clears the cordon flag and rejoins at
        # the next rendezvous).
        self.servicer.push_action(
            d.node_id,
            EventAction.RESTART_TRAINING.value,
            dedupe_key=self._dedupe_key(d, "uncordon"),
        )
        if repl_id >= 0:
            repl = self.job_manager.get_node(repl_id)
            if repl is not None and repl.is_alive():
                self.job_manager.retire_node(repl_id)
        obs.event(
            "remediation.rollback",
            node_id=d.node_id, host=d.host,
            replacement_id=repl_id, decision_id=d.decision_id,
        )

    # -- recording ---------------------------------------------------------

    def _record(
        self, d: RemediationDecision, created: bool = True
    ) -> None:
        if created:
            with self._lock:
                self._decisions.append(d)
            # The decision's trace opens: root span, the convicting
            # verdict, the governor gate results, and the action with
            # its immediate outcome (acted / blocked / dry_run /
            # failed).
            self._tspan(
                d, "remediation.decision", d.timestamp,
                span_id=d.span_id, parent="",
                detector=d.detector, host=d.host,
                action=d.action, outcome=d.outcome,
            )
            self._tspan(
                d, "remediation.verdict", d.timestamp,
                detector=d.detector, severity=d.severity,
                trigger=d.trigger,
            )
            self._tspan(
                d, "remediation.governors", d.timestamp,
                **{
                    f"governor_{name}": why
                    for name, why in d.governors.items()
                },
            )
            if d.action:
                self._tspan(
                    d, f"remediation.{d.action}", d.timestamp,
                    outcome=d.outcome, dry_run=d.dry_run,
                )
        else:
            # Finalization: the probation interval and its outcome.
            end = d.resolved_at or self.clock()
            self._tspan(
                d, "remediation.probation", d.timestamp,
                dur=end - d.timestamp,
                outcome=d.outcome,
            )
            self._tspan(
                d, "remediation.outcome", end,
                outcome=d.outcome, note=d.note,
            )
        _DECISIONS_TOTAL.inc(
            detector=d.detector, action=d.action, outcome=d.outcome
        )
        obs.event(
            "remediation.decision",
            decision_id=d.decision_id, detector=d.detector,
            node_id=d.node_id, host=d.host, action=d.action,
            outcome=d.outcome, dry_run=d.dry_run,
            trace_id=d.trace_id, parent_span_id=d.span_id,
        )
        self._persist(d)

    def _persist(self, d: RemediationDecision) -> None:
        """Ship the decision to the brain datastore (best-effort by
        contract): the same channel the health plane persists verdicts
        into, so the policy history is queryable across masters."""
        if self.brain is None:
            return
        persist = getattr(
            self.brain, "persist_remediation_decision", None
        )
        if persist is None:
            return
        try:
            persist(
                job_name=self.job_name,
                decision_id=d.decision_id,
                detector=d.detector,
                node_id=d.node_id,
                host=d.host,
                action=d.action,
                outcome=d.outcome,
                dry_run=int(d.dry_run),
                governors=json.dumps(d.governors, sort_keys=True),
                message=d.trigger,
                timestamp=d.resolved_at or d.timestamp,
            )
        except Exception:  # noqa: BLE001 — a broken datastore must
            # not take remediation down
            logger.warning(
                "brain persistence of remediation decision failed",
                exc_info=True,
            )

    # -- read surface ------------------------------------------------------

    def decisions(self, limit: int = 0) -> List[RemediationDecision]:
        with self._lock:
            items = list(self._decisions)
        return items[-limit:] if limit > 0 else items

    def cordoned_nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._cordoned)

    def probation_failing(self) -> bool:
        """True when remediation is demonstrably NOT helping: an
        active probation is past its deadline without recovery, or a
        finalized failure's subject is still convicted. The
        ``obs_report --health`` probe exits 1 on this."""
        now = self.clock()
        crit_subjects = {
            (v.host, v.node_id)
            for v in self.health.active_verdicts()
            if v.severity == SEVERITY_CRITICAL
        }
        with self._lock:
            for d in self._probation.values():
                if now >= d.probation_deadline:
                    return True
            for d in self._decisions:
                if (
                    d.outcome in (OUTCOME_ROLLED_BACK, OUTCOME_ESCALATED)
                    and d.subject() in crit_subjects
                ):
                    return True
        return False

    def snapshot(self) -> dict:
        """JSON payload for tools (the RPC response's dict shape)."""
        return {
            "enabled": self.enabled,
            "dry_run": self.dry_run,
            "cordoned": self.cordoned_nodes(),
            "probation_failing": self.probation_failing(),
            "decisions": [d.to_dict() for d in self.decisions()],
        }

    def query_response(self, node_id: int = -1, limit: int = 0):
        from dlrover_tpu_torch.common import messages as msg

        decisions = [
            d
            for d in self.decisions()
            if node_id < 0 or d.node_id == node_id
        ]
        if limit > 0:
            decisions = decisions[-limit:]
        return msg.RemediationQueryResponse(
            enabled=self.enabled,
            dry_run=self.dry_run,
            cordoned=self.cordoned_nodes(),
            probation_failing=self.probation_failing(),
            decisions=[
                msg.RemediationDecisionMsg(
                    decision_id=d.decision_id,
                    detector=d.detector,
                    severity=d.severity,
                    node_id=d.node_id,
                    host=d.host,
                    action=d.action,
                    outcome=d.outcome,
                    dry_run=d.dry_run,
                    governors=dict(d.governors),
                    trigger=d.trigger,
                    timestamp=d.timestamp,
                    probation_deadline=d.probation_deadline,
                    note=d.note,
                    trace_id=d.trace_id,
                )
                for d in decisions
            ],
        )

    # -- warm-restart snapshot ---------------------------------------------

    def to_snapshot(self) -> dict:
        """JSON-safe recoverable state: the decision history, cordons,
        probations, escalation ladder, and blast-window stamps — all
        wall-clock based, so cooldowns and probation deadlines keep
        their meaning across a master restart. Hysteresis tick counts
        are deliberately NOT persisted: a fresh master re-earns the
        consecutive-sick evidence before acting (conservative)."""
        with self._lock:
            return {
                "seq": self._seq,
                "decisions": [d.to_dict() for d in self._decisions],
                # Probations serialize FULLY, not by id: the bounded
                # history deque can evict an acted decision while its
                # probation is still open (mass-degradation storms),
                # and a restore that cannot resolve the id would
                # silently drop the probation — stranding the
                # cordoned node with nothing to ever roll it back.
                "probations": [
                    d.to_dict() for d in self._probation.values()
                ],
                "cordoned": {
                    str(k): dict(v) for k, v in self._cordoned.items()
                },
                "ladder": [
                    [host, node_id, rung]
                    for (host, node_id), rung in self._ladder.items()
                ],
                "window": list(self._window),
            }

    def restore_snapshot(self, state: dict) -> None:
        with self._lock:
            self._seq = int(state.get("seq", 0))
            self._decisions.clear()
            by_id: Dict[int, RemediationDecision] = {}
            for d in state.get("decisions", []):
                dec = RemediationDecision.from_dict(d)
                self._decisions.append(dec)
                by_id[dec.decision_id] = dec
            self._probation = {}
            # Healthy-tick streaks restart (the new master must
            # re-observe M healthy ticks itself) — so the deadline
            # must leave room for them: a restart that consumed most
            # of the window would otherwise hit the deadline before
            # recovery_ticks could possibly accrue and roll back a
            # genuinely-recovered remediation. One extra interval of
            # slack: the first tick races the health monitor's first
            # re-evaluate and may still see the journaled (stale)
            # verdict as active.
            grace = (self._cfg("recovery_ticks") + 1) * self.interval
            floor = self.clock() + grace

            def _re_arm(dec: RemediationDecision) -> None:
                dec.healthy_ticks = 0
                dec.probation_deadline = max(
                    dec.probation_deadline, floor
                )
                self._probation[dec.decision_id] = dec

            for pd in state.get("probations", []):
                dec = RemediationDecision.from_dict(pd)
                # Prefer the history's object so decisions() and the
                # probation share one record (outcome updates in both).
                _re_arm(by_id.get(dec.decision_id, dec))
            for pid in state.get("probation_ids", []):  # legacy journals
                dec = by_id.get(int(pid))
                if dec is not None and dec.decision_id not in self._probation:
                    _re_arm(dec)
            self._cordoned = {
                int(k): dict(v)
                for k, v in state.get("cordoned", {}).items()
            }
            self._ladder = {
                (str(host), int(node_id)): int(rung)
                for host, node_id, rung in state.get("ladder", [])
            }
            # Legacy journals carried alert-only as a parallel set;
            # it folds into the terminal ladder rung.
            for host, node_id in state.get("alert_only", []):
                self._ladder[(str(host), int(node_id))] = (
                    RUNG_ALERT_ONLY
                )
            self._window = [
                float(t) for t in state.get("window", [])
            ]
            self._sick = {}
            self._logged = {}
        _CORDONED_NODES.set(len(self._cordoned))
        _PROBATIONS_ACTIVE.set(len(self._probation))


def render_remediation(payload: dict) -> str:
    """Human rendering of a remediation snapshot (``RemediationEngine.
    snapshot()`` or the assembled ``RemediationQueryResponse``) — the
    remediation section of ``obs_report --health``."""
    decisions = list(payload.get("decisions", []))
    cordoned = list(payload.get("cordoned", []))
    mode = "DRY RUN" if payload.get("dry_run") else "active"
    if not payload.get("enabled", True):
        mode = "disabled"
    lines = [
        f"remediation ({mode}): {len(decisions)} decision"
        f"{'' if len(decisions) == 1 else 's'}, "
        f"{len(cordoned)} node(s) cordoned"
        + (f" {cordoned}" if cordoned else "")
    ]
    if payload.get("probation_failing"):
        lines.append(
            "  PROBATION FAILING: an action did not restore health"
        )
    for d in decisions[-10:]:
        subject = d.get("host") or f"node {d.get('node_id')}"
        lines.append(
            f"  #{d.get('decision_id')} "
            f"[{d.get('outcome', '?'):<11}] "
            f"{d.get('detector', '?')} ({subject}) -> "
            f"{d.get('action', '?')}"
            + (" [dry-run]" if d.get("dry_run") else "")
        )
        governors = d.get("governors") or {}
        vetoes = {
            k: v for k, v in governors.items() if v != GOVERNOR_OK
        }
        if vetoes:
            for name, why in sorted(vetoes.items()):
                lines.append(f"      governor {name}: {why}")
        elif governors:
            lines.append(
                "      governors ok: "
                + ", ".join(sorted(governors))
            )
        note = d.get("note") or ""
        if note:
            lines.append(f"      {note}")
    return "\n".join(lines)
