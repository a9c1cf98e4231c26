"""Cross-host stall localization over the fleet's progress beacons.

When one worker wedges inside a collective, every peer blocks in the
same ``psum`` and — to every *per-host* probe built so far — all N
hosts look identically stuck. The missing signal is relative
progress: the N−1 healthy hosts are parked at the *entry* of step
K's collective (their beacons stamped dispatch-of-step-K just before
blocking), while the wedged host h never got there — its last stamp
sits at an earlier phase or an earlier step. This module is the
master-side correlator that turns the fleet's shipped beacon stamps
(:mod:`dlrover_tpu_torch.obs.beacon`, ridden in on every
``MetricsSnapshotReport``) into exactly that comparison.

Decision table, evaluated on the HealthMonitor tick (a host is
*stalled* once its effective beacon age exceeds ``stall_after_s``
for ``stall_ticks`` consecutive ticks; a beacon that advances resets
its streak, so a flapping beacon never convicts):

==============================  ======================================
fleet state                     verdict
==============================  ======================================
no host stalled                 none (open incident resolves)
some but not all stalled        none (a true collective stall parks
                                everyone within one step; partial
                                staleness is transient/restart noise)
all stalled, one host strictly  ``collective_stall`` CRITICAL on that
behind every peer               host — the localized culprit; feeds
                                the remediation ladder's
                                cordon-replace rung
all stalled at the same spot    ``fleet_stall`` CRITICAL, job subject
(or several tied behind)        (data/master problem — nobody is
                                convicted); if a *silent* node (no
                                heartbeat) explains it, that node is
                                recorded as the attributed suspect and
                                the ``heartbeat_gap`` verdict upgrade
                                carries DIAGNOSE
==============================  ======================================

On the first stalled tick that opens an incident the correlator also:

* mints a hang-incident trace in the TraceStore — a ``stall.incident``
  root span with one ``stall.progress`` child per host (step / phase /
  microbatch / age tags) and one ``stall.capture`` child per queued
  capture — queryable via ``obs_report --trace <incident-id>``;
* queues the **coordinated capture**: DIAGNOSE + PROFILE pushed to
  *every* host's heartbeat FIFO inside one loop (dedupe keys
  ``stall:<incident>:<action>:<node>`` make replays idempotent), so
  the resulting forensics bundles are a simultaneous fleet snapshot
  of who waits on whom.

The incident (plus the rolling per-host progress table) is served
over ``StallQueryRequest`` / ``obs_report --stall``; the rc contract
there is 1 while an incident is open, 0 after resolution.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import EventAction
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs.beacon import BEACON_PHASES, progress_key
from dlrover_tpu_torch.obs.health import (
    SEVERITY_CRITICAL,
    HealthVerdict,
)

logger = get_logger("obs.stall")

STALL_ENV_PREFIX = "DLROVER_TPU_STALL_"

DEFAULTS: Dict[str, float] = {
    # Effective beacon age (agent-observed staleness + snapshot age at
    # the master) before a host counts as stalled. Must sit above any
    # sane step time AND above one ResourceMonitor cadence.
    "stall_after_s": 120.0,
    # Consecutive stalled ticks before any verdict: one tick of
    # staleness is snapshot jitter, not a stall.
    "stall_ticks": 2.0,
    # Minimum seconds between coordinated capture rounds (a flapping
    # incident must not hammer every host's FIFO).
    "capture_cooldown_s": 300.0,
    # Closed incidents retained for --stall / --postmortem.
    "incident_history": 16.0,
}

_INCIDENTS_TOTAL = obs.counter(
    "dlrover_stall_incidents_total",
    "Stall incidents opened by the master's correlator, by kind "
    "(laggard = localized single-host culprit, fleet_wide = "
    "everyone parked at the same spot)",
    ("kind",),
)
_OPEN_INCIDENT = obs.gauge(
    "dlrover_stall_open_incident",
    "1 while a stall incident is open, else 0 (the obs_report "
    "--stall rc contract reads the same state)",
)
_BEACON_HOSTS = obs.gauge(
    "dlrover_stall_beacon_hosts",
    "Hosts currently shipping a progress beacon in their fleet "
    "snapshots",
)
_CAPTURES_TOTAL = obs.counter(
    "dlrover_stall_captures_total",
    "Coordinated-capture actions the correlator queued to host "
    "heartbeat FIFOs, by action (diagnose / profile)",
    ("action",),
)

KIND_LAGGARD = "laggard"
KIND_FLEET_WIDE = "fleet_wide"


def _phase_name(idx: int) -> str:
    if 0 <= idx < len(BEACON_PHASES):
        return BEACON_PHASES[idx]
    return "init"


class StallCorrelator:
    """Aligns per-host progress vectors; localizes collective stalls.

    ``fleet`` is anything with ``live_snapshots()`` returning objects
    with host/node_id/wall_ts/beacon attributes (the
    FleetAggregator); ``capture`` is the coordinated-capture sink
    ``(node_id, action, dedupe_key) -> bool`` (the servicer's
    ``push_action``); ``traces`` a TraceStore; ``diagnostics`` an
    optional ``node_id -> [DiagnosticsReport-like]`` probe used to
    cross-link capture bundle paths into the served snapshot;
    ``silent_probe`` an optional ``() -> {node_id: heartbeat_age}``
    over nodes already past their critical heartbeat fraction
    (:meth:`~dlrover_tpu_torch.obs.health.HealthMonitor.attach_stall`
    wires it). The clock is injectable and everything is evaluated
    on the caller's tick — hermetically testable with a fake clock.
    """

    def __init__(
        self,
        fleet=None,
        traces=None,
        capture: Optional[Callable[..., bool]] = None,
        diagnostics: Optional[Callable[[int], list]] = None,
        silent_probe: Optional[Callable[[], Dict[int, float]]] = None,
        clock: Callable[[], float] = time.time,
        config: Optional[Dict[str, float]] = None,
    ):
        self.fleet = fleet
        self.traces = traces
        self.capture = capture
        self.diagnostics = diagnostics
        self.silent_probe = silent_probe
        self.clock = clock
        self._config = dict(config or {})
        self._lock = threading.Lock()
        # host -> last progress key / consecutive stalled ticks /
        # last rendered row (the --stall progress table).
        self._progress: Dict[str, Tuple[int, int, int]] = {}
        self._stalled_ticks: Dict[str, int] = {}
        self._rows: Dict[str, dict] = {}
        self._incident: Optional[dict] = None
        self._incidents: deque = deque(
            maxlen=max(int(self._cfg("incident_history")), 1)
        )
        self._seq = 0
        self._last_capture_ts = -float("inf")
        # Node ids a fleet-wide stall is attributed to because they
        # went heartbeat-silent — read by _detect_heartbeat_gap's
        # DIAGNOSE upgrade.
        self.silent_suspects: set = set()
        _OPEN_INCIDENT.set(0)

    def _cfg(self, knob: str) -> float:
        if knob in self._config:
            return float(self._config[knob])
        env = os.getenv(STALL_ENV_PREFIX + knob.upper(), "")
        if env:
            try:
                return float(env)
            except ValueError:
                logger.warning(
                    "bad %s%s=%r; using default %s",
                    STALL_ENV_PREFIX, knob.upper(), env,
                    DEFAULTS[knob],
                )
        return DEFAULTS[knob]

    # -- per-tick evaluation ----------------------------------------------

    def _gather(self, now: float) -> Dict[str, dict]:
        """The current beacon table: one row per live beacon-shipping
        host, with the master-side effective staleness (agent-observed
        age + how long ago the snapshot itself was taken)."""
        rows: Dict[str, dict] = {}
        if self.fleet is None:
            return rows
        for snap in self.fleet.live_snapshots():
            stamp = getattr(snap, "beacon", None) or {}
            if not stamp:
                continue
            age = stamp.get("age_s")
            age = (
                float(age)
                if isinstance(age, (int, float)) and age >= 0
                else 0.0
            )
            key = progress_key(stamp)
            rows[snap.host] = {
                "host": snap.host,
                "node_id": int(getattr(snap, "node_id", -1)),
                "step": key[0],
                "phase": _phase_name(key[1]),
                "phase_idx": key[1],
                "microbatch": key[2],
                "age_s": round(
                    age + max(now - float(snap.wall_ts or now), 0.0), 3
                ),
                "key": key,
            }
        return rows

    def evaluate(self) -> List[HealthVerdict]:
        """One correlator tick — runs as a HealthMonitor detector, so
        its verdicts get the engine's full lifecycle (transition
        history, action cooldowns, resolution, persistence)."""
        now = self.clock()
        rows = self._gather(now)
        stall_after = self._cfg("stall_after_s")
        need_ticks = max(int(self._cfg("stall_ticks")), 1)
        with self._lock:
            for host in list(self._stalled_ticks):
                if host not in rows:
                    # Departed host: its streak must not outlive its
                    # series (fleet drop_label purges history; this
                    # purges the conviction state).
                    self._stalled_ticks.pop(host, None)
                    self._progress.pop(host, None)
            for host, row in rows.items():
                prev = self._progress.get(host)
                if prev is not None and row["key"] > prev:
                    # Progress since last tick: a flapping beacon
                    # resets its streak and never convicts.
                    self._stalled_ticks[host] = 0
                elif row["age_s"] >= stall_after:
                    self._stalled_ticks[host] = (
                        self._stalled_ticks.get(host, 0) + 1
                    )
                else:
                    self._stalled_ticks[host] = 0
                self._progress[host] = row["key"]
                row["stalled_ticks"] = self._stalled_ticks[host]
                row["stalled"] = (
                    self._stalled_ticks[host] >= need_ticks
                )
            self._rows = {
                h: {k: v for k, v in r.items() if k != "key"}
                for h, r in rows.items()
            }
        _BEACON_HOSTS.set(len(rows))
        stalled = {h: r for h, r in rows.items() if r["stalled"]}
        if not stalled or len(stalled) < len(rows):
            # Nobody (or not everybody) is parked: a true collective
            # stall blocks the whole fleet within one step.
            self._resolve_incident(now)
            self.silent_suspects = set()
            return []
        return self._verdicts_for_stall(now, rows)

    def _verdicts_for_stall(
        self, now: float, rows: Dict[str, dict]
    ) -> List[HealthVerdict]:
        min_key = min(r["key"] for r in rows.values())
        behind = [h for h, r in rows.items() if r["key"] == min_key]
        localized = len(rows) >= 2 and len(behind) == 1
        suspects: Dict[int, float] = {}
        if not localized and self.silent_probe is not None:
            try:
                suspects = dict(self.silent_probe() or {})
            except Exception:  # noqa: BLE001 — a probe bug must not
                # kill the evaluation tick
                logger.warning("silent probe failed", exc_info=True)
        self.silent_suspects = set(suspects)
        if localized:
            culprit = behind[0]
            kind, culprit_row = KIND_LAGGARD, rows[culprit]
        else:
            culprit, culprit_row, kind = "", None, KIND_FLEET_WIDE
        incident = self._ensure_incident(
            now, kind, culprit, rows, suspects
        )
        peers = [r for h, r in rows.items() if h != culprit]
        peer_step = max((r["step"] for r in peers), default=0)
        if localized:
            ages = culprit_row["age_s"]
            message = (
                f"host {culprit} wedged at step {culprit_row['step']} "
                f"{culprit_row['phase']}"
                + (
                    f" microbatch {culprit_row['microbatch']}"
                    if culprit_row["microbatch"] >= 0
                    else ""
                )
                + f" (beacon stale {ages:.0f}s) while {len(peers)} "
                f"peer(s) sit parked at step {peer_step} collective "
                f"entry — incident {incident['id']}"
            )
            verdict = HealthVerdict(
                detector="collective_stall",
                severity=SEVERITY_CRITICAL,
                message=message,
                node_id=culprit_row["node_id"],
                host=culprit,
                suggested_action=EventAction.DIAGNOSE.value,
                evidence_series="host.beacon_step",
                evidence=[(now, float(culprit_row["step"]))],
                metrics={
                    "hosts": float(len(rows)),
                    "culprit_step": float(culprit_row["step"]),
                    "culprit_phase_idx": float(
                        culprit_row["phase_idx"]
                    ),
                    "peer_step": float(peer_step),
                    "beacon_age_s": float(culprit_row["age_s"]),
                },
                timestamp=now,
            )
        else:
            min_age = min(r["age_s"] for r in rows.values())
            message = (
                f"fleet-wide stall: all {len(rows)} beacon host(s) "
                f"parked at step {min_key[0]} "
                f"{_phase_name(min_key[1])} for {min_age:.0f}s — "
                f"incident {incident['id']}"
            )
            if suspects:
                silent = ", ".join(
                    f"node {n} ({a:.0f}s silent)"
                    for n, a in sorted(suspects.items())
                )
                message += f"; attributed to silent {silent}"
            verdict = HealthVerdict(
                detector="fleet_stall",
                severity=SEVERITY_CRITICAL,
                message=message,
                node_id=-1,
                host="",
                suggested_action="",
                evidence_series="host.beacon_age_s",
                evidence=[
                    (now, float(min(r["age_s"] for r in rows.values())))
                ],
                metrics={
                    "hosts": float(len(rows)),
                    "fleet_step": float(min_key[0]),
                    "silent_nodes": float(len(suspects)),
                },
                timestamp=now,
            )
        return [verdict]

    # -- incident lifecycle -----------------------------------------------

    def _ensure_incident(
        self,
        now: float,
        kind: str,
        culprit: str,
        rows: Dict[str, dict],
        suspects: Dict[int, float],
    ) -> dict:
        with self._lock:
            inc = self._incident
            if inc is not None:
                # Re-localization mid-incident (e.g. the fleet split
                # only became visible a tick later) updates the
                # subject; the incident identity stays.
                if kind == KIND_LAGGARD and inc["kind"] != kind:
                    inc["kind"] = kind
                    inc["culprit"] = culprit
                    inc["culprit_node"] = rows[culprit]["node_id"]
                inc["silent_nodes"] = sorted(suspects)
                return inc
            self._seq += 1
            inc_id = f"stall-{int(now)}-{self._seq}"
            inc = {
                "id": inc_id,
                "trace_id": inc_id,
                "kind": kind,
                "culprit": culprit,
                "culprit_node": (
                    rows[culprit]["node_id"] if culprit else -1
                ),
                "opened_ts": now,
                "resolved_ts": 0.0,
                "silent_nodes": sorted(suspects),
                "hosts": {
                    h: {
                        k: r[k]
                        for k in (
                            "node_id", "step", "phase",
                            "microbatch", "age_s",
                        )
                    }
                    for h, r in rows.items()
                },
                "captures": {},
            }
            self._incident = inc
        _INCIDENTS_TOTAL.inc(kind=kind)
        _OPEN_INCIDENT.set(1)
        obs.event(
            "stall.incident",
            incident=inc_id,
            kind=kind,
            culprit=culprit,
            hosts=len(rows),
        )
        logger.warning(
            "stall incident %s opened (%s%s): %d host(s) parked",
            inc_id, kind, f", culprit {culprit}" if culprit else "",
            len(rows),
        )
        self._mint_trace(inc, rows, now)
        self._coordinated_capture(inc, rows, now)
        return inc

    def _mint_trace(
        self, inc: dict, rows: Dict[str, dict], now: float
    ) -> None:
        if self.traces is None:
            return
        tid = inc["trace_id"]
        root = f"{tid}:root"
        self.traces.add_span(
            tid,
            "stall.incident",
            start_ts=now,
            span_id=root,
            kind=inc["kind"],
            culprit=inc["culprit"],
            hosts=len(rows),
            subject="stall",
        )
        for host, r in sorted(rows.items()):
            self.traces.add_span(
                tid,
                "stall.progress",
                start_ts=now,
                span_id=f"{tid}:h:{host}",
                parent_span_id=root,
                host=host,
                node_id=r["node_id"],
                step=r["step"],
                phase=r["phase"],
                microbatch=r["microbatch"],
                age_s=r["age_s"],
                culprit=(host == inc["culprit"]),
            )

    def _coordinated_capture(
        self, inc: dict, rows: Dict[str, dict], now: float
    ) -> None:
        """DIAGNOSE + PROFILE to every host's heartbeat FIFO in one
        loop — the fleet snapshot is only useful if the bundles are
        (near-)simultaneous, so all pushes happen inside one tick.
        Dedupe keys make a replay (warm restart, RPC retry) a no-op."""
        if self.capture is None:
            return
        if now - self._last_capture_ts < self._cfg("capture_cooldown_s"):
            return
        self._last_capture_ts = now
        actions = (
            EventAction.DIAGNOSE.value,
            EventAction.PROFILE.value,
        )
        for host, r in sorted(rows.items()):
            node_id = r["node_id"]
            if node_id < 0:
                continue
            queued = []
            for action in actions:
                try:
                    ok = self.capture(
                        node_id,
                        action,
                        dedupe_key=(
                            f"stall:{inc['id']}:{action}:{node_id}"
                        ),
                    )
                except Exception:  # noqa: BLE001 — a push failure on
                    # one host must not abort the fleet round
                    logger.warning(
                        "capture push %s -> node %d failed",
                        action, node_id, exc_info=True,
                    )
                    ok = False
                if ok:
                    queued.append(action)
                    _CAPTURES_TOTAL.inc(action=action)
            with self._lock:
                inc["captures"][host] = {
                    "node_id": node_id,
                    "queued": queued,
                }
            if self.traces is not None:
                self.traces.add_span(
                    inc["trace_id"],
                    "stall.capture",
                    start_ts=now,
                    span_id=f"{inc['trace_id']}:cap:{host}",
                    parent_span_id=f"{inc['trace_id']}:root",
                    host=host,
                    node_id=node_id,
                    actions=",".join(queued) or "none",
                )

    def _resolve_incident(self, now: float) -> None:
        with self._lock:
            inc, self._incident = self._incident, None
            if inc is None:
                return
            inc["resolved_ts"] = now
            self._incidents.append(inc)
        _OPEN_INCIDENT.set(0)
        obs.event(
            "stall.resolved",
            incident=inc["id"],
            kind=inc["kind"],
            culprit=inc["culprit"],
            open_s=round(now - inc["opened_ts"], 3),
        )
        logger.info(
            "stall incident %s resolved after %.0fs",
            inc["id"], now - inc["opened_ts"],
        )
        if self.traces is not None:
            self.traces.add_span(
                inc["trace_id"],
                "stall.resolved",
                start_ts=now,
                span_id=f"{inc['trace_id']}:resolved",
                parent_span_id=f"{inc['trace_id']}:root",
                open_s=round(now - inc["opened_ts"], 3),
            )

    # -- read surface ------------------------------------------------------

    def _bundles_for(self, inc: dict) -> Dict[str, list]:
        """Capture bundles that answered this incident, per host —
        diagnostics reports filed at/after the incident opened (small
        slack for clock skew between filing and opening)."""
        if self.diagnostics is None:
            return {}
        out: Dict[str, list] = {}
        since = inc["opened_ts"] - 5.0
        for host, cap in inc.get("captures", {}).items():
            try:
                reports = self.diagnostics(cap["node_id"]) or []
            except Exception:  # noqa: BLE001
                continue
            rows = []
            for r in reports:
                ts = float(getattr(r, "timestamp", 0.0) or 0.0)
                if ts < since:
                    continue
                rows.append(
                    {
                        "kind": str(getattr(r, "kind", "")),
                        "bundle_path": str(
                            getattr(r, "bundle_path", "")
                        ),
                        "timestamp": ts,
                    }
                )
            if rows:
                out[host] = rows
        return out

    def open_incident(self) -> Optional[dict]:
        with self._lock:
            return dict(self._incident) if self._incident else None

    def snapshot(self) -> dict:
        """The ``StallQueryResponse`` payload: rolling per-host
        progress table, open incident (bundle paths cross-linked),
        recent closed incidents, and the effective knobs."""
        with self._lock:
            hosts = {h: dict(r) for h, r in self._rows.items()}
            incident = dict(self._incident) if self._incident else {}
            history = [dict(i) for i in self._incidents]
        if incident:
            incident["bundles"] = self._bundles_for(incident)
        return {
            "now": self.clock(),
            "hosts": hosts,
            "incident": incident,
            "incidents": history,
            "config": {
                k: self._cfg(k) for k in sorted(DEFAULTS)
            },
        }


def render_stall(payload: dict) -> str:
    """Human rendering of a stall snapshot — the body of
    ``obs_report --stall``."""
    hosts = payload.get("hosts", {}) or {}
    incident = payload.get("incident", {}) or {}
    history = payload.get("incidents", []) or []
    lines = [
        f"stall localization: {len(hosts)} beacon host(s), "
        + (
            f"incident {incident.get('id', '?')} OPEN"
            if incident
            else "no open incident"
        )
    ]
    if hosts:
        lines.append(
            "  host             node  step    mb  phase            "
            "age_s  state"
        )
        for host in sorted(hosts):
            r = hosts[host]
            state = (
                "STALLED" if r.get("stalled")
                else ("ok" if not r.get("stalled_ticks") else "stale")
            )
            lines.append(
                f"  {host:<15.15s} {r.get('node_id', -1):>5} "
                f"{r.get('step', 0):>5} {r.get('microbatch', -1):>5} "
                f"{str(r.get('phase', '?')):<16.16s} "
                f"{r.get('age_s', 0.0):>6.0f}  {state}"
            )
    else:
        lines.append("  (no host is shipping a progress beacon)")

    def _inc_lines(inc: dict, head: str) -> List[str]:
        out = [
            f"{head} {inc.get('id', '?')}: {inc.get('kind', '?')}"
            + (
                f", culprit {inc['culprit']}"
                f" (node {inc.get('culprit_node', -1)})"
                if inc.get("culprit")
                else ""
            )
            + f", trace {inc.get('trace_id', '?')}"
        ]
        for host in sorted(inc.get("hosts", {})):
            r = inc["hosts"][host]
            mark = " <- culprit" if host == inc.get("culprit") else ""
            out.append(
                f"    {host}: step {r.get('step')} "
                f"{r.get('phase')} mb {r.get('microbatch')} "
                f"(age {r.get('age_s', 0.0):.0f}s){mark}"
            )
        if inc.get("silent_nodes"):
            out.append(
                "    silent node(s): "
                + ", ".join(str(n) for n in inc["silent_nodes"])
            )
        for host in sorted(inc.get("captures", {})):
            cap = inc["captures"][host]
            out.append(
                f"    capture -> {host} (node {cap.get('node_id')}): "
                f"queued {','.join(cap.get('queued', [])) or 'none'}"
            )
        for host in sorted(inc.get("bundles", {}) or {}):
            for b in inc["bundles"][host]:
                out.append(
                    f"    bundle [{b.get('kind')}] {host}: "
                    f"{b.get('bundle_path') or '(digest only)'}"
                )
        return out

    if incident:
        lines.extend(_inc_lines(incident, "  open incident"))
    for inc in reversed(history[-3:]):
        dur = max(
            inc.get("resolved_ts", 0.0) - inc.get("opened_ts", 0.0),
            0.0,
        )
        lines.extend(
            _inc_lines(
                inc, f"  resolved after {dur:.0f}s —"
            )
        )
    return "\n".join(lines)
