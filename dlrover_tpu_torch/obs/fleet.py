"""Fleet-level metric aggregation on the master.

Each agent periodically ships a ``MetricsSnapshotReport`` — a
serialized dump of its process-local obs registry
(``MetricsRegistry.dump()``) plus resource stats, recent per-step
timings, and new tracer events — over the existing control-plane
channel (``MasterClient.report_metrics_snapshot``, on the
ResourceMonitor cadence). The :class:`FleetAggregator` here merges
those snapshots into the master's registry so the master's
``/metrics`` endpoint and the ``MetricsRequest`` RPC answer for the
*job*, not one process:

* every host series is re-rendered with a ``host`` label
  (``dlrover_train_steps_total{host="w0"} ...``);
* cross-host aggregates (sum/min/max/p50/p90) are computed for the
  key series — step time, tokens/s, data-wait, host-syncs — as
  ``dlrover_fleet_series{series,stat}``;
* snapshots from departed nodes age out after ``ttl`` seconds (and
  are dropped immediately when the master sees the node die), so a
  scrape never shows ghosts.

The aggregator renders through a registry *collector* (see
``MetricsRegistry.add_collector``) instead of writing into typed
metric objects: counters cannot be set backwards, and collector
rendering makes age-out trivially correct — a pruned host simply
stops producing lines.

Event payloads are forwarded to the goodput accountant
(:mod:`dlrover_tpu_torch.obs.goodput`) and per-step timings to the speed
monitor's straggler scorer, which is how trainer-side spans reach the
master's job-level accounting.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.obs.metrics import (
    MetricsRegistry,
    _escape_label_value,
    _format_value,
    get_registry,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs.timeseries import _percentile as _percentile_sorted

logger = get_logger("obs.fleet")

# Key series the fleet view aggregates across hosts, and the stats
# computed for each. Values are per-host scalars extracted from the
# snapshot (see _host_scalar).
KEY_SERIES = (
    "step_time_s",
    "tokens_per_s",
    "data_wait_s_total",
    "host_syncs_total",
    "mfu",
)
STATS = ("sum", "min", "max", "p50", "p90")

DEFAULT_TTL = 90.0  # 3x the default ResourceMonitor cadence


def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) on a sorted copy."""
    return _percentile_sorted(sorted(values), q)


@dataclasses.dataclass
class HostSnapshot:
    host: str
    node_id: int
    wall_ts: float
    received_mono: float
    registry: Dict[str, dict]
    resource: Dict[str, float]
    step_times: List[float]
    # The trainer's last progress stamp (obs/beacon.py record plus the
    # agent-computed ``age_s``); empty when the host runs no beacon.
    beacon: Dict = dataclasses.field(default_factory=dict)


class FleetAggregator:
    """Merges per-host registry snapshots into one fleet view."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        speed_monitor=None,
        goodput=None,
        ttl: float = DEFAULT_TTL,
        attach: bool = True,
        timeseries=None,
        trace_store=None,
    ):
        """``attach=False`` skips hooking :meth:`collect` into the
        registry's render — for owners that cannot guarantee a
        matching :meth:`close` (a collector left on the process-global
        registry would render forever). ``timeseries`` (a
        :class:`~dlrover_tpu_torch.obs.timeseries.TimeSeriesStore`) turns
        every ingest into history: per-host scalars and fleet
        aggregates are recorded so the health detectors can query
        windows instead of instants. ``trace_store`` (a
        :class:`~dlrover_tpu_torch.obs.trace_store.TraceStore`) receives
        any snapshot event that carries a ``trace_id`` — the channel
        by which spans emitted on OTHER hosts join the master's
        assembled trace timelines."""
        self.registry = registry or get_registry()
        self.speed_monitor = speed_monitor
        self.goodput = goodput
        self.timeseries = timeseries
        self.trace_store = trace_store
        self.ttl = ttl
        self._lock = threading.Lock()
        self._hosts: Dict[str, HostSnapshot] = {}
        self._node_to_host: Dict[int, str] = {}
        self._last_fleet_record_ts = -float("inf")
        self._skew_warned: set = set()
        if attach:
            self.registry.add_collector(self.collect)

    def close(self) -> None:
        self.registry.remove_collector(self.collect)

    # -- ingest -----------------------------------------------------------

    def ingest(self, report) -> HostSnapshot:
        """Absorb one ``MetricsSnapshotReport`` (duck-typed: anything
        with host/node_id/timestamp/registry/resource/step_times[/
        events] attributes)."""
        host = str(getattr(report, "host", "") or "")
        node_id = int(getattr(report, "node_id", -1))
        if not host:
            host = f"node{node_id}"
        snap = HostSnapshot(
            host=host,
            node_id=node_id,
            wall_ts=float(getattr(report, "timestamp", 0.0) or time.time()),
            received_mono=time.monotonic(),
            registry=dict(getattr(report, "registry", None) or {}),
            resource=dict(getattr(report, "resource", None) or {}),
            step_times=[
                float(t)
                for t in (getattr(report, "step_times", None) or [])
            ],
            beacon=dict(getattr(report, "beacon", None) or {}),
        )
        with self._lock:
            self._hosts[host] = snap
            if node_id >= 0:
                self._node_to_host[node_id] = host
        if self.speed_monitor is not None and snap.step_times:
            for t in snap.step_times:
                self.speed_monitor.observe_host_step_time(node_id, t)
        events = getattr(report, "events", None) or []
        if self.trace_store is not None and events:
            # Only trace-tagged events are trace material;
            # add_events ignores the rest.
            self.trace_store.add_events(events)
        if self.goodput is not None:
            if events:
                self.goodput.add_events(events)
            # Refresh the goodput gauges even for event-less
            # snapshots: with host tracing off, the accountant's
            # stream is fed by the servicer (step reports, failures)
            # and this is its recompute tick (debounced internally).
            self.goodput.account()
        if self.timeseries is not None:
            self._record_timeseries(snap)
        return snap

    # Snapshot scalar -> time-series name, per host. The cumulative
    # ones (data_wait seconds, host syncs, compiles) are recorded as
    # counters the store's rate() differentiates.
    _TS_SERIES = (
        ("step_time_s", "host.step_time"),
        ("tokens_per_s", "host.tokens_per_s"),
        ("data_wait_s_total", "host.data_wait_s"),
        ("host_syncs_total", "host.host_syncs"),
        ("mfu", "host.mfu"),
    )
    _TS_RESOURCE = ("cpu_percent", "memory_mb", "hbm_used_gb")

    # Minimum snapshot-time seconds between fleet-aggregate history
    # records (per-host series are never debounced).
    FLEET_RECORD_INTERVAL = 5.0

    # Snapshot stamps this far past the master's clock are clamped
    # (generous slack: RPC latency + modest NTP drift, never minutes).
    MAX_FUTURE_SKEW = 30.0

    def _record_timeseries(self, snap: HostSnapshot) -> None:
        """Fold one snapshot into the history store: per-host scalars
        (stamped with the snapshot's wall time, so fake-clock tests
        and late-arriving snapshots land where they belong) plus the
        fleet aggregates as of this ingest."""
        store = self.timeseries
        ts = snap.wall_ts
        # A host clock running ahead of the master would stamp its
        # samples past every detector's query window (anchored at the
        # master's clock) — the host silently vanishes from the
        # health plane, and the fleet-record debounce watermark jumps
        # ahead, muting everyone else. Clamp future stamps to "now"
        # (past stamps stay put: a late arrival and a backdated test
        # snapshot are indistinguishable and both legitimate).
        now = store.clock()
        if ts > now + self.MAX_FUTURE_SKEW:
            with self._lock:
                warn = snap.host not in self._skew_warned
                self._skew_warned.add(snap.host)
            if warn:
                logger.warning(
                    "host %s snapshot stamped %.0fs in the master's "
                    "future; clamping its history stamps (check NTP)",
                    snap.host, ts - now,
                )
            ts = now
        for series, name in self._TS_SERIES:
            v = self._host_scalar(snap, series)
            if v is not None:
                store.record(name, v, ts=ts, host=snap.host)
        for key in self._TS_RESOURCE:
            v = snap.resource.get(key)
            if v is not None:
                store.record(
                    f"host.{key}", float(v), ts=ts, host=snap.host
                )
        compiles = self._compile_total(snap)
        if compiles is not None:
            store.record(
                "host.compiles", compiles, ts=ts, host=snap.host
            )
        if snap.beacon:
            # Progress-vector history for the stall correlator: step
            # is a counter-shaped series (monotone while healthy),
            # age the agent-observed staleness at snapshot time.
            step = snap.beacon.get("step")
            if isinstance(step, (int, float)):
                store.record(
                    "host.beacon_step", float(step), ts=ts,
                    host=snap.host,
                )
            age = snap.beacon.get("age_s")
            if isinstance(age, (int, float)) and age >= 0:
                store.record(
                    "host.beacon_age_s", float(age), ts=ts,
                    host=snap.host,
                )
        # Fleet aggregates walk every live snapshot; recording them
        # on every per-host ingest is O(hosts^2) per collect interval
        # and floods the window with near-identical duplicates, so
        # debounce to once per FLEET_RECORD_INTERVAL of snapshot time.
        # Check-and-advance the watermark under the lock: concurrent
        # ingest RPCs must elect exactly one recorder per interval
        # (aggregates() takes the same lock, so it stays outside).
        with self._lock:
            record_fleet = (
                ts - self._last_fleet_record_ts
                >= self.FLEET_RECORD_INTERVAL
            )
            if record_fleet:
                self._last_fleet_record_ts = ts
        if record_fleet:
            for series, stats in self.aggregates().items():
                for stat, value in stats.items():
                    store.record(
                        f"fleet.{series}", value, ts=ts, stat=stat
                    )

    @staticmethod
    def _compile_total(snap: HostSnapshot) -> Optional[float]:
        """Total (re)compiles the host's CompileTracker counted, from
        its shipped registry dump (sum over the per-fn series)."""
        md = snap.registry.get("dlrover_compile_total")
        if not md or md.get("type") != "counter":
            return None
        return float(sum(row[1] for row in md.get("series", [])))

    def node_for_host(self, host: str) -> Optional[int]:
        """The node id behind a host label, for detectors that queue
        actions on the node's heartbeat FIFO."""
        with self._lock:
            for node_id, h in self._node_to_host.items():
                if h == host:
                    return node_id
        return None

    def host_node_map(self) -> Dict[str, int]:
        """host label -> node id, inverted in one locked pass — for
        callers (the health tick) that would otherwise pay an
        O(hosts) :meth:`node_for_host` scan per host."""
        with self._lock:
            return {h: n for n, h in self._node_to_host.items()}

    def remove_node(self, node_id: int) -> None:
        """Drop a departed node's snapshot immediately (the TTL is
        only the backstop for nodes that die without a master event)."""
        with self._lock:
            host = self._node_to_host.pop(node_id, None)
            if host is not None:
                self._hosts.pop(host, None)
        if host is not None and self.timeseries is not None:
            # Its history goes too: a dead host's stale series must
            # not keep convicting (or acquitting) the live fleet.
            self.timeseries.drop_label("host", host)

    def remove_host(self, host: str) -> None:
        with self._lock:
            snap = self._hosts.pop(host, None)
            if snap is not None:
                self._node_to_host.pop(snap.node_id, None)
        if snap is not None and self.timeseries is not None:
            self.timeseries.drop_label("host", host)

    def _live_locked(self) -> List[HostSnapshot]:
        now = time.monotonic()
        stale = [
            h
            for h, s in self._hosts.items()
            if now - s.received_mono > self.ttl
        ]
        for h in stale:
            snap = self._hosts.pop(h)
            self._node_to_host.pop(snap.node_id, None)
        return list(self._hosts.values())

    def live_snapshots(self) -> List[HostSnapshot]:
        with self._lock:
            return self._live_locked()

    def hosts(self) -> List[str]:
        return sorted(s.host for s in self.live_snapshots())

    # -- aggregation ------------------------------------------------------

    @staticmethod
    def _host_scalar(snap: HostSnapshot, series: str) -> Optional[float]:
        def hist(name):
            md = snap.registry.get(name)
            if not md or md.get("type") != "histogram":
                return None
            total = sum(row[2] for row in md.get("series", []))
            count = sum(row[3] for row in md.get("series", []))
            return total, count

        if series == "step_time_s":
            if snap.step_times:
                return sum(snap.step_times) / len(snap.step_times)
            h = hist("dlrover_train_step_seconds")
            if h and h[1] > 0:
                return h[0] / h[1]
            return None
        if series == "tokens_per_s":
            v = snap.resource.get("tokens_per_s")
            return float(v) if v is not None else None
        if series == "mfu":
            # Shipped via the trainer's step-metrics file -> the
            # agent snapshot's resource dict (monitor.build_snapshot).
            v = snap.resource.get("mfu")
            return float(v) if v is not None else None
        if series == "data_wait_s_total":
            h = hist("dlrover_train_data_wait_seconds")
            return h[0] if h else None
        if series == "host_syncs_total":
            md = snap.registry.get("dlrover_train_host_syncs_total")
            if not md or md.get("type") != "counter":
                return None
            return float(
                sum(row[1] for row in md.get("series", []))
            )
        return None

    def aggregates(self) -> Dict[str, Dict[str, float]]:
        """``{series: {stat: value}}`` over live hosts; a series with
        no reporting host is omitted."""
        snaps = self.live_snapshots()
        out: Dict[str, Dict[str, float]] = {}
        for series in KEY_SERIES:
            values = [
                v
                for v in (
                    self._host_scalar(s, series) for s in snaps
                )
                if v is not None
            ]
            if not values:
                continue
            out[series] = {
                "sum": sum(values),
                "min": min(values),
                "max": max(values),
                "p50": _percentile(values, 50.0),
                "p90": _percentile(values, 90.0),
            }
        return out

    # -- exposition -------------------------------------------------------

    def _series_line(
        self,
        name: str,
        key: List[str],
        labelnames: List[str],
        value: float,
        host: str,
        suffix: str = "",
        extra: str = "",
    ) -> str:
        pairs = [
            f'{ln}="{_escape_label_value(lv)}"'
            for ln, lv in zip(labelnames, key)
        ]
        pairs.append(f'host="{_escape_label_value(host)}"')
        if extra:
            pairs.append(extra)
        return (
            f"{name}{suffix}{{{','.join(pairs)}}} "
            f"{_format_value(value)}"
        )

    def _metric_lines(
        self, name: str, md: dict, host: str
    ) -> List[str]:
        labelnames = list(md.get("labelnames", []))
        mtype = md.get("type", "gauge")
        lines: List[str] = []
        if mtype in ("counter", "gauge"):
            for key, value in md.get("series", []):
                lines.append(
                    self._series_line(
                        name, list(key), labelnames, float(value), host
                    )
                )
            return lines
        if mtype == "histogram":
            bounds = [float(b) for b in md.get("buckets", [])]
            bounds.append(float("inf"))
            for key, counts, total, count in md.get("series", []):
                for bound, c in zip(bounds, counts):
                    lines.append(
                        self._series_line(
                            name, list(key), labelnames, float(c),
                            host, suffix="_bucket",
                            extra=f'le="{_format_value(bound)}"',
                        )
                    )
                lines.append(
                    self._series_line(
                        name, list(key), labelnames, float(total),
                        host, suffix="_sum",
                    )
                )
                lines.append(
                    self._series_line(
                        name, list(key), labelnames, float(count),
                        host, suffix="_count",
                    )
                )
        return lines

    def collect(self) -> List[str]:
        """Registry collector: host-labeled series + fleet aggregates.
        Runs inside ``registry.render()`` for every scrape."""
        snaps = self.live_snapshots()
        lines: List[str] = []
        # TYPE headers only for names the master registry does not
        # already expose (those already got their header above us).
        known = set(self.registry.names())
        typed: set = set()
        for snap in sorted(snaps, key=lambda s: s.host):
            for name in sorted(snap.registry):
                md = snap.registry[name]
                if name not in known and name not in typed:
                    help_ = str(md.get("help", "") or "")
                    if help_:
                        lines.append(f"# HELP {name} {help_}")
                    lines.append(
                        f"# TYPE {name} {md.get('type', 'gauge')}"
                    )
                    typed.add(name)
                lines.extend(self._metric_lines(name, md, snap.host))
        lines.append(
            "# TYPE dlrover_fleet_hosts gauge"
        )
        lines.append(f"dlrover_fleet_hosts {len(snaps)}")
        aggs = self.aggregates()
        if aggs:
            lines.append("# TYPE dlrover_fleet_series gauge")
            for series in sorted(aggs):
                for stat in STATS:
                    lines.append(
                        f'dlrover_fleet_series{{series="{series}",'
                        f'stat="{stat}"}} '
                        f"{_format_value(aggs[series][stat])}"
                    )
        return lines
