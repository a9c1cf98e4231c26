"""Pool capacity accounting: per-tenant chip-second interval ledger.

The pool (PR 14) schedules multi-tenant gangs but, until this plane,
could not answer the capacity-planning question the brain needs
(ROADMAP item 5): *what did tenant A's slices produce per chip-second,
and how much of the pool burned idle, preempting, or recovering?*

:class:`CapacityLedger` records every slice's state timeline as
timestamped intervals::

    idle | allocated{tenant,job} | preempting | draining | restoring

fed by hooks in :mod:`dlrover_tpu_torch.pool.slice_pool` (allocate/release)
and :mod:`dlrover_tpu_torch.pool.scheduler` (preemption park, resume
placement, cancel drain). Accounting is *settle-based*: a slice's
open interval accrues ``chips x elapsed`` into its ``(tenant, state)``
cell exactly when it closes, so at any instant the closed cells plus
the open accruals partition ``total_chips x elapsed`` exactly — the
same partition discipline as the step-phase profiler, asserted by the
acceptance drill.

Joining the ledger with each pool job's ``GoodputAccountant`` ratio
(:meth:`CapacityLedger.observe_goodput`, fed by the pool master's
watch tick) yields per-tenant **productive** chip-seconds and
goodput-per-chip. Closed intervals and tenant rollups persist to the
brain datastore (``capacity_intervals`` / ``tenant_goodput`` tables)
so the future capacity brain warm-starts from history; per-job series
are purged from the :class:`TimeSeriesStore` when a job retires
(:meth:`CapacityLedger.retire_job`), the same way departed hosts are
purged, so long-lived pool masters never accumulate dead-tenant
series toward the store's series cap.

Exported metrics (see tests/test_obs.py's hygiene audit)::

    dlrover_pool_chip_seconds_total{tenant,state}   counter
    dlrover_tenant_goodput_per_chip{tenant}         gauge
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("obs.capacity")

STATE_IDLE = "idle"
STATE_ALLOCATED = "allocated"
STATE_PREEMPTING = "preempting"
STATE_DRAINING = "draining"
STATE_RESTORING = "restoring"
STATES = (
    STATE_IDLE,
    STATE_ALLOCATED,
    STATE_PREEMPTING,
    STATE_DRAINING,
    STATE_RESTORING,
)

# States in which a tenant *holds* chips without producing: the
# overhead the brain subtracts when it scores goodput-per-chip.
OVERHEAD_STATES = (STATE_PREEMPTING, STATE_DRAINING, STATE_RESTORING)

# The tenant label of idle capacity. A real dash-tenant cannot exist:
# pool tenants come from PoolJobSpec which defaults "default".
IDLE_TENANT = "-"

# Closed intervals kept in memory for snapshots/renderers; the brain
# table is the durable history.
INTERVAL_RETENTION = 512

_CHIP_SECONDS = obs.counter(
    "dlrover_pool_chip_seconds_total",
    "Chip-seconds accrued by pool capacity per tenant and slice "
    "state (idle capacity carries tenant '-')",
    ("tenant", "state"),
)
_GOODPUT_PER_CHIP = obs.gauge(
    "dlrover_tenant_goodput_per_chip",
    "Chips-weighted goodput ratio across a tenant's placed pool "
    "jobs (most recent observation)",
    ("tenant",),
)


@dataclasses.dataclass(frozen=True)
class SliceInterval:
    """One closed segment of one slice's state timeline."""

    slice_id: int
    state: str
    tenant: str
    job_id: str
    start_ts: float
    end_ts: float
    chips: int

    @property
    def chip_seconds(self) -> float:
        return max(self.end_ts - self.start_ts, 0.0) * self.chips

    def to_dict(self) -> dict:
        return {
            "slice_id": self.slice_id,
            "state": self.state,
            "tenant": self.tenant,
            "job_id": self.job_id,
            "start_ts": round(self.start_ts, 3),
            "end_ts": round(self.end_ts, 3),
            "chips": self.chips,
            "chip_seconds": round(self.chip_seconds, 3),
        }


class _JobAccount:
    """Per-job goodput accrual state (ledger-internal)."""

    __slots__ = ("tenant", "slices", "chips", "ratio", "mark",
                 "productive")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.slices: List[int] = []
        self.chips = 0
        self.ratio = 0.0
        # Wall stamp productive accrual is settled up to; None while
        # the job holds no allocated-state chips (preempted, parked,
        # restoring) so overhead intervals never count as productive.
        self.mark: Optional[float] = None
        self.productive = 0.0


class CapacityLedger:
    """Thread-safe interval ledger over a fixed slice inventory.

    ``specs`` is the pool's inventory (:class:`SliceSpec` list — only
    ``slice_id`` and ``chips`` are read, so duck-typed fakes work).
    ``timeseries``/``brain`` are optional sinks: goodput observations
    land in the store (series ``tenant.goodput{tenant,job}``), closed
    intervals and tenant rollups in the brain datastore — both
    best-effort by contract. ``clock`` is injectable so drills replay
    backdated timelines hermetically.
    """

    def __init__(
        self,
        specs: Sequence,
        timeseries=None,
        brain=None,
        job_name: str = "pool",
        clock: Callable[[], float] = time.time,
        retention: int = INTERVAL_RETENTION,
    ):
        self._chips: Dict[int, int] = {
            s.slice_id: int(s.chips) for s in specs
        }
        self.total_chips = sum(self._chips.values())
        self.timeseries = timeseries
        self.brain = brain
        self.job_name = job_name
        self.clock = clock
        self._lock = threading.Lock()
        now = self.clock()
        self.start_ts = now
        # slice_id -> [state, tenant, job_id, since] (the open
        # interval; every slice is born idle at ledger start).
        self._open: Dict[int, List] = {
            sid: [STATE_IDLE, IDLE_TENANT, "", now]
            for sid in self._chips
        }
        # (tenant, state) -> closed chip-seconds.
        self._totals: Dict[Tuple[str, str], float] = {}
        self._intervals: deque = deque(maxlen=retention)
        self._jobs: Dict[str, _JobAccount] = {}
        # Productive chip-seconds of retired jobs, folded per tenant
        # so tenant history survives job retirement.
        self._retired_productive: Dict[str, float] = {}
        self._retired_held: Dict[str, float] = {}

    # -- state transitions (pool/scheduler hooks) ---------------------------

    def on_allocate(
        self,
        job_id: str,
        tenant: str,
        slice_ids: Sequence[int],
        ts: Optional[float] = None,
    ) -> None:
        """SlicePool.allocate hook: the gang's slices enter
        ``allocated{tenant,job}``. Idempotent per slice (a re-fired
        hook with the same owner is a no-op transition)."""
        ts = self._stamp(ts)
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                job = self._jobs[job_id] = _JobAccount(tenant)
            job.tenant = tenant
            job.slices = list(slice_ids)
            job.chips = sum(
                self._chips.get(sid, 0) for sid in slice_ids
            )
            self._transition_locked(
                slice_ids, STATE_ALLOCATED, tenant, job_id, ts
            )
            # Accrual starts now; ratio stays at its last known value
            # (0.0 for a fresh job — time before the first goodput
            # report conservatively counts as non-productive).
            job.mark = ts

    def on_release(
        self,
        job_id: str,
        slice_ids: Sequence[int],
        ts: Optional[float] = None,
    ) -> None:
        """SlicePool.release hook: the job's slices return to idle.
        The job account survives (a preempted job resumes later);
        :meth:`retire_job` is the terminal path."""
        ts = self._stamp(ts)
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                self._settle_productive_locked(job, ts)
                job.mark = None
                job.slices = []
                job.chips = 0
            self._transition_locked(
                slice_ids, STATE_IDLE, IDLE_TENANT, "", ts
            )

    def mark_preempting(
        self, job_id: str, ts: Optional[float] = None
    ) -> None:
        """Preemption engine hook: the victim's slices stop producing
        while its park (checkpoint + stop) is in flight."""
        self._mark_state(job_id, STATE_PREEMPTING, ts)

    def mark_draining(
        self, job_id: str, ts: Optional[float] = None
    ) -> None:
        """Cancel hook: slices drain between the cancel decision and
        the release back to idle."""
        self._mark_state(job_id, STATE_DRAINING, ts)

    def mark_restoring(
        self, job_id: str, ts: Optional[float] = None
    ) -> None:
        """Resume-placement hook: a preempted job's new gang restores
        from checkpoint — held but not yet productive."""
        self._mark_state(job_id, STATE_RESTORING, ts)

    def _mark_state(
        self, job_id: str, state: str, ts: Optional[float]
    ) -> None:
        ts = self._stamp(ts)
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or not job.slices:
                return
            self._settle_productive_locked(job, ts)
            job.mark = None
            self._transition_locked(
                job.slices, state, job.tenant, job_id, ts
            )

    def job_ready(
        self, job_id: str, ts: Optional[float] = None
    ) -> None:
        """Workers registered after a resume placement: flip the
        job's ``restoring`` slices back to ``allocated`` and restart
        productive accrual. Idempotent — fresh placements (already
        allocated) and unknown jobs are no-ops."""
        ts = self._stamp(ts)
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or not job.slices:
                return
            open_state = self._open.get(job.slices[0])
            if open_state is None or open_state[0] != STATE_RESTORING:
                return
            self._transition_locked(
                job.slices, STATE_ALLOCATED, job.tenant, job_id, ts
            )
            job.mark = ts

    def retire_job(
        self,
        job_id: str,
        retire_tenant: bool = False,
        ts: Optional[float] = None,
    ) -> None:
        """Terminal path (complete/cancel): fold the job's productive
        history into its tenant and purge its per-job time series —
        and, when the scheduler says this was the tenant's last live
        job, the tenant-labeled series too (the PR-8 departed-host
        purge, applied to tenants)."""
        ts = self._stamp(ts)
        with self._lock:
            job = self._jobs.pop(job_id, None)
            if job is None:
                return
            self._settle_productive_locked(job, ts)
            tenant = job.tenant
            self._retired_productive[tenant] = (
                self._retired_productive.get(tenant, 0.0)
                + job.productive
            )
        store = self.timeseries
        if store is not None:
            try:
                store.drop_label("job", job_id)
                if retire_tenant:
                    store.drop_label("tenant", tenant)
            except Exception:  # noqa: BLE001 — purge is best-effort
                logger.warning(
                    "series purge for job %s failed", job_id,
                    exc_info=True,
                )
        if retire_tenant:
            # The gauge must not report the dead tenant's last ratio
            # forever (same contract as the slice-pool tenant gauge).
            _GOODPUT_PER_CHIP.set(0.0, tenant=tenant)

    # -- goodput join -------------------------------------------------------

    def observe_goodput(
        self,
        job_id: str,
        ratio: float,
        ts: Optional[float] = None,
    ) -> None:
        """One goodput observation for a placed job (the pool
        master's watch tick feeds each embedded JobMaster's
        ``GoodputAccountant`` ratio through here). Accrues
        ``chips x elapsed x ratio`` productive chip-seconds since the
        previous observation, refreshes the tenant gauge, and ships a
        ``tenant_goodput`` rollup to the brain."""
        ts = self._stamp(ts)
        try:
            ratio = max(0.0, min(1.0, float(ratio)))
        except (TypeError, ValueError):
            return
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return
            self._settle_productive_locked(job, ts)
            job.ratio = ratio
            tenant = job.tenant
            gauge_ratio = self._tenant_ratio_locked(tenant)
            rollup = self._tenant_rollup_locked(tenant, ts)
        _GOODPUT_PER_CHIP.set(gauge_ratio, tenant=tenant)
        store = self.timeseries
        if store is not None:
            # Two series: the per-job stream (purged when the job
            # retires) and the tenant-level stream the SLO budget
            # engine queries (series match on the EXACT label set).
            store.record(
                "tenant.goodput", ratio, ts=ts,
                tenant=tenant, job=job_id,
            )
            store.record(
                "tenant.goodput", ratio, ts=ts, tenant=tenant
            )
        self._persist_tenant_goodput(tenant, rollup, ts)

    def _settle_productive_locked(
        self, job: _JobAccount, ts: float
    ) -> None:
        """Accrue productive chip-seconds up to ``ts`` at the job's
        last known ratio, then advance the mark."""
        if job.mark is None:
            return
        dt = ts - job.mark
        if dt > 0:
            job.productive += dt * job.chips * job.ratio
        job.mark = ts

    # -- interval mechanics -------------------------------------------------

    def _stamp(self, ts: Optional[float]) -> float:
        return float(ts) if ts is not None else self.clock()

    def _transition_locked(
        self,
        slice_ids: Sequence[int],
        state: str,
        tenant: str,
        job_id: str,
        ts: float,
    ) -> None:
        closed: List[SliceInterval] = []
        for sid in slice_ids:
            open_rec = self._open.get(sid)
            if open_rec is None:
                continue  # not our inventory — ignore, never raise
            old_state, old_tenant, old_job, since = open_rec
            if (old_state, old_tenant, old_job) == (
                state, tenant, job_id
            ):
                continue  # no-op transition keeps the open interval
            end = max(ts, since)  # clamp clock skew, never negative
            chips = self._chips.get(sid, 0)
            dur = end - since
            cell = (old_tenant, old_state)
            self._totals[cell] = (
                self._totals.get(cell, 0.0) + dur * chips
            )
            if dur * chips > 0:
                _CHIP_SECONDS.inc(
                    dur * chips, tenant=old_tenant, state=old_state
                )
            interval = SliceInterval(
                slice_id=sid,
                state=old_state,
                tenant=old_tenant,
                job_id=old_job,
                start_ts=since,
                end_ts=end,
                chips=chips,
            )
            if dur > 0:
                self._intervals.append(interval)
                closed.append(interval)
            self._open[sid] = [state, tenant, job_id, end]
        for interval in closed:
            self._persist_interval(interval)

    # -- rollups ------------------------------------------------------------

    def _held_locked(self, tenant: str, ts: float) -> float:
        """Chip-seconds ``tenant`` has held in ANY state so far:
        closed cells plus open accruals — no settling, so calling
        this never fragments intervals."""
        held = sum(
            cs
            for (t, _), cs in self._totals.items()
            if t == tenant
        )
        for sid, (state, t, _job, since) in self._open.items():
            if t == tenant:
                held += max(ts - since, 0.0) * self._chips.get(sid, 0)
        return held

    def _productive_locked(self, tenant: str, ts: float) -> float:
        prod = self._retired_productive.get(tenant, 0.0)
        for job in self._jobs.values():
            if job.tenant != tenant:
                continue
            prod += job.productive
            if job.mark is not None and ts > job.mark:
                prod += (ts - job.mark) * job.chips * job.ratio
        return prod

    def _tenant_ratio_locked(self, tenant: str) -> float:
        """Chips-weighted current goodput ratio across the tenant's
        placed jobs (0.0 when it holds nothing)."""
        chips = 0
        weighted = 0.0
        for job in self._jobs.values():
            if job.tenant == tenant and job.chips > 0:
                chips += job.chips
                weighted += job.chips * job.ratio
        return weighted / chips if chips else 0.0

    def _tenant_rollup_locked(self, tenant: str, ts: float) -> dict:
        held = self._held_locked(tenant, ts)
        productive = self._productive_locked(tenant, ts)
        chips = sum(
            j.chips for j in self._jobs.values()
            if j.tenant == tenant
        )
        return {
            "chips": chips,
            "held_chip_seconds": held,
            "productive_chip_seconds": productive,
            "goodput_per_chip": (
                productive / held if held > 0 else 0.0
            ),
        }

    # -- brain persistence (best-effort by contract) ------------------------

    def _persist_interval(self, interval: SliceInterval) -> None:
        persist = getattr(
            self.brain, "persist_capacity_interval", None
        )
        if persist is None:
            return
        try:
            persist(
                job_name=self.job_name,
                slice_id=interval.slice_id,
                state=interval.state,
                tenant=interval.tenant,
                job_id=interval.job_id,
                start_ts=interval.start_ts,
                end_ts=interval.end_ts,
                chip_seconds=interval.chip_seconds,
            )
        except Exception:  # noqa: BLE001 — a broken datastore must
            # not take the accounting plane down
            logger.warning(
                "capacity interval persistence failed", exc_info=True
            )

    def _persist_tenant_goodput(
        self, tenant: str, rollup: dict, ts: float
    ) -> None:
        persist = getattr(self.brain, "persist_tenant_goodput", None)
        if persist is None:
            return
        try:
            persist(
                job_name=self.job_name,
                tenant=tenant,
                chips=rollup["chips"],
                held_chip_seconds=rollup["held_chip_seconds"],
                productive_chip_seconds=rollup[
                    "productive_chip_seconds"
                ],
                goodput_per_chip=rollup["goodput_per_chip"],
                timestamp=ts,
            )
        except Exception:  # noqa: BLE001
            logger.warning(
                "tenant goodput persistence failed", exc_info=True
            )

    # -- read surface -------------------------------------------------------

    def recent_intervals(self, limit: int = 50) -> List[dict]:
        with self._lock:
            items = list(self._intervals)
        return [iv.to_dict() for iv in items[-limit:]]

    def snapshot(self, ts: Optional[float] = None) -> dict:
        """The capacity accounting rollup ``obs_report --capacity``
        renders. Cells include open-interval accrual up to ``ts``, so
        the per-{tenant,state} chip-seconds always partition
        ``total_chips x elapsed`` exactly."""
        ts = self._stamp(ts)
        with self._lock:
            elapsed = max(ts - self.start_ts, 0.0)
            cells: Dict[Tuple[str, str], float] = dict(self._totals)
            for sid, (state, tenant, _job, since) in (
                self._open.items()
            ):
                cell = (tenant, state)
                cells[cell] = cells.get(cell, 0.0) + (
                    max(ts - since, 0.0) * self._chips.get(sid, 0)
                )
            by_state: Dict[str, float] = {}
            by_tenant: Dict[str, Dict[str, float]] = {}
            for (tenant, state), cs in cells.items():
                by_state[state] = by_state.get(state, 0.0) + cs
                by_tenant.setdefault(tenant, {})[state] = cs
            tenants = {}
            names = (
                {t for t, _ in cells if t != IDLE_TENANT}
                | {j.tenant for j in self._jobs.values()}
                | set(self._retired_productive)
            )
            for tenant in sorted(names):
                rollup = self._tenant_rollup_locked(tenant, ts)
                states = by_tenant.get(tenant, {})
                rollup["states"] = {
                    s: round(states.get(s, 0.0), 3) for s in STATES
                    if states.get(s)
                }
                rollup["overhead_chip_seconds"] = sum(
                    states.get(s, 0.0) for s in OVERHEAD_STATES
                )
                rollup["ratio_now"] = self._tenant_ratio_locked(
                    tenant
                )
                rollup["jobs"] = sorted(
                    jid for jid, j in self._jobs.items()
                    if j.tenant == tenant
                )
                tenants[tenant] = rollup
            accounted = sum(cells.values())
            capacity = self.total_chips * elapsed
            busy = capacity - by_state.get(STATE_IDLE, 0.0)
        return {
            "ts": ts,
            "start_ts": self.start_ts,
            "elapsed_s": elapsed,
            "pool_slices": len(self._chips),
            "total_chips": self.total_chips,
            "chip_seconds": {
                "capacity": capacity,
                "accounted": accounted,
                "by_state": {
                    s: round(cs, 3) for s, cs in by_state.items()
                },
            },
            # |accounted - capacity| should be float noise only; a
            # material gap means a transition hook was missed.
            "partition_ok": (
                abs(accounted - capacity)
                <= 1e-6 * max(capacity, 1.0)
            ),
            "utilization": busy / capacity if capacity > 0 else 0.0,
            "tenants": tenants,
        }


def render_capacity(payload: dict) -> str:
    """Human rendering of a capacity snapshot (plus the SLO budget
    block the pool master attaches) — the ``obs_report --capacity``
    body."""
    lines = []
    elapsed = float(payload.get("elapsed_s", 0.0))
    util = float(payload.get("utilization", 0.0))
    lines.append(
        f"pool capacity: {payload.get('pool_slices', 0)} slice(s) / "
        f"{payload.get('total_chips', 0)} chip(s), "
        f"elapsed {elapsed:.0f}s, utilization {util * 100:.0f}%"
    )
    cs = payload.get("chip_seconds", {})
    by_state = cs.get("by_state", {})
    if by_state:
        lines.append(
            "chip-seconds by state: "
            + "  ".join(
                f"{s} {by_state[s]:.1f}"
                for s in STATES
                if s in by_state
            )
        )
    if not payload.get("partition_ok", True):
        lines.append(
            "WARNING: accounted chip-seconds "
            f"{cs.get('accounted', 0.0):.1f} != capacity "
            f"{cs.get('capacity', 0.0):.1f} — missed transition hook?"
        )
    tenants = payload.get("tenants", {})
    if tenants:
        lines.append(
            f"{'tenant':<12} {'chips':>5} {'held-cs':>10} "
            f"{'prod-cs':>10} {'goodput/chip':>12} {'overhead-cs':>11}"
        )
        for tenant in sorted(tenants):
            t = tenants[tenant]
            lines.append(
                f"{tenant:<12} {t.get('chips', 0):>5} "
                f"{t.get('held_chip_seconds', 0.0):>10.1f} "
                f"{t.get('productive_chip_seconds', 0.0):>10.1f} "
                f"{t.get('goodput_per_chip', 0.0):>12.3f} "
                f"{t.get('overhead_chip_seconds', 0.0):>11.1f}"
            )
            if t.get("jobs"):
                lines.append(
                    f"{'':<12} jobs: {', '.join(t['jobs'])}"
                )
    else:
        lines.append("no tenants have held capacity yet")
    slo = payload.get("slo") or {}
    budgets = slo.get("budgets", [])
    if budgets:
        lines.append("slo budgets:")
        for b in budgets:
            alert = ""
            if b.get("burning"):
                alert = (
                    f"  BURNING [{b.get('severity', 'warn')}]"
                    f" fast {b.get('burn', {}).get('fast', 0.0):.1f}x"
                    f" slow {b.get('burn', {}).get('slow', 0.0):.1f}x"
                )
            lines.append(
                f"  {b.get('tenant', '?')}/{b.get('slo', '?')}: "
                f"budget remaining "
                f"{100.0 * float(b.get('budget_remaining', 1.0)):.0f}%"
                f" (objective {b.get('direction', 'min')} "
                f"{b.get('objective', 0.0)} on {b.get('series', '?')})"
                + alert
            )
    return "\n".join(lines)
