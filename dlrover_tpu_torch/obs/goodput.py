"""Goodput/badput accounting: exhaustive wall-time attribution.

Folds an obs event stream into the job-level question "where did the
wall time go", in the framing of Meta's large-scale reliability study
and Google Cloud's ML Goodput work: every second of the accounting
window lands in EXACTLY one bucket —

    productive    steps are landing (time between trainer.step marks)
    compile       cold XLA compilation (trainer.compile_done spans)
    data_wait     the train loop blocked on input
                  (trainer.prefetch_wait)
    checkpoint    save/stage/persist/restore (ckpt.* spans)
    recovery      a failure event until the relaunched trainer's
                  first step (node.fail / node.gone /
                  node.heartbeat_timeout -> trainer.first_step_done)
    idle_unknown  wall time no signal explains (startup, rendezvous
                  waits outside a recovery, silent stalls)

Attribution is a boundary sweep over category intervals with a fixed
precedence (``recovery > checkpoint > compile > data_wait >
productive``), so overlapping signals never double-count and the
bucket sums equal the window length exactly — property-tested in
``tests/test_fleet_telemetry.py`` and asserted by
``tools/obs_report.py --selftest``.

Timestamp conventions of the sources (see tracer.py): span events
carry ``ts`` = start and ``dur_s``; plain events with a ``dur_s`` tag
(``trainer.prefetch_wait``, ``trainer.compile_done``) are emitted at
the END of the measured interval.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from dlrover_tpu_torch.obs import metrics as _metrics

# Buckets in precedence order (highest first); productive is the
# lowest explicit signal and idle_unknown is the remainder.
CATEGORIES = (
    "recovery",
    "checkpoint",
    "compile",
    "data_wait",
    "productive",
    "idle_unknown",
)

FAILURE_EVENTS = ("node.fail", "node.gone", "node.heartbeat_timeout")
# Recovery closes at the explicit phase mark, or — when the trainer's
# marks never reach this stream (tracing off on the host) — at the
# first step landing after the failure: steps landing IS recovery.
RECOVERY_END = ("trainer.first_step_done", "trainer.step")

# Events whose ts marks the END of the measured duration.
_END_STAMPED = {"trainer.prefetch_wait", "trainer.compile_done"}


@dataclasses.dataclass
class GoodputReport:
    """Wall-time attribution over ``[t0, t1]``; ``seconds`` maps every
    category to its share and sums to ``total_s`` exactly."""

    t0: float
    t1: float
    seconds: Dict[str, float]
    steps: int

    @property
    def total_s(self) -> float:
        return self.t1 - self.t0

    @property
    def goodput_ratio(self) -> float:
        if self.total_s <= 0:
            return 0.0
        return self.seconds.get("productive", 0.0) / self.total_s

    def to_dict(self) -> dict:
        return {
            "t0": self.t0,
            "t1": self.t1,
            "total_s": round(self.total_s, 6),
            "goodput_ratio": round(self.goodput_ratio, 6),
            "steps": self.steps,
            "seconds": {
                k: round(v, 6) for k, v in self.seconds.items()
            },
        }


def _clip(
    intervals: List[Tuple[float, float]], t0: float, t1: float
) -> List[Tuple[float, float]]:
    out = []
    for a, b in intervals:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((a, b))
    return out


def _merge(
    intervals: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Sort and coalesce overlapping intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _category_intervals(
    events: List[dict], t0: float, t1: float
) -> Dict[str, List[Tuple[float, float]]]:
    """Raw (unclipped, possibly overlapping) intervals per category."""
    by_cat: Dict[str, List[Tuple[float, float]]] = {
        c: [] for c in CATEGORIES
    }
    step_ts: List[float] = []
    open_failure: Optional[float] = None
    for ev in events:
        name = ev.get("name", "")
        ts = float(ev["ts"])
        dur = float(ev.get("dur_s", 0.0) or 0.0)
        if name == "trainer.step":
            step_ts.append(ts)
        if name in FAILURE_EVENTS:
            if open_failure is None:
                open_failure = ts
        elif name in RECOVERY_END and open_failure is not None:
            by_cat["recovery"].append((open_failure, ts))
            open_failure = None
        if dur <= 0:
            continue
        if name in _END_STAMPED:
            start, end = ts - dur, ts
        else:
            start, end = ts, ts + dur
        if name == "trainer.prefetch_wait":
            by_cat["data_wait"].append((start, end))
        elif name == "trainer.compile_done":
            by_cat["compile"].append((start, end))
        elif name.startswith("ckpt."):
            by_cat["checkpoint"].append((start, end))
    if open_failure is not None:
        # Failure never recovered inside the window: badput to the end.
        by_cat["recovery"].append((open_failure, t1))
    for a, b in zip(step_ts, step_ts[1:]):
        if b > a:
            by_cat["productive"].append((a, b))
    return by_cat


def attribute_goodput(
    events: Iterable[dict],
    t0: Optional[float] = None,
    t1: Optional[float] = None,
) -> Optional[GoodputReport]:
    """Sweep ``events`` into a :class:`GoodputReport` over ``[t0, t1]``
    (defaulting to the event span). Returns None when there is nothing
    to account (no events and no explicit window).

    Exhaustive and exclusive by construction: the window is cut at
    every interval boundary and each elementary segment is assigned to
    the highest-precedence category covering it; uncovered segments
    are ``idle_unknown``.
    """
    evs = sorted(
        (e for e in events if "ts" in e and "name" in e),
        key=lambda e: float(e["ts"]),
    )
    if t0 is None:
        t0 = float(evs[0]["ts"]) if evs else None
    if t1 is None and evs:
        # Window end covers interval ENDS, not just event stamps: a
        # start-stamped span at the tail (e.g. a trailing ckpt.*)
        # extends dur_s past its ts and must not be clipped away.
        t1 = max(
            float(e["ts"])
            + (
                float(e.get("dur_s", 0.0) or 0.0)
                if e.get("name") not in _END_STAMPED
                else 0.0
            )
            for e in evs
        )
    if t0 is None or t1 is None or t1 < t0:
        return None
    by_cat = _category_intervals(evs, t0, t1)
    merged = {
        c: _merge(_clip(iv, t0, t1)) for c, iv in by_cat.items()
    }

    bounds = {t0, t1}
    for iv in merged.values():
        for a, b in iv:
            bounds.add(a)
            bounds.add(b)
    cuts = sorted(bounds)
    seconds = {c: 0.0 for c in CATEGORIES}
    # Precedence: first category in CATEGORIES covering the segment.
    # Segments ascend, so one pointer per category makes the sweep
    # linear in cuts + intervals.
    ptr = {c: 0 for c in CATEGORIES}
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2.0
        for cat in CATEGORIES[:-1]:
            iv = merged[cat]
            i = ptr[cat]
            while i < len(iv) and iv[i][1] <= mid:
                i += 1
            ptr[cat] = i
            if i < len(iv) and iv[i][0] <= mid < iv[i][1]:
                seconds[cat] += b - a
                break
        else:
            seconds["idle_unknown"] += b - a
    steps = sum(1 for e in evs if e.get("name") == "trainer.step")
    return GoodputReport(t0=t0, t1=t1, seconds=seconds, steps=steps)


def render_goodput(report: GoodputReport) -> str:
    """Human-readable breakdown (tools/obs_report.py --goodput)."""
    lines = [
        f"goodput over {report.total_s:.2f}s wall "
        f"({report.steps} steps, "
        f"goodput_ratio {100.0 * report.goodput_ratio:.1f}%):",
    ]
    total = max(report.total_s, 1e-12)
    for cat in CATEGORIES:
        sec = report.seconds.get(cat, 0.0)
        lines.append(
            f"  {cat:<13} {sec:10.2f}s  {100.0 * sec / total:5.1f}%"
        )
    return "\n".join(lines)


class GoodputAccountant:
    """Master-side accountant: accumulates the job's event stream
    (master lifecycle events + trainer spans arriving in agent
    metric snapshots) and keeps the goodput gauges current.

    The window is anchored at the first event seen (the job's observed
    start) and re-accounted on demand — cheap at snapshot cadence
    (seconds), bounded by ``max_events``.
    """

    def __init__(
        self,
        registry=None,
        max_events: int = 100_000,
        min_account_interval: float = 5.0,
        timeseries=None,
    ):
        """``timeseries`` (a TimeSeriesStore) additionally records
        every recompute's ratio and per-category seconds as history,
        so the goodput-SLO detector can judge a window instead of the
        instantaneous gauge."""
        registry = registry or _metrics.get_registry()
        self.timeseries = timeseries
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._max_events = max_events
        # Re-accounting is O(events): debounce the snapshot-cadence
        # callers so a large fleet cannot pin the master's RPC thread
        # re-sweeping the same stream (account(force=True) bypasses).
        self._min_account_interval = min_account_interval
        self._last_account_mono = -float("inf")
        self._last_report: Optional[GoodputReport] = None
        self._seconds = registry.gauge(
            "dlrover_goodput_seconds_total",
            "Wall-time attribution of job time by category "
            "(exhaustive: categories sum to the accounting window)",
            ("category",),
        )
        self._ratio = registry.gauge(
            "dlrover_goodput_ratio",
            "Fraction of the accounting window spent in productive "
            "training steps",
        )

    def add_events(self, events: Iterable[dict]) -> None:
        with self._lock:
            for ev in events:
                if isinstance(ev, dict) and "ts" in ev and "name" in ev:
                    self._events.append(ev)
            if len(self._events) > self._max_events:
                # Keep the newest; the dropped prefix ages the window
                # start forward, which is the right bias for a gauge.
                self._events = self._events[-self._max_events:]

    def account(
        self,
        t0: Optional[float] = None,
        t1: Optional[float] = None,
        force: bool = False,
    ) -> Optional[GoodputReport]:
        with self._lock:
            if (
                not force
                and t0 is None
                and t1 is None
                and time.monotonic() - self._last_account_mono
                < self._min_account_interval
            ):
                return self._last_report
            events = list(self._events)
        report = attribute_goodput(events, t0=t0, t1=t1)
        if report is not None:
            for cat in CATEGORIES:
                self._seconds.set(
                    report.seconds.get(cat, 0.0), category=cat
                )
            self._ratio.set(report.goodput_ratio)
            if self.timeseries is not None and t0 is None and t1 is None:
                # History for the health detectors: stamp at the
                # store's "now", not report.t1 — when the event
                # stream stalls, t1 freezes and frozen-stamped
                # samples would age out of the SLO detector's query
                # window during the exact episode it must see.
                ts = max(report.t1, self.timeseries.clock())
                self.timeseries.record(
                    "goodput.ratio", report.goodput_ratio, ts=ts
                )
                for cat in CATEGORIES:
                    self.timeseries.record(
                        "goodput.seconds",
                        report.seconds.get(cat, 0.0),
                        ts=ts,
                        category=cat,
                    )
        with self._lock:
            if t0 is None and t1 is None:
                self._last_account_mono = time.monotonic()
                self._last_report = report
        return report
