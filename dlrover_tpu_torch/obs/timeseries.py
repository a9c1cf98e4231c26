"""Bounded in-memory time-series store for the master's health plane.

The measurement plane (fleet snapshots, goodput recomputes, speed-
monitor EWMAs, compile counters) produces *instantaneous* values; the
brain layer (PAPER.md §1.1's optimize service) needs *history* —
"throughput over the last two minutes vs the two before that", "is
this host's RSS still climbing". This module is that substrate: a
stdlib-only, lock-guarded store of labeled series with

* **ring retention** — the newest ``raw_points`` samples per series
  are kept at full resolution; older samples are folded into coarse
  buckets of ``coarse_resolution`` seconds (mean/min/max/count per
  bucket, ``coarse_points`` buckets retained), so a series costs
  O(raw + coarse) memory forever;
* **windowed queries** — :meth:`query` (count/mean/min/max/p50/p90),
  :meth:`rate` for cumulative counters, and :meth:`slope` (robust
  Theil–Sen estimator, so one outlier sample cannot fake a trend).
  Every query takes an ``end_offset_s`` so detectors can compare a
  recent window against the *baseline* window that preceded it;
* an **injectable clock** so detector tests drive simulated hours in
  microseconds.

Series names are internal dotted identifiers (``host.step_time``,
``goodput.ratio``) — this store feeds detectors and reports, not the
Prometheus endpoint (the registry in obs/metrics.py owns exposition).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("obs.timeseries")

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _percentile(ordered: List[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not ordered:
        return 0.0
    rank = max(
        0,
        min(len(ordered) - 1, int(round(q / 100.0 * (len(ordered) - 1)))),
    )
    return ordered[rank]


@dataclasses.dataclass
class WindowStats:
    """Summary of one series over one query window."""

    count: int
    mean: float
    minimum: float
    maximum: float
    p50: float
    p90: float
    first_ts: float
    last_ts: float
    first: float
    last: float

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "mean": round(self.mean, 6),
            "min": round(self.minimum, 6),
            "max": round(self.maximum, 6),
            "p50": round(self.p50, 6),
            "p90": round(self.p90, 6),
            "first_ts": round(self.first_ts, 3),
            "last_ts": round(self.last_ts, 3),
        }


class Series:
    """One labeled series: raw ring (full resolution, newest
    ``raw_points`` samples) + coarse downsampled history (one
    mean/min/max/count bucket per ``coarse_resolution`` seconds)."""

    def __init__(self, raw_points: int, coarse_points: int,
                 coarse_resolution: float):
        self.raw_max = max(int(raw_points), 2)
        self.raw: deque = deque()
        self.coarse: deque = deque(maxlen=max(int(coarse_points), 1))
        self.coarse_resolution = max(float(coarse_resolution), 1e-9)
        self.bucket: Optional[list] = None  # [key, sum, count, min, max]

    def append(self, ts: float, value: float) -> None:
        self.raw.append((ts, value))
        while len(self.raw) > self.raw_max:
            old_ts, old_v = self.raw.popleft()
            self._fold(old_ts, old_v)

    def _fold(self, ts: float, value: float) -> None:
        key = int(ts // self.coarse_resolution)
        if self.bucket is None or self.bucket[0] != key:
            self.flush_bucket()
            self.bucket = [key, 0.0, 0, value, value]
        b = self.bucket
        b[1] += value
        b[2] += 1
        b[3] = min(b[3], value)
        b[4] = max(b[4], value)

    def flush_bucket(self) -> None:
        if self.bucket is None:
            return
        key, total, count, vmin, vmax = self.bucket
        center = (key + 0.5) * self.coarse_resolution
        self.coarse.append((center, total / count, vmin, vmax, count))
        self.bucket = None

    def extremes(
        self, t0: float, t1: float
    ) -> Tuple[Optional[float], Optional[float]]:
        """True (min, max) over [t0, t1]: raw samples plus the
        per-bucket extremes the downsampled history retains — a spike
        that has aged into a coarse bucket must still show up in a
        long-window max, not be hidden behind the bucket mean."""
        vmin: Optional[float] = None
        vmax: Optional[float] = None

        def take(lo: float, hi: float) -> None:
            nonlocal vmin, vmax
            vmin = lo if vmin is None else min(vmin, lo)
            vmax = hi if vmax is None else max(vmax, hi)

        for ts, _, bmin, bmax, _ in self.coarse:
            if t0 <= ts <= t1:
                take(bmin, bmax)
        if self.bucket is not None:
            key, _, _, bmin, bmax = self.bucket
            center = (key + 0.5) * self.coarse_resolution
            if t0 <= center <= t1:
                take(bmin, bmax)
        for ts, v in self.raw:
            if t0 <= ts <= t1:
                take(v, v)
        return vmin, vmax

    def points(
        self, t0: float, t1: float
    ) -> List[Tuple[float, float]]:
        """(ts, value) in [t0, t1], coarse means then raw samples.

        The open bucket (folded but not yet flushed) is included so a
        long query never has a blind spot between coarse and raw."""
        out: List[Tuple[float, float]] = [
            (ts, mean)
            for ts, mean, _, _, _ in self.coarse
            if t0 <= ts <= t1
        ]
        if self.bucket is not None:
            key, total, count, _, _ = self.bucket
            center = (key + 0.5) * self.coarse_resolution
            if t0 <= center <= t1:
                out.append((center, total / count))
        out.extend(
            (ts, v) for ts, v in self.raw if t0 <= ts <= t1
        )
        return out


class TimeSeriesStore:
    """Bounded store of labeled series with windowed queries.

    Thread-safe; every public method takes and releases one lock.
    ``clock`` defaults to wall time because the feeding sources stamp
    wall timestamps (agent snapshots, goodput windows) — tests inject
    a fake clock and stamp records explicitly.
    """

    def __init__(
        self,
        raw_points: int = 512,
        coarse_points: int = 512,
        coarse_resolution: float = 30.0,
        max_series: int = 4096,
        clock: Callable[[], float] = time.time,
    ):
        self.raw_points = raw_points
        self.coarse_points = coarse_points
        self.coarse_resolution = coarse_resolution
        self.max_series = max_series
        self.clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, LabelsKey], Series] = {}
        self._dropped_series = 0

    # -- ingest -----------------------------------------------------------

    def record(
        self,
        name: str,
        value: float,
        ts: Optional[float] = None,
        **labels: str,
    ) -> None:
        """Append one sample. Never raises on bad input — telemetry
        must not take its producer down."""
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        if value != value:  # NaN
            return
        stamp = float(ts) if ts is not None else self.clock()
        key = (str(name), _labels_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    # Bounded by contract: a label-cardinality bug
                    # upstream must not grow master memory forever.
                    self._dropped_series += 1
                    if self._dropped_series == 1:
                        logger.warning(
                            "time-series store full (%d series); "
                            "dropping new series %s%s",
                            self.max_series, name, dict(labels),
                        )
                    return
                series = Series(
                    self.raw_points,
                    self.coarse_points,
                    self.coarse_resolution,
                )
                self._series[key] = series
            series.append(stamp, value)

    def drop_series(self, name: str, **labels: str) -> None:
        """Forget one series (departed host)."""
        with self._lock:
            self._series.pop((str(name), _labels_key(labels)), None)

    def drop_label(self, label: str, value: str) -> None:
        """Forget every series carrying ``label == value`` — the one
        call sites need when a host leaves the fleet."""
        pair = (str(label), str(value))
        with self._lock:
            gone = [
                k for k in self._series if pair in k[1]
            ]
            for k in gone:
                self._series.pop(k, None)

    # -- introspection ----------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    def series_labels(self, name: str) -> List[Dict[str, str]]:
        """The label sets under ``name`` (one dict per series)."""
        with self._lock:
            return [
                dict(lk)
                for n, lk in sorted(self._series)
                if n == name
            ]

    def size(self) -> int:
        with self._lock:
            return len(self._series)

    # -- queries ----------------------------------------------------------

    def _window(
        self,
        name: str,
        window_s: Optional[float],
        end_offset_s: float,
        labels: Dict[str, str],
    ) -> List[Tuple[float, float]]:
        key = (str(name), _labels_key(labels))
        now = self.clock()
        t1 = now - max(end_offset_s, 0.0)
        t0 = t1 - window_s if window_s is not None else -float("inf")
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return []
            return series.points(t0, t1)

    def points(
        self,
        name: str,
        window_s: Optional[float] = None,
        end_offset_s: float = 0.0,
        **labels: str,
    ) -> List[Tuple[float, float]]:
        """Samples in ``[now - end_offset - window, now - end_offset]``
        (the whole retained history when ``window_s`` is None), oldest
        first. Points older than the raw ring arrive downsampled to
        one mean per ``coarse_resolution`` bucket."""
        return sorted(self._window(name, window_s, end_offset_s, labels))

    def query(
        self,
        name: str,
        window_s: Optional[float] = None,
        end_offset_s: float = 0.0,
        **labels: str,
    ) -> Optional[WindowStats]:
        """Window summary, or None when the window holds no samples."""
        pts = self.points(
            name, window_s, end_offset_s=end_offset_s, **labels
        )
        if not pts:
            return None
        values = sorted(v for _, v in pts)
        # min/max from the true per-bucket extremes: points() carries
        # only bucket means for downsampled history, which would hide
        # spikes older than the raw ring.
        key = (str(name), _labels_key(labels))
        now = self.clock()
        t1 = now - max(end_offset_s, 0.0)
        t0 = t1 - window_s if window_s is not None else -float("inf")
        with self._lock:
            series = self._series.get(key)
            vmin, vmax = (
                series.extremes(t0, t1)
                if series is not None
                else (None, None)
            )
        return WindowStats(
            count=len(pts),
            mean=sum(values) / len(values),
            minimum=values[0] if vmin is None else vmin,
            maximum=values[-1] if vmax is None else vmax,
            p50=_percentile(values, 50.0),
            p90=_percentile(values, 90.0),
            first_ts=pts[0][0],
            last_ts=pts[-1][0],
            first=pts[0][1],
            last=pts[-1][1],
        )

    def latest(
        self, name: str, **labels: str
    ) -> Optional[Tuple[float, float]]:
        pts = self._window(name, None, 0.0, labels)
        return max(pts) if pts else None

    def rate(
        self,
        name: str,
        window_s: float,
        end_offset_s: float = 0.0,
        **labels: str,
    ) -> Optional[float]:
        """Per-second rate of a CUMULATIVE series over the window
        ((last - first) / elapsed). None without two samples, and None
        on a negative delta — a counter reset (process restart) must
        not read as a negative rate."""
        pts = self.points(
            name, window_s, end_offset_s=end_offset_s, **labels
        )
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0 or v1 < v0:
            return None
        return (v1 - v0) / (t1 - t0)

    # Theil–Sen is O(n^2) pairs; cap the sample count so a full raw
    # ring cannot turn one detector tick into ~130k slope pairs.
    SLOPE_MAX_POINTS = 64

    def slope(
        self,
        name: str,
        window_s: float,
        end_offset_s: float = 0.0,
        **labels: str,
    ) -> Optional[float]:
        """Robust linear trend (units/second) over the window: the
        Theil–Sen estimator — median of pairwise slopes — so a single
        outlier sample cannot fake or mask a trend. None without two
        samples spanning nonzero time."""
        pts = self.points(
            name, window_s, end_offset_s=end_offset_s, **labels
        )
        if len(pts) > self.SLOPE_MAX_POINTS:
            stride = len(pts) / float(self.SLOPE_MAX_POINTS)
            pts = [
                pts[int(i * stride)]
                for i in range(self.SLOPE_MAX_POINTS)
            ]
        if len(pts) < 2:
            return None
        slopes = [
            (v2 - v1) / (t2 - t1)
            for i, (t1, v1) in enumerate(pts)
            for t2, v2 in pts[i + 1:]
            if t2 > t1
        ]
        if not slopes:
            return None
        slopes.sort()
        mid = len(slopes) // 2
        if len(slopes) % 2:
            return slopes[mid]
        return (slopes[mid - 1] + slopes[mid]) / 2.0

    def first_ts(self, name: str, **labels: str) -> Optional[float]:
        pts = self._window(name, None, 0.0, labels)
        return min(pts)[0] if pts else None
