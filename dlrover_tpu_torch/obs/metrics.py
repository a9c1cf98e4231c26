"""Process-local metrics registry with Prometheus text exposition.

Counters, gauges, and histograms with labels, kept in plain dicts
behind a lock and rendered on demand into the Prometheus text format
(version 0.0.4) — the subset ``prometheus_client`` would produce, with
no dependency on it. ``MetricsRegistry.render()`` works without any
server, so tests stay hermetic; the master additionally serves it over
HTTP (obs/exposition.py) and over the control-plane RPC
(``MetricsRequest``).

Semantics follow the Prometheus client-library guidelines:

* a metric name is registered once with a fixed type and label names;
  re-requesting the same name returns the same object, and a
  conflicting re-registration raises.
* label values select a child series; unlabeled metrics have a single
  implicit series.
* histogram buckets are cumulative and always end with ``+Inf``;
  ``_sum`` and ``_count`` series accompany them.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0,
)


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r"\"")
    )


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared label-handling for all three metric types."""

    type_name = ""

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _series_name(self, key: Tuple[str, ...], suffix: str = "",
                     extra: str = "") -> str:
        pairs = [
            f'{ln}="{_escape_label_value(lv)}"'
            for ln, lv in zip(self.labelnames, key)
        ]
        if extra:
            pairs.append(extra)
        label_str = "{" + ",".join(pairs) + "}" if pairs else ""
        return f"{self.name}{suffix}{label_str}"

    def render(self) -> List[str]:
        raise NotImplementedError

    def dump(self) -> dict:
        raise NotImplementedError

    def remove(self, **labels) -> None:
        """Drop one labeled series (departed host, retired node)."""
        key = self._key(labels)
        store = getattr(self, "_values", None)
        if store is None:
            store = getattr(self, "_series")
        with self._lock:
            store.pop(key, None)


class Counter(_Metric):
    type_name = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        return [
            f"{self._series_name(k)} {_format_value(v)}"
            for k, v in items
        ]

    def dump(self) -> dict:
        with self._lock:
            series = [[list(k), v] for k, v in self._values.items()]
        return {
            "type": self.type_name,
            "help": self.help,
            "labelnames": list(self.labelnames),
            "series": series,
        }


class Gauge(_Metric):
    type_name = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        return [
            f"{self._series_name(k)} {_format_value(v)}"
            for k, v in items
        ]

    dump = Counter.dump


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets = tuple(bounds)
        # key -> (per-bucket counts, sum, count)
        self._series: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = [[0] * len(self.buckets), 0.0, 0]
                self._series[key] = series
            counts, _, _ = series
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            series[1] += value
            series[2] += 1

    def count(self, **labels) -> int:
        with self._lock:
            series = self._series.get(self._key(labels))
            return series[2] if series else 0

    def sum(self, **labels) -> float:
        with self._lock:
            series = self._series.get(self._key(labels))
            return series[1] if series else 0.0

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(
                (k, (list(c), s, n))
                for k, (c, s, n) in self._series.items()
            )
        lines: List[str] = []
        for key, (counts, total, n) in items:
            for bound, c in zip(self.buckets, counts):
                le = f'le="{_format_value(bound)}"'
                lines.append(
                    f"{self._series_name(key, '_bucket', le)} {c}"
                )
            lines.append(
                f"{self._series_name(key, '_sum')} "
                f"{_format_value(total)}"
            )
            lines.append(f"{self._series_name(key, '_count')} {n}")
        return lines

    def dump(self) -> dict:
        with self._lock:
            series = [
                [list(k), list(c), s, n]
                for k, (c, s, n) in self._series.items()
            ]
        return {
            "type": self.type_name,
            "help": self.help,
            "labelnames": list(self.labelnames),
            # +Inf is implied by the renderer; keep the dump msgpack-
            # friendly (inf is not representable in JSON either).
            "buckets": [b for b in self.buckets if b != math.inf],
            "series": series,
        }


class MetricsRegistry:
    """Holds named metrics; the factory methods are idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # Collectors append extra exposition lines at render time
        # (e.g. the master's FleetAggregator rendering host-labeled
        # series from agent snapshots). A collector returns a list of
        # text lines; a raising collector is skipped, never fatal.
        self._collectors: List = []

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or tuple(
                    labelnames
                ) != existing.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type_name} with labels "
                        f"{existing.labelnames}"
                    )
                if "buckets" in kw:
                    bounds = sorted(float(b) for b in kw["buckets"])
                    if not bounds or bounds[-1] != math.inf:
                        bounds.append(math.inf)
                    if tuple(bounds) != existing.buckets:
                        raise ValueError(
                            f"histogram {name!r} already registered "
                            f"with buckets {existing.buckets}"
                        )
                return existing
            metric = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def add_collector(self, fn) -> None:
        """Register a callable returning extra exposition lines."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def dump(self) -> Dict[str, dict]:
        """Serializable snapshot of every metric (msgpack/JSON-able):
        ``{name: {type, help, labelnames, series, [buckets]}}`` — the
        payload an agent ships to the master's FleetAggregator."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.dump() for m in metrics}

    def render(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            metrics = sorted(
                self._metrics.values(), key=lambda m: m.name
            )
            collectors = list(self._collectors)
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.type_name}")
            lines.extend(m.render())
        for fn in collectors:
            try:
                lines.extend(fn())
            except Exception:  # noqa: BLE001 — a broken collector
                # must never take the /metrics endpoint down.
                pass
        return "\n".join(lines) + "\n"


# The process-wide default registry every layer instruments into.
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def counter(name, help="", labelnames=()) -> Counter:
    return _DEFAULT.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _DEFAULT.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(),
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return _DEFAULT.histogram(name, help, labelnames, buckets)
