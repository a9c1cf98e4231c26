"""Master-side distributed-trace assembly: bounded per-trace span
timelines, queryable over the control plane.

Every plane that runs *in* the master process (serving router,
remediation engine, rendezvous) feeds completed spans here directly;
spans emitted on other hosts arrive through the existing snapshot
event channel (``FleetAggregator.ingest`` forwards tracer events that
carry a ``trace_id``). The store is the serving counterpart of the
request ledger: ring retention (``max_traces`` newest traces, each
capped at ``max_spans_per_trace`` spans) keeps master RAM bounded
regardless of traffic volume — an evicted trace's timeline simply
becomes unknown to late queries.

A *span* is one dict: ``{name, span_id, parent_span_id, start_ts,
dur_s, tags}``. A *trace timeline* is the spans of one ``trace_id``
sorted by start time, plus the derived subject index (request ids,
``node:<id>``) the ``TraceQueryRequest`` RPC filters on. Assembly is
tolerant by design — orphan spans (parent evicted or never reported)
still render at the root, because a debugging surface must degrade to
"partial timeline", never to "no timeline".
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.obs import metrics as _metrics

_SPANS_TOTAL = _metrics.counter(
    "dlrover_trace_spans_total",
    "Spans ingested by the master's trace store, by source plane "
    "(serve / remediation / rdzv / snapshot / other)",
    ("plane",),
)
_TRACES_GAUGE = _metrics.gauge(
    "dlrover_trace_store_traces",
    "Traces currently retained in the master's bounded trace store",
)

# Default retention: like the router's request ledger, sized so a
# master never grows RAM with traffic volume. Env-tunable
# (DLROVER_TPU_TRACE_MAX_TRACES / _MAX_SPANS_PER_TRACE) for
# high-traffic masters that want deeper history.
MAX_TRACES = 512
MAX_SPANS_PER_TRACE = 256
MAX_TRACES_ENV = "DLROVER_TPU_TRACE_MAX_TRACES"
MAX_SPANS_ENV = "DLROVER_TPU_TRACE_MAX_SPANS_PER_TRACE"


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name, "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return default


def _plane_of(name: str) -> str:
    head = name.split(".", 1)[0]
    return (
        head
        if head in ("serve", "remediation", "rdzv", "pool", "stall")
        else "other"
    )


def _safe_tag(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class _Trace:
    __slots__ = ("spans", "subjects", "first_ts", "last_ts", "dropped")

    def __init__(self):
        self.spans: List[dict] = []
        self.subjects: set = set()
        self.first_ts = float("inf")
        self.last_ts = 0.0
        self.dropped = 0


class TraceStore:
    def __init__(
        self,
        max_traces: Optional[int] = None,
        max_spans_per_trace: Optional[int] = None,
        clock: Callable[[], float] = time.time,
    ):
        if max_traces is None:
            max_traces = _env_int(MAX_TRACES_ENV, MAX_TRACES)
        if max_spans_per_trace is None:
            max_spans_per_trace = _env_int(
                MAX_SPANS_ENV, MAX_SPANS_PER_TRACE
            )
        self.max_traces = max(int(max_traces), 1)
        self.max_spans_per_trace = max(int(max_spans_per_trace), 1)
        self.clock = clock
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()

    # -- ingest -----------------------------------------------------------

    def add_span(
        self,
        trace_id: str,
        name: str,
        start_ts: float,
        dur_s: float = 0.0,
        span_id: str = "",
        parent_span_id: str = "",
        **tags,
    ) -> bool:
        """Record one completed span. Returns False when the trace is
        at its span cap (the drop is counted on the trace)."""
        if not trace_id or not name:
            return False
        span = {
            "name": str(name),
            "span_id": str(span_id),
            "parent_span_id": str(parent_span_id),
            "start_ts": float(start_ts),
            "dur_s": max(float(dur_s), 0.0),
            "tags": {str(k): _safe_tag(v) for k, v in tags.items()},
        }
        subjects = set()
        rid = tags.get("request_id")
        if rid:
            subjects.add(str(rid))
        for key in ("node_id", "replica_id"):
            nid = tags.get(key)
            if nid is not None and nid != -1:
                subjects.add(f"node:{nid}")
        subj = tags.get("subject")
        if subj:
            subjects.add(str(subj))
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                tr = self._traces[trace_id] = _Trace()
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            else:
                self._traces.move_to_end(trace_id)
            if len(tr.spans) >= self.max_spans_per_trace:
                tr.dropped += 1
                return False
            tr.spans.append(span)
            tr.subjects.update(subjects)
            tr.first_ts = min(tr.first_ts, span["start_ts"])
            tr.last_ts = max(
                tr.last_ts, span["start_ts"] + span["dur_s"]
            )
            n_traces = len(self._traces)
        _SPANS_TOTAL.inc(plane=_plane_of(name))
        _TRACES_GAUGE.set(n_traces)
        return True

    def add_event(self, event: dict) -> bool:
        """Absorb one tracer-style event dict (the snapshot channel's
        payload shape). Events with ``dur_s`` are spans; without, they
        become zero-duration point spans. Events with no ``trace_id``
        are not trace material and are ignored."""
        if not isinstance(event, dict):
            return False
        trace_id = event.get("trace_id")
        if not trace_id:
            return False
        reserved = (
            "name", "ts", "mono", "dur_s", "trace_id", "span_id",
            "parent_span_id", "pid", "role", "rank", "parent",
        )
        tags = {
            k: v for k, v in event.items() if k not in reserved
        }
        return self.add_span(
            str(trace_id),
            str(event.get("name", "")),
            float(event.get("ts", 0.0) or self.clock()),
            dur_s=float(event.get("dur_s", 0.0) or 0.0),
            span_id=str(event.get("span_id", "") or ""),
            parent_span_id=str(event.get("parent_span_id", "") or ""),
            **tags,
        )

    def add_events(self, events) -> int:
        n = 0
        for e in events or ():
            if self.add_event(e):
                n += 1
        return n

    # -- query ------------------------------------------------------------

    def query(
        self,
        trace_id: str = "",
        subject: str = "",
        limit: int = 0,
    ) -> List[dict]:
        """Assembled timelines, newest-trace-last. ``trace_id`` wins
        when given; else ``subject`` filters by membership (a request
        id, or ``node:<id>``); else every retained trace. ``limit``
        > 0 keeps only the newest N — applied BEFORE assembly, and
        the (potentially large) span copies are built OUTSIDE the
        store lock, so one big read never stalls the router's or
        remediation engine's span writers."""
        with self._lock:
            if trace_id:
                tr = self._traces.get(trace_id)
                items = [(trace_id, tr)] if tr is not None else []
            else:
                items = [
                    (tid, tr)
                    for tid, tr in self._traces.items()
                    if not subject or subject in tr.subjects
                ]
            if limit and limit > 0:
                items = items[-limit:]
            # Snapshot references only; span dicts are never mutated
            # after add_span, so copying them is safe lock-free.
            snap = [
                (
                    tid, list(tr.spans), sorted(tr.subjects),
                    tr.first_ts if tr.spans else 0.0,
                    tr.last_ts, tr.dropped,
                )
                for tid, tr in items
            ]
        return [
            {
                "trace_id": tid,
                "start_ts": first,
                "end_ts": last,
                "subjects": subjects,
                "spans": sorted(
                    (dict(s) for s in spans),
                    key=lambda s: (s["start_ts"], s["name"]),
                ),
                "dropped_spans": dropped,
            }
            for tid, spans, subjects, first, last, dropped in snap
        ]

    def get(self, trace_id: str) -> Optional[dict]:
        out = self.query(trace_id=trace_id)
        return out[0] if out else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


def span_tree(timeline: dict) -> List[dict]:
    """Flatten one timeline into render order: depth-first by parent
    links, siblings by start time; each entry gains a ``depth``.
    Orphans (parent unknown/evicted) root at depth 0 — a partial
    trace still renders."""
    spans = timeline.get("spans", [])
    by_id: Dict[str, dict] = {
        s["span_id"]: s for s in spans if s.get("span_id")
    }
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        parent = s.get("parent_span_id", "")
        if parent and parent in by_id and by_id[parent] is not s:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    out: List[dict] = []
    seen: set = set()

    def walk(span: dict, depth: int) -> None:
        key = id(span)
        if key in seen:
            return
        seen.add(key)
        entry = dict(span)
        entry["depth"] = depth
        out.append(entry)
        for child in sorted(
            children.get(span.get("span_id", ""), ()),
            key=lambda s: (s["start_ts"], s["name"]),
        ):
            walk(child, depth + 1)

    for root in sorted(
        roots, key=lambda s: (s["start_ts"], s["name"])
    ):
        walk(root, 0)
    return out


def render_trace(timeline: dict) -> str:
    """Human rendering of one assembled trace — the body of
    ``obs_report --trace``."""
    lines = [
        f"trace {timeline.get('trace_id', '?')}: "
        f"{len(timeline.get('spans', []))} span(s), "
        f"subjects {', '.join(timeline.get('subjects', [])) or '-'}"
    ]
    start = timeline.get("start_ts", 0.0)
    for s in span_tree(timeline):
        tags = s.get("tags", {})
        tag_str = " ".join(
            f"{k}={tags[k]}" for k in sorted(tags)
            if tags[k] not in (None, "")
        )
        lines.append(
            "  " + "  " * s["depth"]
            + f"{s['name']}  +{s['start_ts'] - start:.3f}s"
            + (f"  {s['dur_s'] * 1e3:.1f}ms" if s["dur_s"] else "")
            + (f"  [{tag_str}]" if tag_str else "")
        )
    if timeline.get("dropped_spans"):
        lines.append(
            f"  ({timeline['dropped_spans']} span(s) dropped at the "
            "per-trace cap)"
        )
    return "\n".join(lines)
