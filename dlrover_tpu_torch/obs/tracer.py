"""Lightweight event tracer: spans/events with process/role/rank tags.

An event is one dict — ``{"name", "ts" (wall), "mono" (monotonic),
"pid", "role", "rank", ...tags}`` — appended to an in-memory ring and,
when a JSONL sink is configured, written as one line per event (flushed
immediately, so a SIGKILLed process loses at most the event in flight).
Spans are paired events: entering emits nothing, exiting emits
``name`` with ``dur_s`` and the span's start timestamps; nesting is
tracked per-thread and recorded as a ``parent`` tag.

Tracing is OFF by default. It turns on when ``DLROVER_TPU_TRACE_FILE``
(JSONL export path) or ``DLROVER_TPU_TRACE=1`` (in-memory only) is set
in the environment at first use, or explicitly via
:func:`configure_tracer`. Disabled, the module-level :func:`event` is
a single None-check and :func:`span` returns a shared no-op context
manager — well under a microsecond either way, cheap enough for
per-step hot paths.

Role/rank tags come from the environment: ``DLROVER_TPU_ROLE`` (set by
the elastic launcher) and ``JAX_PROCESS_INDEX`` /
``DLROVER_TPU_NODE_RANK``.

**Distributed tracing** (docs/OBSERVABILITY.md "Distributed
tracing"): a W3C-trace-context-shaped :class:`TraceContext`
(``trace_id`` / ``span_id`` / ``parent_span_id``, deterministic hex
ids from an injectable RNG seam — :func:`set_id_source`) can be
*activated* on the current thread (:func:`activate`); while active,
every span minted here chains onto it (child span ids, the same
trace id) and every event is tagged with the trace. :func:`inject`
serializes the active context for an RPC envelope and
:func:`extract` rebuilds it on the receiving side — the propagation
pair ``common/comm.py`` rides on every control-plane RPC. With no
active context both are a dict-lookup + ``None``, cheap enough for
the serving hot loop.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

TRACE_FILE_ENV = "DLROVER_TPU_TRACE_FILE"
TRACE_ENV = "DLROVER_TPU_TRACE"

_RING_SIZE = 4096

# Per-thread stack maps (span parents, active trace contexts) are
# swept for dead threads once they grow past this many entries: a
# churny replica/supervisor thread pool must not grow tracer state
# unboundedly. Entries also delete eagerly when their stack empties,
# so balanced span/activation usage never reaches the sweep.
_STACKS_SWEEP_AT = 64


class TraceContext:
    """One position in a distributed trace: which trace this process
    is contributing to (``trace_id``), the span it is inside
    (``span_id``), and that span's parent (``parent_span_id``, ""
    at the root)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_span_id: str = "",
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    def child(self) -> "TraceContext":
        """A new context for work caused by this one (same trace,
        fresh span id, parented here)."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def to_dict(self) -> Dict[str, str]:
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id:
            d["parent_span_id"] = self.parent_span_id
        return d

    def __repr__(self) -> str:  # debugging only
        return (
            f"TraceContext({self.trace_id[:8]}…/{self.span_id[:8]}…)"
        )


class IdSource:
    """Hex trace/span id generator over an injectable ``random.Random``
    — tests seed it for fully deterministic ids (there is no wall-
    clock or os.urandom dependence anywhere in id minting)."""

    def __init__(self, rng: Optional[random.Random] = None):
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()

    def trace_id(self) -> str:
        with self._lock:
            return f"{self._rng.getrandbits(128):032x}"

    def span_id(self) -> str:
        with self._lock:
            return f"{self._rng.getrandbits(64):016x}"


_id_source = IdSource()


def set_id_source(source: IdSource) -> IdSource:
    """Swap the id generator (tests pass ``IdSource(random.Random(0))``
    for reproducible ids). Returns the previous source."""
    global _id_source
    prev = _id_source
    _id_source = source
    return prev


def new_trace_id() -> str:
    return _id_source.trace_id()


def new_span_id() -> str:
    return _id_source.span_id()


def new_trace_context() -> TraceContext:
    """A root context for a brand-new trace."""
    return TraceContext(new_trace_id(), new_span_id(), "")


# -- per-thread active context ----------------------------------------------
# Keyed by the Thread OBJECT in a plain dict (NOT threading.local:
# local values can linger with churny thread pools, and an explicit
# map is sweepable; NOT the thread ident: the OS recycles idents, so
# an ident-keyed entry orphaned by a thread that died mid-span could
# be inherited — and its trace context mis-attributed — by an
# unrelated new thread. Thread objects are never recycled). Entries
# are deleted the moment their stack empties; the sweep below
# catches stacks orphaned by threads that died mid-activation.

_ctx_lock = threading.Lock()
_ctx_stacks: Dict[threading.Thread, list] = {}


def _sweep_dead_threads(stacks: Dict[threading.Thread, list]) -> None:
    """Drop stack entries belonging to dead threads. Caller holds the
    map's lock. O(entries) — only invoked past the high-water mark."""
    if len(stacks) < _STACKS_SWEEP_AT:
        return
    for t in [t for t in stacks if not t.is_alive()]:
        del stacks[t]


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Make ``ctx`` the current trace context for this thread for the
    duration of the ``with`` block (None = no-op). Server handlers
    activate the extracted caller context so the spans/events they
    emit land in the caller's trace."""
    if ctx is None:
        yield None
        return
    thread = threading.current_thread()
    with _ctx_lock:
        stack = _ctx_stacks.get(thread)
        if stack is None:
            _sweep_dead_threads(_ctx_stacks)
            stack = _ctx_stacks[thread] = []
        stack.append(ctx)
    try:
        yield ctx
    finally:
        with _ctx_lock:
            stack = _ctx_stacks.get(thread)
            if stack:
                stack.pop()
                if not stack:
                    del _ctx_stacks[thread]


def current_context() -> Optional[TraceContext]:
    """The active trace context on this thread (None when outside any
    activation/span)."""
    stack = _ctx_stacks.get(threading.current_thread())
    return stack[-1] if stack else None


def inject() -> Optional[Dict[str, str]]:
    """The active context as an envelope dict for an outgoing RPC
    (None — and no allocation — when no trace is active)."""
    ctx = current_context()
    return ctx.to_dict() if ctx is not None else None


def extract(carrier) -> Optional[TraceContext]:
    """Rebuild a :class:`TraceContext` from an envelope dict (the
    value :func:`inject` produced on the caller). Returns None for
    None/empty/malformed carriers — propagation must never make an
    RPC fail."""
    if not isinstance(carrier, dict):
        return None
    trace_id = carrier.get("trace_id")
    span_id = carrier.get("span_id")
    if not trace_id or not span_id:
        return None
    return TraceContext(
        str(trace_id),
        str(span_id),
        str(carrier.get("parent_span_id", "") or ""),
    )


def _process_tags() -> Dict[str, object]:
    # Shared role/rank env contract (one definition for logs + traces).
    from dlrover_tpu_torch.common.log import role_and_rank

    role, rank = role_and_rank()
    return {
        "pid": os.getpid(),
        "role": role or "unknown",
        "rank": rank,
    }


class Span:
    """Context manager produced by :meth:`EventTracer.span`.

    When a :class:`TraceContext` is active on the thread, the span
    mints a child span id, becomes the active context for its body
    (so nested spans and RPCs issued inside it chain correctly), and
    records ``trace_id`` / ``span_id`` / ``parent_span_id`` on its
    exit event. With no active context it costs exactly what it
    always did — names-only nesting, no id minting."""

    __slots__ = (
        "_tracer", "name", "tags", "_t0_wall", "_t0_mono", "_ctx",
    )

    def __init__(self, tracer: "EventTracer", name: str, tags: dict):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self._t0_wall = 0.0
        self._t0_mono = 0.0
        self._ctx: Optional[TraceContext] = None

    def __enter__(self) -> "Span":
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        parent_ctx = current_context()
        if parent_ctx is not None:
            self._ctx = parent_ctx.child()
            thread = threading.current_thread()
            with _ctx_lock:
                stack = _ctx_stacks.get(thread)
                if stack is None:
                    _sweep_dead_threads(_ctx_stacks)
                    stack = _ctx_stacks[thread] = []
                stack.append(self._ctx)
        self._tracer._span_stack().append(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = self._tracer._span_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        parent = stack[-1] if stack else ""
        if not stack:
            self._tracer._drop_span_stack()
        if self._ctx is not None:
            thread = threading.current_thread()
            with _ctx_lock:
                cstack = _ctx_stacks.get(thread)
                if cstack and cstack[-1] is self._ctx:
                    cstack.pop()
                    if not cstack:
                        del _ctx_stacks[thread]
        dur = time.monotonic() - self._t0_mono
        extra = dict(self.tags)
        if parent:
            extra["parent"] = parent
        if self._ctx is not None:
            extra["trace_id"] = self._ctx.trace_id
            extra["span_id"] = self._ctx.span_id
            if self._ctx.parent_span_id:
                extra["parent_span_id"] = self._ctx.parent_span_id
        if exc_type is not None:
            extra["error"] = exc_type.__name__
        self._tracer._emit(
            self.name,
            ts=self._t0_wall,
            mono=self._t0_mono,
            dur_s=round(dur, 6),
            **extra,
        )


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP_SPAN = _NoopSpan()


class EventTracer:
    def __init__(
        self,
        sink_path: Optional[str] = None,
        ring_size: int = _RING_SIZE,
    ):
        self.sink_path = sink_path
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_size
        )
        # Total events ever emitted: the arrival-order cursor for
        # events_since (a mono-timestamp watermark would silently drop
        # spans, which are emitted at exit but stamped with their
        # START mono).
        self._count = 0
        self._file = None
        # Per-thread span-name stacks, keyed by Thread OBJECT in an
        # explicit dict (NOT threading.local, and not the recyclable
        # thread ident — see _ctx_stacks): entries delete when their
        # stack empties, and a sweep drops stacks orphaned by threads
        # that died mid-span — a churny replica/supervisor thread
        # pool can't grow tracer state unboundedly.
        self._stacks_lock = threading.Lock()
        self._stacks: Dict[threading.Thread, list] = {}
        if sink_path:
            # Line-buffered append; O_APPEND keeps concurrent
            # single-line writes from interleaving mid-line.
            self._file = open(sink_path, "a", buffering=1)

    def _span_stack(self) -> list:
        thread = threading.current_thread()
        stack = self._stacks.get(thread)
        if stack is None:
            with self._stacks_lock:
                stack = self._stacks.get(thread)
                if stack is None:
                    _sweep_dead_threads(self._stacks)
                    stack = self._stacks[thread] = []
        return stack

    def _drop_span_stack(self) -> None:
        """Delete this thread's (now empty) span stack entry."""
        thread = threading.current_thread()
        with self._stacks_lock:
            stack = self._stacks.get(thread)
            if stack is not None and not stack:
                del self._stacks[thread]

    # -- emission --------------------------------------------------------

    def _emit(self, name: str, ts: Optional[float] = None,
              mono: Optional[float] = None, **tags) -> dict:
        record = {
            "name": name,
            "ts": ts if ts is not None else time.time(),
            "mono": mono if mono is not None else time.monotonic(),
            **_process_tags(),
            **tags,
        }
        if "trace_id" not in record:
            # A point event inside an active trace belongs to the
            # current span (parent_span_id); spans set their own ids
            # above and skip this.
            ctx = current_context()
            if ctx is not None:
                record["trace_id"] = ctx.trace_id
                record["parent_span_id"] = ctx.span_id
        with self._lock:
            self._ring.append(record)
            self._count += 1
            if self._file is not None:
                try:
                    self._file.write(
                        json.dumps(record, default=str) + "\n"
                    )
                except (OSError, ValueError):
                    # A dead sink must never take training down.
                    self._file = None
        return record

    def event(self, name: str, **tags) -> dict:
        return self._emit(name, **tags)

    def span(self, name: str, **tags) -> Span:
        return Span(self, name, tags)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def events_since(self, cursor: int):
        """``(new_events, next_cursor)`` in ARRIVAL order. ``cursor``
        is the value returned by the previous call (0 to start).
        Events that fell off the bounded ring before being read are
        lost; a cursor from a replaced tracer (> count) resets."""
        with self._lock:
            count = self._count
            if cursor < 0 or cursor > count:
                cursor = max(0, count - len(self._ring))
            new = count - max(cursor, count - len(self._ring))
            events = list(self._ring)[-new:] if new > 0 else []
            return events, count

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# -- module-level fast path -------------------------------------------------

_tracer: Optional[EventTracer] = None
_init_done = False
_init_lock = threading.Lock()


def _lazy_init() -> Optional[EventTracer]:
    global _tracer, _init_done
    with _init_lock:
        if _init_done:
            return _tracer
        path = os.getenv(TRACE_FILE_ENV, "")
        if path:
            _tracer = EventTracer(sink_path=path)
        elif os.getenv(TRACE_ENV, "") == "1":
            _tracer = EventTracer()
        _init_done = True
        return _tracer


def configure_tracer(
    sink_path: Optional[str] = None, ring_size: int = _RING_SIZE
) -> EventTracer:
    """Explicitly enable tracing (tests, notebooks). Replaces any
    active tracer."""
    global _tracer, _init_done
    with _init_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = EventTracer(sink_path=sink_path, ring_size=ring_size)
        _init_done = True
        return _tracer


def disable_tracer() -> None:
    global _tracer, _init_done
    with _init_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None
        _init_done = True


def get_tracer() -> Optional[EventTracer]:
    if not _init_done:
        return _lazy_init()
    return _tracer


def tracing_enabled() -> bool:
    return get_tracer() is not None


def event(name: str, **tags) -> Optional[dict]:
    """Record an event; a no-op None-check when tracing is disabled."""
    tr = _tracer if _init_done else _lazy_init()
    if tr is None:
        return None
    return tr.event(name, **tags)


def span(name: str, **tags):
    """Span context manager; a shared no-op when tracing is disabled."""
    tr = _tracer if _init_done else _lazy_init()
    if tr is None:
        return _NOOP_SPAN
    return tr.span(name, **tags)
