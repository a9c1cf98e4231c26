"""Master-side serving router: the traffic half of the control plane.

The master already knows how to keep a *fleet* honest — node table,
heartbeat watchdog, health verdicts, governed remediation, ScalePlans.
This router gives the same machinery *requests* to protect:

* a **request ledger** (queued → dispatched → done/failed) mirroring
  the task manager's shard ledger: replicas PULL work (like
  ``get_task``) and REPORT completions, so a dead replica simply
  stops pulling and its dispatched requests are *requeued*, not lost
  — a replica kill costs latency, never requests;
* a **replica registry** fed by the existing node table (replicas
  register as ``NodeType.REPLICA`` through the normal
  ``NodeAddressRequest`` path, heartbeat like any node; the node
  watchdog's DELETED event routes here as :meth:`replica_gone`);
* a **progress watchdog**: a replica holding dispatched work without
  progress past ``progress_timeout_s`` surfaces through
  :meth:`unhealthy_replicas` — the feed of the health plane's
  ``replica_unhealthy`` detector, which in turn drives the
  remediation ladder drain → restart → replace;
* **SLO-driven scaling** through the ScalePlan seam:
  :meth:`maybe_autoscale` grows the replica role when the queue backs
  up or completion p99 breaches ``p99_slo_s``, and shrinks idle
  capacity down to ``min_replicas`` — the same
  ``JobManager.ensure_role`` / ``retire_node`` seams training
  elasticity uses.

First completion wins: a request requeued off a slow-but-alive
replica may later be completed twice; the ledger keeps the first
result and drops the duplicate (same idempotence contract as the
shard ledger's replayed task results).

Every knob reads ``DLROVER_TPU_SERVE_<KNOB>`` (see DEFAULTS),
overridable per-instance via ``config=``; the clock is injectable so
the watchdog and SLO windows are hermetically testable.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs import tracer as _trace
from dlrover_tpu_torch.serving import handoff as handoff_mod
from dlrover_tpu_torch.serving.scheduler import (
    ROLE_DECODE,
    ROLE_MIXED,
    ROLE_PREFILL,
    ROLES,
    ServeRequest,
)

logger = get_logger("serving.router")

SERVE_ENV_PREFIX = "DLROVER_TPU_SERVE_"

REQ_QUEUED = "queued"
REQ_DISPATCHED = "dispatched"  # on a MIXED replica (colocated)
# Disaggregated stages (docs/SERVING.md "Prefill/decode
# disaggregation"): prompt on a PREFILL replica -> KV payload staged
# at the master -> streaming on a DECODE replica.
REQ_PREFILLING = "prefilling"
REQ_HANDOFF = "handoff"
REQ_DECODING = "decoding"
REQ_DONE = "done"
REQ_FAILED = "failed"

# States owned by a live replica (requeue targets on drain/death).
DISPATCHED_STATES = (REQ_DISPATCHED, REQ_PREFILLING, REQ_DECODING)

REPLICA_READY = "ready"
REPLICA_DRAINING = "draining"

_REQUESTS_TOTAL = obs.counter(
    "dlrover_serve_requests_total",
    "Requests through the serving router, by outcome (submitted / "
    "completed / failed / requeued / rejected / duplicate)",
    ("outcome",),
)
_ROUTER_QUEUE = obs.gauge(
    "dlrover_serve_queue_depth",
    "Requests queued at the router awaiting dispatch to a replica",
)
_ROUTER_INFLIGHT = obs.gauge(
    "dlrover_serve_inflight",
    "Requests currently dispatched to replicas and not yet completed",
)
_REPLICAS_GAUGE = obs.gauge(
    "dlrover_serve_replicas",
    "Registered serving replicas, by state (ready / draining)",
    ("state",),
)
_ROLE_REPLICAS_GAUGE = obs.gauge(
    "dlrover_serve_role_replicas",
    "Registered serving replicas by disaggregation role (mixed / "
    "prefill / decode)",
    ("role",),
)
_P99_GAUGE = obs.gauge(
    "dlrover_serve_p99_latency_seconds",
    "p99 end-to-end request latency over the router's recent window",
)
_QPS_GAUGE = obs.gauge(
    "dlrover_serve_qps",
    "Completed requests per second over the router's recent window",
)
_TTFT_PHASE_SECONDS = obs.histogram(
    "dlrover_serve_ttft_phase_seconds",
    "Router-observed time-to-first-token decomposed by phase: queue "
    "(router queue incl. requeue waits), dispatch (replica admission "
    "wait), prefill, first_decode — the phases sum to the request's "
    "observed TTFT",
    ("phase",),
    buckets=(0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
_REQUEUE_HOPS = obs.histogram(
    "dlrover_serve_requeue_hops",
    "Requeue hops a request took before completing (0 = finished on "
    "its first replica), observed per completed request's trace",
    buckets=(0.0, 1.0, 2.0, 3.0, 5.0, 8.0),
)

DEFAULTS: Dict[str, float] = {
    # A ready replica holding dispatched work with no progress for
    # this long is unhealthy (feeds the replica_unhealthy verdict);
    # a draining one that never came back keeps the verdict alive so
    # the remediation ladder can escalate drain -> restart -> replace.
    "progress_timeout_s": 10.0,
    "max_queue": 4096.0,
    # scaling SLOs
    "p99_slo_s": 30.0,
    "backlog_per_replica": 8.0,
    "min_replicas": 1.0,
    "max_replicas": 8.0,
    "scale_cooldown_s": 60.0,
    # completed-latency / QPS windows
    "latency_window": 256.0,
    "qps_window_s": 60.0,
    # finished-request ledger retention: done/failed records past
    # this count are evicted oldest-first (their results become
    # unknown to late pollers) — the master-side bounded-history
    # invariant; cumulative done/failed counters survive eviction
    "ledger_retention": 4096.0,
    # autoscale evaluation cadence (ServingRouter.start's thread)
    "autoscale_interval_s": 15.0,
    # -- prefill/decode disaggregation --------------------------------
    # Staged-handoff byte budget: a completed prefill whose KV would
    # push the master past this falls back to recompute (requeued to
    # the prompt stage — bounded master RAM, zero drops).
    "handoff_max_bytes": 64.0 * 1024 * 1024,
    # Per-role SLO autoscaling (active once any prefill/decode-role
    # replica registers). Prefill count scales on the raw-prompt
    # backlog and the queue+prefill TTFT phases; decode count on the
    # TPOT p99 SLO, staged-handoff backlog, and decode-pool KV
    # utilization.
    "min_prefill": 1.0,
    "max_prefill": 8.0,
    "min_decode": 1.0,
    "max_decode": 8.0,
    "tpot_slo_s": 0.0,  # 0 = disabled
    "ttft_slo_s": 0.0,  # 0 = disabled (queue+prefill phase p99)
    "kv_util_high": 0.9,
    "handoff_backlog_per_decode": 8.0,
    # recent-phase sample window for the per-phase SLO judgments
    "phase_window": 256.0,
}


class _Replica:
    __slots__ = (
        "node_id", "addr", "state", "role", "registered_ts",
        "last_progress_ts", "stats", "dispatched", "drains",
    )

    def __init__(
        self,
        node_id: int,
        addr: str,
        now: float,
        role: str = ROLE_MIXED,
    ):
        self.node_id = node_id
        self.addr = addr
        self.state = REPLICA_READY
        self.role = role
        self.registered_ts = now
        self.last_progress_ts = now
        self.stats: dict = {}
        self.dispatched: set = set()
        self.drains = 0


class _Request:
    __slots__ = (
        "req", "state", "replica_id", "submit_ts", "dispatch_ts",
        "done_ts", "tokens", "error", "requeues", "ttft_s", "tpot_s",
        "finish_reason", "order", "trace_id", "root_span",
        "root_parent", "hops", "phases",
    )

    def __init__(self, req: ServeRequest, now: float):
        self.req = req
        self.order = 0  # monotonic submission sequence (the router)
        self.state = REQ_QUEUED
        self.replica_id = -1
        self.submit_ts = now
        self.dispatch_ts = 0.0
        self.done_ts = 0.0
        self.tokens: List[int] = []
        self.error = ""
        self.requeues = 0
        self.ttft_s = 0.0
        self.tpot_s = 0.0
        self.finish_reason = ""
        # Distributed trace: one trace per request, minted at submit
        # (or adopted from the caller's RPC context); hops are the
        # dispatch intervals [{replica_id, dispatch_ts, end_ts, end}]
        # the trace timeline is assembled from.
        self.trace_id = ""
        self.root_span = ""
        # When the trace is ADOPTED from the caller's RPC context,
        # the request root parents under the caller's span so the
        # cross-process causality renders as one tree.
        self.root_parent = ""
        self.hops: List[dict] = []
        self.phases: Dict[str, float] = {}


class ServingRouter:
    def __init__(
        self,
        job_manager=None,
        clock: Callable[[], float] = time.time,
        config: Optional[Dict[str, float]] = None,
        job_name: str = "default",
        trace_sink=None,
    ):
        """``trace_sink`` is the master's
        :class:`~dlrover_tpu_torch.obs.trace_store.TraceStore` (or None):
        the router assembles every request's causal timeline into it
        — queue waits, per-replica hops closed by requeue or
        completion, and the completing hop's TTFT phase spans."""
        self.job_manager = job_manager
        self.clock = clock
        self.job_name = job_name
        self.trace_sink = trace_sink
        self._config = dict(config or {})
        self._lock = threading.Lock()
        self._replicas: Dict[int, _Replica] = {}
        self._requests: Dict[str, _Request] = {}
        self._queue: deque = deque()  # request ids awaiting dispatch
        # Disaggregation: completed prefills staged for a decode
        # replica's pull. _handoffs maps rid -> {"payload": wire
        # dict, "staged_ts", "from_replica", "bytes"}; the payload
        # leaves the master at dispatch (a decode-replica death
        # re-prefills — the master never retains KV for in-flight
        # decodes, so its RAM stays bounded by handoff_max_bytes).
        self._handoff_queue: deque = deque()
        self._handoffs: Dict[str, dict] = {}
        self._handoff_bytes = 0
        # Recent per-phase TTFT samples + TPOT samples (the per-role
        # SLO autoscaler's evidence; same bounded-window discipline
        # as _done_latencies).
        window = int(self._cfg("phase_window"))
        self._phase_recent: Dict[str, deque] = {
            phase: deque(maxlen=window)
            for phase in ("queue", "prefill")
        }
        self._tpot_recent: deque = deque(maxlen=window)
        self._seq = itertools.count(1)
        self._done_latencies: deque = deque(
            maxlen=int(self._cfg("latency_window"))
        )
        self._done_stamps: deque = deque(maxlen=4096)
        self._requeued_total = 0
        self._last_scale_ts = 0.0
        # Once-per-blocked-transition damper for grant-withheld
        # scale-ups (the blocked branch deliberately does not burn
        # the scale cooldown, so without this every evaluation tick
        # under sustained pressure would re-log and re-emit).
        self._grant_block_logged = False
        # Bounded finished-record retention (eviction order) +
        # cumulative outcome counters that survive eviction.
        self._finished: deque = deque()
        self._done_total = 0
        self._failed_total = 0
        # The slowest observed TTFT and its phase breakdown (the
        # obs_report --serving "worst trace" line): where the p99
        # lives, not just what it is.
        self._worst_ttft: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _span(
        self,
        rec: "_Request",
        name: str,
        start: float,
        dur: float,
        span_id: str = "",
        parent: Optional[str] = None,
        **tags,
    ) -> None:
        """Record one span of ``rec``'s trace into the sink (no-op
        without one). Default parent is the request's root span."""
        if self.trace_sink is None or not rec.trace_id:
            return
        self.trace_sink.add_span(
            rec.trace_id,
            name,
            start,
            dur_s=max(dur, 0.0),
            span_id=span_id,
            parent_span_id=(
                rec.root_span if parent is None else parent
            ),
            request_id=rec.req.request_id,
            **tags,
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start the background autoscale/SLO loop (the JobMaster
        wires this into prepare/stop). Idle-cheap: the loop no-ops
        until the serving plane has ever seen a replica or request."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serving-router", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._cfg("autoscale_interval_s")):
            try:
                self.maybe_autoscale()
                self._publish_slo()
            except Exception:  # noqa: BLE001 — a scaling bug must
                # not kill the loop (and with it all future scaling)
                logger.warning(
                    "serving autoscale tick failed", exc_info=True
                )

    # -- config -----------------------------------------------------------

    def _cfg(self, knob: str) -> float:
        if knob in self._config:
            return float(self._config[knob])
        env = os.getenv(SERVE_ENV_PREFIX + knob.upper(), "")
        if env:
            try:
                return float(env)
            except ValueError:
                logger.warning(
                    "bad %s%s=%r; using default %s",
                    SERVE_ENV_PREFIX, knob.upper(), env,
                    DEFAULTS[knob],
                )
        return DEFAULTS[knob]

    # -- replica registry ---------------------------------------------------

    def register_replica(
        self, node_id: int, addr: str = "", role: str = ROLE_MIXED
    ) -> None:
        """A replica announced itself (NodeAddressRequest with
        node_type=replica routes here from the servicer). Re-register
        after a restart clears a drain — the fresh process is ready.
        ``role`` types the replica for two-stage dispatch: prefill
        replicas are fed raw prompts, decode replicas staged
        handoffs, mixed both."""
        if role not in ROLES:
            logger.warning(
                "replica %d registered with unknown role %r; "
                "treating as mixed", node_id, role,
            )
            role = ROLE_MIXED
        now = self.clock()
        requeued = 0
        with self._lock:
            rep = self._replicas.get(node_id)
            if rep is None:
                self._replicas[node_id] = _Replica(
                    node_id, addr, now, role=role
                )
            else:
                # A re-registration is a NEW incarnation: whatever
                # the old one still held is gone from its memory, so
                # requeue it now rather than waiting for the
                # progress watchdog to notice.
                requeued = self._requeue_locked(rep)
                rep.addr = addr or rep.addr
                rep.state = REPLICA_READY
                rep.role = role
                rep.last_progress_ts = now
        if requeued:
            self._publish_queue()
        self._publish_replicas()
        obs.event(
            "serve.replica_ready", replica_id=node_id, addr=addr,
            role=role,
        )
        logger.info(
            "serving replica %d registered (%s, role=%s)",
            node_id, addr, role,
        )

    def role_of(self, node_id: int) -> str:
        """The registered role of a replica (mixed when unknown) —
        the remediation engine labels replacements with it so a
        replaced prefill replica comes back a prefill replica."""
        with self._lock:
            rep = self._replicas.get(node_id)
            return rep.role if rep is not None else ROLE_MIXED

    def drain_replica(
        self,
        node_id: int,
        reason: str = "",
        link: Optional[tuple] = None,
    ) -> int:
        """Stop dispatching to a replica and requeue everything it
        holds. Returns the number of requests requeued. The replica
        stays registered (a restart re-registers it ready); the
        remediation engine's drain rung calls this, passing its
        decision trace as ``link`` (``(trace_id, parent_span_id)``)
        so the requeues it causes join the decision's timeline."""
        with self._lock:
            rep = self._replicas.get(node_id)
            if rep is None:
                return 0
            rep.state = REPLICA_DRAINING
            rep.drains += 1
            n = self._requeue_locked(rep, link=link)
        self._publish_replicas()
        self._publish_queue()
        obs.event(
            "serve.drain", replica_id=node_id, requeued=n,
            reason=reason,
            **(
                {"trace_id": link[0], "parent_span_id": link[1]}
                if link
                else {}
            ),
        )
        logger.warning(
            "draining serving replica %d (%s): %d request(s) requeued",
            node_id, reason or "operator", n,
        )
        return n

    def replica_gone(self, node_id: int) -> int:
        """The node table declared the replica dead (heartbeat
        timeout, pod deleted): forget it and requeue its in-flight
        requests. Idempotent."""
        with self._lock:
            rep = self._replicas.pop(node_id, None)
            n = self._requeue_locked(rep) if rep is not None else 0
        if rep is None:
            return 0
        self._publish_replicas()
        self._publish_queue()
        obs.event(
            "serve.replica_gone", replica_id=node_id, requeued=n
        )
        logger.warning(
            "serving replica %d gone: %d request(s) requeued",
            node_id, n,
        )
        return n

    def _requeue_locked(
        self, rep: _Replica, link: Optional[tuple] = None
    ) -> int:
        """Move every request dispatched to ``rep`` back to the FRONT
        of the queue, oldest submission first (they have waited
        longest). Caller holds the lock. ``link`` is the causing
        remediation decision's ``(trace_id, parent_span_id)``: each
        requeue is then ALSO recorded as a span of that decision's
        trace, so verdict -> drain -> requeue reads as one causal
        chain."""
        now = self.clock()
        n = 0
        pending = [
            (self._requests[rid].order, rid)
            for rid in rep.dispatched
            if rid in self._requests
        ]
        # appendleft in newest-first submission order leaves the
        # OLDEST at the very front of the queue.
        for _, rid in sorted(pending, reverse=True):
            rec = self._requests.get(rid)
            if rec is None or rec.state not in DISPATCHED_STATES:
                continue
            if rec.state == REQ_DECODING:
                # The decode replica held the only copy of this
                # sequence's KV (the master dropped its staged
                # payload at dispatch): back to the PROMPT stage —
                # a decode-replica kill re-prefills, exact for
                # greedy, zero drops.
                handoff_mod.note_outcome("reprefill")
            # Drop any dispatched payload still referenced off the
            # ledger record: retaining KV bytes past the replica
            # handoff would break the handoff_max_bytes RAM bound.
            rec.req.handoff = None
            rec.state = REQ_QUEUED
            rec.replica_id = -1
            rec.requeues += 1
            self._queue.appendleft(rid)
            n += 1
            _REQUESTS_TOTAL.inc(outcome="requeued")
            # Close the lost hop in the request's own trace.
            hop = rec.hops[-1] if rec.hops else None
            if hop is not None and not hop["end"]:
                hop["end_ts"] = now
                hop["end"] = "requeue"
                self._span(
                    rec, "serve.hop", hop["dispatch_ts"],
                    now - hop["dispatch_ts"],
                    span_id=hop["span_id"],
                    replica_id=rep.node_id,
                    hop=len(rec.hops) - 1,
                    end="requeue",
                )
            obs.event(
                "serve.requeue", request_id=rid,
                replica_id=rep.node_id, hop=rec.requeues,
                trace_id=rec.trace_id,
                parent_span_id=rec.root_span,
            )
            if link is not None and self.trace_sink is not None:
                self.trace_sink.add_span(
                    link[0], "serve.requeue", now,
                    parent_span_id=link[1],
                    request_id=rid,
                    replica_id=rep.node_id,
                    link_trace_id=rec.trace_id,
                )
        rep.dispatched.clear()
        self._requeued_total += n
        return n

    # -- request lifecycle --------------------------------------------------

    def submit(
        self,
        prompt: List[int],
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        request_id: str = "",
    ) -> Optional[str]:
        """Accept a request into the ledger. Returns its id, or None
        when the queue is full (backpressure). A caller-supplied
        ``request_id`` is an idempotence token: resubmitting an id the
        ledger knows returns it unchanged."""
        with self._lock:
            if request_id and request_id in self._requests:
                _REQUESTS_TOTAL.inc(outcome="duplicate")
                return request_id
            if len(self._queue) >= int(self._cfg("max_queue")):
                _REQUESTS_TOTAL.inc(outcome="rejected")
                return None
            order = next(self._seq)
            rid = request_id
            if not rid:
                # Auto ids must never collide with a caller-supplied
                # idempotence token already in the ledger (the
                # collision would overwrite the other caller's record
                # and hand them someone else's tokens).
                rid = f"req-{order}"
                while rid in self._requests:
                    order = next(self._seq)
                    rid = f"req-{order}"
            rec = _Request(
                ServeRequest(
                    request_id=rid,
                    prompt=list(prompt),
                    max_new_tokens=max_new_tokens,
                    temperature=temperature,
                ),
                self.clock(),
            )
            rec.order = order
            # Mint the request's distributed trace at submit — or
            # adopt the caller's (the RPC envelope's context is active
            # on this handler thread). Every hop, requeue, and phase
            # span of this request's life carries this trace id.
            ctx = _trace.current_context()
            rec.trace_id = (
                ctx.trace_id if ctx is not None else _trace.new_trace_id()
            )
            rec.root_span = _trace.new_span_id()
            rec.root_parent = ctx.span_id if ctx is not None else ""
            rec.req.trace = {
                "trace_id": rec.trace_id,
                "span_id": rec.root_span,
            }
            self._requests[rid] = rec
            self._queue.append(rid)
        _REQUESTS_TOTAL.inc(outcome="submitted")
        obs.event(
            "serve.submit",
            request_id=rid,
            trace_id=rec.trace_id,
            parent_span_id=rec.root_span,
        )
        self._publish_queue()
        return rid

    def pull(self, replica_id: int, max_items: int = 1) -> List[ServeRequest]:
        """A replica asks for work. Only READY replicas are fed; the
        pull itself counts as progress (the replica is alive and
        asking). Dispatch is role-typed: PREFILL replicas take raw
        prompts, DECODE replicas take staged handoffs (the KV payload
        rides out attached to the work item and leaves the master),
        MIXED drain raw prompts first and then handoffs — a mixed
        fleet keeps every stage moving even when one role's fleet is
        momentarily empty."""
        now = self.clock()
        out: List[ServeRequest] = []
        staged_waits: List[float] = []
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or rep.state != REPLICA_READY:
                return []
            rep.last_progress_ts = now
            while len(out) < max_items:
                from_handoff = False
                rid = None
                if rep.role == ROLE_DECODE:
                    if self._handoff_queue:
                        rid = self._handoff_queue.popleft()
                        from_handoff = True
                elif self._queue:
                    rid = self._queue.popleft()
                elif rep.role == ROLE_MIXED and self._handoff_queue:
                    rid = self._handoff_queue.popleft()
                    from_handoff = True
                if rid is None:
                    break
                rec = self._requests.get(rid)
                if from_handoff:
                    staged = self._handoffs.pop(rid, None)
                    if rec is None or rec.state != REQ_HANDOFF:
                        if staged is not None:
                            self._handoff_bytes -= staged["bytes"]
                        continue
                    if staged is None:
                        # Payload lost (should not happen): back to
                        # the prompt stage — recompute, never drop.
                        rec.state = REQ_QUEUED
                        self._queue.appendleft(rid)
                        handoff_mod.note_outcome("reprefill")
                        continue
                    self._handoff_bytes -= staged["bytes"]
                    rec.state = REQ_DECODING
                    rec.req.handoff = staged["payload"]
                    wait = now - staged["staged_ts"]
                    staged_waits.append(wait)
                    handoff_mod.note_outcome("dispatched")
                    # The staged interval is the request's
                    # serve.handoff hop: prefill replica -> master
                    # -> decode replica, joining the causal chain
                    # between the two serve.hop spans.
                    self._span(
                        rec, "serve.handoff", staged["staged_ts"],
                        wait, hop=len(rec.hops),
                        from_replica=staged["from_replica"],
                        to_replica=replica_id,
                    )
                else:
                    if rec is None or rec.state != REQ_QUEUED:
                        continue
                    rec.state = (
                        REQ_PREFILLING
                        if rep.role == ROLE_PREFILL
                        else REQ_DISPATCHED
                    )
                    rec.req.handoff = None
                    # Close the queue interval and open this hop in
                    # the trace: queue time since submit (hop 0) or
                    # since the previous hop ended (requeue wait).
                    queued_since = (
                        rec.hops[-1]["end_ts"]
                        if rec.hops
                        else rec.submit_ts
                    )
                    self._span(
                        rec, "serve.queue", queued_since,
                        now - queued_since, hop=len(rec.hops),
                    )
                rec.replica_id = replica_id
                rec.dispatch_ts = now
                rec.hops.append(
                    {
                        "replica_id": replica_id,
                        "dispatch_ts": now,
                        "end_ts": 0.0,
                        "end": "",
                        "stage": rec.state,
                        "span_id": _trace.new_span_id()
                        if rec.trace_id
                        else "",
                    }
                )
                rep.dispatched.add(rid)
                out.append(rec.req)
        for wait in staged_waits:
            handoff_mod.observe_staged_wait(wait)
        if out:
            self._publish_queue()
        return out

    def complete(
        self,
        replica_id: int,
        request_id: str,
        tokens: List[int],
        ttft_s: float = 0.0,
        tpot_s: float = 0.0,
        finish_reason: str = "",
        error: str = "",
        phases: Optional[Dict[str, float]] = None,
        handoff: Optional[dict] = None,
    ) -> bool:
        """A replica finished (or failed) a request. First completion
        wins; late duplicates from a replica the request was requeued
        off are dropped. Completions are accepted from ANY replica —
        after a requeue the original owner may still land the result
        first, which is a win, not an error.

        ``handoff`` (a packed HandoffPayload wire dict) turns the
        report into a STAGE TRANSITION instead of a completion: the
        prefill replica finished the prompt, and the request moves to
        the handoff stage awaiting a decode replica's pull."""
        now = self.clock()
        if handoff and not error:
            return self._stage_handoff(
                replica_id, request_id, handoff, now
            )
        with self._lock:
            rec = self._requests.get(request_id)
            if rec is None:
                _REQUESTS_TOTAL.inc(outcome="duplicate")
                return False
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.dispatched.discard(request_id)
            if rec.state in (REQ_DONE, REQ_FAILED):
                # A replayed completion is not serving progress: a
                # drained replica spewing stale results must not
                # reset the watchdog.
                _REQUESTS_TOTAL.inc(outcome="duplicate")
                return False
            if rep is not None:
                rep.last_progress_ts = now
            owner = self._replicas.get(rec.replica_id)
            if owner is not None and owner is not rep:
                owner.dispatched.discard(request_id)
            if rec.state == REQ_HANDOFF:
                # Completed while staged (only an error report can
                # land here — e.g. the prefill replica double-
                # reported): drop the staged payload with the
                # completion.
                self._drop_staged_locked(request_id)
            if rec.state == REQ_QUEUED:
                # Completed by the original owner after a requeue but
                # before re-dispatch: take the result and drop the
                # queued copy at next pull (state check there).
                try:
                    self._queue.remove(request_id)
                except ValueError:
                    pass
            rec.state = REQ_FAILED if error else REQ_DONE
            # The finished record lives in the ledger until
            # retention evicts it: it must not pin a dispatched KV
            # payload's bytes for that whole window.
            rec.req.handoff = None
            rec.replica_id = replica_id
            rec.done_ts = now
            rec.tokens = list(tokens)
            rec.error = error
            rec.ttft_s = ttft_s
            rec.tpot_s = tpot_s
            rec.finish_reason = finish_reason
            rec.phases = {
                str(k): float(v) for k, v in (phases or {}).items()
            }
            if error:
                self._failed_total += 1
            else:
                self._done_total += 1
                self._done_latencies.append(now - rec.submit_ts)
                self._done_stamps.append(now)
            self._finish_trace_locked(rec, replica_id, now)
            self._note_finished_locked(request_id)
        _REQUESTS_TOTAL.inc(
            outcome="failed" if error else "completed"
        )
        self._publish_queue()
        # SLO gauges (p99 sort + QPS window scan) deliberately NOT
        # recomputed per completion: the router thread refreshes
        # them every autoscale_interval_s, off the RPC hot path.
        return True

    def _note_finished_locked(self, request_id: str) -> None:
        """Bounded ledger: finished records past the retention evict
        oldest-first (the result becomes unknown to late pollers;
        cumulative counters keep the totals) — the master must never
        grow RAM with traffic volume. Caller holds the lock."""
        self._finished.append(request_id)
        retention = int(self._cfg("ledger_retention"))
        while len(self._finished) > retention:
            old = self._finished.popleft()
            old_rec = self._requests.get(old)
            if old_rec is not None and old_rec.state in (
                REQ_DONE, REQ_FAILED
            ):
                del self._requests[old]

    def _drop_staged_locked(self, rid: str) -> None:
        staged = self._handoffs.pop(rid, None)
        if staged is not None:
            self._handoff_bytes -= staged["bytes"]
            try:
                self._handoff_queue.remove(rid)
            except ValueError:
                pass

    def _stage_handoff(
        self, replica_id: int, request_id: str, wire: dict, now: float
    ) -> bool:
        """A prefill replica reports a completed prompt with its KV
        payload: move the request to the handoff stage (awaiting a
        decode replica's pull). First report wins, like completions.
        Budget semantics: a payload that would push the STAGED total
        past ``handoff_max_bytes`` (but fits it alone) falls back to
        the prompt queue — the staging store is draining, so the
        recompute will land once a decode replica frees room. A
        payload that exceeds the budget BY ITSELF can never be
        staged: re-prefilling it would loop forever in a pure
        prefill+decode fleet, so the request fails terminally with
        the reason surfaced to the caller."""
        overflow = False
        oversize = False
        with self._lock:
            rec = self._requests.get(request_id)
            if rec is None:
                _REQUESTS_TOTAL.inc(outcome="duplicate")
                return False
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.dispatched.discard(request_id)
            if rec.state in (
                REQ_DONE, REQ_FAILED, REQ_HANDOFF, REQ_DECODING
            ):
                # Already past the prefill stage (a late duplicate
                # from a replica the request was requeued off).
                _REQUESTS_TOTAL.inc(outcome="duplicate")
                return False
            if rep is not None:
                rep.last_progress_ts = now
            owner = self._replicas.get(rec.replica_id)
            if owner is not None and owner is not rep:
                owner.dispatched.discard(request_id)
            if rec.state == REQ_QUEUED:
                # Requeued off the reporting replica before its
                # handoff landed: the prefill IS done — take the
                # request out of the prompt queue and use it.
                try:
                    self._queue.remove(request_id)
                except ValueError:
                    pass
            nbytes = handoff_mod.payload_nbytes(wire)
            budget = int(self._cfg("handoff_max_bytes"))
            oversize = nbytes > budget
            overflow = (
                not oversize
                and self._handoff_bytes + nbytes > budget
            )
            hop = rec.hops[-1] if rec.hops else None
            if hop is not None and not hop["end"]:
                hop["end_ts"] = now
                hop["end"] = "failed" if oversize else "handoff"
                self._span(
                    rec, "serve.hop", hop["dispatch_ts"],
                    now - hop["dispatch_ts"],
                    span_id=hop["span_id"],
                    replica_id=replica_id,
                    hop=len(rec.hops) - 1,
                    end=hop["end"],
                )
            if oversize:
                rec.state = REQ_FAILED
                rec.replica_id = replica_id
                rec.done_ts = now
                rec.error = (
                    f"handoff payload {nbytes} B exceeds "
                    f"handoff_max_bytes {budget} B"
                )
                self._failed_total += 1
                handoff_mod.note_outcome("oversize")
                _REQUESTS_TOTAL.inc(outcome="failed")
                self._finish_trace_locked(rec, replica_id, now)
                self._note_finished_locked(request_id)
            elif overflow:
                rec.state = REQ_QUEUED
                rec.replica_id = -1
                rec.requeues += 1
                self._queue.appendleft(request_id)
                handoff_mod.note_outcome("overflow")
                _REQUESTS_TOTAL.inc(outcome="requeued")
            else:
                rec.state = REQ_HANDOFF
                self._handoffs[request_id] = {
                    "payload": wire,
                    "staged_ts": now,
                    "from_replica": replica_id,
                    "bytes": nbytes,
                }
                self._handoff_queue.append(request_id)
                self._handoff_bytes += nbytes
                handoff_mod.note_outcome("staged")
            trace_id = rec.trace_id
            root = rec.root_span
        obs.event(
            "serve.handoff_oversize"
            if oversize
            else "serve.handoff_overflow"
            if overflow
            else "serve.handoff_staged",
            request_id=request_id,
            replica_id=replica_id,
            bytes=nbytes,
            trace_id=trace_id,
            parent_span_id=root,
        )
        if oversize:
            logger.warning(
                "handoff for %s (%d B) exceeds handoff_max_bytes "
                "(%d B) by itself; request FAILED (re-prefilling "
                "would loop forever)",
                request_id, nbytes,
                int(self._cfg("handoff_max_bytes")),
            )
        elif overflow:
            logger.warning(
                "handoff for %s (%d B) exceeds the staging budget; "
                "falling back to recompute", request_id, nbytes,
            )
        self._publish_queue()
        return True

    def _finish_trace_locked(
        self, rec: _Request, replica_id: int, now: float
    ) -> None:
        """Fold the finished request into its trace timeline and the
        TTFT phase surface. Caller holds the lock."""
        hop = rec.hops[-1] if rec.hops else None
        if hop is not None and not hop["end"]:
            hop["end_ts"] = now
            hop["end"] = rec.state
            self._span(
                rec, "serve.hop", hop["dispatch_ts"],
                now - hop["dispatch_ts"],
                span_id=hop["span_id"],
                replica_id=replica_id,
                hop=len(rec.hops) - 1,
                end=rec.state,
            )
        # Total time spent QUEUED at the router (initial wait plus
        # every requeue wait) — the "queue" slice of TTFT. A gap
        # preceding a DECODE-stage hop is the staged-handoff wait,
        # not queue time: the first token already existed when the
        # prefill replica exported, so handoff transit is outside
        # TTFT (it has its own phase and histogram).
        queue_s, handoff_master_s, prev = 0.0, 0.0, rec.submit_ts
        for h in rec.hops:
            gap = max(h["dispatch_ts"] - prev, 0.0)
            if h.get("stage") == REQ_DECODING:
                handoff_master_s += gap
            else:
                queue_s += gap
            prev = h["end_ts"] or now
        ph = dict(rec.phases)
        if not rec.error and ph:
            decomposed = {
                "queue": round(queue_s, 6),
                "dispatch": round(float(ph.get("dispatch", 0.0)), 6),
                "prefill": round(float(ph.get("prefill", 0.0)), 6),
                "first_decode": round(
                    float(ph.get("first_decode", 0.0)), 6
                ),
            }
            for phase, dur in decomposed.items():
                _TTFT_PHASE_SECONDS.observe(dur, phase=phase)
            # Per-phase SLO evidence for the role autoscaler.
            self._phase_recent["queue"].append(decomposed["queue"])
            self._phase_recent["prefill"].append(
                decomposed["prefill"]
            )
            self._tpot_recent.append(float(rec.tpot_s))
            ttft_total = round(sum(decomposed.values()), 6)
            handoff_s = handoff_master_s + float(
                ph.get("handoff", 0.0)
            )
            rec.phases = {
                **decomposed,
                **(
                    {"handoff": round(handoff_s, 6)}
                    if handoff_s > 0 or "handoff" in ph
                    else {}
                ),
                "decode": round(float(ph.get("decode", 0.0)), 6),
                "ttft_total": ttft_total,
            }
            worst = self._worst_ttft
            if worst is None or ttft_total > worst["ttft_total_s"]:
                self._worst_ttft = {
                    "request_id": rec.req.request_id,
                    "trace_id": rec.trace_id,
                    "replica_id": replica_id,
                    "requeues": rec.requeues,
                    "ttft_total_s": ttft_total,
                    "phases": decomposed,
                }
        _REQUEUE_HOPS.observe(float(rec.requeues))
        # The completing hop's interior phase spans, laid sequentially
        # backward from the completion instant (the durations are the
        # replica's own monotonic measurements; only the wall anchor
        # is approximated) — monotonic and non-overlapping by
        # construction.
        if self.trace_sink is not None and hop is not None and ph:
            names = (
                ("dispatch", "serve.dispatch"),
                ("prefill", "serve.prefill"),
                ("first_decode", "serve.first_token"),
                # Disaggregated completions: the decode replica's
                # local import wait sits between the first token and
                # the decode stream (the master-side staged wait is
                # the serve.handoff span emitted at dispatch).
                *(
                    (("handoff", "serve.handoff_import"),)
                    if "handoff" in ph
                    else ()
                ),
                ("decode", "serve.decode"),
            )
            total = sum(
                max(float(ph.get(k, 0.0)), 0.0) for k, _ in names
            )
            t = now - total
            for key, span_name in names:
                dur = max(float(ph.get(key, 0.0)), 0.0)
                self._span(
                    rec, span_name, t, dur,
                    parent=hop["span_id"] or rec.root_span,
                    replica_id=replica_id,
                )
                t += dur
        self._span(
            rec, "serve.request", rec.submit_ts,
            now - rec.submit_ts,
            span_id=rec.root_span, parent=rec.root_parent,
            requeues=rec.requeues, outcome=rec.state,
            replica_id=replica_id,
        )

    def trace_of(self, request_id: str) -> str:
        """The trace id minted for a ledger-known request ("" when
        unknown/evicted)."""
        with self._lock:
            rec = self._requests.get(request_id)
            return rec.trace_id if rec is not None else ""

    def result(self, request_id: str) -> Optional[dict]:
        """The ledger's view of one request (the ServeResultResponse
        payload)."""
        with self._lock:
            rec = self._requests.get(request_id)
            if rec is None:
                return None
            return {
                "request_id": request_id,
                "state": rec.state,
                "replica_id": rec.replica_id,
                "tokens": list(rec.tokens),
                "error": rec.error,
                "finish_reason": rec.finish_reason,
                "requeues": rec.requeues,
                "ttft_s": rec.ttft_s,
                "tpot_s": rec.tpot_s,
                "latency_s": (
                    round(rec.done_ts - rec.submit_ts, 6)
                    if rec.done_ts
                    else 0.0
                ),
                "trace_id": rec.trace_id,
                "phases": dict(rec.phases),
            }

    # -- telemetry ----------------------------------------------------------

    def report_stats(self, replica_id: int, stats: dict) -> None:
        """Periodic replica telemetry. Progress = the replica's
        token counter moved (a stats report alone is a heartbeat, not
        progress: a wedged decode loop still reports stats)."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return
            prev = rep.stats.get("tokens_generated", -1)
            cur = stats.get("tokens_generated", 0)
            rep.stats = dict(stats)
            rep.stats["ts"] = self.clock()
            # READY-and-empty: nothing is owed, stats keep it fresh.
            # DRAINING must NOT count stats as progress — a drained-
            # but-alive replica would otherwise look healthy forever
            # while never being fed, and the ladder's restart rung
            # (whose re-register is what clears the drain) would
            # never fire.
            if cur > prev or (
                not rep.dispatched and rep.state == REPLICA_READY
            ):
                rep.last_progress_ts = self.clock()

    def _publish_queue(self) -> None:
        # Gauges snapshot under the lock: callers publish AFTER
        # releasing it, and the replica dict mutates concurrently on
        # RPC / node-event threads.
        with self._lock:
            depth = len(self._queue)
            handoff_depth = len(self._handoff_queue)
            handoff_bytes = self._handoff_bytes
            inflight = sum(
                len(r.dispatched) for r in self._replicas.values()
            )
        _ROUTER_QUEUE.set(depth)
        _ROUTER_INFLIGHT.set(inflight)
        handoff_mod.publish_staging(handoff_depth, handoff_bytes)

    def _publish_replicas(self) -> None:
        with self._lock:
            total = len(self._replicas)
            ready = sum(
                1 for r in self._replicas.values()
                if r.state == REPLICA_READY
            )
            by_role = {role: 0 for role in ROLES}
            for r in self._replicas.values():
                by_role[r.role] = by_role.get(r.role, 0) + 1
        _REPLICAS_GAUGE.set(ready, state="ready")
        _REPLICAS_GAUGE.set(total - ready, state="draining")
        for role, n in by_role.items():
            _ROLE_REPLICAS_GAUGE.set(n, role=role)

    def _publish_slo(self) -> None:
        _P99_GAUGE.set(self.p99_latency())
        _QPS_GAUGE.set(self.qps())

    def p99_latency(self) -> float:
        from dlrover_tpu_torch.obs.timeseries import _percentile

        with self._lock:
            lat = sorted(self._done_latencies)
        return _percentile(lat, 99.0)

    def qps(self) -> float:
        now = self.clock()
        window = self._cfg("qps_window_s")
        with self._lock:
            n = sum(
                1 for t in self._done_stamps if now - t <= window
            )
        return n / window if window > 0 else 0.0

    # -- health feed --------------------------------------------------------

    def unhealthy_replicas(self) -> List[dict]:
        """Replicas that are demonstrably not serving: READY with
        dispatched work and stale progress, or DRAINING and never
        came back. The health plane's ``replica_unhealthy`` detector
        consumes this."""
        now = self.clock()
        timeout = self._cfg("progress_timeout_s")
        out: List[dict] = []
        with self._lock:
            for rep in self._replicas.values():
                stale = now - rep.last_progress_ts
                if stale < timeout:
                    continue
                if rep.state == REPLICA_READY and not rep.dispatched:
                    continue  # idle and empty: nothing owed
                out.append(
                    {
                        "replica_id": rep.node_id,
                        "addr": rep.addr,
                        "state": rep.state,
                        "role": rep.role,
                        "stale_s": round(stale, 3),
                        "timeout_s": timeout,
                        "dispatched": len(rep.dispatched),
                    }
                )
        return out

    # -- SLO-driven scaling -------------------------------------------------

    def maybe_autoscale(self) -> Optional[str]:
        """One scaling evaluation against the QPS/p99 SLOs, through
        the same ScalePlan seam training elasticity uses
        (``JobManager.ensure_role`` launches pending replica nodes;
        ``retire_node`` removes one). Cooldown-limited; no-op without
        a job manager. Returns "grow"/"shrink"/None."""
        if self.job_manager is None:
            return None
        with self._lock:
            idle_master = not self._replicas and not self._requests
        if idle_master:
            # A training-only master (serving never used) must not
            # launch replica nodes toward min_replicas.
            return None
        now = self.clock()
        if now - self._last_scale_ts < self._cfg("scale_cooldown_s"):
            return None
        from dlrover_tpu_torch.common.constants import NodeType

        with self._lock:
            disagg = any(
                r.role != ROLE_MIXED
                for r in self._replicas.values()
            )
        if disagg:
            return self._autoscale_disagg(now)
        with self._lock:
            ready = [
                r for r in self._replicas.values()
                if r.state == REPLICA_READY
            ]
            total = len(self._replicas)
            queue_depth = len(self._queue)
        n = len(ready)
        min_n = int(self._cfg("min_replicas"))
        max_n = int(self._cfg("max_replicas"))
        p99 = self.p99_latency()
        backlogged = queue_depth > self._cfg(
            "backlog_per_replica"
        ) * max(n, 1)
        slo_breach = p99 > self._cfg("p99_slo_s") > 0
        if (backlogged or slo_breach or n < min_n) and total < max_n:
            # The SLO pressure is judged on READY replicas, but the
            # ensure_role target must count EVERY registered replica:
            # ensure_role counts all alive REPLICA nodes (draining /
            # cordoned ones included), so a ready-count target would
            # silently no-op exactly when a drain halved capacity.
            target = max(total + 1, min_n)
            # Under a pool master the serving plane is a per-job
            # consumer of its pool GRANT: with no headroom the scale
            # intent is withheld (no cooldown burned) so the next
            # evaluation retries the moment the grant grows, instead
            # of burning the cooldown on a capped no-op.
            # getattr: embedded test doubles predate the pool seam.
            headroom_fn = getattr(
                self.job_manager, "grant_headroom", None
            )
            headroom = headroom_fn() if headroom_fn else None
            if headroom is not None and headroom <= 0:
                if not self._grant_block_logged:
                    self._grant_block_logged = True
                    obs.event(
                        "serve.scale_blocked_by_grant",
                        target=target,
                        grant=self.job_manager.pool_grant,
                        queue_depth=queue_depth,
                    )
                    logger.warning(
                        "serving scale-up to %d withheld: pool "
                        "grant %s has no headroom", target,
                        self.job_manager.pool_grant,
                    )
                return None
            self._grant_block_logged = False
            self.job_manager.ensure_role(NodeType.REPLICA, target)
            self._last_scale_ts = now
            obs.event(
                "serve.scale", direction="grow", target=target,
                queue_depth=queue_depth, p99_s=round(p99, 3),
            )
            logger.warning(
                "serving scale-up to %d replicas (queue %d, "
                "p99 %.2fs)", target, queue_depth, p99,
            )
            return "grow"
        idle = (
            n > min_n
            and queue_depth == 0
            and self.qps() < 0.5 * max(n - 1, 1)
            and all(not r.dispatched for r in ready)
        )
        if idle:
            victim = max(ready, key=lambda r: r.node_id)
            self.job_manager.retire_node(victim.node_id)
            self._last_scale_ts = now
            obs.event(
                "serve.scale", direction="shrink",
                replica_id=victim.node_id, target=n - 1,
            )
            logger.info(
                "serving scale-down: retiring idle replica %d",
                victim.node_id,
            )
            return "shrink"
        return None

    def phase_p99(self, phase: str) -> float:
        """p99 of a recent TTFT phase window ("queue"/"prefill") or
        of TPOT ("tpot") — the per-phase SLO autoscaler's evidence,
        via the one shared nearest-rank formula."""
        from dlrover_tpu_torch.obs.timeseries import _percentile

        with self._lock:
            if phase == "tpot":
                samples = sorted(self._tpot_recent)
            else:
                samples = sorted(self._phase_recent.get(phase, ()))
        return _percentile(samples, 99.0)

    def _grant_blocked(self, target: int, queue_depth: int) -> bool:
        """Pool-grant headroom gate shared by both scaling paths
        (see maybe_autoscale's grow branch for the semantics)."""
        headroom_fn = getattr(
            self.job_manager, "grant_headroom", None
        )
        headroom = headroom_fn() if headroom_fn else None
        if headroom is None or headroom > 0:
            self._grant_block_logged = False
            return False
        if not self._grant_block_logged:
            self._grant_block_logged = True
            obs.event(
                "serve.scale_blocked_by_grant",
                target=target,
                grant=self.job_manager.pool_grant,
                queue_depth=queue_depth,
            )
            logger.warning(
                "serving scale-up to %d withheld: pool grant %s "
                "has no headroom", target,
                self.job_manager.pool_grant,
            )
        return True

    def _autoscale_disagg(self, now: float) -> Optional[str]:
        """Per-role scaling for a disaggregated fleet. PREFILL count
        scales on the raw-prompt backlog and the queue/prefill TTFT
        phase p99s (the phases a starved prefill fleet inflates);
        DECODE count on the TPOT p99 SLO, the staged-handoff backlog,
        and decode-pool KV utilization (the signals of a starved
        decode fleet). Both route through the same
        ``ensure_role``/ScalePlan seam, labeled with the serving role
        so each role's target counts only its own nodes."""
        from dlrover_tpu_torch.common.constants import NodeType

        with self._lock:
            by_role: Dict[str, List[_Replica]] = {}
            for r in self._replicas.values():
                by_role.setdefault(r.role, []).append(r)
            raw_depth = len(self._queue)
            handoff_depth = len(self._handoff_queue)
            kv_utils = [
                float(
                    (r.stats.get("kv") or {}).get("utilization", 0.0)
                )
                for r in by_role.get(ROLE_DECODE, [])
                if r.stats
            ]
        prefills = by_role.get(ROLE_PREFILL, [])
        decodes = by_role.get(ROLE_DECODE, [])
        n_pre, n_dec = len(prefills), len(decodes)
        min_pre = int(self._cfg("min_prefill"))
        max_pre = int(self._cfg("max_prefill"))
        min_dec = int(self._cfg("min_decode"))
        max_dec = int(self._cfg("max_decode"))
        ttft_slo = self._cfg("ttft_slo_s")
        tpot_slo = self._cfg("tpot_slo_s")
        queue_p99 = self.phase_p99("queue")
        prefill_p99 = self.phase_p99("prefill")
        tpot_p99 = self.phase_p99("tpot")
        kv_mean = (
            sum(kv_utils) / len(kv_utils) if kv_utils else 0.0
        )
        grew = None
        grow_prefill = (
            raw_depth
            > self._cfg("backlog_per_replica") * max(n_pre, 1)
            or (ttft_slo > 0 and queue_p99 + prefill_p99 > ttft_slo)
            or n_pre < min_pre
        )
        if grow_prefill and n_pre < max_pre:
            target = max(n_pre + 1, min_pre)
            if not self._grant_blocked(target, raw_depth):
                self.job_manager.ensure_role(
                    NodeType.REPLICA, target,
                    labels={"serving_role": ROLE_PREFILL},
                )
                self._last_scale_ts = now
                grew = "grow"
                obs.event(
                    "serve.scale", direction="grow",
                    role=ROLE_PREFILL, target=target,
                    queue_depth=raw_depth,
                    queue_p99_s=round(queue_p99, 3),
                    prefill_p99_s=round(prefill_p99, 3),
                )
                logger.warning(
                    "serving scale-up: prefill -> %d (queue %d, "
                    "queue+prefill p99 %.2fs)",
                    target, raw_depth, queue_p99 + prefill_p99,
                )
        grow_decode = (
            handoff_depth
            > self._cfg("handoff_backlog_per_decode") * max(n_dec, 1)
            or (tpot_slo > 0 and tpot_p99 > tpot_slo)
            or kv_mean > self._cfg("kv_util_high")
            or n_dec < min_dec
        )
        if grow_decode and n_dec < max_dec:
            target = max(n_dec + 1, min_dec)
            if not self._grant_blocked(target, handoff_depth):
                self.job_manager.ensure_role(
                    NodeType.REPLICA, target,
                    labels={"serving_role": ROLE_DECODE},
                )
                self._last_scale_ts = now
                grew = "grow"
                obs.event(
                    "serve.scale", direction="grow",
                    role=ROLE_DECODE, target=target,
                    handoff_depth=handoff_depth,
                    tpot_p99_s=round(tpot_p99, 5),
                    kv_util=round(kv_mean, 3),
                )
                logger.warning(
                    "serving scale-up: decode -> %d (handoff "
                    "backlog %d, tpot p99 %.4fs, kv %.0f%%)",
                    target, handoff_depth, tpot_p99,
                    100.0 * kv_mean,
                )
        if grew:
            return grew
        # Shrink one idle role per evaluation (never below its min):
        # prefill idles when no raw prompts wait anywhere; decode
        # when no handoffs wait and nothing is decoding.
        for role, reps, n, floor, depth in (
            (ROLE_PREFILL, prefills, n_pre, min_pre, raw_depth),
            (ROLE_DECODE, decodes, n_dec, min_dec, handoff_depth),
        ):
            ready = [r for r in reps if r.state == REPLICA_READY]
            idle = (
                len(ready) > floor
                and n > floor
                and depth == 0
                and all(not r.dispatched for r in ready)
            )
            if idle:
                victim = max(ready, key=lambda r: r.node_id)
                self.job_manager.retire_node(victim.node_id)
                self._last_scale_ts = now
                obs.event(
                    "serve.scale", direction="shrink", role=role,
                    replica_id=victim.node_id, target=n - 1,
                )
                logger.info(
                    "serving scale-down: retiring idle %s replica "
                    "%d", role, victim.node_id,
                )
                return "shrink"
        return None

    # -- read surface -------------------------------------------------------

    def counters(self) -> dict:
        """Request outcome counters. ``done``/``failed`` are
        CUMULATIVE (they survive ledger eviction); queued/dispatched
        scan the retained records (bounded by retention + live)."""
        with self._lock:
            states = {
                REQ_QUEUED: 0,
                REQ_DISPATCHED: 0,
                REQ_PREFILLING: 0,
                REQ_HANDOFF: 0,
                REQ_DECODING: 0,
            }
            for rec in self._requests.values():
                if rec.state in states:
                    states[rec.state] += 1
            return {
                "requests": len(self._requests),
                "requeued_total": self._requeued_total,
                "done": self._done_total,
                "failed": self._failed_total,
                "handoff_bytes": self._handoff_bytes,
                **states,
            }

    def snapshot(self) -> dict:
        """The ``obs_report --serving`` payload (and the
        ServeQueryResponse body)."""
        unhealthy = {
            u["replica_id"]: u for u in self.unhealthy_replicas()
        }
        with self._lock:
            replicas = [
                {
                    "replica_id": rep.node_id,
                    "addr": rep.addr,
                    "state": rep.state,
                    "role": rep.role,
                    "dispatched": len(rep.dispatched),
                    "drains": rep.drains,
                    "last_progress_age_s": round(
                        self.clock() - rep.last_progress_ts, 3
                    ),
                    "unhealthy": rep.node_id in unhealthy,
                    "stats": dict(rep.stats),
                }
                for rep in sorted(
                    self._replicas.values(),
                    key=lambda r: r.node_id,
                )
            ]
            queue_depth = len(self._queue)
            handoff_depth = len(self._handoff_queue)
            handoff_bytes = self._handoff_bytes
            worst = (
                dict(self._worst_ttft) if self._worst_ttft else None
            )
        # Per-role rollup (obs_report --serving's disaggregation
        # rows): replica counts and mean KV utilization by role.
        roles: Dict[str, dict] = {}
        for rep in replicas:
            row = roles.setdefault(
                rep["role"],
                {"replicas": 0, "ready": 0, "kv_utils": []},
            )
            row["replicas"] += 1
            if rep["state"] == REPLICA_READY:
                row["ready"] += 1
            kv = (rep["stats"] or {}).get("kv") or {}
            if kv:
                row["kv_utils"].append(
                    float(kv.get("utilization", 0.0))
                )
        for row in roles.values():
            utils = row.pop("kv_utils")
            row["kv_utilization"] = round(
                sum(utils) / len(utils), 4
            ) if utils else 0.0
        return {
            "ts": self.clock(),
            "queue_depth": queue_depth,
            "handoff_queue_depth": handoff_depth,
            "handoff_bytes": handoff_bytes,
            "p99_latency_s": round(self.p99_latency(), 6),
            "qps": round(self.qps(), 4),
            "counters": self.counters(),
            "replicas": replicas,
            "roles": roles,
            "unhealthy": sorted(unhealthy),
            "worst_ttft": worst,
        }


def render_serving(payload: dict) -> str:
    """Human rendering of a router snapshot — the body of
    ``obs_report --serving``."""
    counters = payload.get("counters", {})
    replicas = payload.get("replicas", [])
    unhealthy = payload.get("unhealthy", [])
    lines = [
        f"serving: {counters.get('requests', 0)} request(s) "
        f"({counters.get('done', 0)} done, "
        f"{counters.get('failed', 0)} failed, "
        f"{counters.get('queued', 0)} queued, "
        f"{counters.get('dispatched', 0)} in flight, "
        f"{counters.get('requeued_total', 0)} requeue(s)), "
        f"qps {payload.get('qps', 0.0):.2f}, "
        f"p99 {payload.get('p99_latency_s', 0.0):.3f}s"
    ]
    roles = payload.get("roles") or {}
    disagg = any(r != "mixed" for r in roles)
    if disagg:
        # Per-role rollup: the disaggregation dashboard line — role
        # replica counts, the staged-handoff backlog, per-role KV.
        for role in ("prefill", "decode", "mixed"):
            row = roles.get(role)
            if not row:
                continue
            lines.append(
                f"  role {role:<8} {row.get('ready', 0)}/"
                f"{row.get('replicas', 0)} ready, "
                f"kv {100.0 * float(row.get('kv_utilization', 0.0)):.0f}%"
            )
        lines.append(
            f"  handoff queue {payload.get('handoff_queue_depth', 0)}"
            f" staged ({payload.get('handoff_bytes', 0)} B)"
        )
    if not replicas:
        lines.append("  no replicas registered")
    for rep in replicas:
        stats = rep.get("stats") or {}
        kv = stats.get("kv") or {}
        mark = "UNHEALTHY" if rep.get("unhealthy") else rep.get(
            "state", "?"
        )
        lines.append(
            f"  replica {rep.get('replica_id')} "
            f"[{mark:<9}] "
            f"{rep.get('role', 'mixed'):<7} "
            f"{rep.get('addr', '') or '-'}: "
            f"{rep.get('dispatched', 0)} in flight, "
            f"queue {stats.get('queue_depth', 0)}, "
            f"active {stats.get('active', 0)}, "
            f"kv {100.0 * float(kv.get('utilization', 0.0)):.0f}%, "
            f"ttft p99 {stats.get('ttft_p99_s', 0.0):.3f}s, "
            f"tpot p50 {stats.get('tpot_p50_s', 0.0):.4f}s, "
            f"progress {rep.get('last_progress_age_s', 0.0):.1f}s ago"
        )
    worst = payload.get("worst_ttft")
    if worst:
        ph = worst.get("phases") or {}
        lines.append(
            f"  worst TTFT {worst.get('ttft_total_s', 0.0):.3f}s = "
            f"queue {ph.get('queue', 0.0):.3f}s + "
            f"dispatch {ph.get('dispatch', 0.0):.3f}s + "
            f"prefill {ph.get('prefill', 0.0):.3f}s + "
            f"first_decode {ph.get('first_decode', 0.0):.3f}s "
            f"({worst.get('request_id', '?')}, "
            f"{worst.get('requeues', 0)} requeue(s), "
            f"trace {str(worst.get('trace_id', ''))[:16]})"
        )
    if unhealthy:
        lines.append(
            f"  UNHEALTHY replicas: {unhealthy} — replica_unhealthy "
            "verdict feeds drain -> restart -> replace"
        )
    return "\n".join(lines)
