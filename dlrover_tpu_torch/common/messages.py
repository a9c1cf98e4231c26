"""Typed control-plane message schema.

The reference ships pickled dataclasses inside a 2-RPC gRPC envelope
(dlrover/python/common/grpc.py + proto/elastic_training.proto:28-31).
Pickle-over-the-wire is an RCE hazard and version-fragile, so here every
message is an explicit dataclass registered in a type registry and
serialized with msgpack: ``{"_t": <type name>, ...fields}``. Unknown
fields are dropped on decode, which gives forward/backward compatibility.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Type

import msgpack

_REGISTRY: Dict[str, type] = {}


def message(cls):
    """Class decorator: make a dataclass a wire message."""
    cls = dataclasses.dataclass(cls)
    _REGISTRY[cls.__name__] = cls
    return cls


def _encode_value(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return encode_to_dict(v)
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    return v


def encode_to_dict(msg: Any) -> dict:
    d = {"_t": type(msg).__name__}
    for f in dataclasses.fields(msg):
        d[f.name] = _encode_value(getattr(msg, f.name))
    return d


def decode_from_dict(d: Any) -> Any:
    if isinstance(d, dict) and "_t" in d:
        cls = _REGISTRY.get(d["_t"])
        if cls is None:
            raise ValueError(f"unknown message type {d['_t']!r}")
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {
            k: decode_from_dict(v)
            for k, v in d.items()
            if k != "_t" and k in fields
        }
        return cls(**kwargs)
    if isinstance(d, list):
        return [decode_from_dict(x) for x in d]
    if isinstance(d, dict):
        return {k: decode_from_dict(v) for k, v in d.items()}
    return d


def serialize(
    msg: Any,
    trace: Optional[Dict[str, str]] = None,
    job_id: Optional[str] = None,
) -> bytes:
    """Encode a message for the wire. ``trace`` (the dict
    ``obs.tracer.inject()`` produced) rides as a reserved top-level
    ``_tc`` envelope field — never a message field, so every message
    type propagates trace context without schema changes, and an old
    decoder simply drops it (``decode_from_dict`` filters unknown
    keys). ``job_id`` rides the same way as ``_job``: the multi-job
    pool master routes every message type to that job's servicer
    without any per-message schema change, and a single-job master
    (no routing dispatcher) ignores it."""
    d = encode_to_dict(msg)
    if trace:
        d["_tc"] = {str(k): str(v) for k, v in trace.items()}
    if job_id:
        d["_job"] = str(job_id)
    return msgpack.packb(d, use_bin_type=True)


def deserialize(data: bytes) -> Any:
    return decode_from_dict(
        msgpack.unpackb(data, raw=False, strict_map_key=False)
    )


def deserialize_with_trace(data: bytes):
    """``(message, trace_carrier_or_None)`` — the server-side pair of
    :func:`serialize`'s ``trace=``. The carrier is the raw ``_tc``
    dict (feed it to ``obs.tracer.extract``)."""
    msg_, trace, _ = deserialize_envelope(data)
    return msg_, trace


def deserialize_envelope(data: bytes):
    """``(message, trace_carrier_or_None, job_id)`` — the full
    server-side envelope: typed message, raw ``_tc`` trace carrier,
    and the ``_job`` routing id ("" when absent, i.e. a single-job
    client)."""
    raw = msgpack.unpackb(data, raw=False, strict_map_key=False)
    trace = None
    job_id = ""
    if isinstance(raw, dict):
        trace = raw.pop("_tc", None)
        job_id = str(raw.pop("_job", "") or "")
    return decode_from_dict(raw), trace, job_id


# ---------------------------------------------------------------------------
# Envelope
# ---------------------------------------------------------------------------


@message
class BaseRequest:
    node_id: int = -1
    node_type: str = ""
    data: Optional[Any] = None


@message
class BaseResponse:
    success: bool = True
    message: str = ""
    data: Optional[Any] = None


# ---------------------------------------------------------------------------
# Rendezvous (ref grpc.py JoinRendezvousRequest etc.)
# ---------------------------------------------------------------------------


@message
class JoinRendezvousRequest:
    node_id: int = -1
    node_rank: int = -1
    local_world_size: int = 1
    rdzv_name: str = ""
    node_ip: str = ""


@message
class JoinRendezvousResponse:
    round: int = 0


@message
class CommWorldRequest:
    node_id: int = -1
    node_rank: int = -1  # rendezvous worlds are keyed by rank, not id
    rdzv_name: str = ""


@message
class CommWorldResponse:
    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    # node_rank -> local_world_size for every node frozen into this world
    world: Dict[int, int] = dataclasses.field(default_factory=dict)


@message
class WaitingNodeNumRequest:
    node_id: int = -1
    rdzv_name: str = ""


@message
class WaitingNodeNumResponse:
    waiting_num: int = 0


@message
class NetworkReadyRequest:
    node_id: int = -1


@message
class NetworkCheckResultRequest:
    node_id: int = -1
    normal: bool = True
    elapsed_time: float = 0.0


@message
class NetworkCheckQueryRequest:
    node_id: int = -1
    kind: str = "fault"  # "fault" | "straggler"


@message
class NetworkCheckQueryResponse:
    nodes: List[int] = dataclasses.field(default_factory=list)
    # "" = verdict ready; "waiting" = not all nodes reported yet;
    # "fault" = fault nodes present
    reason: str = ""


# ---------------------------------------------------------------------------
# KV store (c10d-style bootstrap over the master)
# ---------------------------------------------------------------------------


@message
class KVStoreSetRequest:
    key: str = ""
    value: bytes = b""


@message
class KVStoreGetRequest:
    key: str = ""


@message
class KVStoreGetResponse:
    found: bool = False
    value: bytes = b""


@message
class KVStoreAddRequest:
    key: str = ""
    amount: int = 0


@message
class KVStoreAddResponse:
    value: int = 0


# ---------------------------------------------------------------------------
# Dynamic data sharding (ref grpc.py TaskRequest/Task/ShardCheckpoint)
# ---------------------------------------------------------------------------


@message
class DatasetShardParams:
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    task_type: str = ""
    storage_type: str = "table"
    # Streaming datasets: number of stream partitions the splitter
    # fabricates shards from (each carries its own offset/watermark).
    num_stream_partitions: int = 1


@message
class Shard:
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: List[int] = dataclasses.field(default_factory=list)
    # Stream partition this shard was fabricated from (streaming
    # datasets only; 0 for table/text shards). start/end index the
    # partition's own record space.
    partition: int = 0


@message
class TaskRequest:
    node_id: int = -1
    dataset_name: str = ""


@message
class Task:
    task_id: int = -1
    task_type: str = ""
    shard: Optional[Shard] = None


@message
class TaskResultRequest:
    node_id: int = -1
    dataset_name: str = ""
    task_id: int = -1
    success: bool = True


@message
class ShardCheckpointRequest:
    dataset_name: str = ""


@message
class ShardCheckpointResponse:
    content: str = ""  # JSON-encoded splitter + todo/doing state


@message
class RestoreShardRequest:
    dataset_name: str = ""
    content: str = ""


# ---------------------------------------------------------------------------
# Metrics / monitoring
# ---------------------------------------------------------------------------


@message
class GlobalStep:
    timestamp: float = 0.0
    step: int = 0


@message
class StepReport:
    node_id: int = -1
    timestamp: float = 0.0
    step: int = 0
    # tokens (or samples) processed since the last report, for throughput
    tokens: int = 0


@message
class ResourceStats:
    node_id: int = -1
    cpu_percent: float = 0.0
    memory_mb: int = 0
    hbm_used_gb: float = 0.0
    duty_cycle: float = 0.0


@message
class MetricsSnapshotReport:
    """Agent -> master: one host's telemetry snapshot, shipped on the
    ResourceMonitor cadence. ``registry`` is the host process's
    ``MetricsRegistry.dump()``; ``step_times`` are the trainer's most
    recent per-step wall times (from the step-metrics file);
    ``events`` are tracer events new since the previous snapshot (how
    trainer-side spans reach the master's goodput accountant). The
    master's FleetAggregator merges these into host-labeled series.
    ``beacon`` is the trainer's last progress stamp (obs/beacon.py
    record plus the agent-computed ``age_s`` staleness) — the
    StallCorrelator's per-host progress vector; empty when the host
    runs no beacon.
    """

    node_id: int = -1
    host: str = ""
    timestamp: float = 0.0
    registry: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resource: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_times: List[float] = dataclasses.field(default_factory=list)
    events: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    beacon: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class NodeFailureReport:
    node_id: int = -1
    error_data: str = ""
    level: str = ""
    restart_count: int = 0
    # True when the reporting agent has exhausted its local restart
    # budget: the node is done, do not relaunch.
    fatal: bool = False
    # Size-capped forensics digest (bundle path + top stack frames +
    # last recorder events) attached by the agent on hangs/crashes.
    # Deliberately separate from error_data: the exit classifier must
    # key on the raw stderr only, never on stack-frame file names.
    diagnostics: str = ""


@message
class NodeSucceededReport:
    node_id: int = -1


@message
class DiagnosticsReport:
    """Agent -> master: one forensics digest (hang, crash, or an
    on-demand ``diagnose`` snapshot). ``bundle_path`` points at the
    full JSON black-box bundle on the reporting host's forensics dir;
    ``digest`` is the size-capped summary (top stack frames, last
    notes/log lines) safe to keep in master memory and render over
    RPC. The master keeps a bounded per-node history
    (``DiagnosticsQueryRequest``)."""

    node_id: int = -1
    kind: str = ""  # "hang" | "crash" | "diagnose" | ...
    bundle_path: str = ""
    digest: str = ""
    timestamp: float = 0.0


@message
class ProfileActionRequest:
    """Operator/tool -> master: queue a PROFILE heartbeat action for
    ``node_id`` (its agent asks the trainer for an N-step phase/MFU
    capture; the digest lands in the diagnostics history, queryable
    via ``DiagnosticsQueryRequest``). The capture length is the
    agent's ``DLROVER_TPU_PROFILE_STEPS``."""

    node_id: int = -1


@message
class DiagnosticsQueryRequest:
    """Fetch the master's per-node diagnostics history; ``node_id``
    -1 means every node."""

    node_id: int = -1


@message
class DiagnosticsQueryResponse:
    reports: List[DiagnosticsReport] = dataclasses.field(
        default_factory=list
    )


@message
class HealthVerdictMsg:
    """One health-detector finding on the wire (the RPC mirror of
    ``obs.health.HealthVerdict``). ``evidence`` is the convicting
    window of ``[ts, value]`` samples; ``metrics`` the detector's
    numeric facts (baseline mean, ratio, slope, ...)."""

    detector: str = ""
    severity: str = ""  # "info" | "warn" | "critical"
    message: str = ""
    node_id: int = -1
    host: str = ""
    suggested_action: str = ""  # an EventAction value, or ""
    evidence_series: str = ""
    evidence: List[List[float]] = dataclasses.field(
        default_factory=list
    )
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    timestamp: float = 0.0
    resolved: bool = False


@message
class HealthQueryRequest:
    """Fetch the master's health verdicts. ``node_id`` >= 0 filters
    to one node's verdicts; ``include_history`` adds the bounded
    transition history (new verdicts, severity changes, resolutions)
    to the response."""

    node_id: int = -1
    include_history: bool = False


@message
class HealthQueryResponse:
    score: float = 1.0
    verdicts: List[HealthVerdictMsg] = dataclasses.field(
        default_factory=list
    )
    history: List[HealthVerdictMsg] = dataclasses.field(
        default_factory=list
    )


@message
class RemediationDecisionMsg:
    """One remediation-engine decision on the wire (the RPC mirror of
    ``master.remediation.RemediationDecision``). ``governors`` maps
    every safety-governor name to ``"ok"`` or a ``"blocked: ..."``
    reason; ``trigger`` is the convicting verdict's message."""

    decision_id: int = 0
    detector: str = ""
    severity: str = ""
    node_id: int = -1
    host: str = ""
    action: str = ""  # restart_training | cordon_replace | shrink
    outcome: str = ""  # acted | dry_run | blocked | recovered | ...
    dry_run: bool = False
    governors: Dict[str, str] = dataclasses.field(default_factory=dict)
    trigger: str = ""
    timestamp: float = 0.0
    probation_deadline: float = 0.0
    note: str = ""
    # The decision's distributed trace (verdict -> governors ->
    # action -> probation -> outcome spans), queryable via
    # TraceQueryRequest.
    trace_id: str = ""


@message
class RemediationQueryRequest:
    """Fetch the master's remediation decision history. ``node_id``
    >= 0 filters to one node's decisions; ``limit`` > 0 caps the
    newest-last decision list."""

    node_id: int = -1
    limit: int = 0


@message
class RemediationQueryResponse:
    enabled: bool = False
    dry_run: bool = False
    cordoned: List[int] = dataclasses.field(default_factory=list)
    probation_failing: bool = False
    decisions: List[RemediationDecisionMsg] = dataclasses.field(
        default_factory=list
    )


@message
class NodeFailureResponse:
    # A NodeAction constant: who owns the restart after this failure.
    action: str = "restart_in_place"


@message
class HeartbeatRequest:
    node_id: int = -1
    timestamp: float = 0.0


@message
class HeartbeatResponse:
    action: str = "none"  # an EventAction value pushed down by the master


@message
class NodeAddressRequest:
    node_id: int = -1
    node_type: str = ""
    node_ip: str = ""
    # Role labels for the node-table entry (e.g. a serving replica's
    # {"serving_role": "prefill"|"decode"|"mixed"}): the labeled
    # ensure_role seam counts targets per label set, so per-role
    # autoscaling can launch/count each role independently. An old
    # decoder simply drops the field.
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)


@message
class ParallelConfigRequest:
    node_id: int = -1


@message
class ParallelConfig:
    """Master-pushed tuning config (ref grpc.ParallelConfig).

    On TPU the tunables are the mesh shape and per-step batching, not
    DDP bucket sizes.
    """

    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    micro_batch_size: int = 0
    grad_accum_steps: int = 0
    remat_policy: str = ""
    version: int = 0


# ---------------------------------------------------------------------------
# Elasticity / scaling
# ---------------------------------------------------------------------------


@message
class JobNodesRequest:
    node_type: str = ""


@message
class NodeMeta:
    node_type: str = ""
    node_id: int = -1
    rank: int = -1
    status: str = ""
    addr: str = ""
    chips: int = 0


@message
class JobNodesResponse:
    nodes: List[NodeMeta] = dataclasses.field(default_factory=list)


@message
class MetricsRequest:
    """Fetch the master's metrics in Prometheus text format over the
    control plane (same payload as the HTTP /metrics endpoint, for
    agents/tools that already hold an RPC channel)."""

    node_id: int = -1


@message
class MetricsResponse:
    text: str = ""


@message
class ScalePlanMsg:
    """A resource plan: target number of nodes per type."""

    node_group: Dict[str, int] = dataclasses.field(default_factory=dict)
    remove_nodes: List[int] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Sparse / PS-elastic path (ref: tfplus kv_variable ops + dlrover
# master/node/ps.py orchestration; arrays ride msgpack as raw bytes)
# ---------------------------------------------------------------------------


@message
class Tensor:
    """Dense ndarray on the wire: raw bytes + dtype + shape."""

    dtype: str = "float32"
    shape: List[int] = dataclasses.field(default_factory=list)
    data: bytes = b""

    @staticmethod
    def from_numpy(arr) -> "Tensor":
        import numpy as np

        arr = np.ascontiguousarray(arr)
        return Tensor(
            dtype=str(arr.dtype),
            shape=list(arr.shape),
            data=arr.tobytes(),
        )

    def to_numpy(self):
        import numpy as np

        return np.frombuffer(self.data, dtype=self.dtype).reshape(
            self.shape
        ).copy()


@message
class PsLookupRequest:
    table: str = ""
    keys: Optional[Tensor] = None
    train: bool = True  # True: gather-or-insert; False: gather-or-zeros
    map_version: int = -1


@message
class PsLookupResponse:
    values: Optional[Tensor] = None


@message
class PsApplyRequest:
    """Fused sparse optimizer apply on a PS shard."""

    table: str = ""
    optimizer: str = "adam"
    keys: Optional[Tensor] = None
    grads: Optional[Tensor] = None
    # Optional per-key auxiliary rows, same [n, dim] layout as grads
    # (adahessian: the Hutchinson Hessian-diagonal estimates).
    aux: Optional[Tensor] = None
    step: int = 0
    lr: float = 1e-3
    hyperparams: Dict[str, float] = dataclasses.field(default_factory=dict)
    map_version: int = -1
    # Replay fence (exactly-once streaming): barrier epoch the client
    # is applying under, its stable client id, and a per-client
    # monotonically increasing apply sequence. A post-restore PS
    # rejects epochs older than its fence and dedups replayed
    # (client_id, apply_seq) pairs per partition, so a trainer
    # replaying its in-flight shard after a kill is idempotent.
    # All three default to -1 = unfenced (legacy at-least-once path).
    epoch: int = -1
    client_id: int = -1
    apply_seq: int = -1


@message
class PsExportRequest:
    """Export rows of the given partitions (for PS->PS moves and for
    checkpoint flush). since_version>0 = delta export."""

    table: str = ""
    partitions: List[int] = dataclasses.field(default_factory=list)
    since_version: int = 0
    include_slots: bool = True


@message
class PsTableDump:
    table: str = ""
    keys: Optional[Tensor] = None
    values: Optional[Tensor] = None
    freqs: Optional[Tensor] = None
    versions: Optional[Tensor] = None
    # slot name -> (keys, values) for optimizer state
    slot_keys: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    slot_values: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    # Replay-fence state for the dumped partitions: partition ->
    # {client_id: last applied seq}, plus the source's fence epoch.
    # Rides PS-to-PS moves so a rebalanced partition keeps its dedup
    # history (without it a live move would reopen the replay window).
    part_seqs: Dict[int, Dict[int, int]] = dataclasses.field(
        default_factory=dict
    )
    fence_epoch: int = -1


@message
class PsImportRequest:
    dump: Optional[PsTableDump] = None


@message
class PsPullPartitionsRequest:
    """Master -> target PS: pull these partitions from source_addr,
    import them, ack. The data moves PS-to-PS, not through the master."""

    source_addr: str = ""
    partitions: List[int] = dataclasses.field(default_factory=list)


@message
class PsFreezeRequest:
    """Master -> source PS: stop serving these partitions (clients get
    a stale-map rejection and refetch the PartitionMap)."""

    partitions: List[int] = dataclasses.field(default_factory=list)
    frozen: bool = True


@message
class PsStatsRequest:
    pass


@message
class PsStatsResponse:
    ps_id: int = -1
    tables: Dict[str, int] = dataclasses.field(default_factory=dict)
    qps: float = 0.0
    cpu_percent: float = 0.0
    frozen_partitions: List[int] = dataclasses.field(default_factory=list)


@message
class PsFlushRequest:
    """Checkpoint: delta-flush owned partitions to storage.

    A barrier flush (``epoch >= 0``) additionally persists the replay
    fence (per-partition applied-seq high water marks) stamped with
    the shard ledger's high-water marks, and advances the PS fence
    epoch — the PS half of a barrier-consistent checkpoint cut.
    """

    step: int = 0
    epoch: int = -1
    # Shard-ledger high-water marks at the cut: dataset -> watermark
    # record offset (forensics stamp carried into the fence files).
    hwm: Dict[str, int] = dataclasses.field(default_factory=dict)


@message
class PsFlushResponse:
    flushed_rows: int = 0
    # Fence epoch in force on the PS after this flush (-1 = no
    # barrier flush has ever run there).
    epoch: int = -1


@message
class PsRestoreRequest:
    """Restore the given partitions from the checkpoint dir (after a
    relaunch or a partition takeover from a dead PS)."""

    partitions: List[int] = dataclasses.field(default_factory=list)


@message
class PartitionMapMsg:
    version: int = 0
    assignment: List[int] = dataclasses.field(default_factory=list)
    ps_addrs: Dict[int, str] = dataclasses.field(default_factory=dict)


@message
class PartitionMapRequest:
    known_version: int = -1


@message
class PsRegisterRequest:
    """PS node -> master: announce service address."""

    node_id: int = -1
    addr: str = ""


@message
class PsStatsReport:
    """PS node -> master: periodic telemetry for the hot-PS optimizer."""

    node_id: int = -1
    qps: float = 0.0
    cpu_percent: float = 0.0
    total_rows: int = 0


@message
class PsSetPartitionsRequest:
    """Master -> PS: own these partitions at this map version."""

    partitions: List[int] = dataclasses.field(default_factory=list)
    map_version: int = 0


@message
class StreamBarrierRequest:
    """Trainer -> master: cut a barrier-consistent checkpoint of the
    streaming sparse path (Chandy-Lamport style: the trainer has
    quiesced its in-flight applies before sending this). The master
    flushes every PS partition stamped with the shard ledger's
    high-water marks, then durably journals (epoch, offsets,
    watermarks, flush generation) as one atomic snapshot before
    acking. ``epoch`` < 0 asks the master to assign the next epoch."""

    dataset_name: str = ""
    epoch: int = -1
    step: int = 0


@message
class StreamBarrierResponse:
    """The durable barrier record (also the answer to a
    StreamBarrierQueryRequest; ``epoch`` < 0 = no barrier yet)."""

    dataset_name: str = ""
    epoch: int = -1
    step: int = 0
    # Per-stream-partition fabrication offsets at the cut.
    offsets: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Per-stream-partition completed-record watermarks at the cut.
    watermarks: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Master state-store generation the record became durable in.
    flush_gen: int = 0
    flushed_rows: int = 0
    durable: bool = False


@message
class StreamBarrierQueryRequest:
    """Trainer -> master: the last durable barrier for a dataset
    (resume point after a trainer restart)."""

    dataset_name: str = ""


# ---------------------------------------------------------------------------
# Serving plane (dlrover_tpu/serving/): clients submit generation
# requests to the master's router; replicas PULL work and REPORT
# completions/stats, mirroring the task-manager shard protocol so the
# same requeue-on-death semantics apply to requests.
# ---------------------------------------------------------------------------


@message
class ServeSubmitRequest:
    """Client -> master: one generation request. ``request_id`` is an
    optional caller idempotence token (resubmitting a known id
    returns it unchanged instead of double-queueing)."""

    prompt: List[int] = dataclasses.field(default_factory=list)
    max_new_tokens: int = 16
    temperature: float = 0.0
    request_id: str = ""


@message
class ServeSubmitResponse:
    request_id: str = ""
    accepted: bool = True
    # The distributed trace minted (or adopted) for this request at
    # the router — feed it to query_traces for the causal timeline.
    trace_id: str = ""


@message
class ServeWorkItem:
    """One dispatched request on the wire (router -> replica).
    ``trace`` is the request's trace context (an
    ``obs.tracer.inject()`` carrier): the replica re-attaches it so
    scheduler events on any hop — including every requeue hop —
    stay in one causal timeline."""

    request_id: str = ""
    prompt: List[int] = dataclasses.field(default_factory=list)
    max_new_tokens: int = 16
    temperature: float = 0.0
    trace: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Prefill/decode disaggregation: a packed HandoffPayload wire
    # dict (serving/handoff.py — raw KV bytes + dtype/shape, msgpack-
    # safe) when this item is a completed prefill bound for a
    # decode-role replica; empty for raw prompts.
    handoff: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class ServePullRequest:
    """Replica -> master: give me up to ``max_items`` requests. Only
    READY replicas are fed; the pull counts as liveness progress."""

    replica_id: int = -1
    max_items: int = 1


@message
class ServePullResponse:
    items: List[ServeWorkItem] = dataclasses.field(
        default_factory=list
    )


@message
class ServeCompletedReport:
    """Replica -> master: a request finished (or failed when
    ``error`` is non-empty). First completion wins in the router's
    ledger; late duplicates after a requeue are dropped."""

    replica_id: int = -1
    request_id: str = ""
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    finish_reason: str = ""
    error: str = ""
    # Replica-side TTFT decomposition, per-phase durations in seconds
    # (dispatch = scheduler queue wait, prefill, first_decode, decode,
    # and "handoff" — the decode replica's import wait — on
    # disaggregated completions) — the master folds these into the
    # request's trace timeline and the
    # dlrover_serve_ttft_phase_seconds histograms.
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Prefill/decode disaggregation: a prefill-role replica reports a
    # finished PROMPT here — the packed KV HandoffPayload rides this
    # field and the report is a stage transition (queued for a decode
    # replica), not a completion.
    handoff: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class ServeResultRequest:
    request_id: str = ""


@message
class ServeResultResponse:
    """The router ledger's view of one request. ``state`` is
    queued | dispatched | done | failed (empty = unknown id)."""

    request_id: str = ""
    state: str = ""
    replica_id: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: str = ""
    finish_reason: str = ""
    requeues: int = 0
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    latency_s: float = 0.0
    trace_id: str = ""
    # Master-assembled TTFT decomposition: queue (router) + the
    # replica-reported phases of the completing hop.
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)


@message
class ServeStatsReport:
    """Replica -> master: periodic scheduler telemetry (the
    ``ContinuousBatchingScheduler.stats()`` dict: queue depth, active
    sequences, KV pool snapshot, TTFT/TPOT percentiles, token
    counters). The router treats a moving token counter as serving
    progress for the replica_unhealthy watchdog."""

    replica_id: int = -1
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class ServeQueryRequest:
    """Fetch the router's FULL serving snapshot (per-replica
    health/stats, request counters, QPS/p99) — the obs_report
    --serving feed. Deliberately fieldless: there is no per-node
    filter, and a dead field would advertise one."""

    pass


@message
class ServeQueryResponse:
    enabled: bool = False
    snapshot: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class TraceQueryRequest:
    """Fetch assembled trace timelines from the master's trace store.
    ``trace_id`` wins when given; else ``subject`` filters by
    membership (a serving request id, or ``node:<id>``); else every
    retained trace. ``limit`` > 0 keeps the newest N."""

    trace_id: str = ""
    subject: str = ""
    limit: int = 0


@message
class TraceQueryResponse:
    """``traces`` are trace-store timelines: ``{trace_id, start_ts,
    end_ts, subjects, spans: [{name, span_id, parent_span_id,
    start_ts, dur_s, tags}], dropped_spans}``, newest last."""

    enabled: bool = False
    traces: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )


# ---------------------------------------------------------------------------
# Multi-job pool control plane (dlrover_tpu/pool/): clients submit
# jobs to the pool master's gang scheduler; every per-job RPC above
# rides the same envelope with its ``_job`` id, so these messages are
# only the POOL-level surface (submit/status/snapshot).
# ---------------------------------------------------------------------------


@message
class PoolSubmitRequest:
    """Client/operator -> pool master: queue one job. ``priority`` is
    an integer band (higher wins; bounded 0..9 by the scheduler);
    ``n_slices`` the gang size (placed whole or not at all);
    ``min_slices`` > 0 the elastic floor a PREEMPTED job may resume
    with when full capacity has not returned yet. Resubmitting a
    known ``job_id`` is idempotent (returns its current state)."""

    job_id: str = ""
    tenant: str = "default"
    priority: int = 0
    n_slices: int = 1
    min_slices: int = 0
    queue: str = "default"


@message
class PoolSubmitResponse:
    job_id: str = ""
    accepted: bool = True
    state: str = ""  # a PoolJobState value
    reason: str = ""  # e.g. "quota: tenant over cap" when queued
    # The job's pool-lifecycle distributed trace (submit -> queue ->
    # place -> [preempt -> resume]* -> complete) — feed query_traces.
    trace_id: str = ""


@message
class PoolJobStatusRequest:
    job_id: str = ""


@message
class PoolJobStatusResponse:
    job_id: str = ""
    known: bool = False
    state: str = ""
    tenant: str = ""
    priority: int = 0
    n_slices: int = 0
    slices: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    trace_id: str = ""
    message: str = ""


@message
class PoolQueryRequest:
    """Fetch the pool scheduler's FULL snapshot (queue depth per
    priority band, per-tenant quota usage, slice utilization,
    preemption counts, wait-time percentiles) — the
    ``obs_report --pool`` feed. Deliberately fieldless, like
    ServeQueryRequest."""

    pass


@message
class PoolQueryResponse:
    enabled: bool = False
    snapshot: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class CapacityQueryRequest:
    """Fetch the pool master's capacity accounting rollup: per-tenant
    chip-second totals by slice state, goodput-per-chip, and the SLO
    error-budget standing (budget remaining + active burn alerts) —
    the ``obs_report --capacity`` feed. Fieldless, like
    PoolQueryRequest."""

    pass


@message
class CapacityQueryResponse:
    enabled: bool = False
    # CapacityLedger.snapshot() with an "slo" block
    # ({"budgets": HealthMonitor.slo_snapshot()}) attached.
    snapshot: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class StallQueryRequest:
    """Fetch the master's stall-localization snapshot: the per-host
    progress table (last beacon step/phase/age), any open or recent
    ``collective_stall`` incident with its localized culprit, trace
    id, and coordinated-capture bundle paths — the
    ``obs_report --stall`` feed. Fieldless, like CapacityQueryRequest."""

    pass


@message
class StallQueryResponse:
    enabled: bool = False
    # StallCorrelator.snapshot(): {"hosts": {host: {...progress...}},
    # "incident": {...} | {}, "incidents": [...], "config": {...}}.
    snapshot: Dict[str, Any] = dataclasses.field(default_factory=dict)


# -- brain service wire messages (standalone brain: brain/server.py) --


@message
class BrainPersistRequest:
    """Master/agents -> brain: persist one record. ``kind`` selects
    the table ("metrics" | "sample" | "ps_job"); ``payload`` carries
    the record's fields (JobMetricsRecord / RuntimeSample /
    persist_ps_job kwargs)."""

    kind: str = ""
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class BrainOptimizeRequest:
    """Master -> brain: run a registered algorithm (the reference's
    brain.Optimize RPC with its ProcessorID dispatch,
    go/brain/pkg/optimizer/...). ``args``/``kwargs`` feed the
    algorithm's positional/keyword parameters after the service."""

    algorithm: str = ""
    args: List[Any] = dataclasses.field(default_factory=list)
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class BrainOptimizeResponse:
    ok: bool = True
    # Algorithm result, JSON-ish (None / number / dict / list).
    result: Any = None
    error: str = ""


# ---------------------------------------------------------------------------
# Cross-pod data ingest (ref: atorch coworker pods feeding training
# pods over RPC, atorch/data/coworker_dataset.py:16,25-40 +
# shm_context.py — there torch rpc, here the typed msgpack layer)
# ---------------------------------------------------------------------------


@message
class DataBatchPush:
    """Remote coworker pod -> training host: one preprocessed batch.

    The training host's BatchIngestServer (data/ingest.py) copies the
    arrays into its local shm ring; the reply is a DataBatchAck whose
    ``accepted=False`` is backpressure (ring full) — the pod retries
    after a backoff instead of overrunning the consumer."""

    pod_id: int = 0
    seq: int = 0
    arrays: Dict[str, Tensor] = dataclasses.field(default_factory=dict)


@message
class DataBatchAck:
    accepted: bool = True


@message
class DataStreamEnd:
    """Remote pod -> training host: this pod's stream is over (or
    failed, when ``error`` is non-empty)."""

    pod_id: int = 0
    produced: int = 0
    error: str = ""
