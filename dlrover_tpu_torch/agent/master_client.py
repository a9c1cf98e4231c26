"""Typed client to the job master, used by agents and trainers.

Parity: dlrover/python/elastic_agent/master_client.py:49 (MasterClient
with the retry decorator at :26), re-typed onto the msgpack schema —
plus a connection supervisor so a master outage (pod reschedule, OOM,
network partition) is ridden out instead of killing the fleet.

Two retry layers with distinct jobs:

* :class:`ConnectionSupervisor` — *transient* transport failures
  (master unreachable) are retried with exponential backoff and
  decorrelated jitter under a total outage budget
  (``DLROVER_TPU_MASTER_RECONNECT_SECONDS``, default 300 s). On the
  first success after an outage it re-registers this node (the master
  may be a warm-restarted replacement) and fires reconnect callbacks.
  Budget exhaustion raises :class:`MasterOutageError`.
* :func:`retry` — brief *application-level* hiccups (a server handler
  momentarily failing) get a couple of jittered retries. It never
  re-retries a :class:`MasterOutageError`: the supervisor already
  spent the whole outage budget.
"""

from __future__ import annotations

import functools
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import grpc

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import RpcClient, RpcError
from dlrover_tpu_torch.common.constants import (
    NodeAction,
    NodeEnv,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("master_client")

RECONNECT_SECONDS_ENV = "DLROVER_TPU_MASTER_RECONNECT_SECONDS"
RECONNECT_BASE_ENV = "DLROVER_TPU_MASTER_RECONNECT_BASE"

# gRPC status codes that mean "the master may be down / unreachable"
# rather than "this request is wrong". Everything else is fatal for
# the call (retrying an INVALID_ARGUMENT forever helps nobody).
_TRANSIENT_GRPC_CODES = frozenset(
    (
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
        grpc.StatusCode.CANCELLED,
        grpc.StatusCode.UNKNOWN,
    )
)


class MasterOutageError(RuntimeError):
    """The master stayed unreachable past the reconnect budget."""


def is_transient_rpc_error(exc: BaseException) -> bool:
    """Transport-level failures worth riding out: a dead/restarting
    master, a partition, or an injected chaos fault. Server-side
    handler failures (our :class:`RpcError`) are NOT transient — the
    master answered, retrying blind would loop on a real bug."""
    if isinstance(exc, MasterOutageError):
        return False
    if isinstance(exc, RpcError):
        return False
    if isinstance(exc, grpc.RpcError):
        code = exc.code() if callable(getattr(exc, "code", None)) else None
        return code in _TRANSIENT_GRPC_CODES
    # ChaosDropError subclasses ConnectionError on purpose.
    return isinstance(exc, (ConnectionError, ConnectionResetError, OSError))


class ConnectionSupervisor:
    """Retries transient failures under one shared outage budget.

    Thread-safe: all of a process's RPC paths (heartbeat thread,
    resource monitor, sharding client, rendezvous poll) share the
    outage clock, which starts at the first observed failure and
    clears on any success. ``on_reconnect`` callbacks fire exactly
    once per outage, from the thread whose call first succeeded.
    """

    def __init__(
        self,
        outage_budget: Optional[float] = None,
        backoff_base: Optional[float] = None,
        backoff_cap: float = 15.0,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if outage_budget is None:
            outage_budget = float(
                os.getenv(RECONNECT_SECONDS_ENV, "") or 300.0
            )
        if backoff_base is None:
            backoff_base = float(
                os.getenv(RECONNECT_BASE_ENV, "") or 0.5
            )
        self.outage_budget = outage_budget
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._lock = threading.Lock()
        self._outage_since: Optional[float] = None  # monotonic
        self.on_reconnect: List[Callable[[], None]] = []
        self.outages = 0
        self.reconnects = 0

    def outage_elapsed(self) -> Optional[float]:
        with self._lock:
            if self._outage_since is None:
                return None
            return time.monotonic() - self._outage_since

    def _note_failure(self) -> float:
        """Record a transient failure; returns seconds into the
        outage."""
        now = time.monotonic()
        with self._lock:
            if self._outage_since is None:
                self._outage_since = now
                self.outages += 1
            return now - self._outage_since

    def _note_success(self) -> bool:
        """Clear any outage; True when this call ended one."""
        with self._lock:
            was_out = self._outage_since is not None
            self._outage_since = None
            if was_out:
                self.reconnects += 1
            return was_out

    def call(
        self,
        fn: Callable[[], object],
        what: str = "rpc",
        max_wait: Optional[float] = None,
    ):
        """Run ``fn``, riding out transient failures.

        ``max_wait`` caps how long THIS call may retry, independent of
        the shared outage budget — for callers that have something
        better to do locally than wait out a whole outage (e.g. a
        failure report whose caller will restart the dead trainer
        anyway)."""
        sleep_s = self.backoff_base
        warned = 1.0
        started = time.monotonic()
        while True:
            try:
                result = fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_transient_rpc_error(e):
                    raise
                elapsed = self._note_failure()
                waited = time.monotonic() - started
                if elapsed >= self.outage_budget or (
                    max_wait is not None and waited >= max_wait
                ):
                    raise MasterOutageError(
                        f"master unreachable for {elapsed:.1f}s "
                        f"(budget {self.outage_budget:.0f}s, call "
                        f"waited {waited:.1f}s"
                        + (
                            f" of max {max_wait:.0f}s"
                            if max_wait is not None else ""
                        )
                        + f") during {what}: {e}"
                    ) from e
                # Decorrelated jitter (never fleet-synchronized
                # thundering herd), capped and clipped to the budget.
                sleep_s = min(
                    self.backoff_cap,
                    self._rng.uniform(self.backoff_base, sleep_s * 3),
                )
                sleep_s = min(
                    sleep_s, max(self.outage_budget - elapsed, 0.05)
                )
                if max_wait is not None:
                    sleep_s = min(
                        sleep_s, max(max_wait - waited, 0.05)
                    )
                if elapsed >= warned:
                    logger.warning(
                        "master unreachable %.1fs into outage "
                        "(budget %.0fs) during %s; retrying in %.2fs",
                        elapsed, self.outage_budget, what, sleep_s,
                    )
                    warned = max(warned * 2, elapsed + sleep_s)
                self._sleep(sleep_s)
                continue
            if self._note_success():
                logger.info(
                    "master connection recovered (during %s)", what
                )
                for cb in list(self.on_reconnect):
                    try:
                        cb()
                    except Exception:  # noqa: BLE001 — a broken
                        # callback must not fail the recovered call
                        logger.warning(
                            "reconnect callback failed", exc_info=True
                        )
            return result


def retry(times: int = 3, interval: float = 1.0):
    """Brief application-level retries with jitter. Does not sleep
    after the final failed attempt (the old version wasted up to
    ``times * interval`` seconds on the error path before raising),
    and never re-retries an exhausted reconnect budget."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            last_exc: Optional[Exception] = None
            for attempt in range(times):
                try:
                    return fn(*args, **kwargs)
                except MasterOutageError:
                    # The supervisor already spent the whole outage
                    # budget; times x that again helps nobody.
                    raise
                except Exception as e:  # noqa: BLE001
                    last_exc = e
                    logger.warning(
                        "%s failed (attempt %d/%d): %s",
                        fn.__name__,
                        attempt + 1,
                        times,
                        e,
                    )
                    if attempt + 1 < times:
                        time.sleep(
                            interval
                            * (attempt + 1)
                            * random.uniform(0.5, 1.5)
                        )
            raise last_exc  # type: ignore[misc]

        return wrapped

    return decorator


class MasterClient:
    """One instance per process; safe to share across threads."""

    _singleton: Optional["MasterClient"] = None

    def __init__(
        self,
        addr: str,
        node_id: int = 0,
        node_rank: int = -1,
        job_id: str = "",
    ):
        # wait_for_ready: during a master outage the channel sits in
        # TRANSIENT_FAILURE; queued-until-connected calls recover the
        # instant the replacement master serves, instead of failing
        # fast until gRPC's backoff deigns to redial.
        # ``job_id`` (or DLROVER_TPU_POOL_JOB_ID via singleton())
        # rides every request's envelope so a multi-job pool master
        # routes this process's RPCs to ITS job's servicer; ""
        # preserves single-job behavior exactly.
        self.job_id = job_id
        self._client = RpcClient(addr, wait_for_ready=True, job_id=job_id)
        self.node_id = node_id
        self.node_rank = node_rank if node_rank >= 0 else node_id
        # Rides out master outages (reschedule, partition) on every
        # critical RPC path. Best-effort telemetry deliberately stays
        # OFF the supervisor: a trainer's step report must drop fast
        # during an outage, not block a hot loop for minutes.
        self.supervisor = ConnectionSupervisor()
        self.supervisor.on_reconnect.append(self._on_reconnected)
        # Remembered registration facts for idempotent re-register
        # after a reconnect (the master may be a warm-restarted
        # replacement that needs this node announced again; the
        # job-manager register path is re-register-safe).
        self._registration: Optional[
            Tuple[str, str, Dict[str, str]]
        ] = None
        # User hooks fired after re-registration on every reconnect
        # (e.g. resend a sharding snapshot / metrics snapshot).
        self._reconnect_callbacks: List[Callable[[], None]] = []

    # -- reconnect handling --------------------------------------------------

    def add_reconnect_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` after each reconnect (post re-registration)."""
        self._reconnect_callbacks.append(fn)

    def _on_reconnected(self) -> None:
        """First successful RPC after an outage: re-announce this node
        (idempotent on the master), then let subscribers resend their
        snapshots. Uses the RAW client — the supervisor is mid-call,
        and a failure here will be healed by the next outage cycle."""
        if self._registration is not None:
            node_type, node_ip, reg_labels = self._registration
            try:
                self._client.report(
                    msg.NodeAddressRequest(
                        node_id=self.node_id,
                        node_type=node_type,
                        node_ip=node_ip,
                        labels=dict(reg_labels),
                    )
                )
                logger.info(
                    "re-registered node %d (%s) after reconnect",
                    self.node_id, node_type,
                )
            except Exception:  # noqa: BLE001
                logger.warning(
                    "post-reconnect re-registration failed",
                    exc_info=True,
                )
        for cb in list(self._reconnect_callbacks):
            try:
                cb()
            except Exception:  # noqa: BLE001
                logger.warning(
                    "reconnect callback failed", exc_info=True
                )

    def _get(
        self,
        request,
        what: Optional[str] = None,
        max_wait: Optional[float] = None,
    ):
        return self.supervisor.call(
            lambda: self._client.get(request),
            what=what or type(request).__name__,
            max_wait=max_wait,
        )

    def _report(self, request, what: Optional[str] = None):
        return self.supervisor.call(
            lambda: self._client.report(request),
            what=what or type(request).__name__,
        )

    @classmethod
    def singleton(cls) -> "MasterClient":
        if cls._singleton is None:
            addr = os.getenv(NodeEnv.MASTER_ADDR, "")
            if not addr:
                raise RuntimeError(
                    f"{NodeEnv.MASTER_ADDR} not set; is this process "
                    "running under dlrover-tpu-run?"
                )
            node_id = int(os.getenv(NodeEnv.NODE_ID, "0"))
            node_rank = int(os.getenv(NodeEnv.NODE_RANK, "-1"))
            job_id = os.getenv(NodeEnv.POOL_JOB_ID, "")
            cls._singleton = cls(
                addr, node_id, node_rank, job_id=job_id
            )
        return cls._singleton

    @classmethod
    def reset(cls) -> None:
        cls._singleton = None

    # -- node lifecycle -----------------------------------------------------

    @retry()
    def register_node(
        self,
        node_type: str = "worker",
        node_ip: str = "",
        labels: Optional[Dict[str, str]] = None,
    ):
        # Remember the facts FIRST: even if this attempt dies mid-
        # outage, the supervisor's reconnect path can re-announce.
        self._registration = (node_type, node_ip, dict(labels or {}))
        self._report(
            msg.NodeAddressRequest(
                node_id=self.node_id,
                node_type=node_type,
                node_ip=node_ip,
                labels=dict(labels or {}),
            )
        )

    @retry()
    def report_failure(
        self,
        error_data: str,
        level: str,
        restart_count: int = 0,
        fatal: bool = False,
        diagnostics: str = "",
    ) -> str:
        # Bounded wait (not the full outage budget): the caller has a
        # DEAD or HUNG trainer in hand and will restart it locally on
        # failure — blocking the supervision loop for minutes to ask
        # a dead master's opinion would hold chips hostage.
        resp = self.supervisor.call(
            lambda: self._client.report(
                msg.NodeFailureReport(
                    node_id=self.node_id,
                    error_data=error_data,
                    level=level,
                    restart_count=restart_count,
                    fatal=fatal,
                    diagnostics=diagnostics,
                )
            ),
            what="NodeFailureReport",
            max_wait=30.0,
        )
        return resp.action if resp else NodeAction.RESTART_IN_PLACE

    @retry()
    def report_succeeded(self):
        # Bounded: worth waiting a bit (an unreported success decays
        # into a heartbeat-timeout "failure" on the master), but not
        # worth pinning a finished agent to the outage budget.
        self.supervisor.call(
            lambda: self._client.report(
                msg.NodeSucceededReport(node_id=self.node_id)
            ),
            what="NodeSucceededReport",
            max_wait=60.0,
        )

    def heartbeat(self) -> str:
        """One beat. Deliberately NOT supervised: the heartbeat loop
        owns per-tick failure accounting (its failure counter and
        escalating warnings are how a master outage shows up in
        telemetry — the supervisor retrying internally would flatline
        them for any outage shorter than the whole budget) and must
        stay responsive to stop/action delivery. The bounded
        queue-until-ready timeout still heals the gRPC channel the
        moment a replacement master serves, and the loop calls
        :meth:`notify_master_recovered` on the first healthy beat
        after a failure streak."""
        resp = self._client.report(
            msg.HeartbeatRequest(
                node_id=self.node_id, timestamp=time.time()
            ),
            timeout=10.0,
        )
        return resp.action if resp else "none"

    def notify_master_recovered(self) -> None:
        """Re-register + fire resend hooks after an outage observed
        OUTSIDE the supervisor (the heartbeat loop's streak
        recovery). Idempotent — harmless if a supervised call already
        reconnected."""
        self._on_reconnected()

    # -- rendezvous ---------------------------------------------------------

    @retry()
    def join_rendezvous(
        self,
        local_world_size: int,
        rdzv_name: str = RendezvousName.TRAINING,
    ) -> int:
        resp = self._get(
            msg.JoinRendezvousRequest(
                node_id=self.node_id,
                node_rank=self.node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
            )
        )
        return resp.round

    def get_comm_world(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> Tuple[int, int, Dict[int, int]]:
        resp = self._get(
            msg.CommWorldRequest(
                node_id=self.node_id,
                node_rank=self.node_rank,
                rdzv_name=rdzv_name,
            )
        )
        return resp.round, resp.group, resp.world

    def num_nodes_waiting(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> int:
        try:
            resp = self._client.get(
                msg.WaitingNodeNumRequest(
                    node_id=self.node_id, rdzv_name=rdzv_name
                ),
                wait_for_ready=False,
            )
            return resp.waiting_num
        except Exception:  # noqa: BLE001 - polling must not kill the agent
            return 0

    @retry()
    def report_network_check(self, normal: bool, elapsed_time: float):
        self._report(
            msg.NetworkCheckResultRequest(
                node_id=self.node_rank,
                normal=normal,
                elapsed_time=elapsed_time,
            )
        )

    def query_fault_nodes(self) -> Tuple[List[int], str]:
        resp = self._get(msg.NetworkCheckQueryRequest(kind="fault"))
        return resp.nodes, resp.reason

    def query_stragglers(self) -> Tuple[List[int], str]:
        resp = self._get(
            msg.NetworkCheckQueryRequest(kind="straggler")
        )
        return resp.nodes, resp.reason

    # -- kv store -----------------------------------------------------------

    @retry()
    def kv_set(self, key: str, value: bytes):
        self._report(msg.KVStoreSetRequest(key=key, value=value))

    def kv_get(self, key: str) -> Optional[bytes]:
        resp = self._get(msg.KVStoreGetRequest(key=key))
        return resp.value if resp.found else None

    def kv_add(self, key: str, amount: int) -> int:
        # NOT supervised: the add is not idempotent — a retry after a
        # lost response would double-apply the increment (callers use
        # this for unique-id assignment). Single attempt, caller owns
        # the ambiguity of a failure, exactly as before the
        # supervisor existed.
        resp = self._client.get(
            msg.KVStoreAddRequest(key=key, amount=amount)
        )
        return resp.value

    def kv_wait(self, key: str, timeout: float = 120.0) -> bytes:
        # Monotonic deadline: an NTP step must not fire or mask it.
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = self.kv_get(key)
            if value is not None:
                return value
            time.sleep(0.2)
        raise TimeoutError(f"kv key {key!r} not set within {timeout}s")

    # -- data sharding ------------------------------------------------------

    @retry()
    def create_dataset(
        self,
        dataset_name: str,
        dataset_size: int,
        batch_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        storage_type: str = "table",
        task_type: str = "training",
        num_stream_partitions: int = 1,
    ):
        self._report(
            msg.DatasetShardParams(
                batch_size=batch_size,
                num_epochs=num_epochs,
                dataset_size=dataset_size,
                shuffle=shuffle,
                num_minibatches_per_shard=num_minibatches_per_shard,
                dataset_name=dataset_name,
                task_type=task_type,
                storage_type=storage_type,
                num_stream_partitions=num_stream_partitions,
            )
        )

    @retry()
    def stream_barrier(
        self, dataset_name: str, epoch: int, step: int
    ) -> msg.StreamBarrierResponse:
        """Commit a stream barrier: coordinated PS flush stamped with
        the shard ledger's HWM, then a durable journal record. The
        caller must have quiesced its sparse applies first."""
        return self._get(msg.StreamBarrierRequest(
            dataset_name=dataset_name, epoch=epoch, step=step
        ))

    @retry()
    def query_stream_barrier(
        self, dataset_name: str
    ) -> msg.StreamBarrierResponse:
        return self._get(msg.StreamBarrierQueryRequest(
            dataset_name=dataset_name
        ))

    def get_task(self, dataset_name: str) -> msg.Task:
        return self._get(
            msg.TaskRequest(node_id=self.node_id, dataset_name=dataset_name)
        )

    @retry()
    def report_task_result(
        self, dataset_name: str, task_id: int, success: bool = True
    ):
        self._report(
            msg.TaskResultRequest(
                node_id=self.node_id,
                dataset_name=dataset_name,
                task_id=task_id,
                success=success,
            )
        )

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self._get(
            msg.ShardCheckpointRequest(dataset_name=dataset_name)
        )
        return resp.content

    @retry()
    def restore_shard_checkpoint(self, dataset_name: str, content: str):
        self._report(
            msg.RestoreShardRequest(dataset_name=dataset_name, content=content)
        )

    # -- auto-tuning --------------------------------------------------------

    def get_parallel_config(self):
        """Master-pushed tuning config (ref ParalConfigTuner)."""
        return self._get(
            msg.ParallelConfigRequest(node_id=self.node_id)
        )

    # -- metrics ------------------------------------------------------------

    def report_step(self, step: int, tokens: int = 0):
        try:
            self._client.report(
                msg.StepReport(
                    node_id=self.node_id,
                    timestamp=time.time(),
                    step=step,
                    tokens=tokens,
                ),
                wait_for_ready=False,
            )
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            pass

    def report_resource(
        self,
        cpu_percent: float,
        memory_mb: int,
        hbm_used_gb: float = 0.0,
        duty_cycle: float = 0.0,
    ):
        try:
            self._client.report(
                msg.ResourceStats(
                    node_id=self.node_id,
                    cpu_percent=cpu_percent,
                    memory_mb=memory_mb,
                    hbm_used_gb=hbm_used_gb,
                    duty_cycle=duty_cycle,
                ),
                wait_for_ready=False,
            )
        except Exception:  # noqa: BLE001
            pass

    def report_metrics_snapshot(
        self,
        host: str,
        registry: Optional[dict] = None,
        resource: Optional[dict] = None,
        step_times: Optional[list] = None,
        events: Optional[list] = None,
        timestamp: Optional[float] = None,
        beacon: Optional[dict] = None,
    ):
        """Ship this host's telemetry snapshot to the master's
        FleetAggregator (ResourceMonitor cadence). Best-effort like
        every other telemetry report."""
        try:
            self._client.report(
                msg.MetricsSnapshotReport(
                    node_id=self.node_id,
                    host=host,
                    timestamp=(
                        timestamp if timestamp is not None else time.time()
                    ),
                    registry=registry or {},
                    resource=resource or {},
                    step_times=list(step_times or []),
                    events=list(events or []),
                    beacon=dict(beacon or {}),
                ),
                wait_for_ready=False,
            )
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            pass

    # -- forensics ----------------------------------------------------------

    def report_diagnostics(
        self, kind: str, bundle_path: str = "", digest: str = ""
    ):
        """Ship a forensics digest (hang / crash / on-demand diagnose)
        to the master's per-node history. Best-effort: forensics must
        never block or fail the recovery path it documents."""
        try:
            self._client.report(
                msg.DiagnosticsReport(
                    node_id=self.node_id,
                    kind=kind,
                    bundle_path=bundle_path,
                    digest=digest,
                    timestamp=time.time(),
                ),
                wait_for_ready=False,
            )
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            logger.warning(
                "could not ship %s diagnostics to master", kind,
                exc_info=True,
            )

    def query_diagnostics(self, node_id: int = -1) -> List:
        """The master's stored DiagnosticsReport history (tools)."""
        resp = self._get(
            msg.DiagnosticsQueryRequest(node_id=node_id)
        )
        return list(resp.reports)

    def query_health(
        self,
        node_id: int = -1,
        include_history: bool = False,
        max_wait: Optional[float] = None,
    ) -> msg.HealthQueryResponse:
        """The master's health plane: composite score + active
        verdicts (optionally the transition history), filtered to one
        node with ``node_id``. Tools and the operator use this as the
        typed counterpart of the /healthz endpoint; probes pass
        ``max_wait`` so a down master fails fast instead of riding
        out the full reconnect budget."""
        return self._get(
            msg.HealthQueryRequest(
                node_id=node_id, include_history=include_history
            ),
            max_wait=max_wait,
        )

    def query_remediation(
        self,
        node_id: int = -1,
        limit: int = 0,
        max_wait: Optional[float] = None,
    ) -> msg.RemediationQueryResponse:
        """The master's remediation engine: mode (enabled/dry-run),
        cordoned nodes, decision history with per-governor audit
        trails, and whether a probation window is currently failing.
        Probes pass ``max_wait`` so a down master fails fast."""
        return self._get(
            msg.RemediationQueryRequest(node_id=node_id, limit=limit),
            max_wait=max_wait,
        )

    def request_profile(self, node_id: int) -> None:
        """Operator trigger: ask the master to queue a PROFILE action
        for ``node_id`` (its agent captures an N-step phase/MFU
        digest into the diagnostics history)."""
        self._report(msg.ProfileActionRequest(node_id=node_id))

    # -- serving plane ----------------------------------------------------

    def serve_submit(
        self,
        prompt: List[int],
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        request_id: str = "",
    ) -> msg.ServeSubmitResponse:
        """Submit one generation request to the master's router.
        ``request_id`` is an idempotence token: RPC retries resubmit
        the same id and the ledger keeps one entry. When the caller
        supplies none, a client-side UUID is minted BEFORE the call —
        a supervisor retry after a lost response must replay the same
        token, or every network blip would double-queue the
        request."""
        import uuid

        return self._get(
            msg.ServeSubmitRequest(
                prompt=[int(t) for t in prompt],
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                request_id=request_id or f"req-{uuid.uuid4().hex}",
            )
        )

    def serve_result(
        self, request_id: str, max_wait: Optional[float] = None
    ) -> msg.ServeResultResponse:
        return self._get(
            msg.ServeResultRequest(request_id=request_id),
            max_wait=max_wait,
        )

    def serve_pull(
        self, replica_id: int, max_items: int = 1
    ) -> List[msg.ServeWorkItem]:
        """Replica side: pull up to ``max_items`` dispatched
        requests off the router's queue."""
        resp = self._get(
            msg.ServePullRequest(
                replica_id=replica_id, max_items=max_items
            )
        )
        return list(resp.items)

    def serve_complete(
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
    ) -> None:
        """``handoff`` (a packed HandoffPayload wire dict) turns the
        report into a prefill->decode stage transition: the KV rides
        this same RPC seam up to the master's staging queue."""
        self._report(
            msg.ServeCompletedReport(
                replica_id=replica_id,
                request_id=request_id,
                tokens=[int(t) for t in tokens],
                ttft_s=ttft_s,
                tpot_s=tpot_s,
                finish_reason=finish_reason,
                error=error,
                phases={
                    str(k): float(v)
                    for k, v in (phases or {}).items()
                },
                handoff=dict(handoff or {}),
            )
        )

    def serve_stats(self, replica_id: int, stats: dict) -> None:
        """Best-effort replica telemetry; a lost report is the next
        interval's problem, never the step loop's."""
        try:
            self._report(
                msg.ServeStatsReport(
                    replica_id=replica_id, stats=dict(stats)
                ),
                what="serve_stats",
            )
        except Exception:  # noqa: BLE001 — telemetry must not kill
            # the replica loop
            logger.debug("serve stats report failed", exc_info=True)

    def query_traces(
        self,
        trace_id: str = "",
        subject: str = "",
        limit: int = 0,
        max_wait: Optional[float] = None,
    ) -> msg.TraceQueryResponse:
        """Assembled distributed-trace timelines from the master's
        trace store. ``trace_id`` fetches one trace; ``subject``
        filters by membership (a serving request id, or
        ``node:<id>``); ``limit`` > 0 keeps the newest N. The
        ``obs_report --trace`` feed."""
        return self._get(
            msg.TraceQueryRequest(
                trace_id=trace_id, subject=subject, limit=limit
            ),
            max_wait=max_wait,
        )

    def query_serving(
        self, max_wait: Optional[float] = None
    ) -> msg.ServeQueryResponse:
        """The router's serving snapshot (per-replica health/stats,
        request counters, QPS/p99) — obs_report --serving's feed."""
        return self._get(
            msg.ServeQueryRequest(), max_wait=max_wait
        )

    # -- multi-job pool plane ---------------------------------------------

    def pool_submit(
        self,
        job_id: str,
        tenant: str = "default",
        priority: int = 0,
        n_slices: int = 1,
        min_slices: int = 0,
        queue: str = "default",
    ) -> msg.PoolSubmitResponse:
        """Submit a job to the pool master's gang scheduler.
        Idempotent on ``job_id`` (a resubmission returns the job's
        current state instead of double-queueing)."""
        return self._get(
            msg.PoolSubmitRequest(
                job_id=job_id,
                tenant=tenant,
                priority=priority,
                n_slices=n_slices,
                min_slices=min_slices,
                queue=queue,
            )
        )

    def pool_job_status(
        self, job_id: str, max_wait: Optional[float] = None
    ) -> msg.PoolJobStatusResponse:
        return self._get(
            msg.PoolJobStatusRequest(job_id=job_id),
            max_wait=max_wait,
        )

    def query_pool(
        self, max_wait: Optional[float] = None
    ) -> msg.PoolQueryResponse:
        """The pool scheduler's snapshot (queue depth per band,
        per-tenant quota usage, slice utilization, preemptions,
        wait percentiles) — obs_report --pool's feed."""
        return self._get(msg.PoolQueryRequest(), max_wait=max_wait)

    def query_capacity(
        self, max_wait: Optional[float] = None
    ) -> msg.CapacityQueryResponse:
        """The pool master's capacity accounting rollup (per-tenant
        chip-seconds by state, goodput-per-chip, SLO budget standing)
        — obs_report --capacity's feed."""
        return self._get(
            msg.CapacityQueryRequest(), max_wait=max_wait
        )

    def query_stall(
        self, max_wait: Optional[float] = None
    ) -> msg.StallQueryResponse:
        """The master's stall-localization snapshot (per-host beacon
        progress table, open/recent collective_stall incidents with
        culprit + trace id + capture bundles) — obs_report --stall's
        feed."""
        return self._get(
            msg.StallQueryRequest(), max_wait=max_wait
        )

    def query_metrics(
        self, max_wait: Optional[float] = None
    ) -> str:
        """The master's Prometheus text exposition over the control
        plane (same payload as GET /metrics)."""
        resp = self._get(
            msg.MetricsRequest(node_id=self.node_id),
            max_wait=max_wait,
        )
        return resp.text

    # -- PS-elastic sparse path ------------------------------------------

    @retry()
    def get_partition_map(self):
        """Fetch the current embedding PartitionMap (sparse path)."""
        from dlrover_tpu_torch.sparse.partition import PartitionMap

        resp = self._get(msg.PartitionMapRequest())
        return PartitionMap(
            version=resp.version,
            assignment=list(resp.assignment),
            ps_addrs={int(k): v for k, v in resp.ps_addrs.items()},
        )

    @retry()
    def register_ps(self, ps_id: int, addr: str):
        self._report(
            msg.PsRegisterRequest(node_id=ps_id, addr=addr)
        )

    def report_ps_stats(self, ps_id: int, qps: float,
                        cpu_percent: float, total_rows: int):
        try:
            self._client.report(msg.PsStatsReport(
                node_id=ps_id, qps=qps, cpu_percent=cpu_percent,
                total_rows=total_rows,
            ), wait_for_ready=False)
        except Exception:  # noqa: BLE001 - telemetry is best-effort
            pass

    def close(self):
        self._client.close()
