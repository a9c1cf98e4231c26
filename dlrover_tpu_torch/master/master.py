"""Job master assembly and lifecycle.

Parity: dlrover/python/master/dist_master.py:53 (DistributedJobMaster)
and local_master.py (LocalJobMaster). One ``JobMaster`` serves both
roles: in local/standalone mode it is spawned as a subprocess of the run
CLI on the rank-0 host; on a cluster it runs in its own pod.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.comm import RpcDispatcher, RpcServer
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.job_manager import JobManager, Scaler
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.metrics import (
    JobMetricCollector,
    LogReporter,
    RegistryReporter,
)
from dlrover_tpu_torch.master.rendezvous import (
    ElasticRendezvous,
    NetworkCheckRendezvous,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.task_manager import TaskManager

logger = get_logger("master")

METRICS_PORT_ENV = "DLROVER_TPU_METRICS_PORT"


class JobMaster:
    def __init__(
        self,
        port: int = 0,
        node_num: int = 1,
        min_nodes: int = 0,
        node_unit: int = 1,
        rdzv_timeout: float = 30.0,
        scaler: Optional[Scaler] = None,
        critical_workers: str = "",
        evaluator_count: int = 0,
        heartbeat_timeout: float = 180.0,
        monitor_interval: float = 30.0,
        job_name: str = "",
        metrics_port: Optional[int] = None,
        collect_interval: float = 60.0,
        state_dir: Optional[str] = None,
        brain=None,
        brain_db: Optional[str] = None,
        health_interval: Optional[float] = None,
        remediation_config: Optional[dict] = None,
        remediation_interval: Optional[float] = None,
        serving_config: Optional[dict] = None,
        job_id: str = "",
        dispatcher=None,
        trace_store=None,
        pool_grant: Optional[int] = None,
    ):
        """``node_num`` is the desired (max) world size; ``min_nodes``
        (default = node_num) is the smallest world the job may proceed
        with after losses — the elastic range of ``--nnodes min:max``.
        ``critical_workers`` ("", "all", "none", "0:3,5:1") marks
        workers whose permanent loss fails the job; ``evaluator_count``
        standalone evaluator nodes are scheduled at prepare().
        ``metrics_port`` (or DLROVER_TPU_METRICS_PORT; 0 = ephemeral)
        serves Prometheus text metrics at GET /metrics.
        ``state_dir`` (or DLROVER_TPU_STATE_DIR) enables master warm
        restart: recoverable state is journaled there as versioned
        JSON snapshots, and prepare() restores from the newest valid
        one so a master reschedule costs seconds, not the job.
        ``brain`` (any object with the BrainService persistence
        surface, e.g. a RemoteBrain) or ``brain_db`` (sqlite path, or
        DLROVER_TPU_BRAIN_DB; default in-memory) is the datastore the
        health plane persists runtime samples, fleet aggregates, and
        verdicts into; ``health_interval`` (or
        DLROVER_TPU_HEALTH_INTERVAL_S, default 15 s) is the detector
        evaluation cadence. ``remediation_config`` /
        ``remediation_interval`` parameterize the self-healing engine
        that acts on critical verdicts (docs/FAULT_TOLERANCE.md
        "Verdict-driven remediation"; DLROVER_TPU_REMEDIATION_* env
        knobs, DLROVER_TPU_REMEDIATION_DRY_RUN=1 to observe without
        acting).

        **Multi-job pool embedding** (docs/MULTI_JOB.md): ``job_id``
        names this master's job inside a pool; ``dispatcher`` (a
        per-job RpcDispatcher the pool's JobRoutingDispatcher routes
        ``_job``-tagged envelopes to) makes this master SHARE the
        pool's RPC server instead of owning one — its node table,
        rendezvous, shard ledger, and kv store stay per-job objects
        behind that routing key. ``trace_store`` shares the pool's
        TraceStore so every job's spans are queryable at the pool
        level; ``pool_grant`` caps this job's scalable node count at
        its pool grant (``JobManager.pool_grant``). All four default
        to the unchanged single-job behavior."""
        self.node_num = node_num
        self.job_id = job_id
        self.evaluator_count = evaluator_count
        self.job_manager = JobManager(
            scaler=scaler,
            critical_workers=critical_workers,
            heartbeat_timeout=heartbeat_timeout,
            monitor_interval=monitor_interval,
        )
        self.job_manager.pool_grant = pool_grant
        # Inside a pool, the job id is the natural job name default.
        job_name = job_name or job_id
        self.task_manager = TaskManager()
        self.speed_monitor = SpeedMonitor()
        self.kv_store = KVStoreService()
        from dlrover_tpu_torch.master.ps_manager import PsManager

        self.ps_manager = PsManager()
        # Fleet telemetry: goodput accountant + per-host snapshot
        # aggregator, rendered into the same registry the /metrics
        # endpoint and MetricsRequest RPC serve — and, new, recorded
        # as bounded HISTORY in the time-series store the health
        # detectors query windows over.
        from dlrover_tpu_torch.obs.fleet import FleetAggregator
        from dlrover_tpu_torch.obs.goodput import GoodputAccountant
        from dlrover_tpu_torch.obs.timeseries import TimeSeriesStore
        from dlrover_tpu_torch.obs.trace_store import TraceStore

        self.timeseries = TimeSeriesStore()
        self.goodput = GoodputAccountant(timeseries=self.timeseries)
        # Distributed-trace assembly (bounded, ring-retained like the
        # request ledger): in-master planes feed it directly; trace-
        # tagged events in agent snapshots arrive via the fleet
        # aggregator. Read via TraceQueryRequest / obs_report --trace.
        # A pool-embedded master shares the pool's store, so pool
        # lifecycle spans and this job's rendezvous/serving spans
        # assemble into the same queryable timelines.
        self.traces = (
            trace_store if trace_store is not None else TraceStore()
        )
        self.fleet = FleetAggregator(
            speed_monitor=self.speed_monitor,
            goodput=self.goodput,
            timeseries=self.timeseries,
            trace_store=self.traces,
        )
        self.speed_monitor.timeseries = self.timeseries
        self.elastic_rdzv = ElasticRendezvous()
        self.check_rdzv = NetworkCheckRendezvous()
        for rdzv in (self.elastic_rdzv, self.check_rdzv):
            rdzv.update_params(
                min_nodes=min_nodes if min_nodes > 0 else node_num,
                max_nodes=node_num,
                waiting_timeout=rdzv_timeout,
                node_unit=node_unit,
            )
        self.servicer = MasterServicer(
            job_manager=self.job_manager,
            task_manager=self.task_manager,
            elastic_rdzv=self.elastic_rdzv,
            check_rdzv=self.check_rdzv,
            kv_store=self.kv_store,
            speed_monitor=self.speed_monitor,
            ps_manager=self.ps_manager,
            fleet=self.fleet,
        )
        # Serving plane: the traffic router replicas pull work from.
        # Always constructed (stdlib-only, idle until a replica
        # registers); ``serving_config`` tunes SLOs/watchdogs, env
        # DLROVER_TPU_SERVE_* otherwise (docs/SERVING.md).
        from dlrover_tpu_torch.serving.router import ServingRouter

        self.serving = ServingRouter(
            job_manager=self.job_manager,
            config=serving_config,
            job_name=(
                job_name
                or os.getenv("DLROVER_TPU_JOB_NAME", "default")
            ),
            trace_sink=self.traces,
        )
        self.servicer.serving = self.serving
        self.servicer.traces = self.traces
        # Rendezvous rounds are traces too: each round's start ->
        # complete interval lands in the store as one rdzv.round span.
        self.elastic_rdzv.trace_sink = self.traces
        self.check_rdzv.trace_sink = self.traces
        # Brain datastore: where the health plane persists runtime
        # samples, fleet aggregates + goodput ratio, and verdicts —
        # the same channel ROADMAP item 2's policy engine reads. An
        # injected `brain` (e.g. brain.server.RemoteBrain for a
        # standalone deployment) wins; else a local sqlite store
        # (DLROVER_TPU_BRAIN_DB path, default in-memory).
        if brain is None:
            from dlrover_tpu_torch.brain.service import BrainService

            if brain_db is None:
                brain_db = (
                    os.getenv("DLROVER_TPU_BRAIN_DB", "") or ":memory:"
                )
            brain = BrainService(brain_db)
        self.brain = brain
        # Health plane: detector engine over the time-series history,
        # queueing PROFILE/DIAGNOSE on critical verdicts through the
        # servicer's per-node action FIFO.
        from dlrover_tpu_torch.obs.health import HealthMonitor

        self.health = HealthMonitor(
            store=self.timeseries,
            speed_monitor=self.speed_monitor,
            job_manager=self.job_manager,
            fleet=self.fleet,
            goodput=self.goodput,
            action_sink=self.servicer.push_action,
            serving=self.serving,
            brain=self.brain,
            job_name=(
                job_name
                or os.getenv("DLROVER_TPU_JOB_NAME", "default")
            ),
            heartbeat_timeout=heartbeat_timeout,
            interval=health_interval,
        )
        self.servicer.health = self.health
        # Stall-localization plane: correlates the fleet's shipped
        # progress beacons on the health tick, localizes collective
        # stalls to one host, mints stall.incident traces, and queues
        # the coordinated all-host DIAGNOSE+PROFILE capture through
        # the same per-node action FIFO.
        from dlrover_tpu_torch.obs.stall import StallCorrelator

        self.stall = StallCorrelator(
            fleet=self.fleet,
            traces=self.traces,
            capture=self.servicer.push_action,
            diagnostics=self.servicer.recent_diagnostics,
        )
        self.health.attach_stall(self.stall)
        self.servicer.stall = self.stall
        # Remediation engine: acts on the health plane's critical
        # verdicts through the master's own seams (cordon-then-replace
        # via ScalePlan, restart_training via the heartbeat FIFO,
        # elastic shrink at the next rendezvous boundary), governed by
        # hysteresis / blast-radius / shared cooldowns / probation.
        from dlrover_tpu_torch.master.remediation import RemediationEngine

        self.remediation = RemediationEngine(
            health=self.health,
            job_manager=self.job_manager,
            servicer=self.servicer,
            fleet=self.fleet,
            store=self.timeseries,
            traces=self.traces,
            speed_monitor=self.speed_monitor,
            rdzv_managers=(self.elastic_rdzv, self.check_rdzv),
            serving=self.serving,
            brain=self.brain,
            min_nodes=min_nodes if min_nodes > 0 else node_num,
            job_name=(
                job_name
                or os.getenv("DLROVER_TPU_JOB_NAME", "default")
            ),
            config=remediation_config,
            interval=remediation_interval,
        )
        self.servicer.remediation = self.remediation
        # A freshly-scored straggler gets a fleet `diagnose` AND a
        # `profile`: its agent SIGUSR1s the training process for a
        # stack digest and asks the trainer for an N-step phase/MFU
        # capture while the host is still slow — verdicts become
        # diagnosable AND measurable, not just flagged.
        self.speed_monitor.on_straggler = self._on_straggler
        # PS-strategy auto-scaling starts on demand (sparse/CTR jobs):
        # master.start_ps_autoscaler() wires the hot-PS optimizer to
        # the registered PS fleet.
        self.ps_auto_scaler = None
        # Job-fact aggregation (runtime, node counts, speed, failures)
        # periodically logged AND mirrored into the obs registry the
        # Prometheus endpoint serves.
        self.metric_collector = JobMetricCollector(
            job_name or os.getenv("DLROVER_TPU_JOB_NAME", "default"),
            self.job_manager,
            self.speed_monitor,
            reporters=[LogReporter(), RegistryReporter()],
            interval=collect_interval,
        )
        if metrics_port is None:
            port_s = os.getenv(METRICS_PORT_ENV, "")
            metrics_port = int(port_s) if port_s else None
        self._metrics_port = metrics_port
        self.metrics_server = None
        if dispatcher is None:
            dispatcher = RpcDispatcher()
            self.servicer.register(dispatcher)
            self._server = RpcServer(dispatcher, port=port)
        else:
            # Pool embedding: register into the provided per-job
            # dispatcher; the pool's shared RpcServer owns the port
            # and routes `_job`-tagged envelopes here.
            self.servicer.register(dispatcher)
            self._server = None
        self._stopped = threading.Event()
        self._warm_restarted = False
        # Warm-restart journal: recoverable master state -> versioned
        # JSON snapshots under state_dir, written (debounced) on
        # state-changing events plus a low-frequency timer.
        from dlrover_tpu_torch.master.state_store import (
            STATE_DIR_ENV,
            MasterStateStore,
            StateJournal,
        )

        if state_dir is None:
            state_dir = os.getenv(STATE_DIR_ENV, "") or None
        self.state_dir = state_dir
        self.state_journal: Optional[StateJournal] = None
        if state_dir:
            self.state_journal = StateJournal(
                MasterStateStore(state_dir), self._collect_state
            )
            mark = self.state_journal.mark_dirty
            self.job_manager.add_listener(mark)
            self.task_manager.on_state_change = mark
            self.kv_store.on_change = mark
            self.elastic_rdzv.on_state_change = mark
            self.check_rdzv.on_state_change = mark
            # Verdict transitions and remediation decisions are
            # recoverable state too: without journaling them, a warm
            # restart re-fires a sticky verdict's action immediately
            # (the cooldown stamp died with the process) and forgets
            # in-flight cordons/probations.
            self.health.on_state_change = mark
            self.remediation.on_state_change = mark
            # The PS partition map survives a master bounce: the PS
            # fleet keeps serving it, so the restored master must
            # adopt rather than re-derive it (ps_manager snapshot).
            self.ps_manager.on_state_change = mark
            # Stream barriers flush the journal synchronously and
            # report the generation back to the trainer.
            self.servicer.state_journal = self.state_journal
        # Nodes can die without their agent ever reporting (pod
        # deleted, preemption, heartbeat timeout). The servicer's
        # failure-report path does this cleanup inline; DELETED events
        # from handle_node_gone / the watchdog must trigger the same
        # shard requeue + rendezvous removal (all idempotent).
        self.job_manager.add_listener(self._on_node_event)

    def _on_node_event(self, node, event_type: str) -> None:
        from dlrover_tpu_torch.common.constants import NodeEventType

        if event_type != NodeEventType.DELETED:
            return
        if node.type == NodeType.REPLICA:
            # A dead serving replica: its in-flight requests requeue
            # to the survivors (a kill costs latency, not requests).
            # Replicas never held shards, rendezvous membership, or
            # step accounting, so the training cleanup below does not
            # apply — and must not bounce the training fleet.
            self.serving.replica_gone(node.id)
            return
        self.task_manager.recover_node_tasks(node.id)
        self.speed_monitor.remove_running_node(node.id)
        # Departed node: its metric snapshot must leave the fleet view
        # now, not after the TTL; its loss is badput until the fleet
        # steps again.
        self.fleet.remove_node(node.id)
        self.goodput.add_events(
            [{"name": "node.gone", "ts": time.time(), "node_id": node.id}]
        )
        # Only training-world roles ever entered the rendezvous (the
        # register path skips evaluators and data workers, and PS
        # hosts register via their own RPC): removing one here would
        # evict the WORKER with the same rank from the waiting set —
        # and a dead DATA_WORKER must never restart the training
        # fleet; its only cleanup is the shard requeue above.
        if node.type not in (
            NodeType.EVALUATOR,
            NodeType.EMBEDDING,
            NodeType.DATA_WORKER,
        ):
            for rdzv in (self.elastic_rdzv, self.check_rdzv):
                rdzv.remove_alive_node(node.id, node_rank=node.rank)
            # A cordoned node already LEFT the training world when the
            # remediation engine benched it: retiring its pod now (the
            # cordon-then-replace finalization) must not bounce the
            # healthy fleet a second time.
            if getattr(node, "cordoned", False):
                return
            # Survivors must not block on collectives with the dead
            # peer until some long transport timeout: push a restart
            # so their next heartbeat sends them back to rendezvous,
            # which completes with the shrunken world (>= min_nodes).
            # (ref: torch elastic restarts the worker group on
            # membership change, elastic_agent/torch/training.py:564.)
            self.servicer.restart_peers(node.id)
        if node.type == NodeType.EMBEDDING:
            # A dead PS host (heartbeat timeout / cluster event): move
            # its partitions to the survivors now — clients are already
            # blocking on the stale map.
            from dlrover_tpu_torch.common.constants import node_ps_id

            self.ps_manager.remove_ps(node_ps_id(node.id))

    # -- warm restart --------------------------------------------------------

    def _collect_state(self) -> dict:
        """Everything a replacement master needs to carry the job on:
        node table, rendezvous round/world + waiters, shard ledger,
        kv-store contents (the JAX bootstrap keys), speed progress."""
        return {
            "job_manager": self.job_manager.to_snapshot(),
            "elastic_rdzv": self.elastic_rdzv.to_snapshot(),
            "check_rdzv": self.check_rdzv.to_snapshot(),
            "task_manager": self.task_manager.to_snapshot(),
            "kv_store": self.kv_store.to_snapshot(),
            "speed_monitor": self.speed_monitor.to_snapshot(),
            "health": self.health.to_snapshot(),
            "remediation": self.remediation.to_snapshot(),
            "ps_manager": self.ps_manager.to_snapshot(),
        }

    def _maybe_warm_restart(self) -> bool:
        """Restore from the newest valid snapshot, if any. Called
        from prepare() before any serving thread starts, so restore
        never races live RPCs."""
        if self.state_journal is None:
            return False
        doc = self.state_journal.store.load_latest()
        if doc is None:
            return False
        state = doc["state"]
        try:
            self.job_manager.restore_snapshot(
                state.get("job_manager", {})
            )
            self.elastic_rdzv.restore_snapshot(
                state.get("elastic_rdzv", {})
            )
            self.check_rdzv.restore_snapshot(
                state.get("check_rdzv", {})
            )
            self.task_manager.restore_snapshot(
                state.get("task_manager", {})
            )
            self.kv_store.restore_snapshot(state.get("kv_store", {}))
            self.speed_monitor.restore_snapshot(
                state.get("speed_monitor", {})
            )
            self.health.restore_snapshot(state.get("health", {}))
            self.remediation.restore_snapshot(
                state.get("remediation", {})
            )
            self.ps_manager.restore_snapshot(
                state.get("ps_manager", {})
            )
        except Exception:  # noqa: BLE001 — a corrupt-but-parseable
            # snapshot must degrade to a cold start, not a crash loop
            logger.exception(
                "warm restart from %s failed; starting cold",
                doc.get("path"),
            )
            # All-or-nothing: components restored before the failure
            # must not survive into the "cold" start — a node table
            # without its kv bootstrap keys (or rendezvous round
            # without its ledger) is a state agents can't reason
            # about. Empty snapshots reset each component.
            self.job_manager.restore_snapshot({})
            self.elastic_rdzv.restore_snapshot({})
            self.check_rdzv.restore_snapshot({})
            self.task_manager.reset()
            self.kv_store.restore_snapshot({})
            self.speed_monitor.restore_snapshot({})
            self.health.restore_snapshot({})
            self.remediation.restore_snapshot({})
            self.ps_manager.restore_snapshot({})
            return False
        age_s = max(time.time() - float(doc.get("saved_at", 0.0)), 0.0)
        alive = len(self.job_manager.alive_nodes())
        datasets = len(state.get("task_manager", {}).get("datasets", {}))
        logger.warning(
            "master WARM RESTART from %s (snapshot age %.1fs): "
            "%d alive nodes, %d datasets, rendezvous round %d",
            doc.get("path"), age_s, alive, datasets,
            self.elastic_rdzv.round,
        )
        import dlrover_tpu_torch.obs as obs

        # The recovery-timeline anchor for master-death drills: the
        # outage's downtime is (this event's ts - kill time), and the
        # goodput accountant books the gap as recovery via the same
        # stream.
        obs.event(
            "master.warm_restart",
            snapshot_age_s=round(age_s, 3),
            snapshot_path=str(doc.get("path")),
            alive_nodes=alive,
            datasets=datasets,
            rdzv_round=self.elastic_rdzv.round,
        )
        self.goodput.add_events(
            [{"name": "master.warm_restart", "ts": time.time()}]
        )
        return True

    @property
    def warm_restarted(self) -> bool:
        return self._warm_restarted

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError(
                "pool-embedded master has no own server; use the "
                "pool master's port"
            )
        return self._server.port

    @property
    def addr(self) -> str:
        if self._server is None:
            raise RuntimeError(
                "pool-embedded master has no own server; use the "
                "pool master's addr"
            )
        return self._server.addr

    def _on_straggler(self, node_id: int) -> None:
        """Fresh straggler verdict: snapshot its stacks (diagnose)
        and measure where its step time goes (profile)."""
        self.servicer.diagnose_node(node_id)
        self.servicer.profile_node(node_id)

    def prepare(self) -> None:
        # Restore BEFORE the server accepts its first RPC: agents
        # must never observe a half-restored ledger.
        self._warm_restarted = self._maybe_warm_restart()
        if self._server is not None:
            self._server.start()
        self.job_manager.start()
        self.task_manager.start()
        self.metric_collector.start()
        if self.state_journal is not None:
            self.state_journal.start()
        self.health.start()
        self.remediation.start()
        # Serving autoscale/SLO loop: no-ops until the serving plane
        # has ever seen a replica or request.
        self.serving.start()
        if self._metrics_port is not None:
            from dlrover_tpu_torch.obs.exposition import MetricsHTTPServer

            self.metrics_server = MetricsHTTPServer(
                port=self._metrics_port,
                health=self.health.healthz_payload,
            )
            self.metrics_server.start()
        # Any job may register PS hosts (sparse path); their liveness
        # probing must not depend on --ps_autoscale. A dead PS is
        # failed over in ~10 s — well inside the sparse client's
        # stale-map retry budget — vs the 180 s node-heartbeat timeout.
        # No-op while no PS is registered. Drills shrink detection
        # latency via the env knobs (stream_soak runs whole kill
        # cycles in seconds).
        self.ps_manager.start_liveness_monitor(
            interval=float(
                os.getenv("DLROVER_TPU_PS_LIVENESS_INTERVAL", "2.0")
            ),
            ping_timeout=float(
                os.getenv("DLROVER_TPU_PS_LIVENESS_TIMEOUT", "3.0")
            ),
        )
        if self.evaluator_count > 0:
            self.job_manager.ensure_role(
                NodeType.EVALUATOR, self.evaluator_count
            )

    def start_ps_autoscaler(self, interval: float = 30.0) -> None:
        """Enable PS-strategy auto-scaling (hot-PS migration + worker
        adjustment) for sparse/CTR jobs. Parity:
        dlrover/python/master/node/job_auto_scaler.py:136
        start_auto_scaling."""
        if self.ps_auto_scaler is None:
            from dlrover_tpu_torch.master.auto_scaler import (
                PsTrainingAutoScaler,
            )

            self.ps_auto_scaler = PsTrainingAutoScaler(
                self.job_manager,
                self.speed_monitor,
                self.ps_manager,
                interval=interval,
            )
            self.ps_auto_scaler.start()

    def run(self, poll_interval: float = 2.0) -> int:
        """Block until the job completes; returns an exit code."""
        try:
            while not self._stopped.wait(poll_interval):
                if self.job_manager.job_failed():
                    reason, detail = self.job_manager.job_failure
                    logger.error(
                        "job failed (%s): %s; master exiting",
                        reason,
                        detail,
                    )
                    # Reclaim the rest of the fleet — without this the
                    # surviving pods keep training against a dead
                    # master until they individually time out.
                    self.job_manager.terminate_job()
                    return 1
                if self.job_manager.all_workers_done():
                    logger.info("all workers finished; master exiting")
                    # Evaluators follow the training fleet: retire any
                    # still-alive ones instead of leaving them orphaned.
                    self.job_manager.retire_role(NodeType.EVALUATOR)
                    return 0
        except KeyboardInterrupt:
            return 1
        return 0

    def stop(self) -> None:
        self._stopped.set()
        if self.state_journal is not None:
            # Final flush first: a clean stop leaves the freshest
            # possible snapshot for the next incarnation.
            self.state_journal.stop(final_flush=True)
        if self.ps_auto_scaler is not None:
            self.ps_auto_scaler.stop()
        self.ps_manager.stop_liveness_monitor()
        self.serving.stop()
        self.remediation.stop()
        self.health.stop()
        self.task_manager.stop()
        self.job_manager.stop()
        # stop() joins the collector thread: after this returns no
        # late snapshot can race the server teardown below.
        self.metric_collector.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        # Unhook the fleet collector from the (process-global)
        # registry so a stopped master stops contributing lines.
        self.fleet.close()
        if self._server is not None:
            self._server.stop(0)


def run_master(
    port: int = 0,
    node_num: int = 1,
    node_unit: int = 1,
    rdzv_timeout: float = 30.0,
) -> JobMaster:
    master = JobMaster(
        port=port,
        node_num=node_num,
        node_unit=node_unit,
        rdzv_timeout=rdzv_timeout,
    )
    master.prepare()
    return master
