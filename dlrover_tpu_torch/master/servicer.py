"""Master RPC servicer: binds typed messages to master components.

Parity: dlrover/python/master/servicer.py:62 (MasterServicer.get/report
dispatch), rebuilt on the typed dispatcher of common/comm.py.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import RpcDispatcher
from dlrover_tpu_torch.common.constants import EventAction, RendezvousName
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.rendezvous import (
    ElasticRendezvous,
    NetworkCheckRendezvous,
)
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.task_manager import TaskManager

logger = get_logger("servicer")

_FORENSICS_TOTAL = obs.counter(
    "dlrover_forensics_bundles_total",
    "Forensics bundles reported to the master, by node and kind "
    "(hang / crash / diagnose)",
    ("node", "kind"),
)

_STREAM_BARRIERS = obs.counter(
    "dlrover_stream_barriers_total",
    "Stream barriers committed (coordinated PS flush + durable "
    "ledger record), by dataset",
    ("dataset",),
)
_STREAM_BARRIER_SECONDS = obs.histogram(
    "dlrover_stream_barrier_seconds",
    "Wall time of one stream barrier: PS fleet flush + urgent "
    "journal write",
)
_STREAM_WATERMARK = obs.gauge(
    "dlrover_stream_watermark_records",
    "Contiguously-applied record count at the last stream barrier, "
    "by dataset",
    ("dataset",),
)

# Bounded per-node queues: how many pushed-but-undelivered actions a
# node may accumulate, and how many diagnostics digests the master
# retains per node.
MAX_PENDING_ACTIONS = 16
DIAGNOSTICS_HISTORY = 8
MAX_STORED_DIGEST = 16384
# How many consumed push_action dedupe keys the servicer remembers: a
# replayed remediation push (RPC retry, engine re-fire after a warm
# restart) carrying a key already consumed is a no-op even after the
# original action was delivered — a replayed RESTART_TRAINING must
# not double-bounce a trainer.
MAX_DEDUPE_KEYS = 512
# Server-side cap on traces returned by one non-id TraceQueryRequest
# (each trace can carry up to max_spans_per_trace spans — an
# unbounded listing would approach the gRPC message cap).
MAX_TRACE_QUERY = 64


class MasterServicer:
    def __init__(
        self,
        job_manager: JobManager,
        task_manager: TaskManager,
        elastic_rdzv: ElasticRendezvous,
        check_rdzv: NetworkCheckRendezvous,
        kv_store: Optional[KVStoreService] = None,
        speed_monitor: Optional[SpeedMonitor] = None,
        ps_manager=None,
        fleet=None,
        health=None,
    ):
        self.job_manager = job_manager
        self.task_manager = task_manager
        self.rdzv_managers = {
            RendezvousName.TRAINING: elastic_rdzv,
            RendezvousName.NETWORK_CHECK: check_rdzv,
        }
        self.kv_store = kv_store or KVStoreService()
        self.speed_monitor = speed_monitor or SpeedMonitor()
        # PS-elastic sparse path (ref master/node/ps.py); created
        # lazily so dense-only jobs pay nothing.
        if ps_manager is None:
            from dlrover_tpu_torch.master.ps_manager import PsManager

            ps_manager = PsManager()
        self.ps_manager = ps_manager
        # Fleet telemetry: merges per-host metric snapshots into the
        # master registry (host labels + cross-host aggregates). The
        # JobMaster passes its (render-attached) aggregator and closes
        # it on stop; a bare servicer (tests, embedded use) has no
        # stop hook, so its default stays DETACHED from the global
        # registry's render — snapshots still feed the speed monitor
        # and straggler verdicts.
        if fleet is None:
            from dlrover_tpu_torch.obs.fleet import FleetAggregator

            fleet = FleetAggregator(
                speed_monitor=self.speed_monitor, attach=False
            )
        self.fleet = fleet
        # Health plane: the detector engine whose verdict history the
        # HealthQueryRequest RPC serves. None on a bare servicer
        # (tests, embedded use) — queries then answer "healthy, no
        # verdicts" rather than failing.
        self.health = health
        # Actions queued for agents: a bounded per-node FIFO drained
        # one action per heartbeat. (A plain node_id -> action dict
        # silently dropped the first action when a second was pushed
        # before the next heartbeat — e.g. a restart_training
        # overwritten by a diagnose.)
        self._actions_lock = threading.Lock()
        self._pending_actions: Dict[int, Deque[str]] = {}
        # Consumed push dedupe keys (bounded FIFO of remembered keys):
        # idempotence for remediation pushes per (action, node) —
        # same contract PROFILE/DIAGNOSE get from the in-queue dedupe,
        # extended past delivery.
        self._dedupe_keys: Deque[str] = collections.deque(
            maxlen=MAX_DEDUPE_KEYS
        )
        self._dedupe_key_set: set = set()
        # Remediation engine (set by the JobMaster); None on a bare
        # servicer — queries then answer "disabled, no decisions".
        self.remediation = None
        # Serving router (set by the JobMaster); None on a bare
        # servicer — serve RPCs then answer "serving disabled".
        self.serving = None
        # Trace store (set by the JobMaster); None on a bare servicer
        # — trace queries then answer "tracing disabled".
        self.traces = None
        # Warm-restart journal (set by the JobMaster when state_dir is
        # configured); None on a bare servicer — stream barriers then
        # still flush the PS fleet but answer durable=False.
        self.state_journal = None
        # Stall correlator (set by the JobMaster); None on a bare
        # servicer — stall queries then answer "plane disabled".
        self.stall = None
        # Per-node forensics history (DiagnosticsReport digests),
        # bounded so a crash-looping node cannot grow master memory.
        # Locked: report and query arrive on different RPC worker
        # threads (iterating a deque while another thread appends
        # raises RuntimeError).
        self._diagnostics_lock = threading.Lock()
        self._diagnostics: Dict[int, Deque[msg.DiagnosticsReport]] = {}
        # auto-tuner output pulled by agents (ref: master-pushed
        # ParallelConfig, elastic_agent/config/paral_config_tuner.py)
        self.parallel_config = msg.ParallelConfig()

    def _rdzv(self, name: str):
        mgr = self.rdzv_managers.get(name or RendezvousName.TRAINING)
        if mgr is None:
            raise KeyError(f"unknown rendezvous {name!r}")
        return mgr

    # -- registration -------------------------------------------------------

    def register(self, dispatcher: RpcDispatcher) -> None:
        g = dispatcher.register_get
        r = dispatcher.register_report

        g(msg.JoinRendezvousRequest, self._join_rendezvous)
        g(msg.CommWorldRequest, self._get_comm_world)
        g(msg.WaitingNodeNumRequest, self._num_nodes_waiting)
        g(msg.NetworkCheckQueryRequest, self._query_network_check)
        g(msg.KVStoreGetRequest, self._kv_get)
        g(msg.KVStoreAddRequest, self._kv_add)
        g(msg.TaskRequest, self._get_task)
        g(msg.ShardCheckpointRequest, self._get_shard_checkpoint)
        g(msg.JobNodesRequest, self._get_job_nodes)
        g(msg.ParallelConfigRequest, self._get_parallel_config)
        g(msg.MetricsRequest, self._get_metrics)
        g(msg.DiagnosticsQueryRequest, self._query_diagnostics)
        g(msg.HealthQueryRequest, self._query_health)
        g(msg.StallQueryRequest, self._query_stall)
        g(msg.RemediationQueryRequest, self._query_remediation)
        g(msg.TraceQueryRequest, self._query_traces)
        g(msg.ServeSubmitRequest, self._serve_submit)
        g(msg.ServeResultRequest, self._serve_result)
        g(msg.ServePullRequest, self._serve_pull)
        g(msg.ServeQueryRequest, self._serve_query)
        r(msg.ServeCompletedReport, self._serve_complete)
        r(msg.ServeStatsReport, self._serve_stats)

        r(msg.KVStoreSetRequest, self._kv_set)
        r(msg.DatasetShardParams, self._create_dataset)
        r(msg.TaskResultRequest, self._report_task_result)
        r(msg.NetworkCheckResultRequest, self._report_network_result)
        r(msg.StepReport, self._report_step)
        r(msg.ResourceStats, self._report_resource)
        r(msg.MetricsSnapshotReport, self._report_metrics_snapshot)
        r(msg.DiagnosticsReport, self._report_diagnostics)
        r(msg.ProfileActionRequest, self._profile_node_req)
        r(msg.NodeFailureReport, self._report_failure)
        r(msg.NodeSucceededReport, self._report_succeeded)
        r(msg.HeartbeatRequest, self._heartbeat)
        r(msg.NodeAddressRequest, self._register_node)
        r(msg.RestoreShardRequest, self._restore_shards)

        g(msg.PartitionMapRequest, self._get_partition_map)
        r(msg.PsRegisterRequest, self._register_ps)
        r(msg.PsStatsReport, self._report_ps_stats)

        g(msg.StreamBarrierRequest, self._stream_barrier)
        g(msg.StreamBarrierQueryRequest, self._query_stream_barrier)

    def _noop(self, req):
        return None

    # -- rendezvous ---------------------------------------------------------

    def _join_rendezvous(self, req: msg.JoinRendezvousRequest):
        if self._cordoned_now(req.node_id):
            # The benched agent raced its CORDON delivery into a
            # rejoin (mirror of the restart_training TOCTOU in
            # _heartbeat): admitting it would form a world around a
            # host about to park its trainer mid-collective. Refuse
            # the join and re-assert the cordon on its next heartbeat.
            self.push_action(req.node_id, EventAction.CORDON.value)
            return msg.JoinRendezvousResponse(round=-1)
        mgr = self._rdzv(req.rdzv_name)
        round_ = mgr.join(req.node_rank, req.local_world_size)
        return msg.JoinRendezvousResponse(round=round_)

    def _get_comm_world(self, req: msg.CommWorldRequest):
        mgr = self._rdzv(req.rdzv_name)
        rank = req.node_rank if req.node_rank >= 0 else req.node_id
        round_, group, world = mgr.get_comm_world(rank)
        return msg.CommWorldResponse(
            rdzv_name=req.rdzv_name, round=round_, group=group, world=world
        )

    def _num_nodes_waiting(self, req: msg.WaitingNodeNumRequest):
        mgr = self._rdzv(req.rdzv_name)
        return msg.WaitingNodeNumResponse(waiting_num=mgr.num_nodes_waiting())

    def _report_network_result(self, req: msg.NetworkCheckResultRequest):
        mgr = self.rdzv_managers[RendezvousName.NETWORK_CHECK]
        mgr.report_result(req.node_id, req.normal, req.elapsed_time)
        return None

    def _query_network_check(self, req: msg.NetworkCheckQueryRequest):
        mgr = self.rdzv_managers[RendezvousName.NETWORK_CHECK]
        if req.kind == "straggler":
            nodes, reason = mgr.get_stragglers()
            # The check-time verdict only sees the pre-training
            # benchmark; the speed monitor scores live step times, so
            # a node that slowed down mid-run still surfaces here.
            # The check rendezvous speaks RANKS while the speed
            # monitor is keyed by node id — translate before the
            # union, or a relaunched node's id could flag whichever
            # healthy agent happens to hold that rank.
            slow = []
            for nid in self.speed_monitor.stragglers():
                node = self.job_manager.get_node(nid)
                slow.append(
                    node.rank
                    if node is not None and node.rank >= 0
                    else nid
                )
            if slow:
                nodes = sorted(set(nodes) | set(slow))
                if reason == "waiting":
                    reason = ""
        else:
            nodes, reason = mgr.check_fault_nodes()
        return msg.NetworkCheckQueryResponse(nodes=nodes, reason=reason)

    # -- kv store -----------------------------------------------------------

    def _kv_get(self, req: msg.KVStoreGetRequest):
        found = self.kv_store.has(req.key)
        return msg.KVStoreGetResponse(
            found=found, value=self.kv_store.get(req.key)
        )

    def _kv_set(self, req: msg.KVStoreSetRequest):
        self.kv_store.set(req.key, req.value)
        return None

    def _kv_add(self, req: msg.KVStoreAddRequest):
        return msg.KVStoreAddResponse(
            value=self.kv_store.add(req.key, req.amount)
        )

    # -- data sharding ------------------------------------------------------

    def _create_dataset(self, req: msg.DatasetShardParams):
        shard_size = req.batch_size * req.num_minibatches_per_shard
        self.task_manager.create_dataset(
            dataset_name=req.dataset_name,
            dataset_size=req.dataset_size,
            shard_size=max(shard_size, 1),
            num_epochs=req.num_epochs,
            shuffle=req.shuffle,
            storage_type=req.storage_type or "table",
            task_type=req.task_type or "training",
            num_stream_partitions=max(req.num_stream_partitions, 1),
        )
        return None

    def _get_task(self, req: msg.TaskRequest):
        task = self.task_manager.get_task(req.node_id, req.dataset_name)
        shard = None
        if task.shard is not None:
            shard = msg.Shard(
                name=task.shard.name,
                start=task.shard.start,
                end=task.shard.end,
                record_indices=task.shard.record_indices or [],
                partition=task.shard.partition,
            )
        return msg.Task(
            task_id=task.task_id, task_type=task.task_type, shard=shard
        )

    # -- stream barriers ----------------------------------------------------

    def _stream_barrier(self, req: msg.StreamBarrierRequest):
        """One barrier = one atomic cut across all three planes: the
        trainer has quiesced its applies before calling; here the
        ledger frontier is read, the PS fleet delta-flushes stamped
        with (epoch, HWM), and the barrier record lands in the warm-
        restart journal with an urgent synchronous flush. Only after
        the journal write returns is the barrier acknowledged durable
        — a master or PS death at any point either replays to the
        previous cut or to this one, never between."""
        t0 = time.monotonic()
        with obs.span(
            "stream.barrier",
            dataset=req.dataset_name,
            epoch=req.epoch,
            step=req.step,
        ):
            frontier = self.task_manager.ledger_watermarks(
                req.dataset_name
            )
            hwm = {
                str(p): int(w)
                for p, w in frontier["watermarks"].items()
            }
            flushed = self.ps_manager.flush_all(
                req.step, epoch=req.epoch, hwm=hwm
            )
            flush_gen = 0
            durable = False
            if self.state_journal is not None:
                record = self.task_manager.record_barrier(
                    req.dataset_name, req.epoch, req.step,
                    flushed_rows=flushed,
                )
                path = self.state_journal.flush()
                if path:
                    durable = True
                    # master_state-<seq>.json: seq is the generation.
                    try:
                        flush_gen = int(
                            path.rsplit("-", 1)[1].split(".")[0]
                        )
                    except (IndexError, ValueError):
                        flush_gen = 0
                    record["flush_gen"] = flush_gen
                    self.task_manager.record_barrier(
                        req.dataset_name, req.epoch, req.step,
                        flush_gen=flush_gen, flushed_rows=flushed,
                    )
            else:
                self.task_manager.record_barrier(
                    req.dataset_name, req.epoch, req.step,
                    flushed_rows=flushed,
                )
        _STREAM_BARRIERS.inc(dataset=req.dataset_name)
        _STREAM_BARRIER_SECONDS.observe(time.monotonic() - t0)
        _STREAM_WATERMARK.set(
            frontier["records"], dataset=req.dataset_name
        )
        return msg.StreamBarrierResponse(
            dataset_name=req.dataset_name,
            epoch=req.epoch,
            step=req.step,
            offsets={
                int(p): int(o) for p, o in frontier["offsets"].items()
            },
            watermarks={
                int(p): int(w)
                for p, w in frontier["watermarks"].items()
            },
            flush_gen=flush_gen,
            flushed_rows=flushed,
            durable=durable,
        )

    def _query_stream_barrier(self, req: msg.StreamBarrierQueryRequest):
        """Last durable barrier cut (what a restarted trainer resumes
        from)."""
        rec = self.task_manager.last_barrier(req.dataset_name)
        if rec is None:
            return msg.StreamBarrierResponse(
                dataset_name=req.dataset_name
            )
        return msg.StreamBarrierResponse(
            dataset_name=req.dataset_name,
            epoch=int(rec.get("epoch", -1)),
            step=int(rec.get("step", 0)),
            offsets={
                int(p): int(o)
                for p, o in rec.get("offsets", {}).items()
            },
            watermarks={
                int(p): int(w)
                for p, w in rec.get("watermarks", {}).items()
            },
            flush_gen=int(rec.get("flush_gen", 0)),
            flushed_rows=int(rec.get("flushed_rows", 0)),
            durable=bool(rec.get("flush_gen", 0)),
        )

    def _report_task_result(self, req: msg.TaskResultRequest):
        # node_id makes the report idempotent against replays: after
        # an agent reconnect, a retried result for a shard the master
        # already re-queued to another node must not act.
        self.task_manager.report_task_result(
            req.dataset_name, req.task_id, req.success,
            node_id=req.node_id,
        )
        return None

    def _get_shard_checkpoint(self, req: msg.ShardCheckpointRequest):
        content = self.task_manager.get_shard_checkpoint(req.dataset_name)
        return msg.ShardCheckpointResponse(content=content)

    def _restore_shards(self, req: msg.RestoreShardRequest):
        self.task_manager.restore_shard_checkpoint(
            req.dataset_name, req.content
        )
        return None

    # -- monitoring ---------------------------------------------------------

    def _report_step(self, req: msg.StepReport):
        ts = req.timestamp or time.time()
        self.speed_monitor.collect_global_step(req.step, ts, req.tokens)
        if req.node_id >= 0:
            self.speed_monitor.collect_node_step(
                req.node_id, req.step, timestamp=ts
            )
        # Mirror the step into the goodput stream: this is how
        # productive time (and recovery closure) is accounted even
        # when host-side tracing is off and snapshots carry no events.
        if self.fleet.goodput is not None:
            self.fleet.goodput.add_events(
                [{"name": "trainer.step", "ts": ts,
                  "step": req.step, "node_id": req.node_id}]
            )
        return None

    def _report_metrics_snapshot(self, req: msg.MetricsSnapshotReport):
        self.fleet.ingest(req)
        return None

    def _report_resource(self, req: msg.ResourceStats):
        node = self.job_manager.get_node(req.node_id)
        if node is not None:
            node.config_resource.used_cpu = req.cpu_percent
            node.config_resource.used_memory_mb = req.memory_mb
            node.config_resource.hbm_used_gb = req.hbm_used_gb
            node.config_resource.duty_cycle = req.duty_cycle
        return None

    def _report_failure(self, req: msg.NodeFailureReport):
        node = self.job_manager.get_node(req.node_id)
        rank = node.rank if node is not None else req.node_id
        if req.diagnostics:
            # Attached forensics digest: surfaced in the master log +
            # trace (the bounded history is fed by the agent's
            # companion DiagnosticsReport), kept OUT of the exit
            # classifier's error_data.
            obs.event(
                "node.failure_diagnostics",
                node_id=req.node_id,
                size=len(req.diagnostics),
            )
            logger.info(
                "failure diagnostics from node %d:\n%s",
                req.node_id,
                req.diagnostics[:MAX_STORED_DIGEST],
            )
        action = self.job_manager.handle_failure_report(
            req.node_id,
            req.error_data,
            req.level,
            req.restart_count,
            fatal=req.fatal,
        )
        self.task_manager.recover_node_tasks(req.node_id)
        self.speed_monitor.remove_running_node(req.node_id)
        for mgr in self.rdzv_managers.values():
            mgr.remove_alive_node(req.node_id, node_rank=rank)
        # The failure opens a recovery interval in the goodput
        # accounting; the matching trainer.first_step_done arrives in
        # a later agent snapshot's event payload.
        if self.fleet.goodput is not None:
            self.fleet.goodput.add_events(
                [{
                    "name": "node.fail",
                    "ts": time.time(),
                    "node_id": req.node_id,
                }]
            )
        return msg.NodeFailureResponse(action=action)

    def _report_succeeded(self, req: msg.NodeSucceededReport):
        self.job_manager.handle_node_succeeded(req.node_id)
        self.speed_monitor.remove_running_node(req.node_id)
        return None

    def _heartbeat(self, req: msg.HeartbeatRequest):
        self.job_manager.update_heartbeat(req.node_id)
        action = EventAction.NONE.value
        with self._actions_lock:
            queue = self._pending_actions.get(req.node_id)
            while queue:
                action = queue.popleft()
                if (
                    action == EventAction.RESTART_TRAINING.value
                    and self._cordoned_now(req.node_id)
                ):
                    # A restart that RACED the cordon (the peer
                    # broadcast snapshots the worker list before the
                    # remediation thread flips the flag): the agent
                    # overloads RESTART_TRAINING as un-cordon, so
                    # delivering it would silently put the benched
                    # host back into the world. Re-checking at
                    # delivery time closes the TOCTOU; the rollback
                    # path clears the flag BEFORE pushing its un-park
                    # restart, so a legitimate un-cordon is never
                    # dropped here.
                    logger.warning(
                        "dropping stale restart_training for "
                        "cordoned node %d", req.node_id,
                    )
                    action = EventAction.NONE.value
                    continue
                break
            if queue is not None and not queue:
                self._pending_actions.pop(req.node_id, None)
        return msg.HeartbeatResponse(action=action)

    def _cordoned_now(self, node_id: int) -> bool:
        node = self.job_manager.get_node(node_id)
        return node is not None and getattr(node, "cordoned", False)

    def push_action(
        self, node_id: int, action: str, dedupe_key: Optional[str] = None
    ) -> bool:
        """Queue an action for the node's next heartbeats (FIFO, one
        per heartbeat). Control actions are idempotent, so an action
        already queued is not queued again (two node deaths in one
        monitor tick mean ONE restart_training per survivor, exactly
        as the old last-write-wins dict behaved — without it being
        able to silently swallow a DIFFERENT action). Bounded: when a
        node stops heartbeating, the oldest action is dropped (with a
        warning) rather than growing the queue forever.

        ``dedupe_key``: an idempotency token for pushes that may be
        REPLAYED (remediation decisions, retried operator RPCs). The
        first push consumes the key; any later push carrying the same
        key is a no-op even after the original action was delivered,
        so a replayed restart_training cannot double-bounce a trainer
        the way the in-queue dedupe alone could not prevent. Returns
        True when the action was actually enqueued."""
        with self._actions_lock:
            if dedupe_key is not None:
                if dedupe_key in self._dedupe_key_set:
                    return False
                if len(self._dedupe_keys) >= MAX_DEDUPE_KEYS:
                    self._dedupe_key_set.discard(self._dedupe_keys[0])
                self._dedupe_keys.append(dedupe_key)
                self._dedupe_key_set.add(dedupe_key)
            queue = self._pending_actions.setdefault(
                node_id, collections.deque()
            )
            if action in queue:
                return False
            if len(queue) >= MAX_PENDING_ACTIONS:
                dropped = queue.popleft()
                logger.warning(
                    "node %d action queue full (%d); dropping oldest "
                    "action %r to enqueue %r",
                    node_id, MAX_PENDING_ACTIONS, dropped, action,
                )
            queue.append(action)
            return True

    def restart_peers(
        self,
        exclude_id: int,
        dedupe_prefix: Optional[str] = None,
    ) -> None:
        """Push RESTART_TRAINING to every alive training peer of a
        departed/benched node so survivors re-rendezvous instead of
        blocking on collectives with it. The ONE broadcast loop —
        master node-death handling and the remediation engine both
        route here. Cordoned peers are deliberately skipped: their
        agents overload RESTART_TRAINING as the un-cordon signal, so
        a broadcast reaching one would silently put the benched host
        back into the world."""
        for peer in self.job_manager.alive_workers(include_chief=True):
            if peer.id != exclude_id:
                self.push_action(
                    peer.id,
                    EventAction.RESTART_TRAINING.value,
                    dedupe_key=(
                        f"{dedupe_prefix}:peer{peer.id}"
                        if dedupe_prefix
                        else None
                    ),
                )

    def pending_actions(self, node_id: int) -> list:
        """Undelivered actions for a node (observability/tests)."""
        with self._actions_lock:
            return list(self._pending_actions.get(node_id, ()))

    # -- forensics / diagnostics -------------------------------------------

    def _report_diagnostics(self, req: msg.DiagnosticsReport):
        record = msg.DiagnosticsReport(
            node_id=req.node_id,
            kind=req.kind or "unknown",
            bundle_path=req.bundle_path,
            digest=(req.digest or "")[:MAX_STORED_DIGEST],
            timestamp=req.timestamp or time.time(),
        )
        with self._diagnostics_lock:
            history = self._diagnostics.setdefault(
                req.node_id,
                collections.deque(maxlen=DIAGNOSTICS_HISTORY),
            )
            history.append(record)
        _FORENSICS_TOTAL.inc(node=str(req.node_id), kind=record.kind)
        obs.event(
            "node.diagnostics",
            node_id=req.node_id,
            kind=record.kind,
            bundle_path=record.bundle_path,
        )
        logger.info(
            "forensics from node %d (%s): bundle=%s digest=%d bytes",
            req.node_id, record.kind, record.bundle_path or "-",
            len(record.digest),
        )
        return None

    def _query_diagnostics(self, req: msg.DiagnosticsQueryRequest):
        with self._diagnostics_lock:
            if req.node_id >= 0:
                reports = list(
                    self._diagnostics.get(req.node_id, ())
                )
            else:
                reports = [
                    r
                    for node_id in sorted(self._diagnostics)
                    for r in self._diagnostics[node_id]
                ]
        return msg.DiagnosticsQueryResponse(reports=reports)

    @staticmethod
    def _verdict_msg(v) -> msg.HealthVerdictMsg:
        d = v.to_dict()
        return msg.HealthVerdictMsg(
            detector=d["detector"],
            severity=d["severity"],
            message=d["message"],
            node_id=d["node_id"],
            host=d["host"],
            suggested_action=d["suggested_action"],
            evidence_series=d["evidence_series"],
            evidence=d["evidence"],
            metrics=d["metrics"],
            timestamp=d["timestamp"],
            resolved=d["resolved"],
        )

    def _query_health(self, req: msg.HealthQueryRequest):
        """The health plane's typed read channel: current score +
        active verdicts (optionally the transition history), filtered
        to one node when asked."""
        if self.health is None:
            return msg.HealthQueryResponse(score=1.0)

        def keep(v) -> bool:
            return req.node_id < 0 or v.node_id == req.node_id

        verdicts = [
            self._verdict_msg(v)
            for v in self.health.active_verdicts()
            if keep(v)
        ]
        history = []
        if req.include_history:
            history = [
                self._verdict_msg(v)
                for v in self.health.history()
                if keep(v)
            ]
        return msg.HealthQueryResponse(
            score=self.health.health_score(),
            verdicts=verdicts,
            history=history,
        )

    def _query_remediation(self, req: msg.RemediationQueryRequest):
        """The remediation engine's typed read channel: enabled/dry-
        run mode, cordoned nodes, the decision history with governor
        audit trails, and whether a probation window is currently
        failing."""
        if self.remediation is None:
            return msg.RemediationQueryResponse(enabled=False)
        return self.remediation.query_response(
            node_id=req.node_id, limit=req.limit
        )

    def _query_stall(self, req: msg.StallQueryRequest):
        """The stall-localization plane's typed read channel: the
        correlator's per-host progress table and incident state —
        ``obs_report --stall``'s feed."""
        if self.stall is None:
            return msg.StallQueryResponse(enabled=False)
        return msg.StallQueryResponse(
            enabled=True, snapshot=self.stall.snapshot()
        )

    def recent_diagnostics(self, node_id: int) -> list:
        """One node's forensics history (DiagnosticsReport records,
        newest last) — the stall correlator cross-links coordinated
        capture bundles into its incident snapshot through this."""
        with self._diagnostics_lock:
            return list(self._diagnostics.get(node_id, ()))

    def _query_traces(self, req: msg.TraceQueryRequest):
        """The trace store's typed read channel: assembled causal
        timelines by trace id or subject. Non-id queries are capped
        server-side (MAX_TRACE_QUERY newest): an unbounded "give me
        everything" against a full store would serialize ~130k spans
        into one response and blow the gRPC message cap."""
        if self.traces is None:
            return msg.TraceQueryResponse(enabled=False)
        limit = req.limit
        if not req.trace_id:
            limit = (
                min(limit, MAX_TRACE_QUERY)
                if limit > 0
                else MAX_TRACE_QUERY
            )
        return msg.TraceQueryResponse(
            enabled=True,
            traces=self.traces.query(
                trace_id=req.trace_id,
                subject=req.subject,
                limit=limit,
            ),
        )

    # -- serving plane ------------------------------------------------------

    def _serve_submit(self, req: msg.ServeSubmitRequest):
        if self.serving is None:
            return msg.ServeSubmitResponse(
                request_id="", accepted=False
            )
        rid = self.serving.submit(
            prompt=req.prompt,
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature,
            request_id=req.request_id,
        )
        return msg.ServeSubmitResponse(
            request_id=rid or "",
            accepted=rid is not None,
            trace_id=self.serving.trace_of(rid) if rid else "",
        )

    def _serve_result(self, req: msg.ServeResultRequest):
        if self.serving is None:
            return msg.ServeResultResponse(
                request_id=req.request_id
            )
        rec = self.serving.result(req.request_id)
        if rec is None:
            return msg.ServeResultResponse(
                request_id=req.request_id
            )
        return msg.ServeResultResponse(**rec)

    def _serve_pull(self, req: msg.ServePullRequest):
        if self.serving is None:
            return msg.ServePullResponse()
        items = self.serving.pull(
            req.replica_id, max_items=max(req.max_items, 1)
        )
        return msg.ServePullResponse(
            items=[
                msg.ServeWorkItem(
                    request_id=r.request_id,
                    prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature,
                    trace=dict(r.trace),
                    handoff=dict(r.handoff or {}),
                )
                for r in items
            ]
        )

    def _serve_complete(self, req: msg.ServeCompletedReport):
        if self.serving is None:
            return None
        self.serving.complete(
            replica_id=req.replica_id,
            request_id=req.request_id,
            tokens=req.tokens,
            ttft_s=req.ttft_s,
            tpot_s=req.tpot_s,
            finish_reason=req.finish_reason,
            error=req.error,
            phases=req.phases,
            handoff=dict(req.handoff) if req.handoff else None,
        )
        return None

    def _serve_stats(self, req: msg.ServeStatsReport):
        if self.serving is not None:
            self.serving.report_stats(req.replica_id, req.stats)
        return None

    def _serve_query(self, req: msg.ServeQueryRequest):
        if self.serving is None:
            return msg.ServeQueryResponse(enabled=False)
        return msg.ServeQueryResponse(
            enabled=True, snapshot=self.serving.snapshot()
        )

    def diagnose_node(self, node_id: int) -> None:
        """Queue an on-demand stack-and-state snapshot on the node
        (operator trigger or the SpeedMonitor's straggler/hang
        verdict); delivered via its next heartbeat."""
        self.push_action(node_id, EventAction.DIAGNOSE.value)

    def profile_node(self, node_id: int) -> None:
        """Queue an on-demand N-step performance capture on the node
        (operator RPC or the SpeedMonitor's straggler verdict): its
        agent asks the co-hosted trainer for a step-phase + MFU
        digest, shipped back as DiagnosticsReport(kind="profile")."""
        self.push_action(node_id, EventAction.PROFILE.value)

    def _profile_node_req(self, req: msg.ProfileActionRequest):
        self.profile_node(req.node_id)
        obs.event("node.profile_requested", node_id=req.node_id)
        return None

    def _register_node(self, req: msg.NodeAddressRequest):
        node = self.job_manager.register_node(
            node_type=req.node_type or "worker",
            node_id=req.node_id if req.node_id >= 0 else None,
            addr=req.node_ip,
            labels=dict(req.labels or {}),
        )
        # Evaluators and data workers live outside the training
        # world: they must not enter the rendezvous alive-sets (their
        # check times would pollute the worker straggler median) nor
        # the speed monitor's step accounting.
        from dlrover_tpu_torch.common.constants import NodeType

        if getattr(node, "cordoned", False):
            # A restarted agent on a benched host knows nothing of
            # its cordon (the flag lived in the old agent's memory):
            # re-assert it — park the fresh trainer, keep the node
            # out of the rendezvous alive-sets and speed accounting —
            # until the remediation engine un-cordons or retires it.
            self.push_action(node.id, EventAction.CORDON.value)
            return None
        if node.type == NodeType.REPLICA:
            # Serving replicas live in the node table (heartbeats,
            # watchdog, remediation) but outside the TRAINING world:
            # no rendezvous membership, no step accounting. Their
            # registration feeds the router's replica registry —
            # role-typed (prefill/decode/mixed) for the two-stage
            # dispatch; a PENDING launch's label stands in when the
            # process itself declared none.
            if self.serving is not None:
                role = (req.labels or {}).get(
                    "serving_role"
                ) or node.labels.get("serving_role") or "mixed"
                self.serving.register_replica(
                    node.id, addr=req.node_ip, role=role
                )
            return None
        if node.type not in (
            NodeType.EVALUATOR, NodeType.DATA_WORKER
        ):
            self.speed_monitor.add_running_node(node.id)
            for mgr in self.rdzv_managers.values():
                mgr.add_alive_node(node.id)
        return None

    def _get_job_nodes(self, req: msg.JobNodesRequest):
        nodes = [
            msg.NodeMeta(
                node_type=n.type,
                node_id=n.id,
                rank=n.rank,
                status=n.status,
                addr=n.host_addr,
                chips=n.config_resource.chips,
            )
            for n in self.job_manager.list_nodes(req.node_type)
        ]
        return msg.JobNodesResponse(nodes=nodes)

    def _get_parallel_config(self, req: msg.ParallelConfigRequest):
        return self.parallel_config

    def _get_metrics(self, req: msg.MetricsRequest):
        from dlrover_tpu_torch import obs

        return msg.MetricsResponse(text=obs.get_registry().render())

    def set_parallel_config(self, config: msg.ParallelConfig) -> None:
        """Called by the auto-tuner; version bump tells agents to
        apply it at the next restart."""
        config.version = self.parallel_config.version + 1
        self.parallel_config = config

    # -- PS-elastic sparse path --------------------------------------------

    def _get_partition_map(self, req: msg.PartitionMapRequest):
        return self.ps_manager.to_msg()

    def _register_ps(self, req: msg.PsRegisterRequest):
        self.ps_manager.register_ps(req.node_id, req.addr)
        # PS hosts are job nodes too: the node table is what the
        # PS auto-scaler plans over (ref master/node/ps.py keeps PS
        # in the same node dict as workers). PS ids are namespaced
        # (constants.ps_node_id) so ps 0 never merges onto worker 0.
        from dlrover_tpu_torch.common.constants import NodeType, ps_node_id

        self.job_manager.register_node(
            node_type=NodeType.EMBEDDING,
            node_id=ps_node_id(req.node_id),
            addr=req.addr,
        )

    def _report_ps_stats(self, req: msg.PsStatsReport):
        from dlrover_tpu_torch.common.constants import ps_node_id

        self.ps_manager.report_stats(req)
        # stats reports double as the PS host's heartbeat — without
        # this the 180s watchdog would kill every healthy PS.
        self.job_manager.update_heartbeat(ps_node_id(req.node_id))

