"""Master-side manager for the PS-elastic sparse path.

Capability parity with the reference's PS node management
(dlrover/python/master/node/ps.py:1-369 ParameterServerManager — alive
PS set, pending migration, sync barrier before dropping a PS) and the
worker SyncService (master/elastic_training/sync_service.py), built on
the versioned PartitionMap instead of node-granular migration:

* PS nodes register their RPC address; the manager assigns hash
  partitions (sparse/partition.py:balanced_assignment — minimal-move).
* scale-up/down is an orchestrated move: freeze on source -> target
  pulls (PS-to-PS delta export/import incl. optimizer slots) -> map
  version bump -> unfreeze. Workers carrying the old version get
  rejected and refetch — no barrier RPC needed.
* a dead PS (failure report / heartbeat timeout) gets its partitions
  reassigned to survivors, who restore them from the per-partition
  delta checkpoint files (ps_server.flush) — the sparse analogue of
  flash-checkpoint recovery.
* periodic PS telemetry (qps/cpu/rows) feeds the hot-PS auto-scaler
  (master/auto_scaler.py:PsAutoScaler; ref local_optimizer.py:66).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import RpcClient
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.sparse.partition import (
    NUM_PARTITIONS,
    PartitionMap,
    balanced_assignment,
)

logger = get_logger("ps_manager")


class PsManager:
    def __init__(self, num_partitions: int = NUM_PARTITIONS):
        self.num_partitions = num_partitions
        self._lock = threading.RLock()
        self._map = PartitionMap(version=0, assignment=[], ps_addrs={})
        self._clients: Dict[int, RpcClient] = {}
        self._stats: Dict[int, msg.PsStatsReport] = {}
        self._stats_time: Dict[int, float] = {}
        self._ping_failures: Dict[int, int] = {}
        self._liveness_stop = threading.Event()
        self._liveness_thread: Optional[threading.Thread] = None
        # Set by check_liveness after an automatic failover: ps_id,
        # t_detected, t_map_published, map_version (drill telemetry).
        self.last_failover: Optional[Dict] = None
        # Fired after every membership/map mutation; the JobMaster
        # points this at the state journal's mark_dirty so the map
        # survives a master bounce (to_snapshot/restore_snapshot).
        self.on_state_change: Optional[Callable[..., None]] = None

    def _changed(self, urgent: bool = False) -> None:
        cb = self.on_state_change
        if cb is not None:
            try:
                cb(urgent=urgent)
            except Exception:  # noqa: BLE001
                pass

    # -- accessors -------------------------------------------------------

    @property
    def partition_map(self) -> PartitionMap:
        with self._lock:
            return PartitionMap(
                version=self._map.version,
                assignment=list(self._map.assignment),
                ps_addrs=dict(self._map.ps_addrs),
            )

    # -- warm-restart snapshot -------------------------------------------

    def to_snapshot(self) -> dict:
        """The partition map is recoverable master state: PS nodes
        outlive a master bounce, and a replacement master that forgot
        the map would re-rebalance healthy nodes from scratch (and
        break every fenced client mid-stream)."""
        with self._lock:
            return {
                "version": self._map.version,
                "assignment": list(self._map.assignment),
                "ps_addrs": {
                    str(ps): addr
                    for ps, addr in self._map.ps_addrs.items()
                },
            }

    def restore_snapshot(self, state: dict) -> None:
        """Adopt a journaled map without republishing: the PS fleet
        still holds these exact partitions at this exact version, so
        the restored master just resumes serving the map."""
        with self._lock:
            if not state:
                self._map = PartitionMap(
                    version=0, assignment=[], ps_addrs={}
                )
                return
            self._map = PartitionMap(
                version=int(state.get("version", 0)),
                assignment=[
                    int(a) for a in state.get("assignment", [])
                ],
                ps_addrs={
                    int(ps): addr
                    for ps, addr in state.get("ps_addrs", {}).items()
                },
            )
            self._clients = {}
            self._ping_failures = {}

    def to_msg(self) -> msg.PartitionMapMsg:
        m = self.partition_map
        return msg.PartitionMapMsg(
            version=m.version,
            assignment=m.assignment,
            ps_addrs=m.ps_addrs,
        )

    def _client(self, ps_id: int) -> RpcClient:
        # Takes the (reentrant) lock itself: callers on the liveness
        # thread and flush path run outside locked sections, and the
        # cache must not race register_ps/remove_ps closing entries.
        with self._lock:
            addr = self._map.ps_addrs[ps_id]
            c = self._clients.get(ps_id)
            if c is None or c.addr != addr:
                if c is not None:
                    c.close()
                c = RpcClient(addr)
                self._clients[ps_id] = c
            return c

    # -- membership ------------------------------------------------------

    def register_ps(self, ps_id: int, addr: str) -> None:
        """A PS node came up (fresh or relaunched). Rebalance minimal-
        move, migrate data for partitions that change owner, publish."""
        with self._lock:
            is_new = ps_id not in self._map.ps_addrs
            self._map.ps_addrs[ps_id] = addr
            self._clients.pop(ps_id, None)
            self._ping_failures.pop(ps_id, None)
            if is_new or not self._map.assignment:
                self._rebalance(reason=f"register ps {ps_id}")
            else:
                # Same node re-registered (restart in place): it lost
                # its memory — restore its partitions from checkpoint
                # and bump the version so workers re-resolve the addr.
                self._map = PartitionMap(
                    version=self._map.version + 1,
                    assignment=list(self._map.assignment),
                    ps_addrs=dict(self._map.ps_addrs),
                )
                for other in sorted(self._map.ps_addrs):
                    parts = self._map.partitions_of(other)
                    self._publish(
                        other, parts,
                        restore=parts if other == ps_id else None,
                    )
        self._changed(urgent=True)

    def remove_ps(self, ps_id: int) -> None:
        """A PS died or is being scaled in. Survivors take over its
        partitions and restore them from the flush dir."""
        with self._lock:
            if ps_id not in self._map.ps_addrs:
                return
            dead_parts = self._map.partitions_of(ps_id)
            del self._map.ps_addrs[ps_id]
            c = self._clients.pop(ps_id, None)
            if c is not None:
                c.close()
            self._stats.pop(ps_id, None)
            if not self._map.ps_addrs:
                logger.error("last PS node %d removed", ps_id)
                self._map.assignment = []
                self._map.version += 1
            else:
                self._rebalance(
                    reason=f"remove ps {ps_id}",
                    restore_parts=dead_parts,
                )
        self._changed(urgent=True)

    def drain_ps(self, ps_id: int) -> None:
        """Gracefully retire a still-alive PS (hot-PS migration, scale
        -in): its partitions move PS-to-PS to the survivors (freeze ->
        pull -> publish) instead of being restored from checkpoint —
        the live analogue of the reference's migrate-then-drop
        (master/node/ps.py:327 _migrate_parameter_server)."""
        with self._lock:
            if ps_id not in self._map.ps_addrs:
                return
            if len(self._map.ps_addrs) > 1:
                # The rebalance publishes the new map (version bump)
                # to the survivors; the drained node just drops out of
                # the address book afterwards — no second bump, or the
                # published version would go stale immediately.
                self._rebalance(
                    reason=f"drain ps {ps_id}", exclude=ps_id
                )
                del self._map.ps_addrs[ps_id]
                c = self._clients.pop(ps_id, None)
                if c is not None:
                    c.close()
                self._stats.pop(ps_id, None)
                self._changed(urgent=True)
                return
        # Last PS: nothing to move to — plain removal (checkpoint
        # restore is the only recovery once a new PS appears).
        self.remove_ps(ps_id)

    # -- rebalancing -----------------------------------------------------

    def _rebalance(self, reason: str,
                   restore_parts: Optional[List[int]] = None,
                   exclude: Optional[int] = None) -> None:
        """Compute the minimal-move assignment and execute the
        migration plan. Must hold the lock. ``exclude``: a still-alive
        node to plan around — it gets no partitions in the new map but
        remains a valid pull source for the moves."""
        ps_ids = sorted(
            i for i in self._map.ps_addrs if i != exclude
        )
        old = self._map
        new_assignment = balanced_assignment(
            ps_ids, self.num_partitions, previous=old
        )
        moves: Dict[int, Dict[int, List[int]]] = {}  # dst -> src -> [p]
        fresh: Dict[int, List[int]] = {}  # dst -> partitions w/o source
        restore_set = set(restore_parts or [])
        for p, dst in enumerate(new_assignment):
            src = (old.assignment[p]
                   if p < len(old.assignment) else None)
            if src == dst:
                continue
            if (src is None or src not in self._map.ps_addrs
                    or p in restore_set):
                fresh.setdefault(dst, []).append(p)
            else:
                moves.setdefault(dst, {}).setdefault(src, []).append(p)

        # 1. freeze moving partitions on their sources
        for dst, by_src in moves.items():
            for src, parts in by_src.items():
                self._safe_call(src, msg.PsFreezeRequest(
                    partitions=parts, frozen=True))
        # 2. targets pull from sources (PS-to-PS)
        for dst, by_src in moves.items():
            for src, parts in by_src.items():
                self._safe_call(dst, msg.PsPullPartitionsRequest(
                    source_addr=self._map.ps_addrs[src],
                    partitions=parts,
                ))
        # 3. publish the new map (version bump) to every PS
        self._map = PartitionMap(
            version=old.version + 1,
            assignment=new_assignment,
            ps_addrs=dict(self._map.ps_addrs),
        )
        for ps_id in ps_ids:
            parts = self._map.partitions_of(ps_id)
            restore = sorted(set(fresh.get(ps_id, [])) & set(parts))
            self._publish(ps_id, parts, restore=restore)
        logger.info(
            "partition map v%d (%s): %s",
            self._map.version, reason,
            {ps: len(self._map.partitions_of(ps)) for ps in ps_ids},
        )

    def _publish(self, ps_id: int, parts: List[int],
                 restore: Optional[List[int]] = None) -> None:
        if restore:
            self._safe_call(ps_id, msg.PsRestoreRequest(
                partitions=restore))
        self._safe_call(ps_id, msg.PsSetPartitionsRequest(
            partitions=parts, map_version=self._map.version))

    def _safe_call(self, ps_id: int, request) -> None:
        try:
            self._client(ps_id).get(request)
        except Exception:  # noqa: BLE001 — a dying PS must not wedge
            logger.warning(
                "PS %d rpc %s failed", ps_id,
                type(request).__name__, exc_info=True,
            )

    # -- checkpoint ------------------------------------------------------

    def flush_all(self, step: int, epoch: int = -1,
                  hwm: Optional[Dict[str, int]] = None) -> int:
        """Direct every PS to delta-flush (called on the trainer's
        checkpoint cadence). Returns total rows flushed.

        A stream barrier passes ``epoch`` and the shard ledger's
        high-water mark ``hwm``; both land in every partition's fence
        file, tying the PS cut to the ledger cut."""
        total = 0
        with self._lock:
            ps_ids = sorted(self._map.ps_addrs)
        for ps_id in ps_ids:
            try:
                resp = self._client(ps_id).get(msg.PsFlushRequest(
                    step=step, epoch=epoch, hwm=dict(hwm or {})))
                total += resp.flushed_rows
            except Exception:  # noqa: BLE001
                logger.warning("PS %d flush failed", ps_id,
                               exc_info=True)
        return total

    # -- liveness --------------------------------------------------------

    def start_liveness_monitor(
        self,
        interval: float = 2.0,
        failure_threshold: int = 2,
        ping_timeout: float = 3.0,
    ) -> None:
        """Detect abrupt PS death and fail it over automatically.

        Each tick pings every registered PS with a stats RPC; after
        ``failure_threshold`` consecutive failures the node is treated
        as dead and :meth:`remove_ps` runs — survivors take over its
        partitions restored from the last delta flush, the map version
        bumps, and blocked clients unblock on their next map refresh.
        Complements (and works without) the master's node-event path,
        e.g. for in-process drills with no servicer heartbeats.

        Invariant the defaults must keep: worst-case detection latency
        — ``failure_threshold * (interval + ping_timeout)`` = 10 s —
        must stay well inside the sparse client's stale-map retry
        budget (DistributedKvClient: max_retries backoff totalling
        ~39 s), or a blocked training step would exhaust its retries
        and crash before the new map is published.
        """
        if self._liveness_thread is not None:
            return
        self._liveness_stop.clear()

        def loop() -> None:
            while not self._liveness_stop.wait(interval):
                self.check_liveness(failure_threshold, ping_timeout)

        self._liveness_thread = threading.Thread(
            target=loop, name="ps-liveness", daemon=True
        )
        self._liveness_thread.start()

    def stop_liveness_monitor(self) -> None:
        self._liveness_stop.set()
        if self._liveness_thread is not None:
            self._liveness_thread.join(timeout=5.0)
            self._liveness_thread = None

    def check_liveness(
        self, failure_threshold: int = 2, ping_timeout: float = 3.0
    ) -> List[int]:
        """One liveness pass; returns the PS ids failed over."""
        with self._lock:
            ps_ids = sorted(self._map.ps_addrs)
        dead: List[int] = []
        for ps_id in ps_ids:
            try:
                self._client(ps_id).get(
                    msg.PsStatsRequest(), timeout=ping_timeout
                )
            except Exception:  # noqa: BLE001 — any failure counts
                with self._lock:
                    if ps_id not in self._map.ps_addrs:
                        # Deliberately removed (drain/remove) while we
                        # were pinging: not a strike.
                        self._ping_failures.pop(ps_id, None)
                        continue
                    self._ping_failures[ps_id] = (
                        self._ping_failures.get(ps_id, 0) + 1
                    )
                    failures = self._ping_failures[ps_id]
                logger.warning(
                    "PS %d liveness ping failed (%d/%d)",
                    ps_id, failures, failure_threshold,
                )
                if failures >= failure_threshold:
                    dead.append(ps_id)
            else:
                with self._lock:
                    self._ping_failures.pop(ps_id, None)
        for ps_id in dead:
            logger.error(
                "PS %d unresponsive for %d pings; failing over",
                ps_id, failure_threshold,
            )
            with self._lock:
                self._ping_failures.pop(ps_id, None)
            t_detected = time.time()
            self.remove_ps(ps_id)
            with self._lock:
                # Phase record for chaos drills: when the monitor
                # declared death vs when the rebalanced map published.
                self.last_failover = {
                    "ps_id": ps_id,
                    "t_detected": t_detected,
                    "t_map_published": time.time(),
                    "map_version": self._map.version,
                }
        return dead

    # -- telemetry -------------------------------------------------------

    def report_stats(self, report: msg.PsStatsReport) -> None:
        with self._lock:
            self._stats[report.node_id] = report
            # Monotonic arrival stamp: only compared against now() in
            # the max_age staleness sweep below.
            self._stats_time[report.node_id] = time.monotonic()

    def hot_ps(self, cpu_threshold: float = 80.0) -> List[int]:
        """PS nodes whose reported CPU exceeds the threshold (input to
        the hot-PS auto-scaler; ref local_optimizer.py:66)."""
        with self._lock:
            return sorted(
                node_id for node_id, s in self._stats.items()
                if s.cpu_percent >= cpu_threshold
            )

    def stats(
        self, max_age: Optional[float] = None
    ) -> Dict[int, msg.PsStatsReport]:
        """Latest report per PS; ``max_age`` (seconds) drops stale
        entries so a PS that stopped reporting can't keep steering
        the auto-scaler with its last value."""
        now = time.monotonic()
        with self._lock:
            return {
                node_id: s
                for node_id, s in self._stats.items()
                if max_age is None
                or now - self._stats_time.get(node_id, 0.0) <= max_age
            }
