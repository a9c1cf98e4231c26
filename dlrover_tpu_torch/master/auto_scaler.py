"""Auto-scaler + local resource optimizer.

Capability parity with the reference's resource re-planning layer
(dlrover/python/master/node/job_auto_scaler.py:40
``new_job_auto_scaler`` / AllreduceTrainingAutoScaler :254, and
master/resource/local_optimizer.py:66): periodically compare the
job's target worker count with what is actually alive, grow OOM'd
nodes' memory before relaunch, and — for TPU — keep the worker count
on *slice-compatible* sizes (a v5p slice wants multiples of its host
count; arbitrary worker counts strand chips).

The Brain remote optimizer of the reference (brain_optimizer.py) is a
pluggable ResourceOptimizer here; LocalResourceOptimizer is the
default heuristic (the reference ships the same split).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import Node, NodeResource
from dlrover_tpu_torch.master.job_manager import JobManager, ScalePlan
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

logger = get_logger("auto_scaler")

_SCALE_PLANS = obs.counter(
    "dlrover_autoscale_plans_total",
    "Scale plans issued by the auto-scalers",
    ("kind",),
)

OOM_MEMORY_GROW_FACTOR = 1.5  # ref local_optimizer.py:96 grows OOM pods


class ResourceOptimizer:
    """Strategy seam: local heuristic now, Brain-style remote later."""

    def optimize_oom_node(self, resource: NodeResource) -> NodeResource:
        raise NotImplementedError

    def target_worker_count(
        self, current: int, speed_monitor: SpeedMonitor
    ) -> int:
        raise NotImplementedError


class LocalResourceOptimizer(ResourceOptimizer):
    def __init__(
        self,
        min_workers: int = 1,
        max_workers: int = 64,
        hosts_per_slice: int = 1,
    ):
        self.min_workers = min_workers
        self.max_workers = max_workers
        # TPU slices come in fixed host multiples (v5p-32 = 4 hosts);
        # scaling to a non-multiple strands chips.
        self.hosts_per_slice = max(hosts_per_slice, 1)

    def optimize_oom_node(self, resource: NodeResource) -> NodeResource:
        grown = NodeResource.from_dict(resource.to_dict())
        grown.memory_mb = int(
            max(resource.memory_mb, 1024) * OOM_MEMORY_GROW_FACTOR
        )
        return grown

    def target_worker_count(
        self, current: int, speed_monitor: SpeedMonitor
    ) -> int:
        target = max(self.min_workers, min(current, self.max_workers))
        # round DOWN to a slice multiple (never exceed what is alive)
        target -= target % self.hosts_per_slice
        return max(target, self.hosts_per_slice)


class PsLocalOptimizer:
    """Runtime-stats-driven resource planning for the PS (sparse/CTR)
    strategy — capability parity with the reference's PSLocalOptimizer
    (dlrover/python/master/resource/local_optimizer.py:66):

    * hot-PS: a PS whose averaged CPU utilisation over the sample
      window crosses ``ps_cpu_hot_threshold`` should be migrated to a
      node with more CPU (``optimize_hot_ps``), scaled by the same
      tune-factor rule the reference uses (bounded by node_max_cpu).
    * worker count: while the hottest PS still has CPU headroom below
      ``ps_cpu_overload_threshold``, workers can grow by the headroom
      factor (ref local_optimizer.py:189 _generate_worker_resoruce) —
      gated on the *marginal speed ratio* of the last worker change
      (ref :249 _compute_worker_speed_ratio): if adding workers no
      longer yields ≥ ``min_worker_speed_ratio`` of linear speedup,
      stop growing.
    """

    def __init__(
        self,
        ps_cpu_hot_threshold: float = 0.9,
        ps_cpu_overload_threshold: float = 0.7,
        min_worker_speed_ratio: float = 0.4,
        node_max_cpu: float = 32.0,
        max_workers: int = 64,
        window: int = 5,
    ):
        self.ps_cpu_hot_threshold = ps_cpu_hot_threshold
        self.ps_cpu_overload_threshold = ps_cpu_overload_threshold
        self.min_worker_speed_ratio = min_worker_speed_ratio
        self.node_max_cpu = node_max_cpu
        self.max_workers = max_workers
        self.window = window
        # ps_id -> recent cpu-percent samples (0..100)
        self._ps_cpu: dict = {}
        # (worker_num, speed) history for the marginal-speedup gate
        self._speed_hist: List[tuple] = []

    # -- sample collection ----------------------------------------------

    def record_ps_sample(self, ps_id: int, cpu_percent: float) -> None:
        hist = self._ps_cpu.setdefault(ps_id, [])
        hist.append(cpu_percent)
        del hist[: -self.window]

    def record_speed_sample(self, worker_num: int, speed: float) -> None:
        if speed > 0:
            self._speed_hist.append((worker_num, speed))
            del self._speed_hist[: -10 * self.window]

    def forget_ps(self, ps_id: int) -> None:
        self._ps_cpu.pop(ps_id, None)

    # -- plans -----------------------------------------------------------

    def _avg_cpu(self, ps_id: int) -> float:
        hist = self._ps_cpu.get(ps_id) or [0.0]
        return sum(hist) / len(hist)

    def hot_ps(self) -> List[int]:
        return sorted(
            ps_id
            for ps_id in self._ps_cpu
            if self._avg_cpu(ps_id) / 100.0 >= self.ps_cpu_hot_threshold
        )

    def optimize_hot_ps(
        self, config_cpu: dict
    ) -> dict:
        """Plan CPU growth for hot PS nodes. ``config_cpu`` maps ps_id
        to its currently-configured CPU cores; returns ps_id -> new
        cpu for nodes that should migrate to a bigger node. Mirrors the
        reference's tune-factor: grow toward node_max_cpu but never
        shrink (local_optimizer.py:299 _optimize_hot_ps_cpu)."""
        plan = {}
        for ps_id in self.hot_ps():
            cur = config_cpu.get(ps_id, 1.0) or 1.0
            used = cur * self._avg_cpu(ps_id) / 100.0
            factor = min(self.node_max_cpu / max(used, 0.1), 2.0)
            opt = round(used * factor, 1)
            if opt > cur:
                plan[ps_id] = min(opt, self.node_max_cpu)
        return plan

    def worker_speed_ratio(self) -> float:
        """Marginal per-worker speedup of the most recent worker-count
        change, relative to the average speed per worker before it.
        1.0 when no change has happened yet (nothing to judge)."""
        hist = self._speed_hist
        if len(hist) < 2:
            return 1.0
        post_num = hist[-1][0]
        split = len(hist)
        for i in reversed(range(len(hist))):
            if hist[i][0] != post_num:
                split = i + 1
                break
        if split == len(hist):  # worker count never changed
            return 1.0
        post = [s for n, s in hist[split:] if n == post_num]
        pre_num = hist[split - 1][0]
        pre = [s for n, s in hist[:split] if n == pre_num]
        if not pre or not post or pre_num == post_num:
            return 1.0
        pre_speed = sum(pre) / len(pre)
        post_speed = sum(post) / len(post)
        worker_diff = post_num - pre_num
        if worker_diff <= 0 or pre_speed <= 0:
            return 1.0
        marginal = (post_speed - pre_speed) / worker_diff
        linear = pre_speed / pre_num
        return marginal / linear if linear > 0 else 1.0

    def optimize_worker_count(self, current: int) -> int:
        """Target worker count from PS CPU headroom: with the hottest
        PS at util u < overload threshold o, workers can scale by o/u
        (ref local_optimizer.py:213). Gated on the marginal-speedup
        ratio so a PS-bound or input-bound job stops growing, and on
        having real throughput evidence at all — with no speed samples
        the gate must fail CLOSED, not open."""
        if current <= 0:
            return current
        if len(self._speed_hist) < self.window:
            return current
        utils = [self._avg_cpu(p) / 100.0 for p in self._ps_cpu]
        max_util = max(utils, default=0.0)
        if max_util >= self.ps_cpu_overload_threshold or max_util <= 0:
            return current
        if self.worker_speed_ratio() < self.min_worker_speed_ratio:
            return current
        factor = self.ps_cpu_overload_threshold / max_util
        return min(int(current * factor), self.max_workers)


class PsTrainingAutoScaler:
    """Auto-scaler for the PS (sparse embedding) strategy — parity with
    the reference's PSTrainingAutoScaler
    (dlrover/python/master/node/job_auto_scaler.py:98) on the
    TPU-native PS fabric (master/ps_manager.py):

    * hot-PS migration: launch a replacement EMBEDDING node with grown
      CPU; when it registers with the PsManager, the old node is
      drained (partitions move via the minimal-move rebalance) and
      removed — the TPU-native analogue of
      ps.py:327 _migrate_parameter_server.
    * worker adjustment: grow the worker group while PS CPU headroom
      and the marginal speed ratio allow (PsLocalOptimizer).
    """

    def __init__(
        self,
        job_manager: JobManager,
        speed_monitor: SpeedMonitor,
        ps_manager,
        optimizer: Optional[PsLocalOptimizer] = None,
        interval: float = 30.0,
    ):
        self.job_manager = job_manager
        self.speed_monitor = speed_monitor
        self.ps_manager = ps_manager
        self.optimizer = optimizer or PsLocalOptimizer()
        self.interval = interval
        # old_ps_id -> replacement node id, pending the replacement's
        # registration with the PsManager
        self._migrations: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="ps-auto-scaler", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.adjust_once()
            except Exception:  # noqa: BLE001
                logger.warning("ps auto-scale pass failed", exc_info=True)

    # -- one adjustment pass --------------------------------------------

    def _collect(self) -> None:
        fresh = self.ps_manager.stats(max_age=3 * self.interval)
        for ps_id, stats in fresh.items():
            self.optimizer.record_ps_sample(ps_id, stats.cpu_percent)
        workers = [
            n
            for n in self.job_manager.list_nodes(NodeType.WORKER)
            if n.is_alive()
        ]
        self.optimizer.record_speed_sample(
            len(workers), self.speed_monitor.running_speed()
        )

    def adjust_once(self) -> Optional[ScalePlan]:
        self._collect()
        self._finish_migrations()
        plan = self._migrate_hot_ps()
        if plan is not None:
            return plan
        return self._adjust_workers()

    # -- hot-PS migration -----------------------------------------------

    def _ps_nodes(self) -> dict:
        """ps_id -> job Node (ids translated out of the EMBEDDING
        node-id namespace, constants.ps_node_id)."""
        from dlrover_tpu_torch.common.constants import node_ps_id

        return {
            node_ps_id(n.id): n
            for n in self.job_manager.list_nodes(NodeType.EMBEDDING)
            if not n.status == NodeStatus.DELETED
        }

    def _migrate_hot_ps(self) -> Optional[ScalePlan]:
        from dlrover_tpu_torch.common.constants import ps_node_id

        nodes = self._ps_nodes()
        config_cpu = {
            ps_id: (n.config_resource.cpu if n.config_resource else 1.0)
            for ps_id, n in nodes.items()
        }
        growth = self.optimizer.optimize_hot_ps(config_cpu)
        plan = ScalePlan()
        next_ps_id = (
            max(
                list(nodes) + list(self._migrations.values()),
                default=-1,
            )
            + 1
        )
        for old_id, new_cpu in growth.items():
            if old_id in self._migrations or old_id not in nodes:
                continue
            old = nodes[old_id]
            resource = (
                NodeResource.from_dict(old.config_resource.to_dict())
                if old.config_resource
                else NodeResource()
            )
            resource.cpu = new_cpu
            repl = Node(
                type=NodeType.EMBEDDING,
                id=ps_node_id(next_ps_id),
                rank=old.rank,
                status=NodeStatus.PENDING,
                config_resource=resource,
            )
            self._migrations[old_id] = next_ps_id
            next_ps_id += 1
            plan.launch_nodes.append(repl)
            logger.info(
                "hot PS %d (cpu %.1f) -> migrating to ps %d with "
                "cpu %.1f",
                old_id,
                config_cpu.get(old_id, 0.0),
                self._migrations[old_id],
                new_cpu,
            )
        if not plan.launch_nodes:
            return None
        for node in plan.launch_nodes:
            self.job_manager.adopt_node(node)
        self.job_manager.scaler.scale(plan)
        _SCALE_PLANS.inc(kind="ps_hot_migration")
        obs.event(
            "autoscale.plan",
            kind="ps_hot_migration",
            launch=[n.id for n in plan.launch_nodes],
        )
        return plan

    def _finish_migrations(self) -> None:
        """Once a replacement PS has registered with the PsManager
        (it appears in the partition map), drain and retire the old
        node. A replacement that died before registering (pending
        timeout, launch failure) releases the migration slot so the
        still-hot PS can be retried."""
        if not self._migrations:
            return
        from dlrover_tpu_torch.common.constants import ps_node_id

        registered = set(self.ps_manager.partition_map.ps_addrs)
        for old_id, new_id in list(self._migrations.items()):
            if new_id in registered:
                # the old PS is still alive: drain (live PS-to-PS
                # move), don't treat it as dead
                self.ps_manager.drain_ps(old_id)
                self.optimizer.forget_ps(old_id)
                self.job_manager.retire_node(ps_node_id(old_id))
                del self._migrations[old_id]
                logger.info(
                    "hot-PS migration %d -> %d complete", old_id, new_id
                )
                continue
            repl_node = self.job_manager.get_node(ps_node_id(new_id))
            if (
                repl_node is not None
                and repl_node.status in NodeStatus.TERMINAL
            ):
                del self._migrations[old_id]
                logger.warning(
                    "hot-PS migration %d -> %d abandoned (replacement "
                    "%s); will retry", old_id, new_id, repl_node.status,
                )

    # -- worker adjustment ----------------------------------------------

    def _adjust_workers(self) -> Optional[ScalePlan]:
        workers = [
            n
            for n in self.job_manager.list_nodes(NodeType.WORKER)
            if n.is_alive()  # ALIVE includes PENDING
        ]
        target = self.optimizer.optimize_worker_count(len(workers))
        missing = target - len(workers)
        if missing <= 0:
            return None
        next_id = (
            max(
                [n.id for n in self.job_manager.list_nodes()],
                default=-1,
            )
            + 1
        )
        template = workers[0] if workers else None
        plan = ScalePlan()
        for i in range(missing):
            resource = (
                NodeResource.from_dict(
                    template.config_resource.to_dict()
                )
                if template is not None and template.config_resource
                else NodeResource()
            )
            plan.launch_nodes.append(
                Node(
                    type=NodeType.WORKER,
                    id=next_id + i,
                    rank=next_id + i,
                    status=NodeStatus.PENDING,
                    config_resource=resource,
                )
            )
        for node in plan.launch_nodes:
            self.job_manager.adopt_node(node)
        self.job_manager.scaler.scale(plan)
        logger.info(
            "ps-strategy worker adjust: %d -> %d", len(workers), target
        )
        _SCALE_PLANS.inc(kind="ps_worker_adjust")
        obs.event(
            "autoscale.plan",
            kind="ps_worker_adjust",
            current=len(workers), target=target,
        )
        return plan


class AllreduceAutoScaler:
    """Keeps an allreduce (SPMD) job at its target size (ref
    AllreduceTrainingAutoScaler._periodic_adjust_worker
    job_auto_scaler.py:288): counts alive workers, asks the scaler for
    replacements of anything missing, and applies OOM memory growth
    to relaunch resources."""

    def __init__(
        self,
        job_manager: JobManager,
        speed_monitor: SpeedMonitor,
        target_workers: int,
        optimizer: Optional[ResourceOptimizer] = None,
        interval: float = 30.0,
        num_slices: int = 1,
    ):
        self.job_manager = job_manager
        self.speed_monitor = speed_monitor
        self.target_workers = target_workers
        self.optimizer = optimizer or LocalResourceOptimizer()
        self.interval = interval
        # Multi-slice jobs: replacements must land in the deficient
        # slice so the DCN (outer) mesh axis stays balanced.
        self.num_slices = max(num_slices, 1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="auto-scaler", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.adjust_once()
            except Exception:  # noqa: BLE001
                logger.warning("auto-scale pass failed", exc_info=True)

    def grow_oom_resources(self) -> None:
        """Apply memory growth to nodes that OOM'd before their
        replacement launches."""
        for node in self.job_manager.list_nodes(NodeType.WORKER):
            if (
                node.relaunch_reason == "oom"
                and node.status == NodeStatus.PENDING
                and node.config_resource is not None
                and not getattr(node, "_oom_grown", False)
            ):
                node.config_resource = self.optimizer.optimize_oom_node(
                    node.config_resource
                )
                node._oom_grown = True  # type: ignore[attr-defined]
                logger.info(
                    "node %d OOM relaunch memory grown to %dMB",
                    node.id,
                    node.config_resource.memory_mb,
                )

    def adjust_once(self) -> Optional[ScalePlan]:
        """One pass: replace missing workers up to the slice-aligned
        target. Returns the plan if one was issued."""
        self.grow_oom_resources()
        nodes = self.job_manager.list_nodes(NodeType.WORKER)
        # ALIVE includes PENDING: replacements in flight count toward
        # the target (counting them twice would strand the job one
        # worker short of the target forever). Cordoned nodes do NOT
        # count (alive_workers excludes them): the remediation engine
        # deliberately benched them, and "fixing" the deficit by
        # counting the benched host would leave the job short a
        # healthy worker.
        alive = self.job_manager.alive_workers()
        target = self.optimizer.target_worker_count(
            self.target_workers, self.speed_monitor
        )
        missing = target - len(alive)
        if missing <= 0:
            return None

        # Fill the most-deficient slice first so the DCN axis stays
        # balanced (each slice is one block of the outer mesh axis).
        def slice_of(n: Node) -> int:
            if n.config_resource is None:
                return 0
            return max(n.config_resource.slice_id, 0) % self.num_slices

        counts = {s: 0 for s in range(self.num_slices)}
        templates: dict = {}
        for n in alive:
            s = slice_of(n)
            counts[s] += 1
            templates.setdefault(s, n)
        fallback = alive[0] if alive else (nodes[0] if nodes else None)

        used_ids = {n.id for n in nodes}
        plan = ScalePlan()
        next_id = max(used_ids, default=-1) + 1
        for i in range(missing):
            s = min(counts, key=counts.get)
            counts[s] += 1
            template = templates.get(s, fallback)
            resource = (
                NodeResource.from_dict(
                    template.config_resource.to_dict()
                )
                if template is not None and template.config_resource
                else NodeResource()
            )
            # pin only when the job actually spans slices
            resource.slice_id = s if self.num_slices > 1 else -1
            plan.launch_nodes.append(
                Node(
                    type=NodeType.WORKER,
                    id=next_id + i,
                    rank=next_id + i,
                    status=NodeStatus.PENDING,
                    config_resource=resource,
                )
            )
        for node in plan.launch_nodes:
            self.job_manager.adopt_node(node)
        self.job_manager.scaler.scale(plan)
        _SCALE_PLANS.inc(kind="allreduce_replace")
        obs.event(
            "autoscale.plan",
            kind="allreduce_replace",
            alive=len(alive), target=target, missing=missing,
        )
        logger.info(
            "auto-scaler: %d alive of target %d -> launching %d "
            "(slices %s)",
            len(alive),
            target,
            missing,
            {s: c for s, c in counts.items()} if self.num_slices > 1
            else "n/a",
        )
        return plan
