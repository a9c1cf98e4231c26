"""Job/node manager on the master.

Capability parity with the reference's node management layer
(dlrover/python/master/node/dist_job_manager.py:87): tracks every node's
state machine, classifies failures, decides relaunches, and feeds the
rendezvous managers / task manager / speed monitor. Platform-specific
scaling (GKE TPU pod-slices, Ray) plugs in via a ``Scaler`` interface;
the local platform simply records intents so tests can assert on them.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import (
    JobExitReason,
    NodeAction,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import Node, NodeResource

logger = get_logger("job_manager")

_NODE_EVENTS = obs.counter(
    "dlrover_node_events_total",
    "Node lifecycle events observed by the master",
    ("event",),
)
_RELAUNCHES = obs.counter(
    "dlrover_node_relaunch_total",
    "Node relaunches ordered by the master",
    ("reason",),
)


class ScalePlan:
    """Target state the scaler should realize."""

    def __init__(self):
        self.launch_nodes: List[Node] = []
        self.remove_nodes: List[Node] = []

    def empty(self) -> bool:
        return not self.launch_nodes and not self.remove_nodes

    def __repr__(self):
        return (
            f"ScalePlan(launch={[n.id for n in self.launch_nodes]}, "
            f"remove={[n.id for n in self.remove_nodes]})"
        )


class Scaler:
    """Executes ScalePlans. Subclasses talk to GKE/Ray; the base class
    records plans for local mode and tests."""

    def __init__(self):
        self.executed_plans: List[ScalePlan] = []

    def scale(self, plan: ScalePlan) -> None:
        self.executed_plans.append(plan)


@dataclasses.dataclass(frozen=True)
class RolePolicy:
    """Per-role lifecycle policy the master applies at registration.

    ``critical``: losing such a node past its relaunch budget fails
    the whole job instead of elastically shrinking it (ref:
    chief/evaluator/PS are always critical, workers per the
    critical-nodes spec, master/node/training_node.py:40-72).
    ``max_relaunch``: role-specific relaunch-budget override; None
    keeps the job-wide default.
    """

    critical: bool = False
    max_relaunch: Optional[int] = None


def default_role_policies() -> Dict[str, RolePolicy]:
    return {
        NodeType.CHIEF: RolePolicy(critical=True),
        NodeType.EVALUATOR: RolePolicy(critical=True),
        NodeType.EMBEDDING: RolePolicy(critical=True),
    }


def parse_critical_workers(spec: str) -> Dict[int, Optional[int]]:
    """Parse the critical-workers spec into {rank: relaunch budget}.

    ``""`` / ``"none"`` -> no critical workers; ``"all"`` -> every
    worker critical (budget None = keep default); ``"0:3,5:1"`` ->
    those ranks critical with the given per-rank relaunch budgets.
    (ref: training_node.py:81 get_critical_worker_index)
    """
    spec = (spec or "").strip().lower()
    if spec in ("", "none"):
        return {}
    if spec == "all":
        return {-1: None}  # sentinel: every rank
    out: Dict[int, Optional[int]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        rank_s, _, budget_s = part.partition(":")
        try:
            rank = int(rank_s)
            budget = int(budget_s) if budget_s else None
        except ValueError:
            raise ValueError(
                f"bad critical-workers entry {part!r}: expected "
                "'rank' or 'rank:relaunch_budget' (or 'all'/'none')"
            ) from None
        if rank < 0 or (budget is not None and budget < 0):
            raise ValueError(
                f"bad critical-workers entry {part!r}: rank and "
                "budget must be non-negative"
            )
        out[rank] = budget
    return out


class JobManager:
    """Tracks nodes and drives relaunch decisions."""

    def __init__(
        self,
        scaler: Optional[Scaler] = None,
        max_relaunch: int = 3,
        heartbeat_timeout: float = 180.0,
        pending_timeout: Optional[float] = None,
        role_policies: Optional[Dict[str, RolePolicy]] = None,
        critical_workers: str = "",
        monitor_interval: float = 30.0,
    ):
        from dlrover_tpu_torch.common.config import Context

        self._lock = threading.Lock()
        self._nodes: Dict[int, Node] = {}
        self._scaler = scaler or Scaler()
        self._max_relaunch = max_relaunch
        self._heartbeat_timeout = heartbeat_timeout
        self._pending_timeout = (
            Context.singleton().pending_timeout_secs
            if pending_timeout is None else pending_timeout
        )
        self._next_node_id = 0
        self._monitor_interval = monitor_interval
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        # subscribers: fn(node, event_type)
        self._listeners: List[Callable[[Node, str], None]] = []
        self._role_policies = (
            default_role_policies()
            if role_policies is None
            else dict(role_policies)
        )
        self._critical_workers = parse_critical_workers(critical_workers)
        # Set when a critical node is lost for good: (reason, detail).
        self._job_failure: Optional[tuple] = None
        # Multi-job pool grant: when this job runs under a pool
        # master, the pool caps its ALIVE node count here (None =
        # single-job, unlimited). ensure_role respects it (the
        # serving plane's autoscale seam), and the remediation
        # engine's pool_grant governor consults grant_headroom()
        # before launching replacements — per-job planes become
        # consumers of pool grants instead of assuming an infinite
        # cluster.
        self.pool_grant: Optional[int] = None

    @property
    def scaler(self) -> Scaler:
        return self._scaler

    # -- membership ---------------------------------------------------------

    def adopt_node(self, node: Node) -> None:
        """Track a node created by the auto-scaler (it will register
        itself over RPC once its agent starts)."""
        with self._lock:
            self._nodes[node.id] = node
            # Keep the id allocator ahead of externally-minted ids:
            # launch_replacement must never collide with (and silently
            # overwrite) an in-flight auto-scaler node.
            self._next_node_id = max(self._next_node_id, node.id + 1)

    def add_listener(self, fn: Callable[[Node, str], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, node: Node, event_type: str) -> None:
        for fn in self._listeners:
            try:
                fn(node, event_type)
            except Exception:  # noqa: BLE001
                logger.exception("node event listener failed")

    def register_node(
        self,
        node_type: str = NodeType.WORKER,
        node_id: Optional[int] = None,
        rank: int = -1,
        addr: str = "",
        resource: Optional[NodeResource] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> Node:
        """Called when an agent announces itself (or a pod is created)."""
        with self._lock:
            if node_id is None:
                node_id = self._next_node_id
            # Only worker-range ids advance the sequence: a
            # namespaced registration (PS 1M+, evaluator 2M+, data
            # worker 3M+, replica 4M+) must not drag the worker id
            # sequence into a role namespace — later worker-sequence
            # launches would mint ids an arriving namespaced agent
            # believes are ITS OWN and silently merge onto.
            from dlrover_tpu_torch.common.constants import PS_NODE_ID_BASE

            if node_id < PS_NODE_ID_BASE:
                self._next_node_id = max(
                    self._next_node_id, node_id + 1
                )
            node = self._nodes.get(node_id)
            if node is not None and node.status in NodeStatus.TERMINAL:
                # A relaunched agent re-registering under its old id: the
                # old Node is a finished incarnation, start a fresh one
                # carrying over rank and the relaunch budget.
                fresh = Node(
                    type=node.type,
                    id=node.id,
                    rank=node.rank,
                    host_addr=addr or node.host_addr,
                    config_resource=node.config_resource,
                    relaunch_count=node.relaunch_count,
                    max_relaunch_count=node.max_relaunch_count,
                    critical=node.critical,
                    # The cordon outlives the incarnation: only the
                    # remediation engine un-cordons. Dropping it here
                    # would let a benched host whose agent was gone
                    # past the heartbeat timeout rejoin the world on
                    # re-register, next to its replacement.
                    cordoned=node.cordoned,
                    labels=dict(node.labels),
                )
                self._nodes[node_id] = fresh
                node = fresh
            elif node is None:
                node = Node(
                    type=node_type,
                    id=node_id,
                    rank=rank if rank >= 0 else node_id,
                    host_addr=addr,
                    config_resource=resource or NodeResource(),
                    max_relaunch_count=self._max_relaunch,
                )
                self._nodes[node_id] = node
            node.host_addr = addr or node.host_addr
            if labels:
                # The registering process's declared labels win over
                # a PENDING launch's (they describe what actually
                # arrived).
                node.labels.update(labels)
            self._apply_role_policy(node)
            node.update_status(NodeStatus.RUNNING)
            node.update_heartbeat()
        _NODE_EVENTS.inc(event="register")
        obs.event(
            "node.register",
            node_id=node.id, type=node.type, node_rank=node.rank,
        )
        self._notify(node, NodeEventType.CREATED)
        return node

    def _apply_role_policy(self, node: Node) -> None:
        """Stamp role-derived lifecycle attributes on a node. Called
        under the lock at registration; idempotent for re-registers."""
        policy = self._role_policies.get(node.type)
        if policy is not None:
            node.critical = policy.critical
            if policy.max_relaunch is not None:
                node.max_relaunch_count = policy.max_relaunch
        if node.type == NodeType.WORKER and self._critical_workers:
            if -1 in self._critical_workers:  # "all"
                budget = self._critical_workers[-1]
            elif node.rank in self._critical_workers:
                budget = self._critical_workers[node.rank]
            else:
                return
            node.critical = True
            if budget is not None:
                node.max_relaunch_count = budget

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def list_nodes(self, node_type: str = "") -> List[Node]:
        with self._lock:
            return [
                n
                for n in self._nodes.values()
                if not node_type or n.type == node_type
            ]

    def alive_nodes(self) -> List[Node]:
        with self._lock:
            return [n for n in self._nodes.values() if n.is_alive()]

    def alive_workers(self, include_chief: bool = False) -> List[Node]:
        """Alive, NON-cordoned training workers. The cordon exclusion
        is deliberate and the default everywhere: a benched host is
        out of the training world — it must not count toward scaling
        capacity or the elastic floor, nor receive fleet broadcasts
        (its agent overloads RESTART_TRAINING as un-cordon)."""
        types = (
            (NodeType.WORKER, NodeType.CHIEF)
            if include_chief
            else (NodeType.WORKER,)
        )
        with self._lock:
            return [
                n
                for n in self._nodes.values()
                if n.type in types and n.is_alive() and not n.cordoned
            ]

    # Beats landing on a PENDING replacement within this window after
    # the relaunch are treated as last-gasp traffic from the agent
    # being replaced and dropped; a genuinely-alive agent (e.g. the
    # failure-report response was lost and it restarted in place)
    # keeps beating past the window, so the PENDING->RUNNING recovery
    # in check_nodes_once still fires for it. 2x the agent heartbeat
    # cadence (agent.py AgentConfig.heartbeat_interval=15).
    PENDING_HEARTBEAT_GRACE = 30.0

    def update_heartbeat(self, node_id: int) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            # Bound by the pending timeout so a short operator-set
            # timeout can never starve the PENDING->RUNNING recovery
            # of every heartbeat before it abandons the node.
            grace = min(
                self.PENDING_HEARTBEAT_GRACE, self._pending_timeout / 2
            )
            if (
                node.status == NodeStatus.PENDING
                and time.monotonic() - node.create_time < grace
            ):
                return
            node.update_heartbeat()

    # -- failure handling ---------------------------------------------------

    def classify_exit(self, error_data: str, level: str) -> str:
        if level == TrainingExceptionLevel.NODE_ERROR:
            return NodeExitReason.HARDWARE_ERROR
        text = (error_data or "").lower()
        # error_data carries raw stderr: match the whole token "oom"
        # plus the kernel/k8s killer spellings, but NOT every token
        # merely starting with "oom" ("oom_score_adj" appears in
        # ordinary procfs dumps of unrelated crashes).
        if (
            re.search(r"\boom\b|\boomkill", text)
            or "out of memory" in text
            or "resource_exhausted" in text
        ):
            return NodeExitReason.OOM
        # A PEER's death, not this node's: jax's coordination client
        # force-aborts every surviving task when another task dies,
        # with stderr that says the LEADER "was preempted/died" —
        # that describes the other task. Classifying the survivor as
        # PREEMPTED escalated to a node relaunch and the agent
        # stopped supervising, so a coordinator-host kill took the
        # whole job down (found by the alternating-victim soak
        # drill). The surviving node is healthy: restart in place and
        # re-rendezvous into the shrunken world.
        if (
            "jax distributed service detected fatal errors" in text
            or "another task died" in text
        ):
            # Only the specific abort fingerprints: a bare
            # "coordination service" mention could ride along in the
            # stderr of a GENUINELY preempted node and must not steal
            # its RELAUNCH_NODE classification.
            return NodeExitReason.KILLED
        if re.search(r"\bpreempt", text):
            return NodeExitReason.PREEMPTED
        return NodeExitReason.KILLED

    def handle_failure_report(
        self,
        node_id: int,
        error_data: str,
        level: str,
        restart_count: int,
        fatal: bool = False,
    ) -> str:
        """Returns the :class:`NodeAction` verdict, which the servicer
        sends back so agent and master never both own the restart.

        A non-fatal PROCESS_ERROR means the agent on that node is
        restarting the training process itself — the node (pod) is
        alive, so it must stay RUNNING here (ref: process restarts are
        agent-local, the master only replaces *nodes*,
        dist_job_manager.py:489).
        """
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return NodeAction.STOP
            # Idempotency: report RPCs are retried, so a duplicate of a
            # report we already acted on must not relaunch twice or
            # fail the replacement incarnation.
            if node.status == NodeStatus.PENDING:
                return NodeAction.RELAUNCH_NODE
            if node.status in NodeStatus.TERMINAL:
                return NodeAction.STOP
            node.exit_reason = self.classify_exit(error_data, level)
            # OOM and preemption escalate to a node relaunch (OOM pods
            # get grown resources in the reference,
            # resource/local_optimizer.py:96); plain app crashes are
            # retried in place by the agent.
            if (
                not fatal
                and level == TrainingExceptionLevel.PROCESS_ERROR
                and node.exit_reason
                not in (NodeExitReason.OOM, NodeExitReason.PREEMPTED)
            ):
                node.process_failure_count = restart_count + 1
                logger.warning(
                    "node %d training process failed; agent is "
                    "restarting it (count=%d)",
                    node_id,
                    node.process_failure_count,
                )
                return NodeAction.RESTART_IN_PLACE
            if fatal:
                node.exit_reason = NodeExitReason.FATAL_ERROR
            node.update_status(NodeStatus.FAILED)
            relaunch = node.should_relaunch()
            if relaunch:
                node.inc_relaunch_count()
            else:
                self._note_critical_loss(node)
        logger.warning(
            "node %d failed (%s, level=%s, fatal=%s) relaunch=%s",
            node_id,
            node.exit_reason,
            level,
            fatal,
            relaunch,
        )
        _NODE_EVENTS.inc(event="fail")
        obs.event(
            "node.fail",
            node_id=node_id, type=node.type,
            reason=node.exit_reason or "", relaunch=relaunch,
        )
        self._notify(node, NodeEventType.MODIFIED)
        if relaunch:
            self._relaunch(node)
            return NodeAction.RELAUNCH_NODE
        return NodeAction.STOP

    def _note_critical_loss(self, node: Node) -> None:
        """A node failed for good (budget exhausted / unrelaunchable).
        For critical roles that means the job cannot make progress:
        record the job-level failure for master.run to act on. Called
        under the lock."""
        if not node.critical or self._job_failure is not None:
            return
        self._job_failure = (
            JobExitReason.CRITICAL_NODE_FAILED,
            f"critical {node.type} node {node.id} (rank {node.rank}) "
            f"lost: {node.exit_reason or 'unknown'} after "
            f"{node.relaunch_count}/{node.max_relaunch_count} relaunches",
        )
        logger.error("job failed: %s", self._job_failure[1])

    def job_failed(self) -> bool:
        with self._lock:
            return self._job_failure is not None

    @property
    def job_failure(self) -> Optional[tuple]:
        return self._job_failure

    def _relaunch(self, node: Node) -> None:
        _RELAUNCHES.inc(reason=node.exit_reason or "unknown")
        obs.event(
            "node.relaunch",
            node_id=node.id, type=node.type,
            reason=node.exit_reason or "",
            relaunch_count=node.relaunch_count,
        )
        plan = ScalePlan()
        new_node = Node(
            type=node.type,
            id=node.id,
            rank=node.rank,
            status=NodeStatus.PENDING,
            config_resource=node.config_resource,
            relaunch_count=node.relaunch_count,
            max_relaunch_count=node.max_relaunch_count,
            relaunch_reason=node.exit_reason,
            critical=node.critical,
            # The cordon outlives the incarnation (same contract as
            # register_node): a benched host whose pod died must come
            # back benched, not rejoin next to its replacement.
            cordoned=node.cordoned,
        )
        # Track the new incarnation: the failed node is being replaced,
        # so the job is NOT done (all_workers_done must see PENDING).
        with self._lock:
            self._nodes[node.id] = new_node
        plan.launch_nodes.append(new_node)
        plan.remove_nodes.append(node)
        self._scaler.scale(plan)

    def handle_node_gone(self, node_id: int, reason: str = "") -> None:
        """A cluster event (pod failed/deleted/preempted) removed the
        node out from under us — the agent may never get to report.
        (ref: _process_event on DELETED, dist_job_manager.py:401)."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or node.status in NodeStatus.TERMINAL:
                return
            # The pod-Deleted event for a node we already relaunched
            # (the scaler removes the old pod as part of the plan)
            # must not fail the fresh PENDING replacement — same
            # duplicate guard as handle_failure_report.
            if node.status == NodeStatus.PENDING:
                return
            node.exit_reason = self.classify_exit(
                reason, TrainingExceptionLevel.PROCESS_ERROR
            )
            if "preempt" in (reason or "").lower():
                node.exit_reason = NodeExitReason.PREEMPTED
            node.update_status(NodeStatus.FAILED)
            relaunch = node.should_relaunch()
            if relaunch:
                node.inc_relaunch_count()
            else:
                self._note_critical_loss(node)
        logger.warning(
            "node %d gone (%s); relaunch=%s", node_id, reason, relaunch
        )
        _NODE_EVENTS.inc(event="gone")
        obs.event(
            "node.gone",
            node_id=node_id, type=node.type,
            reason=node.exit_reason or "", relaunch=relaunch,
        )
        self._notify(node, NodeEventType.DELETED)
        if relaunch:
            self._relaunch(node)

    # -- remediation seams (cordon / replace) -------------------------------

    def cordon_node(self, node_id: int, reason: str = "") -> bool:
        """Mark a live node cordoned: it stays alive (heartbeating,
        reversible) but leaves the rendezvous and stops counting
        toward the auto-scale target, so a replacement can be launched
        next to it. Returns False for unknown/dead/already-cordoned
        nodes (idempotent for replays)."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.is_alive() or node.cordoned:
                return False
            node.cordoned = True
        _NODE_EVENTS.inc(event="cordon")
        obs.event(
            "node.cordon",
            node_id=node_id, type=node.type, reason=reason,
        )
        logger.warning(
            "node %d cordoned (%s): excluded from rendezvous, "
            "replacement pending", node_id, reason or "remediation",
        )
        self._notify(node, NodeEventType.MODIFIED)
        return True

    def uncordon_node(self, node_id: int) -> bool:
        """Reverse a cordon (remediation rollback): the node counts
        toward the target again and may rejoin the rendezvous."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.cordoned:
                return False
            node.cordoned = False
        _NODE_EVENTS.inc(event="uncordon")
        obs.event("node.uncordon", node_id=node_id, type=node.type)
        logger.info("node %d un-cordoned", node_id)
        self._notify(node, NodeEventType.MODIFIED)
        return True

    def launch_replacement(
        self,
        node: Node,
        reason: str = "",
        node_id: Optional[int] = None,
    ) -> Optional[Node]:
        """Launch a fresh worker (new id/rank, copied resources) to
        stand in for ``node`` via a ScalePlan — the cordon-then-
        replace half-step: the old node is NOT removed here, so a
        failed probation can roll back by retiring the replacement
        instead. Returns the PENDING replacement node.

        ``node_id`` overrides the worker-sequence id for roles whose
        agents register under NAMESPACED ids (serving replicas,
        constants.replica_node_id): the arriving process must be able
        to claim the PENDING node, which it can only do when the
        launch used the id it will register with."""
        with self._lock:
            if node_id is not None:
                new_id = node_id
                # Namespaced ids must not drag the worker sequence
                # into their namespace (same rule as register_node).
                from dlrover_tpu_torch.common.constants import (
                    PS_NODE_ID_BASE,
                )

                if new_id < PS_NODE_ID_BASE:
                    self._next_node_id = max(
                        self._next_node_id, new_id + 1
                    )
            else:
                new_id = self._next_node_id
                self._next_node_id += 1
            resource = (
                NodeResource.from_dict(node.config_resource.to_dict())
                if node.config_resource is not None
                else NodeResource()
            )
            repl = Node(
                type=node.type,
                id=new_id,
                rank=new_id,
                status=NodeStatus.PENDING,
                config_resource=resource,
                max_relaunch_count=self._max_relaunch,
                relaunch_reason=reason,
                # The stand-in inherits the replaced node's role
                # labels: a replaced prefill replica must come back
                # a prefill replica, or the role fleet silently
                # changes shape under remediation.
                labels=dict(node.labels),
            )
            self._apply_role_policy(repl)
            # The stand-in inherits the replaced worker's criticality:
            # the rank-keyed critical_workers spec cannot see the new
            # rank, and losing the replacement past its budget must
            # fail the job exactly as losing the original would have.
            repl.critical = repl.critical or node.critical
            self._nodes[new_id] = repl
        plan = ScalePlan()
        plan.launch_nodes.append(repl)
        self._scaler.scale(plan)
        _NODE_EVENTS.inc(event="replace")
        obs.event(
            "node.replace",
            node_id=node.id, replacement_id=new_id, reason=reason,
        )
        logger.info(
            "launching replacement node %d for cordoned node %d (%s)",
            new_id, node.id, reason or "remediation",
        )
        self._notify(repl, NodeEventType.CREATED)
        return repl

    def retire_node(self, node_id: int) -> None:
        """Gracefully retire a node (drained PS, scale-in): DELETED
        through the normal transition path so listeners fire and
        finish_time is set, then the pod is removed."""
        with self._lock:
            node = self._nodes.get(node_id)
        if node is None:
            return
        node.relaunchable = False
        node.update_status(NodeStatus.DELETED)
        self._notify(node, NodeEventType.DELETED)
        plan = ScalePlan()
        plan.remove_nodes.append(node)
        self.scaler.scale(plan)

    def handle_node_succeeded(self, node_id: int) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.update_status(NodeStatus.SUCCEEDED)
        if node is not None:
            _NODE_EVENTS.inc(event="succeeded")
            self._notify(node, NodeEventType.MODIFIED)

    # -- hang watchdog ------------------------------------------------------

    def start(self) -> None:
        if self._monitor_thread is not None:
            return
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="node-monitor", daemon=True
        )
        self._monitor_thread.start()

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self._monitor_interval):
            self.check_nodes_once()

    def check_nodes_once(self) -> None:
        """One watchdog pass: heartbeat + pending timeouts. All
        stamps involved (create_time / heartbeat_time) are monotonic,
        set on this master — a wall-clock step cannot fire or mask a
        timeout."""
        now = time.monotonic()
        dead: List[Node] = []
        with self._lock:
            for node in self._nodes.values():
                if (
                    node.is_alive()
                    and node.heartbeat_time > 0
                    and now - node.heartbeat_time
                    > self._heartbeat_timeout
                ):
                    node.exit_reason = NodeExitReason.KILLED
                    node.update_status(NodeStatus.FAILED)
                    dead.append(node)
                elif (
                    node.status == NodeStatus.PENDING
                    and node.heartbeat_time > 0
                    and now - node.heartbeat_time
                    < self._heartbeat_timeout
                ):
                    # The node is alive and talking to us even though
                    # no status report arrived (e.g. the failure-report
                    # response was lost and the agent restarted in
                    # place): a heartbeating node is RUNNING, not a
                    # stuck replacement to abandon.
                    node.update_status(NodeStatus.RUNNING)
                    logger.info(
                        "pending node %d is heartbeating; marking "
                        "RUNNING", node.id,
                    )
                elif (
                    node.status == NodeStatus.PENDING
                    and now - node.create_time > self._pending_timeout
                ):
                    # A replacement that never came up (or a scaler
                    # that cannot launch, e.g. local mode): abandon it
                    # so all_workers_done() can complete the job
                    # (ref: seconds_to_wait_pending_pod=900).
                    node.exit_reason = JobExitReason.PENDING_TIMEOUT
                    node.relaunchable = False
                    node.update_status(NodeStatus.FAILED)
                    # Only a replacement for a previously-running node
                    # counts as a critical LOSS: an initial schedule
                    # that never materialized (e.g. a platform that
                    # cannot launch evaluators) leaves the job exactly
                    # as it was, so it must not fail a healthy run.
                    if node.relaunch_count > 0:
                        self._note_critical_loss(node)
                    logger.warning(
                        "node %d pending for >%ss; abandoning",
                        node.id,
                        self._pending_timeout,
                    )
        for node in dead:
            logger.warning(
                "node %d heartbeat timeout (>%ss); treating as dead",
                node.id,
                self._heartbeat_timeout,
            )
            _NODE_EVENTS.inc(event="heartbeat_timeout")
            obs.event(
                "node.heartbeat_timeout",
                node_id=node.id, type=node.type,
                timeout_s=self._heartbeat_timeout,
            )
            self._notify(node, NodeEventType.DELETED)
            if node.should_relaunch():
                node.inc_relaunch_count()
                self._relaunch(node)
            else:
                with self._lock:
                    self._note_critical_loss(node)

    def stop(self) -> None:
        self._stop.set()

    # -- warm-restart snapshot ----------------------------------------------

    # Node fields that are process-local clocks: meaningless (and
    # dangerous — instant heartbeat timeout) in a new master process.
    _CLOCK_FIELDS = ("create_time", "heartbeat_time")

    def to_snapshot(self) -> dict:
        """JSON-safe recoverable state: the node table (minus
        process-local monotonic clocks) + relaunch/failure facts."""
        with self._lock:
            nodes = []
            for node in self._nodes.values():
                d = node.to_dict()
                for f in self._CLOCK_FIELDS:
                    d.pop(f, None)
                # start/finish are wall stamps but carry no decisions;
                # drop them too so a restored node is visibly fresh.
                d.pop("start_time", None)
                d.pop("finish_time", None)
                nodes.append(d)
            return {
                "nodes": nodes,
                "next_node_id": self._next_node_id,
                "job_failure": (
                    list(self._job_failure)
                    if self._job_failure is not None else None
                ),
            }

    def restore_snapshot(self, state: dict) -> None:
        """Rebuild the node table from a snapshot. Clocks restart from
        'now': every restored alive node gets a fresh heartbeat stamp,
        so agents have a full heartbeat_timeout to reconnect before
        the watchdog declares them dead (the outage already cost them
        their cadence — the old stamps would kill the whole fleet on
        the first sweep)."""
        with self._lock:
            self._nodes = {}
            for d in state.get("nodes", []):
                node = Node.from_dict(d)
                if node.is_alive():
                    node.update_heartbeat()
                self._nodes[node.id] = node
            self._next_node_id = int(
                state.get("next_node_id", len(self._nodes))
            )
            failure = state.get("job_failure")
            self._job_failure = tuple(failure) if failure else None

    def all_workers_done(self) -> bool:
        """All training nodes (workers AND chiefs) reached a terminal
        state. Evaluators do not gate completion — they follow the
        training fleet and are retired by the master when it ends
        (ref: the estimator evaluator is stopped when the chief
        finishes)."""
        with self._lock:
            training = [
                n
                for n in self._nodes.values()
                if n.type in (NodeType.WORKER, NodeType.CHIEF)
            ]
            if not training:
                return False
            return all(n.status in NodeStatus.TERMINAL for n in training)

    # -- role-aware queries and scheduling ----------------------------------

    def _grant_headroom_locked(self) -> Optional[int]:
        if self.pool_grant is None:
            return None
        alive = sum(
            1 for n in self._nodes.values() if n.is_alive()
        )
        return max(self.pool_grant - alive, 0)

    def grant_headroom(self) -> Optional[int]:
        """Alive-node headroom left inside this job's pool grant
        (None = no pool, unlimited). Cordoned nodes still count:
        they hold their host until retired, so a replacement needs
        real headroom, not a benched slot."""
        with self._lock:
            return self._grant_headroom_locked()

    def is_chief_running(self) -> bool:
        """Whether any chief node is RUNNING (PS-strategy trainers wait
        for the chief to initialize shared state before stepping)."""
        with self._lock:
            return any(
                n.type == NodeType.CHIEF
                and n.status == NodeStatus.RUNNING
                for n in self._nodes.values()
            )

    def ensure_role(
        self,
        node_type: str,
        count: int,
        resource: Optional[NodeResource] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> List[Node]:
        """Schedule nodes so ``count`` of ``node_type`` are alive.

        The master's way to ask the platform for role nodes the job
        spec wants but no agent has registered yet — e.g. a standalone
        evaluator the trainer's evaluate loop will attach to. Returns
        the newly launched (PENDING) nodes; no-op if enough are alive.

        ``labels`` scopes the target to the matching label set (the
        serving plane's per-role autoscaling: prefill and decode
        replica counts are independent targets within one node type).
        Launched nodes carry the labels; alive nodes of the type with
        DIFFERENT labels neither count toward the target nor have
        their ids reused.
        """
        from dlrover_tpu_torch.common.constants import (
            evaluator_node_id,
            ps_node_id,
            replica_node_id,
        )

        # Role-namespaced ids (same scheme the agents use on their
        # RPCs) so the arriving agent claims the PENDING node instead
        # of colliding with a worker rank.
        role_id = {
            NodeType.EVALUATOR: evaluator_node_id,
            NodeType.EMBEDDING: ps_node_id,
            NodeType.REPLICA: replica_node_id,
        }.get(node_type)

        plan = ScalePlan()
        launched: List[Node] = []
        capped = False
        with self._lock:
            headroom = self._grant_headroom_locked()

            def _matches(n: Node) -> bool:
                if n.type != node_type or not n.is_alive():
                    return False
                if labels:
                    return all(
                        n.labels.get(k) == v
                        for k, v in labels.items()
                    )
                return True

            alive = sum(
                1 for n in self._nodes.values() if _matches(n)
            )
            # The id scan must reach past indices occupied by alive
            # same-type nodes of OTHER label sets (a labeled call
            # skips them without counting them toward its target).
            same_type_alive = sum(
                1
                for n in self._nodes.values()
                if n.type == node_type and n.is_alive()
            )
            scan = count + (
                same_type_alive if role_id is not None else 0
            )
            for index in range(scan):
                if alive + len(launched) >= count:
                    break
                if headroom is not None and len(launched) >= headroom:
                    # Pool grant exhausted: scale intents beyond the
                    # grant are dropped, not queued — the caller
                    # (serving autoscaler, evaluator schedule) will
                    # re-ask when the pool grows the grant.
                    capped = True
                    break
                if role_id is not None:
                    node_id = role_id(index)
                    existing = self._nodes.get(node_id)
                    if existing is not None and existing.is_alive():
                        continue
                    rank = index
                else:
                    node_id = self._next_node_id
                    self._next_node_id += 1
                    rank = node_id
                node = Node(
                    type=node_type,
                    id=node_id,
                    rank=rank,
                    status=NodeStatus.PENDING,
                    config_resource=resource or NodeResource(),
                    max_relaunch_count=self._max_relaunch,
                    labels=dict(labels or {}),
                )
                self._apply_role_policy(node)
                self._nodes[node.id] = node
                plan.launch_nodes.append(node)
                launched.append(node)
        if capped:
            obs.event(
                "pool.grant_capped",
                role=node_type, want=count, grant=self.pool_grant,
            )
            logger.warning(
                "ensure_role(%s, %d) capped by pool grant %s "
                "(launched %d)",
                node_type, count, self.pool_grant, len(launched),
            )
        if not plan.empty():
            self._scaler.scale(plan)
        for node in launched:
            self._notify(node, NodeEventType.CREATED)
        return launched

    def retire_role(self, node_type: str) -> None:
        """Scale a whole role out (e.g. evaluators once training is
        done) through the normal retirement path."""
        for node in self.list_nodes(node_type):
            if node.is_alive():
                self.retire_node(node.id)

    def terminate_job(self) -> None:
        """Tear the whole fleet down (job-level failure): every alive
        node is retired so the platform reclaims its pods instead of
        leaving them training against a dead master."""
        for node in self.list_nodes():
            if node.is_alive():
                self.retire_node(node.id)
