"""Node model and status state machine.

Parity with the reference's node model (dlrover/python/common/node.py:336
`Node`) and status flow (dlrover/python/master/node/status_flow.py), with
TPU-native resources: a node is a *host* of a TPU pod slice owning
``chips`` accelerator chips, not a GPU pod.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
)


@dataclasses.dataclass
class NodeResource:
    """Resources of one host in the job."""

    cpu: float = 0.0
    memory_mb: int = 0
    # TPU chips attached to this host (4 for a v5p host, 8 for v5e-8, ...)
    chips: int = 0
    tpu_type: str = ""  # e.g. "v5p", "v5e"
    # Which TPU slice of a multi-slice job this host belongs to; the
    # scaler keeps replacements in the dead host's slice so the DCN
    # mesh axis stays balanced. -1 = single-slice job (no slice pin in
    # the pod manifest — pinning slice "0" on an unlabeled cluster
    # would leave every pod unschedulable).
    slice_id: int = -1
    # Utilisation telemetry filled in by the agent's resource monitor.
    used_cpu: float = 0.0
    used_memory_mb: int = 0
    hbm_used_gb: float = 0.0
    duty_cycle: float = 0.0  # TPU tensorcore duty cycle [0, 1]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "NodeResource":
        return cls(**{k: v for k, v in d.items() if k in _RESOURCE_FIELDS})


_RESOURCE_FIELDS = {f.name for f in dataclasses.fields(NodeResource)}


# Legal status transitions. Anything not listed here is an error except
# transitions to the same status (idempotent) which are silently allowed.
_VALID_TRANSITIONS = {
    NodeStatus.INITIAL: {
        NodeStatus.PENDING,
        NodeStatus.RUNNING,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
    },
    NodeStatus.PENDING: {
        NodeStatus.RUNNING,
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.BREAKDOWN,
    },
    NodeStatus.RUNNING: {
        NodeStatus.SUCCEEDED,
        NodeStatus.FAILED,
        NodeStatus.DELETED,
        NodeStatus.BREAKDOWN,
    },
    NodeStatus.SUCCEEDED: {NodeStatus.DELETED},
    NodeStatus.FAILED: {NodeStatus.DELETED},
    NodeStatus.BREAKDOWN: {NodeStatus.DELETED},
    NodeStatus.DELETED: set(),
}


def is_valid_transition(old: str, new: str) -> bool:
    if old == new:
        return True
    return new in _VALID_TRANSITIONS.get(old, set())


@dataclasses.dataclass
class Node:
    """One host participating in a job, as tracked by the master."""

    type: str
    id: int
    rank: int = -1
    name: str = ""
    status: str = NodeStatus.INITIAL
    host_addr: str = ""
    config_resource: Optional[NodeResource] = None
    used_resource: Optional[NodeResource] = None
    create_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    relaunch_count: int = 0
    max_relaunch_count: int = 3
    # Training-process failures handled by the node's own agent (the
    # node stayed up; only the process inside restarted).
    process_failure_count: int = 0
    relaunchable: bool = True
    is_released: bool = False
    exit_reason: str = ""
    # Why the previous incarnation died (set on the replacement by
    # _relaunch): lets the auto-scaler grow resources for OOM retries.
    relaunch_reason: str = ""
    critical: bool = False
    heartbeat_time: float = 0.0
    # Straggler / health flags set by the network-check rendezvous.
    is_straggler: bool = False
    is_unhealthy: bool = False
    # Cordoned by the remediation engine: alive and heartbeating, but
    # excluded from rendezvous and not counted toward the auto-scale
    # target (its replacement is); retired once probation confirms
    # recovery, un-cordoned on rollback.
    cordoned: bool = False
    # Role labels (e.g. a serving replica's serving_role): set at
    # registration or by a labeled ensure_role launch; the labeled
    # ensure_role seam counts alive nodes per label set so each role
    # scales independently. Rides node-table snapshots like any
    # field.
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.config_resource is None:
            self.config_resource = NodeResource()
        if self.create_time == 0.0:
            # Monotonic: only ever compared against other monotonic
            # stamps on the same master (pending/heartbeat timeout
            # sweeps) — an NTP step must not fire or mask a timeout.
            self.create_time = time.monotonic()

    def update_status(self, new_status: str) -> bool:
        """Apply a status transition; returns True if state changed."""
        if new_status == self.status:
            return False
        if not is_valid_transition(self.status, new_status):
            return False
        self.status = new_status
        now = time.time()
        if new_status == NodeStatus.RUNNING and self.start_time == 0.0:
            self.start_time = now
        if new_status in NodeStatus.TERMINAL:
            self.finish_time = now
        return True

    def inc_relaunch_count(self) -> None:
        self.relaunch_count += 1

    def exhausted_relaunch(self) -> bool:
        return self.relaunch_count >= self.max_relaunch_count

    def should_relaunch(self) -> bool:
        """Relaunch policy on failure (ref: dist_job_manager.py:489)."""
        if not self.relaunchable or self.is_released:
            return False
        if self.exit_reason in NodeExitReason.NO_RELAUNCH:
            return False
        return not self.exhausted_relaunch()

    def is_alive(self) -> bool:
        return self.status in NodeStatus.ALIVE

    def update_heartbeat(self) -> None:
        self.heartbeat_time = time.monotonic()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        d = dict(d)
        if isinstance(d.get("config_resource"), dict):
            d["config_resource"] = NodeResource.from_dict(d["config_resource"])
        if isinstance(d.get("used_resource"), dict):
            d["used_resource"] = NodeResource.from_dict(d["used_resource"])
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
