"""Master-side rendezvous managers.

Behavior parity with the reference's rendezvous layer
(dlrover/python/master/elastic_training/rdzv_manager.py:113,272,351):

* ``ElasticRendezvous`` — collects joining hosts, freezes a
  communication world once ``max_nodes`` joined or ``min_nodes`` joined
  and the waiting timeout elapsed, rounded down to a multiple of
  ``node_unit`` (a TPU *pod-slice host group*: worlds must be a whole
  number of slices for the ICI mesh to be rectangular).
* ``NetworkCheckRendezvous`` — two-round pairwise health check: round 0
  pairs neighbors, round 1 re-pairs sorted-by-time so a failing pair is
  disambiguated; stragglers are nodes slower than 2x the median.

On TPU the "world" handed back is used to (re)build the
``jax.distributed`` bootstrap (coordinator + process ids), and the
health-check payload is a small psum/all-gather over ICI rather than a
NCCL allgather.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("rendezvous")

_RDZV_ROUNDS = obs.counter(
    "dlrover_rendezvous_rounds_total",
    "Completed rendezvous rounds",
    ("name",),
)
_RDZV_WORLD = obs.gauge(
    "dlrover_rendezvous_world_size",
    "Node count of the most recently frozen world",
    ("name",),
)
_RDZV_SECONDS = obs.histogram(
    "dlrover_rendezvous_seconds",
    "Wall time from first join to world freeze",
    ("name",),
)


class RendezvousParameters:
    def __init__(
        self,
        min_nodes: int = 0,
        max_nodes: int = 0,
        waiting_timeout: float = 30.0,
        node_unit: int = 1,
    ):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = waiting_timeout
        self.node_unit = node_unit


class RendezvousManagerBase:
    """Shared join/freeze logic for both rendezvous flavors."""

    name: str = ""

    def __init__(self):
        self._lock = threading.Lock()
        self._params = RendezvousParameters()
        # node_rank -> local_world_size, nodes waiting for the next round
        self._waiting_nodes: Dict[int, int] = {}
        # frozen world for the current round
        self._rdzv_nodes: Dict[int, int] = {}
        self._latest_rdzv_nodes: List[int] = []
        self._alive_nodes: Set[int] = set()
        self._rdzv_round = 0
        # Monotonic stamps (waiting-timeout / elapsed arithmetic must
        # not move when NTP steps the wall clock); 0.0 = unset.
        self._lastcall_time = 0.0
        self._start_rdzv_time = 0.0
        # Fired outside the lock after membership/world changes; the
        # JobMaster points this at the state journal.
        self.on_state_change = None
        # Distributed tracing: one trace per rendezvous round. The
        # JobMaster points trace_sink at its TraceStore; the round's
        # start -> freeze interval lands there as one rdzv.round span
        # and the round events carry its trace id.
        self.trace_sink = None
        self._round_trace = None  # obs.tracer.TraceContext | None
        self._round_start_wall = 0.0

    def _changed(self) -> None:
        cb = self.on_state_change
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001
                pass

    def update_params(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float = 30.0,
        node_unit: int = 1,
    ) -> None:
        with self._lock:
            if self._params.max_nodes == 0:
                self._params = RendezvousParameters(
                    min_nodes, max_nodes, waiting_timeout, node_unit
                )

    @property
    def round(self) -> int:
        return self._rdzv_round

    def add_alive_node(self, node_id: int) -> None:
        with self._lock:
            self._alive_nodes.add(node_id)

    def remove_alive_node(self, node_id: int, node_rank: int = -1) -> None:
        with self._lock:
            self._alive_nodes.discard(node_id)
            rank = node_rank if node_rank >= 0 else node_id
            self._waiting_nodes.pop(rank, None)

    def join(self, node_rank: int, local_world_size: int) -> int:
        """Add a node to the waiting list; returns the round index."""
        joined = False
        with self._lock:
            if not self._waiting_nodes:
                self._start_rdzv_time = time.monotonic()
                logger.info(
                    "%s: start round %d rendezvous",
                    self.name,
                    self._rdzv_round,
                )
            if self._round_trace is None:
                # Round boundary, which is NOT always an empty
                # waiting set: a freeze that leaves surplus waiters
                # behind seeds the next round non-empty, and that
                # churn round must be traced too.
                from dlrover_tpu_torch.obs import tracer as _trace

                self._round_start_wall = time.time()
                self._round_trace = _trace.new_trace_context()
                obs.event(
                    "rdzv.start",
                    rdzv=self.name, round=self._rdzv_round,
                    trace_id=self._round_trace.trace_id,
                    parent_span_id=self._round_trace.span_id,
                )
            if node_rank not in self._waiting_nodes:
                self._waiting_nodes[node_rank] = local_world_size
                # Only a returning member of the frozen world invalidates
                # it (it restarted, so the old world is dead). A brand-new
                # node must NOT wipe the world other members are still
                # fetching — it waits for the next round, which agents
                # enter once num_nodes_waiting() tells them to restart.
                if node_rank in self._latest_rdzv_nodes:
                    self._rdzv_nodes = {}
                self._lastcall_time = time.monotonic()
                joined = True
            round_ = self._rdzv_round
        if joined:
            self._changed()
        return round_

    def _try_complete(self) -> bool:
        """Freeze the world when enough nodes joined. Caller holds lock."""
        waiting_num = len(self._waiting_nodes)
        completed = False
        if waiting_num >= self._params.max_nodes and waiting_num > 0:
            # Never freeze a world larger than max_nodes.
            waiting_num = self._params.max_nodes
            completed = True
        elif (
            waiting_num > 0
            and time.monotonic() - self._lastcall_time
            >= self._params.waiting_timeout
        ):
            # Round down to whole node_units (slices) FIRST, then check
            # the minimum — a rounded-down world below min_nodes is not
            # a viable job and must keep waiting.
            waiting_num = (
                waiting_num // self._params.node_unit
            ) * self._params.node_unit
            if waiting_num >= self._params.min_nodes and waiting_num > 0:
                completed = True
            else:
                return False
        if completed:
            ranks = sorted(self._waiting_nodes.keys())[:waiting_num]
            self._rdzv_nodes = {r: self._waiting_nodes[r] for r in ranks}
            self._latest_rdzv_nodes = list(self._rdzv_nodes.keys())
            for r in ranks:
                self._waiting_nodes.pop(r, None)
            self._lastcall_time = 0.0
            elapsed = time.monotonic() - self._start_rdzv_time
            logger.info(
                "%s: round %d completed with %d nodes in %.2fs; "
                "left waiting: %s",
                self.name,
                self._rdzv_round,
                len(self._rdzv_nodes),
                elapsed,
                self._waiting_nodes,
            )
            _RDZV_ROUNDS.inc(name=self.name)
            _RDZV_WORLD.set(len(self._rdzv_nodes), name=self.name)
            _RDZV_SECONDS.observe(elapsed, name=self.name)
            trace = self._round_trace
            obs.event(
                "rdzv.complete",
                rdzv=self.name, round=self._rdzv_round,
                world_size=len(self._rdzv_nodes),
                elapsed_s=round(elapsed, 3),
                **(
                    {
                        "trace_id": trace.trace_id,
                        "parent_span_id": trace.span_id,
                    }
                    if trace is not None
                    else {}
                ),
            )
            if trace is not None and self.trace_sink is not None:
                self.trace_sink.add_span(
                    trace.trace_id,
                    "rdzv.round",
                    self._round_start_wall or time.time() - elapsed,
                    dur_s=elapsed,
                    span_id=trace.span_id,
                    subject=f"rdzv:{self.name}",
                    rdzv=self.name,
                    round=self._rdzv_round,
                    world_size=len(self._rdzv_nodes),
                )
            self._round_trace = None
        return completed

    # -- warm-restart snapshot ----------------------------------------------

    def to_snapshot(self) -> dict:
        """JSON-safe recoverable state: round, frozen world, pending
        waiters, alive set. Timer stamps are deliberately NOT included
        (monotonic clocks do not survive a process) — restore restarts
        the waiting timeout from 'now'."""
        with self._lock:
            return {
                "round": self._rdzv_round,
                "waiting_nodes": {
                    str(k): v for k, v in self._waiting_nodes.items()
                },
                "rdzv_nodes": {
                    str(k): v for k, v in self._rdzv_nodes.items()
                },
                "latest_rdzv_nodes": list(self._latest_rdzv_nodes),
                "alive_nodes": sorted(self._alive_nodes),
            }

    def restore_snapshot(self, state: dict) -> None:
        with self._lock:
            self._rdzv_round = int(state.get("round", 0))
            self._waiting_nodes = {
                int(k): int(v)
                for k, v in state.get("waiting_nodes", {}).items()
            }
            self._rdzv_nodes = {
                int(k): int(v)
                for k, v in state.get("rdzv_nodes", {}).items()
            }
            self._latest_rdzv_nodes = [
                int(r) for r in state.get("latest_rdzv_nodes", [])
            ]
            self._alive_nodes = {
                int(n) for n in state.get("alive_nodes", [])
            }
            now = time.monotonic()
            # Fresh clocks: the waiting timeout restarts from the
            # warm restart, not from a dead process's monotonic era.
            self._lastcall_time = now if self._waiting_nodes else 0.0
            self._start_rdzv_time = now

    def num_nodes_waiting(self) -> int:
        """Nonzero return tells agents to restart for re-rendezvous.

        A returning member (restart) triggers immediately; brand-new
        nodes only once a whole node_unit (slice) of them is ready.
        """
        with self._lock:
            for rank in self._waiting_nodes:
                if rank in self._latest_rdzv_nodes:
                    return len(self._waiting_nodes)
            if len(self._waiting_nodes) >= self._params.node_unit:
                return len(self._waiting_nodes)
            return 0


class ElasticRendezvous(RendezvousManagerBase):
    """Rendezvous for the training world."""

    name = RendezvousName.TRAINING

    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int]]:
        completed = False
        with self._lock:
            if not self._rdzv_nodes:
                if self._try_complete():
                    self._rdzv_round += 1
                    completed = True
            result = self._rdzv_round, 0, dict(self._rdzv_nodes)
        if completed:
            self._changed()
        return result


class NetworkCheckRendezvous(RendezvousManagerBase):
    """Two-round pairwise health-check rendezvous.

    Round even: pair adjacent nodes — each pair runs the check payload
    (psum + matmul benchmark) over ICI/DCN. Round odd: re-pair fastest
    with slowest so a node that failed in a bad pair gets a known-good
    partner; a node failing both rounds is faulty.
    """

    name = RendezvousName.NETWORK_CHECK
    CHECK_ROUNDS = 2

    def __init__(self):
        super().__init__()
        self._node_status: Dict[int, bool] = {}
        self._node_times: Dict[int, float] = {}
        self._reported_nodes: Set[int] = set()
        self._node_groups: List[Dict[int, int]] = []
        self._fault_nodes: Set[int] = set()
        self._straggler_nodes: Set[int] = set()
        self._verdict_done = False

    def join(self, node_rank: int, local_world_size: int) -> int:
        with self._lock:
            self._node_groups.clear()
        return super().join(node_rank, local_world_size)

    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int]]:
        with self._lock:
            if not self._node_groups:
                if self._try_complete():
                    self._fault_nodes.clear()
                    self._straggler_nodes.clear()
                    self._verdict_done = False
                    self._node_groups = self._group_nodes(self._rdzv_round)
                    logger.info(
                        "network-check round %d groups: %s",
                        self._rdzv_round,
                        self._node_groups,
                    )
                    if self._rdzv_round % self.CHECK_ROUNDS == 0:
                        self._node_status = {}
                        self._node_times = {}
                    self._reported_nodes = set()
                    self._rdzv_round += 1
            for i, group in enumerate(self._node_groups):
                if node_rank in group:
                    return self._rdzv_round, i, dict(group)
            return self._rdzv_round, 0, dict(self._rdzv_nodes)

    def _group_nodes(self, rdzv_round: int) -> List[Dict[int, int]]:
        phase = rdzv_round % self.CHECK_ROUNDS
        groups: List[Dict[int, int]] = []
        if phase == 0:
            # Adjacent pairs; odd node out merges into the last group.
            group: Dict[int, int] = {}
            for rank, lws in sorted(self._rdzv_nodes.items()):
                group[rank] = lws
                if len(group) == 2:
                    groups.append(group)
                    group = {}
            if group:
                if groups:
                    groups[-1].update(group)
                else:
                    groups.append(group)
        else:
            # Pair fastest with slowest from the previous round.
            ordered = [
                rank
                for rank, _ in sorted(
                    self._node_times.items(), key=lambda kv: kv[1]
                )
                if rank in self._rdzv_nodes
            ]
            # Nodes that never reported go in at the end (suspect).
            for rank in sorted(self._rdzv_nodes):
                if rank not in ordered:
                    ordered.append(rank)
            left, right = 0, len(ordered) - 1
            group = {}
            while right >= left:
                group = {}
                group[ordered[left]] = self._rdzv_nodes[ordered[left]]
                group[ordered[right]] = self._rdzv_nodes[ordered[right]]
                if len(group) == 2:
                    groups.append(group)
                left += 1
                right -= 1
            if len(group) == 1:
                if groups:
                    groups[-1].update(group)
                else:
                    groups.append(group)
        return groups

    def report_result(
        self, node_rank: int, normal: bool, elapsed_time: float
    ) -> None:
        with self._lock:
            self._reported_nodes.add(node_rank)
            # Health is sticky-pass across the paired rounds — one bad
            # round may be the partner's fault, so passing anywhere
            # wins — and a node's representative cost is its best time.
            self._node_status[node_rank] = normal or self._node_status.get(
                node_rank, False
            )
            self._node_times[node_rank] = round(
                min(
                    self._node_times.get(node_rank, math.inf),
                    elapsed_time,
                ),
                3,
            )

    def _round_verdict(self) -> bool:
        """Classify the check round once all reports are in. Returns
        False while reports are outstanding.

        Verdict rules: a node whose sticky status never turned healthy
        is faulty; a node slower than twice the median best-time is a
        straggler; and a fully clean fleet fast-forwards the round
        counter to the next CHECK_ROUNDS boundary, so the next check
        request opens a fresh pair of rounds instead of replaying the
        tail of this one. Evaluated at most once per check round (the
        next ``get_comm_world`` completion re-arms it)."""
        if len(self._reported_nodes) < len(self._rdzv_nodes):
            return False
        if not self._verdict_done:
            self._verdict_done = True
            self._fault_nodes.update(
                rank
                for rank, healthy in self._node_status.items()
                if not healthy
            )
            self._straggler_nodes.update(self._slow_outliers())
            if not (self._fault_nodes or self._straggler_nodes):
                self._rdzv_round += -self._rdzv_round % self.CHECK_ROUNDS
        return True

    def check_fault_nodes(self) -> Tuple[List[int], str]:
        """Return ([fault ranks], reason). reason='waiting' while nodes
        are still reporting."""
        with self._lock:
            if not self._round_verdict():
                return [], "waiting"
            reason = "fault" if self._fault_nodes else ""
            return sorted(self._fault_nodes), reason

    def get_stragglers(self) -> Tuple[List[int], str]:
        with self._lock:
            if not self._round_verdict():
                return [], "waiting"
            return sorted(self._straggler_nodes), ""

    def _slow_outliers(self) -> Dict[int, float]:
        """Nodes whose best check time exceeds twice the fleet median."""
        if not self._node_times:
            return {}
        cutoff = 2 * statistics.median(self._node_times.values())
        return {
            rank: t
            for rank, t in self._node_times.items()
            if t > cutoff
        }
