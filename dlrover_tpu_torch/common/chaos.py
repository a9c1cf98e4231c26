"""Deterministic, seeded control-plane fault injector.

The chaos harness exists so the control plane's survivability claims
(master warm restart, reconnecting agents) are *continuously* proven
under injected faults instead of asserted once. It is wired into the
RPC transport (``common/comm.py``): the client side can drop requests,
add latency, or substitute transport errors; the server side can kill
the master process when the Nth request of a given type arrives —
which is how the failover drills schedule "master dies mid-sharded-run"
without racing on wall time.

Design constraints:

* **Deterministic from a seed.** All randomness flows from one
  ``random.Random(seed)`` drawn in a fixed per-call pattern under a
  lock, so the same seed and call sequence produce the same fault
  schedule (asserted by tests/test_master_failover.py). The drawn
  decisions are kept in a bounded ``decisions`` log for drills to
  diff.
* **Env-gated and zero-cost when off.** Nothing is injected unless
  ``DLROVER_TPU_CHAOS=1``; the comm-layer hook is a module-level
  None-check.
* **Faults look like real faults.** Drops and partitions raise
  :class:`ChaosDropError` (a ``ConnectionError``), which the agent's
  connection supervisor classifies as *transient* — exactly like a
  dead master — so chaos exercises the same reconnect machinery a
  real outage does.
"""

from __future__ import annotations

import collections
import os
import random
import sys
import threading
import time
from typing import Deque, Optional, Sequence, Tuple

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("chaos")

CHAOS_ENV = "DLROVER_TPU_CHAOS"
SEED_ENV = "DLROVER_TPU_CHAOS_SEED"
DROP_RATE_ENV = "DLROVER_TPU_CHAOS_DROP_RATE"
ERROR_RATE_ENV = "DLROVER_TPU_CHAOS_ERROR_RATE"
LATENCY_MS_ENV = "DLROVER_TPU_CHAOS_LATENCY_MS"
PARTITION_NODES_ENV = "DLROVER_TPU_CHAOS_PARTITION_NODES"
# Server-side: "MessageTypeName:N" — _exit the process when the Nth
# request of that type is dispatched (N counts from 1).
KILL_AT_ENV = "DLROVER_TPU_CHAOS_KILL_AT"
# Which RPC plane client-side faults apply to: "all" (default),
# "master" (agent<->master control plane only) or "ps" (trainer<->PS
# data plane only — Ps* request types). Out-of-scope calls still draw
# from the RNG so the fault schedule of in-scope calls is unchanged
# by scoping (same seed => same decisions at the same call indices).
SCOPE_ENV = "DLROVER_TPU_CHAOS_SCOPE"

# Exit code for a chaos-scheduled master kill: distinguishable from
# OOM (137) and ordinary failures in drill logs.
KILL_EXIT_CODE = 43


class ChaosDropError(ConnectionError):
    """A chaos-injected request drop / partition.

    Subclasses ``ConnectionError`` so the reconnect supervisor's
    transient-error classification treats it like a real dead socket.
    """


class ChaosPartitionError(ChaosDropError):
    """This node is chaos-partitioned from the master."""


class ChaosInjector:
    """One injector per process; decisions are drawn serially.

    ``node_id`` identifies the local node for partition checks (None
    = read ``DLROVER_TPU_NODE_ID`` lazily, so the injector can be
    built before the agent env is final).
    """

    MAX_DECISIONS = 10000

    def __init__(
        self,
        seed: int = 0,
        drop_rate: float = 0.0,
        error_rate: float = 0.0,
        latency_ms: float = 0.0,
        partition_nodes: Sequence[int] = (),
        kill_at: Optional[Tuple[str, int]] = None,
        node_id: Optional[int] = None,
        scope: str = "all",
    ):
        self.seed = seed
        self.drop_rate = drop_rate
        self.error_rate = error_rate
        self.latency_ms = latency_ms
        self.partition_nodes = frozenset(int(n) for n in partition_nodes)
        self.kill_at = kill_at
        if scope not in ("all", "master", "ps"):
            raise ValueError(
                f"chaos scope must be all|master|ps, got {scope!r}"
            )
        self.scope = scope
        self._node_id = node_id
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._calls = 0
        self._server_counts: dict = {}
        #: (call_index, method, decision) log, bounded; drills diff it
        #: across runs to prove seed-reproducibility.
        self.decisions: Deque[Tuple[int, str, str]] = collections.deque(
            maxlen=self.MAX_DECISIONS
        )

    @classmethod
    def from_env(cls, environ=os.environ) -> "ChaosInjector":
        kill_at = None
        raw = environ.get(KILL_AT_ENV, "")
        if raw:
            name, _, count = raw.partition(":")
            kill_at = (name.strip(), int(count) if count else 1)
        nodes = [
            int(p)
            for p in environ.get(PARTITION_NODES_ENV, "").split(",")
            if p.strip()
        ]
        return cls(
            seed=int(environ.get(SEED_ENV, "0") or 0),
            drop_rate=float(environ.get(DROP_RATE_ENV, "0") or 0),
            error_rate=float(environ.get(ERROR_RATE_ENV, "0") or 0),
            latency_ms=float(environ.get(LATENCY_MS_ENV, "0") or 0),
            partition_nodes=nodes,
            kill_at=kill_at,
            scope=environ.get(SCOPE_ENV, "all") or "all",
        )

    def _local_node_id(self) -> Optional[int]:
        if self._node_id is not None:
            return self._node_id
        raw = os.getenv("DLROVER_TPU_NODE_ID", "")
        return int(raw) if raw else None

    def _draw(self) -> Tuple[int, float, float, float]:
        """One decision draw: always three uniforms in fixed order so
        the schedule depends only on (seed, call index), never on
        which fault kinds are enabled."""
        with self._lock:
            index = self._calls
            self._calls += 1
            u_drop = self._rng.random()
            u_err = self._rng.random()
            u_jitter = self._rng.random()
        return index, u_drop, u_err, u_jitter

    def decide(self, method: str) -> Tuple[str, float]:
        """(decision, latency_s) for one client call.

        decision: "pass" | "drop" | "error" | "partition". Latency
        applies to passing calls (0..latency_ms, jittered)."""
        index, u_drop, u_err, u_jitter = self._draw()
        node_id = self._local_node_id()
        if node_id is not None and node_id in self.partition_nodes:
            decision = "partition"
        elif u_drop < self.drop_rate:
            decision = "drop"
        elif u_err < self.error_rate:
            decision = "error"
        else:
            decision = "pass"
        latency_s = (self.latency_ms / 1000.0) * u_jitter
        self.decisions.append((index, method, decision))
        return decision, latency_s

    # -- client side ------------------------------------------------------

    def _in_scope(self, request) -> bool:
        """Does the configured scope cover this request's plane? The
        PS data plane is identified by its message types (Ps*) — the
        same RpcClient carries both planes, so the stub name alone
        cannot distinguish them."""
        if self.scope == "all":
            return True
        is_ps = type(request).__name__.startswith("Ps")
        return is_ps if self.scope == "ps" else not is_ps

    def before_client_call(self, method: str, request) -> None:
        """Raise/delay per the schedule. Called by RpcClient._call."""
        decision, latency_s = self.decide(method)
        if not self._in_scope(request):
            # The draw already happened (schedule stability); the
            # fault just doesn't apply to this plane.
            return
        if decision == "partition":
            raise ChaosPartitionError(
                f"chaos: node {self._local_node_id()} is partitioned "
                "from the master"
            )
        if decision == "drop":
            raise ChaosDropError(
                f"chaos: dropped {type(request).__name__} ({method})"
            )
        if decision == "error":
            raise ChaosDropError(
                f"chaos: transport error substituted for "
                f"{type(request).__name__} ({method})"
            )
        if latency_s > 0:
            time.sleep(latency_s)

    # -- server side ------------------------------------------------------

    def on_server_request(self, request) -> None:
        """Kill-master-at-event: exit the process when the Nth request
        of the configured type arrives. Called by the RPC server's
        generic handler before dispatch."""
        if self.kill_at is None:
            return
        name = type(request).__name__
        want_name, want_count = self.kill_at
        if name != want_name:
            return
        with self._lock:
            self._server_counts[name] = self._server_counts.get(name, 0) + 1
            count = self._server_counts[name]
        if count >= want_count:
            logger.error(
                "chaos: killing this process at %s #%d (seed=%d)",
                name, count, self.seed,
            )
            sys.stderr.flush()
            os._exit(KILL_EXIT_CODE)


# -- module-level gate --------------------------------------------------------

_injector: Optional[ChaosInjector] = None
_init_done = False
_init_lock = threading.Lock()


def get_injector() -> Optional[ChaosInjector]:
    """The process's env-gated injector, or None when chaos is off."""
    global _injector, _init_done
    if _init_done:
        return _injector
    with _init_lock:
        if not _init_done:
            if os.getenv(CHAOS_ENV, "") == "1":
                _injector = ChaosInjector.from_env()
                logger.warning(
                    "chaos injection ENABLED (seed=%d drop=%.3f "
                    "error=%.3f latency=%.0fms partition=%s kill_at=%s "
                    "scope=%s)",
                    _injector.seed,
                    _injector.drop_rate,
                    _injector.error_rate,
                    _injector.latency_ms,
                    sorted(_injector.partition_nodes),
                    _injector.kill_at,
                    _injector.scope,
                )
            _init_done = True
    return _injector


def install_injector(injector: Optional[ChaosInjector]) -> None:
    """Explicitly install (tests) or clear (None) the injector."""
    global _injector, _init_done
    with _init_lock:
        _injector = injector
        _init_done = True


def reset() -> None:
    """Forget the cached env decision (tests that flip the env)."""
    global _injector, _init_done
    with _init_lock:
        _injector = None
        _init_done = False
