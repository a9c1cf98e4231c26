"""Elastic serving plane on the port: continuous-batching decode on the
training control plane (the counterpart of ``dlrover_tpu/serving``).

* :mod:`dlrover_tpu_torch.serving.kv_pool` — block-granular KV cache
  accounting, the admission currency of the scheduler (copied).
* :mod:`dlrover_tpu_torch.serving.scheduler` — the per-replica
  continuous-batching scheduler: new sequences join the running decode
  batch every step, prompts prefill in bounded chunks, pool exhaustion
  preempts the youngest sequence; its programs are
  ``models/generate.py``'s lane prefill (K1, K3 on the GPU) and ragged
  decode step on the parameters' device.
* :mod:`dlrover_tpu_torch.serving.replica` — the replica worker:
  registers in the master's node table as ``NodeType.REPLICA``, pulls
  work from the router, steps its scheduler, reports completions and
  stats, heartbeats like any other node; ``python -m
  dlrover_tpu_torch.serving.replica`` runs one (on the GPU unless
  ``--device cpu``).
* :mod:`dlrover_tpu_torch.serving.router` — the master-side traffic
  router: request ledger, replica registry, drain + requeue on replica
  death, the progress watchdog and replica scaling (copied).
* :mod:`dlrover_tpu_torch.serving.handoff` — prefill/decode
  disaggregation's transfer seam: block-granular KV payloads exported
  off a prefill replica's cache, their msgpack-safe wire form (the JAX
  package's, bf16 included), and the install into a decode replica's
  cache.

``agent/replica_supervisor.py`` (copied) spawns and restarts replica
processes.
"""

from dlrover_tpu_torch.serving.handoff import (  # noqa: F401
    HandoffPayload,
    export_handoff,
)
from dlrover_tpu_torch.serving.kv_pool import KVBlockPool  # noqa: F401
from dlrover_tpu_torch.serving.router import (  # noqa: F401
    ServingRouter,
    render_serving,
)
from dlrover_tpu_torch.serving.scheduler import (  # noqa: F401
    CompletedRequest,
    ContinuousBatchingScheduler,
    ServeRequest,
)
