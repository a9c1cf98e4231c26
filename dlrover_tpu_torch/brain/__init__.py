"""Brain: offline resource-optimization service.

Functional parity with the reference's Go brain
(dlrover/go/brain/: gRPC optimize API, ~10 pluggable optimization
algorithms, MySQL-backed job-metrics datastore): a Python service with
a sqlite datastore (this environment has no MySQL) exposing the same
shape — persist job runtime facts, answer resource-plan queries from
historical evidence. The master plugs it in through the
ResourceOptimizer seam of master/auto_scaler.py, exactly where the
reference's BrainResourceOptimizer sits
(python/master/resource/brain_optimizer.py).
"""

from dlrover_tpu_torch.brain.service import (  # noqa: F401
    BrainService,
    BrainResourceOptimizer,
    JobMetricsRecord,
)
