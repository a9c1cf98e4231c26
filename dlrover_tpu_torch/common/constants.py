"""Framework-wide constants and enums.

Capability parity with the reference's constant registry
(dlrover/python/common/constants.py), redesigned for a TPU fleet: node
types are host/master rather than PS/worker-GPU, and accelerator metadata
speaks TPU topologies (chips per host, ICI slice shape) instead of GPUs.
"""

from __future__ import annotations

import enum


class NodeType:
    """Roles a node can play in a job."""

    MASTER = "master"
    # A TPU host (one VM of a pod slice, owning N chips).
    WORKER = "worker"
    # The coordinating worker (rank-0 duties: variable init in PS
    # strategy, checkpoint commits). Critical by default.
    CHIEF = "chief"
    # CPU-only preprocessing host (coworker architecture).
    DATA_WORKER = "data_worker"
    # Parameter-server-style host for the sparse embedding path.
    EMBEDDING = "embedding"
    # Inference replica in the serving plane (dlrover_tpu/serving/):
    # hosts a model copy behind a continuous-batching scheduler,
    # registered in the same node table as training roles but outside
    # the training rendezvous and speed accounting.
    REPLICA = "replica"
    EVALUATOR = "evaluator"

    ALL = (MASTER, WORKER, DATA_WORKER, EMBEDDING, EVALUATOR)


# PS (EMBEDDING) hosts pick their own ps_id starting at 0, same as
# workers pick ranks — the job-manager node table is shared, so PS
# node ids live in their own namespace to avoid colliding with (and
# silently merging onto) worker nodes of the same id.
PS_NODE_ID_BASE = 1_000_000


def ps_node_id(ps_id: int) -> int:
    return PS_NODE_ID_BASE + ps_id


def node_ps_id(node_id: int) -> int:
    return node_id - PS_NODE_ID_BASE


# Evaluator ids are namespaced the same way PS ids are: an evaluator
# launched with the default rank 0 must never merge onto worker 0's
# node-table entry (the agent uses its node_id for register/heartbeat/
# failure RPCs, so the namespacing happens at the agent).
EVALUATOR_NODE_ID_BASE = 2_000_000


def evaluator_node_id(index: int) -> int:
    return EVALUATOR_NODE_ID_BASE + index


# Coworker (DATA_WORKER) pods likewise: their pod ids start at 0 and
# must not merge onto worker/PS/evaluator node-table entries.
DATA_WORKER_NODE_ID_BASE = 3_000_000


def data_worker_node_id(pod_id: int) -> int:
    return DATA_WORKER_NODE_ID_BASE + pod_id


# Serving replicas likewise: replica 0 must never merge onto worker
# 0's node-table entry (the replica worker namespaces its id before
# register/heartbeat RPCs, serving/replica.py).
REPLICA_NODE_ID_BASE = 4_000_000


def replica_node_id(replica_id: int) -> int:
    return REPLICA_NODE_ID_BASE + replica_id


class NodeStatus:
    """Lifecycle states of a node; transitions in common/status_flow.py."""

    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"  # hardware failure detected by health check

    ALIVE = (PENDING, RUNNING)
    TERMINAL = (SUCCEEDED, FAILED, DELETED, BREAKDOWN)


class NodeEventType:
    CREATED = "created"
    MODIFIED = "modified"
    DELETED = "deleted"


class NodeAction:
    """Master's verdict on a failure report: who owns the restart."""

    RESTART_IN_PLACE = "restart_in_place"  # agent respawns the process
    RELAUNCH_NODE = "relaunch_node"  # master replaces the node (pod)
    STOP = "stop"  # no restart at all


class NodeExitReason:
    """Why a node's training process exited; drives relaunch policy."""

    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"
    PREEMPTED = "preempted"
    UNKNOWN = "unknown"

    # Exit reasons that should never be relaunched.
    NO_RELAUNCH = (SUCCEEDED, FATAL_ERROR)


class JobStage:
    INIT = "init"
    RENDEZVOUS = "rendezvous"
    TRAINING = "training"
    SUSPENDED = "suspended"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


class RendezvousName:
    TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class TaskType:
    """Dynamic-sharding task types handed to workers."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    NONE = "none"


class DatasetType:
    TABLE = "table"
    TEXT = "text"
    STREAMING = "streaming"


class TrainingExceptionLevel:
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    RDZV_ERROR = "rdzv_error"
    WARNING = "warning"
    INFO = "info"


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "k8s"
    RAY = "ray"


class Accelerators:
    TPU = "tpu"
    CPU = "cpu"  # for tests / virtual meshes


class TpuGeneration:
    V4 = "v4"
    V5E = "v5e"
    V5P = "v5p"
    V6E = "v6e"

    # Peak bf16 matmul TFLOP/s per chip, used by the analyser's cost model.
    PEAK_BF16_TFLOPS = {V4: 275.0, V5E: 197.0, V5P: 459.0, V6E: 918.0}
    # HBM bytes/s per chip.
    HBM_GBPS = {V4: 1228.0, V5E: 819.0, V5P: 2765.0, V6E: 1640.0}


class CheckpointConstant:
    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    STEP_DIR_PREFIX = "iter_"
    DONE_FILE_PREFIX = "done_"
    MODEL_STATE_NAME = "model_state"
    OPTIM_STATE_NAME = "optim_state"
    EXTRA_STATE_NAME = "extra_state"


class NodeEnv:
    """Environment variables understood by agents and training processes."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    # Multi-job pool routing id: when set, every master RPC this
    # process makes carries it on the envelope's _job field so the
    # pool master routes to this job's servicer. Unset/empty =
    # single-job mode (unchanged behavior).
    POOL_JOB_ID = "DLROVER_TPU_POOL_JOB_ID"
    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    LOCAL_WORLD_SIZE = "DLROVER_TPU_LOCAL_WORLD_SIZE"
    # JAX distributed bootstrap (coordinator = rank-0 host).
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    # Restart bookkeeping
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    # Platform type: local | k8s | ray
    PLATFORM = "DLROVER_TPU_PLATFORM"
    # Monitoring
    MONITOR_ENABLED = "DLROVER_TPU_MONITOR_ENABLED"


class GrpcEnv:
    MAX_MESSAGE_LENGTH = 256 * 1024 * 1024


class DefaultValues:
    RDZV_TIMEOUT_SECS = 600
    PENDING_TIMEOUT_SECS = 900
    HANG_TIMEOUT_SECS = 1800
    SHARD_TIMEOUT_SECS = 300
    RELAUNCH_MAX = 3
    MASTER_PORT = 0  # 0 = pick a free port
    SAVE_MEM_INTERVAL_SECS = 30
    REPORT_INTERVAL_SECS = 15


class JobExitReason:
    SUCCEEDED = "succeeded"
    NODE_OOM = "node_oom_error"
    NODE_FATAL = "node_fatal_error"
    RDZV_TIMEOUT = "rendezvous_timeout"
    PENDING_TIMEOUT = "pending_timeout"
    # A critical node (chief/evaluator/critical worker/PS) exhausted
    # its relaunch budget: the job cannot make progress without it.
    CRITICAL_NODE_FAILED = "critical_node_failed"
    UNKNOWN = "unknown"


class ErrorMonitorConstants:
    TYPE_INFO = "info"
    TYPE_ERROR = "error"
    ACTION_RELAUNCH = "relaunch"
    ACTION_STOP = "stop"


class EventAction(str, enum.Enum):
    """Actions the master can push down to agents."""

    NONE = "none"
    RESTART_TRAINING = "restart_training"
    STOP_TRAINING = "stop_training"
    SAVE_CHECKPOINT = "save_checkpoint"
    # Take an on-demand forensics snapshot: the agent SIGUSR1s its
    # training process for a stack dump, writes its own recorder
    # bundle, and ships a DiagnosticsReport back to the master.
    DIAGNOSE = "diagnose"
    # Capture an on-demand N-step performance profile: the agent
    # drops a request file for its trainer's step-phase profiler,
    # waits for the phase/MFU digest, and ships it back as a
    # DiagnosticsReport(kind="profile").
    PROFILE = "profile"
    # Remediation engine: the agent stops its training process and
    # sits OUT of rendezvous (still heartbeating) while the master
    # replaces or observes the host. A subsequent RESTART_TRAINING
    # un-cordons it (the rollback path).
    CORDON = "cordon"
