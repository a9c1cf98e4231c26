"""Per-host elastic agent: supervises the host's training processes
(the port's counterpart of ``dlrover_tpu/agent/agent.py``).

Parity: dlrover/python/elastic_agent/torch/training.py (
MasterRendezvousHandler :132, ElasticTrainingAgent :313, launch_agent
:642). The JAX agent runs ONE training process per host that owns
every local chip and hands it ``jax.distributed.initialize``
coordinates. The port goes back to torchelastic's process model: one
training process per GPU. The agent spawns ``local_world_size``
trainers, each with ``LOCAL_RANK``, ``RANK`` (the ranks of lower-ranked
nodes' processes come first), ``WORLD_SIZE``, and ``MASTER_ADDR`` and
``MASTER_PORT`` of the coordinator that global rank 0 binds
(``trainer/torch_env.py`` turns them into ``init_process_group``).

The trainers are watched as a group: one non-zero exit kills the rest,
flushes the staged checkpoint from shm to storage and restarts all of
them, while the agent itself stays up, as the reference restarts its
workers. Hang detection and the stderr pump cover every trainer. The
flash-checkpoint saver serves one shard: under the port's replicated
data parallelism only global rank 0 stages state
(``trainer/flash_checkpoint/engine.py``). The agent unlinks the host's
shm segment when it exits. The network check is not ported yet
(ROADMAP queue 1 item 2).
"""

from __future__ import annotations

import collections
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.comm import find_free_port
from dlrover_tpu_torch.common.config import ensure_framework_on_pythonpath
from dlrover_tpu_torch.common.constants import (
    EventAction,
    NodeAction,
    NodeEnv,
    NodeType,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("agent")

_HEARTBEAT_FAILURES = obs.counter(
    "dlrover_agent_heartbeat_failures_total",
    "Agent->master heartbeat RPC failures (consecutive streaks are "
    "logged once per power-of-two length, not per tick)",
)


class RendezvousTimeoutError(RuntimeError):
    pass


class MasterRendezvousHandler:
    """Agent-side rendezvous: join, poll for the frozen world, compute
    this node's rank and the torch.distributed coordinates."""

    def __init__(
        self,
        client: MasterClient,
        local_world_size: int,
        rdzv_name: str = RendezvousName.TRAINING,
        timeout: float = 600.0,
        poll_interval: float = 0.3,
    ):
        self.client = client
        self.local_world_size = local_world_size
        self.rdzv_name = rdzv_name
        self.timeout = timeout
        self.poll_interval = poll_interval

    def next_rendezvous(self) -> "WorldSpec":
        round_ = self.client.join_rendezvous(
            self.local_world_size, rdzv_name=self.rdzv_name
        )
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            rdzv_round, group, world = self.client.get_comm_world(
                rdzv_name=self.rdzv_name
            )
            if world and self.client.node_rank in world:
                return self._build_spec(rdzv_round, group, world)
            if world and self.client.node_rank not in world:
                # Frozen without us (e.g. node_unit rounding): rejoin.
                round_ = self.client.join_rendezvous(
                    self.local_world_size, rdzv_name=self.rdzv_name
                )
            time.sleep(self.poll_interval)
        raise RendezvousTimeoutError(
            f"{self.rdzv_name} rendezvous not completed in {self.timeout}s "
            f"(joined round {round_})"
        )

    def _build_spec(
        self, rdzv_round: int, group: int, world: Dict[int, int]
    ) -> "WorldSpec":
        ranks = sorted(world.keys())
        my_rank = ranks.index(self.client.node_rank)
        # Process ids: one training process per GPU; this node's first
        # process follows every process of the lower-ranked nodes.
        spec = WorldSpec(
            round=rdzv_round,
            group=group,
            world=world,
            node_world_size=len(ranks),
            node_rank=my_rank,
            process_id=sum(world[r] for r in ranks[:my_rank]),
            num_processes=sum(world.values()),
        )
        # Rank-0 of the world publishes the coordinator endpoint.
        kv_key = f"coordinator/{self.rdzv_name}/{rdzv_round}/{group}"
        if my_rank == 0:
            host = os.getenv("DLROVER_TPU_HOST_IP", "127.0.0.1")
            port = find_free_port()
            spec.coordinator = f"{host}:{port}"
            self.client.kv_set(kv_key, spec.coordinator.encode())
        else:
            spec.coordinator = self.client.kv_wait(
                kv_key, timeout=self.timeout
            ).decode()
        return spec


@dataclass
class WorldSpec:
    """A frozen world. ``process_id`` is the global rank of this node's
    first training process (local rank 0); ``num_processes`` counts the
    training processes of every node."""

    round: int
    group: int
    world: Dict[int, int]
    node_world_size: int
    node_rank: int
    process_id: int
    num_processes: int
    coordinator: str = ""


@dataclass
class AgentConfig:
    node_id: int = 0
    node_rank: int = -1
    # Role this agent's node plays (NodeType): "worker" nodes join the
    # elastic rendezvous; an "evaluator" runs its command standalone
    # (it follows checkpoints, not the training world) while the
    # master still owns its lifecycle (critical role, relaunch).
    node_type: str = "worker"
    local_world_size: int = 1
    max_restarts: int = 3
    monitor_interval: float = 2.0
    rdzv_timeout: float = 600.0
    network_check: bool = False
    # With network_check: a node the master judges a straggler (>2x
    # median check time) exits instead of joining training, so the
    # scaler replaces it (ref dlrover-run --exclude-straggler,
    # trainer/torch/elastic_run.py:99-137).
    exclude_straggler: bool = False
    heartbeat_interval: float = 15.0
    # >0 enables hang detection: restart the training process when no
    # step progress for this many seconds (ref: atorch
    # --relaunch_on_hanging, fault_tolerance/custom_agent.py:19).
    hang_timeout: float = 0.0
    env: Dict[str, str] = field(default_factory=dict)


class ElasticAgent:
    """Supervises the host's training processes, as a group, through
    restarts and membership changes."""

    def __init__(
        self,
        config: AgentConfig,
        entry_cmd: List[str],
        client: Optional[MasterClient] = None,
    ):
        self.config = config
        self.entry_cmd = entry_cmd
        self.client = client or MasterClient.singleton()
        self._rdzv = MasterRendezvousHandler(
            self.client,
            config.local_world_size,
            timeout=config.rdzv_timeout,
        )
        # One training process per local rank, in local-rank order.
        self._procs: List[subprocess.Popen] = []
        # Tail of the children's stderr, kept so failure reports carry
        # the actual error text (OOM / RESOURCE_EXHAUSTED / preemption)
        # the master's classifier keys on (ref: error log monitor).
        self._stderr_tail: Deque[bytes] = collections.deque(maxlen=50)
        self._stderr_threads: List[threading.Thread] = []
        self._tail_lock = threading.Lock()
        self._restart_count = 0
        self._stop = threading.Event()
        self._spec: Optional[WorldSpec] = None
        self._ckpt_saver = None
        # Set by the heartbeat thread; acted on ONLY by the monitor
        # loop so process lifecycle has a single owner (no concurrent
        # kill/spawn races).
        self._restart_requested = threading.Event()
        # Set by the master's `cordon` heartbeat action (remediation):
        # the agent parks its trainer and sits out rendezvous while
        # still heartbeating; RESTART_TRAINING un-cordons.
        self._cordon_requested = threading.Event()
        # In-flight PROFILE capture worker (one at a time).
        self._profile_thread: Optional[threading.Thread] = None

    # -- process management -------------------------------------------------

    def _spawn(self, spec: WorldSpec) -> None:
        # Remove the previous incarnation's step-metrics file: the
        # hang detector and training monitor must not baseline on a
        # stale step (a resume can legitimately restart at a LOWER
        # step, which a stale high-water mark would misread as a hang
        # / silence).
        from dlrover_tpu_torch.agent.monitor import (
            default_metrics_file,
            METRICS_FILE_ENV,
        )

        try:
            os.remove(os.getenv(METRICS_FILE_ENV, default_metrics_file()))
        except OSError:
            pass
        env = ensure_framework_on_pythonpath(dict(os.environ))
        if self.config.local_world_size > 1:
            # As torchrun: trainers sharing a host's cores get one
            # OpenMP thread each unless the caller chose otherwise.
            env.setdefault("OMP_NUM_THREADS", "1")
        env.update(self.config.env)
        host, port = spec.coordinator.rsplit(":", 1)
        env.update(
            {
                "DLROVER_TPU_AGENT_PRESENT": "1",
                NodeEnv.NODE_ID: str(self.config.node_id),
                NodeEnv.NODE_RANK: str(spec.node_rank),
                NodeEnv.NODE_NUM: str(spec.node_world_size),
                NodeEnv.LOCAL_WORLD_SIZE: str(
                    self.config.local_world_size
                ),
                NodeEnv.COORDINATOR_ADDR: spec.coordinator,
                NodeEnv.NUM_PROCESSES: str(spec.num_processes),
                NodeEnv.RESTART_COUNT: str(self._restart_count),
                NodeEnv.MASTER_ADDR: self.client._client.addr,
                # torchrun's names for the same world
                "MASTER_ADDR": host,
                "MASTER_PORT": port,
                "WORLD_SIZE": str(spec.num_processes),
                "LOCAL_WORLD_SIZE": str(self.config.local_world_size),
                "GROUP_RANK": str(spec.node_rank),
            }
        )
        logger.info(
            "spawning %d training processes (round=%d node rank=%d/%d "
            "ranks %d..%d of %d, restart=%d): %s",
            self.config.local_world_size,
            spec.round,
            spec.node_rank,
            spec.node_world_size,
            spec.process_id,
            spec.process_id + self.config.local_world_size - 1,
            spec.num_processes,
            self._restart_count,
            " ".join(self.entry_cmd),
        )
        # Fresh deque per incarnation: if a previous pump thread out-
        # lives its 3s join (a grandchild kept the pipe open), it keeps
        # appending to the *old* deque and cannot pollute this
        # incarnation's tail or race its readers.
        with self._tail_lock:
            self._stderr_tail = collections.deque(maxlen=50)
        self._procs, self._stderr_threads = [], []
        for local_rank in range(self.config.local_world_size):
            rank = spec.process_id + local_rank
            child_env = dict(env)
            child_env.update(
                {
                    NodeEnv.PROCESS_ID: str(rank),
                    "RANK": str(rank),
                    "LOCAL_RANK": str(local_rank),
                }
            )
            proc = subprocess.Popen(
                self.entry_cmd, env=child_env, stderr=subprocess.PIPE
            )
            pump = threading.Thread(
                target=self._pump_stderr,
                args=(proc.stderr, self._stderr_tail),
                daemon=True,
            )
            pump.start()
            self._procs.append(proc)
            self._stderr_threads.append(pump)

    def _pump_stderr(self, pipe, tail: Deque[bytes]) -> None:
        """Forward the child's stderr while keeping the last lines.

        ``tail`` is this incarnation's deque, bound at spawn time."""
        try:
            for line in iter(pipe.readline, b""):
                with self._tail_lock:
                    tail.append(line)
                try:
                    sys.stderr.buffer.write(line)
                    sys.stderr.buffer.flush()
                except (AttributeError, ValueError, OSError):
                    # stderr replaced by a text-only capture (pytest) or
                    # closed: keep the tail, drop the passthrough.
                    pass
        finally:
            pipe.close()

    def _stderr_text(self, limit: int = 2048) -> str:
        with self._tail_lock:
            lines = list(self._stderr_tail)
        text = b"".join(lines).decode("utf-8", "replace")
        return text[-limit:]

    def _kill_proc(self, grace: float = 10.0) -> None:
        """Stop every training process: SIGTERM, then SIGKILL after
        ``grace`` seconds."""
        alive = [p for p in self._procs if p.poll() is None]
        for proc in alive:
            proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + grace
        while alive and time.monotonic() < deadline:
            alive = [p for p in alive if p.poll() is None]
            if alive:
                time.sleep(0.2)
        for proc in alive:
            proc.kill()
            proc.wait()
        self._join_stderr_pump()

    def _join_stderr_pump(self) -> None:
        """Drain the old incarnation's pump threads so their buffered
        stderr cannot leak into the next incarnation's tail."""
        for pump in self._stderr_threads:
            if pump is not threading.current_thread():
                pump.join(timeout=3.0)
        self._stderr_threads = []

    def _wait_for_exit(self, timeout: float) -> None:
        """Sleep up to ``timeout`` seconds, waking early when a training
        process fails or the last one finishes, so a failed trainer is
        noticed within a tenth of a second rather than a monitor
        interval."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            if self._group_exit() is not None:
                return
            time.sleep(min(0.1, max(deadline - time.monotonic(), 0.0)))

    def _group_exit(self) -> Optional[int]:
        """None while any training process runs and none failed; else
        the group's exit code: the first non-zero one (the others are
        stopped by the caller), or 0 when all finished cleanly."""
        codes = [p.poll() for p in self._procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            return failed[0]
        if codes and all(c == 0 for c in codes):
            return 0
        return None

    # -- forensics ----------------------------------------------------------

    def _snapshot_trainer_stacks(self, timeout: float = 3.0) -> str:
        """Every training process's Python stacks, as text."""
        return "".join(
            self._snapshot_proc_stacks(proc, timeout)
            for proc in self._procs
        )

    def _snapshot_proc_stacks(self, proc, timeout: float) -> str:
        """One training process's Python stacks, as text.

        Alive process: SIGUSR1 triggers its flight recorder's
        C-level faulthandler dump (registered at install; works even
        with the main thread wedged in a C call) and the growth of
        its stacks file is returned. Dead process: the tail the crash
        handlers already left behind."""
        from dlrover_tpu_torch.obs import flight_recorder as fr

        path = fr.stacks_file_path(proc.pid)
        try:
            before = os.path.getsize(path)
        except OSError:
            before = 0
        if proc.poll() is not None:
            return fr.read_stacks_tail(
                path, since=max(before - 8192, 0)
            )
        if not hasattr(signal, "SIGUSR1"):
            return ""
        if not fr.sigusr1_ready(proc.pid):
            # No registered handler (recorder disabled, still
            # importing, or registration failed): the default
            # disposition would KILL the process we are trying to
            # diagnose. No signal, no stacks.
            return ""
        try:
            proc.send_signal(signal.SIGUSR1)
        except OSError:
            return ""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if os.path.getsize(path) > before:
                    # Give the C handler a beat to finish the dump.
                    time.sleep(0.2)
                    break
            except OSError:
                pass
            time.sleep(0.1)
        return fr.read_stacks_tail(path, since=before)

    def _collect_forensics(self, kind: str, **notes):
        """(digest, bundle_path): snapshot the training process's
        stacks, write this agent's black-box bundle (with the trainer
        stacks embedded), and build the size-capped digest failure
        reports and the master's history carry. Never raises."""
        from dlrover_tpu_torch.obs import flight_recorder as fr

        stacks = ""
        try:
            stacks = self._snapshot_trainer_stacks()
        except Exception:  # noqa: BLE001 — forensics must never
            # break the recovery path it documents
            logger.warning(
                "trainer stack snapshot failed", exc_info=True
            )
        rec = fr.get_flight_recorder()
        bundle_path = ""
        if rec is not None:
            # Incident facts ride THIS bundle only — merging them
            # into the recorder's persistent notes would make every
            # later diagnose/crash digest replay a stale hang.
            bundle_path = (
                rec.dump(
                    kind,
                    reason=f"agent {kind} forensics",
                    extra={"trainer_stacks": stacks},
                    incident=notes,
                )
                or ""
            )
        digest = fr.make_digest(
            kind, stacks_text=stacks, recorder=rec, incident=notes
        )
        if bundle_path:
            digest = f"bundle: {bundle_path}\n{digest}"
        return digest, bundle_path

    def _run_diagnose(self) -> None:
        """Master-pushed `diagnose` action: on-demand stack-and-state
        snapshot, shipped back as a DiagnosticsReport."""
        digest, bundle_path = self._collect_forensics("diagnose")
        self.client.report_diagnostics(
            "diagnose", bundle_path=bundle_path, digest=digest
        )

    def _on_stale_beacon(self, stamp: dict) -> None:
        """ResourceMonitor found the trainer's progress beacon wedged
        (no stamp for DLROVER_TPU_BEACON_STALL_S): capture forensics
        while the wedge is live — the SIGUSR1 stack snapshot shows
        exactly which collective the trainer is parked in — and ship
        them as a kind-``stall`` DiagnosticsReport. The master-side
        correlator does the cross-host localization; this capture is
        the host-local half of the evidence."""
        digest, bundle_path = self._collect_forensics(
            "stall",
            beacon_step=stamp.get("step"),
            beacon_microbatch=stamp.get("microbatch"),
            beacon_phase=stamp.get("phase"),
            beacon_age_s=stamp.get("age_s"),
        )
        self.client.report_diagnostics(
            "stall", bundle_path=bundle_path, digest=digest
        )

    def _run_profile(self) -> None:
        """Master-pushed `profile` action: ask the co-hosted trainer
        for an N-step step-phase/MFU capture and ship the digest back
        as a DiagnosticsReport(kind="profile").

        Runs in its own daemon thread: the capture spans N training
        steps (seconds to minutes), and the heartbeat loop must keep
        beating while the trainer gets there. One capture at a time —
        a second PROFILE while one is in flight is dropped (the
        running capture's digest answers it)."""
        if (
            self._profile_thread is not None
            and self._profile_thread.is_alive()
        ):
            logger.info("profile capture already in flight; skipping")
            return
        self._profile_thread = threading.Thread(
            target=self._profile_worker,
            name="profile-capture",
            daemon=True,
        )
        self._profile_thread.start()

    def _profile_worker(self) -> None:
        try:
            self._profile_worker_inner()
        except Exception:  # noqa: BLE001 — a failed capture must
            # neither kill the agent nor masquerade as a crash (an
            # uncaught thread exception would write a forensics
            # bundle via threading.excepthook)
            logger.warning("profile capture failed", exc_info=True)

    def _profile_worker_inner(self) -> None:
        import json as _json

        from dlrover_tpu_torch.obs import profiling

        req_id = profiling.write_profile_request()
        wait_s = float(os.getenv("DLROVER_TPU_PROFILE_WAIT_S", "120"))
        deadline = time.monotonic() + wait_s
        digest = None
        while time.monotonic() < deadline:
            digest = profiling.read_profile_digest(expect_id=req_id)
            if digest is not None:
                break
            time.sleep(0.25)
        if digest is None:
            # The answer is itself diagnostic: no digest within the
            # wait usually means no live trainer loop (hung, between
            # restarts, or a loop without a step-phase profiler).
            self.client.report_diagnostics(
                "profile",
                digest=_json.dumps(
                    {
                        "id": req_id,
                        "error": f"no profile digest within {wait_s:.0f}s"
                        " (trainer not stepping, or its loop has no"
                        " StepPhaseProfiler)",
                    }
                ),
            )
            return
        self.client.report_diagnostics(
            "profile",
            bundle_path=profiling.profile_digest_file(),
            digest=_json.dumps(digest, indent=1, sort_keys=True),
        )

    # -- health check -------------------------------------------------------

    def run_network_check(self) -> bool:
        """The JAX agent times a psum/matmul payload here
        (ref: NetworkCheckElasticAgent); its NCCL counterpart is not
        ported yet."""
        raise NotImplementedError(
            "the network check (trainer/network_check.py as a timed NCCL "
            "all_gather and matmul) is ROADMAP queue 1 item 2"
        )

    def network_check_verdict(self) -> bool:
        """Consume the master's fault + straggler verdicts for this
        node after check results were reported. Split from
        run_network_check so the decision (incl. --exclude-straggler)
        is testable without live rendezvous timing."""
        deadline = time.monotonic() + self.config.rdzv_timeout
        faults, reason = self.client.query_fault_nodes()
        while reason == "waiting":
            if time.monotonic() > deadline:
                logger.error(
                    "network-check verdict not available within %ss "
                    "(peers never reported); treating as failure",
                    self.config.rdzv_timeout,
                )
                return False
            time.sleep(1.0)
            faults, reason = self.client.query_fault_nodes()
        if self.client.node_rank in faults:
            logger.error("this node FAILED the network check")
            return False
        try:
            stragglers, _ = self.client.query_stragglers()
        except Exception:  # noqa: BLE001 — a transient RPC failure
            # must not kill a healthy node over an advisory check
            logger.warning(
                "straggler query failed; assuming not a straggler",
                exc_info=True,
            )
            stragglers = []
        if self.client.node_rank in stragglers:
            if self.config.exclude_straggler:
                logger.error(
                    "this node is a STRAGGLER (>2x median check "
                    "time) and --exclude-straggler is set; exiting "
                    "so it gets replaced"
                )
                return False
            logger.warning(
                "this node is a STRAGGLER (>2x median check time); "
                "continuing (pass --exclude-straggler to exit "
                "instead)"
            )
        return True

    # -- main loop ----------------------------------------------------------

    def run(self) -> int:
        self.client.register_node(node_type=self.config.node_type)
        # The network check is a training-world rendezvous sized to the
        # worker fleet — an evaluator joining it would freeze a wrong-
        # sized world and skew the straggler median, so only workers
        # run it.
        is_evaluator = self.config.node_type == NodeType.EVALUATOR
        if (
            not is_evaluator
            and self.config.network_check
            and not self.run_network_check()
        ):
            self.client.report_failure(
                "network check failed",
                TrainingExceptionLevel.NODE_ERROR,
            )
            return 1
        heartbeat = threading.Thread(
            target=self._heartbeat_loop, daemon=True
        )
        heartbeat.start()
        # Telemetry to the master: node resources + training progress
        # (ref elastic_agent/monitor/{resource,training}.py).
        from dlrover_tpu_torch.agent.monitor import (
            ResourceMonitor,
            TrainingMonitor,
        )
        from dlrover_tpu_torch.agent.paral_config_tuner import ParalConfigTuner

        res_mon = ResourceMonitor(
            self.client, on_stale_beacon=self._on_stale_beacon
        )
        train_mon = TrainingMonitor(self.client)
        tuner = ParalConfigTuner(self.client)
        # After a master reconnect (possibly to a warm-restarted
        # replacement), resend a full telemetry snapshot immediately:
        # the new master's fleet view re-primes now, not a reporting
        # cadence later. (Registration itself is already resent by
        # the client's supervisor.)
        self.client.add_reconnect_callback(res_mon.report_once)
        res_mon.start()
        train_mon.start()
        tuner.start()
        try:
            result = self._invoke_run()
        finally:
            res_mon.stop()
            train_mon.stop()
            tuner.stop()
            self._stop.set()
            self._close_ckpt_saver()
        return result

    def _ensure_ckpt_saver(self, spec: WorldSpec) -> None:
        """Start/refresh the agent-hosted flash-checkpoint saver (ref:
        saver started at _invoke_run, elastic_agent/torch/
        training.py:509; agent ownership means a crashed trainer's shm
        still gets flushed). One shard job-wide: global rank 0 (local
        rank 0 of node rank 0) stages the replicated state."""
        from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

        default_dir = os.path.join(
            tempfile.gettempdir(),
            f"dlrover_tpu_ckpt_{os.getenv('DLROVER_TPU_JOB_NAME', 'job')}",
        )
        saver = AsyncCheckpointSaver.start_async_saving_ckpt(
            checkpoint_dir=default_dir,
            local_shard_num=1,
            global_shard_num=1,
            is_commit_owner=spec.node_rank == 0,
        )
        saver.is_commit_owner = spec.node_rank == 0
        if self._ckpt_saver is None:
            saver.register_signal_handler()
        self._ckpt_saver = saver

    def _flush_ckpt_shm(self) -> None:
        """Persist any staged-but-unpersisted checkpoint before a
        restart (ref: _save_ckpt_to_storage, training.py:572)."""
        if self._ckpt_saver is not None:
            t0 = time.monotonic()
            try:
                self._ckpt_saver.save_shm_to_storage()
            except Exception:  # noqa: BLE001
                logger.warning(
                    "pre-restart checkpoint flush failed", exc_info=True
                )
            logger.info(
                "checkpoint flush before restart took %.3f s",
                time.monotonic() - t0,
            )

    def _close_ckpt_saver(self) -> None:
        """Flush what is staged, stop the saver and unlink the host's
        shm segment: the agent owns it and outlives every trainer."""
        if self._ckpt_saver is None:
            return
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            unlink_shm,
        )

        self._flush_ckpt_shm()
        self._ckpt_saver.close()
        self._ckpt_saver = None
        unlink_shm(0)

    def _standalone_spec(self) -> WorldSpec:
        """World of this node alone for roles outside the training
        rendezvous (evaluator): its processes run by themselves, keyed
        by this node, with a coordinator on this host."""
        host = os.getenv("DLROVER_TPU_HOST_IP", "127.0.0.1")
        return WorldSpec(
            round=0,
            group=0,
            world={self.config.node_id: self.config.local_world_size},
            node_world_size=1,
            node_rank=0,
            process_id=0,
            num_processes=self.config.local_world_size,
            coordinator=f"{host}:{find_free_port()}",
        )

    def _invoke_run(self) -> int:
        from dlrover_tpu_torch.agent.hang_detector import HangDetector

        hang = (
            HangDetector(hang_timeout=self.config.hang_timeout)
            if self.config.hang_timeout > 0
            else None
        )
        if self.config.node_type == NodeType.EVALUATOR:
            # Evaluators run outside the training world: no rendezvous
            # join (which would block or distort the worker world), a
            # world of one; master-side lifecycle still applies.
            self._spec = self._standalone_spec()
        else:
            self._spec = self._rdzv.next_rendezvous()
        self._ensure_ckpt_saver(self._spec)
        self._spawn(self._spec)
        while not self._stop.is_set():
            self._wait_for_exit(self.config.monitor_interval)
            if self._cordon_requested.is_set():
                # Cordoned by the master's remediation engine: stop
                # the trainer (it would otherwise wedge the fleet's
                # collectives), skip rendezvous/membership handling so
                # this node sits OUT of the next world, keep
                # heartbeating so the master can un-cordon (rollback)
                # or retire us. A pending restart request stays set —
                # it fires the moment the cordon clears.
                if any(p.poll() is None for p in self._procs):
                    logger.warning(
                        "cordoned by master; stopping training "
                        "processes and sitting out rendezvous"
                    )
                    obs.event(
                        "agent.cordoned", node_id=self.config.node_id
                    )
                    self._flush_ckpt_shm()
                    self._kill_proc()
                self._procs = []
                if hang is not None:
                    hang.reset()
                continue
            if hang is not None and hang.check():
                exhausted = (
                    self._restart_count >= self.config.max_restarts
                )
                logger.error(
                    "training process hung (%.0fs without step "
                    "progress); %s",
                    hang.seconds_since_progress(),
                    "giving up" if exhausted else "restarting it",
                )
                # Forensics BEFORE any kill/restart: the SIGUSR1 stack
                # snapshot needs the hung process still alive, and the
                # digest must ride the failure report so the hang is
                # diagnosable, not just counted.
                digest, bundle_path = self._collect_forensics(
                    "hang",
                    hang_seconds=round(
                        hang.seconds_since_progress(), 1
                    ),
                    last_step=hang.last_step,
                )
                action = NodeAction.RESTART_IN_PLACE
                try:
                    action = self.client.report_failure(
                        "training process hanging",
                        TrainingExceptionLevel.PROCESS_ERROR,
                        restart_count=self._restart_count,
                        fatal=exhausted,
                        diagnostics=digest,
                    )
                except Exception:  # noqa: BLE001
                    logger.warning("could not report hang", exc_info=True)
                self.client.report_diagnostics(
                    "hang", bundle_path=bundle_path, digest=digest
                )
                if exhausted:
                    self._kill_proc()  # a hung proc still holds chips
                    return 1
                if action != NodeAction.RESTART_IN_PLACE:
                    # Master took ownership (node relaunch/stop): same
                    # handover as _handle_failure.
                    logger.info(
                        "master verdict %r on hang; agent stops "
                        "supervising", action,
                    )
                    self._kill_proc()
                    return 1
                self._restart_count += 1
                self._restart_workers(reason="hang")
                hang.reset()
                continue
            code = self._group_exit()
            if code is not None:
                if code == 0:
                    logger.info("training processes finished successfully")
                    try:
                        self.client.report_succeeded()
                    except Exception:  # noqa: BLE001
                        logger.warning(
                            "could not report success to master",
                            exc_info=True,
                        )
                    return 0
                if not self._handle_failure(code):
                    return code
                continue
            if self._restart_requested.is_set():
                self._restart_requested.clear()
                logger.info("master requested restart")
                self._restart_workers(reason="master_request")
            elif self._membership_changed():
                logger.info(
                    "membership changed; restarting training process "
                    "for re-rendezvous"
                )
                self._restart_workers()
        self._kill_proc()
        return 0

    def _handle_failure(self, exitcode: int) -> bool:
        """Stop the rest of the group, report, and decide restart.
        True = keep running."""
        logger.warning(
            "a training process exited with code %s; stopping the group",
            exitcode,
        )
        self._kill_proc()
        exhausted = self._restart_count >= self.config.max_restarts
        error_data = (
            f"training process exit code {exitcode}\n"
            + self._stderr_text()
        )
        # The dead trainer's crash hooks (excepthook bundle /
        # faulthandler stacks) already wrote to the forensics dir;
        # fold their tail + this agent's black box into a digest. It
        # rides the failure report's `diagnostics` field, NOT
        # error_data: stack frames must not perturb the master's
        # stderr keyword classifier (a frame through
        # preemption_drill.py is not a preemption).
        digest, bundle_path = self._collect_forensics(
            "crash", exit_code=exitcode
        )
        action = NodeAction.RESTART_IN_PLACE
        try:
            action = self.client.report_failure(
                error_data,
                TrainingExceptionLevel.PROCESS_ERROR,
                restart_count=self._restart_count,
                fatal=exhausted,
                diagnostics=digest,
            )
        except Exception:  # noqa: BLE001
            # An unreachable master must not take the agent down with
            # it — restarts are still locally meaningful.
            logger.warning(
                "could not report failure to master", exc_info=True
            )
        self.client.report_diagnostics(
            "crash", bundle_path=bundle_path, digest=digest
        )
        if exhausted:
            logger.error(
                "exhausted %d restarts; giving up", self.config.max_restarts
            )
            return False
        if action != NodeAction.RESTART_IN_PLACE:
            # The master took ownership (node relaunch or stop): this
            # agent must not also restart the process in place.
            logger.info(
                "master verdict %r; agent stops supervising", action
            )
            return False
        self._restart_count += 1
        self._restart_workers(reason="process_exit")
        return True

    def _restart_workers(self, reason: str = "membership") -> None:
        from dlrover_tpu_torch import obs

        obs.event(
            "agent.worker_restart",
            reason=reason,
            restart_count=self._restart_count,
            node_id=self.config.node_id,
        )
        self._flush_ckpt_shm()
        self._kill_proc()
        self._spec = (
            self._standalone_spec()
            if self.config.node_type == NodeType.EVALUATOR
            else self._rdzv.next_rendezvous()
        )
        self._ensure_ckpt_saver(self._spec)
        self._spawn(self._spec)

    def _membership_changed(self) -> bool:
        # Evaluators are not part of the training world: worker churn
        # must not restart the evaluation loop.
        if self.config.node_type == NodeType.EVALUATOR:
            return False
        return self.client.num_nodes_waiting() > 0

    def _heartbeat_loop(self) -> None:
        streak = 0
        next_warn = 1
        while not self._stop.wait(self.config.heartbeat_interval):
            try:
                action = self.client.heartbeat()
            except Exception:  # noqa: BLE001
                # Repeated failures are counted, and warned once per
                # power-of-two streak length — a master outage must
                # show up in telemetry without a log line per tick.
                streak += 1
                _HEARTBEAT_FAILURES.inc()
                if streak >= next_warn:
                    logger.warning(
                        "heartbeat failed (%d consecutive "
                        "failure%s; next warning at %d)",
                        streak,
                        "" if streak == 1 else "s",
                        next_warn * 2,
                        exc_info=True,
                    )
                    next_warn *= 2
                continue
            if streak:
                logger.info(
                    "heartbeat recovered after %d failure%s",
                    streak, "" if streak == 1 else "s",
                )
                streak = 0
                next_warn = 1
                # The master may be a warm-restarted replacement (or
                # a cold one that lost the node table): re-announce
                # this node and let subscribers resend snapshots.
                try:
                    self.client.notify_master_recovered()
                except Exception:  # noqa: BLE001
                    logger.warning(
                        "post-recovery re-registration failed",
                        exc_info=True,
                    )
            if action == EventAction.RESTART_TRAINING.value:
                if self._cordon_requested.is_set():
                    # restart_training doubles as un-cordon (the
                    # remediation rollback path): clear the cordon
                    # FIRST so the supervision loop acts on the
                    # restart instead of skipping it.
                    self._cordon_requested.clear()
                    logger.info(
                        "master un-cordoned this node; rejoining at "
                        "the next rendezvous"
                    )
                self._restart_requested.set()
            elif action == EventAction.CORDON.value:
                logger.warning(
                    "master cordoned this node (remediation); parking "
                    "the trainer"
                )
                self._cordon_requested.set()
            elif action == EventAction.STOP_TRAINING.value:
                self._stop.set()
            elif action == EventAction.DIAGNOSE.value:
                try:
                    self._run_diagnose()
                except Exception:  # noqa: BLE001 — an on-demand
                    # snapshot must never take the heartbeat down
                    logger.warning("diagnose failed", exc_info=True)
            elif action == EventAction.PROFILE.value:
                try:
                    self._run_profile()
                except Exception:  # noqa: BLE001 — an on-demand
                    # capture must never take the heartbeat down
                    logger.warning("profile failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        self._kill_proc()
