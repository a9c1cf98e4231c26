"""Agent-side async checkpoint saver.

Parity with the reference's AsyncCheckpointSaver
(dlrover/python/elastic_agent/torch/ckpt_saver.py:369 —
start_async_saving_ckpt:415, register_signal_handler:441,
save_shm_to_storage:570, commit_checkpoint:757, TempDirCheckpointSaver
:795): a daemon in the host-agent process drains save events from the
trainer, copies shm → storage off the training critical path, flushes
shm on SIGTERM or right before an elastic restart, and commits a step
only when every rank's shard landed (temp-dir rename + done-files +
tracker file).

This process never imports jax — it must not grab the TPU chip the
trainer holds.
"""

from __future__ import annotations

import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from dlrover_tpu_torch.common.ckpt_shm import SharedMemoryHandler
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
)
from dlrover_tpu_torch.common.storage import CheckpointStorage, get_storage
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    CKPT_EVENT_QUEUE,
    CKPT_STATUS_DICT,
    TRACKER_FILE,
    WRITING_PREFIX,
    done_dir,
    pack_shard_file,
    step_dir,
    writing_dir,
)

logger = get_logger("ckpt_saver")


class AsyncCheckpointSaver:
    """Persists trainer-staged shm checkpoints asynchronously.

    One instance per host agent. Serves the IPC primitives the trainer
    engines connect to (event queue, per-shard locks, status dict).

    ``local_shard_num``: training processes on this host.
    ``global_shard_num``: training processes job-wide (commit waits for
    this many shard files).
    ``is_commit_owner``: exactly one agent in the job (node rank 0)
    finalizes commits.
    """

    _instance: Optional["AsyncCheckpointSaver"] = None

    def __init__(
        self,
        checkpoint_dir: str,
        local_shard_num: int = 1,
        global_shard_num: Optional[int] = None,
        is_commit_owner: bool = True,
        storage: Optional[CheckpointStorage] = None,
        commit_timeout: float = 600.0,
    ):
        self.checkpoint_dir = checkpoint_dir.rstrip("/")
        self.local_shard_num = local_shard_num
        self.global_shard_num = global_shard_num or local_shard_num
        self.is_commit_owner = is_commit_owner
        self.commit_timeout = commit_timeout
        self.storage = storage or get_storage()
        self._events = SharedQueue(CKPT_EVENT_QUEUE, server=True)
        self._status = SharedDict(CKPT_STATUS_DICT, server=True)
        self._locks = [
            SharedLock(f"ckpt_{i}", server=True)
            for i in range(local_shard_num)
        ]
        self._shms = [
            SharedMemoryHandler(i) for i in range(local_shard_num)
        ]
        # A restarted agent must not re-commit steps already published
        # (the rename would collide); recover progress from the tracker.
        self._persisted_step = self._read_tracker()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._persist_lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    @classmethod
    def start_async_saving_ckpt(cls, **kwargs) -> "AsyncCheckpointSaver":
        """Singleton start, mirroring the reference classmethod.

        The constructor's checkpoint_dir is a default: save events
        carry the trainer's authoritative dir and the running saver
        adopts it, so a second start with a different dir (agent
        re-rendezvous after the trainer already saved) reuses the
        instance instead of failing."""
        if cls._instance is None:
            cls._instance = cls(**kwargs)
            cls._instance.start()
        elif kwargs.get("checkpoint_dir", "").rstrip("/") != (
                cls._instance.checkpoint_dir):
            logger.info(
                "reusing running checkpoint saver (dir %s; requested "
                "%s will apply if save events name it)",
                cls._instance.checkpoint_dir,
                kwargs.get("checkpoint_dir"),
            )
        return cls._instance

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._saving_loop, name="ckpt-saver", daemon=True
        )
        self._thread.start()

    def register_signal_handler(self) -> None:
        """Flush shm to storage on SIGTERM (preemption notice), then
        re-raise default handling so the agent still terminates."""
        orig_term = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            logger.info("SIGTERM: flushing shm checkpoint to storage")
            try:
                self.save_shm_to_storage()
            finally:
                if callable(orig_term):
                    orig_term(signum, frame)
                else:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    signal.raise_signal(signal.SIGTERM)

        signal.signal(signal.SIGTERM, handler)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for h in self._locks:
            h.close()
        self._events.close()
        self._status.close()
        for shm in self._shms:
            shm.close()
        if AsyncCheckpointSaver._instance is self:
            AsyncCheckpointSaver._instance = None

    # -- main loop -------------------------------------------------------

    def _saving_loop(self) -> None:
        import queue as _q

        while not self._stop.is_set():
            try:
                event = self._events.get(timeout=0.5)
            except _q.Empty:
                continue
            except (ConnectionError, OSError):
                return  # server shut down
            if event.get("type") == "save":
                step = int(event["step"])
                evt_dir = (event.get("dir") or "").rstrip("/")
                if evt_dir and evt_dir != self.checkpoint_dir:
                    logger.info(
                        "adopting trainer checkpoint dir %s", evt_dir
                    )
                    self.checkpoint_dir = evt_dir
                try:
                    self.save_step_checkpoint(step)
                except Exception:  # noqa: BLE001
                    logger.exception("persisting step %s failed", step)

    # -- persistence -----------------------------------------------------

    def _snapshot_shards(self):
        """Snapshot every local shard at one *consistent* step.

        The trainer stages steps monotonically; if shard k advanced
        between our reads, re-read until all shards agree (bounded
        retries) so a commit never mixes two steps' tensors."""
        for _ in range(8):
            snapshots = []
            for i in range(self.local_shard_num):
                with self._locks[i]:
                    snap = self._shms[i].load()
                if snap is None:
                    logger.warning("no shm state for local shard %s", i)
                    return None
                snapshots.append(snap)
            steps = {s[0] for s in snapshots}
            if len(steps) == 1:
                return snapshots
            logger.info(
                "shards hold mixed steps %s; re-snapshotting", steps)
            time.sleep(0.05)
        logger.error("shards never converged to one step; giving up")
        return None

    def save_step_checkpoint(self, step: int) -> bool:
        """Copy every local shard's shm to storage and commit when the
        job-wide shard set is complete. ``step`` is advisory — the shm
        contents (one consistent step across shards) win."""
        with self._persist_lock:
            snapshots = self._snapshot_shards()
            if snapshots is None:
                return False
            step = snapshots[0][0]
            # The staged metadata names the trainer's checkpoint dir —
            # authoritative even when the only save events so far were
            # memory-only (flash fast path flushed before a restart).
            staged_dir = (snapshots[0][2].get("_checkpoint_dir")
                          or "").rstrip("/")
            if staged_dir and staged_dir != self.checkpoint_dir:
                logger.info(
                    "adopting staged checkpoint dir %s", staged_dir)
                self.checkpoint_dir = staged_dir
                self._persisted_step = self._read_tracker()
            if step <= self._persisted_step:
                return True
            wdir = writing_dir(self.checkpoint_dir, step)
            ddir = done_dir(self.checkpoint_dir, step)
            with ThreadPoolExecutor(
                    max_workers=min(8, self.local_shard_num)) as pool:
                futs = [
                    pool.submit(self._persist_shard, wdir, step,
                                entries, extra, payload)
                    for _, entries, extra, payload in snapshots
                ]
                ranks = [f.result() for f in futs]
            for rank in ranks:
                self.storage.write_bytes(b"", f"{ddir}/{rank}.done")
            if self.is_commit_owner:
                committed = self.commit_checkpoint(step)
            else:
                committed = self._wait_commit(step)
            if committed:
                self._persisted_step = step
                self._status.set("latest_persisted_step", step)
            return committed

    def _persist_shard(self, wdir: str, step: int, entries, extra,
                       payload: bytes) -> int:
        rank = int(extra.get("_global_rank", 0))
        data = pack_shard_file(step, entries, extra, payload)
        self.storage.write_bytes(data, f"{wdir}/shard_{rank}.ckpt")
        return rank

    def _read_tracker(self) -> int:
        path = f"{self.checkpoint_dir}/{TRACKER_FILE}"
        try:
            if self.storage.exists(path):
                return int(self.storage.read_bytes(path).decode().strip())
        except (ValueError, OSError):
            pass
        return -1

    def commit_checkpoint(self, step: int) -> bool:
        """Wait for all ranks' done-files, then publish: rename temp
        dir → step dir, update tracker, sweep stale temp dirs. Every
        stage is idempotent so a committer crash at any point can be
        retried by the restarted agent."""
        wdir = writing_dir(self.checkpoint_dir, step)
        sdir = step_dir(self.checkpoint_dir, step)
        ddir = done_dir(self.checkpoint_dir, step)
        deadline = time.monotonic() + self.commit_timeout
        while time.monotonic() < deadline:
            if self.storage.exists(sdir):
                break  # rename already happened (this run or a prior one)
            done = [f for f in self.storage.listdir(ddir)
                    if f.endswith(".done")]
            if len(done) >= self.global_shard_num:
                self.storage.rename(wdir, sdir)
                break
            time.sleep(0.1)
        else:
            logger.error(
                "commit timeout for step %s: %s/%s shards done",
                step, len(self.storage.listdir(ddir)),
                self.global_shard_num)
            return False
        if self._read_tracker() < step:
            self.storage.write_bytes(
                str(step).encode(),
                f"{self.checkpoint_dir}/{TRACKER_FILE}")
        self.storage.rmtree(ddir)
        self._sweep_stale(step)
        logger.info("committed checkpoint step %s", step)
        return True

    def _sweep_stale(self, committed_step: int) -> None:
        """Remove writing/done dirs from failed or superseded attempts
        (≤ the committed step) so commit timeouts never leak a full
        checkpoint's worth of storage."""
        for name in self.storage.listdir(self.checkpoint_dir):
            for prefix in (WRITING_PREFIX, ".done_"):
                if not name.startswith(prefix):
                    continue
                try:
                    s = int(name[len(prefix):])
                except ValueError:
                    continue
                if s <= committed_step:
                    self.storage.rmtree(
                        f"{self.checkpoint_dir}/{name}")

    def _wait_commit(self, step: int) -> bool:
        """Non-owner agents wait for the owner's rename to land."""
        sdir = step_dir(self.checkpoint_dir, step)
        deadline = time.monotonic() + self.commit_timeout
        while time.monotonic() < deadline:
            if self.storage.exists(sdir):
                return True
            time.sleep(0.1)
        return False

    def save_shm_to_storage(self) -> bool:
        """Flush whatever step the shm currently holds — called on
        SIGTERM, on trainer failure, and before an elastic restart
        (the reference's _save_ckpt_to_storage, training.py:572)."""
        with self._locks[0]:
            snap = self._shms[0].load()
        if snap is None:
            logger.info("no shm checkpoint state to flush")
            return False
        if snap[0] <= self._persisted_step:
            logger.info("shm step %s already persisted", snap[0])
            return True
        logger.info("flushing shm checkpoint step %s to storage",
                    snap[0])
        return self.save_step_checkpoint(snap[0])

    def latest_persisted_step(self) -> int:
        return self._persisted_step
