"""Dynamic data sharding: the master-side task manager.

Parity: dlrover/python/master/shard/task_manager.py:37 (TaskManager) and
batch_dataset_manager.py. Shards flow todo -> doing -> done; a shard
assigned to a worker that dies or times out goes back to todo, which is
what gives exactly-once(-ish) data consumption under elasticity without
any coordination in the training processes.

Two contracts matter for control-plane survivability:

* **Idempotent result reports.** Agents retry ``TaskResultRequest``
  across reconnects, and a replayed report can arrive after the shard
  was already completed or re-queued to another node. A report only
  acts when its task is still in ``doing`` AND it comes from the
  shard's *current* assignee — a stale replay can neither double-count
  a shard nor yank it from the node now working on it.
* **Warm-restart snapshots.** ``to_snapshot``/``restore_snapshot``
  capture every dataset (creation params + shard ledger, with doing
  shards kept assigned to their node). In-flight shards stay with
  their owners across a master bounce (the watchdog re-queues them
  only if the owner never completes them), and completion reports
  request an urgent journal flush — so a journaled completion is
  never re-dispatched. The floor is still at-least-once: a completion
  acknowledged in the instant between the ack and the journal write
  reaching disk can be re-dispatched after ``shard_timeout`` if the
  master dies in that window.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.dataset_splitter import (
    DatasetSplitter,
    Shard,
    new_dataset_splitter,
)

logger = get_logger("task_manager")


@dataclasses.dataclass
class Task:
    task_id: int
    task_type: str
    shard: Optional[Shard] = None

    @classmethod
    def wait_task(cls) -> "Task":
        return cls(task_id=-1, task_type=TaskType.WAIT)


@dataclasses.dataclass
class DoingTask:
    task: Task
    node_id: int
    start_time: float  # monotonic: feeds the shard-timeout watchdog


def _task_to_dict(task: Task) -> dict:
    return {
        "task_id": task.task_id,
        "start": task.shard.start if task.shard else 0,
        "end": task.shard.end if task.shard else 0,
        "indices": task.shard.record_indices if task.shard else None,
        "partition": task.shard.partition if task.shard else 0,
    }


class DatasetManager:
    """Todo/doing bookkeeping for one named dataset."""

    def __init__(
        self,
        splitter: DatasetSplitter,
        task_type: str,
        params: Optional[dict] = None,
    ):
        self.splitter = splitter
        self.task_type = task_type
        # Creation parameters, kept verbatim so a warm-restarted
        # master can rebuild this manager before restoring its ledger.
        self.params = dict(params or {})
        self.todo: List[Task] = []
        self.doing: Dict[int, DoingTask] = {}
        self._task_id = 0
        self._completed_step = 0

    def create_tasks(self) -> None:
        if self.splitter.epoch_finished():
            return
        self.splitter.create_shards()
        for shard in self.splitter.get_shards():
            self.todo.append(
                Task(
                    task_id=self._task_id,
                    task_type=self.task_type,
                    shard=shard,
                )
            )
            self._task_id += 1

    def get_task(self, node_id: int) -> Task:
        if not self.todo and not self.splitter.epoch_finished():
            self.create_tasks()
        if not self.todo:
            if self.doing:
                return Task.wait_task()  # epoch may still be recovered
            return Task(task_id=-1, task_type=TaskType.NONE)
        task = self.todo.pop(0)
        self.doing[task.task_id] = DoingTask(
            task, node_id, time.monotonic()
        )
        return task

    def report_done(
        self, task_id: int, success: bool, node_id: Optional[int] = None
    ) -> Optional[Task]:
        """Record one result report. Idempotent against replays:

        * a task no longer in ``doing`` (already completed, already
          re-queued, or never dispatched) is a no-op;
        * a report whose ``node_id`` is not the shard's current
          assignee (the original owner replaying after the watchdog
          re-queued and re-dispatched the shard) is ignored.
        """
        doing = self.doing.get(task_id)
        if doing is None:
            return None  # already done / re-queued / never dispatched
        if (
            node_id is not None
            and node_id >= 0
            and doing.node_id != node_id
        ):
            logger.warning(
                "ignoring stale result for task %d from node %d "
                "(currently assigned to node %d)",
                task_id, node_id, doing.node_id,
            )
            return None
        del self.doing[task_id]
        if not success:
            self.todo.insert(0, doing.task)
            return doing.task
        shard = doing.task.shard
        if shard is not None and hasattr(self.splitter, "mark_done"):
            # Streaming ledgers advance the per-partition watermark —
            # the completion frontier a stream barrier stamps into PS
            # flushes.
            self.splitter.mark_done(
                shard.partition, shard.start, shard.end
            )
        return None

    def recover_node_tasks(self, node_id: int) -> int:
        """Requeue all shards a dead node was working on."""
        recovered = 0
        for task_id in list(self.doing):
            if self.doing[task_id].node_id == node_id:
                doing = self.doing.pop(task_id)
                self.todo.insert(0, doing.task)
                recovered += 1
        return recovered

    def reassign_timeout_tasks(self, timeout: float) -> int:
        now = time.monotonic()
        n = 0
        for task_id in list(self.doing):
            doing = self.doing[task_id]
            if now - doing.start_time > timeout:
                self.doing.pop(task_id)
                self.todo.insert(0, doing.task)
                n += 1
        if n:
            logger.warning("reassigned %d timed-out shards", n)
        return n

    def finished(self) -> bool:
        return (
            self.splitter.epoch_finished()
            and not self.todo
            and not self.doing
        )

    def to_checkpoint(self) -> dict:
        """Snapshot undone shards so a restarted job resumes data
        exactly. ``todo`` holds unassigned shards; ``doing`` keeps the
        in-flight ones with their assignee, so a master warm restart
        can leave them with their owners instead of re-queueing work
        an agent is mid-way through (which would double-process it
        when the agent's completion report lands after reconnect)."""
        return {
            "splitter": self.splitter.to_checkpoint(),
            "todo": [_task_to_dict(t) for t in self.todo],
            "doing": [
                {**_task_to_dict(d.task), "node_id": d.node_id}
                for d in self.doing.values()
            ],
            "next_task_id": self._task_id,
        }

    def restore_checkpoint(
        self, state: dict, keep_doing: bool = False
    ) -> None:
        """``keep_doing=False`` (trainer-driven resume of a FRESH job:
        the old workers are gone) folds in-flight shards back into
        todo; ``keep_doing=True`` (master warm restart: the workers
        are still out there) restores them as doing with a fresh
        timeout clock."""
        self.splitter.restore_checkpoint(state.get("splitter", {}))
        self.todo = []
        self.doing = {}

        def _shard(t: dict) -> Shard:
            return Shard(
                name=self.splitter.dataset_name,
                start=t["start"],
                end=t["end"],
                record_indices=t.get("indices"),
                partition=int(t.get("partition", 0)),
            )

        def _task(t: dict) -> Task:
            return Task(
                task_id=t["task_id"],
                task_type=self.task_type,
                shard=_shard(t),
            )

        for t in state.get("todo", []):
            self.todo.append(_task(t))
        for t in state.get("doing", []):
            if keep_doing:
                self.doing[t["task_id"]] = DoingTask(
                    _task(t), int(t.get("node_id", -1)), time.monotonic()
                )
            else:
                self.todo.append(_task(t))
        self._task_id = state.get(
            "next_task_id", len(self.todo) + len(self.doing)
        )


class TaskManager:
    """All datasets of one job + the shard-timeout watchdog."""

    def __init__(self, shard_timeout: float = 300.0):
        self._lock = threading.Lock()
        self._datasets: Dict[str, DatasetManager] = {}
        self._completed_notified: set = set()
        # dataset -> last stream-barrier record (epoch, offsets,
        # watermarks, flush_gen); journaled with the snapshot.
        self._barriers: Dict[str, dict] = {}
        self.shard_timeout = shard_timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # callback(dataset_name) fired when a dataset completes
        self.on_dataset_complete: Optional[Callable[[str], None]] = None
        # Fired (outside the lock) after every ledger mutation; the
        # JobMaster points this at the state journal's mark_dirty.
        # ``urgent=True`` (completion reports) asks the journal to
        # skip its debounce: once a completion is acknowledged to the
        # agent, the window in which a master death could resurrect
        # the shard must be the write latency, not the debounce
        # interval.
        self.on_state_change: Optional[Callable[..., None]] = None

    def _changed(self, urgent: bool = False) -> None:
        cb = self.on_state_change
        if cb is not None:
            try:
                # The callback must accept urgent= (StateJournal.
                # mark_dirty does; so must any test double).
                cb(urgent=urgent)
            except Exception:  # noqa: BLE001
                pass

    def create_dataset(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
        task_type: str = TaskType.TRAINING,
        num_stream_partitions: int = 1,
    ) -> None:
        params = {
            "dataset_name": dataset_name,
            "dataset_size": dataset_size,
            "shard_size": shard_size,
            "num_epochs": num_epochs,
            "shuffle": shuffle,
            "storage_type": storage_type,
            "task_type": task_type,
            "num_stream_partitions": num_stream_partitions,
        }
        with self._lock:
            if dataset_name in self._datasets:
                return
            splitter = new_dataset_splitter(
                storage_type,
                dataset_name,
                dataset_size,
                shard_size,
                num_epochs,
                shuffle,
                num_stream_partitions=num_stream_partitions,
            )
            self._datasets[dataset_name] = DatasetManager(
                splitter, task_type, params=params
            )
        self._changed()

    def has_dataset(self, dataset_name: str) -> bool:
        with self._lock:
            return dataset_name in self._datasets

    def get_task(self, node_id: int, dataset_name: str) -> Task:
        completed = False
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return Task.wait_task()
            task = ds.get_task(node_id)
            if (
                task.task_type == TaskType.NONE
                and ds.finished()
                and dataset_name not in self._completed_notified
            ):
                self._completed_notified.add(dataset_name)
                completed = True
        # Fire the callback OUTSIDE the lock: it may re-enter TaskManager.
        if completed and self.on_dataset_complete:
            self.on_dataset_complete(dataset_name)
        if task.shard is not None:
            self._changed()
        return task

    def report_task_result(
        self,
        dataset_name: str,
        task_id: int,
        success: bool,
        node_id: Optional[int] = None,
    ) -> None:
        acted = False
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is not None:
                before = task_id in ds.doing
                ds.report_done(task_id, success, node_id=node_id)
                acted = before and task_id not in ds.doing
        # Urgent flush ONLY when the report actually retired or
        # re-queued a doing entry: a replay storm of no-op reports
        # after a mass reconnect must not become an fsync storm.
        if acted:
            self._changed(urgent=True)

    def recover_node_tasks(self, node_id: int) -> None:
        with self._lock:
            for ds in self._datasets.values():
                ds.recover_node_tasks(node_id)
        self._changed()

    # -- stream barriers ----------------------------------------------------

    def ledger_watermarks(self, dataset_name: str) -> dict:
        """Streaming ledger frontier: per-partition fabrication
        offsets, per-partition completion watermarks, and the total
        contiguously-applied record count (the barrier's HWM)."""
        with self._lock:
            ds = self._datasets.get(dataset_name)
            sp = ds.splitter if ds is not None else None
            if sp is None or not hasattr(sp, "watermarks"):
                return {"offsets": {}, "watermarks": {}, "records": 0}
            return {
                "offsets": dict(sp.part_offsets),
                "watermarks": dict(sp.watermarks),
                "records": sp.watermark_records(),
            }

    def record_barrier(
        self,
        dataset_name: str,
        epoch: int,
        step: int,
        flush_gen: int = 0,
        flushed_rows: int = 0,
    ) -> dict:
        """Pin the current streaming cut as the last barrier: (epoch,
        per-partition offsets + watermarks, PS flush generation) as one
        unit. Lives inside the warm-restart snapshot, so the journal
        write that makes it durable is the same one that makes the
        shard ledger durable — the atomicity the barrier contract
        needs."""
        frontier = self.ledger_watermarks(dataset_name)
        with self._lock:
            record = {
                "epoch": epoch,
                "step": step,
                "offsets": frontier["offsets"],
                "watermarks": frontier["watermarks"],
                "records": frontier["records"],
                "flush_gen": flush_gen,
                "flushed_rows": flushed_rows,
            }
            self._barriers[dataset_name] = record
        self._changed(urgent=True)
        return dict(record)

    def last_barrier(self, dataset_name: str) -> Optional[dict]:
        with self._lock:
            rec = self._barriers.get(dataset_name)
            return dict(rec) if rec else None

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(ds.finished() for ds in self._datasets.values())

    # -- checkpoint ---------------------------------------------------------

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return ""
            return json.dumps(ds.to_checkpoint())

    def restore_shard_checkpoint(
        self, dataset_name: str, content: str
    ) -> bool:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None or not content:
                return False
            # Trainer-driven resume: the checkpoint's doing-owners are
            # from a previous job incarnation, so fold them into todo.
            ds.restore_checkpoint(json.loads(content), keep_doing=False)
        self._changed()
        return True

    # -- warm-restart snapshot ----------------------------------------------

    def to_snapshot(self) -> dict:
        """The whole shard ledger: per-dataset creation params +
        checkpoint state, so a restarted master can rebuild each
        DatasetManager and resume exactly."""
        with self._lock:
            return {
                "datasets": {
                    name: {
                        "params": dict(ds.params),
                        "state": ds.to_checkpoint(),
                    }
                    for name, ds in self._datasets.items()
                },
                "completed_notified": sorted(self._completed_notified),
                "barriers": {
                    name: dict(rec)
                    for name, rec in self._barriers.items()
                },
            }

    def reset(self) -> None:
        """Drop the whole ledger (cold-start cleanup when a warm
        restart fails half-way)."""
        with self._lock:
            self._datasets = {}
            self._completed_notified = set()
            self._barriers = {}

    def restore_snapshot(self, state: dict) -> None:
        for name, entry in state.get("datasets", {}).items():
            params = entry.get("params", {})
            self.create_dataset(
                dataset_name=params.get("dataset_name", name),
                dataset_size=int(params.get("dataset_size", 0)),
                shard_size=max(int(params.get("shard_size", 1)), 1),
                num_epochs=int(params.get("num_epochs", 1)),
                shuffle=bool(params.get("shuffle", False)),
                storage_type=params.get("storage_type", "table")
                or "table",
                task_type=params.get("task_type", TaskType.TRAINING)
                or TaskType.TRAINING,
                num_stream_partitions=int(
                    params.get("num_stream_partitions", 1)
                ),
            )
            with self._lock:
                ds = self._datasets[name]
                # Warm restart: the assignees are (probably) still
                # alive and mid-shard — keep doing as doing.
                ds.restore_checkpoint(
                    entry.get("state", {}), keep_doing=True
                )
        with self._lock:
            self._completed_notified = set(
                state.get("completed_notified", [])
            )
            # The JSON round-trip stringifies the per-partition dict
            # keys; the query path (StreamBarrierResponse) and the
            # live record_barrier path both speak int partitions.
            self._barriers = {}
            for name, rec in state.get("barriers", {}).items():
                rec = dict(rec)
                for field in ("offsets", "watermarks"):
                    rec[field] = {
                        int(p): int(v)
                        for p, v in rec.get(field, {}).items()
                    }
                self._barriers[name] = rec
        self._changed()

    # -- watchdog -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._watch_loop, name="shard-watchdog", daemon=True
        )
        self._thread.start()

    def _watch_loop(self) -> None:
        while not self._stop.wait(15.0):
            reassigned = 0
            with self._lock:
                for ds in self._datasets.values():
                    reassigned += ds.reassign_timeout_tasks(
                        self.shard_timeout
                    )
            if reassigned:
                self._changed()

    def stop(self) -> None:
        self._stop.set()
