"""Worker-side dynamic sharding clients.

Parity: dlrover/python/elastic_agent/sharding/client.py:31,233
(ShardingClient / IndexShardingClient). The index client prefetches
sample indices from master-assigned shards on a background thread so
``fetch_sample_index()`` is cheap inside the input pipeline.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common import messages as msg

logger = get_logger("sharding_client")


class ShardingClient:
    """Fetches whole shards; reports completion."""

    def __init__(
        self,
        dataset_name: str,
        client: Optional[MasterClient] = None,
    ):
        self.dataset_name = dataset_name
        self._client = client or MasterClient.singleton()
        self._pending: Dict[int, msg.Task] = {}
        self._lock = threading.Lock()

    def create_dataset(
        self,
        dataset_size: int,
        batch_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        num_minibatches_per_shard: int = 2,
        storage_type: str = "table",
        num_stream_partitions: int = 1,
    ) -> None:
        self._client.create_dataset(
            dataset_name=self.dataset_name,
            dataset_size=dataset_size,
            batch_size=batch_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            num_minibatches_per_shard=num_minibatches_per_shard,
            storage_type=storage_type,
            num_stream_partitions=num_stream_partitions,
        )

    def stream_barrier(self, epoch: int, step: int):
        """Commit a stream barrier for this dataset (caller quiesces
        its sparse applies first)."""
        return self._client.stream_barrier(
            self.dataset_name, epoch=epoch, step=step
        )

    def query_stream_barrier(self):
        return self._client.query_stream_barrier(self.dataset_name)

    def get_task(
        self,
        wait: bool = True,
        timeout: float = 300.0,
        return_wait: bool = False,
    ):
        """Returns the next Task or None when the dataset is
        exhausted. ``return_wait=True`` hands back the WAIT task
        itself instead of blocking/None, so callers holding
        deliverables (deferred-completion producers) can flush before
        the master's wait-for-doing-shards would deadlock them."""
        deadline = time.monotonic() + timeout
        while True:
            task = self._client.get_task(self.dataset_name)
            if task.task_type == TaskType.WAIT:
                if return_wait:
                    return task
                if not wait or time.monotonic() > deadline:
                    return None
                time.sleep(1.0)
                continue
            if task.task_type == TaskType.NONE or task.task_id < 0:
                return None
            with self._lock:
                self._pending[task.task_id] = task
            return task

    def report_task_done(self, task_id: int, success: bool = True) -> None:
        with self._lock:
            self._pending.pop(task_id, None)
        self._client.report_task_result(
            self.dataset_name, task_id, success
        )

    def checkpoint(self) -> str:
        return self._client.get_shard_checkpoint(self.dataset_name)

    def restore(self, content: str) -> None:
        self._client.restore_shard_checkpoint(self.dataset_name, content)


class IndexShardingClient(ShardingClient):
    """Streams individual sample indices out of master-assigned shards.

    The dataset's ``__getitem__`` asks for the next index; shard
    boundaries and completion reporting stay invisible to user code.
    """

    def __init__(
        self,
        dataset_name: str,
        batch_size: int,
        client: Optional[MasterClient] = None,
        defer_completion: bool = False,
    ):
        """``defer_completion=True`` changes WHEN a fully-consumed
        shard is reported done: not at the moment its last index is
        popped (the producer may still die with the materialized batch
        in hand — silently lost, since the master would never
        re-dispatch a "done" shard), but at the next explicit
        :meth:`confirm_delivered` call, which producers place right
        after the downstream hand-off (shm ring put / remote push
        ack). That makes shard completion mean "delivered", the
        at-least-once contract the chaos drills check."""
        super().__init__(dataset_name, client)
        self.batch_size = batch_size
        self.defer_completion = defer_completion
        self._indices: Deque[int] = deque()
        self._index_lock = threading.Lock()
        # task_id -> remaining sample count; completion reported at 0
        self._task_remaining: Dict[int, int] = {}
        self._current_task_queue: Deque[int] = deque()
        self._consumed_unconfirmed: List[int] = []
        self._exhausted = False

    #: fetch_sample_index(block=False) sentinel: the master answered
    #: WAIT (doing shards may still be re-queued) — the caller should
    #: flush/confirm anything it holds and retry.
    WOULD_WAIT = object()

    def fetch_sample_index(self, block: bool = True):
        """Next sample index; None when the dataset is exhausted.

        ``block=False`` returns :data:`WOULD_WAIT` instead of blocking
        when the master says WAIT. Deferred-completion producers MUST
        use this: with ``defer_completion=True`` the un-confirmed
        shard they still hold is exactly what the master is waiting
        on, so blocking here would deadlock until the shard timeout
        re-queues it — and then a stale confirm would mark the
        re-dispatched copy done with its tail batch undelivered."""
        with self._index_lock:
            if self._indices:
                self._account_consumed()
                return self._indices.popleft()
        if self._exhausted:
            return None
        if not self._prefetch(block=block):
            return self.WOULD_WAIT
        with self._index_lock:
            if not self._indices:
                return None
            self._account_consumed()
            return self._indices.popleft()

    def _account_consumed(self) -> None:
        # Called with _index_lock held, BEFORE popping one index.
        while self._current_task_queue:
            tid = self._current_task_queue[0]
            if self._task_remaining.get(tid, 0) > 0:
                self._task_remaining[tid] -= 1
                if self._task_remaining[tid] == 0:
                    self._current_task_queue.popleft()
                    done_tid = tid
                    if self.defer_completion:
                        self._consumed_unconfirmed.append(done_tid)
                        return
                    # Report outside the lock via a thread to keep the
                    # input pipeline non-blocking.
                    threading.Thread(
                        target=self.report_task_done,
                        args=(done_tid,),
                        daemon=True,
                    ).start()
                return
            self._current_task_queue.popleft()

    def confirm_delivered(self) -> int:
        """Report done every fully-consumed shard whose indices were
        all popped BEFORE this call (defer_completion mode). Producers
        call it right after a successful downstream hand-off; batches
        are built in pop order, so the hand-off covers everything
        popped so far. Returns the number of shards reported.

        The reports ride a daemon thread like the non-defer path —
        the delivery-ordering requirement is already satisfied the
        moment the tids leave the unconfirmed list, so the producer's
        batch loop need not stall on master round-trips."""
        with self._index_lock:
            ready, self._consumed_unconfirmed = (
                self._consumed_unconfirmed, []
            )
        for tid in ready:
            threading.Thread(
                target=self.report_task_done, args=(tid,), daemon=True
            ).start()
        return len(ready)

    def _prefetch(self, block: bool = True) -> bool:
        """Pull one shard into the local queue. Returns False when
        ``block=False`` and the master answered WAIT."""
        task = self.get_task(wait=block, return_wait=not block)
        if task is not None and task.task_type == TaskType.WAIT:
            return False
        if task is None:
            self._exhausted = True
            return True
        shard = task.shard
        if shard.record_indices:
            indices: List[int] = list(shard.record_indices)
        else:
            indices = list(range(shard.start, shard.end))
        with self._index_lock:
            self._indices.extend(indices)
            self._task_remaining[task.task_id] = len(indices)
            self._current_task_queue.append(task.task_id)
        return True

    def reset(self) -> None:
        with self._index_lock:
            self._indices.clear()
            self._task_remaining.clear()
            self._current_task_queue.clear()
            # Unconfirmed completions must NOT survive a reset: the
            # master re-queues those shards, and confirming a stale
            # tid afterwards would mark the re-queued shard done with
            # its batches undelivered.
            self._consumed_unconfirmed.clear()
            self._exhausted = False
