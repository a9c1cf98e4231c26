"""Dataset splitters for dynamic data sharding.

Parity: dlrover/python/master/shard/dataset_splitter.py:144,257,359
(TableDatasetSplitter / TextDatasetSplitter / StreamingDatasetSplitter).
A splitter turns a dataset into epoch-aware shards of
``batch_size * num_minibatches_per_shard`` records; the TaskManager
queues them to workers. On TPU the worker side maps shard index ranges
onto per-host `jax.Array` feed batches.
"""

from __future__ import annotations

import dataclasses
import json
import random
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("splitter")


@dataclasses.dataclass
class Shard:
    """A contiguous [start, end) range of records of one dataset.

    ``record_indices`` optionally carries a shuffled index list for
    text-style datasets where order must be randomized per epoch.
    ``partition`` is the stream partition the shard was fabricated
    from (streaming datasets only; 0 otherwise) — start/end then index
    that partition's own record space, and ``record_indices`` carries
    the striped global record ids.
    """

    name: str
    start: int
    end: int
    record_indices: Optional[List[int]] = None
    partition: int = 0


class DatasetSplitter(ABC):
    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
    ):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = shard_size
        self.num_epochs = num_epochs
        self.epoch = 0

    @abstractmethod
    def create_shards(self) -> None:
        """Populate shards for the next epoch."""

    @abstractmethod
    def get_shards(self) -> List[Shard]:
        ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs

    def to_checkpoint(self) -> dict:
        return {
            "dataset_name": self.dataset_name,
            "dataset_size": self.dataset_size,
            "shard_size": self.shard_size,
            "num_epochs": self.num_epochs,
            "epoch": self.epoch,
        }

    def restore_checkpoint(self, state: dict) -> None:
        self.epoch = state.get("epoch", 0)


class TableDatasetSplitter(DatasetSplitter):
    """Shards a record-addressable table dataset by index ranges."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        max_shard_count: int = 50000,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self.shuffle = shuffle
        self.max_shard_count = max_shard_count
        self._shards: List[Shard] = []

    def create_shards(self) -> None:
        # Huge datasets are covered in sub-epoch windows of at most
        # max_shard_count shards: keep a sliding offset and only advance
        # the epoch once the window reaches the end of the data, so no
        # record is ever silently dropped (parity with the reference's
        # _split_epoch_for_huge_dataset).
        offset = getattr(self, "_sub_offset", 0)
        if offset == 0:
            self.epoch += 1
        shards = []
        window_records = self.max_shard_count * self.shard_size
        end_of_window = min(offset + window_records, self.dataset_size)
        for start in range(offset, end_of_window, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(Shard(self.dataset_name, start, end))
        self._sub_offset = 0 if end_of_window >= self.dataset_size else end_of_window
        if self.shuffle:
            random.shuffle(shards)
        self._shards = shards
        logger.info(
            "dataset %s epoch %d: %d shards of %d records "
            "(window [%d, %d))",
            self.dataset_name,
            self.epoch,
            len(shards),
            self.shard_size,
            offset,
            end_of_window,
        )

    def epoch_finished(self) -> bool:
        # Mid-window: the current epoch still has uncovered records.
        if getattr(self, "_sub_offset", 0) > 0:
            return False
        return super().epoch_finished()

    def get_shards(self) -> List[Shard]:
        return self._shards

    def to_checkpoint(self) -> dict:
        state = super().to_checkpoint()
        state["sub_offset"] = getattr(self, "_sub_offset", 0)
        return state

    def restore_checkpoint(self, state: dict) -> None:
        super().restore_checkpoint(state)
        self._sub_offset = state.get("sub_offset", 0)


class TextDatasetSplitter(DatasetSplitter):
    """Shards a line-indexed text dataset, shuffling record indices
    within (and optionally across) shards per epoch."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self.shuffle = shuffle
        self._shards: List[Shard] = []

    def create_shards(self) -> None:
        self.epoch += 1
        indices = list(range(self.dataset_size))
        if self.shuffle:
            random.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(
                    self.dataset_name,
                    start,
                    end,
                    record_indices=indices[start:end],
                )
            )
        self._shards = shards

    def get_shards(self) -> List[Shard]:
        return self._shards


class StreamingDatasetSplitter(DatasetSplitter):
    """Shards an unbounded stream by advancing per-partition offsets.

    ``dataset_size`` < 0 means infinite; shards are fabricated on
    demand from the current offsets. The stream is striped across
    ``num_stream_partitions``: partition p owns global record ids
    {p, p+P, p+2P, ...} (TextDatasetSplitter's record_indices idiom),
    so independent sources can be consumed concurrently while every
    global id still belongs to exactly one shard.

    Two cursors per partition survive checkpoints:

    * ``part_offsets[p]`` — fabrication frontier: next record (in the
      partition's own space) no shard has been cut for yet.
    * ``watermarks[p]`` — completion frontier: records below it were
      reported done contiguously. Out-of-order completions park in
      ``_done_ranges`` until the gap closes. The watermark is what a
      stream barrier stamps into PS flushes: everything below it is
      both applied and flushed, so neither a PS restore nor a master
      warm restart can lose or re-deliver it.
    """

    def __init__(
        self,
        dataset_name: str,
        shard_size: int,
        dataset_size: int = -1,
        num_epochs: int = 1,
        fetch_batch: int = 100,
        num_stream_partitions: int = 1,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self.fetch_batch = fetch_batch
        self.num_stream_partitions = max(1, int(num_stream_partitions))
        parts = range(self.num_stream_partitions)
        self.part_offsets: Dict[int, int] = {p: 0 for p in parts}
        self.watermarks: Dict[int, int] = {p: 0 for p in parts}
        self._done_ranges: Dict[int, List[List[int]]] = {
            p: [] for p in parts
        }
        self._shards: List[Shard] = []

    @property
    def offset(self) -> int:
        """Total records fabricated across partitions (legacy view)."""
        return sum(self.part_offsets.values())

    def partition_size(self, partition: int) -> int:
        """Record count of one stripe, -1 if the stream is unbounded."""
        if self.dataset_size < 0:
            return -1
        p, n = partition, self.num_stream_partitions
        return max(0, (self.dataset_size - p + n - 1) // n)

    def epoch_finished(self) -> bool:
        if self.dataset_size < 0:
            return False
        return all(
            self.part_offsets[p] >= self.partition_size(p)
            for p in range(self.num_stream_partitions)
        )

    def _global_ids(self, partition: int, start: int, end: int
                    ) -> List[int]:
        n = self.num_stream_partitions
        return [partition + n * i for i in range(start, end)]

    def create_shards(self) -> None:
        if self.epoch == 0:
            self.epoch = 1
        shards: List[Shard] = []
        parts = list(range(self.num_stream_partitions))
        while len(shards) < self.fetch_batch:
            open_parts = [
                p for p in parts
                if self.partition_size(p) < 0
                or self.part_offsets[p] < self.partition_size(p)
            ]
            if not open_parts:
                break
            # Round-robin the least-advanced partition so stripes
            # drain evenly and no watermark lags just from scheduling.
            p = min(open_parts, key=lambda q: self.part_offsets[q])
            start = self.part_offsets[p]
            end = start + self.shard_size
            if self.partition_size(p) >= 0:
                end = min(end, self.partition_size(p))
            shards.append(Shard(
                self.dataset_name, start, end,
                record_indices=self._global_ids(p, start, end),
                partition=p,
            ))
            self.part_offsets[p] = end
        self._shards = shards

    def get_shards(self) -> List[Shard]:
        return self._shards

    def mark_done(self, partition: int, start: int, end: int) -> None:
        """Record [start, end) of ``partition`` as applied; advance the
        watermark over every contiguously-done range."""
        if end <= start:
            return
        wm = self.watermarks.get(partition, 0)
        if end <= wm:
            return  # duplicate report of an already-passed range
        ranges = self._done_ranges.setdefault(partition, [])
        ranges.append([max(start, wm), end])
        ranges.sort()
        merged: List[List[int]] = []
        for r in ranges:
            if merged and r[0] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], r[1])
            else:
                merged.append(list(r))
        while merged and merged[0][0] <= wm:
            wm = max(wm, merged.pop(0)[1])
        self.watermarks[partition] = wm
        self._done_ranges[partition] = merged

    def watermark_records(self) -> int:
        """Total contiguously-applied records across partitions."""
        return sum(self.watermarks.values())

    def to_checkpoint(self) -> dict:
        state = super().to_checkpoint()
        state["offset"] = self.offset
        state["num_stream_partitions"] = self.num_stream_partitions
        state["part_offsets"] = {
            str(p): o for p, o in self.part_offsets.items()
        }
        state["watermarks"] = {
            str(p): w for p, w in self.watermarks.items()
        }
        state["done_ranges"] = {
            str(p): [list(r) for r in rs]
            for p, rs in self._done_ranges.items()
        }
        return state

    def restore_checkpoint(self, state: dict) -> None:
        super().restore_checkpoint(state)
        self.num_stream_partitions = max(
            1, int(state.get("num_stream_partitions", 1))
        )
        parts = range(self.num_stream_partitions)
        if "part_offsets" in state:
            self.part_offsets = {
                p: int(state["part_offsets"].get(str(p), 0))
                for p in parts
            }
            self.watermarks = {
                p: int(state.get("watermarks", {}).get(str(p), 0))
                for p in parts
            }
            self._done_ranges = {
                p: [
                    [int(a), int(b)]
                    for a, b in state.get("done_ranges", {}).get(
                        str(p), []
                    )
                ]
                for p in parts
            }
        else:
            # Pre-watermark checkpoint: a single scalar offset.
            self.part_offsets = {p: 0 for p in parts}
            self.part_offsets[0] = int(state.get("offset", 0))
            self.watermarks = {p: 0 for p in parts}
            self._done_ranges = {p: [] for p in parts}


def new_dataset_splitter(
    storage_type: str,
    dataset_name: str,
    dataset_size: int,
    shard_size: int,
    num_epochs: int = 1,
    shuffle: bool = False,
    num_stream_partitions: int = 1,
) -> DatasetSplitter:
    if storage_type in ("", "table"):
        return TableDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "text":
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "streaming":
        return StreamingDatasetSplitter(
            dataset_name, shard_size, dataset_size, num_epochs,
            num_stream_partitions=num_stream_partitions,
        )
    raise ValueError(f"unknown dataset storage type {storage_type!r}")


def splitter_state_to_json(splitter: DatasetSplitter, extra: dict) -> str:
    state = splitter.to_checkpoint()
    state.update(extra)
    return json.dumps(state)
