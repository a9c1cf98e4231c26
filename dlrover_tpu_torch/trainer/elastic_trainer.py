"""ElasticTrainer: a fixed global batch size under elasticity
(counterpart of ``dlrover_tpu/trainer/elastic_trainer.py``).

The global batch the user asked for stays constant while the number of
data-parallel shards changes, by recomputing the gradient accumulation
factor for every world. The shards are the processes of the
``torch.distributed`` world (one, with no process group): each process
feeds its own ``local_samples_per_step`` samples, accumulates each
microbatch's gradients in f32, pre-scaled by 1/accum, into one flat
buffer, and after the last microbatch averages that buffer and the loss
over the world with one ``all_reduce``, so every rank applies the same
optimizer update to the same parameters. The JAX trainer's step takes
the same mean over the mesh's data axis. The overlapped and pipelined
steps, the mesh, the MFU meter and the metrics registry come with later
slices (ROADMAP queue 1).

``ElasticDistributedSampler`` and ``ElasticDataLoader`` are framework
free and copied as they are: the same seed and epoch give the same
sample order as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.tree import (
    tree_flatten,
    tree_leaves,
    tree_unflatten,
)
from dlrover_tpu_torch.trainer.async_metrics import AsyncScalarReporter
from dlrover_tpu_torch.trainer.step import value_and_grad

logger = get_logger("elastic_trainer")


def gradient_accumulation_steps(
    global_batch_size: int, micro_batch_size: int, num_shards: int
) -> int:
    """Microbatches per optimizer update so that
    num_shards * micro_batch_size * accum >= global_batch_size: the
    effective batch never shrinks when nodes are lost."""
    per_step = micro_batch_size * num_shards
    return (global_batch_size + per_step - 1) // per_step


@dataclasses.dataclass
class TrainerReport:
    """Per-step scalars for the master speed monitor."""

    step: int
    loss: float
    global_batch_size: int
    accum_steps: int


class ElasticTrainer:
    """Accumulate-then-update steps at a fixed global batch size.

    Parameters
    ----------
    loss_fn: ``loss_fn(params, tokens, targets) -> scalar``.
    optimizer: an object with ``update(grads, state, params) ->
        (params, state)`` (``optim.adamw.AdamW``).
    global_batch_size: samples per optimizer update.
    micro_batch_size: samples the device holds at once.
    device: where batches go; CUDA unless the caller passes
        ``device="cpu"``.
    report_fn: optional callback(TrainerReport), fed one step late.

    ``num_shards`` is the ``torch.distributed`` world size when a
    process group is initialised (its gradients are then averaged over
    the group, a world of one included), else 1.
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer,
        global_batch_size: int,
        micro_batch_size: int,
        device: DeviceLike = None,
        report_fn: Optional[Callable[[TrainerReport], None]] = None,
    ):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        dist = torch.distributed
        self.distributed = dist.is_available() and dist.is_initialized()
        self.num_shards = dist.get_world_size() if self.distributed else 1
        self.report_fn = report_fn
        self.accum_steps = gradient_accumulation_steps(
            global_batch_size, micro_batch_size, self.num_shards
        )
        self.step_num = 0
        self._value_and_grad = value_and_grad(loss_fn)
        self._reporter: Optional[AsyncScalarReporter] = None
        if report_fn is not None:
            self._reporter = AsyncScalarReporter(
                self._emit_report, reason="speed_report"
            )
        logger.info(
            "elastic trainer: %d shards x micro %d x accum %d >= global %d",
            self.num_shards, micro_batch_size, self.accum_steps,
            global_batch_size,
        )

    @property
    def samples_per_step(self) -> int:
        """Samples per optimizer update, over the whole world."""
        return self.accum_steps * self.micro_batch_size * self.num_shards

    @property
    def local_samples_per_step(self) -> int:
        """Samples THIS process supplies per optimizer update: its
        sharded sampler's slice of the global batch."""
        return self.accum_steps * self.micro_batch_size

    def shard_microbatches(self, tokens, targets):
        """This process's host batch [local_samples_per_step, ...] ->
        [accum, micro, ...] tensors on the trainer's device."""
        n, accum = self.local_samples_per_step, self.accum_steps

        def stage(x):
            x = torch.as_tensor(np.asarray(x[:n]))
            x = x.reshape((accum, -1) + tuple(x.shape[1:]))
            return x.to(self.device, non_blocking=True)

        return stage(tokens), stage(targets)

    def train_step(self, params, opt_state, tokens, targets):
        """One optimizer update over ``accum`` microbatches.

        tokens/targets: this process's numpy host arrays
        ([local_samples_per_step, ...]) or tensors already staged as
        [accum, micro, ...] (use :meth:`shard_microbatches`). Returns
        (params, opt_state, loss); the loss is a device scalar, the
        mean over the microbatches and the world -- read it with
        ``async_metrics.materialize``."""
        if not isinstance(tokens, torch.Tensor):
            tokens, targets = self.shard_microbatches(tokens, targets)
        expect = (self.accum_steps, self.micro_batch_size)
        if tokens.dim() < 2 or tuple(tokens.shape[:2]) != expect:
            raise ValueError(
                f"tensor batch must be staged as [accum={expect[0]}, "
                f"micro={expect[1]}, ...]; got {tuple(tokens.shape)} -- "
                "pass a numpy host batch or use shard_microbatches()"
            )
        accum = self.accum_steps
        flat = grads = None
        loss_sum = 0.0
        for mb in range(accum):
            loss, g = self._value_and_grad(params, tokens[mb], targets[mb])
            if flat is None:
                flat, grads = _flat_f32_like(g)
            # f32 accumulators, each microbatch pre-scaled by 1/accum.
            for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                if mb == 0:
                    acc.copy_(gi / accum)
                else:
                    acc.add_((gi / accum).float())
            loss_sum = loss_sum + loss
        loss = loss_sum / accum
        if self.distributed:
            # One all_reduce of the flat f32 gradients, the loss riding
            # in its last element: every rank then holds the world's
            # mean and applies the same update.
            flat[-1] = loss
            torch.distributed.all_reduce(flat)
            flat.div_(self.num_shards)
            loss = flat[-1].clone()
        params, opt_state = self.optimizer.update(grads, opt_state, params)
        self.step_num += 1
        if self._reporter is not None:
            self._reporter.offer(self.step_num, loss)
        return params, opt_state, loss

    def _emit_report(self, step: int, loss: float) -> None:
        self.report_fn(
            TrainerReport(
                step=step,
                loss=loss,
                global_batch_size=self.samples_per_step,
                accum_steps=self.accum_steps,
            )
        )

    def flush_metrics(self) -> None:
        """Deliver every pending loss report (blocking)."""
        if self._reporter is not None:
            self._reporter.flush()

    def state_dict(self) -> dict:
        return {"step_num": self.step_num}

    def load_state_dict(self, state: dict) -> None:
        self.step_num = int(state.get("step_num", 0))


def _flat_f32_like(tree):
    """(flat, views): one f32 buffer holding every leaf of ``tree`` and
    one more element, and a tree like ``tree`` of f32 views into it."""
    leaves, struct = tree_flatten(tree)
    sizes = [x.numel() for x in leaves]
    flat = torch.empty(sum(sizes) + 1, dtype=torch.float32,
                       device=leaves[0].device)
    views = [
        v.view(x.shape)
        for v, x in zip(flat[:-1].split(sizes), leaves)
    ]
    return flat, tree_unflatten(struct, views)


class ElasticDistributedSampler:
    """Checkpointable shuffling sampler.

    Yields dataset indices for this shard; ``state_dict`` records how
    many samples the epoch consumed, so a restart -- possibly with a
    different shard count -- resumes where training stopped.
    """

    def __init__(
        self,
        dataset_size: int,
        num_shards: int = 1,
        shard_rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not 0 <= shard_rank < num_shards:
            raise ValueError(
                f"shard_rank {shard_rank} not in [0, {num_shards})"
            )
        self.dataset_size = dataset_size
        self.num_shards = num_shards
        self.shard_rank = shard_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.consumed = 0  # samples consumed this epoch, global count

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.consumed = 0

    def _epoch_order(self):
        order = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        if self.drop_last:
            usable = self.dataset_size // self.num_shards * self.num_shards
            order = order[:usable]
        else:
            pad = (-len(order)) % self.num_shards
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order

    def __iter__(self):
        order = self._epoch_order()
        # Round-robin interleave: the global consumed counter stays
        # meaningful when the shard count changes on resume.
        for global_pos in range(
            self.consumed + self.shard_rank, len(order), self.num_shards
        ):
            self.consumed = global_pos + (self.num_shards - self.shard_rank)
            yield int(order[global_pos])

    def __len__(self):
        if self.drop_last:
            order_len = self.dataset_size // self.num_shards * self.num_shards
        else:
            order_len = self.dataset_size + (
                (-self.dataset_size) % self.num_shards
            )
        return max(0, order_len - self.consumed) // self.num_shards

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "consumed": self.consumed,
            "seed": self.seed,
        }

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state.get("epoch", 0))
        self.consumed = int(state.get("consumed", 0))
        self.seed = int(state.get("seed", self.seed))
        # Align to a shard boundary so no shard replays a neighbour's
        # sample after a world-size change.
        self.consumed -= self.consumed % self.num_shards


class ElasticDataLoader:
    """Batches a map-style dataset through a sampler (all indices in
    order without one), dropping a last partial batch. The JAX loader's
    master-driven sharding client arrives with the elastic launch slice
    (ROADMAP queue 1, item 6)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[ElasticDistributedSampler] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler

    def __iter__(self):
        indices = self.sampler if self.sampler is not None else range(
            len(self.dataset)
        )
        batch = []
        for idx in indices:
            batch.append(self.dataset[idx])
            if len(batch) == self.batch_size:
                yield _collate(batch)
                batch = []


def _collate(samples):
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(
            np.stack([s[i] for s in samples]) for i in range(len(first))
        )
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    return np.stack(samples)
