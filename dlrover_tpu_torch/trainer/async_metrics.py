"""Asynchronous scalar reporting (counterpart of
``dlrover_tpu/trainer/async_metrics.py``): keep the hot loop free of
host syncs.

``loss.item()`` on a freshly launched step waits for the card to finish
everything queued before it. The trainer instead hands the device
scalar to an :class:`AsyncScalarReporter`, which records a CUDA event
behind it and emits it only once that event has completed -- in
practice one step late. :meth:`AsyncScalarReporter.flush` delivers the
tail, so every offered step is emitted exactly once, in order.

Every intentional materialization is counted in ``HOST_SYNCS`` by
reason.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

HOST_SYNCS: collections.Counter = collections.Counter()

DEFAULT_MAX_PENDING = 8


def materialize(value, reason: str = "metrics") -> float:
    """Device scalar -> float (a host sync, counted under ``reason``)."""
    HOST_SYNCS[reason] += 1
    if isinstance(value, (int, float)):
        return float(value)
    return float(value.item())


def _ready_marker(value):
    """A CUDA event recorded behind ``value``'s computation, or None
    when the value is already on the host."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
        return event
    return None


class AsyncScalarReporter:
    """Bounded, ordered, exactly-once scalar drain.

    ``emit_fn(step, value_float, **tags)`` is called for every offered
    entry, oldest first. :meth:`offer` blocks only when more than
    ``max_pending`` entries wait; the oldest is then materialized.
    """

    def __init__(
        self,
        emit_fn: Callable,
        max_pending: int = DEFAULT_MAX_PENDING,
        reason: str = "metrics",
    ):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.emit_fn = emit_fn
        self.max_pending = max_pending
        self.reason = reason
        self._pending: collections.deque = collections.deque()
        self.emitted = 0

    def __len__(self) -> int:
        return len(self._pending)

    def offer(self, step: int, value, **tags) -> None:
        """Queue a (step, device scalar) and drain whatever is ready."""
        self._pending.append((step, value, _ready_marker(value), tags))
        self.drain_ready()
        while len(self._pending) > self.max_pending:
            self._emit_oldest()

    def drain_ready(self) -> int:
        """Emit leading entries whose values are computed; never
        blocks. Returns how many were emitted."""
        n = 0
        while self._pending:
            marker = self._pending[0][2]
            if marker is not None and not marker.query():
                break
            self._emit_oldest()
            n += 1
        return n

    def flush(self) -> int:
        """Materialize and emit everything pending (blocking)."""
        n = 0
        while self._pending:
            self._emit_oldest()
            n += 1
        return n

    def _emit_oldest(self) -> None:
        step, value, _, tags = self._pending.popleft()
        self.emit_fn(step, materialize(value, reason=self.reason), **tags)
        self.emitted += 1
