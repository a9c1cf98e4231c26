"""Block-granular KV cache accounting for the decode service.

PagedAttention's memory model (vLLM, SOSP '23) applied to this repo's
dense multi-lane cache: the physical cache stays one preallocated
``[L, lanes, T_max, H_kv, D]`` pytree (models/generate.py — static
shapes, one compile), and this pool makes its *capacity* first-class:

* the cache is divided into fixed-size **blocks** of ``block_size``
  token positions; a sequence owns ``ceil(len / block_size)`` blocks
  and grows one block at a time as decode crosses block boundaries;
* the pool's ``total_blocks`` budget may be set BELOW the physical
  ``lanes * blocks_per_lane`` (the overcommit guard serving configs
  tune): admission and growth then gate on real memory accounting,
  not just on a free lane — the scheduler preempts instead of
  letting padded dead space masquerade as capacity;
* ``utilization`` is exported as ``dlrover_serve_kv_utilization`` so
  the fleet's obs plane sees KV pressure per replica.

Placement stays lane-affine (a sequence's blocks all live in its
lane): this keeps the decode step a plain vectorized scatter with no
gather-indirection table, at the cost of lane-internal fragmentation
the budget accounting makes visible instead of hiding.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from dlrover_tpu_torch import obs

_KV_BLOCKS_IN_USE = obs.gauge(
    "dlrover_serve_kv_blocks_in_use",
    "KV cache blocks currently allocated to live sequences on this "
    "replica",
)
_KV_UTILIZATION = obs.gauge(
    "dlrover_serve_kv_utilization",
    "Fraction of the replica's KV block budget currently allocated",
)
_KV_ALLOC_TOTAL = obs.counter(
    "dlrover_serve_kv_alloc_total",
    "KV block-pool allocation attempts on this replica, by outcome "
    "(admitted / grown / rejected / exhausted)",
    ("outcome",),
)


class KVBlockPool:
    """Alloc/free accounting of fixed-size KV blocks per sequence.

    Thread-safe (the replica's heartbeat thread reads utilization
    while the step loop allocates). Pure bookkeeping: the caller owns
    the physical cache arrays; the pool only answers "may this
    sequence exist / grow, and in which lane".
    """

    def __init__(
        self,
        lanes: int,
        max_len: int,
        block_size: int = 16,
        total_blocks: Optional[int] = None,
    ):
        if lanes < 1 or max_len < 1 or block_size < 1:
            raise ValueError(
                f"bad pool shape: lanes={lanes} max_len={max_len} "
                f"block_size={block_size}"
            )
        self.lanes = lanes
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_lane = -(-max_len // block_size)
        physical = lanes * self.blocks_per_lane
        self.total_blocks = (
            physical if total_blocks is None
            else min(int(total_blocks), physical)
        )
        if self.total_blocks < 1:
            raise ValueError("total_blocks must be >= 1")
        self._lock = threading.Lock()
        self._free_lanes: List[int] = list(range(lanes))
        # seq_id -> {"lane": int, "blocks": int, "length": int,
        #            "ticket": int}  (ticket orders preemption victims)
        self._seqs: Dict[str, dict] = {}
        self._in_use = 0
        self._ticket = 0
        self._publish_locked()

    # -- internal ----------------------------------------------------------

    def _publish_locked(self) -> None:
        _KV_BLOCKS_IN_USE.set(self._in_use)
        _KV_UTILIZATION.set(self._in_use / self.total_blocks)

    def blocks_for(self, length: int) -> int:
        """Blocks a sequence of ``length`` tokens owns (>= 1)."""
        return max(-(-length // self.block_size), 1)

    # -- allocation surface ------------------------------------------------

    def allocate(self, seq_id: str, length: int) -> Optional[int]:
        """Admit a sequence of ``length`` tokens: claim a free lane
        and its initial blocks. Returns the lane, or None when no
        lane or not enough block budget (the scheduler then leaves
        the request queued). Idempotent-hostile by design: a seq_id
        that is already resident raises — the scheduler must never
        double-admit."""
        blocks = self.blocks_for(length)
        with self._lock:
            if seq_id in self._seqs:
                raise KeyError(f"sequence {seq_id!r} already resident")
            if length > self.max_len:
                _KV_ALLOC_TOTAL.inc(outcome="rejected")
                return None
            if (
                not self._free_lanes
                or self._in_use + blocks > self.total_blocks
            ):
                _KV_ALLOC_TOTAL.inc(outcome="rejected")
                return None
            lane = self._free_lanes.pop(0)
            self._ticket += 1
            self._seqs[seq_id] = {
                "lane": lane,
                "blocks": blocks,
                "length": length,
                "ticket": self._ticket,
            }
            self._in_use += blocks
            self._publish_locked()
        _KV_ALLOC_TOTAL.inc(outcome="admitted")
        return lane

    def extend(self, seq_id: str, new_length: int) -> bool:
        """Grow a resident sequence to ``new_length`` tokens,
        allocating blocks as boundaries are crossed. False when the
        budget is exhausted (the scheduler preempts a victim and
        retries) or the lane itself is full."""
        with self._lock:
            rec = self._seqs.get(seq_id)
            if rec is None:
                raise KeyError(f"sequence {seq_id!r} not resident")
            if new_length <= rec["length"]:
                return True
            if new_length > self.max_len:
                _KV_ALLOC_TOTAL.inc(outcome="exhausted")
                return False
            need = self.blocks_for(new_length)
            extra = need - rec["blocks"]
            if extra <= 0:
                rec["length"] = new_length
                return True
            if self._in_use + extra > self.total_blocks:
                _KV_ALLOC_TOTAL.inc(outcome="exhausted")
                return False
            rec["blocks"] = need
            rec["length"] = new_length
            self._in_use += extra
            self._publish_locked()
        _KV_ALLOC_TOTAL.inc(outcome="grown")
        return True

    def release(self, seq_id: str) -> None:
        """Free a sequence's lane and blocks (finish, preemption, or
        drain). Unknown ids are a no-op — release must be safe to
        replay."""
        with self._lock:
            rec = self._seqs.pop(seq_id, None)
            if rec is None:
                return
            self._free_lanes.append(rec["lane"])
            self._free_lanes.sort()
            self._in_use -= rec["blocks"]
            self._publish_locked()

    # -- read surface ------------------------------------------------------

    def lane_of(self, seq_id: str) -> Optional[int]:
        with self._lock:
            rec = self._seqs.get(seq_id)
            return None if rec is None else rec["lane"]

    def resident(self) -> List[str]:
        with self._lock:
            return list(self._seqs)

    def free_lane_count(self) -> int:
        with self._lock:
            return len(self._free_lanes)

    def blocks_in_use(self) -> int:
        with self._lock:
            return self._in_use

    def utilization(self) -> float:
        with self._lock:
            return self._in_use / self.total_blocks

    def youngest(self) -> Optional[str]:
        """The preemption victim: the most recently admitted resident
        sequence (vLLM's recompute-preemption order — the youngest
        has the least sunk prefill cost to redo)."""
        with self._lock:
            if not self._seqs:
                return None
            return max(
                self._seqs.items(), key=lambda kv: kv[1]["ticket"]
            )[0]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "lanes": self.lanes,
                "block_size": self.block_size,
                "total_blocks": self.total_blocks,
                "blocks_in_use": self._in_use,
                "utilization": round(
                    self._in_use / self.total_blocks, 4
                ),
                "resident": len(self._seqs),
                "free_lanes": len(self._free_lanes),
            }
