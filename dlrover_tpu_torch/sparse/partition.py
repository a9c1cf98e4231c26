"""Hash partitioning for the distributed embedding store.

Capability parity with the reference's PS sharding model
(dlrover/python/master/node/ps.py — fixed PS set per training session,
tfplus partitioned KvVariables): keys are mapped to a fixed number of
*virtual partitions* by a 64-bit mix hash, and partitions are assigned
to PS nodes by a versioned PartitionMap owned by the master. Scaling
moves whole partitions (not individual keys), so a reshard is a
bounded set of delta export/import transfers and the map version is
the only coordination point workers need.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# Virtual partitions. Power of two, far above any realistic PS count,
# so every reshard moves ~1/P of the keyspace per partition moved.
NUM_PARTITIONS = 64


def key_partition(keys: np.ndarray, num_partitions: int = NUM_PARTITIONS
                  ) -> np.ndarray:
    """[n] int64 -> [n] int32 partition ids via a splitmix64-style mix
    (plain ``key % P`` would stripe structured id spaces onto few
    partitions)."""
    k = np.asarray(keys, np.uint64)
    k = (k ^ (k >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    k = (k ^ (k >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    k = k ^ (k >> np.uint64(31))
    return (k % np.uint64(num_partitions)).astype(np.int32)


def group_by_partition(
    keys: np.ndarray, num_partitions: int = NUM_PARTITIONS
) -> Dict[int, np.ndarray]:
    """partition id -> indices (into ``keys``) that hash to it. The
    shared grouping for per-partition work: delta-flush file layout
    and the replay fence's per-partition dedup both key on it, so a
    partition restored on a new owner sees exactly the key set the
    old owner's fence covered."""
    parts = key_partition(keys, num_partitions)
    out: Dict[int, np.ndarray] = {}
    for p in np.unique(parts):
        out[int(p)] = np.nonzero(parts == p)[0]
    return out


@dataclasses.dataclass
class PartitionMap:
    """Versioned assignment of virtual partitions to PS node ids.

    ``assignment[p]`` = ps node id owning partition p. The version
    increments on every change; PS servers reject requests carrying a
    stale version so workers refetch before retrying (the reference's
    worker SyncService barrier collapses into this version check).
    """

    version: int = 0
    assignment: List[int] = dataclasses.field(default_factory=list)
    # ps id -> "host:port" for direct worker connections
    ps_addrs: Dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def num_partitions(self) -> int:
        return len(self.assignment)

    def ps_ids(self) -> List[int]:
        return sorted(set(self.assignment))

    def partitions_of(self, ps_id: int) -> List[int]:
        return [p for p, owner in enumerate(self.assignment)
                if owner == ps_id]

    def group_keys(self, keys: np.ndarray) -> Dict[int, np.ndarray]:
        """ps id -> indices (into ``keys``) this ps owns."""
        parts = key_partition(keys, self.num_partitions)
        owners = np.asarray(self.assignment, np.int64)[parts]
        out: Dict[int, np.ndarray] = {}
        for ps_id in np.unique(owners):
            out[int(ps_id)] = np.nonzero(owners == ps_id)[0]
        return out


def balanced_assignment(
    ps_ids: List[int],
    num_partitions: int = NUM_PARTITIONS,
    previous: Optional[PartitionMap] = None,
) -> List[int]:
    """Assign partitions to ``ps_ids``, moving as few as possible from
    ``previous`` (consistent-hashing-style stability without the ring:
    keep owned partitions where the owner survives, rebalance the rest
    round-robin onto the least-loaded nodes)."""
    if not ps_ids:
        raise ValueError("no PS nodes to assign partitions to")
    alive = set(ps_ids)
    target = [-1] * num_partitions
    load: Dict[int, int] = {ps: 0 for ps in ps_ids}
    cap = -(-num_partitions // len(ps_ids))  # ceil: max partitions/ps
    if previous is not None and previous.assignment:
        for p, owner in enumerate(previous.assignment):
            if p < num_partitions and owner in alive and load[owner] < cap:
                target[p] = owner
                load[owner] += 1
    for p in range(num_partitions):
        if target[p] < 0:
            ps = min(ps_ids, key=lambda i: load[i])
            target[p] = ps
            load[ps] += 1
    return target
