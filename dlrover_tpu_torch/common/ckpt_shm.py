"""Flash-checkpoint shared-memory staging format.

TPU-native analogue of the reference's SharedMemoryHandler
(dlrover/python/elastic_agent/torch/ckpt_saver.py:232 —
_traverse_copy_to_shm/_write_shared_memory): the training process
flattens a sharded ``jax.Array`` pytree into one POSIX shm segment;
the host agent reads the segment back and persists it without ever
importing jax.  Layout::

    [8B little-endian meta length][msgpack meta][raw tensor bytes...]

meta = {
  "step": int,
  "extra": {...user metadata...},
  "entries": [
    {"name": "params/blocks/wqkv", "dtype": "bfloat16",
     "global_shape": [...], "index": [[start, stop], ...],
     "offset": N, "nbytes": M},
    ...
  ],
}

Each entry is one *addressable shard* of one pytree leaf, tagged with
its slice into the global (logical) array — this is what makes
reshard-on-load work: the loader reassembles global arrays from any
shard layout and re-shards them onto the new mesh, the moral
equivalent of the reference's FSDP reshard-on-restart
(atorch/utils/fsdp_save_util.py).

No jax import at module level: the agent-side saver runs in a process
that must stay light (and must not grab a TPU chip).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import msgpack
import numpy as np

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.multi_process import SharedMemoryHandle

logger = get_logger("ckpt_shm")

_META_LEN_BYTES = 8

# bfloat16 has no numpy dtype; stage it as raw uint16 words and tag the
# true dtype in meta so the loader can reinterpret via ml_dtypes/jax.
_RAW_DTYPES = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
               "float8_e5m2": np.uint8}


def _np_view(dtype_name: str):
    return _RAW_DTYPES.get(dtype_name)


def np_from_raw(data: np.ndarray, dtype_name: str) -> np.ndarray:
    """Reinterpret a raw-word staged array back to its true dtype."""
    if dtype_name in _RAW_DTYPES:
        import ml_dtypes

        return data.view(np.dtype(getattr(ml_dtypes, dtype_name)))
    return data


class TensorEntry:
    """One shard's placement in shm and in the global array."""

    __slots__ = ("name", "dtype", "global_shape", "index", "offset",
                 "nbytes")

    def __init__(self, name: str, dtype: str,
                 global_shape: Sequence[int],
                 index: Sequence[Sequence[int]], offset: int,
                 nbytes: int):
        self.name = name
        self.dtype = dtype
        self.global_shape = tuple(global_shape)
        self.index = tuple(tuple(i) for i in index)
        self.offset = offset
        self.nbytes = nbytes

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dtype": self.dtype,
            "global_shape": list(self.global_shape),
            "index": [list(i) for i in self.index],
            "offset": self.offset,
            "nbytes": self.nbytes,
        }

    @staticmethod
    def from_dict(d: dict) -> "TensorEntry":
        return TensorEntry(d["name"], d["dtype"], d["global_shape"],
                           d["index"], d["offset"], d["nbytes"])

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(stop - start for start, stop in self.index)


def pack_meta(step: int, entries: List[TensorEntry],
              extra: Optional[dict] = None) -> bytes:
    meta = {
        "step": step,
        "extra": extra or {},
        "entries": [e.to_dict() for e in entries],
    }
    return msgpack.packb(meta, use_bin_type=True)


def unpack_meta(data: bytes) -> Tuple[int, List[TensorEntry], dict]:
    meta = msgpack.unpackb(data, raw=False, strict_map_key=False)
    entries = [TensorEntry.from_dict(d) for d in meta["entries"]]
    return meta["step"], entries, meta.get("extra", {})


def plan_entries(
    shards: List[Tuple[str, str, Sequence[int], Sequence[Sequence[int]], int]],
) -> Tuple[List[TensorEntry], int]:
    """Lay out (name, dtype, global_shape, index, nbytes) shards in shm.

    Returns entries with offsets assigned and the total payload size.
    Offsets are 128-byte aligned so persisted files mmap cleanly.
    """
    entries: List[TensorEntry] = []
    offset = 0
    for name, dtype, gshape, index, nbytes in shards:
        offset = (offset + 127) & ~127
        entries.append(TensorEntry(name, dtype, gshape, index, offset,
                                   nbytes))
        offset += nbytes
    return entries, offset


class SharedMemoryHandler:
    """Owns one shm segment for one training process's checkpoint.

    Both sides (trainer writes, agent reads) construct this with the
    same ``local_rank``; the segment is created/resized lazily on the
    writer side and attached on the reader side.
    """

    def __init__(self, local_rank: int, job: str = ""):
        import os

        job = job or os.getenv("DLROVER_TPU_JOB_NAME", "local")
        self.shm_name = f"dlrover_tpu_ckpt_{job}_{local_rank}"
        self.local_rank = local_rank
        self._shm: Optional[SharedMemoryHandle] = None
        self._lock = threading.Lock()

    # -- writer side -----------------------------------------------------

    def _ensure(self, size: int) -> SharedMemoryHandle:
        if self._shm is not None and self._shm.size >= size:
            return self._shm
        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
            self._shm = None
        # Grow with slack so step-to-step metadata jitter doesn't
        # force recreation (agent re-attaches on size change).
        self._shm = SharedMemoryHandle(self.shm_name, create=True,
                                       size=int(size * 1.1) + 4096)
        return self._shm

    def save(self, step: int,
             arrays: List[Tuple[TensorEntry, np.ndarray]],
             extra: Optional[dict] = None) -> None:
        """Write staged shards into shm. ``arrays`` pairs each planned
        entry with its host ndarray (raw view for bf16 etc.)."""
        entries = [e for e, _ in arrays]
        meta = pack_meta(step, entries, extra)
        payload = (entries[-1].offset + entries[-1].nbytes) if entries else 0
        base = _META_LEN_BYTES + len(meta)
        with self._lock:
            shm = self._ensure(base + payload)
            buf = shm.buf
            # Torn-write guard: invalidate the segment (meta_len=0)
            # before touching bytes, and publish the meta length only
            # after the full payload landed. A trainer killed mid-save
            # leaves meta_len=0 and readers see "no state" instead of a
            # silently mixed-step checkpoint.
            buf[:_META_LEN_BYTES] = (0).to_bytes(_META_LEN_BYTES,
                                                 "little")
            buf[_META_LEN_BYTES:base] = meta
            for entry, arr in arrays:
                start = base + entry.offset
                flat = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
                buf[start:start + entry.nbytes] = flat.data
            buf[:_META_LEN_BYTES] = len(meta).to_bytes(_META_LEN_BYTES,
                                                       "little")

    # -- reader side -----------------------------------------------------

    def attach(self) -> bool:
        if self._shm is not None:
            return True
        try:
            self._shm = SharedMemoryHandle(self.shm_name)
            return True
        except FileNotFoundError:
            return False

    def load(self) -> Optional[Tuple[int, List[TensorEntry], dict, bytes]]:
        """Snapshot the segment: (step, entries, extra, payload bytes).

        The payload copy is taken under the handler lock; callers must
        additionally hold the cross-process SharedLock to exclude a
        concurrent writer.
        """
        with self._lock:
            # Always (re-)attach: the writer may have unlinked and
            # recreated a larger segment since our last look.
            if self._shm is not None:
                self._shm.close()
                self._shm = None
            if not self.attach():
                return None
            buf = self._shm.buf
            meta_len = int.from_bytes(bytes(buf[:_META_LEN_BYTES]),
                                      "little")
            if meta_len <= 0 or meta_len > len(buf):
                return None
            base = _META_LEN_BYTES + meta_len
            step, entries, extra = unpack_meta(bytes(
                buf[_META_LEN_BYTES:base]))
            payload_len = (entries[-1].offset + entries[-1].nbytes
                           if entries else 0)
            payload = bytes(buf[base:base + payload_len])
            return step, entries, extra, payload

    def no_checkpoint_state(self) -> bool:
        res = self.load()
        return res is None

    def close(self) -> None:
        with self._lock:
            if self._shm is not None:
                self._shm.close()
                self._shm = None

    def unlink(self) -> None:
        with self._lock:
            if self._shm is None:
                try:
                    self._shm = SharedMemoryHandle(self.shm_name)
                except FileNotFoundError:
                    return
            self._shm.unlink()
            self._shm.close()
            self._shm = None


def entry_array(entry: TensorEntry, payload: bytes) -> np.ndarray:
    """Materialize one entry's ndarray (raw view dtype) from payload."""
    raw = _np_view(entry.dtype)
    dtype = np.dtype(raw) if raw is not None else np.dtype(entry.dtype)
    data = np.frombuffer(payload, dtype=np.uint8,
                         count=entry.nbytes, offset=entry.offset)
    return data.view(dtype).reshape(entry.local_shape)


def assemble_global(entries: List[TensorEntry],
                    payload: bytes) -> Dict[str, np.ndarray]:
    """Reassemble {name: global ndarray (true dtype)} from shards.

    Any shard layout works — this is the reshard-on-load pivot.
    """
    out: Dict[str, np.ndarray] = {}
    by_name: Dict[str, List[TensorEntry]] = {}
    for e in entries:
        by_name.setdefault(e.name, []).append(e)
    for name, shards in by_name.items():
        gshape = shards[0].global_shape
        raw = _np_view(shards[0].dtype)
        np_dtype = (np.dtype(raw) if raw is not None
                    else np.dtype(shards[0].dtype))
        full = np.empty(gshape, np_dtype)
        for e in shards:
            sl = tuple(slice(start, stop) for start, stop in e.index)
            full[sl] = entry_array(e, payload)
        out[name] = np_from_raw(full, shards[0].dtype)
    return out
