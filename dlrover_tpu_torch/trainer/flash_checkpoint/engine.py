"""Train-side flash-checkpoint engine (the port's counterpart of
``dlrover_tpu/trainer/flash_checkpoint/engine.py``).

The JAX engine stages a sharded ``jax.Array`` pytree into the host's
shared-memory segment (``common/ckpt_shm.py``) and leaves persistence to
the host agent's saver (``agent/ckpt_saver.py``), which it asks through
a ``SharedQueue`` event. This engine keeps that design and the formats:

* state is the port's tree of tensors (nested dicts, tuples and named
  tuples, with Python ints such as the optimizer's step count), and
  leaves are named as the JAX engine names them (``flatten_named``), so
  ``(params, (adam_state,))`` gives the entry names of ``(params,
  optax_state)`` and a checkpoint of either package loads into the
  other;
* staging is one ``non_blocking`` device-to-host copy per leaf, straight
  into the shm segment, which is registered with CUDA (pinned) while
  the engine owns it, and one synchronisation; the segment's torn-write
  guard is the one ``SharedMemoryHandler.save`` keeps (the length of
  the metadata is published last);
* under replicated data parallelism (the port's only layout until FSDP,
  ROADMAP queue 1 item 6) every rank holds the same state, so only
  global rank 0 stages it, as the JAX engine writes replica 0 of each
  shard; the other ranks stage nothing and never talk to the saver;
* ``load`` restores the newest committed step: from this host's shm
  segment when it holds exactly that step (a trainer restarted by the
  agent), from storage otherwise, into tensors of the saved dtypes on
  the device of the tree it is given. bf16 leaves travel as raw 16-bit
  words, as the JAX engine stages them, and become ``torch.bfloat16``
  by a bit cast.

The segment is untracked by ``multiprocessing``'s resource tracker, so a
trainer that is killed leaves it for the agent to persist and for the
restarted trainer to restore; the agent unlinks it when it exits.
Streaming reshard-on-load (``load_streaming``) waits for the FSDP item.
"""

from __future__ import annotations

import dataclasses
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common import ckpt_shm
from dlrover_tpu_torch.common.ckpt_shm import (
    SharedMemoryHandler,
    TensorEntry,
    plan_entries,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedMemoryHandle,
    SharedQueue,
)

logger = get_logger("flash_ckpt")

_CKPT_OPS = obs.counter(
    "dlrover_ckpt_ops_total",
    "Flash-checkpoint operations",
    ("op", "result"),
)
_CKPT_STAGE_SECONDS = obs.histogram(
    "dlrover_ckpt_stage_seconds",
    "Device-to-shm staging time of save_to_memory",
)
_CKPT_RESTORE_SECONDS = obs.histogram(
    "dlrover_ckpt_restore_seconds",
    "End-to-end restore time of CheckpointEngine.load",
)

CKPT_EVENT_QUEUE = "ckpt_events"
CKPT_STATUS_DICT = "ckpt_status"
TRACKER_FILE = "latest_checkpointed_step"
WRITING_PREFIX = "._writing_"

_META_LEN_BYTES = 8

# torch dtype <-> the dtype names the JAX engine writes (str(jax dtype))
_DTYPE_NAMES = {
    torch.float32: "float32",
    torch.float64: "float64",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.bool: "bool",
}
_TORCH_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


# -- leaf names -------------------------------------------------------------


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container in ``jax.tree`` order, or None
    for a leaf: dict keys sorted, sequence indices, named-tuple and
    dataclass fields in declaration order."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def flatten_named(tree) -> List[Tuple[str, Any]]:
    """[('0/blocks/wqkv', leaf), ...]: the JAX engine's leaf names
    (dict keys, sequence indices and attribute names joined by '/')."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(prefix), node))
            return
        for key, child in kids:
            walk(child, prefix + [key])

    walk(tree, [])
    return out


def map_named(fn: Callable[[str, Any], Any], tree):
    """A tree like ``tree`` with each leaf replaced by fn(name, leaf)."""

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            return fn("/".join(prefix), node)
        new = {k: walk(c, prefix + [k]) for k, c in kids}
        if isinstance(node, dict):
            return {k: new[str(k)] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(**new)
        if isinstance(node, (tuple, list)):
            return type(node)(new[str(i)] for i in range(len(node)))
        return dataclasses.replace(node, **new)

    return walk(tree, [])


# -- storage layout (the JAX engine's) ----------------------------------------


def step_dir(checkpoint_dir: str, step: int) -> str:
    return f"{checkpoint_dir.rstrip('/')}/{step}"


def writing_dir(checkpoint_dir: str, step: int) -> str:
    return f"{checkpoint_dir.rstrip('/')}/{WRITING_PREFIX}{step}"


def done_dir(checkpoint_dir: str, step: int) -> str:
    """Done-files live *outside* the writing dir so the commit rename
    doesn't destroy the evidence a retrying committer needs."""
    return f"{checkpoint_dir.rstrip('/')}/.done_{step}"


def pack_shard_file(step: int, entries: List[TensorEntry], extra: dict,
                    payload: bytes) -> bytes:
    meta = ckpt_shm.pack_meta(step, entries, extra)
    return (len(meta).to_bytes(8, "little") + meta + payload)


def unpack_shard_file(data: bytes) -> Tuple[int, List[TensorEntry],
                                            dict, bytes]:
    meta_len = int.from_bytes(data[:8], "little")
    step, entries, extra = ckpt_shm.unpack_meta(data[8:8 + meta_len])
    return step, entries, extra, data[8 + meta_len:]


def unlink_shm(local_rank: int) -> None:
    """Remove this host's staged segment of ``local_rank``: the agent
    (or a self-hosted saver) owns the segments and removes them when it
    exits."""
    name = SharedMemoryHandler(local_rank).shm_name
    try:
        # attaching registers the name with the resource tracker and
        # unlink unregisters it, so the tracker's books stay balanced
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    seg.close()
    seg.unlink()


# -- leaves ------------------------------------------------------------------


def _as_tensor(leaf) -> torch.Tensor:
    """A staged leaf: tensors as they are, Python ints as the int32
    scalar optax keeps its step count in, floats as f32 scalars."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, bool) or not isinstance(leaf, (int, float)):
        raise TypeError(f"cannot checkpoint a {type(leaf).__name__} leaf")
    dtype = torch.int32 if isinstance(leaf, int) else torch.float32
    return torch.tensor(leaf, dtype=dtype)


def _tensor_from_bytes(data: torch.Tensor, entry: TensorEntry,
                       device: torch.device) -> torch.Tensor:
    """A uint8 tensor holding ``entry``'s bytes -> the entry's tensor
    on ``device`` (a bit cast, so bf16 words come back exactly)."""
    dtype = _TORCH_DTYPES.get(entry.dtype)
    if dtype is None:
        raise TypeError(f"no torch dtype for checkpoint entry "
                        f"{entry.name} of dtype {entry.dtype}")
    # a fresh tensor starts at offset 0, so any dtype may view it
    if data.device == device:
        data = data.clone()
    else:
        data = data.to(device, non_blocking=data.is_pinned())
    return data.view(dtype).reshape(entry.local_shape)


def _restore_leaf(name: str, like, value: torch.Tensor):
    if isinstance(like, torch.Tensor):
        if tuple(value.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint leaf {name} has shape {tuple(value.shape)}, "
                f"the state wants {tuple(like.shape)}"
            )
        # the checkpoint's dtype, as the JAX engine's whole-state load
        # keeps it: a fresh optimizer state's bf16 moments must not round
        # the f32 moments a trained one holds
        return value.to(device=like.device)
    if isinstance(like, int):
        return int(value.item())
    return float(value.item())


class CheckpointEngine:
    """Stages the port's state into shm; loads committed checkpoints.

    One engine per training process. ``local_rank`` selects the shm
    segment shared with the host agent; ``global_rank``/``world_size``
    default to ``torch.distributed``'s (0 and 1 without a process
    group). Only global rank 0 stages (see the module docstring).
    """

    def __init__(
        self,
        checkpoint_dir: str,
        local_rank: int = 0,
        global_rank: Optional[int] = None,
        world_size: Optional[int] = None,
        use_agent: bool = True,
        storage=None,
    ):
        from dlrover_tpu_torch.common.storage import get_storage

        dist = torch.distributed
        ready = dist.is_available() and dist.is_initialized()
        self.checkpoint_dir = checkpoint_dir
        self.storage = storage or get_storage()
        self.local_rank = local_rank
        self.global_rank = (
            (dist.get_rank() if ready else 0)
            if global_rank is None else global_rank
        )
        self.world_size = (
            (dist.get_world_size() if ready else 1)
            if world_size is None else world_size
        )
        self.stages = self.global_rank == 0
        self._shm = SharedMemoryHandler(local_rank)
        # uint8 view of the segment while this engine stages into it,
        # and whether that memory is registered with CUDA
        self._host: Optional[torch.Tensor] = None
        self._pinned = False
        self._lock = self._events = self._status = None
        if use_agent and self.stages:
            self._lock = SharedLock(f"ckpt_{local_rank}")
            self._events = SharedQueue(CKPT_EVENT_QUEUE)
            self._status = SharedDict(CKPT_STATUS_DICT)
        self._cached_step = -1
        # where the last load came from ("shm" or "storage") and the
        # seconds it took
        self.last_load_source = ""
        self.last_load_s = 0.0

    # -- save ------------------------------------------------------------

    def _host_buffer(self, size: int) -> torch.Tensor:
        """A uint8 view of a segment of at least ``size`` bytes."""
        seg = self._shm._shm
        if seg is None or seg.size < size:
            self._release_host()
            seg = self._shm._ensure(size)
            # Let the segment outlive this process: a trainer that is
            # killed must leave its last staged step to the agent.
            name = seg._shm._name  # type: ignore[attr-defined]
            resource_tracker.register(name, "shared_memory")
            resource_tracker.unregister(name, "shared_memory")
        if self._host is None:
            self._host = torch.frombuffer(seg.buf, dtype=torch.uint8)
        return self._host

    def _pin(self, host: torch.Tensor) -> None:
        if self._pinned:
            return
        err = torch.cuda.cudart().cudaHostRegister(
            host.data_ptr(), host.numel(), 0
        )
        if err != torch.cuda.cudart().cudaError.success:
            raise RuntimeError(f"cudaHostRegister of the shm segment: {err}")
        self._pinned = True

    def _release_host(self) -> None:
        if self._host is None:
            return
        if self._pinned:
            torch.cuda.cudart().cudaHostUnregister(self._host.data_ptr())
            self._pinned = False
        self._host = None

    def _stage(self, step: int, state, extra: dict) -> None:
        """Device->shm copy of every leaf, then publish the metadata."""
        named = [(n, _as_tensor(leaf)) for n, leaf in flatten_named(state)]
        plans = [
            (name, _DTYPE_NAMES[t.dtype], tuple(t.shape),
             [(0, d) for d in t.shape], t.numel() * t.element_size())
            for name, t in named
        ]
        entries, payload = plan_entries(plans)
        meta = ckpt_shm.pack_meta(step, entries, extra)
        base = _META_LEN_BYTES + len(meta)
        host = self._host_buffer(base + payload)
        cuda = [t.device for _, t in named if t.is_cuda]
        if cuda:
            self._pin(host)
        buf = self._shm._shm.buf
        # Torn-write guard, as SharedMemoryHandler.save keeps it: no
        # metadata length until every byte of this step has landed.
        buf[:_META_LEN_BYTES] = (0).to_bytes(_META_LEN_BYTES, "little")
        buf[_META_LEN_BYTES:base] = meta
        for entry, (_, t) in zip(entries, named):
            if entry.nbytes:
                start = base + entry.offset
                host[start:start + entry.nbytes].copy_(
                    t.contiguous().view(-1).view(torch.uint8),
                    non_blocking=True,
                )
        for dev in set(cuda):
            torch.cuda.current_stream(dev).synchronize()
        buf[:_META_LEN_BYTES] = len(meta).to_bytes(_META_LEN_BYTES,
                                                   "little")

    def save_to_memory(self, step: int, state,
                       extra: Optional[dict] = None) -> bool:
        """Stage ``state`` into shm (global rank 0; a no-op that returns
        True elsewhere). Non-blocking wrt storage; skips (returns False)
        if the agent is mid-persist on this segment."""
        if not self.stages:
            return True
        extra = dict(extra or {})
        extra["_global_rank"] = self.global_rank
        extra["_world_size"] = self.world_size
        # The agent flushing a memory-only checkpoint before a restart
        # must persist where the resumed trainer will look.
        extra["_checkpoint_dir"] = self.checkpoint_dir
        if self._lock is not None and not self._lock.acquire(
                blocking=False):
            logger.warning(
                "step %s: shm busy (agent persisting); skip staging",
                step)
            _CKPT_OPS.inc(op="save_memory", result="skipped")
            return False
        t0 = time.monotonic()
        try:
            with obs.span("ckpt.save_memory", step=step):
                self._stage(step, state, extra)
            self._cached_step = step
        except Exception:
            _CKPT_OPS.inc(op="save_memory", result="error")
            raise
        finally:
            if self._lock is not None:
                self._lock.release()
        _CKPT_STAGE_SECONDS.observe(time.monotonic() - t0)
        _CKPT_OPS.inc(op="save_memory", result="ok")
        return True

    def save_to_storage(self, step: int, state,
                        extra: Optional[dict] = None) -> bool:
        """Stage into shm then ask the agent to persist asynchronously."""
        if not self.save_to_memory(step, state, extra):
            return False
        if self._events is not None:
            self._events.put(
                {
                    "type": "save",
                    "step": step,
                    "dir": self.checkpoint_dir,
                }
            )
            _CKPT_OPS.inc(op="persist_request", result="ok")
            obs.event("ckpt.persist_requested", step=step)
        return True

    def wait_persisted(self, step: int, timeout: float = 60.0) -> bool:
        """Block until the agent reports ``step`` committed."""
        if self._status is None:
            return False
        deadline = time.time() + timeout
        while time.time() < deadline:
            if int(self._status.get("latest_persisted_step", -1)) >= step:
                return True
            time.sleep(0.05)
        return False

    # -- load ------------------------------------------------------------

    def latest_step(self) -> int:
        """Latest committed step in storage, or -1."""
        path = f"{self.checkpoint_dir.rstrip('/')}/{TRACKER_FILE}"
        if not self.storage.exists(path):
            return -1
        txt = self.storage.read_bytes(path).decode().strip()
        return int(txt) if txt else -1

    def _read_shm(self, step: int, device: torch.device
                  ) -> Optional[Tuple[Dict[str, torch.Tensor], dict]]:
        """{name: tensor on ``device``} and extras of the segment this
        engine stages into, when it holds ``step`` in whole leaves; else
        None (and always None on a rank that does not stage: it reads
        storage).

        The read goes through the engine's own pinned view of the
        segment, which its next save reuses. Pinned, the copies to the
        card run at the D2H rate of staging instead of paging the
        segment in."""
        if not self.stages:
            return None
        if self._shm._shm is None:
            try:
                self._shm._shm = SharedMemoryHandle(self._shm.shm_name)
            except FileNotFoundError:
                return None
        buf = self._shm._shm.buf
        meta_len = int.from_bytes(bytes(buf[:_META_LEN_BYTES]), "little")
        if meta_len <= 0 or meta_len > len(buf):
            return None
        base = _META_LEN_BYTES + meta_len
        found, entries, extra = ckpt_shm.unpack_meta(
            bytes(buf[_META_LEN_BYTES:base]))
        if found != step or len({e.name for e in entries}) != len(entries):
            return None
        data = self._host_buffer(0)
        if device.type == "cuda":
            self._pin(data)
        out = {
            e.name: _tensor_from_bytes(
                data[base + e.offset:base + e.offset + e.nbytes], e, device)
            for e in entries
        }
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return out, extra

    def _read_storage(self, step: int, device: torch.device
                      ) -> Optional[Tuple[Dict[str, torch.Tensor], dict]]:
        """{name: tensor} and extras of a committed step, merging every
        rank's shard files (any shard layout)."""
        sdir = step_dir(self.checkpoint_dir, step)
        shards: Dict[str, List[Tuple[TensorEntry, bytes]]] = {}
        extra: dict = {}
        found = False
        for fname in self.storage.listdir(sdir):
            if not fname.endswith(".ckpt"):
                continue
            found = True
            shard_step, entries, shard_extra, payload = unpack_shard_file(
                self.storage.read_bytes(f"{sdir}/{fname}"))
            if shard_step != step:
                raise ValueError(
                    f"shard {fname} holds step {shard_step}, dir says "
                    f"{step}: corrupt checkpoint")
            for e in entries:
                shards.setdefault(e.name, []).append((e, payload))
            extra.update(shard_extra)
        if not found:
            return None
        out = {}
        for name, parts in shards.items():
            first = parts[0][0]
            full = np.empty(first.global_shape, ckpt_shm._np_view(
                first.dtype) or np.dtype(first.dtype))
            for e, payload in parts:
                sl = tuple(slice(a, b) for a, b in e.index)
                full[sl] = ckpt_shm.entry_array(e, payload)
            whole = TensorEntry(name, first.dtype, first.global_shape,
                                [(0, d) for d in first.global_shape], 0,
                                full.nbytes)
            raw = torch.from_numpy(full.reshape(-1).view(np.uint8))
            out[name] = _tensor_from_bytes(raw, whole, device)
        return out, extra

    def load(self, like, step: Optional[int] = None):
        """Restore a tree shaped like ``like`` (tensors, and Python ints
        for scalars such as the optimizer's step count) from the newest
        committed step, or ``step``. Tensors come back in the dtypes
        they were saved in, on the devices of ``like``'s. Returns (step,
        state, extra), or None when no checkpoint exists; raises when
        the committed step can be read neither from shm nor from storage,
        or when it lacks a leaf of ``like`` or holds it in another
        shape."""
        t0 = time.monotonic()
        with obs.span("ckpt.restore"):
            res = self._load(like, step)
        if res is None:
            _CKPT_OPS.inc(op="restore", result="none")
        else:
            self.last_load_s = time.monotonic() - t0
            _CKPT_RESTORE_SECONDS.observe(self.last_load_s)
            _CKPT_OPS.inc(op="restore", result="ok")
        return res

    def _load(self, like, step: Optional[int]):
        found = self.latest_step() if step is None else step
        if found < 0:
            return None
        named = flatten_named(like)
        devices = [x.device for _, x in named
                   if isinstance(x, torch.Tensor)]
        device = devices[0] if devices else torch.device("cpu")
        res = self._read_shm(found, device)
        self.last_load_source = "shm"
        if res is None:
            res = self._read_storage(found, device)
            self.last_load_source = "storage"
        if res is None:
            raise FileNotFoundError(
                f"checkpoint step {found} of {self.checkpoint_dir} is in "
                f"neither this host's shm segment nor storage "
                f"({step_dir(self.checkpoint_dir, found)} holds no shard)")
        flat, extra = res
        missing = [n for n, _ in named if n not in flat]
        if missing:
            raise KeyError(
                f"checkpoint step {found} missing leaves: "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        state = map_named(
            lambda name, leaf: _restore_leaf(name, leaf, flat[name]), like
        )
        extra = {k: v for k, v in extra.items() if not k.startswith("_")}
        return found, state, extra

    def close(self) -> None:
        self._release_host()
        self._shm.close()
        for h in (self._lock, self._events, self._status):
            if h is not None:
                h.close()
