"""Cross-process IPC primitives shared by trainer and agent processes.

Capability parity with the reference's shared primitives
(dlrover/python/common/multi_process.py:211,332,439,519 — SharedLock,
SharedQueue, SharedDict over a unix-domain-socket server, plus a
SharedMemory wrapper that tolerates unlink races).

Design: one process (the *master* side, normally the host agent) serves
each primitive on an abstract unix socket derived from its name; other
processes connect as clients. Requests/replies are msgpack maps — no
pickle. The flash-checkpoint path depends on these: the trainer holds
``SharedLock`` while writing tensors into POSIX shm and posts save events
on a ``SharedQueue`` that the agent's async saver drains.
"""

from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
import queue as _queue
from multiprocessing import shared_memory
from typing import Any, Dict, Optional

import msgpack

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("ipc")

SOCKET_DIR = os.getenv("DLROVER_TPU_SOCK_DIR", "/tmp/dlrover_tpu_sock")


def _socket_path(name: str) -> str:
    os.makedirs(SOCKET_DIR, exist_ok=True)
    job = os.getenv("DLROVER_TPU_JOB_NAME", "local")
    return os.path.join(SOCKET_DIR, f"{job}_{name}.sock")


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(len(data).to_bytes(4, "big") + data)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    header = b""
    while len(header) < 4:
        chunk = sock.recv(4 - len(header))
        if not chunk:
            return None
        header += chunk
    size = int.from_bytes(header, "big")
    data = b""
    while len(data) < size:
        chunk = sock.recv(min(65536, size - len(data)))
        if not chunk:
            return None
        data += chunk
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class _PrimitiveServer:
    """Unix-socket request server for one named primitive."""

    def __init__(self, name: str):
        self.name = name
        self.path = _socket_path(name)
        if os.path.exists(self.path):
            os.unlink(self.path)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                conn_id = f"conn_{id(self.request)}_{threading.get_ident()}"
                try:
                    while True:
                        try:
                            req = _recv_msg(self.request)
                        except OSError:
                            return
                        if req is None:
                            return
                        req["_conn"] = conn_id
                        try:
                            resp = outer.handle_request(req)
                        except Exception as e:  # noqa: BLE001
                            resp = {"ok": False, "err": str(e)}
                        try:
                            _send_msg(self.request, resp)
                        except OSError:
                            return
                finally:
                    outer.on_disconnect(conn_id)

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server(self.path, Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"ipc-{name}",
            daemon=True,
        )
        self._thread.start()

    def handle_request(self, req: dict) -> dict:  # overridden
        raise NotImplementedError

    def on_disconnect(self, conn_id: str) -> None:
        """Called when a client connection closes (incl. process death)."""

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if os.path.exists(self.path):
            os.unlink(self.path)


class _PrimitiveClient:
    """Reconnecting client to a primitive server."""

    def __init__(self, name: str, timeout: float = 60.0):
        self.name = name
        self.path = _socket_path(name)
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        deadline = time.time() + self.timeout
        while True:
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(self.path)
                self._sock = s
                return s
            except (FileNotFoundError, ConnectionRefusedError):
                if time.time() > deadline:
                    raise TimeoutError(
                        f"primitive server {self.name} not up at {self.path}"
                    )
                time.sleep(0.1)

    def call(self, req: dict) -> dict:
        with self._lock:
            for attempt in (0, 1):
                sock = self._connect()
                try:
                    _send_msg(sock, req)
                    resp = _recv_msg(sock)
                    if resp is None:
                        raise ConnectionError("server closed connection")
                    return resp
                except (ConnectionError, BrokenPipeError, OSError):
                    self._sock = None
                    if attempt == 1:
                        raise
            raise ConnectionError("unreachable")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


# ---------------------------------------------------------------------------
# SharedLock
# ---------------------------------------------------------------------------


class _LockServer(_PrimitiveServer):
    def __init__(self, name: str):
        self._locked_by: Optional[str] = None
        self._locked_conn: Optional[str] = None
        self._cond = threading.Condition()
        super().__init__(name)

    def handle_request(self, req: dict) -> dict:
        op = req["op"]
        owner = req.get("owner", "")
        conn = req.get("_conn", "")
        if op == "acquire":
            blocking = req.get("blocking", True)
            with self._cond:
                if blocking:
                    ok = self._cond.wait_for(
                        lambda: self._locked_by is None, timeout=60.0
                    )
                    if not ok:
                        return {"ok": True, "acquired": False}
                elif self._locked_by is not None:
                    return {"ok": True, "acquired": False}
                self._locked_by = owner
                self._locked_conn = conn
                return {"ok": True, "acquired": True}
        if op == "release":
            with self._cond:
                if self._locked_by == owner:
                    self._locked_by = None
                    self._locked_conn = None
                    self._cond.notify_all()
                    return {"ok": True, "released": True}
                return {"ok": True, "released": False}
        if op == "locked":
            with self._cond:
                return {"ok": True, "locked": self._locked_by is not None}
        return {"ok": False, "err": f"bad op {op}"}

    def on_disconnect(self, conn_id: str) -> None:
        # A holder whose connection died (process crash/OOM-kill) must
        # not leave the lock stuck forever — the whole point of the
        # flash-checkpoint path is surviving exactly that crash.
        with self._cond:
            if self._locked_conn == conn_id:
                logger.warning(
                    "lock %s holder disconnected; force-releasing",
                    self.name,
                )
                self._locked_by = None
                self._locked_conn = None
                self._cond.notify_all()


class SharedLock:
    """A named lock shared across processes on one host.

    The process constructed with ``server=True`` hosts the lock; all
    handles (including the server's own) go through the socket so lock
    semantics are identical regardless of which process holds a handle.
    """

    def __init__(self, name: str, server: bool = False):
        self.name = f"lock_{name}"
        self._server = _LockServer(self.name) if server else None
        self._client = _PrimitiveClient(self.name)
        self._owner = f"{os.getpid()}_{id(self)}"

    def acquire(self, blocking: bool = True) -> bool:
        resp = self._client.call(
            {"op": "acquire", "owner": self._owner, "blocking": blocking}
        )
        return bool(resp.get("acquired"))

    def release(self) -> bool:
        resp = self._client.call({"op": "release", "owner": self._owner})
        return bool(resp.get("released"))

    def locked(self) -> bool:
        return bool(self._client.call({"op": "locked"}).get("locked"))

    def __enter__(self):
        # acquire() can time out server-side (60s wait cap); never enter
        # the critical section without actually holding the lock.
        while not self.acquire():
            pass
        return self

    def __exit__(self, *exc):
        self.release()

    def close(self) -> None:
        self._client.close()
        if self._server is not None:
            self._server.close()


# ---------------------------------------------------------------------------
# SharedQueue
# ---------------------------------------------------------------------------


class _QueueServer(_PrimitiveServer):
    def __init__(self, name: str, maxsize: int = 0):
        self._queue: _queue.Queue = _queue.Queue(maxsize)
        super().__init__(name)

    def handle_request(self, req: dict) -> dict:
        op = req["op"]
        if op == "put":
            try:
                self._queue.put(
                    req["item"],
                    block=req.get("block", True),
                    timeout=req.get("timeout"),
                )
                return {"ok": True}
            except _queue.Full:
                return {"ok": False, "err": "full"}
        if op == "get":
            try:
                item = self._queue.get(
                    block=req.get("block", True), timeout=req.get("timeout")
                )
                return {"ok": True, "item": item}
            except _queue.Empty:
                return {"ok": False, "err": "empty"}
        if op == "qsize":
            return {"ok": True, "size": self._queue.qsize()}
        if op == "empty":
            return {"ok": True, "empty": self._queue.empty()}
        return {"ok": False, "err": f"bad op {op}"}


class SharedQueue:
    """A named FIFO queue shared across processes on one host.

    Items must be msgpack-serializable (numbers, strings, bytes, lists,
    maps) — checkpoint events are small dicts.
    """

    def __init__(self, name: str, server: bool = False, maxsize: int = 0):
        self.name = f"queue_{name}"
        self._server = _QueueServer(self.name, maxsize) if server else None
        self._client = _PrimitiveClient(self.name)

    # Blocking calls are chopped into short server-side waits so the
    # per-client socket lock is never held for an unbounded time (a
    # blocked get would otherwise deadlock a put from another thread of
    # the same process).
    _POLL_SECS = 0.2

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.time() + timeout
        while True:
            slice_timeout = 0 if not block else self._POLL_SECS
            resp = self._client.call(
                {"op": "put", "item": item, "block": block and slice_timeout > 0,
                 "timeout": slice_timeout}
            )
            if resp.get("ok"):
                return
            if not block:
                raise _queue.Full
            if deadline is not None and time.time() >= deadline:
                raise _queue.Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            slice_timeout = 0 if not block else self._POLL_SECS
            resp = self._client.call(
                {"op": "get", "block": block and slice_timeout > 0,
                 "timeout": slice_timeout}
            )
            if resp.get("ok"):
                return resp.get("item")
            if not block:
                raise _queue.Empty
            if deadline is not None and time.time() >= deadline:
                raise _queue.Empty

    def qsize(self) -> int:
        return int(self._client.call({"op": "qsize"}).get("size", 0))

    def empty(self) -> bool:
        return bool(self._client.call({"op": "empty"}).get("empty", True))

    def close(self) -> None:
        self._client.close()
        if self._server is not None:
            self._server.close()


# ---------------------------------------------------------------------------
# SharedDict
# ---------------------------------------------------------------------------


class _DictServer(_PrimitiveServer):
    def __init__(self, name: str):
        self._dict: Dict[str, Any] = {}
        self._lock = threading.Lock()
        super().__init__(name)

    def handle_request(self, req: dict) -> dict:
        op = req["op"]
        with self._lock:
            if op == "set":
                self._dict[req["key"]] = req["value"]
                return {"ok": True}
            if op == "get":
                if req["key"] in self._dict:
                    return {"ok": True, "found": True, "value": self._dict[req["key"]]}
                return {"ok": True, "found": False}
            if op == "update":
                self._dict.update(req["items"])
                return {"ok": True}
            if op == "all":
                return {"ok": True, "items": dict(self._dict)}
            if op == "pop":
                val = self._dict.pop(req["key"], None)
                return {"ok": True, "value": val}
        return {"ok": False, "err": f"bad op {op}"}


class SharedDict:
    """A named dict shared across processes on one host."""

    def __init__(self, name: str, server: bool = False):
        self.name = f"dict_{name}"
        self._server = _DictServer(self.name) if server else None
        self._client = _PrimitiveClient(self.name)

    def set(self, key: str, value: Any) -> None:
        self._client.call({"op": "set", "key": key, "value": value})

    def get(self, key: str, default: Any = None) -> Any:
        resp = self._client.call({"op": "get", "key": key})
        return resp["value"] if resp.get("found") else default

    def update(self, items: Dict[str, Any]) -> None:
        self._client.call({"op": "update", "items": items})

    def all(self) -> Dict[str, Any]:
        return self._client.call({"op": "all"}).get("items", {})

    def pop(self, key: str) -> Any:
        return self._client.call({"op": "pop", "key": key}).get("value")

    def close(self) -> None:
        self._client.close()
        if self._server is not None:
            self._server.close()


# ---------------------------------------------------------------------------
# SharedMemory wrapper
# ---------------------------------------------------------------------------


class SharedMemoryHandle:
    """POSIX shared memory that survives creator/attacher races.

    Parity with the reference's wrapper: creating an existing segment
    re-attaches (resizing if needed); unlink is idempotent. The resource
    tracker is disabled for attachers so an exiting trainer doesn't
    destroy the agent's segment.
    """

    def __init__(self, name: str, create: bool = False, size: int = 0):
        self.name = name.replace("/", "_")
        self._shm: Optional[shared_memory.SharedMemory] = None
        if create:
            try:
                self._shm = shared_memory.SharedMemory(
                    name=self.name, create=True, size=size
                )
            except FileExistsError:
                existing = shared_memory.SharedMemory(name=self.name)
                if existing.size >= size:
                    self._shm = existing
                    # This process is an attacher, not the creator: its
                    # resource tracker must not unlink the creator's
                    # segment at exit.
                    self._untrack()
                else:
                    existing.close()
                    existing.unlink()
                    self._shm = shared_memory.SharedMemory(
                        name=self.name, create=True, size=size
                    )
        else:
            self._shm = shared_memory.SharedMemory(name=self.name)
            self._untrack()

    def _untrack(self):
        # Attachers must not let the multiprocessing resource_tracker
        # unlink the segment when they exit.
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(self._shm._name, "shared_memory")  # type: ignore[attr-defined]
        except Exception:  # noqa: BLE001 - best effort, py-version dependent
            pass

    @property
    def buf(self) -> memoryview:
        assert self._shm is not None
        return self._shm.buf

    @property
    def size(self) -> int:
        assert self._shm is not None
        return self._shm.size

    def close(self) -> None:
        if self._shm is not None:
            self._shm.close()

    def unlink(self) -> None:
        if self._shm is not None:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    @staticmethod
    def exists(name: str) -> bool:
        try:
            shm = shared_memory.SharedMemory(name=name.replace("/", "_"))
        except FileNotFoundError:
            return False
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
        except Exception:  # noqa: BLE001
            pass
        shm.close()
        return True
