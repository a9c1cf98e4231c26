"""Master-hosted key-value store.

Parity: dlrover/python/master/elastic_training/kv_store_service.py. Used
by agents/trainers as the bootstrap store (the role torch's TCPStore
plays in torchelastic; here it hands out the JAX coordinator address and
synchronizes process-id assignment) and for small cross-host blobs.
"""

from __future__ import annotations

import base64
import threading
import time
from typing import Callable, Dict, Optional


class KVStoreService:
    def __init__(self):
        self._lock = threading.Lock()
        self._store: Dict[str, bytes] = {}
        self._cond = threading.Condition(self._lock)
        # Fired (outside the lock) after every mutation; the JobMaster
        # points this at the state journal so bootstrap keys survive a
        # master restart.
        self.on_change: Optional[Callable[[], None]] = None

    def _changed(self) -> None:
        cb = self.on_change
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — journaling must not
                # break the bootstrap path it records
                pass

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()
        self._changed()

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def add(self, key: str, amount: int) -> int:
        """Atomic counter add (value stored as decimal string)."""
        with self._cond:
            current = int(self._store.get(key, b"0") or b"0")
            current += amount
            self._store[key] = str(current).encode()
            self._cond.notify_all()
            result = current
        self._changed()
        return result

    def wait(self, key: str, timeout: float = 60.0) -> bytes:
        # Monotonic deadline: an NTP step must neither fire this
        # timeout early nor mask it (same bug class as HangDetector).
        deadline = time.monotonic() + timeout
        with self._cond:
            while key not in self._store:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"key {key!r} not set in {timeout}s")
                self._cond.wait(remaining)
            return self._store[key]

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
        self._changed()

    # -- warm-restart snapshot ----------------------------------------------

    def to_snapshot(self) -> dict:
        """JSON-safe dump (values are arbitrary bytes -> base64)."""
        with self._lock:
            return {
                k: base64.b64encode(v).decode("ascii")
                for k, v in self._store.items()
            }

    def restore_snapshot(self, state: dict) -> None:
        with self._cond:
            self._store = {
                k: base64.b64decode(v) for k, v in state.items()
            }
            self._cond.notify_all()
