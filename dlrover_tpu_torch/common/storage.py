"""Checkpoint storage backends.

Capability parity with the reference's storage abstraction
(dlrover/python/common/storage.py — PosixDiskStorage with
write/read/safe_rmtree plus a pluggable CheckpointStorage base). The
TPU build keeps the same surface so the async saver is storage-agnostic;
a GCS backend can slot in for GKE pod-slices without touching the saver.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from abc import ABC, abstractmethod
from typing import List, Optional


class CheckpointStorage(ABC):
    """Minimal filesystem-like interface the async saver needs."""

    @abstractmethod
    def write_bytes(self, data: bytes, path: str) -> None: ...

    @abstractmethod
    def read_bytes(self, path: str) -> bytes: ...

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        """Read ``length`` bytes at ``offset``. Base implementation
        reads the whole object; backends with ranged reads (POSIX
        seek, GCS/S3 Range headers) override BOTH this and
        ``supports_range`` for streaming restore."""
        return self.read_bytes(path)[offset:offset + length]

    def supports_range(self) -> bool:
        """Whether read_range is a true ranged read. Streaming restore
        only engages when True — the base fallback would otherwise
        download the whole object once per requested range."""
        return False

    @abstractmethod
    def exists(self, path: str) -> bool: ...

    @abstractmethod
    def listdir(self, path: str) -> List[str]: ...

    @abstractmethod
    def makedirs(self, path: str) -> None: ...

    @abstractmethod
    def rmtree(self, path: str) -> None: ...

    @abstractmethod
    def rename(self, src: str, dst: str) -> None: ...


class PosixStorage(CheckpointStorage):
    """Local/NFS POSIX storage.

    Writes are atomic (temp file + rename) so a reader never sees a
    half-written shard — the commit protocol depends on done-files being
    all-or-nothing.
    """

    def write_bytes(self, data: bytes, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def supports_range(self) -> bool:
        return True

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def rmtree(self, path: str) -> None:
        shutil.rmtree(path, ignore_errors=True)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)


def get_storage(kind: Optional[str] = None) -> CheckpointStorage:
    """Factory. ``kind`` defaults to env DLROVER_TPU_CKPT_STORAGE."""
    kind = kind or os.getenv("DLROVER_TPU_CKPT_STORAGE", "posix")
    if kind == "posix":
        return PosixStorage()
    raise ValueError(f"unknown checkpoint storage backend: {kind}")
