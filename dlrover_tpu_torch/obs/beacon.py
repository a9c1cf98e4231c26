"""Collective-stall progress beacon: wedge-proof progress stamps.

A host wedged inside a C-level collective cannot answer an RPC, run a
signal handler, or service a thread dump — every Python-level probe
built so far (SIGUSR1 stack capture, heartbeat, metrics file) goes
dark with it. But the file its trainer wrote *just before entering*
the collective is still there, and another process can read it. This
module is that file: a single fixed-size, mmap'd record holding the
trainer's last-crossed progress boundary — step index, microbatch
index, phase id (the :data:`~dlrover_tpu_torch.obs.profiling.PHASES`
boundary it came from), and a monotonic timestamp — rewritten in
place on every boundary the hot loop already crosses.

Cost model: one ~200-byte memcpy into an mmap per phase boundary (a
handful per optimizer step), no syscall on the write path, no host
sync, no device interaction — the step-loop AST host-sync audits and
the transfer-guard tripwires see nothing new. The *reader* (the
co-hosted agent, ``bench.py``'s parent, ``obs_report``) opens the
file fresh each time; because CLOCK_MONOTONIC is machine-wide on
Linux, ``time.monotonic() - stamp["mono"]`` in any process on the
host is the true staleness age even when the writer is wedged.

Record schema (JSON, space-padded to :data:`RECORD_SIZE` bytes)::

    {"pid": 1234,          # writer pid (restart detection)
     "step": 17,           # optimizer step the stamp belongs to
     "microbatch": 3,      # last staged microbatch, -1 before any
     "phase": "dispatch",  # last boundary crossed (BEACON_PHASES)
     "mono": 8123.4,       # time.monotonic() at the stamp
     "ts": 1754...,        # wall clock (rendering only)
     "seq": 91}            # total stamps this writer has made

A torn read (the writer memcpy'd mid-``open``) fails JSON parsing and
is reported as "no stamp"; the next read self-heals. Readers never
block writers and vice versa.
"""

from __future__ import annotations

import json
import mmap
import os
import time
from typing import Callable, Optional, Tuple

BEACON_FILE_ENV = "DLROVER_TPU_BEACON_FILE"
BEACON_ENABLE_ENV = "DLROVER_TPU_BEACON"

# One page is overkill; 512 bytes fits the record with headroom and
# keeps the whole stamp inside a single cache-line burst.
RECORD_SIZE = 512

# Progress ordering *within* one step, for the correlator: a stamp at
# a later index has made strictly more progress through the step.
# ``init`` is the pre-first-stamp state; ``compile`` and ``dispatch``
# are the same boundary (mutually exclusive per step) but compile
# sorts first so a host stuck compiling reads as "behind" a peer that
# already dispatched.
BEACON_PHASES = (
    "init",
    "data_wait",
    "h2d_stage",
    "compile",
    "dispatch",
    "device_execute",
)


def beacon_file() -> str:
    """Where this job's trainer stamps progress. Job-scoped (two jobs
    on one host must not read each other's progress)."""
    job = os.getenv("DLROVER_TPU_JOB_NAME", "default")
    return os.getenv(
        BEACON_FILE_ENV, f"/tmp/dlrover_tpu_beacon_{job}.json"
    )


def beacon_enabled() -> bool:
    return os.getenv(BEACON_ENABLE_ENV, "1").strip().lower() not in (
        "0", "false", "off", "no",
    )


def phase_index(phase: str) -> int:
    """Ordering rank of a phase name; unknown phases rank as init."""
    try:
        return BEACON_PHASES.index(phase)
    except ValueError:
        return 0


def progress_key(stamp: Optional[dict]) -> Tuple[int, int, int]:
    """Totally-ordered progress position ``(step, phase, microbatch)``
    of a stamp — the correlator compares hosts with plain tuple
    comparison. ``None`` (no beacon yet) sorts before everything."""
    if not isinstance(stamp, dict):
        return (-1, 0, -1)
    try:
        return (
            int(stamp.get("step", 0)),
            phase_index(str(stamp.get("phase", "init"))),
            int(stamp.get("microbatch", -1)),
        )
    except (TypeError, ValueError):
        return (-1, 0, -1)


def stamp_age(
    stamp: Optional[dict], now_mono: Optional[float] = None
) -> Optional[float]:
    """Seconds since the stamp was written, on the machine-wide
    monotonic clock — meaningful only on the writer's host."""
    if not isinstance(stamp, dict):
        return None
    try:
        mono = float(stamp["mono"])
    except (KeyError, TypeError, ValueError):
        return None
    now = time.monotonic() if now_mono is None else now_mono
    return max(now - mono, 0.0)


def read_beacon(path: Optional[str] = None) -> Optional[dict]:
    """The last stamp at ``path``, or None when absent/torn/invalid.
    Opens the file fresh — works on a wedged writer's beacon."""
    path = path or beacon_file()
    try:
        with open(path, "rb") as f:
            raw = f.read(RECORD_SIZE)
    except OSError:
        return None
    try:
        stamp = json.loads(raw.decode("utf-8", "replace").strip("\x00 \r\n"))
    except ValueError:
        return None
    return stamp if isinstance(stamp, dict) else None


class ProgressBeacon:
    """The writer half: owns the mmap'd record and rewrites it in
    place on every :meth:`stamp`. Construction is best-effort — a
    read-only ``/tmp`` degrades to a no-op beacon, never a trainer
    crash. Clocks are injectable for hermetic tests."""

    def __init__(
        self,
        path: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
    ):
        self.path = path or beacon_file()
        self._clock = clock
        self._wall = wall
        self.step = 0
        self.microbatch = -1
        self.phase = "init"
        self.seq = 0
        self._mm: Optional[mmap.mmap] = None
        self._fd: Optional[int] = None
        try:
            # The file appears atomically at its final size, so a
            # reader never sees a short file.
            tmp = f"{self.path}.tmp{os.getpid()}"
            fd = os.open(
                tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644
            )
            try:
                os.ftruncate(fd, RECORD_SIZE)
                os.replace(tmp, self.path)
            except OSError:
                os.close(fd)
                raise
            self._fd = fd
            self._mm = mmap.mmap(fd, RECORD_SIZE)
        except (OSError, ValueError):
            self._close()
        else:
            self.stamp()  # the init stamp: "trainer alive, step 0"

    @property
    def active(self) -> bool:
        return self._mm is not None

    def stamp(
        self,
        step: Optional[int] = None,
        microbatch: Optional[int] = None,
        phase: Optional[str] = None,
    ) -> None:
        """Record a crossed boundary. Omitted fields keep their last
        value, so a microbatch-only stamp doesn't regress the phase."""
        if self._mm is None:
            return
        if step is not None:
            self.step = int(step)
        if microbatch is not None:
            self.microbatch = int(microbatch)
        if phase is not None:
            self.phase = str(phase)
        self.seq += 1
        data = json.dumps(
            {
                "pid": os.getpid(),
                "step": self.step,
                "microbatch": self.microbatch,
                "phase": self.phase,
                "mono": round(self._clock(), 4),
                "ts": round(self._wall(), 4),
                "seq": self.seq,
            },
            separators=(",", ":"),
        ).encode("utf-8")
        if len(data) > RECORD_SIZE:
            return
        try:
            self._mm[:RECORD_SIZE] = data.ljust(RECORD_SIZE)
        except (ValueError, OSError):
            self._close()

    def read(self) -> Optional[dict]:
        return read_beacon(self.path)

    def _close(self) -> None:
        mm, self._mm = self._mm, None
        fd, self._fd = self._fd, None
        if mm is not None:
            try:
                mm.close()
            except (OSError, ValueError):
                pass
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass

    def close(self) -> None:
        """Flush-and-release; the file (and its last stamp) remains
        for post-mortem readers."""
        if self._mm is not None:
            try:
                self._mm.flush()
            except (OSError, ValueError):
                pass
        self._close()

    def __del__(self):  # pragma: no cover - GC timing
        self._close()


def default_beacon() -> Optional[ProgressBeacon]:
    """The beacon a hot loop should run: job-scoped path, real
    clocks; None when disabled via DLROVER_TPU_BEACON=0."""
    if not beacon_enabled():
        return None
    b = ProgressBeacon()
    return b if b.active else None
