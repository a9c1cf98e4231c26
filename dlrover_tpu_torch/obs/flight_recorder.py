"""Always-on flight recorder: the black box every role carries.

The healthy-job telemetry (metrics registry, tracer, fleet
aggregation) answers "what is the job doing"; this module answers
"what was it doing when it died or wedged". Each process installs one
:class:`FlightRecorder` at startup (``install_flight_recorder(role)``)
holding a bounded in-memory ring — recent WARNING+ log records, the
last step/loss notes the trainer drops, tracer-event and metric
snapshots taken only at dump time — with near-zero steady-state cost:
no background thread, no I/O off the crash path, every hot-path hook
is a deque append or dict assignment.

Crash capture, three layers:

* ``faulthandler.enable`` on a pre-opened per-process *stacks file*
  (``<forensics_dir>/stacks_<pid>.txt``): fatal signals (SIGSEGV,
  SIGABRT, SIGBUS, SIGFPE, SIGILL) dump every thread's Python stack
  from the C handler — works even when the interpreter is wedged in a
  C extension call.
* a chained ``sys.excepthook`` / ``threading.excepthook``: any
  unhandled Python exception writes a full JSON *bundle* (ring
  contents + all-thread stacks + process/env/JAX platform info) to
  the forensics dir before the previous hook runs.
* trainer role only: ``faulthandler.register(SIGUSR1)`` on the same
  stacks file, so the supervising agent can snapshot the training
  process's stacks *while it is hung* (a Python-level signal handler
  would never run with the main thread stuck in a collective; the
  C-level faulthandler does).

The agent folds the stacks-file tail + ring digest into its failure
report when the hang detector trips, and ships a
``DiagnosticsReport`` to the master — see agent/agent.py and
master/servicer.py. ``tools/obs_report.py --postmortem <dir>`` renders
the bundles (obs/postmortem.py).

Knobs: ``DLROVER_TPU_FORENSICS_DIR`` (default
``/tmp/dlrover_tpu_forensics_<job>``), ``DLROVER_TPU_FLIGHT_RECORDER=0``
disables installation, ``DLROVER_TPU_FORENSICS_KEEP`` bounds retained
bundles per process (default 8, oldest deleted first).
"""

from __future__ import annotations

import collections
import faulthandler
import json
import logging
import os
import platform
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

FORENSICS_DIR_ENV = "DLROVER_TPU_FORENSICS_DIR"
FLIGHT_RECORDER_ENV = "DLROVER_TPU_FLIGHT_RECORDER"
FORENSICS_KEEP_ENV = "DLROVER_TPU_FORENSICS_KEEP"

BUNDLE_SCHEMA_VERSION = 1

# Ring / bundle size caps: the recorder must stay cheap while alive
# and the bundle must stay shippable when dead.
_LOG_RING_SIZE = 128
_EVENT_TAIL = 256
_MAX_FRAMES_PER_THREAD = 50
_DIGEST_CAP = 4096


def forensics_dir() -> str:
    """Per-run directory every role's recorder writes into."""
    configured = os.getenv(FORENSICS_DIR_ENV, "")
    if configured:
        return configured
    job = os.getenv("DLROVER_TPU_JOB_NAME", "default")
    return f"/tmp/dlrover_tpu_forensics_{job}"


def stacks_file_path(pid: Optional[int] = None,
                     dir_: Optional[str] = None) -> str:
    """The faulthandler dump target for ``pid`` — deterministic, so
    the agent can find its training process's stacks knowing only the
    pid (the SIGUSR1 contract)."""
    return os.path.join(
        dir_ or forensics_dir(), f"stacks_{pid or os.getpid()}.txt"
    )


class _RecorderLogHandler(logging.Handler):
    """Feeds WARNING+ records into the recorder's bounded ring."""

    def __init__(self, recorder: "FlightRecorder"):
        super().__init__(level=logging.WARNING)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder._log_ring.append(
                {
                    "ts": round(record.created, 3),
                    "level": record.levelname,
                    "logger": record.name,
                    "msg": record.getMessage()[:500],
                }
            )
        except Exception:  # noqa: BLE001 — logging must never raise
            pass


def _thread_stacks() -> List[dict]:
    """Python stacks of every live thread (bounded frames each)."""
    names = {t.ident: t for t in threading.enumerate()}
    stacks = []
    current = threading.get_ident()
    for ident, frame in sys._current_frames().items():
        thread = names.get(ident)
        frames = [
            f"{os.path.basename(fs.filename)}:{fs.lineno} in {fs.name}"
            for fs in traceback.extract_stack(
                frame, limit=_MAX_FRAMES_PER_THREAD
            )
        ]
        stacks.append(
            {
                "thread": thread.name if thread else f"ident-{ident}",
                "ident": ident,
                "daemon": bool(thread.daemon) if thread else None,
                "current": ident == current,
                "frames": frames,
            }
        )
    return stacks


def _process_info() -> dict:
    info = {
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "cwd": os.getcwd(),
    }
    # NEVER import torch or initialise CUDA here (a crash handler must
    # not open a device context); report the CUDA device only if the
    # process already initialised it.
    torch = sys.modules.get("torch")
    if torch is None:
        info["torch_device"] = "not_imported"
    elif not torch.cuda.is_initialized():
        info["torch_device"] = "cpu"
    else:
        try:
            info["torch_device"] = (
                f"cuda:{torch.cuda.current_device()} "
                f"{torch.cuda.get_device_name()}"
            )
        except Exception:  # noqa: BLE001 — a context lost in the crash
            info["torch_device"] = "error"
    return info


def _env_snapshot() -> Dict[str, str]:
    keep = ("DLROVER_TPU_", "JAX_", "TPU_", "XLA_")
    return {
        k: v[:200]
        for k, v in sorted(os.environ.items())
        if any(k.startswith(p) for p in keep)
    }


class FlightRecorder:
    """One per process; see module docstring. Use
    :func:`install_flight_recorder`, not the constructor."""

    def __init__(
        self,
        role: str,
        rank: int = -1,
        dir_: Optional[str] = None,
        keep: Optional[int] = None,
    ):
        self.role = role or "unknown"
        self.rank = rank
        self.dir = dir_ or forensics_dir()
        if keep is None:
            try:
                keep = int(os.getenv(FORENSICS_KEEP_ENV, "") or 8)
            except ValueError:
                keep = 8
        self.keep = max(keep, 1)
        self._lock = threading.Lock()
        self._log_ring: collections.deque = collections.deque(
            maxlen=_LOG_RING_SIZE
        )
        self._notes: Dict[str, Any] = {}
        self._bundle_seq = 0
        self._bundle_paths: collections.deque = collections.deque()
        self._log_handler: Optional[_RecorderLogHandler] = None
        self._prev_excepthook = None
        self._prev_threading_excepthook = None
        self._sigusr1_registered = False
        self._stacks_file = None
        self.stacks_path = stacks_file_path(os.getpid(), self.dir)
        os.makedirs(self.dir, exist_ok=True)

    # -- steady-state surface (hot-path cheap) ---------------------------

    def note(self, **kv) -> None:
        """Record 'last known' facts (step, loss, phase): one bounded
        dict update, the whole per-step cost of the black box."""
        with self._lock:
            self._notes.update(kv)

    # -- installation ----------------------------------------------------

    def install(self, register_sigusr1: bool = False) -> None:
        """Wire the crash hooks. Idempotent per process."""
        # Pre-opened, line-buffered: a C signal handler cannot open
        # files, so faulthandler needs the fd ready before the crash.
        if self._stacks_file is None:
            try:
                self._stacks_file = open(
                    self.stacks_path, "a", buffering=1
                )
            except OSError:
                self._stacks_file = None
        if self._stacks_file is not None:
            try:
                faulthandler.enable(
                    file=self._stacks_file, all_threads=True
                )
            except (OSError, ValueError, RuntimeError):
                pass
            if register_sigusr1 and hasattr(signal, "SIGUSR1"):
                # C-level handler: dumps even when the main thread is
                # wedged inside a C call (blocked collective) where a
                # Python signal handler would never run.
                try:
                    faulthandler.register(
                        signal.SIGUSR1,
                        file=self._stacks_file,
                        all_threads=True,
                        chain=False,
                    )
                    self._sigusr1_registered = True
                except (OSError, ValueError, RuntimeError):
                    pass
            # Header written AFTER the SIGUSR1 registration attempt,
            # and only when it did not fail: a non-empty stacks file
            # is the agent's ack that signaling this pid is SAFE
            # (default SIGUSR1 disposition kills the process, so the
            # agent must never signal blind — sigusr1_ready()).
            if self._sigusr1_registered or not register_sigusr1:
                try:
                    self._stacks_file.write(
                        f"# flight recorder role={self.role} "
                        f"rank={self.rank} pid={os.getpid()} "
                        f"sigusr1={int(self._sigusr1_registered)} "
                        f"ts={time.time():.3f}\n"
                    )
                except OSError:
                    pass
        if self._prev_excepthook is None:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
        if self._prev_threading_excepthook is None and hasattr(
            threading, "excepthook"
        ):
            self._prev_threading_excepthook = threading.excepthook
            threading.excepthook = self._threading_excepthook
        if self._log_handler is None:
            from dlrover_tpu_torch.common.log import default_logger

            self._log_handler = _RecorderLogHandler(self)
            default_logger.addHandler(self._log_handler)

    def uninstall(self) -> None:
        """Restore hooks (tests; a real process crashes with them on)."""
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_threading_excepthook is not None:
            threading.excepthook = self._prev_threading_excepthook
            self._prev_threading_excepthook = None
        if self._log_handler is not None:
            from dlrover_tpu_torch.common.log import default_logger

            default_logger.removeHandler(self._log_handler)
            self._log_handler = None
        if self._sigusr1_registered:
            try:
                faulthandler.unregister(signal.SIGUSR1)
            except (OSError, ValueError, RuntimeError):
                pass
            self._sigusr1_registered = False
        if self._stacks_file is not None:
            try:
                # Re-point faulthandler at stderr before closing the
                # file it holds, else a later crash writes to a
                # closed fd.
                faulthandler.enable(file=sys.stderr, all_threads=True)
            except (OSError, ValueError, RuntimeError):
                try:
                    faulthandler.disable()
                except (OSError, ValueError, RuntimeError):
                    pass
            try:
                self._stacks_file.close()
            except OSError:
                pass
            self._stacks_file = None

    # -- crash hooks -----------------------------------------------------

    def _excepthook(self, exc_type, exc, tb) -> None:
        try:
            reason = "".join(
                traceback.format_exception_only(exc_type, exc)
            ).strip()[:500]
            formatted = "".join(
                traceback.format_exception(exc_type, exc, tb)
            )[-4096:]
            self.dump(
                "exception",
                reason=reason,
                extra={"traceback": formatted},
            )
        except Exception:  # noqa: BLE001 — the original traceback
            # must still reach the user even if the black box fails
            pass
        if self._prev_excepthook is not None:
            self._prev_excepthook(exc_type, exc, tb)

    def _threading_excepthook(self, args) -> None:
        try:
            reason = "".join(
                traceback.format_exception_only(
                    args.exc_type, args.exc_value
                )
            ).strip()[:500]
            thread = getattr(args.thread, "name", "?")
            self.dump(
                "thread_exception",
                reason=f"[thread {thread}] {reason}",
            )
        except Exception:  # noqa: BLE001
            pass
        if self._prev_threading_excepthook is not None:
            self._prev_threading_excepthook(args)

    # -- bundles ---------------------------------------------------------

    def snapshot(self, kind: str = "manual", reason: str = "") -> dict:
        """The black-box contents as one JSON-able dict."""
        from dlrover_tpu_torch import obs

        with self._lock:
            logs = list(self._log_ring)
            notes = dict(self._notes)
        tracer = obs.get_tracer()
        events = tracer.events()[-_EVENT_TAIL:] if tracer else []
        try:
            metrics = obs.get_registry().dump()
        except Exception:  # noqa: BLE001 — a half-poisoned registry
            # must not block the crash dump
            metrics = {}
        return {
            "schema": BUNDLE_SCHEMA_VERSION,
            "kind": kind,
            "reason": reason,
            "ts": time.time(),
            "role": self.role,
            "rank": self.rank,
            "pid": os.getpid(),
            "proc": _process_info(),
            "env": _env_snapshot(),
            "notes": notes,
            "logs": logs,
            "events": events,
            "metrics": metrics,
            "stacks": _thread_stacks(),
            "stacks_file": self.stacks_path,
        }

    def dump(
        self,
        kind: str,
        reason: str = "",
        extra: Optional[dict] = None,
        incident: Optional[dict] = None,
    ) -> Optional[str]:
        """Write one bundle file; returns its path (None on failure).
        ``incident`` facts (hang_seconds, exit_code, ...) merge into
        THIS bundle's notes only — never into the recorder's
        persistent notes, which must keep describing the live process
        (a later diagnose snapshot must not replay a past hang's
        facts). Retention: at most ``keep`` bundles per process."""
        try:
            bundle = self.snapshot(kind=kind, reason=reason)
            if incident:
                bundle["notes"] = {**bundle["notes"], **incident}
            if extra:
                bundle.update(extra)
            with self._lock:
                self._bundle_seq += 1
                seq = self._bundle_seq
            fname = (
                f"bundle_{self.role}_r{self.rank}_{os.getpid()}"
                f"_{seq:03d}_{kind}.json"
            )
            path = os.path.join(self.dir, fname)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, default=str)
            os.replace(tmp, path)
            self._bundle_paths.append(path)
            while len(self._bundle_paths) > self.keep:
                stale = self._bundle_paths.popleft()
                try:
                    os.remove(stale)
                except OSError:
                    pass
            return path
        except Exception:  # noqa: BLE001 — the black box must never
            # turn a crash into a different crash
            return None


def make_digest(
    kind: str,
    stacks_text: str = "",
    recorder: Optional[FlightRecorder] = None,
    incident: Optional[dict] = None,
    cap: int = _DIGEST_CAP,
) -> str:
    """Size-capped human-readable digest for failure reports and the
    master's per-node diagnostics history: top stack frames first
    (they carry the verdict), then this incident's facts and the
    recorder's last notes/events."""
    parts: List[str] = [f"-- forensics digest ({kind}) --"]
    if stacks_text:
        parts.append(stacks_text.strip())
    notes: Dict[str, Any] = {}
    logs: List[dict] = []
    if recorder is not None:
        with recorder._lock:
            notes = dict(recorder._notes)
            logs = list(recorder._log_ring)[-5:]
    if incident:
        notes.update(incident)
    if notes:
        parts.append(
            "notes: "
            + json.dumps(notes, default=str, sort_keys=True)[:500]
        )
    for rec in logs:
        parts.append(
            f"log {rec.get('level')}: {rec.get('msg', '')[:200]}"
        )
    digest = "\n".join(parts)
    return digest[:cap]


def sigusr1_ready(pid: int, dir_: Optional[str] = None) -> bool:
    """True when ``pid``'s recorder registered the SIGUSR1 stack-dump
    handler (its stacks file carries the post-registration header
    line). The agent MUST check this before signaling: the default
    SIGUSR1 disposition terminates the process, so signaling a
    trainer whose recorder is disabled (``DLROVER_TPU_FLIGHT_RECORDER
    =0``), not yet installed (still importing), or whose registration
    failed would turn a diagnostics snapshot into a kill."""
    try:
        with open(stacks_file_path(pid, dir_), "rb") as f:
            header = f.readline()
    except OSError:
        return False
    return b"sigusr1=1" in header


def read_stacks_tail(
    path: str, since: int = 0, cap: int = 8192
) -> str:
    """Bytes ``since``.. of a stacks file (capped): the agent reads
    the growth the SIGUSR1 dump produced, not the whole history."""
    try:
        with open(path, "rb") as f:
            f.seek(since)
            data = f.read(cap + 1)
    except OSError:
        return ""
    return data[:cap].decode("utf-8", "replace")


# -- module-level singleton -------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_install_lock = threading.Lock()


def install_flight_recorder(
    role: str,
    rank: Optional[int] = None,
    dir_: Optional[str] = None,
) -> Optional[FlightRecorder]:
    """Install the process's recorder (idempotent; first caller wins).
    Trainer role additionally gets the SIGUSR1 stack-dump handler so
    the agent can snapshot it while hung. Returns None when disabled
    via ``DLROVER_TPU_FLIGHT_RECORDER=0``."""
    if os.getenv(FLIGHT_RECORDER_ENV, "") == "0":
        return None
    global _recorder
    with _install_lock:
        if _recorder is not None:
            return _recorder
        if rank is None:
            from dlrover_tpu_torch.common.log import role_and_rank

            _, rank = role_and_rank()
        rec = FlightRecorder(role, rank=rank, dir_=dir_)
        try:
            rec.install(register_sigusr1=(role == "trainer"))
        except Exception:  # noqa: BLE001 — a broken forensics dir
            # must not stop the process from starting
            return None
        _recorder = rec
        return rec


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _recorder


def uninstall_flight_recorder() -> None:
    """Tear down the singleton (tests)."""
    global _recorder
    with _install_lock:
        if _recorder is not None:
            _recorder.uninstall()
            _recorder = None


def recorder_note(**kv) -> None:
    """Record 'last known' facts into the black box; a single
    None-check when no recorder is installed."""
    rec = _recorder
    if rec is not None:
        rec.note(**kv)
