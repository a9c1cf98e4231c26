"""Durable master state: versioned JSON snapshots + a dirty-debounced
journal, so a replacement master can warm-restart instead of taking
the whole fleet down with it.

The master's recoverable state — node table, rendezvous round/world,
dataset-shard ledger, kv-store contents, speed-monitor progress — is
collected by ``JobMaster._collect_state()`` into one JSON document and
written atomically (tmp + fsync + rename) into ``state_dir`` as
``master_state-<seq>.json``. The newest *valid* snapshot wins on
restore: a torn or unparsable file (master killed mid-write is exactly
the case this exists for) falls back to the previous sequence number,
and ``keep`` generations are retained.

Writes are driven two ways, both through :class:`StateJournal`:

* **state-changing events** — components call ``mark_dirty()`` (via
  the hooks JobMaster installs); the journal thread flushes at most
  once per ``min_interval`` so a shard-dispatch hot loop cannot turn
  the master into an fsync benchmark;
* **a low-frequency timer** — every ``timer_interval`` seconds a
  dirty journal is flushed even if the event volume stayed under the
  debounce, bounding staleness for slow-changing state (heartbeats,
  speed-monitor progress).

Nothing here imports master components: the journal takes a
``collect`` callable, so tests can snapshot arbitrary payloads.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, List, Optional, Tuple

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("state_store")

STATE_DIR_ENV = "DLROVER_TPU_STATE_DIR"
SNAPSHOT_SECONDS_ENV = "DLROVER_TPU_SNAPSHOT_SECONDS"
SNAPSHOT_MIN_INTERVAL_ENV = "DLROVER_TPU_SNAPSHOT_MIN_INTERVAL"

SCHEMA_VERSION = 1
_FILE_RE = re.compile(r"^master_state-(\d+)\.json$")


class MasterStateStore:
    """Atomic, generation-numbered snapshot files in one directory."""

    def __init__(self, state_dir: str, keep: int = 3):
        self.state_dir = state_dir
        self.keep = max(keep, 1)
        os.makedirs(state_dir, exist_ok=True)

    def _generations(self) -> List[Tuple[int, str]]:
        out = []
        try:
            names = os.listdir(self.state_dir)
        except OSError:
            return []
        for name in names:
            m = _FILE_RE.match(name)
            if m:
                out.append(
                    (int(m.group(1)), os.path.join(self.state_dir, name))
                )
        return sorted(out)

    def save(self, payload: dict) -> str:
        """Write the next generation atomically; prune old ones."""
        gens = self._generations()
        seq = (gens[-1][0] + 1) if gens else 1
        doc = {
            "schema_version": SCHEMA_VERSION,
            "seq": seq,
            "saved_at": time.time(),
            "state": payload,
        }
        path = os.path.join(self.state_dir, f"master_state-{seq}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for _, old in gens[: max(0, len(gens) + 1 - self.keep)]:
            try:
                os.remove(old)
            except OSError:
                pass
        # Sweep tmp files orphaned by a master killed mid-write
        # (their pids never write again, so nothing else reclaims
        # them and repeated bounces would accumulate garbage).
        try:
            for name in os.listdir(self.state_dir):
                if ".json.tmp." in name and not tmp.endswith(name):
                    try:
                        os.remove(os.path.join(self.state_dir, name))
                    except OSError:
                        pass
        except OSError:
            pass
        return path

    def load_latest(self) -> Optional[dict]:
        """Newest snapshot that parses and matches the schema, or
        None. Falls back across generations: the newest file may be a
        torn write from the master's death."""
        for _, path in reversed(self._generations()):
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                logger.warning(
                    "skipping unreadable master snapshot %s", path
                )
                continue
            if (
                isinstance(doc, dict)
                and doc.get("schema_version") == SCHEMA_VERSION
                and isinstance(doc.get("state"), dict)
            ):
                doc["path"] = path
                return doc
            logger.warning(
                "skipping master snapshot %s with unknown schema %r",
                path, doc.get("schema_version") if isinstance(doc, dict)
                else type(doc).__name__,
            )
        return None


class StateJournal:
    """Debounced writer pumping ``collect()`` into a store."""

    def __init__(
        self,
        store: MasterStateStore,
        collect: Callable[[], dict],
        min_interval: Optional[float] = None,
        timer_interval: Optional[float] = None,
    ):
        if min_interval is None:
            min_interval = float(
                os.getenv(SNAPSHOT_MIN_INTERVAL_ENV, "") or 1.0
            )
        if timer_interval is None:
            timer_interval = float(
                os.getenv(SNAPSHOT_SECONDS_ENV, "") or 30.0
            )
        self.store = store
        self._collect = collect
        self.min_interval = min_interval
        self.timer_interval = timer_interval
        self._dirty = threading.Event()
        self._urgent = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._write_lock = threading.Lock()
        self._last_write = 0.0  # monotonic
        self.writes = 0
        self.write_errors = 0

    def mark_dirty(self, *_args, urgent: bool = False, **_kwargs) -> None:
        """Signal that recoverable state changed. Accepts (and
        ignores) arbitrary args so it can be registered directly as a
        node-event listener / on_state_change callback.

        ``urgent=True`` skips the min_interval debounce for the next
        flush: used for acknowledgements the master must not forget
        (shard completions) — the at-least-once window shrinks from
        the debounce interval to the write latency."""
        if urgent:
            self._urgent.set()
        self._dirty.set()

    def flush(self) -> Optional[str]:
        """Write a snapshot now (used at stop and by tests)."""
        with self._write_lock:
            self._dirty.clear()
            self._urgent.clear()
            try:
                path = self.store.save(self._collect())
            except Exception:  # noqa: BLE001 — a full disk must not
                # take down the live control plane it is backing up
                self.write_errors += 1
                logger.warning("master state snapshot failed",
                               exc_info=True)
                return None
            self._last_write = time.monotonic()
            self.writes += 1
            return path

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="master-state-journal", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            # Wake on dirty or after the timer interval, whichever
            # first; then debounce event bursts to min_interval.
            self._dirty.wait(self.timer_interval)
            if self._stop.is_set():
                return
            if not self._dirty.is_set():
                continue
            since = time.monotonic() - self._last_write
            if not self._urgent.is_set() and since < self.min_interval:
                # Debounce event bursts — but an urgent mark (shard
                # completion ack) breaks the sleep and flushes now.
                self._urgent.wait(self.min_interval - since)
                if self._stop.is_set():
                    return
            self.flush()

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        self._dirty.set()  # unblock the timer wait
        self._urgent.set()  # unblock a debounce sleep
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_flush:
            self.flush()
