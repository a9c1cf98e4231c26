"""Replica worker: one model copy behind a continuous-batching
scheduler, attached to the master's control plane.

The worker is the serving counterpart of a training agent's trainer
process: it registers in the master's node table as
``NodeType.REPLICA`` (namespaced id, constants.replica_node_id),
heartbeats like any node (so the existing watchdog declares it dead
and the router requeues its work), PULLS requests off the router
(mirroring the shard protocol's ``get_task``), steps its scheduler,
and reports completions and periodic stats.

Heartbeat actions it honors:

* ``restart_training`` — bounce in place: drop local scheduler state
  and re-register (the router requeues anything the old incarnation
  held on re-registration, so the requests ride to a healthy replica
  or back to this fresh one);
* ``cordon`` — park: stop pulling work (still heartbeating) until a
  ``restart_training`` un-parks.

Runnable standalone for drills and local serving::

    python -m dlrover_tpu_torch.serving.replica --master 127.0.0.1:PORT \
        --replica_id 0 --seed 7            # on the GPU
    python -m dlrover_tpu_torch.serving.replica --master 127.0.0.1:PORT \
        --replica_id 0 --device cpu       # on the CPU, when asked

(the CLI builds a seed-deterministic tiny Llama so every replica of
the fleet on one kind of device holds the SAME model — the drill's
requeue-equivalence assertions depend on it). This is the port of
``dlrover_tpu/serving/replica.py``: the same worker loop, with the
model on a device the caller names (the GPU unless ``--device cpu``;
without one the CLI raises), and a restart that frees the old
scheduler's KV cache before it builds the new one.
"""

from __future__ import annotations

import argparse
import threading
import time
from collections import deque
from typing import Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import (
    EventAction,
    NodeType,
    replica_node_id,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.serving import handoff as handoff_mod
from dlrover_tpu_torch.serving.scheduler import (
    FINISH_HANDOFF,
    ROLE_MIXED,
    ContinuousBatchingScheduler,
    ServeRequest,
)

logger = get_logger("serving.replica")


class ReplicaWorker:
    def __init__(
        self,
        master_addr: str,
        replica_id: int,
        params,
        cfg,
        lanes: int = 2,
        max_len: Optional[int] = None,
        block_size: int = 8,
        prefill_chunk: int = 16,
        prefill_budget: Optional[int] = None,
        total_blocks: Optional[int] = None,
        eos_id: Optional[int] = None,
        heartbeat_interval: float = 1.0,
        stats_interval: float = 1.0,
        pull_batch: int = 4,
        pull_interval_s: float = 0.05,
        idle_sleep_s: float = 0.02,
        name: str = "",
        role: str = ROLE_MIXED,
    ):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        self.replica_id = replica_id
        self.node_id = replica_node_id(replica_id)
        self.name = name or f"replica-{replica_id}"
        self.role = role
        self.client = MasterClient(
            master_addr, node_id=self.node_id
        )
        self._sched_kwargs = dict(
            lanes=lanes,
            max_len=max_len,
            block_size=block_size,
            prefill_chunk=prefill_chunk,
            prefill_budget=prefill_budget,
            total_blocks=total_blocks,
            eos_id=eos_id,
            role=role,
        )
        self.params = params
        self.cfg = cfg
        self.scheduler = ContinuousBatchingScheduler(
            params, cfg, **self._sched_kwargs
        )
        self.heartbeat_interval = heartbeat_interval
        self.stats_interval = stats_interval
        self.pull_batch = pull_batch
        # Busy-loop pull throttle: while sequences are resident, the
        # pull RPC fires at most every pull_interval_s — otherwise a
        # replica with a free lane pays a master roundtrip between
        # EVERY decode tick, and that roundtrip (not the model)
        # dominates TPOT at small batch. An EMPTY scheduler still
        # pulls every iteration (nothing to delay).
        self.pull_interval_s = pull_interval_s
        self._last_pull = 0.0
        self.idle_sleep_s = idle_sleep_s
        # Async completion reporter: the decode loop must never
        # block on a completion RPC (each one is a master roundtrip
        # — under a handoff-heavy storm those stalls, not the model,
        # would dominate TPOT). run_forever drains the queue on a
        # daemon thread; without the thread (tests driving run_once
        # directly) reports go inline.
        self._report_queue: deque = deque()
        self._report_cond = threading.Condition()
        self._reporter: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._parked = False
        self._last_hb = 0.0
        self._last_stats = 0.0
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0

    # -- lifecycle ----------------------------------------------------------

    def register(self) -> None:
        self.client.register_node(
            node_type=NodeType.REPLICA,
            node_ip=self.name,
            labels={"serving_role": self.role},
        )
        obs.event(
            "serve.replica_register",
            replica_id=self.node_id, replica_name=self.name,
            role=self.role,
        )

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run_forever,
                name=f"replica-{self.replica_id}",
                daemon=True,
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._report_cond:
            self._report_cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._reporter is not None:
            self._reporter.join(timeout=5.0)
            self._reporter = None
        self._drain_reports()
        self.client.close()

    # -- loop ---------------------------------------------------------------

    def _heartbeat_tick(self, now: float) -> None:
        if now - self._last_hb < self.heartbeat_interval:
            return
        self._last_hb = now
        try:
            action = self.client.heartbeat()
        except Exception:  # noqa: BLE001 — the supervisor inside the
            # client already classified; a heartbeat miss is the
            # master watchdog's signal, not ours to crash on
            logger.debug("replica heartbeat failed", exc_info=True)
            return
        if action == EventAction.RESTART_TRAINING.value:
            self.restart_in_place()
        elif action == EventAction.CORDON.value:
            if not self._parked:
                logger.warning(
                    "replica %d parked by cordon", self.replica_id
                )
            self._parked = True

    def restart_in_place(self) -> None:
        """The restart rung of the serving ladder, executed locally:
        drop every local sequence (a fresh incarnation), rebuild the
        scheduler, and re-register — the router requeues whatever the
        old incarnation still held the moment it sees the
        re-registration, so no request depends on our dropped
        state."""
        dropped = len(self.scheduler.drain())
        # Free the old incarnation's KV cache first: two caches at once
        # would need twice the cache's device memory.
        self.scheduler = None
        self.scheduler = ContinuousBatchingScheduler(
            self.params, self.cfg, **self._sched_kwargs
        )
        self.restarts += 1
        self._parked = False
        obs.event(
            "serve.replica_restart",
            replica_id=self.node_id, dropped=dropped,
        )
        logger.warning(
            "replica %d restarted in place (%d request(s) dropped "
            "for requeue)", self.replica_id, dropped,
        )
        try:
            self.register()
        except Exception:  # noqa: BLE001
            logger.warning(
                "re-register after restart failed", exc_info=True
            )

    def _stats_tick(self, now: float) -> None:
        if now - self._last_stats < self.stats_interval:
            return
        self._last_stats = now
        self.client.serve_stats(self.node_id, self.scheduler.stats())

    def run_once(self) -> int:
        """One loop iteration: heartbeat, pull, step, report.
        Returns the number of requests completed (drives the idle
        backoff)."""
        now = time.monotonic()
        self._heartbeat_tick(now)
        self._stats_tick(now)
        if self._parked:
            return 0
        want = min(self.scheduler.capacity_hint(), self.pull_batch)
        if want > 0 and (
            self.scheduler.active() == 0
            or now - self._last_pull >= self.pull_interval_s
        ):
            self._last_pull = now
            try:
                items = self.client.serve_pull(
                    self.node_id, max_items=want
                )
            except Exception:  # noqa: BLE001 — a pull miss is
                # retried next iteration
                logger.debug("serve pull failed", exc_info=True)
                items = []
            for item in items:
                if item.handoff:
                    # A completed prefill bound for this decode/
                    # mixed replica: import its KV instead of
                    # re-prefilling the prompt.
                    self.scheduler.submit_handoff(
                        handoff_mod.unpack(item.handoff)
                    )
                    continue
                self.scheduler.submit(
                    ServeRequest(
                        request_id=item.request_id,
                        prompt=list(item.prompt),
                        max_new_tokens=item.max_new_tokens,
                        temperature=item.temperature,
                        trace=dict(item.trace or {}),
                    )
                )
        completed = self.scheduler.step()
        for c in completed:
            report = dict(
                request_id=c.request_id,
                tokens=c.tokens,
                ttft_s=c.ttft_s,
                tpot_s=c.tpot_s,
                finish_reason=c.finish_reason,
                error=c.error,
                phases=c.phases,
                # A prefill-role export: the KV payload rides the
                # same completion RPC up to the master's staging
                # queue (a stage transition, not a completion).
                handoff=(
                    handoff_mod.pack(c.handoff)
                    if c.finish_reason == FINISH_HANDOFF
                    and c.handoff is not None
                    else None
                ),
            )
            if self._reporter is not None:
                with self._report_cond:
                    self._report_queue.append(report)
                    self._report_cond.notify()
            else:
                self._send_report(report)
        return len(completed)

    def _send_report(self, report: dict) -> None:
        try:
            self.client.serve_complete(self.node_id, **report)
        except Exception:  # noqa: BLE001 — the router requeues on
            # our death; a lost completion costs a recompute, never
            # the request
            logger.warning(
                "completion report for %s failed",
                report.get("request_id"), exc_info=True,
            )

    def _reporter_loop(self) -> None:
        while True:
            with self._report_cond:
                while not self._report_queue:
                    if self._stop.is_set():
                        return
                    self._report_cond.wait(timeout=0.2)
                report = self._report_queue.popleft()
            self._send_report(report)

    def _drain_reports(self, timeout_s: float = 5.0) -> None:
        """Flush queued completion reports at shutdown (best-effort:
        anything lost is requeued by the router's watchdog)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._report_cond:
                if not self._report_queue:
                    return
                report = self._report_queue.popleft()
            self._send_report(report)

    def run_forever(self) -> None:
        self.register()
        if self._reporter is None:
            self._reporter = threading.Thread(
                target=self._reporter_loop,
                name=f"replica-reporter-{self.replica_id}",
                daemon=True,
            )
            self._reporter.start()
        while not self._stop.is_set():
            busy = self.run_once()
            # Back off when there is nothing to step: idle, or
            # parked by a cordon (a parked replica skipping its
            # scheduler must not busy-spin a core while it waits for
            # the master's verdict).
            if not busy and (
                self._parked
                or (
                    self.scheduler.active() == 0
                    and self.scheduler.queue_depth() == 0
                )
            ):
                self._stop.wait(self.idle_sleep_s)


def build_tiny_model(seed: int, block_size: int = 128, device=None):
    """The drill fleet's model: a seed-deterministic tiny Llama on
    ``device`` (the GPU unless the caller passes ``device="cpu"``) —
    every replica built from the same seed on the same kind of device
    holds bitwise-identical weights, so greedy results are
    replica-independent."""
    import dataclasses as _dc

    import torch

    from dlrover_tpu_torch.common.device import resolve_device
    from dlrover_tpu_torch.models import llama

    dev = resolve_device(device)
    cfg = _dc.replace(
        llama.LlamaConfig.tiny(), block_size=block_size
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = llama.init_params(cfg, generator=gen, device=dev)
    return params, cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser("dlrover-tpu-replica")
    p.add_argument("--master", required=True, help="host:port")
    p.add_argument("--replica_id", type=int, required=True)
    p.add_argument(
        "--seed", type=int, default=0,
        help="model seed (all fleet replicas must share it)",
    )
    p.add_argument("--lanes", type=int, default=2)
    p.add_argument("--block_size", type=int, default=8)
    p.add_argument("--prefill_chunk", type=int, default=16)
    p.add_argument(
        "--prefill_budget", type=int, default=0,
        help="prompt tokens prefilled per scheduler step across "
        "sequences (0 = the scheduler default, 2x prefill_chunk)",
    )
    p.add_argument("--pull_interval_s", type=float, default=0.05)
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--heartbeat_interval", type=float, default=1.0)
    p.add_argument("--stats_interval", type=float, default=1.0)
    p.add_argument("--pull_batch", type=int, default=4)
    p.add_argument(
        "--role", type=str, default="mixed",
        choices=["mixed", "prefill", "decode"],
        help="disaggregation role: prefill replicas only prefill "
        "and export KV handoffs, decode replicas only decode "
        "handoff imports, mixed does both (colocated default)",
    )
    p.add_argument(
        "--device", type=str, default=None,
        help="device of the model (default: the GPU; raises without "
        "one unless 'cpu' is given)",
    )
    args = p.parse_args(argv)
    params, cfg = build_tiny_model(
        args.seed, block_size=max(args.max_len, 64), device=args.device
    )
    worker = ReplicaWorker(
        args.master,
        args.replica_id,
        params,
        cfg,
        lanes=args.lanes,
        max_len=args.max_len,
        block_size=args.block_size,
        prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget or None,
        heartbeat_interval=args.heartbeat_interval,
        stats_interval=args.stats_interval,
        pull_batch=args.pull_batch,
        pull_interval_s=args.pull_interval_s,
        role=args.role,
    )
    print(f"DLROVER_TPU_REPLICA={args.replica_id}", flush=True)
    try:
        worker.run_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
