"""Per-replica continuous-batching scheduler (Orca-style iteration-
level scheduling, OSDI '22); the port of ``dlrover_tpu/serving/
scheduler.py``.

One :meth:`ContinuousBatchingScheduler.step` is one *iteration* of the
whole replica, not of one request:

1. **retire** — sequences that hit their token budget (or EOS) leave
   the batch and free their KV blocks *this* step, not at batch end;
2. **admit** — queued requests claim free lanes + blocks from the
   :class:`~dlrover_tpu_torch.serving.kv_pool.KVBlockPool` and join
   immediately (no padding a static batch to completion);
3. **prefill** — admitted prompts advance in bounded chunks
   (``prefill_chunk`` tokens per sequence, ``prefill_budget`` tokens
   per step across sequences), so a long prompt cannot stall the
   decode latency of sequences already streaming;
4. **decode** — ONE ragged batched step
   (models/generate.llama_decode_step_ragged) advances every decoding
   lane at its own position, always over all ``lanes`` (one shape for
   any active set); sampling (greedy / temperature, from the
   scheduler's own ``torch.Generator`` on the device) happens on the
   device, and the only device-to-host copy in the steady decode loop
   is the sampled ``[lanes]`` token vector.

The programs are eager PyTorch on the device of the parameters: the
cache is one preallocated multi-lane ``generate.KVCache`` written in
place, the lane prefill runs the flash kernel K1 and the fused norm
kernel K3 where the model path picks them (``models/generate.py``).
The request types, roles, metrics and every method that touches no
device are the JAX scheduler's, unchanged.

KV pressure is honest: growth past a block boundary that the pool
cannot fund preempts the *youngest* resident sequence back to the
queue (recompute preemption — greedy decode redoes to the identical
result), never wedges the batch.

The scheduler is a plain in-process object: the replica worker
(serving/replica.py) drives it against the master's router; tests
drive it directly.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.serving.kv_pool import KVBlockPool

_TOKENS_TOTAL = obs.counter(
    "dlrover_serve_tokens_total",
    "Tokens processed by this replica's scheduler, by kind "
    "(prefill / decode)",
    ("kind",),
)
_PREEMPTIONS_TOTAL = obs.counter(
    "dlrover_serve_preemptions_total",
    "Sequences preempted back to the queue by KV block-pool "
    "exhaustion on this replica",
)
_REPLICA_QUEUE = obs.gauge(
    "dlrover_serve_replica_queue_depth",
    "Requests waiting in this replica's local admission queue",
)
_ACTIVE_SEQS = obs.gauge(
    "dlrover_serve_active_sequences",
    "Sequences currently resident in this replica's decode batch "
    "(prefilling or decoding)",
)
_TTFT_SECONDS = obs.histogram(
    "dlrover_serve_ttft_seconds",
    "Time from request admission on this replica to its first "
    "generated token",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
_TPOT_SECONDS = obs.histogram(
    "dlrover_serve_tpot_seconds",
    "Mean time per generated output token after the first, per "
    "completed request on this replica",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)

PHASE_PREFILL = "prefill"
PHASE_DECODE = "decode"

# Replica roles (prefill/decode disaggregation, docs/SERVING.md):
# MIXED is the colocated default (prefill + decode in one loop);
# PREFILL runs only lane-chunk prefill and EXPORTS finished
# sequences' KV as handoffs; DECODE runs only the ragged decode step,
# admitting from handoff IMPORTS — its ticks are never preempted by a
# prompt storm.
ROLE_MIXED = "mixed"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLES = (ROLE_MIXED, ROLE_PREFILL, ROLE_DECODE)

FINISH_LENGTH = "length"
FINISH_EOS = "eos"
FINISH_ERROR = "error"
# A prefill-role "completion" that is really a stage transition: the
# CompletedRequest carries the KV handoff payload instead of tokens.
FINISH_HANDOFF = "handoff"

# How many recent latency samples the stats surface keeps.
LATENCY_WINDOW = 256


@dataclasses.dataclass
class ServeRequest:
    """One generation request as it rides queues and the wire.
    ``trace`` is the router-minted trace-context carrier
    (``{"trace_id", "span_id"}``) re-attached on every hop so
    scheduler events stay in the request's causal timeline."""

    request_id: str
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    trace: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Router-attached packed HandoffPayload wire dict when this item
    # is a completed prefill bound for a decode replica. NOT part of
    # to_dict(): on the wire it rides ServeWorkItem.handoff.
    handoff: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "trace": dict(self.trace),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServeRequest":
        return cls(
            request_id=str(d.get("request_id", "")),
            prompt=[int(t) for t in d.get("prompt", [])],
            max_new_tokens=int(d.get("max_new_tokens", 16)),
            temperature=float(d.get("temperature", 0.0)),
            trace={
                str(k): str(v)
                for k, v in (d.get("trace") or {}).items()
            },
        )


@dataclasses.dataclass
class CompletedRequest:
    request_id: str
    tokens: List[int]
    finish_reason: str = FINISH_LENGTH
    error: str = ""
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    wall_s: float = 0.0
    # Replica-side TTFT decomposition (per-phase durations, seconds):
    # dispatch (local queue wait: scheduler submit -> lane admission),
    # prefill (admission -> last prompt chunk), first_decode (prefill
    # done -> first token), decode (first -> last token). dispatch +
    # prefill + first_decode == ttft_s + dispatch by construction;
    # the router folds these into the request's trace timeline. A
    # handoff-imported completion additionally carries "handoff" (the
    # decode replica's local import wait — the master adds its own
    # staged wait when assembling the trace).
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Prefill-role export: set when finish_reason == FINISH_HANDOFF
    # (a HandoffPayload — the request's KV blocks + sampling state,
    # bound for a decode replica via the complete/pull seam).
    handoff: Optional[object] = None


class _Seq:
    """A resident sequence: one lane of the decode batch."""

    __slots__ = (
        "req", "lane", "phase", "prefilled", "generated",
        "admit_ts", "first_token_ts", "last_token_ts", "last_logits",
        "dispatch_wait_s", "prefill_done_ts", "imported_phases",
        "imported_ttft_s", "import_wait_s",
    )

    def __init__(self, req: ServeRequest, lane: int, now: float):
        self.req = req
        self.lane = lane
        self.phase = PHASE_PREFILL
        self.prefilled = 0
        self.generated: List[int] = []
        self.admit_ts = now
        self.first_token_ts = 0.0
        self.last_token_ts = 0.0
        # TTFT phase boundaries: how long the request waited in this
        # replica's local queue before claiming a lane, and when its
        # prompt finished prefilling.
        self.dispatch_wait_s = 0.0
        self.prefill_done_ts = 0.0
        # Host copy of the final prefill chunk's logits row, used to
        # sample the first token at the prefill -> decode handoff.
        self.last_logits: Optional[np.ndarray] = None
        # Handoff import (decode role): the PREFILL replica's phase
        # decomposition and TTFT, carried so the completing replica
        # reports the request's true end-to-end phases; None when the
        # sequence prefilled locally.
        self.imported_phases: Optional[Dict[str, float]] = None
        self.imported_ttft_s = 0.0
        self.import_wait_s = 0.0

    @property
    def length(self) -> int:
        return len(self.req.prompt) + len(self.generated)


class ContinuousBatchingScheduler:
    def __init__(
        self,
        params,
        cfg,
        lanes: int = 4,
        max_len: Optional[int] = None,
        block_size: int = 16,
        total_blocks: Optional[int] = None,
        prefill_chunk: int = 16,
        prefill_budget: Optional[int] = None,
        max_queue: int = 1024,
        eos_id: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        role: str = ROLE_MIXED,
    ):
        """``prefill_budget`` (default ``2 * prefill_chunk``) caps the
        total prompt tokens processed per step across all admitting
        sequences — the decode-latency protection knob. Llama-family
        configs only (the ragged decode step's contract).

        ``role`` selects the disaggregation mode: ``mixed`` (default,
        colocated), ``prefill`` (prefill-only — finished prompts
        EXPORT as KV handoffs instead of entering decode), ``decode``
        (decode-only — admission comes from :meth:`submit_handoff`
        imports; a raw prompt submitted here fails loudly at
        admission, it can never prefill)."""
        from dlrover_tpu_torch.models import generate, llama

        if not isinstance(cfg, llama.LlamaConfig):
            raise TypeError(
                "the serving scheduler drives the Llama-family ragged "
                f"decode path; got config {type(cfg).__name__}"
            )
        if role not in ROLES:
            raise ValueError(
                f"unknown scheduler role {role!r}; expected one of "
                f"{ROLES}"
            )
        self.role = role
        self.params = params
        self.cfg = cfg
        self.lanes = lanes
        self.max_len = min(max_len or cfg.block_size, cfg.block_size)
        self.prefill_chunk = max(
            min(int(prefill_chunk), self.max_len), 1
        )
        self.prefill_budget = (
            int(prefill_budget)
            if prefill_budget is not None
            else 2 * self.prefill_chunk
        )
        self.eos_id = eos_id
        self.clock = clock
        self.pool = KVBlockPool(
            lanes=lanes,
            max_len=self.max_len,
            block_size=block_size,
            total_blocks=total_blocks,
        )
        self._queue: deque = deque()
        # Completed-prefill imports awaiting lane admission (decode /
        # mixed roles; HandoffPayload entries).
        self._handoff_queue: deque = deque()
        self.max_queue = max_queue
        # request_id -> local-queue entry stamp (the "dispatch" TTFT
        # phase: scheduler submit -> lane admission). Entries leave at
        # admission/rejection; a preemption re-stamps (its re-
        # admission wait is a fresh dispatch phase, matching the
        # recomputed TTFT).
        self._enqueue_ts: Dict[str, float] = {}
        self._by_lane: Dict[int, _Seq] = {}
        self._steps = 0
        self._completed_total = 0
        self._failed_total = 0
        self._preempted_total = 0
        self._handoffs_exported = 0
        self._handoffs_imported = 0
        self._tokens_generated = 0
        self._ttft_recent: deque = deque(maxlen=LATENCY_WINDOW)
        self._tpot_recent: deque = deque(maxlen=LATENCY_WINDOW)
        self._build_programs(generate, llama)

    # -- jitted programs ---------------------------------------------------

    def _build_programs(self, generate, llama) -> None:
        """Build-once programs on the device of the parameters. The
        decode program closes over cfg and the rope tables and takes
        ONLY device tensors — sampling (greedy vs per-lane temperature,
        ``torch.multinomial`` from the scheduler's own generator on the
        device) runs inside it, so the steady decode loop's one
        device-to-host copy is the [lanes] token vector. Prefill is one
        program too: ragged tails pad up to prefill_chunk, so one shape
        covers every chunk."""
        import torch

        cfg = self.cfg
        device = self.params["wte"].device
        # The physical cache rounds max_len UP to a prefill-chunk
        # multiple: a padded final chunk writes [start, start+chunk),
        # and a slice assignment that crosses the buffer end raises
        # (the JAX update silently clamps it onto wrong positions).
        # Real data never exceeds max_len (admission guards it); the
        # slack rows only ever hold pad garbage no causal mask can
        # expose. The rope tables extend to match so the final
        # chunk's table slice cannot fall short either. It then rounds
        # to a KV-BLOCK multiple too: handoff installs are block-padded
        # (handoff.py), and their write window must never cross the
        # buffer end for the same reason.
        cache_len = (
            -(-self.max_len // self.prefill_chunk)
            * self.prefill_chunk
        )
        cache_len = (
            -(-cache_len // self.pool.block_size)
            * self.pool.block_size
        )
        rope = llama.rope_table(cfg, cache_len, device)
        self._device = device
        self._cache = generate._cache_for(
            cfg, self.lanes, cache_len, generate._kv_heads(cfg), device
        )
        gen = torch.Generator(device=device).manual_seed(0)

        def decode(params, cache, token, pos, temps, active):
            logits, cache = generate.llama_decode_step_ragged(
                params, cache, token, pos, cfg, rope=rope,
                active=active,
            )
            greedy = logits.argmax(dim=-1)
            scaled = logits / temps.clamp(min=1e-6)[:, None]
            sampled = torch.multinomial(
                torch.softmax(scaled, dim=-1), 1, generator=gen
            )[:, 0]
            tok = torch.where(temps > 0.0, sampled, greedy)
            return tok.to(torch.int32), cache

        self._decode_fn = decode

        def prefill(params, cache, tokens, lane, start):
            return generate.llama_lane_prefill_chunk(
                params, cache, tokens, lane, start, cfg, rope=rope
            )

        self._prefill_fn = prefill
        # Handoff install (decode/mixed roles): an in-place copy into
        # one lane of the cache.
        from dlrover_tpu_torch.serving import handoff as handoff_mod

        self._handoff_mod = handoff_mod
        self._install_fn = handoff_mod.make_install_fn()

    # -- submission --------------------------------------------------------

    def submit(self, req: ServeRequest) -> bool:
        """Queue a request for admission. False = queue full (the
        caller backs off / the router keeps it).

        Duplicate request_ids are dropped (returning True): a router
        requeue can race the ORIGINAL copy still resident or queued
        on this very replica (reconnect re-registration requeues a
        live replica's in-flight work, and the next pull may hand it
        straight back) — the resident copy completes and the
        ledger's first-completion-wins drops any other. Without the
        dedupe, re-admitting the id would crash the pool's
        already-resident guard."""
        rid = req.request_id
        if self._known_locally(rid):
            return True
        if len(self._queue) >= self.max_queue:
            return False
        self._queue.append(req)
        self._enqueue_ts[rid] = self.clock()
        _REPLICA_QUEUE.set(self.queue_depth())
        return True

    def _known_locally(self, rid: str) -> bool:
        return (
            self.pool.lane_of(rid) is not None
            or any(q.request_id == rid for q in self._queue)
            or any(
                h.request_id == rid for h in self._handoff_queue
            )
        )

    def submit_handoff(self, payload) -> bool:
        """Queue a completed-prefill import (decode / mixed roles)
        for lane admission. Same dedupe contract as :meth:`submit`
        (a requeue can race the resident copy); False = queue full.
        Prefill-role replicas never import — they could not decode
        the sequence."""
        if self.role == ROLE_PREFILL:
            raise ValueError(
                "a prefill-role scheduler cannot import handoffs"
            )
        rid = payload.request_id
        if self._known_locally(rid):
            return True
        if self.queue_depth() >= self.max_queue:
            return False
        self._handoff_queue.append(payload)
        self._enqueue_ts[rid] = self.clock()
        _REPLICA_QUEUE.set(self.queue_depth())
        return True

    def queue_depth(self) -> int:
        return len(self._queue) + len(self._handoff_queue)

    def active(self) -> int:
        return len(self._by_lane)

    def capacity_hint(self) -> int:
        """How many more requests this replica can reasonably take on
        board right now (free lanes minus already-queued) — the pull
        sizing the replica worker uses against the router."""
        return max(
            self.pool.free_lane_count() - self.queue_depth(), 0
        )

    # -- the iteration ------------------------------------------------------

    def step(self) -> List[CompletedRequest]:
        """One scheduler iteration; returns requests completed (or
        failed) during it. Role-typed: a PREFILL scheduler never runs
        the decode tick (finished prompts export as handoffs), a
        DECODE scheduler never prefills (handoff imports arrive with
        their KV already computed), MIXED does both — today's
        colocated behavior, bit for bit."""
        self._steps += 1
        now = self.clock()
        completed: List[CompletedRequest] = []
        if self.role != ROLE_PREFILL:
            self._admit_handoffs(now, completed)
        self._admit(now, completed)
        if self.role != ROLE_DECODE:
            self._prefill_tick(now)
        if self.role == ROLE_PREFILL:
            completed.extend(self._export_tick(now))
        else:
            completed.extend(self._decode_tick(now))
        _REPLICA_QUEUE.set(self.queue_depth())
        _ACTIVE_SEQS.set(len(self._by_lane))
        return completed

    def _admit(
        self, now: float, completed: List[CompletedRequest]
    ) -> None:
        while self._queue:
            req = self._queue[0]
            total = len(req.prompt) + req.max_new_tokens
            if (
                self.role == ROLE_DECODE
                or not req.prompt
                or req.max_new_tokens < 1
                or total > self.max_len
                or self.pool.blocks_for(total) > self.pool.total_blocks
            ):
                self._queue.popleft()
                self._enqueue_ts.pop(req.request_id, None)
                completed.append(
                    CompletedRequest(
                        request_id=req.request_id,
                        tokens=[],
                        finish_reason=FINISH_ERROR,
                        error=(
                            # A raw prompt on a decode-only replica
                            # is a routing bug: fail it loudly at
                            # admission — this replica can never
                            # prefill it.
                            "decode-role replica cannot prefill "
                            "prompts"
                            if self.role == ROLE_DECODE
                            else "empty prompt"
                            if not req.prompt
                            else "max_new_tokens must be >= 1"
                            if req.max_new_tokens < 1
                            else f"prompt+new {total} exceeds "
                            "replica capacity (max_len "
                            f"{self.max_len}, "
                            f"{self.pool.total_blocks} blocks)"
                        ),
                    )
                )
                self._failed_total += 1
                continue
            lane = self.pool.allocate(
                req.request_id, len(req.prompt)
            )
            if lane is None:
                break  # no lane / no blocks: stays queued
            self._queue.popleft()
            seq = _Seq(req, lane, now)
            seq.dispatch_wait_s = max(
                now - self._enqueue_ts.pop(req.request_id, now), 0.0
            )
            self._by_lane[lane] = seq

    def _admit_handoffs(
        self, now: float, completed: List[CompletedRequest]
    ) -> None:
        """Admit completed-prefill imports: claim a lane + blocks
        (the SAME budget accounting raw admission pays — a handoff
        cannot smuggle KV past the pool), install the payload's
        block-padded KV into the lane via the install program,
        and enter the batch directly in the DECODE phase with the
        prefill replica's first token as ``generated[0]`` — exactly
        the state a colocated scheduler is in after its own prefill,
        so greedy continuation is bitwise identical."""
        import torch

        while self._handoff_queue:
            h = self._handoff_queue[0]
            plen = h.prompt_len
            total = plen + h.max_new_tokens
            if (
                plen < 1
                or h.max_new_tokens < 1
                or total > self.max_len
                or h.k.shape[1] > self._cache.k.shape[2]
                or self.pool.blocks_for(total) > self.pool.total_blocks
            ):
                self._handoff_queue.popleft()
                self._enqueue_ts.pop(h.request_id, None)
                completed.append(
                    CompletedRequest(
                        request_id=h.request_id,
                        tokens=[],
                        finish_reason=FINISH_ERROR,
                        error=(
                            f"handoff of {plen}+{h.max_new_tokens} "
                            "tokens exceeds replica capacity "
                            f"(max_len {self.max_len}, cache "
                            f"{self._cache.k.shape[2]}, "
                            f"{self.pool.total_blocks} blocks)"
                        ),
                    )
                )
                self._failed_total += 1
                continue
            lane = self.pool.allocate(h.request_id, plen)
            if lane is None:
                break  # no lane / no blocks: stays queued
            self._handoff_queue.popleft()
            self._cache = self._install_fn(
                self._cache,
                torch.as_tensor(h.k).to(self._device, self._cache.k.dtype),
                torch.as_tensor(h.v).to(self._device, self._cache.v.dtype),
                lane,
            )
            req = ServeRequest(
                request_id=h.request_id,
                prompt=list(h.prompt),
                max_new_tokens=h.max_new_tokens,
                temperature=h.temperature,
                trace=dict(h.trace or {}),
            )
            seq = _Seq(req, lane, now)
            seq.prefilled = plen
            seq.phase = PHASE_DECODE
            seq.generated = [int(h.first_token)]
            # The first token already exists (sampled on the prefill
            # replica): TPOT intervals start at import, and the
            # prefill-side TTFT decomposition rides through to the
            # completion report.
            seq.first_token_ts = now
            seq.last_token_ts = now
            seq.prefill_done_ts = now
            seq.imported_phases = dict(h.phases or {})
            seq.imported_ttft_s = h.ttft_s
            seq.import_wait_s = max(
                now - self._enqueue_ts.pop(h.request_id, now), 0.0
            )
            self._by_lane[lane] = seq
            self._handoffs_imported += 1
            self._tokens_generated += 1
            self._handoff_mod.note_outcome("imported")
            trace_id = req.trace.get("trace_id", "")
            obs.event(
                "serve.handoff_import",
                request_id=h.request_id,
                lane=lane,
                prompt_len=plen,
                **({"trace_id": trace_id} if trace_id else {}),
            )

    def _export_tick(self, now: float) -> List[CompletedRequest]:
        """Prefill-role counterpart of the decode tick: sequences
        whose prompt just finished (phase flipped to DECODE at the
        first-token sample) leave the batch as either a finished
        request (max_new_tokens == 1, or the first token was EOS) or
        a KV handoff bound for a decode replica."""
        completed: List[CompletedRequest] = []
        for seq in list(self._by_lane.values()):
            if seq.phase != PHASE_DECODE:
                continue
            if self._finished(seq):
                completed.append(self._retire(seq, now))
                continue
            payload = self._handoff_mod.export_handoff(
                self._cache,
                seq.lane,
                len(seq.req.prompt),
                self.pool.block_size,
                seq.req,
                seq.generated[0],
                ttft_s=round(seq.first_token_ts - seq.admit_ts, 6),
                phases={
                    "dispatch": round(seq.dispatch_wait_s, 6),
                    "prefill": round(
                        seq.prefill_done_ts - seq.admit_ts, 6
                    ),
                    "first_decode": round(
                        seq.first_token_ts - seq.prefill_done_ts, 6
                    ),
                },
            )
            self.pool.release(seq.req.request_id)
            self._by_lane.pop(seq.lane, None)
            self._handoffs_exported += 1
            completed.append(
                CompletedRequest(
                    request_id=seq.req.request_id,
                    tokens=[],
                    finish_reason=FINISH_HANDOFF,
                    ttft_s=payload.ttft_s,
                    wall_s=round(now - seq.admit_ts, 6),
                    phases=dict(payload.phases),
                    handoff=payload,
                )
            )
            trace_id = seq.req.trace.get("trace_id", "")
            obs.event(
                "serve.handoff_export",
                request_id=seq.req.request_id,
                prompt_len=len(seq.req.prompt),
                **({"trace_id": trace_id} if trace_id else {}),
            )
        return completed

    def _prefill_tick(self, now: float) -> None:
        """Advance PREFILL sequences by bounded chunks. Ragged final
        chunks PAD up to prefill_chunk (one compiled shape): padded
        positions write garbage the next chunk or decode step
        overwrites before any causal mask can expose it, and the
        first token samples from the last REAL position's logits."""
        import torch

        budget = self.prefill_budget
        for seq in list(self._by_lane.values()):
            if seq.phase != PHASE_PREFILL or budget <= 0:
                continue
            prompt = seq.req.prompt
            while budget > 0 and seq.prefilled < len(prompt):
                c = min(
                    self.prefill_chunk, len(prompt) - seq.prefilled
                )
                chunk = np.zeros((1, self.prefill_chunk), np.int64)
                chunk[0, :c] = prompt[
                    seq.prefilled:seq.prefilled + c
                ]
                logits, self._cache = self._prefill_fn(
                    self.params,
                    self._cache,
                    torch.as_tensor(chunk, device=self._device),
                    seq.lane,
                    seq.prefilled,
                )
                budget -= c
                seq.prefilled += c
                _TOKENS_TOTAL.inc(c, kind="prefill")
                if seq.prefilled >= len(prompt):
                    # Prefill -> decode handoff: sample the first
                    # token host-side from the last real position
                    # (one boundary transfer per request, outside
                    # the steady decode loop). The prefill phase ends
                    # here; the logits materialization + sample is
                    # the first_decode slice of TTFT.
                    seq.prefill_done_ts = self.clock()
                    row = logits[0, c - 1].cpu().numpy()
                    seq.last_logits = row
                    tok = self._sample_host(seq.req, row)
                    # Clock at the sample moment, not step start:
                    # TTFT must include the prefill compute it just
                    # paid.
                    self._append_token(seq, int(tok), self.clock())
                    seq.phase = PHASE_DECODE

    @staticmethod
    def _sample_host(req: ServeRequest, logits: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        # Deterministic per request id ACROSS PROCESSES, so a
        # requeued sampled request redraws the same first token on
        # any replica — a stable digest, never Python's hash()
        # (salted per process by PYTHONHASHSEED).
        import hashlib

        digest = hashlib.sha256(
            b"serve-first:" + req.request_id.encode()
        ).digest()
        seed = int.from_bytes(digest[:4], "big")
        rng = np.random.default_rng(seed)
        z = logits.astype(np.float64) / max(req.temperature, 1e-6)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def _append_token(self, seq: _Seq, tok: int, now: float) -> None:
        seq.generated.append(tok)
        self._tokens_generated += 1
        if seq.first_token_ts == 0.0:
            seq.first_token_ts = now
            ttft = now - seq.admit_ts
            self._ttft_recent.append(ttft)
            _TTFT_SECONDS.observe(ttft)
        seq.last_token_ts = now

    def _decode_lanes(self) -> List[_Seq]:
        return [
            s for s in self._by_lane.values()
            if s.phase == PHASE_DECODE
        ]

    def _decode_tick(self, now: float) -> List[CompletedRequest]:
        import torch

        completed: List[CompletedRequest] = []
        # Retire sequences that already hit their budget (the first
        # generated token comes from prefill, so a max_new_tokens=1
        # request finishes without ever entering the ragged step).
        for seq in self._decode_lanes():
            if self._finished(seq):
                completed.append(self._retire(seq, now))
        active = self._decode_lanes()
        if not active:
            return completed
        # Fund this step's cache writes BEFORE dispatch: the step
        # writes each lane's slot at position length-1, so the
        # sequence must own blocks covering ``length`` positions.
        # Growth the pool cannot fund preempts the youngest resident
        # sequence back to the queue (recompute preemption) and
        # retries; a sequence can preempt itself when it IS the
        # youngest.
        for seq in active:
            if self._by_lane.get(seq.lane) is not seq:
                continue  # already preempted as someone's victim
            while not self.pool.extend(
                seq.req.request_id, seq.length
            ):
                victim = self._preempt_youngest()
                if victim is None or victim == seq.req.request_id:
                    break
        active = [
            s for s in active if self._by_lane.get(s.lane) is s
        ]
        if not active:
            return completed
        token = np.zeros(self.lanes, np.int64)
        pos = np.zeros(self.lanes, np.int64)
        temps = np.zeros(self.lanes, np.float32)
        # Only DECODING lanes may write their cache slot: an idle
        # lane (or one mid-prefill) rides the batch with pos=0 and
        # must not clobber its own position 0.
        mask = np.zeros(self.lanes, np.bool_)
        for seq in active:
            token[seq.lane] = seq.generated[-1]
            # The position this step WRITES: the new token's slot.
            pos[seq.lane] = seq.length - 1
            temps[seq.lane] = seq.req.temperature
            mask[seq.lane] = True
        dev = self._device
        toks_dev, self._cache = self._decode_fn(
            self.params,
            self._cache,
            torch.as_tensor(token, device=dev),
            torch.as_tensor(pos, device=dev),
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(mask, device=dev),
        )
        # The steady decode loop's single device-to-host copy.
        toks = toks_dev.cpu().numpy()
        now = self.clock()
        _TOKENS_TOTAL.inc(len(active), kind="decode")
        for seq in active:
            self._append_token(seq, int(toks[seq.lane]), now)
            if self._finished(seq):
                completed.append(self._retire(seq, now))
        return completed

    def _finished(self, seq: _Seq) -> bool:
        if len(seq.generated) >= seq.req.max_new_tokens:
            return True
        return (
            self.eos_id is not None
            and bool(seq.generated)
            and seq.generated[-1] == self.eos_id
        )

    def _retire(self, seq: _Seq, now: float) -> CompletedRequest:
        self.pool.release(seq.req.request_id)
        self._by_lane.pop(seq.lane, None)
        self._completed_total += 1
        n = len(seq.generated)
        tpot = (
            (seq.last_token_ts - seq.first_token_ts) / (n - 1)
            if n > 1
            else 0.0
        )
        self._tpot_recent.append(tpot)
        _TPOT_SECONDS.observe(tpot)
        reason = (
            FINISH_EOS
            if (
                self.eos_id is not None
                and seq.generated
                and seq.generated[-1] == self.eos_id
            )
            else FINISH_LENGTH
        )
        prefill_done = seq.prefill_done_ts or seq.first_token_ts
        if seq.imported_phases is not None:
            # Handoff-imported: the prefill replica's decomposition
            # (dispatch/prefill/first_decode) rides through; this
            # replica contributes its local import wait ("handoff")
            # and the decode span. TTFT is the prefill replica's —
            # the first token existed before the handoff.
            phases = {
                **seq.imported_phases,
                "handoff": round(seq.import_wait_s, 6),
                "decode": round(
                    seq.last_token_ts - seq.first_token_ts, 6
                ),
            }
            ttft = seq.imported_ttft_s
        else:
            phases = {
                "dispatch": round(seq.dispatch_wait_s, 6),
                "prefill": round(prefill_done - seq.admit_ts, 6),
                "first_decode": round(
                    seq.first_token_ts - prefill_done, 6
                ),
                "decode": round(
                    seq.last_token_ts - seq.first_token_ts, 6
                ),
            }
            ttft = seq.first_token_ts - seq.admit_ts
        return CompletedRequest(
            request_id=seq.req.request_id,
            tokens=list(seq.generated),
            finish_reason=reason,
            ttft_s=round(ttft, 6),
            tpot_s=round(tpot, 6),
            wall_s=round(now - seq.admit_ts, 6),
            phases=phases,
        )

    def _preempt_youngest(self) -> Optional[str]:
        victim_id = self.pool.youngest()
        if victim_id is None:
            return None
        lane = self.pool.lane_of(victim_id)
        seq = self._by_lane.get(lane) if lane is not None else None
        self.pool.release(victim_id)
        if seq is not None:
            self._by_lane.pop(seq.lane, None)
            # Recompute preemption: back to the FRONT of the queue,
            # redoing prefill from the prompt (greedy decode redoes
            # to the identical tokens). Re-stamp the local-queue
            # entry: the re-admission wait is a fresh dispatch phase,
            # matching the recomputed TTFT.
            self._queue.appendleft(seq.req)
            self._enqueue_ts[victim_id] = self.clock()
            self._preempted_total += 1
            _PREEMPTIONS_TOTAL.inc()
            trace_id = seq.req.trace.get("trace_id", "")
            obs.event(
                "serve.preempt",
                request_id=victim_id,
                generated=len(seq.generated),
                **({"trace_id": trace_id} if trace_id else {}),
            )
        return victim_id

    # -- drain / stats ------------------------------------------------------

    def drain(self) -> List[ServeRequest]:
        """Stop serving: release every resident sequence and return
        every unfinished request (queued + resident) for the caller to
        requeue elsewhere. The scheduler stays usable afterward."""
        out: List[ServeRequest] = []
        for seq in list(self._by_lane.values()):
            self.pool.release(seq.req.request_id)
            out.append(seq.req)
        self._by_lane.clear()
        out.extend(self._queue)
        self._queue.clear()
        # Queued handoff imports requeue as their raw requests (the
        # KV stays behind with this incarnation; the router's
        # re-prefill path recomputes it — exact for greedy).
        for h in self._handoff_queue:
            out.append(
                ServeRequest(
                    request_id=h.request_id,
                    prompt=list(h.prompt),
                    max_new_tokens=h.max_new_tokens,
                    temperature=h.temperature,
                    trace=dict(h.trace or {}),
                )
            )
        self._handoff_queue.clear()
        self._enqueue_ts.clear()
        _REPLICA_QUEUE.set(0)
        _ACTIVE_SEQS.set(0)
        return out

    @staticmethod
    def _pct(samples: deque, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) via the one shared
        rank formula (obs/timeseries) — serving percentiles must
        agree with fleet/health percentiles on the same samples."""
        from dlrover_tpu_torch.obs.timeseries import _percentile

        return _percentile(sorted(samples), q)

    def stats(self) -> dict:
        """The replica's telemetry snapshot (ServeStatsReport payload
        + obs_report --serving rows)."""
        return {
            "role": self.role,
            "steps": self._steps,
            "queue_depth": len(self._queue),
            "handoff_queue_depth": len(self._handoff_queue),
            "active": len(self._by_lane),
            "completed_total": self._completed_total,
            "failed_total": self._failed_total,
            "preempted_total": self._preempted_total,
            "handoffs_exported": self._handoffs_exported,
            "handoffs_imported": self._handoffs_imported,
            "tokens_generated": self._tokens_generated,
            "kv": self.pool.snapshot(),
            "ttft_p50_s": round(self._pct(self._ttft_recent, 50), 6),
            "ttft_p99_s": round(self._pct(self._ttft_recent, 99), 6),
            "tpot_p50_s": round(self._pct(self._tpot_recent, 50), 6),
            "tpot_p99_s": round(self._pct(self._tpot_recent, 99), 6),
        }
