"""Serving request types (the framework-free part of
``dlrover_tpu/serving/scheduler.py``).

The master's :class:`~dlrover_tpu_torch.serving.router.ServingRouter`
needs the replica roles, the finish reasons, :class:`ServeRequest` and
:class:`CompletedRequest`; they are copied here with their metrics. The
continuous-batching decode engine (``_Seq`` and
``ContinuousBatchingScheduler``: the jitted prefill and ragged decode
programs over ``models/generate``) runs on the device and is ported with
the decode and serving slice.
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
