"""KV-block handoff between prefill and decode replicas.

The disaggregation seam (DistServe, OSDI '24 / Splitwise, ISCA '24):
a PREFILL replica runs only lane-chunk prefill and samples the first
token; this module serializes the finished sequence's KV blocks plus
its sampling state off the prefill replica's dense multi-lane cache,
and installs them into a DECODE replica's cache at a freshly
allocated lane — so decode ticks are never preempted by a prompt
storm, and the handed-off sequence's greedy continuation is bitwise
the tokens colocated ``generate.generate`` would produce (the same
prefill program wrote the same KV; the install is a value-preserving
``dynamic_update_slice``; the ragged decode step then sees an
identical cache prefix).

Payloads are **block-granular**: the exported arrays pad the prompt
length up to the exporter's KV block multiple, so one compiled
install program serves every prompt within the same block count
(bounded compile buckets, like the scheduler's chunk-padded prefill).
The padded tail rows carry garbage the decode steps overwrite before
any causal mask can expose them — the same argument that makes the
chunk-padded prefill exact.

On the wire the payload rides the existing complete/pull RPC seam
(``ServeCompletedReport.handoff`` up to the master,
``ServeWorkItem.handoff`` down to a decode replica) as a msgpack-safe
dict: raw little-endian bytes + dtype + shape, no pickle.

In this port the payload's ``k``/``v`` are CPU tensors (the export is
one device-to-host copy). A bf16 cache travels as its raw 16-bit words
under the dtype name ``"bfloat16"``: the bytes and the name the JAX
package writes through ``ml_dtypes``, so a payload packed by either
package unpacks bitwise in the other. Unpacking rebuilds bf16 by a bit
cast of those words to ``torch.bfloat16`` and needs no ``ml_dtypes``.
The install (:func:`make_install_fn`) is an in-place copy on the
device into one lane of the decode replica's cache.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

from dlrover_tpu_torch import obs

# The master imports this module and never needs torch.
if TYPE_CHECKING:
    import torch

_HANDOFF_TOTAL = obs.counter(
    "dlrover_serve_handoff_total",
    "Prefill->decode KV handoffs by lifecycle outcome (exported = "
    "prefill replica produced one, staged = master accepted it, "
    "dispatched = a decode replica pulled it, imported = installed "
    "into a decode pool, overflow = master budget exceeded and the "
    "request fell back to recompute, oversize = a payload bigger "
    "than the whole budget failed terminally, reprefill = a decode-replica "
    "death sent the request back to the prompt stage)",
    ("outcome",),
)
_HANDOFF_BYTES = obs.gauge(
    "dlrover_serve_handoff_bytes",
    "Bytes of KV handoff payloads currently staged at the master "
    "awaiting a decode replica's pull",
)
_HANDOFF_QUEUE = obs.gauge(
    "dlrover_serve_handoff_queue_depth",
    "Completed-prefill requests staged at the master awaiting "
    "dispatch to a decode replica",
)
_HANDOFF_SECONDS = obs.histogram(
    "dlrover_serve_handoff_seconds",
    "Time a completed prefill spent staged at the master before a "
    "decode replica pulled it (the handoff hop of the request trace)",
    buckets=(0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)


def note_outcome(outcome: str, n: int = 1) -> None:
    _HANDOFF_TOTAL.inc(n, outcome=outcome)


def publish_staging(depth: int, total_bytes: int) -> None:
    _HANDOFF_QUEUE.set(depth)
    _HANDOFF_BYTES.set(total_bytes)


def observe_staged_wait(seconds: float) -> None:
    _HANDOFF_SECONDS.observe(max(seconds, 0.0))


@dataclasses.dataclass
class HandoffPayload:
    """One completed prefill, ready to decode elsewhere.

    ``k``/``v`` are CPU tensors of shape ``[L, P_pad, H_kv, D]``
    (block-granular: ``P_pad`` is the prompt length rounded up to the
    exporter's block size). ``first_token`` is the token the prefill
    replica sampled from the last real prompt position — it has NOT
    been written to the cache (the first decode step writes it at
    position ``prompt_len``, exactly as the colocated scheduler
    would). ``phases``/``ttft_s`` are the prefill replica's TTFT
    decomposition, carried through so the completing decode replica
    reports end-to-end phases."""

    request_id: str
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    first_token: int
    k: torch.Tensor
    v: torch.Tensor
    ttft_s: float = 0.0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def nbytes(self) -> int:
        return int(self.k.nbytes) + int(self.v.nbytes)


def export_handoff(
    cache,
    lane: int,
    prompt_len: int,
    block_size: int,
    req,
    first_token: int,
    ttft_s: float = 0.0,
    phases: Optional[Dict[str, float]] = None,
) -> HandoffPayload:
    """Slice lane ``lane``'s prompt KV off the shared multi-lane
    cache (``cache.k``/``v`` are ``[L, lanes, T, H_kv, D]``) into a
    host payload, block-granular. This is the one deliberate host
    transfer of the prefill replica's export path — the prefill
    role's product IS host-shippable KV."""
    pad = -(-prompt_len // block_size) * block_size
    pad = min(pad, cache.k.shape[2])
    k = cache.k[:, lane, :pad].cpu().contiguous()
    v = cache.v[:, lane, :pad].cpu().contiguous()
    note_outcome("exported")
    return HandoffPayload(
        request_id=req.request_id,
        prompt=list(req.prompt),
        max_new_tokens=req.max_new_tokens,
        temperature=req.temperature,
        first_token=int(first_token),
        k=k,
        v=v,
        ttft_s=ttft_s,
        phases=dict(phases or {}),
        trace=dict(req.trace or {}),
    )


# -- wire form --------------------------------------------------------------


# bf16 on the wire: its raw 16-bit words under the dtype's own name.
_BF16 = "bfloat16"


def _pack_array(a) -> dict:
    """A tensor or a numpy array -> its wire form."""
    import torch

    t = torch.as_tensor(a).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, t = _BF16, t.view(torch.int16)
    else:
        name = str(t.dtype).removeprefix("torch.")
    return {
        "dtype": name,
        "shape": list(t.shape),
        "data": t.numpy().tobytes(),
    }


def _unpack_array(d: dict) -> "torch.Tensor":
    import torch

    if d["dtype"] == _BF16:
        words = np.frombuffer(d["data"], dtype=np.int16)
        return torch.from_numpy(words.copy()).view(
            torch.bfloat16
        ).reshape(d["shape"])
    a = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
    return torch.from_numpy(a.copy()).reshape(d["shape"])


def pack(payload: HandoffPayload) -> dict:
    """Msgpack-safe wire dict (raw bytes, never pickle)."""
    return {
        "request_id": payload.request_id,
        "prompt": list(payload.prompt),
        "max_new_tokens": int(payload.max_new_tokens),
        "temperature": float(payload.temperature),
        "first_token": int(payload.first_token),
        "k": _pack_array(payload.k),
        "v": _pack_array(payload.v),
        "ttft_s": float(payload.ttft_s),
        "phases": {
            str(k): float(v) for k, v in payload.phases.items()
        },
        "trace": {
            str(k): str(v) for k, v in (payload.trace or {}).items()
        },
    }


def unpack(d: dict) -> HandoffPayload:
    return HandoffPayload(
        request_id=str(d.get("request_id", "")),
        prompt=[int(t) for t in d.get("prompt", [])],
        max_new_tokens=int(d.get("max_new_tokens", 16)),
        temperature=float(d.get("temperature", 0.0)),
        first_token=int(d.get("first_token", 0)),
        k=_unpack_array(d["k"]),
        v=_unpack_array(d["v"]),
        ttft_s=float(d.get("ttft_s", 0.0)),
        phases={
            str(k): float(v)
            for k, v in (d.get("phases") or {}).items()
        },
        trace={
            str(k): str(v)
            for k, v in (d.get("trace") or {}).items()
        },
    )


def payload_nbytes(wire: dict) -> int:
    """Size accounting for a packed payload (the master's staging
    budget is judged on wire bytes — what it actually holds)."""
    n = 0
    for key in ("k", "v"):
        arr = wire.get(key) or {}
        data = arr.get("data", b"")
        n += len(data)
    return n


def make_install_fn():
    """The decode replica's install: copy a payload's ``[L, P_pad, H_kv,
    D]`` KV into lane ``lane`` of the shared cache at positions ``[0,
    P_pad)``, in place on the cache's device; every other lane is
    untouched. The payload arrives as tensors already on that device
    and of the cache's dtype."""

    def install(cache, k_chunk, v_chunk, lane):
        p = k_chunk.shape[1]
        cache.k[:, lane, :p].copy_(k_chunk)
        cache.v[:, lane, :p].copy_(v_chunk)
        return cache

    return install
