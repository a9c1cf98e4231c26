"""Control-plane RPC transport.

Same 2-RPC shape as the reference master service
(proto/elastic_training.proto:28-31: ``report`` fire-and-forget-ish and
``get`` request/response), but built with gRPC *generic handlers* and the
typed msgpack schema from ``messages.py`` — no protoc codegen, no pickle.

The server dispatches on the request dataclass type; handlers are
registered per message class.
"""

from __future__ import annotations

import socket
import threading
from concurrent import futures
from typing import Any, Callable, Dict, Optional, Type

import grpc

from dlrover_tpu_torch.common import messages
from dlrover_tpu_torch.common.constants import GrpcEnv
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs import tracer as _trace

logger = get_logger("comm")

SERVICE_NAME = "dlrover_tpu_torch.Master"
_GET = f"/{SERVICE_NAME}/get"
_REPORT = f"/{SERVICE_NAME}/report"

_GRPC_OPTIONS = [
    ("grpc.max_send_message_length", GrpcEnv.MAX_MESSAGE_LENGTH),
    ("grpc.max_receive_message_length", GrpcEnv.MAX_MESSAGE_LENGTH),
    # Reconnect fast after a master bounce: gRPC's default connect
    # backoff grows toward 120s, which would leave a client failing
    # instantly ("failed to connect to all addresses") long after the
    # replacement master is up — the agent's outage budget would burn
    # on channel backoff, not on the actual outage.
    ("grpc.initial_reconnect_backoff_ms", 100),
    ("grpc.min_reconnect_backoff_ms", 100),
    ("grpc.max_reconnect_backoff_ms", 2000),
]


def _chaos_injector():
    """Env-gated chaos injector (common/chaos.py); None when off."""
    from dlrover_tpu_torch.common import chaos

    return chaos.get_injector()


def _chaos_server_hook(request) -> None:
    inj = _chaos_injector()
    if inj is not None:
        inj.on_server_request(request)


class _TracedPayload:
    """Client-side carrier pairing a request with its envelope fields
    (``_tc`` trace context, ``_job`` routing id) for the gRPC
    serializer — per-call state the stub's fixed
    ``request_serializer`` could not otherwise see."""

    __slots__ = ("msg", "trace", "job_id")

    def __init__(
        self,
        msg: Any,
        trace: Optional[Dict[str, str]],
        job_id: str = "",
    ):
        self.msg = msg
        self.trace = trace
        self.job_id = job_id


def _serialize_request(obj: Any) -> bytes:
    if isinstance(obj, _TracedPayload):
        return messages.serialize(
            obj.msg, trace=obj.trace, job_id=obj.job_id
        )
    return messages.serialize(obj)


def find_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class RpcDispatcher:
    """Routes decoded request messages to per-type handler callables.

    ``job_id`` (the envelope's ``_job`` field) is accepted — and
    ignored — by the base dispatcher: a single-job master serves
    every caller identically, so a job-tagged client talking to one
    keeps working. :class:`JobRoutingDispatcher` overrides the
    handle methods to route on it."""

    def __init__(self):
        self._get_handlers: Dict[type, Callable[[Any], Any]] = {}
        self._report_handlers: Dict[type, Callable[[Any], Any]] = {}

    def register_get(self, msg_cls: type, fn: Callable[[Any], Any]) -> None:
        self._get_handlers[msg_cls] = fn

    def register_report(self, msg_cls: type, fn: Callable[[Any], Any]) -> None:
        self._report_handlers[msg_cls] = fn

    def has_get(self, msg_cls: type) -> bool:
        return msg_cls in self._get_handlers

    def has_report(self, msg_cls: type) -> bool:
        return msg_cls in self._report_handlers

    def handle_get(self, request: Any, job_id: str = "") -> Any:
        fn = self._get_handlers.get(type(request))
        if fn is None:
            raise KeyError(f"no get handler for {type(request).__name__}")
        return fn(request)

    def handle_report(self, request: Any, job_id: str = "") -> Any:
        fn = self._report_handlers.get(type(request))
        if fn is None:
            raise KeyError(f"no report handler for {type(request).__name__}")
        return fn(request)


class JobRoutingDispatcher(RpcDispatcher):
    """Multi-job dispatcher: the pool master's one RPC server hosting
    many per-job servicers.

    Requests whose envelope carries a ``_job`` id route to that job's
    registered :class:`RpcDispatcher` (its own node table, rendezvous,
    shard ledger, kv store); pool-level messages — and any message
    type a job's servicer does not handle, e.g. TraceQueryRequest
    served by the shared trace store — fall through to the handlers
    registered directly on this dispatcher. An unknown job id raises,
    so a worker of a retired job fails loudly instead of silently
    mutating another job's state."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._jobs: Dict[str, RpcDispatcher] = {}

    def register_job(
        self, job_id: str, dispatcher: RpcDispatcher
    ) -> None:
        if not job_id:
            raise ValueError("job_id must be non-empty")
        with self._lock:
            self._jobs[job_id] = dispatcher

    def remove_job(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)

    def job_ids(self) -> list:
        with self._lock:
            return sorted(self._jobs)

    def _job_dispatcher(self, job_id: str) -> RpcDispatcher:
        with self._lock:
            d = self._jobs.get(job_id)
        if d is None:
            raise KeyError(
                f"unknown job {job_id!r} (known: {self.job_ids()})"
            )
        return d

    def handle_get(self, request: Any, job_id: str = "") -> Any:
        if job_id:
            d = self._job_dispatcher(job_id)
            if d.has_get(type(request)):
                return d.handle_get(request)
        return super().handle_get(request)

    def handle_report(self, request: Any, job_id: str = "") -> Any:
        if job_id:
            d = self._job_dispatcher(job_id)
            if d.has_report(type(request)):
                return d.handle_report(request)
        return super().handle_report(request)


class _GenericHandler(grpc.GenericRpcHandler):
    def __init__(self, dispatcher: RpcDispatcher):
        self._dispatcher = dispatcher

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method == _GET:
            return grpc.unary_unary_rpc_method_handler(
                self._do_get,
                request_deserializer=messages.deserialize_envelope,
                response_serializer=messages.serialize,
            )
        if method == _REPORT:
            return grpc.unary_unary_rpc_method_handler(
                self._do_report,
                request_deserializer=messages.deserialize_envelope,
                response_serializer=messages.serialize,
            )
        return None

    def _dispatch(self, handle, payload, what: str):
        request, trace, job_id = payload
        _chaos_server_hook(request)
        # Re-activate the caller's trace context for the handler: the
        # spans/events the master emits while serving this RPC land in
        # the caller's causal timeline. Malformed carriers extract to
        # None and cost nothing.
        ctx = _trace.extract(trace) if trace else None
        try:
            if ctx is not None:
                with _trace.activate(ctx):
                    result = handle(request, job_id)
            else:
                result = handle(request, job_id)
            return messages.BaseResponse(success=True, data=result)
        except Exception as e:  # noqa: BLE001 - must not kill the server
            logger.exception(
                "%s(%s) failed", what, type(request).__name__
            )
            return messages.BaseResponse(success=False, message=str(e))

    def _do_get(self, payload, context):
        return self._dispatch(
            self._dispatcher.handle_get, payload, "get"
        )

    def _do_report(self, payload, context):
        return self._dispatch(
            self._dispatcher.handle_report, payload, "report"
        )


class RpcServer:
    """gRPC server hosting the master service."""

    def __init__(
        self,
        dispatcher: RpcDispatcher,
        port: int = 0,
        max_workers: int = 16,
    ):
        self.dispatcher = dispatcher
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=_GRPC_OPTIONS,
        )
        self._server.add_generic_rpc_handlers([_GenericHandler(dispatcher)])
        self.port = self._server.add_insecure_port(f"0.0.0.0:{port}")

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> None:
        self._server.start()
        logger.info("master RPC server listening on port %d", self.port)

    def stop(self, grace: Optional[float] = None) -> None:
        self._server.stop(grace)


class RpcError(RuntimeError):
    pass


class RpcClient:
    """Client to the master service; thread-safe, lazily connected.

    ``wait_for_ready`` is the per-client default for queue-until-
    connected RPC semantics (overridable per call): True suits
    clients of the (warm-restartable) master, whose supervisor wants
    calls to wait out a channel in TRANSIENT_FAILURE; the default
    False (fail fast) suits clients of peers that are REPLACED rather
    than restarted in place (PS hosts, ingest workers) — their
    callers own a refetch/retry loop and need dead-peer calls to
    fail instantly, not block a step for the full RPC timeout."""

    def __init__(
        self,
        addr: str,
        timeout: float = 30.0,
        wait_for_ready: bool = False,
        job_id: str = "",
    ):
        self.addr = addr
        self.timeout = timeout
        self.wait_for_ready = wait_for_ready
        # Stamped on every request's envelope (the ``_job`` field) so
        # a pool master routes this client's calls to its job's
        # servicer. "" = single-job client (envelope field omitted).
        self.job_id = job_id
        self._lock = threading.Lock()
        self._channel: Optional[grpc.Channel] = None
        self._get: Optional[grpc.UnaryUnaryMultiCallable] = None
        self._report: Optional[grpc.UnaryUnaryMultiCallable] = None

    def _connect(self):
        with self._lock:
            if self._channel is not None:
                return
            self._channel = grpc.insecure_channel(
                self.addr, options=_GRPC_OPTIONS
            )
            self._get = self._channel.unary_unary(
                _GET,
                request_serializer=_serialize_request,
                response_deserializer=messages.deserialize,
            )
            self._report = self._channel.unary_unary(
                _REPORT,
                request_serializer=_serialize_request,
                response_deserializer=messages.deserialize,
            )

    def _call(
        self,
        stub_name: str,
        request: Any,
        timeout: Optional[float],
        wait_for_ready: Optional[bool] = None,
    ):
        if wait_for_ready is None:
            wait_for_ready = self.wait_for_ready
        inj = _chaos_injector()
        if inj is not None:
            # May sleep (added latency) or raise ChaosDropError /
            # ChaosPartitionError, which the reconnect supervisor
            # classifies as transient — same path as a dead master.
            inj.before_client_call(stub_name, request)
        self._connect()
        stub = self._get if stub_name == "get" else self._report
        # Propagate the active trace context (if any) as the request
        # envelope's _tc field, and the client's job id as _job.
        # inject() is a dict lookup + None when no trace is active —
        # the single-job, no-trace common case stays allocation-free.
        carrier = _trace.inject()
        payload = (
            _TracedPayload(request, carrier, self.job_id)
            if carrier is not None or self.job_id
            else request
        )
        # wait_for_ready=True queues the RPC until the channel
        # (re)connects instead of failing fast from TRANSIENT_FAILURE
        # — without it a channel that ever saw the master down keeps
        # failing instantly long after the master is back, burning
        # the reconnect budget on channel state instead of the actual
        # outage. Best-effort telemetry passes False: it must DROP
        # fast during an outage, not block a reporting loop.
        response = stub(
            payload,
            timeout=timeout or self.timeout,
            wait_for_ready=wait_for_ready,
        )
        if not isinstance(response, messages.BaseResponse):
            raise RpcError(f"bad response type {type(response).__name__}")
        if not response.success:
            raise RpcError(response.message)
        return response.data

    def get(
        self,
        request: Any,
        timeout: Optional[float] = None,
        wait_for_ready: Optional[bool] = None,
    ) -> Any:
        return self._call("get", request, timeout, wait_for_ready)

    def report(
        self,
        request: Any,
        timeout: Optional[float] = None,
        wait_for_ready: Optional[bool] = None,
    ) -> Any:
        return self._call("report", request, timeout, wait_for_ready)

    def close(self) -> None:
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None
