"""Cross-layer observability substrate: metrics + event tracing.

Every layer of the stack (master node management, rendezvous,
auto-scaling, flash checkpoint, elastic trainer) records what it is
doing through this package, so "what is the job doing right now" and
"where did the recovery time go" are answerable from one place:

* :mod:`dlrover_tpu_torch.obs.metrics` — a process-local registry of
  counters/gauges/histograms with labels, rendered in Prometheus text
  exposition format by ``registry.render()`` (no ``prometheus_client``
  dependency — the whole package is stdlib-only by contract, enforced
  by tests/test_obs.py::test_no_prometheus_or_otel_imports).
* :mod:`dlrover_tpu_torch.obs.tracer` — lightweight events/spans with
  monotonic timestamps and process/role/rank tags, exported as JSON
  lines when ``DLROVER_TPU_TRACE_FILE`` is set. Disabled (the
  default) every hook is a None-check costing well under a
  microsecond, so instrumented hot paths stay hot.
* :mod:`dlrover_tpu_torch.obs.trace_store` — the master-side distributed-
  trace assembler: bounded per-trace span timelines (serving request
  hops with TTFT phase spans, remediation decision chains, rendezvous
  rounds) fed by the in-master planes and the snapshot event channel,
  queryable via the ``TraceQueryRequest`` RPC and
  ``obs_report --trace``.
* :mod:`dlrover_tpu_torch.obs.timeline` — folds an event stream into the
  canonical recovery breakdown ``failure-detect -> rendezvous ->
  restore -> first-step -> 90%-throughput`` that the chaos drills
  assert on.
* :mod:`dlrover_tpu_torch.obs.exposition` — a stdlib HTTP server giving the
  master a ``GET /metrics`` Prometheus endpoint.
* :mod:`dlrover_tpu_torch.obs.fleet` — the master-side
  :class:`FleetAggregator` merging per-host registry snapshots
  (shipped by agents over the control plane) into host-labeled series
  and cross-host aggregates, with TTL age-out for departed nodes.
* :mod:`dlrover_tpu_torch.obs.goodput` — exhaustive goodput/badput wall-time
  attribution (productive / compile / data_wait / checkpoint /
  recovery / idle_unknown) over the job's event stream.
* :mod:`dlrover_tpu_torch.obs.flight_recorder` — the always-on black box:
  a bounded in-memory ring (WARNING+ logs, last step/loss notes)
  plus faulthandler / excepthook / SIGUSR1 crash hooks that dump a
  JSON bundle with all-thread Python stacks to the per-run forensics
  dir on any crash or hang.
* :mod:`dlrover_tpu_torch.obs.postmortem` — folds a forensics dir (bundles,
  faulthandler stack dumps, traces) into the "last 60 seconds before
  failure" report ``tools/obs_report.py --postmortem`` prints.
* :mod:`dlrover_tpu_torch.obs.profiling` — perf observability for the hot
  path: per-step wall-time attribution (data_wait / h2d_stage /
  compile / dispatch / device_execute), recompile counters per jitted
  function,
  a live MFU gauge from XLA cost analysis, and the on-demand PROFILE
  capture protocol (master action -> agent request file -> trainer
  digest -> diagnostics history).
* :mod:`dlrover_tpu_torch.obs.beacon` — the collective-stall progress
  beacon: a fixed-size mmap'd progress stamp (step / microbatch /
  phase / monotonic ts) the trainer rewrites at every phase boundary,
  readable by other processes even when the trainer is wedged inside
  a C-level collective.
* :mod:`dlrover_tpu_torch.obs.stall` — the master-side
  :class:`StallCorrelator` over the fleet's shipped beacons: splits
  fleet-wide stalls from single-host laggards, emits the localized
  ``collective_stall`` verdict, mints ``stall.incident`` traces, and
  queues the coordinated all-host DIAGNOSE+PROFILE capture.
* :mod:`dlrover_tpu_torch.obs.timeseries` — the bounded in-memory
  time-series store (labeled series, ring retention with coarse
  downsampling, windowed mean/percentile/rate/robust-slope queries)
  the measurement plane records history into.
* :mod:`dlrover_tpu_torch.obs.health` — the detector engine over that
  history: throughput-degradation / goodput-SLO / data-starvation /
  recompile-storm / RSS-growth / straggler-persistence /
  heartbeat-gap verdicts with evidence windows, the composite
  ``dlrover_job_health_score``, auto-queued PROFILE/DIAGNOSE actions,
  and brain persistence — plus the per-tenant SLO error-budget engine
  with multi-window burn-rate alerting.
* :mod:`dlrover_tpu_torch.obs.capacity` — the pool capacity accounting
  plane: a per-slice state-interval ledger (idle / allocated /
  preempting / draining / restoring) producing per-tenant chip-second
  totals, productive chip-seconds from goodput joins, and
  goodput-per-chip — the substrate for capacity-aware autoscaling.

The functions re-exported here are the instrumentation surface the
rest of the codebase uses::

    from dlrover_tpu_torch import obs

    _RELAUNCHES = obs.counter("dlrover_node_relaunch_total", "...")
    _RELAUNCHES.inc(type="worker")
    obs.event("node.relaunch", node_id=3)
    with obs.span("ckpt.save"):
        ...
"""

from dlrover_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    get_registry,
    histogram,
)
from dlrover_tpu_torch.obs.tracer import (  # noqa: F401
    EventTracer,
    IdSource,
    TraceContext,
    activate,
    configure_tracer,
    current_context,
    disable_tracer,
    event,
    extract,
    get_tracer,
    inject,
    new_span_id,
    new_trace_context,
    new_trace_id,
    set_id_source,
    span,
    tracing_enabled,
)
from dlrover_tpu_torch.obs.trace_store import (  # noqa: F401
    TraceStore,
    render_trace,
    span_tree,
)
from dlrover_tpu_torch.obs.beacon import (  # noqa: F401
    ProgressBeacon,
    beacon_file,
    progress_key,
    read_beacon,
    stamp_age,
)
from dlrover_tpu_torch.obs.fleet import FleetAggregator  # noqa: F401
from dlrover_tpu_torch.obs.flight_recorder import (  # noqa: F401
    FlightRecorder,
    forensics_dir,
    get_flight_recorder,
    install_flight_recorder,
    recorder_note,
    uninstall_flight_recorder,
)
from dlrover_tpu_torch.obs.goodput import (  # noqa: F401
    GoodputAccountant,
    GoodputReport,
    attribute_goodput,
    render_goodput,
)
from dlrover_tpu_torch.obs.profiling import (  # noqa: F401
    CompileTracker,
    MfuMeter,
    StepPhaseProfiler,
)
from dlrover_tpu_torch.obs.timeseries import (  # noqa: F401
    TimeSeriesStore,
    WindowStats,
)

# Imported last: health.py and capacity.py instrument through
# `dlrover_tpu_torch.obs` itself (obs.counter/obs.gauge are bound above by
# the time this executes), mirroring how the master modules import
# the package.
from dlrover_tpu_torch.obs.health import (  # noqa: E402,F401
    HealthMonitor,
    HealthVerdict,
    SLOSpec,
    render_health,
    slos_from_env,
)
from dlrover_tpu_torch.obs.capacity import (  # noqa: E402,F401
    CapacityLedger,
    SliceInterval,
    render_capacity,
)
from dlrover_tpu_torch.obs.stall import (  # noqa: E402,F401
    StallCorrelator,
    render_stall,
)
