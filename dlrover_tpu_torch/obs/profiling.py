"""Performance observability: step phases, compile accounting, MFU.

The control plane can observe everything about a job *except* where
its time goes; this module closes that gap for the training hot path:

* :class:`StepPhaseProfiler` attributes every step's wall time into
  five exhaustive phases — ``data_wait`` (blocking on the input
  pipeline's host side), ``h2d_stage`` (the host->device staging
  slice of the input wait), ``compile`` (dispatches that traced +
  XLA-compiled), ``dispatch`` (host-side enqueue of an
  already-compiled step), and ``device_execute`` (the residual: the
  device working while the host runs ahead) — into
  ``dlrover_step_phase_seconds_total{phase}``.
  The clock is injectable, so attribution is testable hermetically.
* :class:`CompileTracker` counts (re)compilations per jitted function
  via its dispatch-cache size (``dlrover_compile_total{fn}`` /
  ``dlrover_compile_seconds_total{fn}``): a shape drift that silently
  retraces every step shows up as a counter slope, not a mystery.
* :class:`MfuMeter` turns XLA's own cost model
  (``jit(f).lower(*args).cost_analysis()`` — trace+lower only, never
  a second XLA compile) plus measured step time into a live
  ``dlrover_train_mfu`` gauge (and ``dlrover_train_flops_per_step``).
* The **PROFILE action** file protocol: the master pushes a
  ``profile`` heartbeat action (straggler auto-trigger or operator
  RPC), the agent drops a request file, the trainer's profiler picks
  it up between steps, captures an N-step phase breakdown (plus an
  optional ``torch.profiler`` trace), and writes a digest file the
  agent ships back over the existing ``DiagnosticsReport`` channel.

Everything here is stdlib-only except the lazily-imported
``torch.profiler`` trace (the FLOPs derivation raises until the
profiling item is ported), so the phase
accounting and the capture protocol stay hermetically testable.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs.beacon import ProgressBeacon, default_beacon
from dlrover_tpu_torch.obs.metrics import counter, gauge
from dlrover_tpu_torch.obs.tracer import event as obs_event

logger = get_logger("profiling")

# The exhaustive per-step wall-time phases, in attribution precedence.
# ``data_wait`` is host-side input wait (pulling/collating the next
# batch); ``h2d_stage`` is the host->device staging slice of that wait
# (the split makes a device-prefetch win attributable: a healthy
# device-resident pipeline drives BOTH toward zero, while a hidden H2D
# stall shows up as h2d_stage specifically).
PHASES = ("data_wait", "h2d_stage", "compile", "dispatch", "device_execute")

PROFILE_REQUEST_ENV = "DLROVER_TPU_PROFILE_REQUEST_FILE"
PROFILE_DIGEST_ENV = "DLROVER_TPU_PROFILE_DIGEST_FILE"
PROFILE_STEPS_ENV = "DLROVER_TPU_PROFILE_STEPS"
PROFILE_TRACE_DIR_ENV = "DLROVER_TPU_PROFILE_TRACE_DIR"
PEAK_TFLOPS_ENV = "DLROVER_TPU_PEAK_TFLOPS"
MFU_ENV = "DLROVER_TPU_MFU"

DEFAULT_PROFILE_STEPS = 20

_PHASE_SECONDS = counter(
    "dlrover_step_phase_seconds_total",
    "Training wall time attributed by step phase (data_wait / "
    "h2d_stage / compile / dispatch / device_execute); the five "
    "phases partition each step's wall time exactly — data_wait is "
    "host-side input wait, h2d_stage the host->device staging slice "
    "of it",
    ("phase",),
)
_COMPILE_TOTAL = counter(
    "dlrover_compile_total",
    "XLA (re)compilations observed per jitted function",
    ("fn",),
)
_COMPILE_SECONDS = counter(
    "dlrover_compile_seconds_total",
    "Wall seconds spent in dispatches that traced + compiled, per "
    "jitted function",
    ("fn",),
)
_MFU = gauge(
    "dlrover_train_mfu",
    "Live model FLOPs utilisation: cost-analysis FLOPs per step over "
    "measured step time, vs the chip's peak (windowed mean)",
)
_FLOPS_PER_STEP = gauge(
    "dlrover_train_flops_per_step",
    "FLOPs one optimizer step costs per XLA cost analysis",
)
_PROFILE_CAPTURES = counter(
    "dlrover_profile_captures_total",
    "On-demand PROFILE captures completed by this trainer",
)


def _job_scoped(name: str) -> str:
    job = os.getenv("DLROVER_TPU_JOB_NAME", "default")
    return f"/tmp/dlrover_tpu_{name}_{job}.json"


def profile_request_file() -> str:
    """Agent -> trainer: where a PROFILE request is dropped. Job-
    scoped (two jobs on one host must not trigger each other)."""
    return os.getenv(PROFILE_REQUEST_ENV, _job_scoped("profile_request"))


def profile_digest_file() -> str:
    """Trainer -> agent: where the capture digest lands."""
    return os.getenv(PROFILE_DIGEST_ENV, _job_scoped("profile_digest"))


_request_counter = [0]
_request_lock = threading.Lock()


def write_profile_request(
    steps: int = 0, trace_dir: str = "", path: Optional[str] = None
) -> str:
    """Drop a PROFILE request for the co-hosted trainer; returns the
    request id the digest will echo. Atomic (tmp+rename) so the
    trainer never reads a torn request."""
    with _request_lock:
        _request_counter[0] += 1
        seq = _request_counter[0]
    req_id = f"{os.getpid()}-{int(time.time() * 1000)}-{seq}"
    req = {
        "id": req_id,
        "steps": int(
            steps
            or os.getenv(PROFILE_STEPS_ENV, str(DEFAULT_PROFILE_STEPS))
        ),
        "trace_dir": trace_dir or os.getenv(PROFILE_TRACE_DIR_ENV, ""),
        "ts": time.time(),
    }
    path = path or profile_request_file()
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(req, f)
    os.replace(tmp, path)
    return req_id


def read_profile_digest(
    expect_id: Optional[str] = None, path: Optional[str] = None
) -> Optional[dict]:
    """The digest the trainer wrote, or None when absent / not yet the
    one answering ``expect_id``."""
    path = path or profile_digest_file()
    try:
        with open(path) as f:
            digest = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(digest, dict):
        return None
    if expect_id is not None and digest.get("id") != expect_id:
        return None
    return digest


# Dense bf16 tensor-core peak of the port's card (NVIDIA H100 SXM data
# sheet, 700 W), the figure chip_smoke.py holds kernels against.
H100_PEAK_BF16_TFLOPS = 989.0


def peak_flops_per_s() -> float:
    """The card's peak FLOP/s for the MFU denominator.

    ``DLROVER_TPU_PEAK_TFLOPS`` overrides (tests, other cards);
    otherwise the H100's bf16 peak. Never raises, and never queries
    the device: the agent and master call this without a CUDA
    context."""
    env = os.getenv(PEAK_TFLOPS_ENV, "")
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            logger.warning("unparseable %s=%r", PEAK_TFLOPS_ENV, env)
    return H100_PEAK_BF16_TFLOPS * 1e12


def step_flops(jfn, *args) -> Optional[float]:
    """FLOPs per call of a step function. The JAX package prices a
    jitted step with XLA's cost analysis; the port has no counterpart
    yet (a FLOP counter over the eager step arrives with the
    profiling item, ROADMAP queue 1 item 7)."""
    raise NotImplementedError(
        "step_flops needs a FLOP counter for eager PyTorch steps "
        "(ROADMAP queue 1 item 7, auto-acceleration and profiling)"
    )


class CompileTracker:
    """Detects which dispatches of a jitted callable (re)compiled.

    Primary signal: growth of the jit dispatch cache
    (``jfn._cache_size()``), which catches silent retraces from shape
    or dtype drift mid-run. Fallback (no cache API): only the first
    observed call counts as the compile.
    """

    def __init__(self, fn_name: str, jfn=None):
        self.fn_name = fn_name
        self._jfn = jfn
        self._last_cache_size: Optional[int] = None
        self._calls = 0
        self.compiles = 0

    def _cache_size(self) -> Optional[int]:
        probe = getattr(self._jfn, "_cache_size", None)
        if probe is None:
            return None
        try:
            return int(probe())
        except Exception:  # noqa: BLE001 — private API, best-effort
            return None

    def observe_call(self, dur_s: float) -> bool:
        """Record one dispatch lasting ``dur_s``; True when it
        (re)compiled."""
        self._calls += 1
        size = self._cache_size()
        if size is None:
            compiled = self._calls == 1
        else:
            compiled = (
                self._last_cache_size is None
                or size > self._last_cache_size
            )
            self._last_cache_size = size
        if compiled:
            self.compiles += 1
            _COMPILE_TOTAL.inc(fn=self.fn_name)
            _COMPILE_SECONDS.inc(max(dur_s, 0.0), fn=self.fn_name)
            obs_event(
                "trainer.compile",
                fn=self.fn_name,
                dur_s=round(dur_s, 4),
                total=self.compiles,
            )
            if self.compiles > 1:
                logger.warning(
                    "%s recompiled (compile #%d, %.2fs): check for "
                    "shape/dtype drift in the input pipeline",
                    self.fn_name, self.compiles, dur_s,
                )
        return compiled


class MfuMeter:
    """FLOPs/step + measured step seconds -> live MFU gauge.

    Step times feed a bounded window; the gauge is the windowed-mean
    utilisation, which absorbs the host-side pacing jitter of the
    zero-sync loop (individual samples are dispatch pacing; their
    mean is true step time — see dlrover_train_step_seconds)."""

    def __init__(
        self,
        peak_flops: Optional[float] = None,
        window: int = 32,
    ):
        self._peak = peak_flops  # resolved lazily
        self.flops_per_step: Optional[float] = None
        self._times: collections.deque = collections.deque(maxlen=window)
        self.mfu: Optional[float] = None

    @property
    def peak(self) -> float:
        if self._peak is None:
            self._peak = peak_flops_per_s()
        return self._peak

    def set_flops(self, flops_per_step: Optional[float]) -> None:
        if not flops_per_step or flops_per_step <= 0:
            return
        self.flops_per_step = float(flops_per_step)
        _FLOPS_PER_STEP.set(self.flops_per_step)

    def observe_step(self, step_seconds: float) -> Optional[float]:
        """Fold one measured step; returns (and gauges) the updated
        windowed MFU, or None until FLOPs are known."""
        if step_seconds > 0:
            self._times.append(float(step_seconds))
        if self.flops_per_step is None or not self._times:
            return None
        mean = sum(self._times) / len(self._times)
        if mean <= 0:
            return None
        self.mfu = self.flops_per_step / (mean * self.peak)
        _MFU.set(self.mfu)
        return self.mfu


class StepPhaseProfiler:
    """Per-step wall-time attribution + on-demand N-step capture.

    The owning loop reports what it knows::

        prof.note_data_wait(dt)         # blocked on next(batches)
        prof.note_dispatch(dt, compiled)  # from the trainer's step
        prof.end_step()                 # once per optimizer step

    ``end_step`` measures the step's total wall time on its own
    (injectable) clock and books the residual — wall minus the noted
    phases — as ``device_execute``: in a zero-sync loop that residual
    is exactly the time the host spent ahead of (or waiting on) the
    device. The five phases therefore partition wall time exactly.

    Capture protocol: every ``end_step`` polls the request file
    (mtime-gated, so the steady-state cost is one ``stat``); a fresh
    request arms an N-step capture whose per-step breakdowns fold
    into a digest written to the digest file (and, when a trace dir
    is requested, brackets the steps with ``torch.profiler``).
    """

    def __init__(
        self,
        fn_name: str = "train_step",
        clock: Callable[[], float] = time.perf_counter,
        mfu: Optional[MfuMeter] = None,
        compile_tracker: Optional[CompileTracker] = None,
        request_file: Optional[str] = None,
        digest_file: Optional[str] = None,
        poll_requests: bool = True,
        beacon: object = "auto",
    ):
        self.fn_name = fn_name
        self._clock = clock
        self.mfu = mfu
        self.compile_tracker = compile_tracker
        self._request_file = request_file or profile_request_file()
        self._digest_file = digest_file or profile_digest_file()
        self._poll_requests = poll_requests
        # Stall-localization beacon: the profiler stamps every phase
        # boundary the loop already reports, so cross-host progress
        # comparison costs the hot path one mmap memcpy per note.
        # "auto" = job-scoped beacon unless DLROVER_TPU_BEACON=0;
        # pass None/False to run beacon-less, or inject an instance.
        if beacon == "auto":
            beacon = default_beacon()
        self.beacon: Optional[ProgressBeacon] = beacon or None
        self._step_start: Optional[float] = None
        self._noted: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        self.steps = 0
        # capture state
        self._capture: Optional[dict] = None
        self._last_request_mtime: Optional[int] = None
        self._last_request_id: Optional[str] = None

    # -- per-step notes ---------------------------------------------------

    def note_data_wait(
        self, seconds: float, h2d_seconds: float = 0.0
    ) -> None:
        """Input wait for this step: ``seconds`` of host-side wait
        (pull/collate/queue) plus ``h2d_seconds`` of host->device
        staging (the split an input pipeline reports via
        ``wait_breakdown()``). Callers without the split pass the
        whole wait as ``seconds`` — attribution stays exhaustive
        either way."""
        host = max(seconds, 0.0)
        h2d = max(h2d_seconds, 0.0)
        if self._step_start is None:
            self._step_start = self._clock() - (host + h2d)
        self._noted["data_wait"] += host
        self._noted["h2d_stage"] += h2d
        if self.beacon is not None:
            self.beacon.stamp(step=self.steps + 1, phase="data_wait")

    def note_dispatch(self, seconds: float, compiled: bool = False) -> None:
        if self._step_start is None:
            self._step_start = self._clock() - max(seconds, 0.0)
        phase = "compile" if compiled else "dispatch"
        self._noted[phase] += max(seconds, 0.0)
        if self.beacon is not None:
            self.beacon.stamp(step=self.steps + 1, phase=phase)

    def end_step(self) -> Dict[str, float]:
        """Close the step: attribute its wall time and return the
        breakdown ``{phase: seconds, "wall_s": total}``."""
        now = self._clock()
        start = self._step_start if self._step_start is not None else now
        wall = max(now - start, 0.0)
        noted = sum(self._noted.values())
        breakdown = dict(self._noted)
        breakdown["device_execute"] = max(wall - noted, 0.0)
        # Clock skew guard: noted phases can (rarely) overshoot the
        # wall clock by scheduler jitter; scale them down so the
        # partition invariant (sum == wall) holds.
        if noted > wall > 0:
            scale = wall / noted
            for k in ("data_wait", "h2d_stage", "compile", "dispatch"):
                breakdown[k] *= scale
            breakdown["device_execute"] = 0.0
        for phase in PHASES:
            if breakdown[phase] > 0:
                _PHASE_SECONDS.inc(breakdown[phase], phase=phase)
        self.steps += 1
        self._noted = dict.fromkeys(PHASES, 0.0)
        self._step_start = now
        breakdown["wall_s"] = wall
        if self.beacon is not None:
            self.beacon.stamp(step=self.steps, phase="device_execute")
        mfu = None
        if self.mfu is not None:
            # Compile-tainted steps stay OUT of the MFU window (same
            # exclusion the profiler-less trainer path applies to its
            # compile-boundary sample): one multi-second XLA compile
            # in a 32-sample mean would underreport utilisation for
            # the whole window — exactly when a straggler-triggered
            # PROFILE is most likely to read it.
            if breakdown["compile"] > 0:
                mfu = self.mfu.mfu
            else:
                mfu = self.mfu.observe_step(wall)
        obs_event(
            "trainer.step_phases",
            step=self.steps,
            wall_s=round(wall, 6),
            data_wait_s=round(breakdown["data_wait"], 6),
            h2d_s=round(breakdown["h2d_stage"], 6),
            compile_s=round(breakdown["compile"], 6),
            dispatch_s=round(breakdown["dispatch"], 6),
            device_s=round(breakdown["device_execute"], 6),
            **({"mfu": round(mfu, 4)} if mfu is not None else {}),
        )
        if self._capture is not None:
            self._capture_step(breakdown)
        if self._poll_requests:
            self.poll_request()
        return breakdown

    # -- on-demand capture ------------------------------------------------

    @property
    def capturing(self) -> bool:
        return self._capture is not None

    def poll_request(self) -> bool:
        """Arm a capture when a fresh request file appeared. Steady-
        state cost: one stat() per step."""
        if self._capture is not None:
            return False
        try:
            mtime = os.stat(self._request_file).st_mtime_ns
        except OSError:
            return False
        if mtime == self._last_request_mtime:
            return False
        self._last_request_mtime = mtime
        try:
            with open(self._request_file) as f:
                req = json.load(f)
        except (OSError, ValueError):
            return False
        if not isinstance(req, dict):
            return False
        req_id = str(req.get("id", ""))
        if not req_id or req_id == self._last_request_id:
            return False
        self._last_request_id = req_id
        self.start_capture(
            steps=int(req.get("steps", 0) or DEFAULT_PROFILE_STEPS),
            trace_dir=str(req.get("trace_dir", "") or ""),
            request_id=req_id,
        )
        return True

    def start_capture(
        self,
        steps: int = DEFAULT_PROFILE_STEPS,
        trace_dir: str = "",
        request_id: str = "",
    ) -> None:
        """Record the next ``steps`` step breakdowns into a digest."""
        if self._capture is not None:
            return
        self._capture = {
            "id": request_id,
            "want": max(int(steps), 1),
            "rows": [],
            "compiles_at_start": (
                self.compile_tracker.compiles
                if self.compile_tracker is not None
                else 0
            ),
            "trace_dir": trace_dir,
            "tracing": False,
        }
        if trace_dir:
            try:
                import torch.profiler

                os.makedirs(trace_dir, exist_ok=True)
                prof = torch.profiler.profile(
                    on_trace_ready=(
                        torch.profiler.tensorboard_trace_handler(trace_dir)
                    )
                )
                prof.start()
                self._capture["tracing"] = prof
            except Exception:  # noqa: BLE001 — a broken trace backend
                # must not block the phase capture
                logger.warning(
                    "torch.profiler trace unavailable; capturing "
                    "phases only", exc_info=True,
                )
        obs_event(
            "trainer.profile_start",
            steps=self._capture["want"],
            request_id=request_id,
        )

    def _capture_step(self, breakdown: Dict[str, float]) -> None:
        cap = self._capture
        cap["rows"].append(breakdown)
        if len(cap["rows"]) >= cap["want"]:
            self._finish_capture()

    def _finish_capture(self) -> dict:
        cap, self._capture = self._capture, None
        if cap["tracing"]:
            try:
                cap["tracing"].stop()
            except Exception:  # noqa: BLE001
                logger.warning("profiler stop failed", exc_info=True)
        rows: List[Dict[str, float]] = cap["rows"]
        n = len(rows)
        walls = sorted(r["wall_s"] for r in rows)
        phases = {}
        for phase in PHASES:
            total = sum(r[phase] for r in rows)
            phases[phase] = {
                "total_s": round(total, 6),
                "mean_s": round(total / n, 6) if n else 0.0,
            }
        digest = {
            "id": cap["id"],
            "fn": self.fn_name,
            "steps": n,
            "phases": phases,
            "step_time_mean_s": round(sum(walls) / n, 6) if n else 0.0,
            "step_time_min_s": round(walls[0], 6) if walls else 0.0,
            "step_time_max_s": round(walls[-1], 6) if walls else 0.0,
            "compiles_during_capture": (
                self.compile_tracker.compiles - cap["compiles_at_start"]
                if self.compile_tracker is not None
                else 0
            ),
            "mfu": (
                round(self.mfu.mfu, 4)
                if self.mfu is not None and self.mfu.mfu is not None
                else None
            ),
            "flops_per_step": (
                self.mfu.flops_per_step if self.mfu is not None else None
            ),
            "trace_dir": cap["trace_dir"],
            "ts": time.time(),
        }
        try:
            tmp = f"{self._digest_file}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(digest, f)
            os.replace(tmp, self._digest_file)
        except OSError:
            logger.warning(
                "could not write profile digest %s",
                self._digest_file, exc_info=True,
            )
        _PROFILE_CAPTURES.inc()
        obs_event(
            "trainer.profile_done",
            steps=n,
            request_id=cap["id"],
            mfu=digest["mfu"],
        )
        return digest
