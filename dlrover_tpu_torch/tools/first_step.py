"""Where a fresh process's first training steps spend their time.

    python -m dlrover_tpu_torch.tools.first_step            # GPT-2, 2 steps
    python -m dlrover_tpu_torch.tools.first_step --top 20 -- \
        --model gpt2 --steps 3
    python -m dlrover_tpu_torch.tools.first_step -- --smoke --device cpu

Runs the nanoGPT example's ``run()`` once in this process while a thread
samples the main thread's Python stack every 5 ms, and prints the time
of each window (the example's imports, its set-up to the first
``train_step``, then each step from its ``train_step`` to the next, the
last one to the end of the run) with, for every window, the
sampled time by the innermost frame (a call into C, a kernel library's
included, counts as its Python caller), by the innermost frame of the
port's own code, and by the module being imported, if any. Each sample
weighs the time since the one before it, so a C call that holds the GIL
counts in full. Started in a new process, with the kernel libraries
already built, it is what a trainer the elastic agent restarts pays
from its imports to its first steps. Sampling leaves the program's own
profiling hooks alone. Arguments after ``--`` go to the example
(default: ``--model gpt2 --steps 2``).
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import threading
import time

PORT = os.sep + "dlrover_tpu_torch" + os.sep
INTERVAL_S = 0.005


def card() -> str:
    """``name, power limit`` of the cards, or why they cannot be read."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _where(code, lineno) -> str:
    name = code.co_filename
    cut = name.rfind(PORT)
    if cut < 0:
        cut = name.rfind(os.sep + "site-packages" + os.sep)
    short = name[cut + 1:] if cut >= 0 else name
    return f"{short}:{lineno}({code.co_name})"


class StackSampler:
    """Samples one thread's stack: (time, seconds since the previous
    sample, innermost frame, innermost frame of the port, module being
    imported or "")."""

    def __init__(self, thread_id: int, interval: float):
        self.thread_id, self.interval = thread_id, interval
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        last = time.perf_counter()
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self.thread_id)
            if frame is None:
                continue
            leaf = _where(frame.f_code, frame.f_lineno)
            port, module = "", ""
            while frame is not None:
                code = frame.f_code
                if not port and PORT in code.co_filename:
                    port = _where(code, frame.f_lineno)
                if code.co_name == "_find_and_load":
                    module = str(frame.f_locals.get("name", "?"))
                frame = frame.f_back
            now = time.perf_counter()
            self.samples.append((now, now - last, leaf, port, module))
            last = now

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def report(sampler: StackSampler, start: float, end: float,
           top: int) -> str:
    """Sampled seconds in [start, end) by leaf, port frame and import."""
    by = {k: collections.Counter() for k in ("leaf", "port", "import")}
    for t, dt, leaf, port, module in sampler.samples:
        if start <= t < end:
            by["leaf"][leaf] += dt
            by["port"][port or "(outside the port)"] += dt
            by["import"][module or "(no import)"] += dt
    return "\n".join(
        f"#   {kind:6s} {s:8.3f} s  {what}"
        for kind, counts in by.items()
        for what, s in counts.most_common(top)
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rest = []
    if "--" in argv:
        at = argv.index("--")
        argv, rest = argv[:at], argv[at + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--top", type=int, default=12,
                   help="entries listed by each grouping of a window")
    args = p.parse_args(argv)
    starts = []
    with StackSampler(threading.get_ident(), INTERVAL_S) as sampler:
        t0 = time.perf_counter()
        from dlrover_tpu_torch.examples.nanogpt import train
        from dlrover_tpu_torch.trainer.elastic_trainer import ElasticTrainer

        t_run = time.perf_counter()
        step = ElasticTrainer.train_step

        def timed_step(self, *a, **kw):
            starts.append(time.perf_counter())
            return step(self, *a, **kw)

        ElasticTrainer.train_step = timed_step
        try:
            out = train.run(train.parse_args(
                rest or ["--model", "gpt2", "--steps", "2"]))
        finally:
            ElasticTrainer.train_step = step
        t_end = time.perf_counter()
    edges = [t0, t_run] + starts + [t_end]
    names = ["imports", "set-up"] + [
        f"step {i + 1}" for i in range(len(starts))]
    windows = ", ".join(
        f"{n} {b - a:.3f} s" for n, a, b in zip(names, edges, edges[1:]))
    print(f"# first_step: {card()} | {windows} | step_s {out['step_s']} | "
          f"{len(sampler.samples)} samples every {INTERVAL_S} s",
          flush=True)
    for name, a, b in zip(names, edges, edges[1:]):
        print(f"# first_step {name} ({b - a:.3f} s)\n"
              f"{report(sampler, a, b, args.top)}", flush=True)
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
