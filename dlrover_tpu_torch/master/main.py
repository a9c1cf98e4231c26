"""Master CLI entrypoint: ``python -m dlrover_tpu_torch.master.main``.

Parity: dlrover/python/master/main.py:37-58.
"""

from __future__ import annotations

import argparse
import sys

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.master import JobMaster

logger = get_logger("master.main")


def parse_args(argv=None):
    parser = argparse.ArgumentParser("dlrover-tpu-master")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--node_num", type=int, default=1)
    parser.add_argument("--min_nodes", type=int, default=0)
    parser.add_argument("--node_unit", type=int, default=1)
    parser.add_argument("--rdzv_timeout", type=float, default=30.0)
    # Sparse/CTR jobs: enable hot-PS migration + worker adjustment
    # (master/auto_scaler.py:PsTrainingAutoScaler).
    parser.add_argument("--ps_autoscale", action="store_true")
    parser.add_argument(
        "--ps_autoscale_interval", type=float, default=30.0
    )
    # Workers whose permanent loss fails the job: "", "none", "all",
    # or "rank:budget,..." (ref: critical-nodes spec,
    # master/node/training_node.py:81).
    parser.add_argument("--critical_workers", type=str, default="")
    # Standalone evaluator nodes the master schedules; the trainer's
    # evaluate loop attaches to them (role: NodeType.EVALUATOR).
    parser.add_argument("--evaluator_count", type=int, default=0)
    # Node-death detection knobs (drills/tests tighten these; the
    # defaults match production pod-failure budgets).
    parser.add_argument(
        "--heartbeat_timeout", type=float, default=180.0
    )
    parser.add_argument(
        "--monitor_interval", type=float, default=30.0
    )
    # Prometheus text exposition: GET /metrics on this port (0 =
    # ephemeral, printed as DLROVER_TPU_METRICS_PORT=N; unset = no
    # HTTP endpoint — metrics stay reachable over the MetricsRequest
    # RPC either way).
    parser.add_argument("--metrics_port", type=int, default=None)
    parser.add_argument("--job_name", type=str, default="")
    # Master warm restart: journal recoverable state (node table,
    # rendezvous round/world, shard ledger, kv store, speed progress)
    # into this directory and restore from the newest valid snapshot
    # at startup. Also settable via DLROVER_TPU_STATE_DIR.
    parser.add_argument("--state_dir", type=str, default=None)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # Black box before anything can crash: the master process's
    # flight recorder (crash bundles + WARNING+ log ring). Installed
    # here, not in JobMaster.prepare(), so in-process test harnesses
    # never get their excepthooks rewired implicitly.
    from dlrover_tpu_torch import obs

    obs.install_flight_recorder("master")
    try:
        master = JobMaster(
            port=args.port,
            node_num=args.node_num,
            min_nodes=args.min_nodes,
            node_unit=args.node_unit,
            rdzv_timeout=args.rdzv_timeout,
            critical_workers=args.critical_workers,
            evaluator_count=args.evaluator_count,
            heartbeat_timeout=args.heartbeat_timeout,
            monitor_interval=args.monitor_interval,
            job_name=args.job_name,
            metrics_port=args.metrics_port,
            state_dir=args.state_dir,
        )
    except ValueError as exc:
        logger.error("invalid arguments: %s", exc)
        return 2
    master.prepare()
    if args.ps_autoscale:
        master.start_ps_autoscaler(interval=args.ps_autoscale_interval)
    # Print the bound port on stdout so a parent process can discover it.
    print(f"DLROVER_TPU_MASTER_PORT={master.port}", flush=True)
    if master.metrics_server is not None:
        print(
            f"DLROVER_TPU_METRICS_PORT={master.metrics_server.port}",
            flush=True,
        )
    return master.run()


if __name__ == "__main__":
    sys.exit(main())
