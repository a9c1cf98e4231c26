"""Brain service: historical job metrics -> resource plans.

Algorithms re-derived from the reference's optalgorithm set
(go/brain/pkg/optimizer/implementation/optalgorithm/ — one function per
file, registered by name; same registry shape here in ALGORITHMS):

* ``optimize_job_resource`` — initial worker plan from similar
  completed jobs (optimize_job_worker_create_resource.go).
* ``optimize_worker_oom`` — grow memory after a worker OOM
  (optimize_job_worker_resource.go runtime path).
* ``optimize_worker_create_oom`` — initial memory for a job family
  with OOM history (optimize_job_worker_create_oom_resource.go).
* ``optimize_worker_count`` — throughput-knee detection
  (optimize_job_worker_resource.go count path).
* ``optimize_ps_create`` — PS count/resource from similar historic
  jobs (optimize_job_ps_create_resource.go).
* ``optimize_ps_cold_create`` — cold-start defaults with no history
  (optimize_job_ps_cold_create_resource.go).
* ``optimize_ps_init_adjust`` — PS cpu from the model's recv-op
  count + margin once the first steps ran
  (optimize_job_ps_init_adjust_resource.go).
* ``optimize_ps_oom`` — PS OOM memory growth
  (optimize_job_ps_oom_resource.go).
* ``optimize_hot_ps`` — per-node cpu/memory hotness over the last N
  runtime samples -> grow hot PS nodes
  (optimize_job_hot_ps_resource.go).

The datastore is sqlite (stdlib) instead of MySQL — same schema shape
(job facts + runtime samples), zero deployment burden.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import NodeResource
from dlrover_tpu_torch.master.auto_scaler import ResourceOptimizer
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

logger = get_logger("brain")


@dataclasses.dataclass
class JobMetricsRecord:
    job_name: str
    model_signature: str  # e.g. "gpt2-124m" — similarity key
    workers: int
    memory_mb: int
    chips_per_worker: int
    throughput: float  # samples or tokens / s
    peak_memory_mb: int = 0
    oom: bool = False
    completed: bool = True
    timestamp: float = 0.0


@dataclasses.dataclass
class RuntimeSample:
    """One telemetry snapshot of one node — the analogue of the
    reference's JobRuntimeInfo rows (PSCPU/PSMemory/WorkerCPU maps)."""

    job_name: str
    node_type: str  # "worker" | "ps"
    node_id: int
    used_cpu: float
    used_memory_mb: int
    config_cpu: float
    config_memory_mb: int
    speed: float = 0.0  # global steps/s at sample time
    timestamp: float = 0.0


class BrainService:
    # samples averaged for hotness decisions (ref
    # optimplcomm.NRecordToAvgResource)
    HOT_WINDOW = 3
    MAX_PS_CPU = 32.0  # ref maxCPUThreshold

    def __init__(self, db_path: str = ":memory:"):
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = threading.Lock()
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS job_metrics (
                job_name TEXT, model_signature TEXT, workers INT,
                memory_mb INT, chips_per_worker INT, throughput REAL,
                peak_memory_mb INT, oom INT, completed INT,
                timestamp REAL
            )"""
        )
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS runtime_samples (
                job_name TEXT, node_type TEXT, node_id INT,
                used_cpu REAL, used_memory_mb INT, config_cpu REAL,
                config_memory_mb INT, speed REAL, timestamp REAL
            )"""
        )
        self._db.execute(
            """CREATE INDEX IF NOT EXISTS idx_runtime_samples
               ON runtime_samples (job_name, node_type, timestamp)"""
        )
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS ps_job_facts (
                job_name TEXT, model_signature TEXT, ps_count INT,
                ps_cpu REAL, ps_memory_mb INT, recv_op_count INT,
                oom INT, completed INT, timestamp REAL
            )"""
        )
        # Health plane (obs/health.py): fleet aggregate snapshots and
        # detector verdicts on the evaluation cadence — the telemetry
        # HISTORY the scaling policy engine plans over.
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS fleet_samples (
                job_name TEXT, aggregates TEXT, goodput_ratio REAL,
                health_score REAL, timestamp REAL
            )"""
        )
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS health_verdicts (
                job_name TEXT, detector TEXT, severity TEXT,
                node_id INT, message TEXT, action TEXT,
                evidence TEXT, timestamp REAL
            )"""
        )
        # Remediation engine (master/remediation.py): every decision
        # (acted, blocked, dry-run) and outcome transition, with the
        # governor audit trail as JSON — the record of what the
        # self-healing loop DID, next to what the detectors SAW.
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS remediation_decisions (
                job_name TEXT, decision_id INT, detector TEXT,
                node_id INT, host TEXT, action TEXT, outcome TEXT,
                dry_run INT, governors TEXT, message TEXT,
                timestamp REAL
            )"""
        )
        # Capacity plane (obs/capacity.py): closed slice state
        # intervals and per-tenant goodput rollups — the offline
        # history the capacity brain (ROADMAP item 5) warm-starts
        # goodput-per-chip planning from.
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS capacity_intervals (
                job_name TEXT, slice_id INT, state TEXT,
                tenant TEXT, job_id TEXT, start_ts REAL,
                end_ts REAL, chip_seconds REAL
            )"""
        )
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS tenant_goodput (
                job_name TEXT, tenant TEXT, chips INT,
                held_chip_seconds REAL, productive_chip_seconds REAL,
                goodput_per_chip REAL, timestamp REAL
            )"""
        )

    def persist_metrics(self, rec: JobMetricsRecord) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO job_metrics VALUES (?,?,?,?,?,?,?,?,?,?)",
                (
                    rec.job_name,
                    rec.model_signature,
                    rec.workers,
                    rec.memory_mb,
                    rec.chips_per_worker,
                    rec.throughput,
                    rec.peak_memory_mb,
                    int(rec.oom),
                    int(rec.completed),
                    rec.timestamp or time.time(),
                ),
            )
            self._db.commit()

    def _rows(self, signature: str) -> List[tuple]:
        with self._lock:
            cur = self._db.execute(
                "SELECT workers, memory_mb, chips_per_worker, "
                "throughput, peak_memory_mb, oom, completed "
                "FROM job_metrics WHERE model_signature = ?",
                (signature,),
            )
            return cur.fetchall()

    # -- algorithms ---------------------------------------------------------

    def optimize_job_resource(
        self, signature: str
    ) -> Optional[Dict]:
        """Initial plan from successful history: median worker count
        and the max memory that never OOM'd."""
        rows = [r for r in self._rows(signature) if r[6]]  # completed
        if not rows:
            return None
        workers = sorted(r[0] for r in rows)
        memory = [r[1] for r in rows if not r[5]]
        plan = {
            "workers": workers[len(workers) // 2],
            "memory_mb": max(memory) if memory else max(
                r[1] for r in rows
            ),
            "chips_per_worker": rows[-1][2],
        }
        return plan

    def optimize_worker_oom(
        self, signature: str, requested_mb: int
    ) -> int:
        """Memory for an OOM retry: above every observed peak."""
        rows = self._rows(signature)
        peaks = [r[4] for r in rows if r[4] > 0]
        candidate = int(max(peaks) * 1.5) if peaks else requested_mb * 2
        return max(candidate, int(requested_mb * 1.5))

    # keep this many newest samples per (job, node_type) — hotness
    # windows are tiny, unbounded telemetry would grow forever
    SAMPLE_RETENTION = 1000

    def persist_runtime_sample(self, s: RuntimeSample) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO runtime_samples VALUES "
                "(?,?,?,?,?,?,?,?,?)",
                (
                    s.job_name, s.node_type, s.node_id, s.used_cpu,
                    s.used_memory_mb, s.config_cpu,
                    s.config_memory_mb, s.speed,
                    s.timestamp or time.time(),
                ),
            )
            self._db.execute(
                "DELETE FROM runtime_samples WHERE rowid IN ("
                "  SELECT rowid FROM runtime_samples"
                "  WHERE job_name = ? AND node_type = ?"
                "  ORDER BY timestamp DESC"
                "  LIMIT -1 OFFSET ?)",
                (s.job_name, s.node_type, self.SAMPLE_RETENTION),
            )
            self._db.commit()

    def persist_fleet_sample(
        self,
        job_name: str,
        aggregates: Optional[Dict] = None,
        goodput_ratio: float = 0.0,
        health_score: float = 1.0,
        timestamp: float = 0.0,
    ) -> None:
        """One fleet-level telemetry snapshot per health-evaluation
        tick: the FleetAggregator's cross-host aggregates (stored as
        JSON) plus the goodput ratio and composite health score —
        the windowed history the worker-count / replanning policies
        consume."""
        with self._lock:
            self._db.execute(
                "INSERT INTO fleet_samples VALUES (?,?,?,?,?)",
                (
                    job_name,
                    json.dumps(aggregates or {}, sort_keys=True),
                    float(goodput_ratio),
                    float(health_score),
                    timestamp or time.time(),
                ),
            )
            self._db.execute(
                "DELETE FROM fleet_samples WHERE rowid IN ("
                "  SELECT rowid FROM fleet_samples"
                "  WHERE job_name = ?"
                "  ORDER BY timestamp DESC"
                "  LIMIT -1 OFFSET ?)",
                (job_name, self.SAMPLE_RETENTION),
            )
            self._db.commit()

    def recent_fleet_samples(
        self, job_name: str, limit: int = 100
    ) -> List[Dict]:
        """Newest-first fleet samples, aggregates decoded."""
        with self._lock:
            cur = self._db.execute(
                "SELECT aggregates, goodput_ratio, health_score, "
                "timestamp FROM fleet_samples WHERE job_name = ? "
                "ORDER BY timestamp DESC LIMIT ?",
                (job_name, limit),
            )
            rows = cur.fetchall()
        out = []
        for aggregates, ratio, score, ts in rows:
            try:
                decoded = json.loads(aggregates)
            except ValueError:
                decoded = {}
            out.append(
                {
                    "aggregates": decoded,
                    "goodput_ratio": ratio,
                    "health_score": score,
                    "timestamp": ts,
                }
            )
        return out

    def persist_capacity_interval(
        self,
        job_name: str,
        slice_id: int,
        state: str,
        tenant: str = "",
        job_id: str = "",
        start_ts: float = 0.0,
        end_ts: float = 0.0,
        chip_seconds: float = 0.0,
    ) -> None:
        """One closed slice state interval from the capacity ledger
        (``end_ts`` doubles as the retention-order timestamp)."""
        with self._lock:
            self._db.execute(
                "INSERT INTO capacity_intervals VALUES "
                "(?,?,?,?,?,?,?,?)",
                (
                    job_name, int(slice_id), state, tenant, job_id,
                    float(start_ts), float(end_ts),
                    float(chip_seconds),
                ),
            )
            self._db.execute(
                "DELETE FROM capacity_intervals WHERE rowid IN ("
                "  SELECT rowid FROM capacity_intervals"
                "  WHERE job_name = ?"
                "  ORDER BY end_ts DESC"
                "  LIMIT -1 OFFSET ?)",
                (job_name, self.SAMPLE_RETENTION),
            )
            self._db.commit()

    def recent_capacity_intervals(
        self, job_name: str, limit: int = 100
    ) -> List[Dict]:
        """Newest-first closed capacity intervals."""
        with self._lock:
            cur = self._db.execute(
                "SELECT slice_id, state, tenant, job_id, start_ts, "
                "end_ts, chip_seconds FROM capacity_intervals "
                "WHERE job_name = ? ORDER BY end_ts DESC LIMIT ?",
                (job_name, limit),
            )
            rows = cur.fetchall()
        return [
            {
                "slice_id": slice_id,
                "state": state,
                "tenant": tenant,
                "job_id": job_id,
                "start_ts": start_ts,
                "end_ts": end_ts,
                "chip_seconds": chip_seconds,
            }
            for slice_id, state, tenant, job_id, start_ts, end_ts,
            chip_seconds in rows
        ]

    def persist_tenant_goodput(
        self,
        job_name: str,
        tenant: str,
        chips: int = 0,
        held_chip_seconds: float = 0.0,
        productive_chip_seconds: float = 0.0,
        goodput_per_chip: float = 0.0,
        timestamp: float = 0.0,
    ) -> None:
        """One per-tenant chip-second rollup (held vs productive,
        goodput-per-chip) on the goodput-observation cadence."""
        with self._lock:
            self._db.execute(
                "INSERT INTO tenant_goodput VALUES (?,?,?,?,?,?,?)",
                (
                    job_name, tenant, int(chips),
                    float(held_chip_seconds),
                    float(productive_chip_seconds),
                    float(goodput_per_chip),
                    timestamp or time.time(),
                ),
            )
            self._db.execute(
                "DELETE FROM tenant_goodput WHERE rowid IN ("
                "  SELECT rowid FROM tenant_goodput"
                "  WHERE job_name = ?"
                "  ORDER BY timestamp DESC"
                "  LIMIT -1 OFFSET ?)",
                (job_name, self.SAMPLE_RETENTION),
            )
            self._db.commit()

    def recent_tenant_goodput(
        self, job_name: str, limit: int = 100
    ) -> List[Dict]:
        """Newest-first tenant goodput rollups."""
        with self._lock:
            cur = self._db.execute(
                "SELECT tenant, chips, held_chip_seconds, "
                "productive_chip_seconds, goodput_per_chip, "
                "timestamp FROM tenant_goodput "
                "WHERE job_name = ? ORDER BY timestamp DESC LIMIT ?",
                (job_name, limit),
            )
            rows = cur.fetchall()
        return [
            {
                "tenant": tenant,
                "chips": chips,
                "held_chip_seconds": held,
                "productive_chip_seconds": productive,
                "goodput_per_chip": gpc,
                "timestamp": ts,
            }
            for tenant, chips, held, productive, gpc, ts in rows
        ]

    def persist_health_verdict(
        self,
        job_name: str,
        detector: str,
        severity: str,
        node_id: int = -1,
        message: str = "",
        action: str = "",
        evidence: str = "",
        timestamp: float = 0.0,
    ) -> None:
        """One detector verdict transition (new verdict, severity
        change, or resolution). ``evidence`` is the JSON-encoded
        evidence window the verdict shipped."""
        with self._lock:
            self._db.execute(
                "INSERT INTO health_verdicts VALUES "
                "(?,?,?,?,?,?,?,?)",
                (
                    job_name, detector, severity, int(node_id),
                    message, action, evidence,
                    timestamp or time.time(),
                ),
            )
            self._db.execute(
                "DELETE FROM health_verdicts WHERE rowid IN ("
                "  SELECT rowid FROM health_verdicts"
                "  WHERE job_name = ?"
                "  ORDER BY timestamp DESC"
                "  LIMIT -1 OFFSET ?)",
                (job_name, self.SAMPLE_RETENTION),
            )
            self._db.commit()

    def recent_health_verdicts(
        self, job_name: str, limit: int = 100
    ) -> List[Dict]:
        with self._lock:
            cur = self._db.execute(
                "SELECT detector, severity, node_id, message, "
                "action, evidence, timestamp FROM health_verdicts "
                "WHERE job_name = ? ORDER BY timestamp DESC LIMIT ?",
                (job_name, limit),
            )
            rows = cur.fetchall()
        return [
            {
                "detector": detector,
                "severity": severity,
                "node_id": node_id,
                "message": message,
                "action": action,
                "evidence": evidence,
                "timestamp": ts,
            }
            for detector, severity, node_id, message, action,
            evidence, ts in rows
        ]

    def persist_remediation_decision(
        self,
        job_name: str,
        decision_id: int = 0,
        detector: str = "",
        node_id: int = -1,
        host: str = "",
        action: str = "",
        outcome: str = "",
        dry_run: int = 0,
        governors: str = "",
        message: str = "",
        timestamp: float = 0.0,
    ) -> None:
        """One remediation decision or outcome transition (the same
        decision_id appears once per outcome). ``governors`` is the
        JSON-encoded governor-check map."""
        with self._lock:
            self._db.execute(
                "INSERT INTO remediation_decisions VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?)",
                (
                    job_name, int(decision_id), detector,
                    int(node_id), host, action, outcome,
                    int(dry_run), governors, message,
                    timestamp or time.time(),
                ),
            )
            self._db.execute(
                "DELETE FROM remediation_decisions WHERE rowid IN ("
                "  SELECT rowid FROM remediation_decisions"
                "  WHERE job_name = ?"
                "  ORDER BY timestamp DESC"
                "  LIMIT -1 OFFSET ?)",
                (job_name, self.SAMPLE_RETENTION),
            )
            self._db.commit()

    def recent_remediation_decisions(
        self, job_name: str, limit: int = 100
    ) -> List[Dict]:
        with self._lock:
            cur = self._db.execute(
                "SELECT decision_id, detector, node_id, host, "
                "action, outcome, dry_run, governors, message, "
                "timestamp FROM remediation_decisions "
                "WHERE job_name = ? ORDER BY timestamp DESC LIMIT ?",
                (job_name, limit),
            )
            rows = cur.fetchall()
        out = []
        for (decision_id, detector, node_id, host, action, outcome,
             dry_run, governors, message, ts) in rows:
            try:
                decoded = json.loads(governors) if governors else {}
            except ValueError:
                decoded = {}
            out.append(
                {
                    "decision_id": decision_id,
                    "detector": detector,
                    "node_id": node_id,
                    "host": host,
                    "action": action,
                    "outcome": outcome,
                    "dry_run": bool(dry_run),
                    "governors": decoded,
                    "message": message,
                    "timestamp": ts,
                }
            )
        return out

    def persist_ps_job(
        self,
        job_name: str,
        signature: str,
        ps_count: int,
        ps_cpu: float,
        ps_memory_mb: int,
        recv_op_count: int = 0,
        oom: bool = False,
        completed: bool = True,
    ) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO ps_job_facts VALUES (?,?,?,?,?,?,?,?,?)",
                (
                    job_name, signature, ps_count, ps_cpu,
                    ps_memory_mb, recv_op_count, int(oom),
                    int(completed), time.time(),
                ),
            )
            self._db.commit()

    def _recent_samples(
        self, job_name: str, node_type: str, window: int
    ) -> Dict[int, List[tuple]]:
        """node_id -> newest-first [(used_cpu, used_mem, cfg_cpu,
        cfg_mem)] limited to ``window`` per node."""
        with self._lock:
            cur = self._db.execute(
                "SELECT node_id, used_cpu, used_memory_mb, "
                "config_cpu, config_memory_mb FROM runtime_samples "
                "WHERE job_name = ? AND node_type = ? "
                "ORDER BY timestamp DESC",
                (job_name, node_type),
            )
            rows = cur.fetchall()
        out: Dict[int, List[tuple]] = {}
        for node_id, ucpu, umem, ccpu, cmem in rows:
            bucket = out.setdefault(node_id, [])
            if len(bucket) < window:
                bucket.append((ucpu, umem, ccpu, cmem))
        return out

    def optimize_worker_count(
        self, signature: str, min_marginal_gain: float = 0.6
    ) -> Optional[int]:
        """Largest worker count whose marginal throughput per added
        worker stays above ``min_marginal_gain`` x linear scaling."""
        rows = [r for r in self._rows(signature) if r[3] > 0]
        if len(rows) < 2:
            return None
        by_workers: Dict[int, float] = {}
        for r in rows:
            by_workers[r[0]] = max(by_workers.get(r[0], 0.0), r[3])
        counts = sorted(by_workers)
        best = counts[0]
        for prev, cur in zip(counts, counts[1:]):
            gain = by_workers[cur] - by_workers[prev]
            linear = by_workers[prev] / prev * (cur - prev)
            if linear > 0 and gain / linear >= min_marginal_gain:
                best = cur
            else:
                break
        return best


    def optimize_worker_create_oom(
        self, signature: str, default_mb: int = 8192
    ) -> int:
        """Initial worker memory for a job family whose history shows
        OOMs (ref optimize_job_worker_create_oom_resource.go): above
        every OOM'd request and every observed peak."""
        rows = self._rows(signature)
        oom_requests = [r[1] for r in rows if r[5]]
        peaks = [r[4] for r in rows if r[4] > 0]
        if not oom_requests and not peaks:
            return default_mb
        floor = max(oom_requests + peaks)
        return int(floor * 1.5)

    # -- PS-strategy algorithms -----------------------------------------

    def _ps_rows(self, signature: str) -> List[tuple]:
        with self._lock:
            cur = self._db.execute(
                "SELECT ps_count, ps_cpu, ps_memory_mb, "
                "recv_op_count, oom, completed FROM ps_job_facts "
                "WHERE model_signature = ?",
                (signature,),
            )
            return cur.fetchall()

    def optimize_ps_create(self, signature: str) -> Optional[Dict]:
        """PS plan from similar completed jobs (ref
        optimize_job_ps_create_resource.go ->
        EstimateJobResourceByHistoricJobs): median count, max cpu, max
        memory that never OOM'd."""
        rows = [r for r in self._ps_rows(signature) if r[5]]
        if not rows:
            return None
        counts = sorted(r[0] for r in rows)
        no_oom = [r for r in rows if not r[4]]
        pool = no_oom or rows
        return {
            "ps_count": counts[len(counts) // 2],
            "ps_cpu": max(r[1] for r in pool),
            "ps_memory_mb": max(r[2] for r in pool),
        }

    def optimize_ps_cold_create(
        self,
        default_count: int = 2,
        default_cpu: float = 8.0,
        default_memory_mb: int = 8192,
    ) -> Dict:
        """Cold start — no history for the family (ref
        optimize_job_ps_cold_create_resource.go config defaults)."""
        return {
            "ps_count": default_count,
            "ps_cpu": default_cpu,
            "ps_memory_mb": default_memory_mb,
        }

    def optimize_ps_init_adjust(
        self,
        job_name: str,
        recv_op_count: int,
        ps_count: int,
        margin_cpu: float = 4.0,
        memory_margin_percent: float = 0.5,
    ) -> Optional[Dict]:
        """Right after the first steps: size PS cpu from the model's
        recv-op fan-in per PS (ref
        optimize_job_ps_init_adjust_resource.go: cpu =
        ceil(0.08 * recv_ops_per_ps) + margin, capped; memory = peak *
        (1 + margin))."""
        if ps_count <= 0:
            return None
        recv_per_ps = recv_op_count / ps_count
        if recv_per_ps <= 150:
            cpu = float(int(0.08 * recv_per_ps + 0.999)) + margin_cpu
        else:
            cpu = 16.0
        samples = self._recent_samples(
            job_name, "ps", self.HOT_WINDOW
        )
        peak_mem = 0
        observed_cpu = 0.0
        for rows in samples.values():
            for ucpu, umem, _, _ in rows:
                peak_mem = max(peak_mem, umem)
                observed_cpu = max(observed_cpu, ucpu)
        cpu = min(max(cpu, observed_cpu + margin_cpu),
                  self.MAX_PS_CPU)
        plan: Dict = {"ps_cpu": cpu}
        if peak_mem > 0:
            plan["ps_memory_mb"] = int(
                peak_mem * (1.0 + memory_margin_percent)
            )
        return plan

    def optimize_ps_oom(
        self, signature: str, requested_mb: int
    ) -> int:
        """Memory for an OOM'd PS relaunch (ref
        optimize_job_ps_oom_resource.go): above every observed PS
        request that OOM'd."""
        rows = self._ps_rows(signature)
        oomed = [r[2] for r in rows if r[4]]
        floor = max(oomed, default=requested_mb)
        return int(max(floor, requested_mb) * 1.5)

    def optimize_hot_ps(
        self,
        job_name: str,
        current_workers: int,
        target_workers: int,
        hot_cpu_util: float = 0.8,
        hot_memory_util: float = 0.8,
        memory_adjust_mb: int = 4096,
    ) -> Dict[int, Dict]:
        """Per-node hotness over the last HOT_WINDOW samples (ref
        optimize_job_hot_ps_resource.go): a PS averaging above the cpu
        threshold gets cpu scaled by target/current workers (capped at
        MAX_PS_CPU, every PS scaled by the same coefficient); one
        above the memory threshold gets a fixed memory bump. Returns
        {ps_id: {"cpu": new, "memory_mb": new}}."""
        samples = self._recent_samples(
            job_name, "ps", self.HOT_WINDOW
        )
        avg_cpu: Dict[int, float] = {}
        cfg_cpu: Dict[int, float] = {}
        hot_cpu: List[int] = []
        hot_mem: Dict[int, int] = {}
        for node_id, rows in samples.items():
            if len(rows) < self.HOT_WINDOW:
                continue
            a_cpu = sum(r[0] for r in rows) / len(rows)
            avg_cpu[node_id] = a_cpu
            cfg_cpu[node_id] = rows[0][2]
            if rows[0][2] > 0 and a_cpu / rows[0][2] >= hot_cpu_util:
                hot_cpu.append(node_id)
            a_mem = sum(r[1] for r in rows) / len(rows)
            if (rows[0][3] > 0
                    and a_mem / rows[0][3] >= hot_memory_util):
                hot_mem[node_id] = rows[0][3]
        plan: Dict[int, Dict] = {}
        if hot_cpu and current_workers > 0:
            coeff = target_workers / current_workers
            for n in hot_cpu:
                if avg_cpu[n] * coeff > self.MAX_PS_CPU:
                    coeff = self.MAX_PS_CPU / avg_cpu[n]
            # enlarge every PS by the same ratio (the ref scales the
            # whole group so the load stays balanced)
            for n, cpu in avg_cpu.items():
                opt = float(int(cpu * coeff + 0.999))
                if opt > cfg_cpu.get(n, 0.0):
                    plan[n] = {"cpu": min(opt, self.MAX_PS_CPU)}
        for n, cfg_mem in hot_mem.items():
            entry = plan.setdefault(n, {})
            entry["memory_mb"] = cfg_mem + memory_adjust_mb
        return plan


# Name -> bound-method registry, mirroring the reference's
# registerOptimizeAlgorithm table (optimize_algorithm.go).
ALGORITHMS = {
    "optimize_job_worker_create_resource": "optimize_job_resource",
    "optimize_job_worker_resource": "optimize_worker_count",
    "optimize_job_worker_create_oom_resource":
        "optimize_worker_create_oom",
    "optimize_job_worker_oom_resource": "optimize_worker_oom",
    "optimize_job_ps_create_resource": "optimize_ps_create",
    "optimize_job_ps_cold_create_resource": "optimize_ps_cold_create",
    "optimize_job_ps_init_adjust_resource": "optimize_ps_init_adjust",
    "optimize_job_ps_oom_resource": "optimize_ps_oom",
    "optimize_job_hot_ps_resource": "optimize_hot_ps",
}


def run_algorithm(brain: BrainService, name: str, /, *args, **kw):
    """Invoke a registered algorithm by its reference name."""
    try:
        method = ALGORITHMS[name]
    except KeyError:
        raise KeyError(
            f"unknown brain algorithm {name!r}; known: "
            f"{sorted(ALGORITHMS)}"
        ) from None
    return getattr(brain, method)(*args, **kw)


class BrainResourceOptimizer(ResourceOptimizer):
    """Plugs the Brain into the master's auto-scaler (ref
    brain_optimizer.py BrainResoureOptimizer)."""

    def __init__(
        self,
        brain: BrainService,
        signature: str,
        min_workers: int = 1,
        max_workers: int = 64,
        hosts_per_slice: int = 1,
    ):
        self.brain = brain
        self.signature = signature
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.hosts_per_slice = max(hosts_per_slice, 1)

    def optimize_oom_node(self, resource: NodeResource) -> NodeResource:
        grown = NodeResource.from_dict(resource.to_dict())
        grown.memory_mb = self.brain.optimize_worker_oom(
            self.signature, max(resource.memory_mb, 1024)
        )
        return grown

    def target_worker_count(
        self, current: int, speed_monitor: SpeedMonitor
    ) -> int:
        suggested = self.brain.optimize_worker_count(self.signature)
        target = suggested if suggested is not None else current
        target = max(self.min_workers, min(target, self.max_workers))
        target -= target % self.hosts_per_slice
        return max(target, self.hosts_per_slice)
