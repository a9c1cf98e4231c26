"""The port's elastic launch on the CPU, with gloo workers.

* ``elastic_run --standalone --nproc_per_node 2`` trains the smoke GPT
  (f32) for 3 steps through the port's master and agent: both ranks
  report the same loss at every step, and the losses equal a
  one-process run at the same global batch within 1e-5.
* The same run with the rank-1 trainer SIGKILLed once step 2 and its
  checkpoint are done (the example's drill hook): the agent restarts the
  group once, both ranks resume at step 2 from the staged checkpoint
  (rank 0 from shared memory) with the same next sample indices, and the
  final parameters and optimizer state are bitwise equal to the
  uninterrupted run's.
* The data-parallel step against JAX: the JAX ``ElasticTrainer`` on a
  2-device CPU mesh against the port's two gloo ranks, from the same
  JAX init, two steps at global batch 8: losses, and every parameter,
  within 1e-5 of max(1, the leaf's largest value), as
  ``test_torch_train_step.py`` holds three f32 steps; both ranks'
  parameters bitwise equal.
* Units: the agent's environment -> backend, rank and world size
  (``torch_env``); process ids for a world {0: 2, 1: 2}; the
  environment of each trainer the agent spawns; the group's exit code,
  and the agent waking at once on a failure; the launcher's process
  count; a one-process run writing no agent files; the first-step probe
  (``tools/first_step.py``).
"""

import importlib
import io
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time
import uuid

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.agent import agent as tagent
from dlrover_tpu_torch.examples.nanogpt import train
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.trainer import elastic_run, torch_env
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    CheckpointEngine,
    flatten_named,
    unlink_shm,
)

jgpt = importlib.import_module("dlrover_tpu.models.gpt")
jet = importlib.import_module("dlrover_tpu.trainer.elastic_trainer")

REPO = pathlib.Path(__file__).resolve().parent.parent
SMOKE = [
    "--smoke", "--device", "cpu", "--steps", "3", "--global-batch-size",
    "8", "--micro-batch-size", "2",
]
LAUNCH_TIMEOUT = 120
# Trainers share the launcher's stdout: find records anywhere in a line.
STEP = re.compile(
    r"step (\d+): loss (\S+) [^\n]*? batch_sum (-?\d+) rank (\d+) "
    r"restart (\d+) at"
)
RECORD = re.compile(r"(ckpt_\w+|killing) (\{.*\})")


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p]
    )
    env["DLROVER_TPU_JOB_NAME"] = f"t{uuid.uuid4().hex[:10]}"
    for var in ("DLROVER_TPU_AGENT_PRESENT", "DLROVER_TPU_MASTER_ADDR"):
        env.pop(var, None)
    env.update(extra)
    return env


def _launch(tmp: pathlib.Path, **extra_env) -> dict:
    """Run the launcher; its exit code, steps and records."""
    ckdir = tmp / "ckpt"
    env = _env(**extra_env)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
             "--standalone", "--nproc_per_node", "2",
             "-m", "dlrover_tpu_torch.examples.nanogpt.train", "--",
             *SMOKE, "--checkpoint-every", "2", "--checksums",
             "--checkpoint-dir", str(ckdir)],
            cwd=tmp, env=env, capture_output=True, text=True,
            timeout=LAUNCH_TIMEOUT,
        )
    finally:
        unlink_shm_of(env["DLROVER_TPU_JOB_NAME"])
    steps, records = [], {}
    for m in STEP.finditer(out.stdout):
        steps.append(dict(
            step=int(m[1]), loss=m[2], batch_sum=int(m[3]),
            rank=int(m[4]), restart=int(m[5]),
        ))
    for m in RECORD.finditer(out.stdout):
        records.setdefault(m[1], []).append(json.loads(m[2]))
    return dict(rc=out.returncode, steps=steps, records=records,
                ckdir=ckdir, log=out.stdout + out.stderr[-3000:])


def unlink_shm_of(job: str) -> None:
    """Remove a run's segment should its agent not have (it does)."""
    old = os.environ.get("DLROVER_TPU_JOB_NAME")
    os.environ["DLROVER_TPU_JOB_NAME"] = job
    try:
        unlink_shm(0)
    finally:
        if old is None:
            del os.environ["DLROVER_TPU_JOB_NAME"]
        else:
            os.environ["DLROVER_TPU_JOB_NAME"] = old


def _by(steps, **match):
    return [s for s in steps if all(s[k] == v for k, v in match.items())]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("uninterrupted"))


def test_standalone_two_workers_match_one_process(uninterrupted):
    run = uninterrupted
    assert run["rc"] == 0, run["log"]
    one = train.run(train.parse_args(SMOKE))
    for step in (1, 2, 3):
        ranks = _by(run["steps"], step=step)
        assert sorted(s["rank"] for s in ranks) == [0, 1], run["log"]
        assert ranks[0]["loss"] == ranks[1]["loss"]
        assert abs(float(ranks[0]["loss"]) - one["losses"][step - 1]) <= 1e-5
    assert {s["restart"] for s in run["steps"]} == {0}
    staged = run["records"]["ckpt_staged"]
    assert [r["step"] for r in staged] == [2, 3]
    assert {r["rank"] for r in staged} == {0}


def _final_state(ckdir):
    cfg = train.model_config(train.parse_args(SMOKE))
    params = tgpt.init_params(cfg, device="cpu")
    opt = train.make_run_optimizer(train.parse_args(SMOKE))
    engine = CheckpointEngine(str(ckdir), use_agent=False, global_rank=0,
                              world_size=1)
    try:
        step, state, extra = engine.load((params, (opt.init(params),)))
    finally:
        engine.close()
    return step, state, extra


def test_killed_worker_resumes_from_its_checkpoint(tmp_path, uninterrupted):
    run = _launch(tmp_path, DLROVER_TPU_KILL_AT_STEP="2",
                  DLROVER_TPU_KILL_RANK="1")
    assert run["rc"] == 0, run["log"]
    assert run["records"]["killing"] == [
        {"rank": 1, "step": 2, "time": run["records"]["killing"][0]["time"]}
    ]
    # one restart; the first incarnation reached step 2, the second
    # resumed there and trained step 3 only
    assert {s["restart"] for s in run["steps"]} == {0, 1}
    assert sorted(s["step"] for s in _by(run["steps"], restart=0)) == [
        1, 1, 2, 2]
    assert sorted(s["step"] for s in _by(run["steps"], restart=1)) == [3, 3]
    restored = run["records"]["ckpt_restored"]
    assert sorted(r["rank"] for r in restored) == [0, 1]
    assert {r["step"] for r in restored} == {2}
    assert _by(restored, rank=0)[0]["source"] == "shm"
    staged2 = [r for r in run["records"]["ckpt_staged"] if r["step"] == 2]
    for r in restored:
        assert r["checksums"] == staged2[0]["checksums"]
    # the same samples, in the same order, and the same loss at step 3
    for rank in (0, 1):
        got = _by(run["steps"], step=3, rank=rank)[0]
        want = _by(uninterrupted["steps"], step=3, rank=rank)[0]
        assert got["batch_sum"] == want["batch_sum"]
        assert got["loss"] == want["loss"]
    step, got, extra = _final_state(run["ckdir"])
    step_u, want, extra_u = _final_state(uninterrupted["ckdir"])
    assert step == step_u == 3 and extra == extra_u
    for (name, a), (_, b) in zip(flatten_named(got), flatten_named(want)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


# -- the data-parallel step against JAX ---------------------------------------

DIMS = dict(vocab_size=256, block_size=64, n_layer=2, n_head=2, n_embd=64)

RANK_SCRIPT = r"""
import json, sys
import numpy as np, torch
from dlrover_tpu_torch.models import gpt
from dlrover_tpu_torch.optim.adamw import AdamW
from dlrover_tpu_torch.trainer import torch_env
from dlrover_tpu_torch.trainer.elastic_trainer import ElasticTrainer
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    flatten_named, map_named)

torch.set_num_threads(1)
data = np.load(sys.argv[1])
cfg = gpt.GPTConfig(dtype=torch.float32, remat=False,
                    use_flash_attention=False, **json.loads(sys.argv[2]))
dev = torch_env.setup_distributed("cpu")
rank = torch.distributed.get_rank()
params = map_named(
    lambda n, _: torch.tensor(data["p|" + n.replace("/", "|")]),
    gpt.init_params(cfg, device="cpu"))
opt = AdamW(3e-4, weight_decay=0.1)
trainer = ElasticTrainer(
    lambda p, a, b: gpt.loss_fn_fused(p, a, b, cfg), opt,
    global_batch_size=8, micro_batch_size=2, device=dev)
state = opt.init(params)
losses = []
for i in range(2):
    tok = data[f"tok{i}_rank{rank}"]
    tgt = data[f"tgt{i}_rank{rank}"]
    params, state, loss = trainer.train_step(params, state, tok, tgt)
    losses.append(float(loss))
np.savez(sys.argv[3], losses=np.array(losses), shards=trainer.num_shards,
         accum=trainer.accum_steps,
         **{"p|" + n.replace("/", "|"): t.numpy()
            for n, t in flatten_named(params)})
torch_env.teardown_distributed()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_jax_on_two_devices(tmp_path):
    jcfg = jgpt.GPTConfig(
        dtype=jax.numpy.float32, remat=False, use_flash_attention=False,
        **DIMS,
    )
    jp = jax.jit(lambda k: jgpt.init_params(k, jcfg))(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    batches = [
        tuple(rng.integers(0, DIMS["vocab_size"],
                           (8, DIMS["block_size"])).astype(np.int32)
              for _ in range(2))
        for _ in range(2)
    ]
    data = {"p|" + n.replace("/", "|"): t.numpy()
            for n, t in flatten_named(tp)}
    # JAX's microbatch k is rows [4k, 4k+4) of the global batch, split
    # over the data axis: device r takes rows 4k + 2r and 4k + 2r + 1.
    for i, (tok, tgt) in enumerate(batches):
        for r in (0, 1):
            rows = [4 * k + 2 * r + j for k in (0, 1) for j in (0, 1)]
            data[f"tok{i}_rank{r}"] = tok[rows]
            data[f"tgt{i}_rank{r}"] = tgt[rows]
    np.savez(tmp_path / "in.npz", **data)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(tmp_path / "in.npz"),
             json.dumps(DIMS), str(tmp_path / f"out{r}.npz")],
            env=_env(**{
                "DLROVER_TPU_COORDINATOR_ADDR": f"127.0.0.1:{port}",
                "DLROVER_TPU_NUM_PROCESSES": "2",
                "DLROVER_TPU_PROCESS_ID": str(r),
                "LOCAL_RANK": str(r),
            }),
            stderr=subprocess.PIPE, text=True,
        )
        for r in (0, 1)
    ]
    mesh = build_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    jopt = optax.adamw(3e-4, weight_decay=0.1)
    jtr = jet.ElasticTrainer(
        mesh, lambda p, a, b: jgpt.loss_fn_fused(p, a, b, jcfg), jopt,
        global_batch_size=8, micro_batch_size=2, donate_state=False,
    )
    jstate = jopt.init(jp)
    jlosses = []
    for tok, tgt in batches:
        jp, jstate, loss = jtr.train_step(jp, jstate, tok, tgt)
        jlosses.append(float(loss))
    for p in procs:
        _, err = p.communicate(timeout=LAUNCH_TIMEOUT)
        assert p.returncode == 0, err[-3000:]
    outs = [np.load(tmp_path / f"out{r}.npz") for r in (0, 1)]
    assert int(outs[0]["shards"]) == jtr.num_shards == 2
    assert int(outs[0]["accum"]) == jtr.accum_steps == 2
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=1e-5)
    want = {n: np.asarray(x) for n, x in flatten_named(
        jax.tree.map(np.asarray, jp))}
    for name, ref in want.items():
        key = "p|" + name.replace("/", "|")
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
        err = np.max(np.abs(outs[0][key] - ref))
        assert err <= 1e-5 * max(1.0, np.max(np.abs(ref))), (name, err)


# -- units ---------------------------------------------------------------------


def _agent_env(monkeypatch, **env):
    for var in ("DLROVER_TPU_COORDINATOR_ADDR", "DLROVER_TPU_AGENT_PRESENT",
                "DLROVER_TPU_FLIGHT_RECORDER"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_torch_env_joins_a_gloo_world_of_one(monkeypatch):
    _agent_env(
        monkeypatch,
        DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
        DLROVER_TPU_NUM_PROCESSES="1", DLROVER_TPU_PROCESS_ID="0",
        DLROVER_TPU_RESTART_COUNT="2", LOCAL_RANK="0",
    )
    assert torch_env.num_processes() == 1 and torch_env.process_id() == 0
    assert torch_env.restart_count() == 2
    dev = torch_env.setup_distributed("cpu")
    try:
        assert dev == torch.device("cpu")
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_rank() == 0
        x = torch.ones(3)
        torch.distributed.all_reduce(x)
        assert torch.equal(x, torch.ones(3))
    finally:
        torch_env.teardown_distributed()
    assert not torch.distributed.is_initialized()


def test_torch_env_maps_the_card_to_nccl(monkeypatch):
    _agent_env(
        monkeypatch, DLROVER_TPU_COORDINATOR_ADDR="10.0.0.1:29500",
        DLROVER_TPU_NUM_PROCESSES="4", DLROVER_TPU_PROCESS_ID="3",
        LOCAL_RANK="1",
    )
    calls = {}
    monkeypatch.setattr(torch_env, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("set_device", d))
    monkeypatch.setattr(
        torch.distributed, "init_process_group",
        lambda backend, **kw: calls.update(backend=backend, **kw),
    )
    try:
        dev = torch_env.setup_distributed()
    finally:
        torch_env._initialized = False
    assert dev == torch.device("cuda", 1) == calls["set_device"]
    assert calls["backend"] == "nccl"
    assert calls["init_method"] == "tcp://10.0.0.1:29500"
    assert (calls["world_size"], calls["rank"]) == (4, 3)
    assert calls["device_id"] == torch.device("cuda", 1)


def test_torch_env_without_agent_stays_one_process(monkeypatch):
    _agent_env(monkeypatch)
    assert torch_env.setup_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_one_process_run_writes_no_agent_files(monkeypatch, tmp_path):
    """Outside the launcher the example writes neither the agent's step
    metrics (whose default path is shared) nor phase marks."""
    from dlrover_tpu_torch.agent import monitor

    _agent_env(
        monkeypatch, DLROVER_TPU_JOB_NAME=f"t{uuid.uuid4().hex[:10]}",
        DLROVER_TPU_PHASES_FILE=str(tmp_path / "phases.json"),
    )
    monkeypatch.delenv(monitor.METRICS_FILE_ENV, raising=False)
    out = train.run(train.parse_args(
        ["--smoke", "--device", "cpu", "--steps", "1"]))
    assert out["finite"] and len(out["losses"]) == 1
    assert not os.path.exists(monitor.default_metrics_file())
    assert not (tmp_path / "phases.json").exists()


def test_first_step_probe_profiles_a_run(capsys):
    from dlrover_tpu_torch.tools import first_step

    rc = first_step.main(
        ["--top", "5", "--", "--smoke", "--device", "cpu", "--steps", "2"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "# first_step: " in text and "step_s [" in text
    for window in ("imports", "set-up", "step 1", "step 2"):
        assert f"# first_step {window} (" in text
    assert "#   leaf " in text and "#   port " in text


class FakeClient:
    """The master client calls the rendezvous makes, over one dict."""

    def __init__(self, node_rank, kv):
        self.node_rank, self.kv = node_rank, kv

    def kv_set(self, key, value):
        self.kv[key] = value

    def kv_wait(self, key, timeout):
        return self.kv[key]


def test_process_ids_count_lower_ranked_nodes():
    kv = {}
    world = {0: 2, 1: 2}
    specs = [
        tagent.MasterRendezvousHandler(FakeClient(r, kv), 2)._build_spec(
            3, 0, world)
        for r in (0, 1)
    ]
    assert [s.process_id for s in specs] == [0, 2]
    assert [s.num_processes for s in specs] == [4, 4]
    assert [s.node_rank for s in specs] == [0, 1]
    assert specs[0].coordinator == specs[1].coordinator != ""


class FakeProc:
    def __init__(self, cmd, env, stderr):
        self.env, self.stderr, self.code = env, io.BytesIO(b""), None

    def poll(self):
        return self.code


def test_agent_spawns_one_trainer_per_local_rank(monkeypatch):
    spawned = []

    def popen(cmd, env, stderr):
        spawned.append(FakeProc(cmd, env, stderr))
        return spawned[-1]

    monkeypatch.setattr(tagent.subprocess, "Popen", popen)
    client = type("C", (), {"_client": type("R", (), {"addr": "m:1"})()})()
    agent = tagent.ElasticAgent(
        tagent.AgentConfig(node_id=1, local_world_size=2), ["trainer"],
        client=client,
    )
    spec = tagent.WorldSpec(round=1, group=0, world={0: 2, 1: 2},
                            node_world_size=2, node_rank=1, process_id=2,
                            num_processes=4, coordinator="10.0.0.1:29500")
    agent._spawn(spec)
    envs = [p.env for p in spawned]
    assert [e["RANK"] for e in envs] == ["2", "3"]
    assert [e["DLROVER_TPU_PROCESS_ID"] for e in envs] == ["2", "3"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1"]
    for e in envs:
        assert e["WORLD_SIZE"] == e["DLROVER_TPU_NUM_PROCESSES"] == "4"
        assert (e["MASTER_ADDR"], e["MASTER_PORT"]) == ("10.0.0.1", "29500")
        assert e["DLROVER_TPU_COORDINATOR_ADDR"] == "10.0.0.1:29500"
        assert e["LOCAL_WORLD_SIZE"] == "2"
    # watched as a group: running, one failure, all done
    assert agent._group_exit() is None
    spawned[0].code = 0
    assert agent._group_exit() is None
    spawned[1].code = -9
    assert agent._group_exit() == -9
    spawned[1].code = 0
    assert agent._group_exit() == 0
    agent._join_stderr_pump()


def test_agent_wakes_when_a_trainer_fails_not_when_one_finishes():
    agent = tagent.ElasticAgent(
        tagent.AgentConfig(local_world_size=2), ["trainer"],
        client=object(),
    )
    done, running = FakeProc(None, None, None), FakeProc(None, None, None)
    done.code = 0
    agent._procs = [done, running]
    t0 = time.monotonic()
    agent._wait_for_exit(0.3)
    assert time.monotonic() - t0 >= 0.3  # a clean exit waits for the rest
    running.code = -9
    t0 = time.monotonic()
    agent._wait_for_exit(5.0)
    assert time.monotonic() - t0 < 1.0


def test_launcher_counts_gpus_and_refuses_a_quiet_cpu_world(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="no CUDA device"):
        elastic_run._local_process_count(["--smoke"])
    assert elastic_run._local_process_count(["--device", "cpu"]) == 1
    assert elastic_run._local_process_count(["--device=cpu"]) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert elastic_run._local_process_count(["--smoke"]) == 4
