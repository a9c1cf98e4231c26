"""The port's serving engine against the JAX package's, on the CPU.

``dlrover_tpu_torch/serving/scheduler.py``'s
``ContinuousBatchingScheduler`` runs the same requests as
``dlrover_tpu/serving/scheduler.py``'s on the same tiny Llama (JAX init
from one seed, carried over by ``models/convert.py``): staggered
admission, preemption under a starved block budget and the
disaggregated prefill -> decode pipeline give the JAX scheduler's greedy
tokens exactly. The engine cases of the JAX serving tests are held to
the port's own ``generate.generate`` (itself held to JAX's in
``test_torch_generate.py``): a prefill spanning decode ticks, the padded
final chunk at the cache's end, the prefill budget, EOS, drain, roles,
handoff block-budget gating.

Also: the handoff wire form with a bf16 cache (export, pack, unpack and
install bitwise, JAX <-> port both ways, no ``ml_dtypes``), an AST audit
that the decode and prefill programs hold no host sync and the ticks
exactly one device-to-host copy each, and ``replica.main`` on the CPU
answering requests from an in-process port ``JobMaster``. No wall-clock
limit is asserted.
"""

import ast
import dataclasses
import importlib
import inspect
import pathlib
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import generate as tgen
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import handoff as thandoff
from dlrover_tpu_torch.serving import replica as treplica
from dlrover_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    ServeRequest,
)

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
jllama = importlib.import_module("dlrover_tpu.models.llama")
jgen = importlib.import_module("dlrover_tpu.models.generate")
jsched = importlib.import_module("dlrover_tpu.serving.scheduler")
jhandoff = importlib.import_module("dlrover_tpu.serving.handoff")


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, port cfg, JAX cfg): the tiny Llama of
    the JAX serving tests (GQA on), seed 7."""
    jcfg = jllama.LlamaConfig.tiny()
    jp = jllama.init_params(jax.random.PRNGKey(7), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp, tllama.LlamaConfig.tiny(), jcfg


def _greedy(tp, cfg, prompt, max_new):
    out = tgen.generate(
        tp, cfg, torch.tensor([prompt]).long(), max_new_tokens=max_new,
        temperature=0.0,
    )
    return out[0, len(prompt):].tolist()


def _requests(seed, n, lo=3, hi=12, max_new=6, cls=ServeRequest):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(lo, hi))
        prompt = rng.integers(0, 256, size=plen).tolist()
        out.append(cls(request_id=f"r{i}", prompt=prompt,
                       max_new_tokens=max_new))
    return out


def _run(sched, reqs, steps=300):
    for r in reqs:
        assert sched.submit(r)
    done = {}
    for _ in range(steps):
        for c in sched.step():
            done[c.request_id] = c
        if len(done) == len(reqs):
            break
    assert len(done) == len(reqs)
    return done


def _both(model, reqs_seed, n, max_new=6, **kw):
    """The same requests through the JAX and the port scheduler."""
    jp, tp, cfg, jcfg = model
    want = _run(
        jsched.ContinuousBatchingScheduler(jp, jcfg, **kw),
        _requests(reqs_seed, n, max_new=max_new, cls=jsched.ServeRequest),
    )
    sched = ContinuousBatchingScheduler(tp, cfg, **kw)
    got = _run(sched, _requests(reqs_seed, n, max_new=max_new))
    return want, got, sched


def test_staggered_admission_matches_the_jax_scheduler(model):
    want, got, sched = _both(
        model, 0, 6, lanes=3, block_size=4, prefill_chunk=4, max_len=32
    )
    for rid, c in got.items():
        assert c.tokens == want[rid].tokens, rid
        assert c.finish_reason == "length"
    _, tp, cfg, _ = model
    r = _requests(0, 6)[5]
    assert got["r5"].tokens == _greedy(tp, cfg, r.prompt, 6)
    stats = sched.stats()
    assert stats["completed_total"] == 6
    assert stats["kv"]["blocks_in_use"] == 0
    assert stats["ttft_p99_s"] > 0


def test_preemption_recomputes_the_jax_schedulers_tokens(model):
    want, got, sched = _both(
        model, 3, 2, max_new=8, lanes=2, block_size=4, prefill_chunk=4,
        max_len=32, total_blocks=6,
    )
    assert sched.stats()["preempted_total"] >= 1
    for rid, c in got.items():
        assert c.tokens == want[rid].tokens, rid


def test_prefill_spanning_decode_ticks_not_clobbered(model):
    """While one lane decodes, another lane's chunked prefill spans
    several steps; the decode step's masked write must leave the
    prefilling lane alone."""
    _, tp, cfg, _ = model
    sched = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=4, prefill_chunk=4,
        prefill_budget=4, max_len=32,
    )
    rng = np.random.default_rng(9)
    reqs = [
        ServeRequest(request_id="short", prompt=[1, 2, 3],
                     max_new_tokens=8),
        ServeRequest(request_id="long",
                     prompt=rng.integers(0, 256, size=12).tolist(),
                     max_new_tokens=4),
    ]
    done = _run(sched, reqs, steps=100)
    for r in reqs:
        assert done[r.request_id].tokens == _greedy(
            tp, cfg, r.prompt, r.max_new_tokens
        ), r.request_id


def test_padded_final_chunk_at_cache_end(model):
    """max_len 24 is no multiple of the 16-token chunk: the prompt's
    padded final chunk [16, 32) crosses max_len, so the physical cache
    carries chunk-multiple slack (a slice past its end would raise)."""
    _, tp, cfg, _ = model
    sched = ContinuousBatchingScheduler(
        tp, cfg, lanes=1, block_size=4, prefill_chunk=16, max_len=24,
    )
    assert sched._cache.k.shape[2] == 32
    prompt = np.random.default_rng(21).integers(0, 256, size=20).tolist()
    done = _run(sched, [ServeRequest(request_id="edge", prompt=prompt,
                                     max_new_tokens=4)], steps=60)
    assert done["edge"].tokens == _greedy(tp, cfg, prompt, 4)


def test_admission_bounded_by_lanes(model):
    _, tp, cfg, _ = model
    sched = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=8, prefill_chunk=8, max_len=32,
    )
    for i in range(5):
        sched.submit(ServeRequest(request_id=f"q{i}", prompt=[1, 2, 3],
                                  max_new_tokens=4))
    sched.step()
    assert sched.active() <= 2
    assert sched.queue_depth() == 3


def test_prefill_budget_protects_decode(model):
    _, tp, cfg, _ = model
    sched = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=8, prefill_chunk=4,
        prefill_budget=4, max_len=48,
    )
    sched.submit(ServeRequest(request_id="long",
                              prompt=list(range(1, 17)), max_new_tokens=2))
    sched.step()
    seq = next(iter(sched._by_lane.values()))
    assert seq.phase == "prefill" and seq.prefilled == 4
    for _ in range(3):
        sched.step()
    assert (
        not sched._by_lane
        or next(iter(sched._by_lane.values())).phase == "decode"
    )


def test_bad_requests_eos_duplicates_and_drain(model):
    _, tp, cfg, _ = model
    sched = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=8, max_len=16,
    )
    for rid, prompt, new in (("big", [1] * 12, 8), ("empty", [], 4),
                             ("zero", [1, 2], 0)):
        sched.submit(ServeRequest(request_id=rid, prompt=prompt,
                                  max_new_tokens=new))
    failed = {c.request_id: c for c in sched.step()}
    assert failed["big"].error and failed["empty"].error
    assert "max_new_tokens" in failed["zero"].error
    assert sched.stats()["failed_total"] == 3
    # EOS: the third greedy token ends the request
    prompt = [5, 6, 7]
    ref = _greedy(tp, cfg, prompt, 8)
    eos = ContinuousBatchingScheduler(
        tp, cfg, lanes=1, block_size=8, max_len=32, eos_id=ref[2]
    )
    done = _run(eos, [ServeRequest(request_id="e", prompt=prompt,
                                   max_new_tokens=8)], steps=50)
    assert done["e"].tokens == ref[:3]
    assert done["e"].finish_reason == "eos"
    # a duplicate of a resident request is dropped, not re-admitted
    dup = ServeRequest(request_id="dup", prompt=[1, 2, 3],
                       max_new_tokens=6)
    sched = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=8, max_len=32,
    )
    assert sched.submit(dup)
    sched.step()
    assert sched.submit(dup) and sched.queue_depth() == 0
    out = []
    for _ in range(30):
        out.extend(sched.step())
        if out:
            break
    assert [c.request_id for c in out] == ["dup"]
    assert out[0].tokens == _greedy(tp, cfg, dup.prompt, 6)
    # drain hands back every unfinished request
    sched = ContinuousBatchingScheduler(
        tp, cfg, lanes=1, block_size=8, max_len=32,
    )
    for i in range(3):
        sched.submit(ServeRequest(request_id=f"d{i}", prompt=[1, 2, 3],
                                  max_new_tokens=16))
    sched.step()
    assert sorted(r.request_id for r in sched.drain()) == ["d0", "d1", "d2"]
    assert sched.active() == 0 and sched.pool.blocks_in_use() == 0


def test_sampled_tokens_repeat_under_the_schedulers_seed(model):
    _, tp, cfg, _ = model

    def run():
        sched = ContinuousBatchingScheduler(
            tp, cfg, lanes=2, block_size=4, prefill_chunk=4, max_len=32,
        )
        reqs = _requests(4, 3, max_new=6)
        for r in reqs:
            r.temperature = 0.8
        return {k: c.tokens for k, c in _run(sched, reqs).items()}

    a = run()
    assert a == run()
    assert all(len(t) == 6 and max(t) < cfg.vocab_size for t in a.values())


def test_sample_host_equals_the_jax_schedulers(model):
    rng = np.random.default_rng(0)
    for temp in (0.0, 0.7, 1.3):
        logits = rng.standard_normal(256).astype(np.float32)
        req = ServeRequest(request_id=f"t{temp}", prompt=[1],
                           temperature=temp)
        jreq = jsched.ServeRequest(request_id=f"t{temp}", prompt=[1],
                                   temperature=temp)
        assert ContinuousBatchingScheduler._sample_host(
            req, logits
        ) == jsched.ContinuousBatchingScheduler._sample_host(jreq, logits)


def test_roles(model):
    _, tp, cfg, _ = model
    with pytest.raises(ValueError, match="role"):
        ContinuousBatchingScheduler(tp, cfg, lanes=1, role="turbo")
    dec = ContinuousBatchingScheduler(
        tp, cfg, lanes=1, block_size=8, max_len=32, role="decode",
    )
    dec.submit(ServeRequest(request_id="raw", prompt=[1, 2],
                            max_new_tokens=4))
    assert "cannot prefill" in {
        c.request_id: c for c in dec.step()
    }["raw"].error
    with pytest.raises(ValueError, match="prefill-role"):
        ContinuousBatchingScheduler(
            tp, cfg, lanes=1, block_size=8, max_len=32, role="prefill",
        ).submit_handoff(object())


def test_disaggregated_pipeline_bitwise_equals_colocated(model):
    """A prefill-role scheduler exports KV handoffs through the wire
    form, a decode-role one (another block size) imports them; every
    greedy continuation equals the JAX scheduler's colocated tokens,
    and max_new_tokens=1 finishes on the prefill side."""
    jp, tp, cfg, jcfg = model
    want = _run(
        jsched.ContinuousBatchingScheduler(
            jp, jcfg, lanes=2, block_size=4, prefill_chunk=4, max_len=32
        ),
        _requests(5, 4, cls=jsched.ServeRequest),
    )
    pre = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=4, prefill_chunk=4, max_len=32,
        role="prefill",
    )
    dec = ContinuousBatchingScheduler(
        tp, cfg, lanes=3, block_size=8, prefill_chunk=8, max_len=32,
        role="decode",
    )
    reqs = _requests(5, 4)
    one = ServeRequest(request_id="one", prompt=[3, 1, 4], max_new_tokens=1)
    for r in reqs + [one]:
        assert pre.submit(r)
    done = {}
    for _ in range(400):
        for c in pre.step():
            if c.finish_reason == "handoff":
                wire = thandoff.pack(c.handoff)
                assert dec.submit_handoff(thandoff.unpack(wire))
            else:
                done[c.request_id] = c
        for c in dec.step():
            done[c.request_id] = c
        if len(done) == len(reqs) + 1:
            break
    assert done["one"].finish_reason == "length"
    assert done["one"].tokens == _greedy(tp, cfg, one.prompt, 1)
    assert "handoff" not in done["one"].phases
    for r in reqs:
        assert done[r.request_id].tokens == want[r.request_id].tokens
        assert "handoff" in done[r.request_id].phases
    assert pre.stats()["handoffs_exported"] == len(reqs)
    assert dec.stats()["handoffs_imported"] == len(reqs)
    assert pre.pool.blocks_in_use() == 0 and dec.pool.blocks_in_use() == 0


def test_handoff_import_gates_on_block_budget(model):
    _, tp, cfg, _ = model
    dec = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=8, max_len=32, total_blocks=3,
        role="decode",
    )
    kv = np.zeros((cfg.n_layer, 16, cfg.n_kv_head, cfg.head_dim),
                  np.float32)

    def payload(rid, plen, max_new=4):
        return thandoff.HandoffPayload(
            request_id=rid, prompt=list(range(plen)),
            max_new_tokens=max_new, temperature=0.0, first_token=1,
            k=kv, v=kv,
        )

    assert dec.submit_handoff(payload("a", 14))  # 2 blocks
    assert dec.submit_handoff(payload("b", 14))  # budget-blocked
    dec.step()
    assert dec.active() == 1 and dec.queue_depth() == 1
    dec2 = ContinuousBatchingScheduler(
        tp, cfg, lanes=2, block_size=8, max_len=32, role="decode",
    )
    assert dec2.submit_handoff(payload("c", 14, max_new=32))
    failed = {c.request_id: c for c in dec2.step()}
    assert "exceeds replica capacity" in failed["c"].error
    dec3 = ContinuousBatchingScheduler(
        tp, cfg, lanes=1, block_size=8, max_len=32, role="decode",
    )
    dec3.submit_handoff(dataclasses.replace(
        payload("q", 3), temperature=0.5
    ))
    drained = dec3.drain()
    assert [(r.request_id, r.prompt, r.temperature) for r in drained] == [
        ("q", [0, 1, 2], 0.5)
    ]


# -- the bf16 handoff -------------------------------------------------------


def _bf16_cache(lanes=3, t=16, seed=0):
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.bfloat16)
    cache = tgen._cache_for(cfg, lanes, t, cfg.n_kv_head, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for buf in cache:
        buf.copy_(torch.randn(buf.shape, generator=gen))
    return cfg, cache


def _words(x) -> np.ndarray:
    """Raw 16-bit words of a bf16 tensor or ml_dtypes array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.ascontiguousarray(x).view(np.uint16)


def test_bf16_cache_exports_packs_and_unpacks_bitwise():
    """A bf16 cache exports (block-padded, a CPU copy), packs as raw
    words under "bfloat16" and unpacks bitwise (this raised
    ``TypeError: Got unsupported ScalarType BFloat16`` in np.asarray)."""
    _, cache = _bf16_cache()
    req = ServeRequest(request_id="h", prompt=[1, 2, 3, 4, 5],
                       max_new_tokens=4)
    payload = thandoff.export_handoff(cache, 1, 5, 4, req, 9)
    assert payload.k.shape == cache.k[:, 1, :8].shape
    assert payload.k.dtype == torch.bfloat16
    assert np.array_equal(_words(payload.k), _words(cache.k[:, 1, :8]))
    wire = thandoff.pack(payload)
    assert wire["k"]["dtype"] == "bfloat16"
    assert thandoff.payload_nbytes(wire) == payload.nbytes()
    back = thandoff.unpack(wire)
    assert back.k.dtype == torch.bfloat16
    assert np.array_equal(_words(back.k), _words(payload.k))
    assert np.array_equal(_words(back.v), _words(payload.v))
    assert (back.first_token, back.prompt) == (9, [1, 2, 3, 4, 5])


def test_bf16_wire_interop_with_the_jax_package():
    """JAX-packed bf16 KV unpacks in the port and installs into its
    cache bitwise; port-packed KV unpacks in JAX bitwise."""
    cfg, cache = _bf16_cache()
    rng = np.random.default_rng(3)
    shape = (cfg.n_layer, 8, cfg.n_kv_head, cfg.head_dim)
    jk = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    jv = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    jwire = jhandoff.pack(jhandoff.HandoffPayload(
        request_id="j", prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=3,
        temperature=0.0, first_token=7, k=np.asarray(jk), v=np.asarray(jv),
    ))
    got = thandoff.unpack(jwire)
    assert np.array_equal(_words(got.k), _words(np.asarray(jk)))
    assert np.array_equal(_words(got.v), _words(np.asarray(jv)))
    before = cache.k.clone()
    thandoff.make_install_fn()(cache, got.k, got.v, 2)
    assert np.array_equal(_words(cache.k[:, 2, :8]), _words(np.asarray(jk)))
    assert np.array_equal(_words(cache.v[:, 2, :8]), _words(np.asarray(jv)))
    assert torch.equal(cache.k[:, :2], before[:, :2])
    assert torch.equal(cache.k[:, 2, 8:], before[:, 2, 8:])
    # and back: the port's wire form unpacks in the JAX package
    twire = thandoff.pack(got)
    assert twire == {**jwire, "k": twire["k"], "v": twire["v"]}
    jback = jhandoff.unpack(twire)
    assert str(jback.k.dtype) == "bfloat16"
    assert np.array_equal(_words(jback.k), _words(np.asarray(jk)))
    assert np.array_equal(_words(jback.v), _words(np.asarray(jv)))


def test_bf16_unpack_needs_no_ml_dtypes(tmp_path):
    """In a process where ml_dtypes (and jax) cannot be imported, a
    JAX-packed bf16 payload still unpacks bitwise."""
    jk = np.asarray(jnp.asarray(
        np.random.default_rng(1).standard_normal((2, 4, 2, 16)),
        jnp.bfloat16,
    ))
    (tmp_path / "k.bin").write_bytes(jk.tobytes())
    np.save(tmp_path / "words.npy", _words(jk))
    code = f"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("ml_dtypes", "jax", "jaxlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
from dlrover_tpu_torch.serving import handoff
data = open({str(tmp_path / "k.bin")!r}, "rb").read()
arr = {{"dtype": "bfloat16", "shape": [2, 4, 2, 16], "data": data}}
t = handoff._unpack_array(arr)
want = np.load({str(tmp_path / "words.npy")!r})
assert t.dtype == torch.bfloat16
assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), want)
assert handoff._pack_array(t) == arr
assert "ml_dtypes" not in sys.modules
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- host syncs --------------------------------------------------------------

FORBIDDEN_CALLS = {"float", "bool"}
FORBIDDEN_ATTRS = {"item", "tolist", "cpu", "numpy", "asarray",
                   "synchronize", "device_get", "block_until_ready"}


def _calls(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def test_decode_and_prefill_programs_hold_no_host_sync():
    """The programs the serving loop launches (and the install a decode
    replica runs) contain no host sync: no float()/bool(), .item(),
    .tolist(), .cpu(), .numpy(), np.asarray or torch.cuda.synchronize.
    ``export_handoff``'s copy is the prefill role's product and stays
    outside, as in the JAX package."""
    for fn in (
        tgen.llama_decode_step_ragged, tgen.llama_lane_prefill_chunk,
        tgen._attend_cache, tgen._rect_attention_dense,
        tgen._rect_attention, tgen._ragged_mask, tgen._llama_block,
        tgen._llama_head,
        tgen._mm_f32, tgen._bmm_f32, tgen._layers,
        ContinuousBatchingScheduler._build_programs,
        thandoff.make_install_fn,
    ):
        for node in _calls(fn):
            f = node.func
            name = getattr(f, "id", None) or getattr(f, "attr", None)
            bad = (
                isinstance(f, ast.Name) and name in FORBIDDEN_CALLS
            ) or (isinstance(f, ast.Attribute) and name in FORBIDDEN_ATTRS)
            assert not bad, f"{fn.__qualname__}:{node.lineno}: {name}()"


def test_each_tick_copies_to_the_host_once():
    """The decode tick's one device-to-host copy is the sampled token
    vector; the prefill tick's is a finished prompt's logits row."""
    for fn in (ContinuousBatchingScheduler._decode_tick,
               ContinuousBatchingScheduler._prefill_tick):
        names = [
            getattr(n.func, "attr", None) or getattr(n.func, "id", None)
            for n in _calls(fn)
        ]
        assert names.count("cpu") == 1, fn.__name__
        assert not {"item", "tolist", "synchronize", "asarray"} & set(names)


# -- the replica -----------------------------------------------------------


def test_replica_main_on_the_cpu_answers_through_the_master(monkeypatch):
    """``replica.main([... "--device", "cpu"])`` registers with an
    in-process port ``JobMaster``, pulls two requests through its
    router and answers them with the tiny model's greedy tokens."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import JobMaster

    workers = []
    init = treplica.ReplicaWorker.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        workers.append(self)

    monkeypatch.setattr(treplica.ReplicaWorker, "__init__", record)
    master = JobMaster(
        port=0, node_num=1, rdzv_timeout=1.0, heartbeat_timeout=30.0,
        monitor_interval=0.5, collect_interval=999.0,
        health_interval=9999.0,
        remediation_config={"interval_s": 9999.0},
        serving_config={"progress_timeout_s": 30.0,
                        "scale_cooldown_s": 9999.0},
    )
    master.prepare()
    rc = []
    thread = threading.Thread(
        target=lambda: rc.append(treplica.main([
            "--master", master.addr, "--replica_id", "1", "--seed", "3",
            "--max_len", "32", "--device", "cpu",
            "--heartbeat_interval", "0.2", "--stats_interval", "0.2",
        ])),
        daemon=True,
    )
    client = MasterClient(master.addr, node_id=-1)
    try:
        thread.start()
        prompts = {"a": [5, 1, 7], "b": [9, 9, 2, 4, 8]}
        for rid, prompt in prompts.items():
            assert client.serve_submit(
                prompt, max_new_tokens=5, request_id=rid
            ).accepted
        deadline = time.monotonic() + 120
        while True:
            results = {r: client.serve_result(r) for r in prompts}
            if all(x.state in ("done", "failed") for x in results.values()):
                break
            assert time.monotonic() < deadline, results
            time.sleep(0.05)
        tp, cfg = treplica.build_tiny_model(3, block_size=64, device="cpu")
        for rid, prompt in prompts.items():
            assert results[rid].state == "done", results[rid]
            assert results[rid].finish_reason == "length"
            assert results[rid].tokens == _greedy(tp, cfg, prompt, 5)
    finally:
        for w in workers:
            w._stop.set()
        thread.join(timeout=20)
        client.close()
        master.stop()
    assert not thread.is_alive() and rc == [0]
    assert workers[0].scheduler._cache.k.device.type == "cpu"


def test_restart_in_place_frees_the_old_cache_first(model, monkeypatch):
    """restart_in_place drops the old scheduler before building the new
    one, so the two KV caches never coexist."""
    _, tp, cfg, _ = model
    worker = treplica.ReplicaWorker.__new__(treplica.ReplicaWorker)
    worker.params, worker.cfg = tp, cfg
    worker._sched_kwargs = dict(lanes=2, max_len=32, block_size=8)
    worker.scheduler = ContinuousBatchingScheduler(
        tp, cfg, **worker._sched_kwargs
    )
    worker.restarts, worker.replica_id, worker.node_id = 0, 0, 0
    worker._parked = True
    seen = []
    build = ContinuousBatchingScheduler.__init__

    def init(self, *a, **kw):
        seen.append(worker.scheduler)
        build(self, *a, **kw)

    monkeypatch.setattr(ContinuousBatchingScheduler, "__init__", init)
    monkeypatch.setattr(worker, "register", lambda: None, raising=False)
    worker.restart_in_place()
    assert seen == [None]
    assert worker.restarts == 1 and not worker._parked
