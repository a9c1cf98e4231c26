"""The port's GLM family and prefix-LM attention against the JAX
package's, on the CPU.

* ``prefix_lm_attention`` (a non-causal flash call on the prefix and a
  causal rectangular call of the suffix at ``q_offset = p``; on the CPU
  the flash wrappers run their plain versions) at p in {0, 1, t/2,
  t - 1, t}: output against JAX's composition in Pallas interpret mode
  and its dense reference, the port's own reference against JAX's, and
  the gradient of q, k and v against JAX's (the prefix keys' dK and dV
  add up over the two calls).
* ``glm.tiny()`` from the JAX init (q/k/v biases made random):
  ``prefix_lm_forward``, ``prefix_lm_loss_fn`` and every gradient leaf,
  through the composition and through the dense reference; the
  empty-band error; the generation prefill (bidirectional) against
  ``prefix_lm_forward``'s last position and JAX's prefill, and a
  causal prefill that must differ; presets, the mesh refusal.
* ``examples/glm_infill/train.py --smoke`` under the port's
  ``elastic_run --standalone`` with two gloo workers: both ranks report
  one loss at every step, equal to a one-process run's within 1e-5, and
  no process of the launch loads a module of jax or of the JAX package
  (the same import audit ``chip_smoke.py`` installs).

Tolerances, on the largest difference over max(1, the largest value):
f32 1e-5 (the same f32 arithmetic in another order), the gradients
against Pallas interpret mode 1e-4 (its blockwise online softmax
accumulates in another order).
"""

import dataclasses
import importlib
import os
import pathlib
import re
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.common.tree import tree_leaves
from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import generate as tgen
from dlrover_tpu_torch.models import glm as tglm
from dlrover_tpu_torch.ops import prefix_lm as tpl
from dlrover_tpu_torch.trainer.step import value_and_grad

jglm = importlib.import_module("dlrover_tpu.models.glm")
jgen = importlib.import_module("dlrover_tpu.models.generate")
jpl = importlib.import_module("dlrover_tpu.ops.prefix_lm")

REPO = pathlib.Path(__file__).resolve().parent.parent
F32_TOL = 1e-5
T = 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _qkv(seed, b=2, t=T, h=4, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


PREFIXES = [0, 1, T // 2, T - 1, T]


@pytest.mark.parametrize("p", PREFIXES)
def test_prefix_attention_matches_jax(p):
    q, k, v = _qkv(p)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    got = tpl.prefix_lm_attention(tq, tk, tv, p)
    _close(got, jpl.prefix_lm_attention(q, k, v, p, interpret=True),
           F32_TOL, "vs JAX interpret")
    ref = jpl.prefix_lm_attention_reference(q, k, v, p)
    _close(got, ref, F32_TOL, "vs JAX reference")
    _close(tpl.prefix_lm_attention_reference(tq, tk, tv, p), ref,
           F32_TOL, "reference vs JAX reference")
    # prefix rows see the whole prefix, suffix rows are causal
    if 0 < p < T:
        v2 = tv.clone()
        v2[:, p - 1] += 1.0  # the last prefix key: every row sees it
        moved = (tpl.prefix_lm_attention(tq, tk, v2, p) - got).abs()
        assert moved.amax((0, 2, 3)).min() > 0
    if p < T:
        v2 = tv.clone()
        v2[:, p] += 1.0  # the first suffix key: rows from p on see it
        moved = (tpl.prefix_lm_attention(tq, tk, v2, p) - got).abs()
        moved = moved.amax((0, 2, 3))
        assert moved[p:].min() > 0
        if p:
            assert moved[:p].max() == 0


@pytest.mark.parametrize("p", [0, 1, 16, 31, 32])
def test_prefix_attention_gradient_matches_jax(p):
    q, k, v = _qkv(10 + p, b=1, t=32, h=2, d=8)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def jf(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) * w)

    jref = jax.grad(
        jf(lambda q, k, v: jpl.prefix_lm_attention_reference(q, k, v, p)),
        argnums=(0, 1, 2),
    )(q, k, v)
    tg = value_and_grad(
        lambda t: (tpl.prefix_lm_attention(t["q"], t["k"], t["v"], p)
                   * torch.tensor(w)).sum()
    )({n: torch.tensor(x) for n, x in zip("qkv", (q, k, v))})[1]
    for n, j in zip("qkv", jref):
        _close(tg[n], j, F32_TOL, f"d{n} vs JAX reference")
    if p in (1, 16):
        jint = jax.grad(
            jf(lambda q, k, v: jpl.prefix_lm_attention(
                q, k, v, p, interpret=True)),
            argnums=(0, 1, 2),
        )(q, k, v)
        for n, j in zip("qkv", jint):
            _close(tg[n], j, 1e-4, f"d{n} vs JAX interpret")


def test_prefix_attention_refuses_bad_input():
    q, k, v = (torch.tensor(x) for x in _qkv(0))
    with pytest.raises(ValueError, match="outside"):
        tpl.prefix_lm_attention(q, k, v, T + 1)
    with pytest.raises(NotImplementedError, match="tiles"):
        tpl.prefix_lm_attention(q, k, v, 8, attn_blocks=(64, 64, 64, 64))


def _model(seed=0, **kw):
    jcfg = jglm.tiny(**kw)
    tcfg = tglm.tiny(**kw)
    jp = jglm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for n in ("bq", "bk", "bv"):  # zero at init: make them reach outputs
        leaf = jp["blocks"][n]
        jp["blocks"][n] = jnp.asarray(
            rng.standard_normal(leaf.shape) * 0.1, leaf.dtype
        )
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok = rng.integers(8, jcfg.vocab_size, (2, jcfg.block_size))
    return jcfg, tcfg, jp, tp, tok.astype(np.int32)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("p", [0, 17, 40, 62])
def test_prefix_lm_loss_and_gradients_match_jax(p, flash):
    """The loss band [max(p - 1, 0), T - 1) and every gradient leaf,
    through the flash composition (its plain versions here) and through
    the dense reference, against JAX's dense path."""
    jcfg, tcfg, jp, tp, tok = _model(
        seed=p, use_flash_attention=flash, use_fused_norm=flash
    )
    jcfg = dataclasses.replace(jcfg, use_flash_attention=False,
                               use_fused_norm=False)
    tgt = np.roll(tok, -1, axis=1)
    ttok, ttgt = torch.tensor(tok).long(), torch.tensor(tgt).long()
    _close(tglm.prefix_lm_forward(tp, ttok, tcfg, p),
           jglm.prefix_lm_forward(jp, tok, jcfg, p), F32_TOL, "logits")
    jl, jg = jax.value_and_grad(jglm.prefix_lm_loss_fn)(
        jp, tok, tgt, jcfg, p
    )
    tl, tg = value_and_grad(
        lambda pp, a, b: tglm.prefix_lm_loss_fn(pp, a, b, tcfg, p)
    )(tp, ttok, ttgt)
    _close(tl, jl, F32_TOL, "loss")
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 15
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        _close(t, j, F32_TOL, f"grad leaf {i}")


def test_loss_scores_only_the_suffix_band():
    """Targets outside the band [p - 1, T - 1) do not move the loss;
    one inside does."""
    _, tcfg, _, tp, tok = _model(seed=1)
    tok = torch.tensor(tok).long()
    tgt = torch.roll(tok, -1, 1)
    base = tglm.prefix_lm_loss_fn(tp, tok, tgt, tcfg, 40)
    for pos, moves in ((38, False), (63, False), (39, True), (62, True)):
        t2 = tgt.clone()
        t2[:, pos] = (t2[:, pos] + 1) % tcfg.vocab_size
        changed = tglm.prefix_lm_loss_fn(tp, tok, t2, tcfg, 40) != base
        assert bool(changed) == moves, pos


def test_empty_band_raises_as_jax():
    jcfg, tcfg, jp, tp, tok = _model()
    for p, t in ((T, T), (0, 1)):  # band [max(p - 1, 0), t - 1) empty
        with pytest.raises(ValueError, match="no supervised positions"):
            jglm.prefix_lm_loss_fn(jp, tok[:, :t], tok[:, :t], jcfg, p)
        tok_t = torch.tensor(tok[:, :t]).long()
        with pytest.raises(ValueError, match="no supervised positions"):
            tglm.prefix_lm_loss_fn(tp, tok_t, tok_t, tcfg, p)
    # p = T - 1 leaves the one position T - 2
    tok_t = torch.tensor(tok).long()
    assert torch.isfinite(
        tglm.prefix_lm_loss_fn(tp, tok_t, tok_t, tcfg, T - 1)
    )


def test_generation_prefill_matches_prefix_forward_and_jax():
    """GLM generation prefills the prompt bidirectionally: its last
    logits equal ``prefix_lm_forward`` with the whole prompt as prefix,
    and JAX's bidirectional prefill; a causal prefill differs."""
    jcfg, tcfg, jp, tp, tok = _model(seed=7)
    t0 = 24
    prompt = tok[:, :t0]
    want = tglm.prefix_lm_forward(
        tp, torch.tensor(prompt).long(),
        dataclasses.replace(tcfg, block_size=t0), prefix_len=t0,
    )[:, -1]
    cache = tgen._cache_for(tcfg, 2, t0, tcfg.n_kv_head, "cpu")
    assert tcfg.prefix_lm
    got, _ = tgen.llama_prefill(
        tp, cache, torch.tensor(prompt).long(), tcfg, causal=False
    )
    _close(got, want, F32_TOL, "prefill vs prefix forward")
    jcache = jgen._cache_for(jcfg, 2, t0, jcfg.n_kv_head)
    jgot, _ = jgen.llama_prefill(jp, jcache, prompt, jcfg, causal=False)
    _close(got, jgot, F32_TOL, "prefill vs JAX")
    wrong, _ = tgen.llama_prefill(
        tp, tgen._cache_for(tcfg, 2, t0, tcfg.n_kv_head, "cpu"),
        torch.tensor(prompt).long(), tcfg, causal=True,
    )
    assert (wrong - want).abs().max() > 1e-3


def test_the_card_path_takes_the_flash_composition(monkeypatch):
    """For a CUDA device, ChatGLM3's attention is the composition: one
    non-causal ``flash_attention`` on the prefix square and one causal
    ``flash_attention_rect`` at ``q_offset = p`` (the wrappers then
    launch K1/K2 or raise, tests/test_torch_isolation.py), never the
    dense reference; BERT-large's is the non-causal flash call."""
    from dlrover_tpu_torch.models import bert as tbert
    from dlrover_tpu_torch.models import gpt as tgpt

    calls = []
    monkeypatch.setattr(tpl, "flash_attention", lambda q, k, v, **kw: (
        calls.append(("square", q.shape[1], k.shape[1], kw)) or q))
    monkeypatch.setattr(tpl, "flash_attention_rect", lambda q, k, v, **kw: (
        calls.append(("rect", q.shape[1], k.shape[1], kw)) or q))

    def dense(*a):
        raise AssertionError("the card path reached the dense reference")

    monkeypatch.setattr(tpl, "prefix_lm_attention_reference", dense)
    monkeypatch.setattr(tglm, "prefix_lm_attention_reference", dense)
    attn = tglm.prefix_attention_for(tglm.chatglm3_6b(), 1000, device="cuda")
    q = torch.zeros(1, 2048, 1, 8)
    assert attn(q, q, q).shape == q.shape
    assert calls == [
        ("square", 1000, 1000, dict(causal=False, scale=None)),
        ("rect", 1048, 2048, dict(causal=True, q_offset=1000, scale=None)),
    ]
    fn = tgpt.default_attention_for(tbert.bert_large(), "cuda")
    assert fn.func is tgpt.flash_attention and fn.keywords["causal"] is False


def test_presets_and_mesh_refusal():
    for name in ("chatglm2_6b", "chatglm3_6b", "tiny"):
        j, t = getattr(jglm, name)(), getattr(tglm, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(j, f.name) == getattr(t, f.name), (name, f)
    c3 = tglm.chatglm3_6b()
    assert c3.block_size == 8192 and c3.n_kv_head == 2 and c3.qkv_bias

    class Mesh:
        shape = {"data": 1, "seq": 2}

    with pytest.raises(NotImplementedError, match="item 6"):
        tglm.prefix_attention_for(c3, 16, mesh=Mesh())
    Mesh.shape = {"data": 2, "seq": 1}
    tglm.prefix_attention_for(c3, 16, mesh=Mesh(), device="cpu")


def test_glm_infill_example_under_the_elastic_launcher(tmp_path):
    from chip_smoke import IMPORT_AUDIT
    from dlrover_tpu_torch.examples.glm_infill import train

    audit = tmp_path / "audit"
    audit.mkdir()
    (audit / "sitecustomize.py").write_text(IMPORT_AUDIT)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(audit), str(REPO)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    env["DLROVER_TPU_JOB_NAME"] = f"g{uuid.uuid4().hex[:10]}"
    for var in ("DLROVER_TPU_AGENT_PRESENT", "DLROVER_TPU_MASTER_ADDR"):
        env.pop(var, None)
    args = ["--smoke", "--device", "cpu", "--steps", "4"]
    out = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.elastic_run",
         "--standalone", "--nproc_per_node", "2",
         "-m", "dlrover_tpu_torch.examples.glm_infill.train", "--", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    losses = {}
    for m in re.finditer(r"step (\d+): loss (\S+) rank (\d+)", out.stdout):
        losses.setdefault(int(m[3]), []).append(float(m[2]))
    assert sorted(losses) == [0, 1] and losses[0] == losses[1]
    assert len(losses[0]) == 4
    one = train.run(train.parse_args(args))
    np.testing.assert_allclose(losses[0], one["losses"], rtol=0, atol=1e-5)
    audited = set(re.findall(r"IMPORT_AUDIT_ON (\d+)", out.stderr))
    assert len(audited) >= 3, out.stderr[-2000:]  # launcher, 2 trainers
    loaded = re.findall(r"IMPORT_AUDIT_LOADED \d+ (\S+)", out.stderr)
    assert not loaded, loaded
    assert "greedy infill accuracy" in out.stdout
