"""The port's KV-cache decoding against the JAX package's
(``dlrover_tpu_torch/models/generate.py`` vs ``dlrover_tpu/models/
generate.py``), at f32 smoke sizes on the CPU.

Weights come from the JAX init and reach the port through
``models/convert.params_from_jax``; a JAX ``KVCache`` crosses through
``convert.cache_from_jax``. Each case feeds the same seeded inputs to
both packages:

* cached decode (``decode_logits_sequential``) for GPT, Llama (GQA),
  windowed Mistral-tiny, Llama with experts (no-drop capacity) and GLM
  tiny, against JAX's and against the port's own training forward;
* greedy ``generate`` tokens equal to JAX's for each (GLM through its
  bidirectional prefill), and a sampled run that is repeatable under
  one generator seed;
* ``llama_prefill_chunked`` against JAX's and against one-shot prefill,
  plain and windowed; one-shot prefill with ``causal=False``;
* ``llama_lane_prefill_chunk`` with a padded final chunk into one lane
  of a shared cache, chunk by chunk;
* ``llama_decode_step_ragged`` started from a JAX-prefilled cache with
  lanes at different positions and inactive lanes, whose cache slots
  stay untouched.

Tolerance: logits and cache values within 1e-5 x max(1, max|JAX|)
(the same f32 arithmetic in another order; the port's Llama parity
tests measure ~3e-7). Tokens are equal. Against the port's own training
forward, the JAX tests' 2e-4 x max(1, max|logits|).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import convert
from dlrover_tpu_torch.models import generate as tgen
from dlrover_tpu_torch.models import glm as tglm
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tllama

jgen = importlib.import_module("dlrover_tpu.models.generate")
jglm = importlib.import_module("dlrover_tpu.models.glm")
jgpt = importlib.import_module("dlrover_tpu.models.gpt")
jllama = importlib.import_module("dlrover_tpu.models.llama")

F32_TOL = 1e-5
FORWARD_TOL = 2e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _to_port(jp):
    return convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _cache_to_port(jcache):
    return convert.cache_from_jax(
        jax.tree.map(np.asarray, jcache), device="cpu"
    )


def _gpt():
    kw = dict(
        vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
        remat=False, use_flash_attention=False,
    )
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **kw)
    tcfg = tgpt.GPTConfig(dtype=torch.float32, **kw)
    return jcfg, tcfg, jgpt.init_params(jax.random.PRNGKey(0), jcfg)


def _llama(**kw):
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), use_flash_attention=False, **kw
    )
    tcfg = dataclasses.replace(
        tllama.LlamaConfig.tiny(), use_flash_attention=False, **kw
    )
    return jcfg, tcfg, jllama.init_params(jax.random.PRNGKey(0), jcfg)


def _moe():
    """Llama with 4 experts, top-2, at the no-drop capacity factor
    (n_experts / top_k, what hf_convert gives a Mixtral): the training
    forward routes a whole sequence at once and a decode step one token
    a lane, so only a capacity that drops nothing makes them one
    function. The router is widened 50x so that no near-tie between
    two experts flips between the frameworks."""
    jcfg, tcfg, jp = _llama(n_experts=4, moe_capacity_factor=2.0)
    jp["blocks"]["moe"]["router"] = jp["blocks"]["moe"]["router"] * 50.0
    return jcfg, tcfg, jp


def _glm():
    """GLM tiny (q/k/v biases made random, half-dim rotary, GQA):
    generate prefills the prompt bidirectionally in both packages."""
    kw = dict(use_flash_attention=False)
    jcfg, tcfg = jglm.tiny(**kw), tglm.tiny(**kw)
    jp = jglm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    for n in ("bq", "bk", "bv"):
        leaf = jp["blocks"][n]
        jp["blocks"][n] = jnp.asarray(
            rng.standard_normal(leaf.shape) * 0.1, leaf.dtype
        )
    return jcfg, tcfg, jp


MODELS = {
    "gpt": _gpt,
    "llama_gqa": _llama,
    "mistral_window8": lambda: _llama(sliding_window=8, block_size=32),
    "llama_moe": _moe,
    "glm": _glm,
}
FORWARDS = {"gpt": tgpt.forward, "llama_gqa": tllama.forward,
            "mistral_window8": tllama.forward, "llama_moe": tllama.forward,
            "glm": tllama.forward}


def _tokens(vocab, b, t, seed=1, low=0):
    rng = np.random.default_rng(seed)
    return rng.integers(low, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_cached_decode_matches_jax_and_forward(model):
    jcfg, tcfg, jp = MODELS[model]()
    tp = _to_port(jp)
    t = 25 if model.startswith("mistral") else 16
    tok = _tokens(jcfg.vocab_size, 2, t, seed=8)
    got = tgen.decode_logits_sequential(tp, tcfg, torch.tensor(tok).long())
    want = jgen.decode_logits_sequential(jp, jcfg, jnp.asarray(tok))
    _close(got, want, F32_TOL, "decode logits vs JAX")
    _close(got, FORWARDS[model](tp, torch.tensor(tok).long(), tcfg),
           FORWARD_TOL, "decode logits vs the port's forward")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_greedy_generate_equals_jax(model):
    jcfg, tcfg, jp = MODELS[model]()
    tp = _to_port(jp)
    prompt = _tokens(jcfg.vocab_size, 2, 12)
    want = jgen.generate(jp, jcfg, jnp.asarray(prompt),
                         max_new_tokens=10, temperature=0.0)
    got = tgen.generate(tp, tcfg, torch.tensor(prompt).long(),
                        max_new_tokens=10, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_is_repeatable_under_one_seed():
    _, tcfg, jp = _llama()
    tp = _to_port(jp)
    prompt = torch.tensor(_tokens(tcfg.vocab_size, 2, 3)).long()

    def run(seed):
        return tgen.generate(
            tp, tcfg, prompt, max_new_tokens=5, temperature=1.0, top_k=8,
            generator=torch.Generator().manual_seed(seed),
        )

    a, b = run(7), run(7)
    assert torch.equal(a, b) and a.shape == (2, 8)
    assert int(a.max()) < tcfg.vocab_size
    assert torch.equal(a[:, :3], prompt)
    with pytest.raises(ValueError, match="exceeds block_size"):
        tgen.generate(tp, tcfg, torch.zeros(1, 60).long(), 10)


@pytest.mark.parametrize("window", [None, 8])
def test_chunked_prefill_matches_jax_and_one_shot(window):
    jcfg, tcfg, jp = _llama(sliding_window=window)
    tp = _to_port(jp)
    prompt = _tokens(jcfg.vocab_size, 2, 40, seed=11)
    tprompt = torch.tensor(prompt).long()
    jcache = jgen._cache_for(jcfg, 2, 40, jcfg.n_kv_head)
    want, want_cache = jgen.llama_prefill_chunked(
        jp, jcache, jnp.asarray(prompt), jcfg, chunk_size=16
    )
    got, got_cache = tgen.llama_prefill_chunked(
        tp, tgen._cache_for(tcfg, 2, 40, tcfg.n_kv_head, "cpu"), tprompt,
        tcfg, chunk_size=16,
    )
    _close(got, want, F32_TOL, "chunked logits vs JAX")
    _close(got_cache.k, want_cache.k, F32_TOL, "chunked k vs JAX")
    _close(got_cache.v, want_cache.v, F32_TOL, "chunked v vs JAX")
    one, one_cache = tgen.llama_prefill(
        tp, tgen._cache_for(tcfg, 2, 40, tcfg.n_kv_head, "cpu"), tprompt,
        tcfg,
    )
    _close(got, one, FORWARD_TOL, "chunked vs one-shot logits")
    _close(got_cache.k, one_cache.k, F32_TOL, "chunked vs one-shot k")
    with pytest.raises(ValueError, match="at least one prompt token"):
        tgen.llama_prefill_chunked(
            tp, got_cache, torch.zeros(2, 0).long(), tcfg
        )


def test_bidirectional_prefill_matches_jax():
    jcfg, tcfg, jp = _llama()
    tp = _to_port(jp)
    prompt = _tokens(jcfg.vocab_size, 2, 10, seed=4)
    want, want_cache = jgen.llama_prefill(
        jp, jgen._cache_for(jcfg, 2, 16, jcfg.n_kv_head),
        jnp.asarray(prompt), jcfg, causal=False,
    )
    got, got_cache = tgen.llama_prefill(
        tp, tgen._cache_for(tcfg, 2, 16, tcfg.n_kv_head, "cpu"),
        torch.tensor(prompt).long(), tcfg, causal=False,
    )
    _close(got, want, F32_TOL, "bidirectional logits")
    _close(got_cache.v, want_cache.v, F32_TOL, "bidirectional v")
    causal, _ = tgen.llama_prefill(
        tp, tgen._cache_for(tcfg, 2, 16, tcfg.n_kv_head, "cpu"),
        torch.tensor(prompt).long(), tcfg,
    )
    assert not torch.allclose(causal, got, atol=1e-4)


def _lane_prefill(gen, params, cache, cfg, prompt, lane, chunk, asarray):
    """Chunks of ``chunk`` tokens, the last one padded, into ``lane``;
    returns each chunk's logits and the cache."""
    outs, start = [], 0
    while start < len(prompt):
        c = min(chunk, len(prompt) - start)
        buf = np.zeros((1, chunk), np.int32)
        buf[0, :c] = prompt[start:start + c]
        logits, cache = gen.llama_lane_prefill_chunk(
            params, cache, asarray(buf), lane, start, cfg
        )
        outs.append((logits, c))
        start += c
    return outs, cache


def test_lane_prefill_padded_chunks_match_jax():
    jcfg, tcfg, jp = _llama()
    tp = _to_port(jp)
    prompt = _tokens(jcfg.vocab_size, 1, 7, seed=1)[0]
    jouts, jcache = _lane_prefill(
        jgen, jp, jgen._cache_for(jcfg, 3, 32, jcfg.n_kv_head), jcfg,
        prompt, 1, 4, jnp.asarray,
    )
    touts, tcache = _lane_prefill(
        tgen, tp, tgen._cache_for(tcfg, 3, 32, tcfg.n_kv_head, "cpu"), tcfg,
        prompt, 1, 4, lambda a: torch.tensor(a).long(),
    )
    assert [c for _, c in touts] == [4, 3]
    for i, ((tl, c), (jl, _)) in enumerate(zip(touts, jouts)):
        # every real query row of each chunk; padded rows are discarded
        _close(tl[:, :c], jl[:, :c], F32_TOL, f"chunk {i} logits")
    _close(tcache.k[:, 1, :7], jcache.k[:, 1, :7], F32_TOL, "lane k")
    _close(tcache.v[:, 1, :7], jcache.v[:, 1, :7], F32_TOL, "lane v")
    assert float(tcache.k[:, 0].abs().sum()) == 0.0
    assert float(tcache.v[:, 2].abs().sum()) == 0.0
    # the last real row equals the monolithic prefill's logits
    one, _ = tgen.llama_prefill(
        tp, tgen._cache_for(tcfg, 1, 32, tcfg.n_kv_head, "cpu"),
        torch.tensor(prompt[None]).long(), tcfg,
    )
    _close(touts[-1][0][0, 2], one[0], FORWARD_TOL, "last real row")


def test_ragged_decode_from_jax_cache_matches_jax():
    """Lanes 0 and 2 decode at positions 6 and 9 of a cache JAX
    prefilled; lane 1 (mid-prefill) and lane 3 (idle) are inactive,
    and every slot of theirs stays as it was."""
    jcfg, tcfg, jp = _llama(sliding_window=5)
    tp = _to_port(jp)
    lanes, T = 4, 24
    jcache = jgen._cache_for(jcfg, lanes, T, jcfg.n_kv_head)
    for lane, plen in ((0, 6), (1, 4), (2, 9)):
        prompt = _tokens(jcfg.vocab_size, 1, plen, seed=lane)[0]
        _, jcache = _lane_prefill(
            jgen, jp, jcache, jcfg, prompt, lane, 4, jnp.asarray
        )
    tcache = _cache_to_port(jcache)
    before_k, before_v = tcache.k.clone(), tcache.v.clone()
    token = np.asarray([5, 17, 40, 9], np.int32)
    pos = np.asarray([6, 0, 9, 0], np.int32)
    active = np.asarray([True, False, True, False])
    want, want_cache = jgen.llama_decode_step_ragged(
        jp, jcache, jnp.asarray(token), jnp.asarray(pos), jcfg,
        active=jnp.asarray(active),
    )
    got, got_cache = tgen.llama_decode_step_ragged(
        tp, tcache, torch.tensor(token).long(), torch.tensor(pos).long(),
        tcfg, active=torch.tensor(active),
    )
    assert got_cache.k is tcache.k  # written in place
    _close(got[active], np.asarray(want)[active], F32_TOL, "ragged logits")
    _close(got_cache.k, want_cache.k, F32_TOL, "ragged k")
    _close(got_cache.v, want_cache.v, F32_TOL, "ragged v")
    for lane in (1, 3):
        assert torch.equal(got_cache.k[:, lane], before_k[:, lane])
        assert torch.equal(got_cache.v[:, lane], before_v[:, lane])
    changed = (got_cache.k != before_k).any(dim=(0, 3, 4))
    assert changed.nonzero().tolist() == [[0, 6], [2, 9]]
    # a second step, all lanes writing, stays with JAX too
    pos2 = np.asarray([7, 1, 10, 1], np.int32)
    want2, _ = jgen.llama_decode_step_ragged(
        jp, want_cache, jnp.asarray(token), jnp.asarray(pos2), jcfg
    )
    got2, _ = tgen.llama_decode_step_ragged(
        tp, got_cache, torch.tensor(token).long(),
        torch.tensor(pos2).long(), tcfg,
    )
    _close(got2, want2, F32_TOL, "second ragged step")


def test_cache_is_a_view_of_head_major_storage():
    """Each (lane, head) is one contiguous [T, D] matrix, so the decode
    products read the cache without a copy."""
    cfg = tllama.LlamaConfig.tiny()
    cache = tgen._cache_for(cfg, 3, 10, cfg.n_kv_head, "cpu")
    L, D, Hkv = cfg.n_layer, cfg.head_dim, cfg.n_kv_head
    assert cache.k.shape == (L, 3, 10, Hkv, D)
    assert cache.k.stride() == (3 * Hkv * 10 * D, Hkv * 10 * D, D, 10 * D, 1)
    lane = cache.k[0].permute(0, 2, 1, 3).reshape(3 * Hkv, 10, D)
    assert lane.data_ptr() == cache.k.data_ptr()
    assert lane._base is not None  # a view, not a copy


def test_kernel_route_of_the_serving_programs(monkeypatch):
    """With the kernels selected (as on CUDA), the lane prefill's
    attention goes through ``flash_attention_rect`` once per group of
    query heads a layer and every block norm through the fused norm
    wrappers (here their plain versions, on CPU tensors), and the
    logits equal the plain route's."""
    jcfg, tcfg, jp = _llama()
    tp = _to_port(jp)
    kernels = dataclasses.replace(
        tcfg, use_flash_attention=True, use_fused_norm=True
    )
    calls = []
    for name in ("flash_attention_rect", "fused_rms_norm",
                 "fused_add_rms_norm"):
        fn = getattr(tgen, name)
        monkeypatch.setattr(
            tgen, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k),
        )
    prompt = torch.tensor(_tokens(tcfg.vocab_size, 1, 6, seed=2)).long()
    buf = torch.zeros(1, 8, dtype=torch.long)
    buf[0, :6] = prompt[0]
    outs = []
    for cfg in (tcfg, kernels):
        cache = tgen._cache_for(cfg, 2, 16, cfg.n_kv_head, "cpu")
        logits, cache = tgen.llama_lane_prefill_chunk(
            tp, cache, buf, 1, 0, cfg
        )
        step, _ = tgen.llama_decode_step_ragged(
            tp, cache, torch.tensor([0, 7]), torch.tensor([0, 6]), cfg,
            active=torch.tensor([False, True]),
        )
        outs.append((logits, step))
    L, g = tcfg.n_layer, tcfg.q_per_kv
    assert calls == (
        (["fused_rms_norm"] + ["flash_attention_rect"] * g
         + ["fused_add_rms_norm"]) * L
        + ["fused_rms_norm", "fused_add_rms_norm"] * L
    )
    _close(outs[1][0][:, :6], outs[0][0][:, :6], F32_TOL, "prefill logits")
    _close(outs[1][1][1], outs[0][1][1], F32_TOL, "decode logits")


def test_decode_gap_tool_measures_no_gap_in_f32():
    """``tools/decode_gap.gaps`` on the tiny f32 Llama on the CPU: the
    same arithmetic on both sides, so the decode step's logits lie
    within F32_TOL of the forward's on every lane."""
    from dlrover_tpu_torch.tools import decode_gap

    _, tcfg, jp = _llama()
    res = decode_gap.gaps(_to_port(jp), tcfg, lanes=3, steps=2, device="cpu")
    assert len(res) == 3
    assert all(a <= F32_TOL and r <= F32_TOL for a, r in res), res
