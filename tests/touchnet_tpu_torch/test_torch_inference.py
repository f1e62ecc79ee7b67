# The serving slice at small size: touchnet_tpu_torch's forward_step and
# generate against touchnet_tpu's on the same weights (JAX init_params ->
# numpy -> params_from_jax_numpy), in f32 on the CPU, where attention takes
# the kernels' plain versions. Configs: tests/assets/config/tiny_llama.json,
# tiny_llama_4l.json, and a narrow one with head_dim 64 and Llama-3's
# rope scaling. Prefill logits are held to atol 2e-4 (as the JAX package's
# test_prefill_matches_forward); greedy tokens must be identical.

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.models.llama import inference_llama as jinf
from touchnet_tpu.models.llama.configuration_llama import LlamaConfig as JLlamaConfig
from touchnet_tpu.models.llama.modeling_llama import init_params as j_init_params
from touchnet_tpu_torch.models.llama import inference_llama as inf
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.models.llama.modeling_llama import empty_model
from touchnet_tpu_torch.ops import attention as attn_ops
from touchnet_tpu_torch.ops import decode_attention as decode_ops
from touchnet_tpu_torch.ops.attention import flash_attention
from touchnet_tpu_torch.ops.decode_attention import decode_attention

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "config")
NARROW_64 = {
    "vocab_size": 96, "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 64, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "tie_word_embeddings": True,
}


def _config_dict(name):
    if name == "narrow_64":
        return dict(NARROW_64)
    with open(os.path.join(ASSETS, f"{name}.json")) as f:
        return json.load(f)


_PAIRS = {}


def _pair(name):
    """(torch config, torch model, jax config, jax params) on one set of
    weights, built once per config. The port runs its main route,
    attn_implementation "flash" (the kernels' wrappers), whatever the JSON
    says; JAX generate ignores the field."""
    if name not in _PAIRS:
        d = _config_dict(name)
        cfg = LlamaConfig.from_dict({**d, "attn_implementation": "flash"})
        jcfg = JLlamaConfig.from_dict(d)
        params = j_init_params(jcfg, jax.random.PRNGKey(0))
        model = empty_model(cfg)
        model.load_state_dict(
            params_from_jax_numpy(jax.tree.map(np.asarray, params), cfg)
        )
        _PAIRS[name] = (cfg, model, jcfg, params)
    return _PAIRS[name]


def _prompts(params, lens, seed, lo=3):
    """Right-padded prompt embeddings for rows of the given lengths."""
    rng = np.random.default_rng(seed)
    V = params["model"]["embed_tokens"]["weight"].shape[0]
    T = max(lens)
    emb = np.asarray(params["model"]["embed_tokens"]["weight"])
    out = np.zeros((len(lens), T, emb.shape[1]), np.float32)
    for b, n in enumerate(lens):
        out[b, :n] = emb[rng.integers(lo, V, n)]
    return out, np.asarray(lens, np.int32)


@pytest.mark.parametrize("name", ["tiny_llama", "narrow_64"])
@pytest.mark.parametrize("flash", [False, True])
def test_prefill_matches_jax_forward_step(name, flash):
    cfg, model, jcfg, params = _pair(name)
    emb, _ = _prompts(params, [24, 24], seed=1)
    B, T = emb.shape[:2]
    kw = dict(write_pos=0, flash_prefill=True) if flash else {}
    want, jcache = jinf.forward_step(
        params, jnp.asarray(emb), jinf.init_cache(jcfg, B, T, jnp.float32),
        jnp.zeros((B,), jnp.int32), jcfg, jnp.float32, **kw,
    )
    got, cache = inf.forward_step(
        model, torch.from_numpy(emb), inf.init_cache(cfg, B, T, torch.float32),
        torch.zeros((B,), dtype=torch.long), cfg, torch.float32, **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    # the packed caches agree slot for slot
    np.testing.assert_allclose(cache.kv.numpy(), np.asarray(jcache.kv), atol=1e-5)


CASES = {
    # name: (prompt lengths, new tokens, generate kwargs)
    "single_shot": ([12], 8, {}),
    "chunked": ([40, 21], 6, {"prefill_chunk": 16}),
    "ragged_batch": ([16, 10], 6, {}),
    "no_repeat_ngram": ([10, 10], 16, {"no_repeat_ngram_size": 2}),
    "repetition_penalty": ([10, 7], 16, {"no_repeat_ngram_size": 2,
                                         "repetition_penalty": 1.5,
                                         "repetition_window": 16}),
    "prime_tokens": ([12], 16, {"no_repeat_ngram_size": 2, "repetition_penalty": 1.5,
                                "repetition_window": 16, "prime_tokens": (0, 0, 1)}),
}


def _generate_both(name, lens, new, kw, seed=3):
    cfg, model, jcfg, params = _pair(name)
    emb, plen = _prompts(params, lens, seed)
    want = jinf.generate(params, jcfg, jnp.asarray(emb), jnp.asarray(plen), new,
                         eos_id=-1, compute_dtype=jnp.float32, **kw)
    got = inf.generate(model, cfg, torch.from_numpy(emb), torch.from_numpy(plen),
                       new, eos_id=-1, compute_dtype=torch.float32, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generate_matches_jax(case):
    lens, new, kw = CASES[case]
    f0, d0 = flash_attention.launches, decode_attention.launches
    got, want = _generate_both("tiny_llama", lens, new, kw)
    np.testing.assert_array_equal(got, want)
    # CPU tensors take the plain versions: no kernel launched
    assert (flash_attention.launches, decode_attention.launches) == (f0, d0)


@pytest.mark.parametrize("name", ["tiny_llama_4l", "narrow_64"])
@pytest.mark.parametrize("chunk", [None, 16])
def test_greedy_generate_matches_jax_other_configs(name, chunk):
    got, want = _generate_both(name, [37, 20], 8, {"prefill_chunk": chunk}, seed=5)
    np.testing.assert_array_equal(got, want)


def test_chunked_equals_single_shot():
    cfg, model, _, params = _pair("tiny_llama")
    emb, plen = _prompts(params, [40, 21], seed=8)
    args = (model, cfg, torch.from_numpy(emb), torch.from_numpy(plen), 6)
    one = inf.generate(*args, eos_id=-1, compute_dtype=torch.float32)
    chunked = inf.generate(*args, eos_id=-1, compute_dtype=torch.float32,
                           prefill_chunk=16)
    torch.testing.assert_close(one, chunked, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [None, 16])
def test_eager_route_matches_flash_route(chunk, monkeypatch):
    """Serving does not read attn_implementation (nor does the JAX
    generate): an "eager" config goes through the same kernel wrappers as
    a "flash" one, once per layer in every prefill chunk and decode step,
    so on the card it can never bypass the kernels."""
    calls = {"K1": 0, "K4": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(attn_ops, "flash_attention", counting("K1", flash_attention))
    monkeypatch.setattr(decode_ops, "decode_attention", counting("K4", decode_attention))
    cfg, model, _, params = _pair("narrow_64")
    eager = LlamaConfig.from_dict({**NARROW_64, "attn_implementation": "eager"})
    emb, plen = _prompts(params, [37, 20], seed=6)
    L, outs = cfg.num_hidden_layers, []
    for c in (cfg, eager):
        calls.update(K1=0, K4=0)
        cache, logits, Tp = inf.prefill(model, c, torch.from_numpy(emb),
                                        torch.from_numpy(plen), 4,
                                        compute_dtype=torch.float32, prefill_chunk=chunk)
        tok_emb = model.model.embed_tokens.weight[logits.argmax(-1)][:, None]
        step = inf.decode_step(model, c, cache, tok_emb, torch.from_numpy(plen), Tp, 0,
                               torch.float32)
        chunks = 1 if chunk is None else -(-emb.shape[1] // chunk)
        assert calls == {"K1": L * chunks, "K4": L}
        outs.append((logits, step, cache.kv))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cache_is_updated_in_place():
    """The cache tensor keeps its storage across prefill and decode steps,
    and each step writes its own slot."""
    cfg, model, _, params = _pair("narrow_64")
    emb, plen = _prompts(params, [9, 5], seed=2)
    plen = torch.from_numpy(plen)
    cache, logits, Tp = inf.prefill(model, cfg, torch.from_numpy(emb), plen, 4,
                                    compute_dtype=torch.float32)
    ptr = cache.kv.data_ptr()
    for step in range(3):
        tok = logits.argmax(-1)
        assert (cache.kv[:, :, :, Tp + step] == 0).all()
        emb_t = model.model.embed_tokens.weight[tok][:, None]
        logits = inf.decode_step(model, cfg, cache, emb_t, plen, Tp, step,
                                 torch.float32)
        assert cache.kv.data_ptr() == ptr
        assert (cache.kv[:, :, :, Tp + step] != 0).any(-1).all()


@pytest.mark.parametrize("kw", [
    {"top_k": 3}, {"top_p": 0.8}, {"top_k": 5, "top_p": 0.5},
    {"repetition_penalty": 1.7, "top_k": 4},
], ids=["top_k", "top_p", "top_k_top_p", "penalty"])
def test_sampler_masks_match_jax(kw, monkeypatch):
    """The deterministic part of sampling (penalty, temperature, top-k and
    top-p masks) on fixed logits; the draw itself is not compared (JAX and
    torch generators differ). JAX's categorical is replaced by the identity
    so its sample_token returns the processed logits."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 50)) * 2).astype(np.float32)
    logits[1, 7] = logits[1, 3]  # a tie
    recent = np.asarray([[3, 7, -1], [-1, -1, -1], [0, 49, 49]], np.int32)
    monkeypatch.setattr(jax.random, "categorical", lambda key, lg, axis=-1: lg)
    want = jinf.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                             temperature=0.7, recent_tokens=jnp.asarray(recent), **kw)
    tl = inf.apply_repetition_penalty(torch.from_numpy(logits),
                                      kw.get("repetition_penalty", 1.0),
                                      torch.from_numpy(recent).long())
    got = inf.warp_logits(tl, 0.7, kw.get("top_k", 0), kw.get("top_p", 0.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_greedy_sampler_with_penalty_matches_jax():
    logits = np.asarray([[2.0, 1.0, 0.5, -1.0], [-0.5, -0.4, -3.0, -0.45]], np.float32)
    recent = np.asarray([[0, -1], [1, 1]], np.int32)
    want = jinf.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                             repetition_penalty=10.0, recent_tokens=jnp.asarray(recent))
    got = inf.sample_token(torch.from_numpy(logits), None, repetition_penalty=10.0,
                           recent_tokens=torch.from_numpy(recent).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_draws_follow_the_seed():
    cfg, model, _, params = _pair("tiny_llama")
    emb, plen = _prompts(params, [8, 8], seed=4)
    args = (model, cfg, torch.from_numpy(emb), torch.from_numpy(plen), 12)
    kw = dict(eos_id=-1, compute_dtype=torch.float32, temperature=1.0, top_k=20)
    a = inf.generate(*args, seed=1, **kw)
    b = inf.generate(*args, seed=1, **kw)
    c = inf.generate(*args, seed=2, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_early_stop_at_eos():
    cfg, model, _, params = _pair("tiny_llama")
    emb, plen = _prompts(params, [12], seed=3)
    first = inf.generate(model, cfg, torch.from_numpy(emb), torch.from_numpy(plen), 8,
                         eos_id=-1, compute_dtype=torch.float32)
    eos = int(first[0, 2])
    got = inf.generate(model, cfg, torch.from_numpy(emb), torch.from_numpy(plen), 8,
                       eos_id=eos, compute_dtype=torch.float32)
    stop = int((first[0] == eos).nonzero()[0])
    assert torch.equal(got[0, :stop + 1], first[0, :stop + 1])
    assert (got[0, stop:] == eos).all()


def test_generate_stops_at_the_first_done_check(monkeypatch):
    """Once every row has emitted eos, the loop ends at the next
    EOS_CHECK_EVERY boundary: it reads the done flag (a host sync) only
    there, and runs no decode step after it."""
    cfg, model, _, params = _pair("tiny_llama")
    emb, plen = _prompts(params, [12], seed=3)
    args = (model, cfg, torch.from_numpy(emb), torch.from_numpy(plen))
    every = inf.EOS_CHECK_EVERY
    first = inf.generate(*args, every + 4, eos_id=-1, compute_dtype=torch.float32)
    steps = []
    real_step = inf.decode_step

    def counted_step(*a, **k):
        steps.append(a[6])  # the step index
        return real_step(*a, **k)

    monkeypatch.setattr(inf, "decode_step", counted_step)
    got = inf.generate(*args, 2 * every, eos_id=int(first[0, 1]),
                       compute_dtype=torch.float32)
    stop = int((first[0] == first[0, 1]).nonzero()[0])
    assert steps == list(range(every)) and stop < every
    assert torch.equal(got[0, :stop + 1], first[0, :stop + 1])
    assert (got[0, stop:] == first[0, 1]).all()
