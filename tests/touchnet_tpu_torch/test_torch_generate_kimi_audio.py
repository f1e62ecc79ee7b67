# The port's dual-stream generation (touchnet_tpu_torch/models/kimi_audio/
# generate_kimi_audio.py) against the JAX package on the CPU, on the TINY
# config of test_torch_kimi_audio.py (4 main layers with the fork after
# layer 1, 2 mimo layers: cache rows 0-3 and 4-5), JAX's weights, f32:
#   - forward_step_dual's prefill: text and audio logits and the whole
#     packed cache (both stacks' rows) at rtol/atol 1e-5;
#   - generate_dual with greedy samplers (the text stream's default, greedy
#     with repetition penalty 1.1; the audio stream at temperature 0, with
#     and without a penalty): text and audio tokens equal to JAX's, with
#     single-shot and with chunked prefill (13-token prompts in chunks of
#     5), with an eos that ends one row early;
#   - output_type "text": inference_llama.generate over the text stack with
#     the audio stream held at blank through embed_fn equals
#     generate_dual(output_type="text") up to each row's eos, and the audio
#     stream is all blank (the JAX test's equivalence);
#   - the default audio sampler (temperature 0.8, top-k 10, a
#     torch.Generator, whose draws differ from jax.random's): held by
#     structure: the first kimia_mimo_audiodelaytokens audio tokens are
#     blank, later ones are drawn from the mimo head's top 10.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from touchnet_tpu.models.kimi_audio import generate_kimi_audio as jg
from touchnet_tpu_torch.models.kimi_audio import generate_kimi_audio as tg
from touchnet_tpu_torch.models.llama import inference_llama as inf
from test_torch_kimi_audio import TINY, jax_tree, port_model

BLANK = 7
GREEDY_AUDIO = {"plain": (0.0, 1.0), "penalized": (0.0, 1.1)}


@pytest.fixture(scope="module")
def tiny():
    from touchnet_tpu.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig as JC
    from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig

    jparams = jax_tree(seed=3)
    return KimiAudioConfig.from_dict(TINY), JC.from_dict(TINY), jparams, \
        port_model(TINY, jparams)


def _prompt(jparams, B=2, Tp=13, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 90, size=(B, Tp))
    emb = np.asarray(jparams["model"]["embed_tokens"]["weight"])[ids]
    return emb.astype(np.float32), np.asarray([Tp, Tp - 4], np.int64)


def test_dual_cache_and_prefill_match_jax(tiny):
    cfg, jcfg, jparams, model = tiny
    emb, plen = _prompt(jparams)
    B, Tp, _ = emb.shape
    cache = tg.init_dual_cache(cfg, B, Tp + 4, torch.float32, "cpu")
    jcache = jg.init_dual_cache(jcfg, B, Tp + 4, jnp.float32)
    assert tuple(cache.kv.shape) == jcache.kv.shape == (6, B, 2, inf.decode_ops.DECODE_BLOCK, 32)
    want_t, want_a, jcache = jg.forward_step_dual(
        jparams, jnp.asarray(emb), jcache, jnp.zeros((B,), jnp.int32), jcfg, jnp.float32,
        write_pos=jnp.asarray(0, jnp.int32), flash_prefill=True,
        logits_indices=jnp.asarray(plen - 1))
    got_t, got_a, cache = tg.forward_step_dual(
        model, torch.from_numpy(emb), cache, torch.zeros((B,), dtype=torch.long), cfg,
        torch.float32, write_pos=0, flash_prefill=True,
        logits_indices=torch.from_numpy(plen - 1))
    for got, want in ((got_t, want_t), (got_a, want_a), (cache.kv, jcache.kv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(cache.kv[4:, :, :, :Tp].abs().sum()) > 0  # the mimo rows were written


def _eos(jparams, jcfg, emb, plen, sampler=jg.SamplerSettings(
        temperature=0.0, repetition_penalty=1.1)) -> int:
    """A text id that row 1's greedy decode emits after its first step and
    row 0's never does: with it as eos row 1 ends early and row 0 runs on."""
    text, _ = jg.generate_dual(jparams, jcfg, jnp.asarray(emb), jnp.asarray(plen), 10,
                               blank_id=BLANK, eos_id=-1, output_type="text",
                               text_sampler=sampler, compute_dtype=jnp.float32)
    text = np.asarray(text)
    return next(int(t) for t in text[1, 1:] if t not in text[0])


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("audio", list(GREEDY_AUDIO))
def test_greedy_generate_dual_matches_jax(tiny, chunk, audio):
    cfg, jcfg, jparams, model = tiny
    emb, plen = _prompt(jparams)
    eos = _eos(jparams, jcfg, emb, plen)
    temp, pen = GREEDY_AUDIO[audio]
    want = jg.generate_dual(
        jparams, jcfg, jnp.asarray(emb), jnp.asarray(plen), 10, blank_id=BLANK, eos_id=eos,
        output_type="both", compute_dtype=jnp.float32, prefill_chunk=chunk,
        audio_sampler=jg.SamplerSettings(temperature=temp, repetition_penalty=pen))
    got = tg.generate_dual(
        model, cfg, torch.from_numpy(emb), torch.from_numpy(plen), 10, blank_id=BLANK,
        eos_id=eos, output_type="both", compute_dtype=torch.float32, prefill_chunk=chunk,
        audio_sampler=tg.SamplerSettings(temperature=temp, repetition_penalty=pen))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    text, audio_toks = got[0].numpy(), got[1].numpy()
    assert eos in text[1] and eos not in text[0]  # row 1 ended, its streams then blank
    end = list(text[1]).index(eos)
    assert (text[1, end + 1:] == BLANK).all() and (audio_toks[1, end:] == BLANK).all()
    delay = cfg.kimia_mimo_audiodelaytokens
    assert (audio_toks[:, :delay] == BLANK).all() and (audio_toks[0, delay:] != BLANK).any()


def test_text_output_equals_single_stream_generate(tiny):
    cfg, jcfg, jparams, model = tiny
    emb, plen = _prompt(jparams, Tp=12, seed=2)
    embed_w = model.model.embed_tokens.weight
    blank_emb = embed_w[BLANK]
    prompt = torch.from_numpy(emb) + blank_emb
    first, _ = jg.generate_dual(jparams, jcfg, jnp.asarray(prompt.numpy()), jnp.asarray(plen),
                                3, blank_id=BLANK, eos_id=-1, output_type="text",
                                text_sampler=jg.SamplerSettings(), compute_dtype=jnp.float32)
    eos = int(np.asarray(first)[1, 2])  # row 1 ends by its third step
    single = inf.generate(model, cfg.text_config, prompt, torch.from_numpy(plen), 8,
                          eos_id=eos, embed_fn=lambda t: F.embedding(t, embed_w) + blank_emb,
                          compute_dtype=torch.float32)
    text, audio = tg.generate_dual(model, cfg, prompt, torch.from_numpy(plen), 8,
                                   blank_id=BLANK, eos_id=eos, output_type="text",
                                   text_sampler=tg.SamplerSettings(),
                                   compute_dtype=torch.float32)
    want, _ = jg.generate_dual(jparams, jcfg, jnp.asarray(prompt.numpy()), jnp.asarray(plen), 8,
                               blank_id=BLANK, eos_id=eos, output_type="text",
                               text_sampler=jg.SamplerSettings(), compute_dtype=jnp.float32)
    np.testing.assert_array_equal(text.numpy(), np.asarray(want))
    s, t = single.numpy(), text.numpy()
    for b in range(s.shape[0]):
        n = list(s[b]).index(eos) + 1 if eos in s[b] else s.shape[1]
        np.testing.assert_array_equal(t[b, :n], s[b, :n])
    assert eos in s[1] and (audio == BLANK).all()


def test_default_audio_sampler_keeps_the_delay_and_the_top_k(tiny):
    cfg, _, jparams, model = tiny
    emb, plen = _prompt(jparams, Tp=8, seed=4)
    N, delay = 9, 3
    seen = []
    real = tg.forward_step_dual

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[1][:, -1].clone())  # each step's audio logits
        return out

    tg.forward_step_dual = spy
    try:
        _, audio = tg.generate_dual(model, cfg, torch.from_numpy(emb), torch.from_numpy(plen), N,
                                    blank_id=BLANK, eos_id=-1, output_type="both",
                                    audio_delay_tokens=delay, compute_dtype=torch.float32)
    finally:
        tg.forward_step_dual = real
    audio = audio.numpy()
    assert (audio[:, :delay] == BLANK).all()
    assert (audio[:, delay:] != BLANK).any()
    for step in range(delay, N):  # drawn from the logits that fed the step
        top = torch.topk(seen[step], 10, dim=-1).indices.numpy()
        assert all(audio[b, step] in top[b] for b in range(audio.shape[0]))
