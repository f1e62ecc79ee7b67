# The port's KimiAudioForCausalLM (touchnet_tpu_torch/models/kimi_audio/)
# against the JAX package on the CPU, on the TINY config of
# tests/touchnet_tpu/models/test_kimi_audio.py (Qwen2 text model 4 layers,
# 4 heads over 2, mimo fork after layer 1 with 2 mimo layers; whisper tower
# and WhisperVQ tokenizer d32 x 2 layers, 16 mel bins, a tokenizer block of
# 8 frames, so rows cross block edges), weights carried over from JAX
# init_params (convert.params_from_jax_numpy), seeded numpy inputs, f32,
# the JAX side on its plain attention (eager, as its own tests run it):
#   - block_causal_attention, the tokenizer's pooled states, the adaptor,
#     prepare_audio_input_embs and forward's text and audio logits: rtol and
#     atol 1e-5 (f32; only the two frameworks' summation orders differ);
#   - the VQ codes: equal to JAX's, except where JAX's two best scores of a
#     frame lie within NEAR_TIE of each other (an f32 near-tie may flip
#     between the summation orders); the test prints how many frames differ
#     (0 at this config). A constructed exact tie goes to the smallest
#     index on both sides;
#   - mask_between_markers: equal, with a missing marker and reversed
#     markers;
#   - get_num_params (10,742,582,784 at Kimi-Audio-7B) and
#     get_num_flop_per_token equal; the module holds get_num_params plus the
#     three position tables;
#   - the HF state dict: the same keys and arrays as JAX's
#     params_to_hf_state_dict; HF -> port drops the tokenizer's EMA buffers
#     and raises naming a missing key; the config of hf_config_dict loads
#     in both packages.

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.models.kimi_audio import convert as jconvert
from touchnet_tpu.models.kimi_audio import modeling_kimi_audio as jm
from touchnet_tpu.models.kimi_audio.configuration_kimi_audio import (
    KimiAudioConfig as JConfig,
)
from touchnet_tpu_torch.models.kimi_audio import convert
from touchnet_tpu_torch.models.kimi_audio import modeling_kimi_audio as tm
from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
KIMI_7B = os.path.join(ROOT, "examples/audio/sft/asr/wenetspeech/config/Kimi-Audio-7B.json")
TOL = dict(rtol=1e-5, atol=1e-5)
# f32 scores of 2 h.c - |c|^2 at |h|, |c| of this config: summation order
# moves them by ~1e-6; a gap below this may flip the argmax between the two
# frameworks
NEAR_TIE = 1e-4

TINY = {
    "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2,
    "attn_implementation": "eager",
    "kimia_mimo_layers": 2, "kimia_mimo_transformer_from_layer_index": 1,
    "kimia_adaptor_input_dim": 128,  # 4 * whisper d_model
    "kimia_token_offset": 100, "kimia_media_begin": 200, "kimia_media_end": 201,
    "speech_encoder_config": {
        "num_mel_bins": 16, "d_model": 32, "encoder_layers": 2,
        "encoder_attention_heads": 4, "encoder_ffn_dim": 64, "max_source_positions": 100,
    },
    "speech_tokenizer_config": {
        "num_mel_bins": 16, "d_model": 32, "encoder_attention_heads": 4,
        "encoder_ffn_dim": 64, "max_source_positions": 100,
        "pooling_kernel_size": 4, "pooling_position": 2,
        "quantize_position": 2, "quantize_vocab_size": 32,
        "quantize_causal_block_size": 8,
    },
}


def jax_tree(raw=TINY, seed=0):
    return jm.init_params(JConfig.from_dict(raw), jax.random.PRNGKey(seed))


def port_model(raw, jparams) -> tm.KimiAudioForCausalLM:
    """The port's model on the CPU in f32 holding the JAX params."""
    cfg = KimiAudioConfig.from_dict(raw)
    model = tm.empty_model(cfg, torch.float32, "cpu")
    model.load_state_dict(convert.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg))
    return model


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_tree()
    return KimiAudioConfig.from_dict(TINY), JConfig.from_dict(TINY), jparams, \
        port_model(TINY, jparams)


def _inputs(B=2, T=40, Tw=64, seed=1, markers=((4, 13), (6, 15))):
    """(text ids, audio ids with media markers, features [B, mel, Tw], frame
    mask [B, Tw]: row 1 padded after 40 frames)."""
    rng = np.random.default_rng(seed)
    audio = rng.integers(0, 90, (B, T)).astype(np.int64)
    for b, (lo, hi) in enumerate(markers[:B]):
        audio[b, lo], audio[b, hi] = 200, 201
    text = rng.integers(0, 90, (B, T)).astype(np.int64)
    feats = rng.standard_normal((B, 16, Tw)).astype(np.float32)
    mask = np.ones((B, Tw), np.int64)
    mask[1:, 40:] = 0
    return text, audio, feats, mask


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_config_and_counts():
    for path in (None, KIMI_7B):
        raw = TINY if path is None else json.load(open(path))
        cfg, jcfg = KimiAudioConfig.from_dict(raw), JConfig.from_dict(raw)
        assert json.dumps(cfg.to_dict(), sort_keys=True) == \
            json.dumps(jcfg.to_dict(), sort_keys=True)
        assert tm.get_num_params(cfg) == jm.get_num_params(jcfg)
        assert tm.get_num_params(cfg, True) == jm.get_num_params(jcfg, True)
        assert tm.get_num_flop_per_token(123, cfg, 4096) == \
            jm.get_num_flop_per_token(123, jcfg, 4096)
        with torch.device("meta"):
            held = sum(p.numel() for p in tm.KimiAudioForCausalLM(cfg).parameters())
        se, vq = cfg.speech_encoder_config, cfg.speech_tokenizer_config
        tables = (se.max_source_positions * se.d_model + vq.max_source_positions * vq.d_model
                  + -(-vq.max_source_positions // vq.pooling_kernel_size) * vq.d_model)
        assert held == tm.get_num_params(cfg) + tables
    assert tm.get_num_params(cfg) == 10_742_582_784


def test_init_params_and_empty_model():
    cfg = KimiAudioConfig.from_dict(TINY)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    assert bool((model.model.mimo_norm.weight == 1).all())
    assert bool((model.model.vq_adaptor.layers[4].weight == 1).all())
    assert bool((model.speech_tokenizer.conv1.bias == 0).all())
    assert 0.015 < float(model.speech_tokenizer.codebook.weight.std()) < 0.025
    assert 0.015 < float(model.mimo_output.weight.std()) < 0.025
    meta = tm.empty_model(cfg, torch.bfloat16, "meta")
    assert {p.dtype for p in meta.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("block,pad", [(8, 0), (8, 5), (3, 7), (64, 0)])
def test_block_causal_attention_matches_jax(block, pad):
    rng = np.random.default_rng(block + pad)
    B, T, H, D = 2, 20, 4, 8
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, T), np.int64)
    if pad:
        mask[1, T - pad:] = 0
    want = jm._block_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(mask), block, 0.3)
    got = tm.block_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(mask), block, 0.3)
    _close(got, want)


def _jax_pooled(jparams, jcfg, feats, mask, monkeypatch):
    """JAX's codes and the pooled states its vector_quantize searched with."""
    seen = {}
    real = jm.vector_quantize

    def spy(h, codebook):
        seen["h"] = np.asarray(h)
        return real(h, codebook)

    monkeypatch.setattr(jm, "vector_quantize", spy)
    codes = jm.speech_tokenizer_forward(jparams["speech_tokenizer"], jnp.asarray(feats),
                                        jnp.asarray(mask), jcfg.speech_tokenizer_config,
                                        jnp.float32)
    return np.asarray(codes), seen["h"]


def _differing_frames(got, want_codes, want_h, codebook) -> int:
    """Frames whose codes differ; each must be an f32 near-tie of JAX's."""
    diff = np.argwhere(got != want_codes)
    if len(diff):
        cb = np.asarray(codebook, np.float64)
        for b, t in diff:
            s = 2.0 * cb @ want_h[b, t].astype(np.float64) - (cb * cb).sum(-1)
            top = np.sort(s)[-2:]
            assert top[1] - top[0] <= NEAR_TIE, (b, t, top)
    return len(diff)


@pytest.mark.parametrize("Tw", [64, 50])
def test_speech_tokenizer_matches_jax(tiny, monkeypatch, Tw):
    cfg, jcfg, jparams, model = tiny
    _, _, feats, mask = _inputs(Tw=Tw)
    want_codes, want_h = _jax_pooled(jparams, jcfg, feats, mask, monkeypatch)
    vq = cfg.speech_tokenizer_config
    h = tm.speech_tokenizer_hidden(model.speech_tokenizer, torch.from_numpy(feats),
                                   torch.from_numpy(mask), vq, torch.float32)
    _close(h, want_h)
    codes = tm.speech_tokenizer_forward(model.speech_tokenizer, torch.from_numpy(feats),
                                        torch.from_numpy(mask), vq, torch.float32)
    assert codes.shape == want_codes.shape == (2, -(-(-(-Tw // 2)) // 4))
    n = _differing_frames(codes.numpy(), want_codes, want_h,
                          jparams["speech_tokenizer"]["codebook"]["weight"])
    print(f"VQ codes differing from JAX's: {n} of {codes.numel()} frames")
    assert n == 0


def test_vector_quantize_ties_go_to_the_smallest_index():
    cb = np.eye(4, dtype=np.float32) * 2
    cb = np.concatenate([cb, cb])  # every codeword twice: rows i and i + 4 tie
    h = np.asarray([[[1.9, 0, 0, 0], [0, 0, 0.1, 2.2], [0, 0, 0, 0]]], np.float32)
    want = np.asarray(jm.vector_quantize(jnp.asarray(h), jnp.asarray(cb)))
    got = tm.vector_quantize(torch.from_numpy(h), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[0, 3, 0]]


@pytest.mark.parametrize("case", ["both", "missing_end", "missing_begin", "reversed",
                                  "adjacent", "edges", "repeated"])
def test_mask_between_markers_matches_jax(case):
    ids = np.zeros((3, 12), np.int64)
    if case in ("both", "missing_end", "repeated"):
        ids[:, 2], ids[:, 8] = 200, 201
    if case == "missing_end":
        ids[1, 8] = 0
    if case == "missing_begin":
        ids[:, 8] = 201
    if case == "reversed":
        ids[:, 3], ids[:, 9] = 201, 200
    if case == "adjacent":
        ids[:, 4], ids[:, 5] = 200, 201
    if case == "edges":
        ids[:, 0], ids[:, 11] = 200, 201
    if case == "repeated":
        ids[0, 10] = 200
        ids[2, 1] = 201
    want = np.asarray(jm._mask_between_markers(jnp.asarray(ids), 200, 201))
    got = tm.mask_between_markers(torch.from_numpy(ids), 200, 201).numpy()
    np.testing.assert_array_equal(got, want)


def test_adaptor_and_prepare_audio_input_embs_match_jax(tiny):
    cfg, jcfg, jparams, model = tiny
    _, audio, feats, mask = _inputs()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = jm.vq_adaptor_forward(jparams["model"]["vq_adaptor"], jnp.asarray(x), 1e-6)
    _close(tm.vq_adaptor_forward(model.model.vq_adaptor, torch.from_numpy(x), 1e-6), want)

    embed = jparams["model"]["embed_tokens"]["weight"]
    want = jm.prepare_audio_input_embs(
        jparams, jnp.asarray(audio), jnp.take(embed, jnp.asarray(audio), axis=0),
        jnp.asarray(feats), jnp.asarray(mask), jcfg, jnp.float32)
    ids = torch.from_numpy(audio)
    with torch.no_grad():
        got = tm.prepare_audio_input_embs(
            model, ids, torch.nn.functional.embedding(ids, model.model.embed_tokens.weight),
            torch.from_numpy(feats), torch.from_numpy(mask), cfg, torch.float32)
    _close(got, want)
    # the 8 positions between the markers hold the speech; the rest is untouched
    inside = tm.mask_between_markers(ids, 200, 201)
    assert inside.sum(1).tolist() == [8, 8]
    assert torch.equal(got[~inside], model.model.embed_tokens.weight[ids][~inside])


@pytest.mark.parametrize("with_speech", [True, False])
def test_forward_matches_jax(tiny, with_speech):
    cfg, jcfg, jparams, model = tiny
    text, audio, feats, mask = _inputs()
    speech = dict(whisper_input_features=feats, whisper_attention_mask=mask) \
        if with_speech else {}
    want_t, want_a = jm.forward(
        jparams, text_input_ids=jnp.asarray(text), audio_input_ids=jnp.asarray(audio),
        **{k: jnp.asarray(v) for k, v in speech.items()}, config=jcfg,
        compute_dtype=jnp.float32, return_audio_logits=True)
    with torch.no_grad():
        got_t, got_a = tm.forward(
            model, text_input_ids=torch.from_numpy(text), audio_input_ids=torch.from_numpy(audio),
            **{k: torch.from_numpy(v) for k, v in speech.items()}, config=cfg,
            compute_dtype=torch.float32, return_audio_logits=True)
        only_text = tm.forward(model, text_input_ids=torch.from_numpy(text),
                               audio_input_ids=torch.from_numpy(audio),
                               **{k: torch.from_numpy(v) for k, v in speech.items()},
                               config=cfg, compute_dtype=torch.float32)
    _close(got_t, want_t)
    _close(got_a, want_a)
    assert torch.equal(only_text, got_t)


def test_hf_state_dict_matches_jax(tiny, tmp_path):
    cfg, jcfg, jparams, model = tiny
    want = jconvert.params_to_hf_state_dict(jcfg, jax.tree.map(np.asarray, jparams))
    got = convert.params_to_hf_state_dict(cfg, model.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    hf = dict(got)
    hf["speech_tokenizer.layers.0.ema_codebook.weight"] = torch.zeros(3)
    hf["speech_tokenizer.ema_count"] = torch.zeros(3)
    back = convert.params_from_hf_state_dict(cfg, hf, dtype=torch.bfloat16)
    assert sorted(back) == sorted(got) and back["lm_head.weight"].dtype == torch.bfloat16
    assert "speech_tokenizer.embed_positions2.weight" in back
    del hf["speech_tokenizer.codebook.weight"]
    with pytest.raises(KeyError, match="speech_tokenizer.codebook.weight"):
        convert.params_from_hf_state_dict(cfg, hf)
    raw = convert.hf_config_dict(cfg, "float32")
    (tmp_path / "config.json").write_text(json.dumps(raw))
    assert KimiAudioConfig.from_json_file(str(tmp_path / "config.json")).to_dict() == \
        cfg.to_dict()
    assert JConfig.from_json_file(str(tmp_path / "config.json")).to_dict() == jcfg.to_dict()
    assert raw["model_type"] == "kimi_audio" and raw["torch_dtype"] == "float32"
