# The port's Qwen2AudioForConditionalGeneration (touchnet_tpu_torch/models/
# qwen2_audio/) against the JAX package on the CPU, on the TINY config of
# tests/touchnet_tpu/models/test_qwen2_audio.py (whisper tower 32 mel x d64
# x 2 layers, Qwen2 text model 4 heads over 2) and on the same config with
# 7 query heads over 1 kv head (G 7, the group of Qwen2-Audio-7B's 28 over
# 4), weights carried over from JAX init_params
# (convert.params_from_jax_numpy), seeded numpy inputs, f32:
#   - get_feat_extract_output_lengths and merge_audio_into_text: exact,
#     including more <|AUDIO|> tokens than audio frames (clipped to the
#     last frame) and rows without audio;
#   - encode_audio (the causal tower, the pool, the final LN, the projector)
#     and forward's logits: rtol/atol 1e-5 (the JAX side on its plain
#     attention, use_pallas=False / "eager", as its own tests run it);
#   - the HF state dict: the same keys and arrays as JAX's
#     params_to_hf_state_dict, a round trip HF -> port -> HF, the config
#     written by hf_config_dict loading into both packages' configs;
#   - init_params, empty_model, get_num_params, get_num_flop_per_token;
#   - K1's and K4's plain versions (what CPU tensors take) at G 7 and at
#     G 1 with a T off the tile against the JAX Pallas kernels in interpret
#     mode (K1 at G 1 on the static grid, as the JAX whisper tower calls
#     it): atol 2e-5, as test_torch_attention.py and
#     test_torch_decode_attention.py.

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.models.qwen2_audio import convert as jconvert
from touchnet_tpu.models.qwen2_audio import modeling_qwen2_audio as jm
from touchnet_tpu.models.qwen2_audio.configuration_qwen2_audio import (
    Qwen2AudioConfig as JConfig,
)
from touchnet_tpu.ops import attention as jattn
from touchnet_tpu.ops.decode_attention import decode_attention as j_decode
from touchnet_tpu_torch.models.qwen2_audio import convert
from touchnet_tpu_torch.models.qwen2_audio import modeling_qwen2_audio as tm
from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig
from touchnet_tpu_torch.ops import attention as attn
from touchnet_tpu_torch.ops import decode_attention as dec

TINY = {
    "audio_token_index": 60,
    "audio_config": {"num_mel_bins": 32, "d_model": 64, "encoder_layers": 2,
                     "encoder_attention_heads": 4, "encoder_ffn_dim": 128,
                     "max_source_positions": 100},
    "text_config": {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 128,
                    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                    "attention_bias": True, "attn_implementation": "eager"},
}
TINY_G7 = copy.deepcopy(TINY)
TINY_G7["text_config"].update(hidden_size=112, num_attention_heads=7, num_key_value_heads=1,
                              head_dim=16)
CONFIGS = {"G2": TINY, "G7": TINY_G7}


def _model(raw, seed=0):
    """(JAX params, JAX config, the port's model with the same weights, its config)."""
    jc, tc = JConfig.from_dict(raw), Qwen2AudioConfig.from_dict(raw)
    jp = jm.init_params(jc, jax.random.PRNGKey(seed))
    model = tm.empty_model(tc, torch.float32, "cpu")
    model.load_state_dict(convert.params_from_jax_numpy(jax.tree.map(np.asarray, jp), tc))
    return jp, jc, model, tc


def _batch(seed, B=2, frames=240, L=80):
    """features [B, 32, frames] and ids whose rows hold a span of
    frames // 4 audio tokens (row 1: ten fewer) amid text."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, 32, frames)).astype(np.float32)
    ids = rng.integers(0, 58, (B, L))
    n = frames // 4
    ids[0, 3:3 + n] = 60
    ids[1, 5:5 + n - 10] = 60
    return feats, ids


def test_feat_extract_output_lengths_match_jax():
    lengths = np.asarray([1, 2, 3, 4, 5, 6, 99, 100, 101, 1500, 3000, 3500])
    want = [np.asarray(x) for x in jm.get_feat_extract_output_lengths(jnp.asarray(lengths))]
    got = tm.get_feat_extract_output_lengths(torch.from_numpy(lengths))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert tm.get_feat_extract_output_lengths(3000) == (1500, 750)
    assert tm.get_feat_extract_output_lengths(3500) == (1750, 875)


@pytest.mark.parametrize("case", ["one_span", "more_tokens_than_frames", "no_audio",
                                  "two_spans"])
def test_merge_audio_into_text_matches_jax(case):
    rng = np.random.default_rng(7)
    B, L, Ta, E = 2, 12, 3, 5
    text = rng.standard_normal((B, L, E)).astype(np.float32)
    audio = rng.standard_normal((B, Ta, E)).astype(np.float32)
    ids = rng.integers(0, 9, (B, L))
    if case == "one_span":
        ids[0, 2:5], ids[1, 0:3] = 9, 9
    elif case == "more_tokens_than_frames":  # the 4th..6th take frame Ta - 1
        ids[0, 1:7], ids[1, 6:12] = 9, 9
    elif case == "two_spans":  # the count runs on across spans
        ids[0, 1:3], ids[0, 8:9] = 9, 9
    want = np.asarray(jm.merge_audio_into_text(jnp.asarray(text), jnp.asarray(audio),
                                               jnp.asarray(ids), 9))
    got = tm.merge_audio_into_text(torch.from_numpy(text), torch.from_numpy(audio),
                                   torch.from_numpy(ids), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "no_audio":
        np.testing.assert_array_equal(got.numpy(), text)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_audio_and_forward_match_jax(name):
    jp, jc, model, tc = _model(CONFIGS[name])
    feats, ids = _batch(1)
    want_audio = jm.encode_audio(jp, jnp.asarray(feats), jc, jnp.float32, use_pallas=False)
    got_audio = tm.encode_audio(model, torch.from_numpy(feats), tc, torch.float32)
    assert got_audio.shape == (2, 60, tc.text_config.hidden_size)
    np.testing.assert_allclose(got_audio.numpy(), np.asarray(want_audio), rtol=1e-5, atol=1e-5)
    want = jm.forward(jp, input_ids=jnp.asarray(ids), input_features=jnp.asarray(feats),
                      config=jc, compute_dtype=jnp.float32)
    got = tm.forward(model, input_ids=torch.from_numpy(ids),
                     input_features=torch.from_numpy(feats), config=tc,
                     compute_dtype=torch.float32)
    assert got.shape == (2, 80, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # text only: the language model alone
    want = jm.forward(jp, input_ids=jnp.asarray(ids), config=jc, compute_dtype=jnp.float32)
    got = tm.forward(model, input_ids=torch.from_numpy(ids), config=tc,
                     compute_dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_hf_state_dict_matches_jax_and_round_trips():
    jp, jc, model, tc = _model(TINY, seed=3)
    want = jconvert.params_to_hf_state_dict(jc, jax.tree.map(np.asarray, jp))
    got = convert.params_to_hf_state_dict(tc, model.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    back = convert.params_from_hf_state_dict(tc, got, dtype=torch.bfloat16)
    assert back.keys() == model.state_dict().keys()
    assert all(t.dtype == torch.bfloat16 for t in back.values())
    again = convert.params_from_hf_state_dict(tc, got)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k
    # the tower alone, as the JAX converter's tower_from_hf / tower_to_hf
    tower = convert.tower_from_hf(got, tc.audio_config)
    assert convert.tower_to_hf(tower, tc.audio_config).keys() == {
        k for k in got if k.startswith("audio_tower.")}
    with pytest.raises(KeyError, match="audio_tower.layers.1.fc2.bias"):
        convert.params_from_hf_state_dict(
            tc, {k: v for k, v in got.items() if k != "audio_tower.layers.1.fc2.bias"})
    bad = dict(got)
    bad["multi_modal_projector.linear.weight"] = torch.zeros(64, 32)
    with pytest.raises(ValueError, match="multi_modal_projector"):
        convert.params_from_hf_state_dict(tc, bad)


def test_hf_config_dict_loads_in_both_packages():
    tc = Qwen2AudioConfig.from_dict(TINY_G7)
    d = convert.hf_config_dict(tc, "bfloat16")
    assert d["torch_dtype"] == "bfloat16" and d["audio_token_index"] == 60
    jc = JConfig.from_dict(d)
    back = Qwen2AudioConfig.from_dict(d)
    assert back.audio_config == tc.audio_config and jc.audio_config.__dict__ == \
        tc.audio_config.__dict__
    for f in ("hidden_size", "num_attention_heads", "num_key_value_heads", "head_dim",
              "attention_bias", "rope_theta", "tie_word_embeddings", "vocab_size"):
        assert getattr(back.text_config, f) == getattr(tc.text_config, f) == \
            getattr(jc.text_config, f), f


def test_config_turns_the_qwen2_biases_on():
    raw = copy.deepcopy(TINY)
    del raw["text_config"]["attention_bias"]
    assert Qwen2AudioConfig.from_dict(raw).text_config.attention_bias
    assert JConfig.from_dict(raw).text_config.attention_bias
    raw["text_config"]["attention_bias"] = False
    assert not Qwen2AudioConfig.from_dict(raw).text_config.attention_bias


def test_init_params_empty_model_and_counts():
    tc = Qwen2AudioConfig.from_dict(TINY)
    model = tm.init_params(tc, torch.Generator().manual_seed(0), torch.bfloat16)
    sd = model.state_dict()
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu" for t in sd.values())
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    table = tc.audio_config.max_source_positions * tc.audio_config.d_model
    assert sum(t.numel() for t in sd.values()) == tm.get_num_params(tc) + table
    assert tm.get_num_params(tc) == jm.get_num_params(JConfig.from_dict(TINY))
    w = sd["multi_modal_projector.linear.weight"].float()
    # kaiming uniform, bound sqrt(3 / fan_in), rounded to bf16
    assert w.abs().max() <= (3 / 64) ** 0.5 * (1 + 2**-8) and w.std() > 0.1
    assert (sd["multi_modal_projector.linear.bias"] == 0).all()
    assert (sd["language_model.model.layers.0.self_attn.q_proj.bias"] == 0).all()
    empty = tm.empty_model(tc, torch.bfloat16, "meta")
    assert all(p.dtype == torch.bfloat16 and p.is_meta for p in empty.parameters())
    assert empty.state_dict().keys() == sd.keys()
    jc = JConfig.from_dict(TINY)
    n = tm.get_num_params(tc)
    assert tm.get_num_flop_per_token(n, tc, 80) == jm.get_num_flop_per_token(n, jc, 80)


def test_qwen2_audio_7b_counts():
    """Qwen2-Audio-7B's config: the parameter count both packages give
    (8,283,699,200) and its bf16 bytes (16.57 GB, phase 12's export)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "..", "examples", "audio", "sft",
                        "asr", "wenetspeech", "config", "Qwen2-Audio-7B.json")
    tc, jc = Qwen2AudioConfig.from_json_file(path), JConfig.from_json_file(path)
    assert tm.get_num_params(tc) == jm.get_num_params(jc) == 8_283_699_200
    t = tc.text_config
    assert (t.num_attention_heads // t.num_key_value_heads, t.head_dim) == (7, 128)
    assert t.attention_bias and not t.tie_word_embeddings
    a = tc.audio_config
    assert (a.d_model // a.encoder_attention_heads, a.encoder_layers) == (64, 32)


@pytest.mark.parametrize("B,T,H,Hkv,D,dynamic", [
    (2, 150, 7, 1, 64, True),  # G 7, the text model's group; T off the tile
    (1, 200, 14, 2, 128, True),  # G 7 at D 128
    (2, 150, 4, 4, 64, False),  # G 1, the tower's MHA, static grid
])
def test_plain_k1_matches_jax_kernel(B, T, H, Hkv, D, dynamic):
    rng = np.random.default_rng(T + H)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    n0 = attn.flash_attention.launches
    out, _ = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  None, True)
    assert attn.flash_attention.launches == n0  # CPU: the plain version
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True,
                                 block_q=128, block_kv=128, use_pallas=True, interpret=True,
                                 dynamic=dynamic)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Hkv,G,D", [(1, 7, 64), (2, 7, 128), (3, 1, 64)])
def test_plain_k4_matches_jax_kernel(Hkv, G, D):
    rng = np.random.default_rng(Hkv * G + D)
    q = rng.standard_normal((3, Hkv * G, D)).astype(np.float32)
    kv = rng.standard_normal((3, Hkv, 640, 2 * D)).astype(np.float32)
    plen = np.asarray([500, 37, 1], np.int32)  # ragged prompts, one of a single token
    n0 = dec.decode_attention.launches
    got = dec.decode_attention(torch.from_numpy(q), torch.from_numpy(kv),
                               torch.from_numpy(plen), 512, 530)
    assert dec.decode_attention.launches == n0
    want = j_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(plen), 512, 530, block_s=256,
                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
