# The port's whisper encoder (touchnet_tpu_torch/models/whisper_encoder.py)
# against the JAX package's on the CPU, with the tower of the tiny
# qwen2_audio config of tests/touchnet_tpu/models/test_qwen2_audio.py (32
# mel bins, d_model 64, 2 layers, 4 heads, ffn 128, 100 positions), its
# weights carried over from JAX init_params (convert.tower_from_jax_numpy),
# seeded numpy features:
#   - forward in f32, causal and not, with and without the final LayerNorm,
#     and past max_source_positions (the tiled table): rtol/atol 1e-5 (only
#     summation order differs; the JAX side runs its plain attention,
#     use_pallas=False, as its own tests do on the CPU);
#   - against HF transformers' WhisperEncoder (non-causal, final LN) on the
#     port's state dict loaded as is: 3e-4, the JAX test's own tolerance;
#   - sinusoidal_positions and layer_norm (f32 and bf16) against JAX's;
#   - init_params (its table, norms, biases and spread) and get_num_params;
#   - the tower's attention goes through ops.attention.flash_attention (K1
#     on the card) once a layer, with no segment ids.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.models import whisper_encoder as jwe
from touchnet_tpu_torch.models import whisper_encoder as twe
from touchnet_tpu_torch.models.qwen2_audio.convert import tower_from_jax_numpy
from touchnet_tpu_torch.ops import attention as attn_ops

AUDIO = {"num_mel_bins": 32, "d_model": 64, "encoder_layers": 2, "encoder_attention_heads": 4,
         "encoder_ffn_dim": 128, "max_source_positions": 100}


def _tower(max_positions=100, seed=0):
    """(JAX params, JAX config, the port's tower with the same weights)."""
    cfg = dict(AUDIO, max_source_positions=max_positions)
    jcfg, tcfg = jwe.WhisperEncoderConfig.from_dict(cfg), twe.WhisperEncoderConfig.from_dict(cfg)
    jp = jwe.init_params(jcfg, jax.random.PRNGKey(seed))
    state = tower_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg)
    with torch.device("meta"):
        tower = twe.WhisperEncoder(tcfg)
    tower.to_empty(device="cpu")
    tower.load_state_dict(state)
    return jp, jcfg, tower.eval().requires_grad_(False), tcfg


@pytest.mark.parametrize("causal,final_ln,frames,positions", [
    (True, False, 120, 100),  # qwen2_audio's tower: causal, pooled before the LN
    (False, True, 120, 100),  # plain whisper
    (True, True, 121, 100),  # an odd frame count
    (False, False, 120, 100),
    (True, False, 260, 50),  # 130 positions over a 50-row table: tiled
])
def test_forward_matches_jax(causal, final_ln, frames, positions):
    jp, jcfg, tower, tcfg = _tower(positions)
    feats = np.random.default_rng(frames).standard_normal((2, 32, frames)).astype(np.float32)
    want = jwe.forward(jp, jnp.asarray(feats), jcfg, compute_dtype=jnp.float32, causal=causal,
                       use_pallas=False, apply_final_layer_norm=final_ln)
    n0 = attn_ops.flash_attention.launches
    got = twe.forward(tower, torch.from_numpy(feats), tcfg, compute_dtype=torch.float32,
                      causal=causal, apply_final_layer_norm=final_ln)
    assert attn_ops.flash_attention.launches == n0  # CPU tensors: the plain version
    assert got.shape == (2, (frames + 1) // 2, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_forward_attends_through_the_kernel_wrapper(monkeypatch):
    """Each layer calls ops.attention.flash_attention once, with no segment
    ids and the caller's causality; the call is looked up at run time."""
    _, _, tower, tcfg = _tower()
    calls = []
    real = attn_ops.flash_attention

    def spy(q, k, v, segment_ids=None, causal=True, scale=None, *a, **kw):
        calls.append((tuple(q.shape), segment_ids, causal, scale))
        return real(q, k, v, segment_ids, causal, scale, *a, **kw)

    monkeypatch.setattr(attn_ops, "flash_attention", spy)
    feats = torch.randn(1, 32, 40, generator=torch.Generator().manual_seed(0))
    twe.forward(tower, feats, tcfg, compute_dtype=torch.float32, causal=False)
    assert calls == [((1, 20, 4, 16), None, False, 0.25)] * 2


def test_matches_hf_whisper_encoder():
    transformers = pytest.importorskip("transformers")
    _, _, tower, tcfg = _tower(50, seed=1)
    hf_cfg = transformers.WhisperConfig(
        num_mel_bins=32, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, max_source_positions=50, decoder_layers=1,
        attn_implementation="eager")
    hf = transformers.models.whisper.modeling_whisper.WhisperEncoder(hf_cfg).eval()
    missing, unexpected = hf.load_state_dict(tower.state_dict(), strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    feats = np.random.default_rng(0).standard_normal((2, 32, 100)).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(feats)).last_hidden_state.numpy()
    got = twe.forward(tower, torch.from_numpy(feats), tcfg, compute_dtype=torch.float32,
                      causal=False, apply_final_layer_norm=True)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("length,channels", [(1500, 1280), (100, 64), (7, 4)])
def test_sinusoidal_positions_match_jax(length, channels):
    """atol 2.5e-4: XLA's and torch's f32 exp differ in the last bit, and the
    sine's argument (position x timescale) carries that ulp times the
    position; at 1500 an ulp of the argument is 1.2e-4."""
    got = twe.sinusoidal_positions(length, channels)
    want = np.asarray(jwe.sinusoidal_positions(length, channels))
    assert got.dtype == torch.float32 and got.shape == (length, channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """f32 arithmetic, then a cast back to the input's dtype: bit for bit in
    bf16, 1e-6 in f32."""
    rng = np.random.default_rng(3)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((4, 9, 64), (64,), (64,)))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = twe.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                         torch.from_numpy(b).to(tdt))
    want = jwe.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_init_params_and_num_params():
    cfg = twe.WhisperEncoderConfig.from_dict(AUDIO)
    tower = twe.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    sd = tower.state_dict()
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu" for t in sd.values())
    assert not any(p.requires_grad for p in tower.parameters()) and not tower.training
    # the table in bf16: half a bf16 ulp at |x| <= 1 (1.95e-3) from the f32 one
    np.testing.assert_allclose(sd["embed_positions.weight"].float().numpy(),
                               np.asarray(jwe.sinusoidal_positions(100, 64)), rtol=0,
                               atol=2.5e-3)
    assert (sd["layer_norm.weight"] == 1).all() and (sd["layers.1.fc2.bias"] == 0).all()
    assert "layers.0.self_attn.k_proj.bias" not in sd
    std = sd["layers.0.fc1.weight"].float().std().item()
    assert 0.017 < std < 0.023  # normal(0, 0.02)
    n = sum(t.numel() for k, t in sd.items() if k != "embed_positions.weight")
    assert n == twe.get_num_params(cfg) == jwe.get_num_params(
        jwe.WhisperEncoderConfig.from_dict(AUDIO))
    full = twe.WhisperEncoderConfig()  # Qwen2-Audio-7B's tower
    assert twe.get_num_params(full) == jwe.get_num_params(jwe.WhisperEncoderConfig())
