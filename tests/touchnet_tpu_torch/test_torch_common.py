# touchnet_tpu_torch building blocks against touchnet_tpu on the CPU: the
# shared ops (f32, atol 1e-5), the copied LlamaConfig, weight init and the
# JAX-tree converter. Inputs come from numpy with a fixed seed.

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.models import common as jcommon
from touchnet_tpu.models.llama.configuration_llama import LlamaConfig as JLlamaConfig
from touchnet_tpu.models.llama.modeling_llama import get_num_params as j_get_num_params
from touchnet_tpu.models.llama.modeling_llama import init_params as j_init_params
from touchnet_tpu_torch.models import common
from touchnet_tpu_torch.models.llama import check_finite_params, head_weight
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.models.llama.modeling_llama import (
    empty_model,
    get_num_params,
    init_params,
)

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
LLAMA_1B = os.path.join(
    ROOT, "examples", "text", "pretrain", "fineweb-edu", "config", "Llama-3_2-1B.json"
)
TINY = os.path.join(ROOT, "tests", "assets", "config", "tiny_llama.json")
ATOL = 1e-5


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _np(rng, (3, 5, 64)), _np(rng, (64,))
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cfg_path", [TINY, LLAMA_1B], ids=["tiny", "llama_3_2_1b"])
def test_rope_frequencies(cfg_path):
    """Includes Llama-3.2-1B's llama3 rope scaling (factor 32, theta 5e5)."""
    with open(cfg_path) as f:
        d = json.load(f)
    cfg = LlamaConfig.from_dict(d)
    want = jcommon.rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                    rope_scaling=cfg.rope_scaling)
    got = common.rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                  rope_scaling=cfg.rope_scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)


def test_apply_rope():
    rng = np.random.default_rng(1)
    B, T, H, Hkv, D = 2, 7, 4, 2, 64
    q, k = _np(rng, (B, T, H, D)), _np(rng, (B, T, Hkv, D))
    pos = rng.integers(0, 5000, (B, T)).astype(np.int32)
    with open(LLAMA_1B) as f:
        scaling = json.load(f)["rope_scaling"]
    jf = jcommon.rope_frequencies(D, 500000.0, rope_scaling=scaling)
    tf = common.rope_frequencies(D, 500000.0, rope_scaling=scaling)
    jq, jk = jcommon.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), jf)
    tq, tk = common.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(pos), tf)
    # angles reach 5000 rad: f32 trig of equal inputs agrees to ~1e-5 there
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=5 * ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=5 * ATOL)


def test_apply_rope_short_positions():
    rng = np.random.default_rng(2)
    q, k = _np(rng, (1, 9, 2, 16)), _np(rng, (1, 9, 1, 16))
    pos = np.arange(9, dtype=np.int32)[None]
    jq, jk = jcommon.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                                jcommon.rope_frequencies(16))
    tq, tk = common.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(pos), common.rope_frequencies(16))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)


def test_linear_and_swiglu():
    rng = np.random.default_rng(3)
    x = _np(rng, (2, 3, 32))
    g, u, d = _np(rng, (48, 32)) * 0.2, _np(rng, (48, 32)) * 0.2, _np(rng, (32, 48)) * 0.2
    b = _np(rng, (48,))
    np.testing.assert_allclose(
        common.linear(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)).numpy(),
        np.asarray(jcommon.linear(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
        atol=ATOL,
    )
    want = jcommon.swiglu(*(jnp.asarray(a) for a in (x, g, u, d)))
    got = common.swiglu(*(torch.from_numpy(a) for a in (x, g, u, d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_normal_init_uses_the_generator():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = common.normal_init(g1, (256, 64), std=0.02, dtype=torch.bfloat16)
    b = common.normal_init(g2, (256, 64), std=0.02, dtype=torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert abs(a.float().std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("cfg_path", [TINY, LLAMA_1B], ids=["tiny", "llama_3_2_1b"])
def test_config_copy_keeps_the_schema(cfg_path):
    with open(cfg_path) as f:
        d = json.load(f)
    got, want = LlamaConfig.from_dict(d).to_dict(), JLlamaConfig.from_dict(d).to_dict()
    assert got == want


@pytest.mark.parametrize("impl,want", [
    ("flash", "flash"), ("flash_static", "flash"), ("flash_grouped", "flash"),
    ("eager", "eager"),
])
def test_config_attn_implementation(impl, want):
    assert LlamaConfig(attn_implementation=impl).attn_implementation == want


def test_config_rejects_unknown_attention():
    with pytest.raises(ValueError):
        LlamaConfig(attn_implementation="splash")


@pytest.mark.parametrize("cfg_path", [TINY, LLAMA_1B], ids=["tiny", "llama_3_2_1b"])
def test_get_num_params_matches_jax(cfg_path):
    cfg = LlamaConfig.from_json_file(cfg_path)
    jcfg = JLlamaConfig.from_json_file(cfg_path)
    for ex in (False, True):
        assert get_num_params(cfg, ex) == j_get_num_params(jcfg, ex)
    model = empty_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == get_num_params(cfg)


def test_init_params_semantics():
    cfg = LlamaConfig.from_json_file(TINY)
    model = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        if name.endswith("norm.weight"):
            assert (p == 1).all(), name
        else:
            assert abs(p.float().std().item() - cfg.initializer_range) < 5e-3, name
    check_finite_params(model)
    again = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    with torch.no_grad():
        model.model.norm.weight[0] = float("nan")
    with pytest.raises(ValueError, match="model.norm.weight"):
        check_finite_params(model)


@pytest.mark.parametrize("tied", [False, True])
def test_params_from_jax_numpy(tied):
    with open(TINY) as f:
        d = json.load(f)
    d["tie_word_embeddings"] = tied
    d["attention_bias"] = True
    cfg, jcfg = LlamaConfig.from_dict(d), JLlamaConfig.from_dict(d)
    params = j_init_params(jcfg, jax.random.PRNGKey(0))
    state = params_from_jax_numpy(jax.tree.map(np.asarray, params), cfg)
    model = empty_model(cfg)
    model.load_state_dict(state, strict=True)
    lp = params["model"]["layers"]
    np.testing.assert_array_equal(
        model.model.layers[1].self_attn.q_proj.weight.numpy(),
        np.asarray(lp["self_attn"]["q_proj"]["weight"][1]),
    )
    np.testing.assert_array_equal(
        model.model.layers[0].self_attn.k_proj.bias.numpy(),
        np.asarray(lp["self_attn"]["k_proj"]["bias"][0]),
    )
    want_head = params["model"]["embed_tokens"] if tied else params["lm_head"]
    np.testing.assert_array_equal(head_weight(model, cfg).numpy(),
                                  np.asarray(want_head["weight"]))
