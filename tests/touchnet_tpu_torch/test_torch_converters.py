# Stages 1 and 3 of the recipes on the port against the JAX converter and
# transformers, on the CPU, hermetic (random tiny HF Llamas built in the
# test, tests/assets/config/tiny_llama.json's shapes):
#   - the port's safetensors reader and writer against the safetensors
#     package, both directions, every dtype the converters meet;
#   - stage 1 (convert_hf_to_ckpt), tied and untied, from safetensors (bf16,
#     as the published weights) and from pytorch_model.bin (f32): the seed's
#     tensors equal the JAX converter's params (load_hf_state_dict +
#     params_from_hf_state_dict, through params_from_jax_numpy) exactly, in
#     f32, and bin.train's Trainer starts from them and trains;
#   - stage 3 (convert_ckpt_to_hf --step -1 --config, the recipe's flags) on
#     a trained checkpoint of a config with llama3 rope_scaling: the export
#     reloads in transformers with tensors equal to the trainer's, and its
#     f32 logits at positions past original_max_position_embeddings equal
#     the port's forward at rtol 1e-5 (atol 1e-5 of the largest |logit|: the
#     two frameworks' summation orders). An HF model built from the JAX
#     exporter's ten-field config (no rope_scaling, no head_dim) misses them
#     by over 100x that. Without --tokenizer_model the converter imports no
#     transformers; with it the tokenizer is saved beside the weights.

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import transformers

from touchnet_tpu.bin.convert_hf_to_ckpt import load_hf_state_dict as jload_hf_state_dict
from touchnet_tpu.models.llama import convert as jconvert
from touchnet_tpu.models.llama.configuration_llama import LlamaConfig as JLlamaConfig
from touchnet_tpu_torch.bin import convert_ckpt_to_hf, convert_hf_to_ckpt
from touchnet_tpu_torch.models.llama import modeling_llama as tmodel
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import (
    hf_config_dict,
    params_from_hf_state_dict,
    params_from_jax_numpy,
    params_to_hf_state_dict,
)
from touchnet_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors
from test_torch_checkpoint import _run, _trainer
from test_torch_make_data import char_tokenizer_dir
from test_torch_train import CFG, _flags, build_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 32}


def _config_file(tmp_path, **over):
    raw = {**json.load(open(CFG)), **over}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _hf_model(cfg_path, seed, dtype):
    """A random transformers Llama of the config at ``cfg_path``."""
    hf_cfg = transformers.LlamaConfig(**hf_config_dict(LlamaConfig.from_json_file(cfg_path)))
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(hf_cfg).to(dtype).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64,
                                   torch.int32, torch.uint8, torch.bool])
def test_safetensors_io_matches_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {name: (torch.randn(shape, generator=gen) * 50).to(dtype)
               for name, shape in (("w", (17, 8)), ("b", (5,)), ("s", ()), ("e", (0, 3)))}
    save_file(tensors, str(tmp_path / "pkg.safetensors"))
    write_safetensors(tensors, str(tmp_path / "port.safetensors"))
    for got in (read_safetensors(str(tmp_path / "pkg.safetensors")),
                load_file(str(tmp_path / "port.safetensors")),
                read_safetensors(str(tmp_path / "port.safetensors"))):
        assert got.keys() == tensors.keys()
        for k, t in tensors.items():
            assert got[k].dtype == dtype and got[k].shape == t.shape and torch.equal(got[k], t)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_seed_checkpoint_equals_jax_converter(tmp_path, tied, fmt):
    cfg_path = _config_file(tmp_path, tie_word_embeddings=tied)
    dtype = torch.bfloat16 if fmt == "safetensors" else torch.float32
    hf_dir = tmp_path / "hf"
    _hf_model(cfg_path, 1, dtype).save_pretrained(hf_dir, safe_serialization=fmt == "safetensors")
    assert any(f.endswith(".bin" if fmt == "bin" else ".safetensors") for f in os.listdir(hf_dir))
    exp = tmp_path / "exp"
    step_dir = convert_hf_to_ckpt.main([
        "--huggingface_model", str(hf_dir), "--ckpt_dir", str(exp),
        "--training_model_config_path", cfg_path, "--model_type", "causal_lm"])
    assert step_dir == str(exp / "checkpoint" / "step_0")
    seed = convert_ckpt_to_hf.read_model(os.path.join(step_dir, "model"))

    jcfg = JLlamaConfig.from_json_file(cfg_path)
    tcfg = LlamaConfig.from_json_file(cfg_path)
    want = params_from_jax_numpy(
        jconvert.params_from_hf_state_dict(jcfg, jload_hf_state_dict(str(hf_dir))), tcfg)
    assert seed.keys() == want.keys() and ("lm_head.weight" in seed) == (not tied)
    for k in want:
        assert seed[k].dtype == torch.float32 and torch.equal(seed[k], want[k]), k

    listfile = build_corpus(tmp_path)
    trainer = _trainer(_flags(exp, listfile, 2, training_model_config_path=cfg_path,
                              training_trace_dump_folder=str(exp),
                              training_enable_ckpt="true", training_ckpt_interval=100))
    assert trainer.step == 0
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, seed[k]), k
    losses = _run(trainer)
    assert trainer.step == 2 and all(np.isfinite(losses))


def test_hf_state_dict_fallbacks():
    """An untied config over a checkpoint without lm_head takes a copy of
    the embedding (as JAX); q/k/v biases load under attention_bias and are
    refused without it; the export holds exactly the config's keys."""
    cfg = LlamaConfig.from_json_file(CFG)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    out = params_from_hf_state_dict(cfg, sd)
    assert torch.equal(out["lm_head.weight"], sd["model.embed_tokens.weight"])
    assert out["lm_head.weight"].data_ptr() != sd["model.embed_tokens.weight"].data_ptr()
    assert params_to_hf_state_dict(cfg, out).keys() == out.keys()
    biased = LlamaConfig.from_dict({**cfg.to_dict(), "attention_bias": True})
    bmodel = tmodel.init_params(biased, torch.Generator().manual_seed(0))
    got = params_from_hf_state_dict(biased, bmodel.state_dict())
    assert "model.layers.1.self_attn.k_proj.bias" in got
    with pytest.raises(ValueError, match="attention_bias"):
        params_from_hf_state_dict(cfg, {**model.state_dict(),
                                        "model.layers.0.self_attn.q_proj.bias": torch.ones(64)})
    with pytest.raises(KeyError, match="model.norm.weight"):
        params_from_hf_state_dict(cfg, {k: v for k, v in sd.items() if k != "model.norm.weight"})


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_export_reloads_in_transformers_under_llama3_rope(tmp_path, tied):
    cfg_path = _config_file(tmp_path, tie_word_embeddings=tied, rope_scaling=LLAMA3,
                            rope_theta=500000.0)
    listfile = build_corpus(tmp_path)
    exp = tmp_path / "exp"
    trainer = _trainer(_flags(exp, listfile, 2, training_model_config_path=cfg_path,
                              training_trace_dump_folder=str(exp),
                              training_enable_ckpt="true", training_ckpt_interval=100))
    _run(trainer)
    state = trainer.model.state_dict()
    argv = ["--ckpt_dir", str(exp), "--step", "-1", "--config", cfg_path,
            "--model_type", "causal_lm"]
    code = ("import sys; from touchnet_tpu_torch.bin.convert_ckpt_to_hf import main; "
            f"main({argv!r}); assert 'transformers' not in sys.modules, 'imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = exp / "checkpoint_hf" / "step-2"
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    assert {k: v for k, v in json.load(open(out / "config.json")).items()
            if k in ("rope_scaling", "head_dim", "tie_word_embeddings")} == \
        {"rope_scaling": LLAMA3, "head_dim": 16, "tie_word_embeddings": tied}
    for k, v in read_safetensors(str(out / "model.safetensors")).items():
        assert torch.equal(v, state[k]), k

    hf = transformers.LlamaForCausalLM.from_pretrained(out, torch_dtype=torch.float32,
                                                       attn_implementation="eager").eval()
    got = hf.state_dict()
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 96)))
    with torch.no_grad():
        want = tmodel.forward(trainer.model, input_ids=ids, config=trainer.model_config,
                              compute_dtype=torch.float32).numpy()
        logits = hf(ids).logits.numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5 * scale)

        # the JAX exporter's config: ten fields, plain RoPE
        m = trainer.model_config
        ten = transformers.LlamaConfig(
            vocab_size=m.vocab_size, hidden_size=m.hidden_size,
            intermediate_size=m.intermediate_size, num_hidden_layers=m.num_hidden_layers,
            num_attention_heads=m.num_attention_heads, num_key_value_heads=m.num_key_value_heads,
            max_position_embeddings=m.max_position_embeddings, rms_norm_eps=m.rms_norm_eps,
            rope_theta=m.rope_theta, tie_word_embeddings=m.tie_word_embeddings)
        jax_style = transformers.LlamaForCausalLM(ten).eval()
        jax_style.load_state_dict(got)
        # 100x the limit above (measured: 4.8e-3 and 6.5e-3 of the largest |logit|)
        assert np.abs(jax_style(ids).logits.numpy() - want).max() > 1e-3 * scale

    out_tok = convert_ckpt_to_hf.main(argv + ["--tokenizer_model",
                                              char_tokenizer_dir(tmp_path / "tok")])
    assert transformers.AutoTokenizer.from_pretrained(out_tok).decode([5, 6]) == "bc"


def test_export_step_resolution(tmp_path):
    for s in (3, 12, 7):
        os.makedirs(tmp_path / "checkpoint" / f"step_{s}")
    os.makedirs(tmp_path / "checkpoint" / "step_20.partial")
    assert convert_ckpt_to_hf.resolve_step(str(tmp_path), -1) == 12
    assert convert_ckpt_to_hf.resolve_step(str(tmp_path), 7) == 7
    with pytest.raises(FileNotFoundError, match="step_5"):
        convert_ckpt_to_hf.resolve_step(str(tmp_path), 5)


@pytest.mark.parametrize("model_type", ["touch_audio", "qwen2_audio", "kimi_audio"])
def test_converters_refuse_audio_model_types(tmp_path, model_type):
    """kimi_audio is a later slice. touch_audio and qwen2_audio convert
    (test_torch_touch_audio.py, test_torch_qwen2_audio_sft.py); touch_audio
    refuses a seed without the model config (the HF directory holds only
    the backbone's), qwen2_audio one whose directory has no config.json
    when no config is given, and both an export without a checkpoint."""
    if model_type in ("touch_audio", "qwen2_audio"):
        seed_error = ((ValueError, "training_model_config_path is required")
                      if model_type == "touch_audio" else (FileNotFoundError, "config.json"))
        with pytest.raises(seed_error[0], match=seed_error[1]):
            convert_hf_to_ckpt.main(["--ckpt_dir", str(tmp_path), "--model_type", model_type,
                                     "--huggingface_model", str(tmp_path)])
        with pytest.raises(FileNotFoundError, match="no step_<N>"):
            convert_ckpt_to_hf.main(["--ckpt_dir", str(tmp_path), "--model_type", model_type,
                                     "--step", "-1", "--config", CFG])
        return
    for main, extra in ((convert_hf_to_ckpt.main, ["--huggingface_model", str(tmp_path)]),
                        (convert_ckpt_to_hf.main, ["--step", "-1", "--config", CFG])):
        with pytest.raises(ValueError, match="later audio slice"):
            main(["--ckpt_dir", str(tmp_path), "--model_type", model_type] + extra)


@pytest.mark.parametrize("main, flag", [
    (convert_hf_to_ckpt.main, "--tmp_dir"),
    (convert_ckpt_to_hf.main, "--tmp_dir"),
], ids=["hf_to_ckpt", "ckpt_to_hf"])
def test_converters_refuse_flags_they_would_not_read(tmp_path, main, flag):
    """The JAX converters' --tmp_dir is not a flag of the port's: passing
    it is a parse error, not a value silently dropped."""
    with pytest.raises(SystemExit):
        main(["--ckpt_dir", str(tmp_path), flag, str(tmp_path)])


@pytest.mark.parametrize("main, args", [
    (convert_hf_to_ckpt.main, ["--huggingface_model", "x", "--tokenizer_model", "x"]),
    (convert_hf_to_ckpt.main, ["--huggingface_model", "x", "--step", "-1"]),
    (convert_hf_to_ckpt.main, ["--huggingface_model", "x", "--config", CFG]),
    (convert_ckpt_to_hf.main, ["--huggingface_model", "x", "--config", CFG]),
], ids=["hf_to_ckpt_tokenizer", "hf_to_ckpt_step", "hf_to_ckpt_config", "ckpt_to_hf_hf"])
def test_converters_refuse_the_other_converters_flags(tmp_path, main, args):
    """CkptConverterConfig serves both converters; a field one of them does
    not read raises there, naming it, before any file is touched."""
    with pytest.raises(ValueError, match="is not a flag of"):
        main(["--ckpt_dir", str(tmp_path)] + args)
