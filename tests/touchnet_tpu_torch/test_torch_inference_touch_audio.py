# The port's ASR CLI for TouchAudioForCausalLM
# (models/touch_audio/inference_touch_audio.py) and utils/inference.py
# against the JAX package on the CPU, tiny config
# (tests/assets/config/tiny_touch_audio.json), seeded wavs. The JAX CLI's
# own test is marked slow, so the comparison is at the function level:
#   - each utterance's prompt (the stacked fbank features projected, then
#     the bos embedding) against the JAX CLI's prepare (its compute_features
#     and the same concatenation on the JAX params in the same dtype): atol
#     1e-5;
#   - the greedy tokens of the port's generate under the CLI's decode
#     settings against JAX generate on the same prompts: equal;
#   - main on the CPU writes part_0 with a hyp for every key, equal to the
#     tokens of that comparison; without a card it raises; features of
#     another width raise at setup;
#   - batched, pad_right, prefetch_map, part_file and write_results equal
#     JAX's;
#   - stage 4 of the SFT recipe as run.sh writes it (chip_smoke.stage4_argv:
#     bf16, batch 16, an empty instruct, no config, tokenizer or feature
#     flag) on an export holding config.json and an HF tokenizer (a
#     `tokenizers` char-level model with eos/pad and bos): a hyp for every
#     key; without the config, or the tokenizer, the ValueError names the
#     flag, and a config.json of another model_type raises
#     (test_torch_inference_kimi_audio.run_stage4).

import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.models.llama import inference_llama as jinf
from touchnet_tpu.models.touch_audio import inference_touch_audio as jcli
from touchnet_tpu.models.touch_audio import modeling_touch_audio as jmodel
from touchnet_tpu.models.touch_audio.configuration_touch_audio import (
    TouchAudioConfig as JTouchAudioConfig,
)
from touchnet_tpu.utils import inference as jutils
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.llama.inference_llama import generate
from touchnet_tpu_torch.models.touch_audio import convert
from touchnet_tpu_torch.models.touch_audio import inference_touch_audio as cli
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import TouchAudioConfig
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils import inference as utils
from touchnet_tpu_torch.utils.safetensors_io import write_safetensors
from test_torch_audio_frontend import jax_native, jax_native_dir, write_audio_jsonl  # noqa: F401
from test_torch_inference_kimi_audio import STAGE4_FAULTS, chip_smoke, run_stage4

CFG = os.path.join(os.path.dirname(__file__), "..", "assets", "config", "tiny_touch_audio.json")
NEW = 12
TOK = ["--tokenizer_type", "RawTokenizer", "--tokenizer_raw_vocab_size", "64"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX params from a key, the same weights as an HF directory, and a
    jsonl of 5 seeded wavs."""
    root = tmp_path_factory.mktemp("asr")
    jcfg, tcfg = JTouchAudioConfig.from_json_file(CFG), TouchAudioConfig.from_json_file(CFG)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    state = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    hf = root / "hf"
    hf.mkdir()
    write_safetensors(convert.params_to_hf_state_dict(tcfg, state), str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(convert.hf_config_dict(tcfg)))
    jsonl = write_audio_jsonl(root / "wav", 5, seed=21, lo=0.5, hi=2.0)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, hf=str(hf), jsonl=jsonl, root=root)


def _argv(tiny, out, *extra):
    return ["--model_path", tiny["hf"], "--training_model_config_path", CFG,
            "--data_list", tiny["jsonl"], "--output_dir", str(out), "--batch_size", "2",
            "--max_length", str(NEW), "--model_dtype", "float32", "--num_workers", "2", *TOK,
            *extra]


def _jax_prompts(tiny, samples):
    """The JAX CLI's prepare (:265-272) on the JAX params."""
    jp = tiny["jparams"]
    proj = np.asarray(jp["projector"]["weight"], np.float32)
    bos = build_tokenizer(TokenizerConfig(tokenizer_type="RawTokenizer")).bos
    bos_emb = np.asarray(jp["language_model"]["model"]["embed_tokens"]["weight"],
                         np.float32)[bos][None]
    cfg = JDataConfig()
    return [np.concatenate([jcli.compute_features(s, cfg).astype(np.float32) @ proj.T,
                            bos_emb], axis=0) for s in samples]


def _port_prompts(tiny):
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="RawTokenizer",
                                          tokenizer_raw_vocab_size=64))
    config = utils.InferenceConfig(model_path=tiny["hf"])
    model = cli.load_params(config, tiny["tcfg"], torch.float32, torch.device("cpu"))
    proj, bos_emb = cli.prompt_parts(model, tok)
    samples = [utils.AudioJsonlDataset.load(s)
               for s in utils.AudioJsonlDataset(tiny["jsonl"]).samples]
    return model, tok, samples, [cli.make_prompt(cli.compute_features(copy.deepcopy(s),
                                                                      DataConfig()), proj,
                                                 bos_emb) for s in samples]


def test_prompts_and_greedy_tokens_match_jax(tiny, jax_native):
    model, tok, samples, prompts = _port_prompts(tiny)
    want_prompts = _jax_prompts(tiny, [jutils.AudioJsonlDataset.load(s) for s in
                                       jutils.AudioJsonlDataset(tiny["jsonl"]).samples])
    assert len(prompts) == len(want_prompts) == 5
    for g, w in zip(prompts, want_prompts):
        assert g.shape == w.shape and g.shape[1] == tiny["tcfg"].text_config.hidden_size
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    lens = np.asarray([p.shape[0] for p in prompts], np.int32)
    padded = utils.pad_right(prompts, 0.0)
    kw = cli.decode_kwargs(tok, NEW)
    got = generate(model.language_model, tiny["tcfg"].text_config, torch.from_numpy(padded),
                   torch.from_numpy(lens), NEW, compute_dtype=torch.float32, **kw)
    want = jinf.generate(tiny["jparams"]["language_model"], tiny["jcfg"].text_config,
                         jnp.asarray(padded), jnp.asarray(lens), NEW,
                         compute_dtype=jnp.float32, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert kw["prime_tokens"] == (0, 0, 1) and kw["repetition_window"] == NEW


def test_main_writes_a_hyp_for_every_key(tiny, tmp_path):
    path = cli.main(_argv(tiny, tmp_path / "out"), device=torch.device("cpu"))
    assert path == str(tmp_path / "out" / "part_0")
    rows = [json.loads(ln) for ln in open(path)]
    keys = [json.loads(ln)["key"] for ln in open(tiny["jsonl"])]
    assert [r["key"] for r in rows] == keys
    model, tok, _, prompts = _port_prompts(tiny)
    lens = torch.tensor([p.shape[0] for p in prompts])
    toks = []
    for i in range(0, len(prompts), 2):  # the CLI's batches of 2
        out = generate(model.language_model, tiny["tcfg"].text_config,
                       torch.from_numpy(utils.pad_right(prompts[i:i + 2], 0.0)),
                       lens[i:i + 2], NEW, compute_dtype=torch.float32,
                       **cli.decode_kwargs(tok, NEW))
        toks += [[t for t in row if t != tok.eos] for row in out.tolist()]
    assert [r["hyp"] for r in rows] == toks
    assert all("hyp" in r and r["txt"] for r in rows)


def test_main_in_float16_matches_the_jax_cli(tiny, tmp_path, jax_native):
    """--model_dtype float16 (the weights cast to f16, an f16 cache, K1's
    and K4's plain versions in f16 on the CPU): the part file equals the
    JAX CLI's at --model_dtype float16 on the same HF directory and wavs,
    key for key and hyp for hyp."""
    path = cli.main(_argv(tiny, tmp_path / "port", "--model_dtype", "float16"),
                    device=torch.device("cpu"))
    jcli.main(_argv(tiny, tmp_path / "jax", "--model_dtype", "float16"))
    got = [json.loads(ln) for ln in open(path)]
    want = [json.loads(ln) for ln in open(tmp_path / "jax" / "part_0")]
    assert [r["key"] for r in got] == [json.loads(ln)["key"] for ln in open(tiny["jsonl"])]
    assert got == want and any(r["hyp"] for r in got)


def test_main_needs_a_card_and_fitting_features(tiny, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="projector takes input_size 161"):
        cli.main(_argv(tiny, tmp_path, "--audiofeat_num_mel_bins", "80"),
                 device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(_argv(tiny, tmp_path))
    with pytest.raises(ValueError, match="output_type"):
        cli.main(_argv(tiny, tmp_path, "--output_type", "both"), device=torch.device("cpu"))


def test_inference_utils_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((int(n), 3)).astype(np.float32) for n in (4, 1, 6)]
    np.testing.assert_array_equal(utils.pad_right(arrays, -1.0), jutils.pad_right(arrays, -1.0))
    assert list(utils.batched(range(7), 3)) == list(jutils.batched(range(7), 3))
    for workers in (0, 3):
        got = list(utils.prefetch_map(lambda x: x * x, range(20), workers, 4))
        assert got == list(jutils.prefetch_map(lambda x: x * x, range(20), workers, 4))
    assert utils.part_file(str(tmp_path / "a"), 3) == jutils.part_file(str(tmp_path / "a"), 3)
    results = [{"key": "k1", "txt": "x", "hyp": [1, 2]}, {"key": "k2", "txt": "ü", "hyp": "a"}]
    utils.write_results(str(tmp_path / "p"), results)
    jutils.write_results(str(tmp_path / "q"), results)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "q").read_bytes()
    assert utils.InferenceConfig().__dict__ == jutils.InferenceConfig().__dict__
    assert utils.torch_dtype("bfloat16") is torch.bfloat16
    # every name of JAX's jnp_dtype maps (float16 too); another one raises
    for name in ("bfloat16", "float32", "float16"):
        assert utils.torch_dtype(name) == getattr(torch, name)
        assert jnp.dtype(jutils.jnp_dtype(name)).name == name
    with pytest.raises(ValueError, match="float64"):
        utils.torch_dtype("float64")


@pytest.mark.parametrize("fault", STAGE4_FAULTS)
def test_stage4_flags(tiny, tmp_path, fault, monkeypatch):
    export = tmp_path / "export"
    shutil.copytree(tiny["hf"], export)
    chip_smoke.write_char_tokenizer(export, 64, {"<|endoftext|>": 61, "<s>": 62},
                                    "<|endoftext|>")
    tok_cfg = json.loads((export / "tokenizer_config.json").read_text())
    (export / "tokenizer_config.json").write_text(json.dumps({**tok_cfg, "bos_token": "<s>"}))
    rows = run_stage4(cli, "touch_audio", export, tiny["jsonl"], tmp_path, fault, monkeypatch)
    if rows is not None:
        keys = [json.loads(ln)["key"] for ln in open(tiny["jsonl"])]
        assert [r["key"] for r in rows] == keys
        assert all(isinstance(r["hyp"], str) for r in rows) and any(r["hyp"] for r in rows)
