# The port's qwen2_audio ASR CLI (models/qwen2_audio/inference_qwen2_audio.py)
# and whisper features (processing_qwen2_audio.py) against the JAX package
# on the CPU, on the TINY config of test_torch_qwen2_audio.py:
#   - whisper_features against JAX's: features atol 1e-6 and the frame mask
#     exact, for a short utterance, one past 30 s (every frame of the mask
#     on) and 8 kHz input (resampled to 16 kHz);
#   - main on the CPU (f32) against the JAX CLI's main on the same HF
#     directory (JAX weights written by the port's converter and
#     safetensors writer), the same wavs (one of 31 s: 775 audio tokens over
#     a 100-row position table, tiled) and the same tokenizer (a
#     `tokenizers` char-level model with the special tokens at the config's
#     ids, built by chip_smoke.write_char_tokenizer): the part files are
#     equal, key, txt and hyp;
#   - the setup check: a tokenizer whose <|AUDIO|> is another id, or not a
#     token at all, raises before any weight is read; a prompt with fewer
#     audio ids than frames raises;
#   - without a card main raises, and output_type "both" raises, as in JAX;
#   - stage 4 of the SFT recipe as run.sh writes it (chip_smoke.stage4_argv:
#     bf16, batch 16, no config and no tokenizer flag) on an export holding
#     config.json and the tokenizer: a hyp for every key; without the
#     config, or the tokenizer, the ValueError names the flag, and a
#     config.json of another model_type raises
#     (test_torch_inference_kimi_audio.run_stage4).

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from touchnet_tpu.models.qwen2_audio import inference_qwen2_audio as jcli
from touchnet_tpu.models.qwen2_audio import processing_qwen2_audio as jproc
from touchnet_tpu_torch.models.qwen2_audio import convert
from touchnet_tpu_torch.models.qwen2_audio import inference_qwen2_audio as cli
from touchnet_tpu_torch.models.qwen2_audio import processing_qwen2_audio as proc
from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.safetensors_io import write_safetensors
from test_torch_audio_frontend import synth_wave, write_audio_jsonl
from test_torch_inference_kimi_audio import STAGE4_FAULTS, run_stage4
from test_torch_qwen2_audio import TINY

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SPECIALS = {"<|endoftext|>": 57, "<|audio_bos|>": 58, "<|audio_eos|>": 59, "<|AUDIO|>": 60}
INSTRUCT = "Generate the transcription:"


def _tokenizer(root, specials=SPECIALS):
    return str(chip_smoke.write_char_tokenizer(root, 64, specials, "<|endoftext|>", INSTRUCT))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The TINY model's JAX weights as an HF directory, its config file, a
    char tokenizer, and a jsonl of 3 short wavs and one of 31 s."""
    import jax

    from touchnet_tpu.models.qwen2_audio import modeling_qwen2_audio as jm
    from touchnet_tpu.models.qwen2_audio.configuration_qwen2_audio import (
        Qwen2AudioConfig as JConfig,
    )

    root = tmp_path_factory.mktemp("qwen2_asr")
    tc = Qwen2AudioConfig.from_dict(TINY)
    jp = jm.init_params(JConfig.from_dict(TINY), jax.random.PRNGKey(5))
    state = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jp), tc)
    hf = root / "hf"
    hf.mkdir()
    write_safetensors(convert.params_to_hf_state_dict(tc, state), str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(convert.hf_config_dict(tc)))
    cfg = root / "config.json"
    cfg.write_text(json.dumps(TINY))
    jsonl = write_audio_jsonl(str(root / "wav"), 3, seed=31, lo=0.5, hi=2.0)
    long = root / "wav" / "long.wav"
    wavfile.write(long, 16000, synth_wave(np.random.default_rng(32), 31.0))
    with open(jsonl, "a") as f:
        f.write(json.dumps({"key": "long", "wav": str(long), "txt": "long one"}) + "\n")
    return dict(hf=str(hf), cfg=str(cfg), jsonl=jsonl, tok=_tokenizer(root / "tok"), root=root)


def _argv(tiny, out, tok=None, *extra):
    return ["--model_path", tiny["hf"], "--training_model_config_path", tiny["cfg"],
            "--data_list", tiny["jsonl"], "--output_dir", str(out), "--batch_size", "2",
            "--max_length", "6", "--model_dtype", "float32", "--num_workers", "2",
            "--instruct", INSTRUCT, "--tokenizer_type", "HuggingFaceTokenizer",
            "--tokenizer_model", tok or tiny["tok"], *extra]


@pytest.mark.parametrize("seconds,rate", [(1.3, 16000), (31.0, 16000), (2.0, 8000)])
def test_whisper_features_match_jax(seconds, rate):
    wav = synth_wave(np.random.default_rng(int(seconds * 10)), seconds * rate / 16000)
    wav = wav.astype(np.float32) / 32768.0
    got, got_mask = proc.whisper_features(wav, rate, 32)
    want, want_mask = jproc.whisper_features(wav, rate, 32)
    frames = max(3000, int(seconds * 100))
    assert got.shape == (frames, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.all() if seconds > 30 else got_mask.sum() == int(seconds * 100)
    assert proc.QWEN2_AUDIO_TEMPLATE_FOR_S2T == jproc.QWEN2_AUDIO_TEMPLATE_FOR_S2T


def test_main_matches_the_jax_cli(tiny, tmp_path):
    path = cli.main(_argv(tiny, tmp_path / "port"), device=torch.device("cpu"))
    jcli.main(_argv(tiny, tmp_path / "jax"))
    got = [json.loads(ln) for ln in open(path, encoding="utf8")]
    want = [json.loads(ln) for ln in open(tmp_path / "jax" / "part_0", encoding="utf8")]
    keys = [json.loads(ln)["key"] for ln in open(tiny["jsonl"])]
    assert [r["key"] for r in got] == keys and keys[-1] == "long"
    assert got == want
    assert all(isinstance(r["hyp"], str) for r in got) and any(r["hyp"] for r in got)


def test_prompts_hold_one_audio_id_a_frame(tiny):
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=tiny["tok"]))
    proc.check_audio_token(proc.ManualQwen2AudioFrontend(tok), 60)
    for frames, n in ((100, 25), (3000, 750), (3100, 775)):
        ids = cli.prompt_ids(tok, INSTRUCT, frames, 60)
        # the instruct's characters take the first ids: "G" is 0
        assert list(ids[:2]) == [58, 60] and list(ids[n + 1:n + 3]) == [59, 0]
        assert (ids == 60).sum() == n and len(ids) == n + 2 + len(INSTRUCT)

    class Merging:  # one id for the token alone, two audio ids for any span
        def tokenize(self, text, add_special_tokens=False):
            return [60] if text == cli.AUDIO_TOKEN else [58, 60, 60, 59]

    proc.check_audio_token(proc.ManualQwen2AudioFrontend(Merging()), 60)
    with pytest.raises(ValueError, match="holds 2 audio ids for 25 audio frames"):
        cli.prompt_ids(Merging(), INSTRUCT, 100, 60)


@pytest.mark.parametrize("specials,match", [
    ({**SPECIALS, "<|AUDIO|>": 61}, r"maps '<\|AUDIO\|>' to \[61\]"),
    ({k: v for k, v in SPECIALS.items() if k != "<|AUDIO|>"},  # split into characters
     r"maps '<\|AUDIO\|>' to \[\d+, \d+, "),
])
def test_main_refuses_a_tokenizer_without_the_audio_id(tiny, tmp_path, specials, match,
                                                       monkeypatch):
    tok = _tokenizer(tmp_path / "tok", specials)
    monkeypatch.setattr(cli, "load_params", lambda *a: pytest.fail("weights read"))
    with pytest.raises(ValueError, match=match):
        cli.main(_argv(tiny, tmp_path / "out", tok), device=torch.device("cpu"))


def test_main_needs_a_card(tiny, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="output_type"):
        cli.main(_argv(tiny, tmp_path, None, "--output_type", "both"),
                 device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(_argv(tiny, tmp_path))


@pytest.mark.parametrize("fault", STAGE4_FAULTS)
def test_stage4_flags(tiny, tmp_path, fault, monkeypatch):
    export = tmp_path / "export"
    shutil.copytree(tiny["hf"], export)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(tiny["tok"], name), export / name)
    rows = run_stage4(cli, "qwen2_audio", export, tiny["jsonl"], tmp_path, fault, monkeypatch)
    if rows is not None:
        keys = [json.loads(ln)["key"] for ln in open(tiny["jsonl"])]
        assert [r["key"] for r in rows] == keys
        assert all(isinstance(r["hyp"], str) for r in rows) and any(r["hyp"] for r in rows)
