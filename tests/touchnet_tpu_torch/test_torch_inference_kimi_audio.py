# The port's Kimi-Audio ASR CLI (models/kimi_audio/inference_kimi_audio.py)
# against the JAX CLI on the CPU, on the TINY config of
# test_torch_kimi_audio.py with real-size position tables (1500 frames:
# whisper features are padded to 30 s), JAX's weights written as an HF
# export (the port's converter and safetensors writer) with its config.json
# and a `tokenizers` char-level tokenizer holding Kimi's special tokens at
# the config's ids (chip_smoke.write_char_tokenizer), seeded wavs:
#   - main with stage 4's exact flags (chip_smoke.stage4_argv: f32, batch
#     1, no config and no tokenizer flag) plus max_length 6, batch 2 and the
#     output type, against the JAX CLI given the config and tokenizer
#     flags: the part files are equal for output_type text and for both
#     (key, txt, hyp and audio_codes), with the audio stream greedy on both
#     sides (the CLIs' default audio sampler draws, and torch's draws differ
#     from jax.random's);
#   - main with stage 4's exact flags alone writes a hyp for every key; its
#     twins: without the export's config.json the ValueError names
#     --training_model_config_path, without its tokenizer --tokenizer_model,
#     and a config.json of another model_type raises;
#   - each check the JAX CLI lacks raises: a wav over 30 s (naming its key
#     and seconds), blank or eos tokens of several ids, media markers at
#     other ids than the config's (before any weight is read), streams of
#     unequal length, a span between the markers of another length;
#   - without a card main raises, and an unknown output_type raises.

import functools
import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from touchnet_tpu.models.kimi_audio import generate_kimi_audio as jgen
from touchnet_tpu.models.kimi_audio import inference_kimi_audio as jcli
from touchnet_tpu_torch.models.kimi_audio import convert
from touchnet_tpu_torch.models.kimi_audio import generate_kimi_audio as tgen
from touchnet_tpu_torch.models.kimi_audio import inference_kimi_audio as cli
from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.inference import InferenceConfig
from touchnet_tpu_torch.utils.safetensors_io import write_safetensors
from test_torch_audio_frontend import synth_wave, write_audio_jsonl
from test_torch_kimi_audio import TINY, jax_tree

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

RAW = json.loads(json.dumps(TINY))
RAW["speech_encoder_config"]["max_source_positions"] = 1500
RAW["speech_tokenizer_config"]["max_source_positions"] = 1500
SPECIALS = {"<|im_media_begin|>": 200, "<|im_media_end|>": 201,
            "<|im_kimia_user_msg_start|>": 210, "<|im_kimia_assistant_msg_start|>": 211,
            "<|im_kimia_text_blank|>": 212, "<|im_kimia_text_eos|>": 213,
            "<|im_kimia_speech_ct_id|>": 214, "<|im_msg_end|>": 215}
EOS = "<|im_kimia_text_eos|>"


def _tokenizer(root, specials=SPECIALS):
    return str(chip_smoke.write_char_tokenizer(root, 256, specials, EOS,
                                               chip_smoke.STAGE4_INSTRUCT))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny model's JAX weights as an HF export holding config.json and
    the tokenizer, its config file, and a jsonl of 3 short wavs."""
    root = tmp_path_factory.mktemp("kimi_asr")
    cfg = KimiAudioConfig.from_dict(RAW)
    state = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jax_tree(RAW, seed=5)), cfg)
    hf = root / "hf"
    hf.mkdir()
    write_safetensors(convert.params_to_hf_state_dict(cfg, state), str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(convert.hf_config_dict(cfg, "float32")))
    _tokenizer(hf)
    cfg_file = root / "config.json"
    cfg_file.write_text(json.dumps(RAW))
    jsonl = write_audio_jsonl(str(root / "wav"), 3, seed=41, lo=0.5, hi=2.0)
    return dict(hf=str(hf), cfg=str(cfg_file), jsonl=jsonl, root=root, config=cfg)


def _greedy_audio(module, monkeypatch, settings):
    """The module's generate_dual with a greedy audio sampler."""
    monkeypatch.setattr(module, "generate_dual", functools.partial(
        module.generate_dual, audio_sampler=settings(temperature=0.0)))


@pytest.mark.parametrize("output_type", ["text", "both"])
def test_main_matches_the_jax_cli(tiny, tmp_path, monkeypatch, output_type):
    _greedy_audio(tgen, monkeypatch, tgen.SamplerSettings)
    _greedy_audio(cli, monkeypatch, tgen.SamplerSettings)
    _greedy_audio(jgen, monkeypatch, jgen.SamplerSettings)
    extra = ["--max_length", "6", "--batch_size", "2", "--output_type", output_type]
    port = chip_smoke.stage4_argv("kimi_audio", tiny["hf"], tiny["jsonl"], tmp_path / "port")
    path = cli.main(port + extra, device=torch.device("cpu"))
    jargv = chip_smoke.stage4_argv("kimi_audio", tiny["hf"], tiny["jsonl"], tmp_path / "jax")
    jcli.main(jargv + extra + ["--training_model_config_path", tiny["cfg"],
                               "--tokenizer_type", "HuggingFaceTokenizer",
                               "--tokenizer_model", tiny["hf"]])
    got = [json.loads(ln) for ln in open(path, encoding="utf8")]
    want = [json.loads(ln) for ln in open(tmp_path / "jax" / "part_0", encoding="utf8")]
    assert got == want
    assert [r["key"] for r in got] == ["utt0", "utt1", "utt2"]
    assert any(r["hyp"] for r in got)
    if output_type == "both":
        # the sampled ids past kimia_token_offset, offset removed
        assert all(0 <= c < 256 - 100 for r in got for c in r["audio_codes"])
        assert any(r["audio_codes"] for r in got)
    else:
        assert all("audio_codes" not in r for r in got)


STAGE4_FAULTS = ["none", "no_config", "no_tokenizer", "wrong_model_type"]
STAGE4_MAX_LENGTH = 6  # test_stage4_flags' default of new tokens


def run_stage4(cli_module, model_type: str, export, jsonl, tmp_path, fault: str,
               monkeypatch):
    """The CLI on a copy of the export (config.json and the tokenizer beside
    the weights) with stage 4's exact flags (run.sh:172-181). fault "none":
    returns the part file's rows. Else the copy lacks config.json, or the
    tokenizer, or its config.json names another model_type, and the
    ValueError must name the flag (or model_type) before any weight is
    read."""
    hf = tmp_path / "hf"
    shutil.copytree(export, hf)
    match = {"no_config": "--training_model_config_path",
             "no_tokenizer": "--tokenizer_model", "wrong_model_type": "model_type"}.get(fault)
    if fault == "no_config":
        os.remove(hf / "config.json")
    if fault == "no_tokenizer":
        for name in ("tokenizer.json", "tokenizer_config.json"):
            os.remove(hf / name)
    if fault == "wrong_model_type":
        raw = json.loads((hf / "config.json").read_text())
        other = "kimi_audio" if model_type != "kimi_audio" else "qwen2_audio"
        (hf / "config.json").write_text(json.dumps({**raw, "model_type": other}))
    argv = chip_smoke.stage4_argv(model_type, hf, jsonl, tmp_path / "out")
    if match is not None:
        monkeypatch.setattr(cli_module, "load_params", lambda *a: pytest.fail("weights read"))
        with pytest.raises(ValueError, match=match):
            cli_module.main(argv, device=torch.device("cpu"))
        return None
    path = cli_module.main(argv, device=torch.device("cpu"))
    return [json.loads(ln) for ln in open(path, encoding="utf8")]


@pytest.mark.parametrize("fault", STAGE4_FAULTS)
def test_stage4_flags(tiny, tmp_path, fault, monkeypatch):
    """run.sh:172-181 as written: the config and the tokenizer come from the
    export; a missing one raises naming its flag. The argv stays stage 4's;
    only the CLI's default of new tokens is lowered, so the tiny model does
    not decode 512 tokens for each utterance."""
    monkeypatch.setattr(InferenceConfig.__dataclass_fields__["max_length"], "default",
                        STAGE4_MAX_LENGTH)
    rows = run_stage4(cli, "kimi_audio", tiny["hf"], tiny["jsonl"], tmp_path, fault,
                      monkeypatch)
    if rows is not None:
        assert [r["key"] for r in rows] == ["utt0", "utt1", "utt2"]
        assert all(isinstance(r["hyp"], str) for r in rows) and any(r["hyp"] for r in rows)


def test_long_utterance_raises_naming_it(tiny, tmp_path):
    jsonl = tmp_path / "data.jsonl"
    long = tmp_path / "long.wav"
    wavfile.write(long, 16000, synth_wave(np.random.default_rng(3), 31.0))
    jsonl.write_text(open(tiny["jsonl"]).read()
                     + json.dumps({"key": "long", "wav": str(long), "txt": "x"}) + "\n")
    argv = chip_smoke.stage4_argv("kimi_audio", tiny["hf"], jsonl, tmp_path / "out")
    with pytest.raises(ValueError, match=r"utterance 'long': 31\.00 s of audio.*1500 frames"):
        cli.main(argv + ["--max_length", "2"], device=torch.device("cpu"))


@pytest.mark.parametrize("change,match", [
    ({"<|im_kimia_text_blank|>": None}, r"maps '<\|im_kimia_text_blank\|>' to \[\d+, \d+"),
    ({"<|im_kimia_text_eos|>": None, "<|endoftext|>": 216},
     r"maps '<\|im_kimia_text_eos\|>' to \[\d+, \d+"),
    ({"<|im_media_begin|>": 202}, r"maps '<\|im_media_begin\|>' to \[202\], not to \[200\]"),
    ({"<|im_media_end|>": None}, r"maps '<\|im_media_end\|>' to \[\d+, \d+"),
])
def test_setup_refuses_special_tokens_off_the_config(tiny, tmp_path, monkeypatch, change, match):
    specials = {k: v for k, v in {**SPECIALS, **change}.items() if v is not None}
    eos = EOS if EOS in specials else "<|endoftext|>"
    chip_smoke.write_char_tokenizer(tmp_path / "tok", 256, specials, eos,
                                    chip_smoke.STAGE4_INSTRUCT)
    monkeypatch.setattr(cli, "load_params", lambda *a: pytest.fail("weights read"))
    argv = chip_smoke.stage4_argv("kimi_audio", tiny["hf"], tiny["jsonl"], tmp_path / "out")
    with pytest.raises(ValueError, match=match):
        cli.main(argv + ["--tokenizer_model", str(tmp_path / "tok")], device=torch.device("cpu"))


class _Shifted:
    """The char tokenizer, except that one text maps to other ids."""

    def __init__(self, inner, text, ids):
        self.inner, self.text, self.ids = inner, text, ids

    def tokenize(self, text, add_special_tokens=False):
        if text == self.text:
            return list(self.ids)
        return self.inner.tokenize(text, add_special_tokens=add_special_tokens)


def test_prompt_streams_hold_the_span_and_refuse_misalignment(tiny):
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=tiny["hf"]))
    cfg = tiny["config"]
    instruct = chip_smoke.STAGE4_INSTRUCT
    text, audio = cli.prompt_streams(tok, instruct, 5, cfg)
    assert len(text) == len(audio) == 1 + len(instruct) + 1 + 5 + 4
    begin = list(audio).index(200)
    assert audio[begin + 6] == 201 and (audio[begin + 1:begin + 6] == 212).all()
    assert (text[len(instruct) + 1:len(instruct) + 7] == 212).all()
    # the instruct alone one id shorter than inside the text stream
    short = _Shifted(tok, instruct, tok.tokenize(instruct)[:-1])
    with pytest.raises(ValueError, match="the text stream has 38 ids, the audio stream 37"):
        cli.prompt_streams(short, instruct, 5, cfg)
    # a tokenizer that drops the audio stream's end marker
    audio_text = cli.KIMI_AUDIO_TEMPLATE_FOR_S2T.replace(
        "<|INSTRUCT|>", cli.BLANK * len(instruct)).replace("<|AUDIO|>", cli.BLANK * 5)
    dropped = _Shifted(tok, audio_text, [i for i in tok.tokenize(audio_text) if i != 201] + [212])
    with pytest.raises(ValueError, match="1 begin and 0 end markers around None positions"):
        cli.prompt_streams(dropped, instruct, 5, cfg)


def test_main_needs_a_card(tiny, tmp_path, monkeypatch):
    argv = chip_smoke.stage4_argv("kimi_audio", tiny["hf"], tiny["jsonl"], tmp_path)
    with pytest.raises(ValueError, match="output_type"):
        cli.main(argv + ["--output_type", "audio"], device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv)
