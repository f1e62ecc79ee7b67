# The port's entry points run on the card unless the caller names another
# device: with no card, Trainer and bin.train.main raise instead of training
# on the CPU (with each model family: llama, touch_audio, kimi_audio), and so
# do the touch_audio and kimi_audio ASR CLIs; empty_model
# (Llama, touch_audio, kimi_audio), init_cache and init_dual_cache default
# to "cuda"; init_params follows its generator's device.

import inspect
import os

import pytest
import torch

from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.models.kimi_audio import generate_kimi_audio as kimi_gen
from touchnet_tpu_torch.models.kimi_audio import inference_kimi_audio as kimi_cli
from touchnet_tpu_torch.models.kimi_audio import modeling_kimi_audio as kimi_model
from touchnet_tpu_torch.models.llama import inference_llama as inf
from touchnet_tpu_torch.models.llama import modeling_llama as tmodel
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.touch_audio import inference_touch_audio as ta_cli
from touchnet_tpu_torch.models.touch_audio import modeling_touch_audio as ta_model
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import TouchAudioConfig

CFG = os.path.join(os.path.dirname(__file__), "..", "assets", "config", "tiny_llama.json")
TA_CFG = os.path.join(os.path.dirname(__file__), "..", "assets", "config",
                      "tiny_touch_audio.json")


def _flags(tmp_path):
    args = {
        "tokenizer_type": "RawTokenizer", "tokenizer_raw_vocab_size": 64,
        "datapipe_type": "causal_lm", "datalist_path": tmp_path / "data.list",
        "dataset_batchsize": 1, "dataset_text_seqlen": 32,
        "training_model_config_path": CFG, "training_trace_dump_folder": tmp_path / "exp",
        "training_mixed_precision_param": "float32", "lr_scheduler_steps": 2,
    }
    return [x for k, v in args.items() for x in (f"--{k}", str(v))]


@pytest.mark.parametrize("entry", ["Trainer", "main"])
def test_training_without_a_card_raises(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if entry == "main":
            ttrain.main(_flags(tmp_path))
        else:
            from touchnet_tpu_torch.bin import TrainConfig
            from touchnet_tpu_torch.data import DataConfig
            from touchnet_tpu_torch.tokenizer import TokenizerConfig
            from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses

            tok, data, job = parse_args_into_dataclasses(
                [TokenizerConfig, DataConfig, TrainConfig], _flags(tmp_path))
            ttrain.Trainer(tok, data, job)


def test_init_params_follows_its_generator():
    cfg = LlamaConfig.from_json_file(CFG)
    model = tmodel.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert inspect.signature(tmodel.init_params).parameters["device"].default is None


@pytest.mark.parametrize("fn", [tmodel.empty_model, inf.init_cache, ta_model.empty_model,
                                kimi_model.empty_model, kimi_gen.init_dual_cache])
def test_model_and_cache_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_empty_model_and_cache_on_meta():
    cfg = LlamaConfig.from_json_file(CFG)
    model = tmodel.empty_model(cfg, device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}
    cache = inf.init_cache(cfg, 2, 16, torch.float32, "meta")
    assert cache.kv.device.type == "meta" and cache.kv.shape[1] == 2


def test_touch_audio_entry_points_take_the_card(tmp_path, monkeypatch):
    """The touch_audio init follows its generator; the ASR CLI and the
    trainer with the touch_audio model raise without a card."""
    cfg = TouchAudioConfig.from_json_file(TA_CFG)
    model = ta_model.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert inspect.signature(ta_model.init_params).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ta_cli.main(["--training_model_config_path", TA_CFG, "--model_path", str(tmp_path)])
    flags = _flags(tmp_path) + ["--training_model_name", "touch_audio",
                                "--training_model_config_path", TA_CFG,
                                "--datapipe_type", "touch_audio"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.main(flags)


def test_kimi_audio_cli_takes_the_card(tmp_path, monkeypatch):
    """The Kimi-Audio ASR CLI raises without a card, before it reads the
    export; its init follows its generator."""
    from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
    from test_torch_kimi_audio import TINY

    model = kimi_model.init_params(KimiAudioConfig.from_dict(TINY),
                                   torch.Generator(device="cpu").manual_seed(0))
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert inspect.signature(kimi_model.init_params).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kimi_cli.main(["--model_path", str(tmp_path / "missing")])


def test_kimi_audio_trainer_takes_the_card(tmp_path, monkeypatch):
    """bin.train.main with the kimi_audio model and datapipe raises without a
    card (before any weight or shard is read); the trainable init follows
    its generator too."""
    from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
    from test_torch_kimi_audio_sft import RAW

    cfg_file = tmp_path / "kimi.json"
    cfg_file.write_text(__import__("json").dumps(RAW))
    model = kimi_model.init_params(KimiAudioConfig.from_dict(RAW),
                                   torch.Generator(device="cpu").manual_seed(0),
                                   requires_grad=True, train=True)
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = _flags(tmp_path) + ["--training_model_name", "kimi_audio",
                                "--training_model_config_path", str(cfg_file),
                                "--datapipe_type", "kimi_audio", "--audiofeat_num_mel_bins",
                                str(RAW["speech_encoder_config"]["num_mel_bins"])]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.main(flags)
