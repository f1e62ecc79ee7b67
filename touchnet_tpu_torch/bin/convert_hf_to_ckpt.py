# Copyright (c) 2026 touchnet_tpu authors.
# Stage 1 of the recipes: an HF model directory -> the seed checkpoint
# <ckpt_dir>/checkpoint/step_0/model, which the trainer takes as a
# model-only seed (training_ckpt_load_step 0, or -1 while it is the only step).
#
#     python -m touchnet_tpu_torch.bin.convert_hf_to_ckpt --ckpt_dir <exp> \
#         --huggingface_model <hf dir> --training_model_config_path <cfg> \
#         --model_type causal_lm | touch_audio | qwen2_audio
#
# Port of touchnet_tpu/bin/convert_hf_to_ckpt.py: load_hf_state_dict
# (:20-47; *.safetensors through the port's own reader, else
# pytorch_model*.bin through torch.load) and convert (:50-115) for
# causal_lm, touch_audio (a text backbone's HF weights under
# language_model. and a fresh projector drawn from torch.Generator seed 0,
# models/touch_audio/convert.py) and qwen2_audio (the whole
# Qwen2AudioForConditionalGeneration, :75-85, models/qwen2_audio/
# convert.py; the config from --training_model_config_path, else the HF
# directory's config.json). The seed is written with torch.distributed.checkpoint in one
# process, in the layout of utils/checkpoint.py, as f32 masters: HF
# weights are bf16, the trainer's masters f32, and its load refuses a dtype
# that differs (JAX upcasts at load, :31-33). Host-only. kimi_audio is a
# later slice.

import glob
import os
import shutil
from typing import Dict

import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemWriter

from touchnet_tpu_torch.bin import CkptConverterConfig
from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses
from touchnet_tpu_torch.utils.logging import init_logger, logger
from touchnet_tpu_torch.utils.safetensors_io import read_safetensors

LATER_MODEL_TYPES = ("kimi_audio",)
MODEL_TYPES = ("causal_lm", "touch_audio", "qwen2_audio")


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF checkpoint directory, in its stored dtype, on
    the CPU: the *.safetensors files, else the pytorch_model*.bin files."""
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
        return sd
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if bin_files:
        for f in bin_files:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
        return sd
    raise FileNotFoundError(f"no safetensors/bin weights under {path}")


def check_model_type(model_type: str) -> None:
    if model_type in LATER_MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r}: a later audio slice of "
                         f"touchnet_tpu_torch; the port converts {', '.join(MODEL_TYPES)}")
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {model_type!r}")


def refuse_unread(config: CkptConverterConfig, names, tool: str) -> None:
    """The two converters share CkptConverterConfig; a field that ``tool``
    does not read is an error when set, never a value silently dropped."""
    for name in names:
        if getattr(config, name) is not None:
            raise ValueError(f"--{name} is not a flag of {tool}")


def convert(config: CkptConverterConfig) -> str:
    """Write the seed; returns the step directory."""
    check_model_type(config.model_type)
    refuse_unread(config, ("config", "step", "tokenizer_model"), "convert_hf_to_ckpt")
    if config.model_type == "touch_audio":
        from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
            TouchAudioConfig,
        )
        from touchnet_tpu_torch.models.touch_audio.convert import (
            params_from_hf_backbone_state_dict,
        )

        if config.training_model_config_path is None:
            raise ValueError("--training_model_config_path is required for touch_audio "
                             "(the HF directory holds the text backbone's config)")
        mcfg = TouchAudioConfig.from_json_file(config.training_model_config_path)
        sd = load_hf_state_dict(config.huggingface_model)
        params = params_from_hf_backbone_state_dict(
            mcfg, sd, torch.Generator().manual_seed(0), dtype=torch.float32)
    elif config.model_type == "qwen2_audio":
        from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import (
            Qwen2AudioConfig,
        )
        from touchnet_tpu_torch.models.qwen2_audio.convert import params_from_hf_state_dict

        mcfg = Qwen2AudioConfig.from_json_file(
            config.training_model_config_path
            or os.path.join(config.huggingface_model, "config.json"))
        sd = load_hf_state_dict(config.huggingface_model)
        params = params_from_hf_state_dict(mcfg, sd, dtype=torch.float32)
    else:
        from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
        from touchnet_tpu_torch.models.llama.convert import params_from_hf_state_dict

        mcfg = LlamaConfig.from_json_file(
            config.training_model_config_path
            or os.path.join(config.huggingface_model, "config.json"))
        sd = load_hf_state_dict(config.huggingface_model)
        params = params_from_hf_state_dict(mcfg, sd, dtype=torch.float32)
    final = os.path.abspath(os.path.join(config.ckpt_dir, "checkpoint", "step_0"))
    tmp = final + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    dcp.save(params, storage_writer=FileSystemWriter(os.path.join(tmp, "model"),
                                                     thread_count=4), no_dist=True)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    logger.info(f"seed checkpoint written to {final} ({len(params)} tensors, f32)")
    return final


def main(argv=None):
    (config,) = parse_args_into_dataclasses([CkptConverterConfig], argv)
    init_logger()
    assert config.huggingface_model and config.ckpt_dir, \
        "--huggingface_model and --ckpt_dir are required"
    return convert(config)


if __name__ == "__main__":
    main()
