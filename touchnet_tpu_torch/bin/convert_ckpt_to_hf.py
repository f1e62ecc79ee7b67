# Copyright (c) 2026 touchnet_tpu authors.
# Stage 3 of the recipes: a trained checkpoint's model -> an HF directory
# <ckpt_dir>/checkpoint_hf/step-<N>/{model.safetensors,config.json}.
#
#     python -m touchnet_tpu_torch.bin.convert_ckpt_to_hf --ckpt_dir <exp> \
#         --step -1 --config <cfg> --model_type causal_lm | touch_audio | qwen2_audio \
#         [--tokenizer_model <dir>]
#
# Port of touchnet_tpu/bin/convert_ckpt_to_hf.py (:16-139) for causal_lm,
# touch_audio (whose config.json is the TouchAudioConfig's own dict, as the
# JAX exporter writes it) and qwen2_audio (:84-121: the HF state dict of
# models/qwen2_audio/convert.py and its hf_config_dict, which holds every
# field of the audio and text configs), with two faults of that file left
# behind: its HF config has ten fields
# and drops rope_scaling and head_dim (here models/llama/convert.py's
# hf_config_dict writes them all), and it reads the model config only from
# --training_model_config_path and hands --step -1 to the restore unresolved
# (here --config is taken when that flag is unset, the recipe's spelling,
# and -1 means the latest step, as the trainer's load step). step_<N>/model
# is read with torch.distributed.checkpoint in one process, into tensors of
# the stored shapes and dtypes, and written with the port's safetensors
# writer, so the tensors keep their bits. transformers is imported only for
# --tokenizer_model (save_pretrained of the tokenizer). Host-only.

import json
import os
import re

import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader

from touchnet_tpu_torch.bin import CkptConverterConfig
from touchnet_tpu_torch.bin.convert_hf_to_ckpt import check_model_type, refuse_unread
from touchnet_tpu_torch.utils.cli import parse_args_into_dataclasses
from touchnet_tpu_torch.utils.logging import init_logger, logger
from touchnet_tpu_torch.utils.safetensors_io import write_safetensors

_STEP_DIR = re.compile(r"step_(\d+)$")


def resolve_step(ckpt_dir: str, step: int) -> int:
    """``step``, or the latest step_<N> under <ckpt_dir>/checkpoint for -1."""
    folder = os.path.join(ckpt_dir, "checkpoint")
    steps = sorted(int(m.group(1)) for m in
                   map(_STEP_DIR.match, os.listdir(folder) if os.path.isdir(folder) else [])
                   if m)
    if step == -1:
        if not steps:
            raise FileNotFoundError(f"no step_<N> under {folder}")
        return steps[-1]
    if step not in steps:
        raise FileNotFoundError(f"no step_{step} under {folder} (steps: {steps})")
    return step


def read_model(path: str) -> dict:
    """The tensors of a DCP model directory, on the CPU, in the stored
    shapes and dtypes."""
    meta = FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(state, storage_reader=FileSystemReader(path), no_dist=True)
    return state


def convert(config: CkptConverterConfig) -> str:
    """Write the HF directory; returns its path."""
    check_model_type(config.model_type)
    refuse_unread(config, ("huggingface_model",), "convert_ckpt_to_hf")
    cfg_path = config.training_model_config_path or config.config
    if cfg_path is None:
        raise ValueError("--training_model_config_path or --config is required")
    if config.model_type == "touch_audio":
        from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
            TouchAudioConfig as Config,
        )
        from touchnet_tpu_torch.models.touch_audio.convert import (
            hf_config_dict,
            params_to_hf_state_dict,
        )
    elif config.model_type == "qwen2_audio":
        from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import (
            Qwen2AudioConfig as Config,
        )
        from touchnet_tpu_torch.models.qwen2_audio.convert import (
            hf_config_dict,
            params_to_hf_state_dict,
        )
    else:
        from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig as Config
        from touchnet_tpu_torch.models.llama.convert import (
            hf_config_dict,
            params_to_hf_state_dict,
        )
    mcfg = Config.from_json_file(cfg_path)
    step = resolve_step(config.ckpt_dir, -1 if config.step is None else config.step)
    state = read_model(os.path.join(config.ckpt_dir, "checkpoint", f"step_{step}", "model"))
    sd = params_to_hf_state_dict(mcfg, state)
    dtypes = {str(t.dtype).replace("torch.", "") for t in sd.values()}
    out = os.path.join(config.ckpt_dir, "checkpoint_hf", f"step-{step}")
    os.makedirs(out, exist_ok=True)
    nbytes = write_safetensors(sd, os.path.join(out, "model.safetensors"))
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(hf_config_dict(mcfg, dtypes.pop() if len(dtypes) == 1 else None), f,
                  indent=2)
    if config.tokenizer_model:
        import transformers

        tok = transformers.AutoTokenizer.from_pretrained(config.tokenizer_model,
                                                         trust_remote_code=True)
        tok.save_pretrained(out)
    logger.info(f"HF checkpoint of step {step} written to {out} ({nbytes} bytes of weights)")
    return out


def main(argv=None):
    (config,) = parse_args_into_dataclasses([CkptConverterConfig], argv)
    init_logger()
    assert config.ckpt_dir, "--ckpt_dir is required"
    return convert(config)


if __name__ == "__main__":
    main()
