# Copyright (c) 2026 touchnet_tpu authors.
# Weight layouts of the port's TouchAudioForCausalLM: the JAX package's
# param tree -> the port's state_dict (params_from_jax_numpy), and HF <->
# the port.
#
# Port of touchnet_tpu/models/touch_audio/convert.py (:18-55). A text
# backbone's HF checkpoint becomes a touch_audio seed by prefixing its keys
# with "language_model." and adding a fresh projector
# (params_from_hf_backbone_state_dict; the projector's draws come from a
# torch.Generator, so they differ from JAX's for the same seed). A full
# TouchAudioForCausalLM checkpoint holds projector.weight and the
# language_model.* keys, which are the port's state_dict keys as they are.

from typing import Dict, Optional

import numpy as np
import torch

from touchnet_tpu_torch.models.llama import convert as llama_convert
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
    TouchAudioConfig,
)

PREFIX = "language_model."
PROJECTOR = "projector.weight"


def params_from_jax_numpy(tree: dict, config: TouchAudioConfig) -> dict:
    """state_dict for TouchAudioForCausalLM from the JAX param tree
    ({"projector": {"weight"}, "language_model": <Llama tree>}) given as
    numpy arrays. Dtypes are kept."""
    lm = llama_convert.params_from_jax_numpy(tree["language_model"], config.text_config)
    state = {PROJECTOR: llama_convert._tensor(np.asarray(tree["projector"]["weight"]))}
    state.update({PREFIX + k: v for k, v in lm.items()})
    return state


def _language_model(config: TouchAudioConfig, sd: Dict[str, torch.Tensor], prefix: str,
                    dtype: Optional[torch.dtype]) -> dict:
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    lm = llama_convert.params_from_hf_state_dict(config.text_config, sub, dtype=dtype)
    return {PREFIX + k: v for k, v in lm.items()}


def params_from_hf_backbone_state_dict(config: TouchAudioConfig, sd: Dict[str, torch.Tensor],
                                       generator: torch.Generator,
                                       dtype: Optional[torch.dtype] = None) -> dict:
    """A text backbone's HF state dict (model.*, lm_head.weight) -> the
    port's state_dict with a fresh projector drawn from ``generator``
    (modeling_touch_audio.kaiming_uniform_init), in ``dtype`` when given."""
    from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import kaiming_uniform_init

    state = _language_model(config, sd, "", dtype)
    shape = (config.text_config.hidden_size, config.audio_config.input_size)
    proj = kaiming_uniform_init(generator, shape, device=generator.device)
    state[PROJECTOR] = proj.to("cpu", dtype or torch.float32)
    return state


def params_from_hf_state_dict(config: TouchAudioConfig, sd: Dict[str, torch.Tensor],
                              dtype: Optional[torch.dtype] = None) -> dict:
    """A full TouchAudioForCausalLM HF state dict (projector.weight +
    language_model.*) -> the port's state_dict, cast to ``dtype`` when given."""
    if PROJECTOR not in sd:
        raise KeyError(f"HF state dict has no {PROJECTOR!r}")
    want = (config.text_config.hidden_size, config.audio_config.input_size)
    if tuple(sd[PROJECTOR].shape) != want:
        raise ValueError(f"{PROJECTOR}: shape {tuple(sd[PROJECTOR].shape)}, the config wants "
                         f"{want}")
    state = _language_model(config, sd, PREFIX, dtype)
    proj = sd[PROJECTOR]
    state[PROJECTOR] = proj.to(dtype) if dtype is not None else proj
    return state


def params_to_hf_state_dict(config: TouchAudioConfig,
                            state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The HF state dict of the port's state_dict: projector.weight and the
    language_model.* keys the config defines (no lm_head when tied)."""
    lm = llama_convert.params_to_hf_state_dict(
        config.text_config, {k[len(PREFIX):]: v for k, v in state.items()
                             if k.startswith(PREFIX)})
    if PROJECTOR not in state:
        raise KeyError(f"state dict has no {PROJECTOR!r}")
    out = {PROJECTOR: state[PROJECTOR]}
    out.update({PREFIX + k: v for k, v in lm.items()})
    return out


def hf_config_dict(config: TouchAudioConfig, torch_dtype: Optional[str] = None) -> dict:
    """The config.json of an export: the config's own dict (every text_config
    field, rope_scaling and head_dim included), as the JAX exporter writes
    it, so the export loads in both packages."""
    out = config.to_dict()
    if torch_dtype is not None:
        out["torch_dtype"] = torch_dtype
    return out
