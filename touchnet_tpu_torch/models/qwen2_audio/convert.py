# Copyright (c) 2026 touchnet_tpu authors.
# Weight layouts of the port's Qwen2AudioForConditionalGeneration: the JAX
# package's param tree -> the port's state_dict (params_from_jax_numpy), and
# HF <-> the port.
#
# Port of touchnet_tpu/models/qwen2_audio/convert.py: tower_from_hf (:44),
# tower_to_hf (:63), params_from_hf_state_dict (:77) and
# params_to_hf_state_dict (:92). The JAX package stacks the tower's layers
# on [L, ...] and converts each leaf; the port's state_dict keys are the HF
# ones (audio_tower.*, multi_modal_projector.linear.*, language_model.*),
# so HF <-> port checks the key set against the config and moves the
# prefix, with no remap. The language model goes through
# models/llama/convert.py (its q/k/v biases, the lm_head when untied).

from typing import Dict, Optional

import numpy as np
import torch

from touchnet_tpu_torch.models.llama import convert as llama_convert
from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig

TOWER = "audio_tower."
PROJECTOR = "multi_modal_projector.linear."
LM = "language_model."


def tower_keys(config) -> list:
    """The WhisperEncoder state_dict keys of ``config`` (a
    WhisperEncoderConfig), in module order."""
    from touchnet_tpu_torch.models.whisper_encoder import WhisperEncoder

    with torch.device("meta"):
        return list(WhisperEncoder(config).state_dict())


def tower_from_jax_numpy(tree: dict, config) -> dict:
    """The WhisperEncoder state_dict from the JAX tower tree (numpy arrays;
    ``config`` a WhisperEncoderConfig): each [L, ...] leaf becomes
    layers.{i}.*. Dtypes are kept."""
    L = config.encoder_layers
    state = {}
    for name, arr in llama_convert._flatten(tree).items():
        arr = np.asarray(arr)
        if not name.startswith("layers."):
            state[name] = llama_convert._tensor(arr)
            continue
        if arr.shape[0] != L:
            raise ValueError(f"{name}: leading dim {arr.shape[0]}, expected {L} layers")
        for i in range(L):
            state[f"layers.{i}.{name[len('layers.'):]}"] = llama_convert._tensor(arr[i])
    return state


def params_from_jax_numpy(tree: dict, config: Qwen2AudioConfig) -> dict:
    """state_dict for Qwen2AudioForConditionalGeneration from the JAX param
    tree given as numpy arrays. Dtypes are kept."""
    state = {TOWER + k: v for k, v in
             tower_from_jax_numpy(tree["audio_tower"], config.audio_config).items()}
    proj = tree["multi_modal_projector"]["linear"]
    for leaf in ("weight", "bias"):
        state[PROJECTOR + leaf] = llama_convert._tensor(np.asarray(proj[leaf]))
    lm = llama_convert.params_from_jax_numpy(tree["language_model"], config.text_config)
    state.update({LM + k: v for k, v in lm.items()})
    return state


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t.to(dtype) if dtype is not None else t


def tower_from_hf(sd: Dict[str, torch.Tensor], config, prefix: str = TOWER,
                  dtype: Optional[torch.dtype] = None) -> dict:
    """The WhisperEncoder state_dict (keys without ``prefix``) of an HF state
    dict whose tower keys carry ``prefix``; raises naming the first key
    ``config`` needs and ``sd`` lacks."""
    out = {}
    for key in tower_keys(config):
        if prefix + key not in sd:
            raise KeyError(f"HF state dict has no {prefix + key!r}")
        out[key] = _cast(sd[prefix + key], dtype)
    return out


def tower_to_hf(tower: Dict[str, torch.Tensor], config,
                prefix: str = TOWER) -> Dict[str, torch.Tensor]:
    """The HF keys (``prefix`` + the WhisperEncoder key) of a tower
    state_dict; raises on a key ``config`` defines and ``tower`` lacks."""
    out = {}
    for key in tower_keys(config):
        if key not in tower:
            raise KeyError(f"tower state dict has no {key!r}")
        out[prefix + key] = tower[key]
    return out


def params_from_hf_state_dict(config: Qwen2AudioConfig, sd: Dict[str, torch.Tensor],
                              dtype: Optional[torch.dtype] = None) -> dict:
    """The port's state_dict from an HF Qwen2AudioForConditionalGeneration
    state dict, cast to ``dtype`` when given."""
    state = {TOWER + k: v for k, v in tower_from_hf(sd, config.audio_config, TOWER,
                                                    dtype).items()}
    for leaf in ("weight", "bias"):
        if PROJECTOR + leaf not in sd:
            raise KeyError(f"HF state dict has no {PROJECTOR + leaf!r}")
        state[PROJECTOR + leaf] = _cast(sd[PROJECTOR + leaf], dtype)
    want = (config.text_config.hidden_size, config.audio_config.d_model)
    if tuple(state[PROJECTOR + "weight"].shape) != want:
        raise ValueError(f"{PROJECTOR}weight: shape {tuple(state[PROJECTOR + 'weight'].shape)}, "
                         f"the config wants {want}")
    sub = {k[len(LM):]: v for k, v in sd.items() if k.startswith(LM)}
    lm = llama_convert.params_from_hf_state_dict(config.text_config, sub, dtype=dtype)
    state.update({LM + k: v for k, v in lm.items()})
    return state


def params_to_hf_state_dict(config: Qwen2AudioConfig,
                            state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The HF state dict of the port's state_dict: the tower's, the
    projector's and the language model's keys the config defines."""
    tower = {k[len(TOWER):]: v for k, v in state.items() if k.startswith(TOWER)}
    out = tower_to_hf(tower, config.audio_config, TOWER)
    for leaf in ("weight", "bias"):
        if PROJECTOR + leaf not in state:
            raise KeyError(f"state dict has no {PROJECTOR + leaf!r}")
        out[PROJECTOR + leaf] = state[PROJECTOR + leaf]
    lm = llama_convert.params_to_hf_state_dict(
        config.text_config, {k[len(LM):]: v for k, v in state.items() if k.startswith(LM)})
    out.update({LM + k: v for k, v in lm.items()})
    return out


def hf_config_dict(config: Qwen2AudioConfig, torch_dtype: Optional[str] = None) -> dict:
    """The config.json of an export: every field of the audio config and of
    the text config (llama_convert.hf_config_dict: rope_scaling, head_dim,
    the biases) and the audio token index, so the export loads in both
    packages."""
    out = {"architectures": ["Qwen2AudioForConditionalGeneration"], **config.to_dict()}
    out["text_config"] = llama_convert.hf_config_dict(config.text_config)
    if torch_dtype is not None:
        out["torch_dtype"] = torch_dtype
    return out
