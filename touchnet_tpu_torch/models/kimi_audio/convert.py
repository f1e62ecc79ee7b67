# Copyright (c) 2026 touchnet_tpu authors.
# Weight layouts of the port's KimiAudioForCausalLM: the JAX package's param
# tree -> the port's state_dict (params_from_jax_numpy), and HF <-> the port.
#
# Port of touchnet_tpu/models/kimi_audio/convert.py: params_from_hf_state_dict
# (:34) with _vq_from_hf (:69), and params_to_hf_state_dict (:92). The JAX
# package stacks every per-layer leaf on a leading [L, ...] axis (the main
# and mimo Qwen2 layers, the tower's and the tokenizer's whisper layers) and
# remaps HF names into that tree; the port's state_dict keys are the HF ones
# (modeling_kimi_audio's header lists them), so HF <-> port checks the key
# set against the config and takes the tensors as they are: the HF
# checkpoint's speech_tokenizer EMA buffers (keys holding "ema_") are
# dropped, embed_positions2 is kept though the forward never reads it, and
# a key the config needs and the checkpoint lacks raises, naming it.

from typing import Dict, Optional

import numpy as np
import torch

from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
from touchnet_tpu_torch.models.llama import convert as llama_convert

# the JAX tree's stacked leaves: prefix -> the config's layer count
_STACKS = {
    "model.layers.": lambda c: c.text_config.num_hidden_layers,
    "model.mimo_layers.": lambda c: c.kimia_mimo_layers,
    "speech_encoder.layers.": lambda c: c.speech_encoder_config.encoder_layers,
    "speech_tokenizer.layers.": lambda c: c.speech_tokenizer_config.quantize_position,
}


def state_dict_keys(config: KimiAudioConfig) -> list:
    """The port's state_dict keys for ``config``, in module order."""
    from touchnet_tpu_torch.models.kimi_audio.modeling_kimi_audio import KimiAudioForCausalLM

    with torch.device("meta"):
        return list(KimiAudioForCausalLM(config).state_dict())


def params_from_jax_numpy(tree: dict, config: KimiAudioConfig) -> dict:
    """state_dict for KimiAudioForCausalLM from the JAX param tree given as
    numpy arrays: each stacked [L, ...] leaf becomes <stack>.{i}.*. Dtypes
    are kept."""
    state = {}
    for name, arr in llama_convert._flatten(tree).items():
        arr = np.asarray(arr)
        stack = next((p for p in _STACKS if name.startswith(p)), None)
        if stack is None:
            state[name] = llama_convert._tensor(arr)
            continue
        L = _STACKS[stack](config)
        if arr.shape[0] != L:
            raise ValueError(f"{name}: leading dim {arr.shape[0]}, expected {L} layers")
        for i in range(L):
            state[f"{stack}{i}.{name[len(stack):]}"] = llama_convert._tensor(arr[i])
    return state


def params_from_hf_state_dict(config: KimiAudioConfig, sd: Dict[str, torch.Tensor],
                              dtype: Optional[torch.dtype] = None) -> dict:
    """The port's state_dict from an HF MoonshotKimiaForCausalLM state dict,
    cast to ``dtype`` when given (None keeps the stored dtype, for a loader
    that casts on the card). Keys the model does not hold (the tokenizer's
    EMA buffers, rotary buffers) are left out; a missing one raises."""
    out = {}
    for key in state_dict_keys(config):
        if key not in sd:
            raise KeyError(f"HF state dict has no {key!r}")
        t = sd[key]
        out[key] = t.to(dtype) if dtype is not None else t
    return out


def params_to_hf_state_dict(config: KimiAudioConfig,
                            state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The HF state dict of the port's state_dict: exactly the keys the
    config defines (embed_positions2 and the codebook included; no EMA
    buffers, which only training writes)."""
    keys = state_dict_keys(config)
    missing = [k for k in keys if k not in state]
    if missing:
        raise KeyError(f"state dict has no {missing[0]!r}")
    return {k: state[k] for k in keys}


def hf_config_dict(config: KimiAudioConfig, torch_dtype: Optional[str] = None) -> dict:
    """The config.json of an export: the config's own flat dict (the Qwen2
    fields at the top level, the two whisper sub-configs, model_type
    kimi_audio), so the export loads in both packages."""
    out = {"architectures": ["MoonshotKimiaForCausalLM"], **config.to_dict()}
    out["speech_encoder_config"] = dict(out["speech_encoder_config"])
    out["speech_tokenizer_config"] = dict(out["speech_tokenizer_config"])
    if torch_dtype is not None:
        out["torch_dtype"] = torch_dtype
    return out
