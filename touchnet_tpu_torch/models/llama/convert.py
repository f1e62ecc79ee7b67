# Copyright (c) 2026 touchnet_tpu authors.
# Weight layouts of the port's Llama: the JAX package's param tree -> the
# port's state_dict (params_from_jax_numpy), and HF <-> the port
# (params_from_hf_state_dict, params_to_hf_state_dict, hf_config_dict; port
# of touchnet_tpu/models/llama/convert.py:43-102 and the config of
# touchnet_tpu/bin/convert_ckpt_to_hf.py:57-68).
#
# touchnet_tpu keeps params as a nested dict with HF key names and every
# per-layer leaf stacked on a leading [L, ...] axis
# (touchnet_tpu/models/llama/modeling_llama.py:17-23). The port has one
# module per layer, so each stacked leaf is split into
# model.layers.{i}.<name>. The tree arrives as numpy arrays, so this module
# needs no jax: the tests convert with jax.tree.map(np.asarray, params).
#
# The port's state_dict keys are the HF ones, so HF <-> port is a check of
# the key set against the config, not a remap: the lm_head is absent when
# tied (and falls back to a copy of the embedding when an untied checkpoint
# lacks it, as in JAX), q/k/v biases are there exactly when
# config.attention_bias. hf_config_dict writes every field of the config,
# rope_scaling and head_dim included: the JAX exporter's ten-field
# LlamaConfig drops them, so an HF model loaded from its llama3-scaled
# export runs plain RoPE.

from typing import Dict, Optional

import numpy as np
import torch

from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig

_LAYERS = "model.layers."
_LM_HEAD = "lm_head.weight"
_EMBED = "model.embed_tokens.weight"


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = val
    return flat


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes, which torch cannot wrap
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def params_from_jax_numpy(tree: dict, config: LlamaConfig) -> dict:
    """state_dict for LlamaForCausalLM (load with load_state_dict) from the
    JAX param tree given as numpy arrays. Dtypes are kept."""
    L = config.num_hidden_layers
    state = {}
    for name, arr in _flatten(tree).items():
        arr = np.asarray(arr)
        if not name.startswith(_LAYERS):
            state[name] = _tensor(arr)
            continue
        if arr.shape[0] != L:
            raise ValueError(f"{name}: leading dim {arr.shape[0]}, expected {L} layers")
        rest = name[len(_LAYERS):]
        for i in range(L):
            state[f"{_LAYERS}{i}.{rest}"] = _tensor(arr[i])
    return state


def state_dict_keys(config: LlamaConfig) -> list:
    """The port's state_dict keys for ``config``, in module order."""
    from touchnet_tpu_torch.models.llama.modeling_llama import LlamaForCausalLM

    with torch.device("meta"):
        return list(LlamaForCausalLM(config).state_dict())


def params_from_hf_state_dict(config: LlamaConfig, sd: Dict[str, torch.Tensor],
                              dtype: Optional[torch.dtype] = None) -> dict:
    """The port's state_dict from an HF Llama state dict, cast to ``dtype``
    when given. Raises naming the first key the config needs and ``sd``
    lacks, or a bias the config has no room for; other HF-only keys
    (rotary buffers) are ignored."""
    keys = state_dict_keys(config)
    if not config.attention_bias:
        extra = sorted(k for k in sd if k.endswith("_proj.bias"))
        if extra:
            raise ValueError(f"{extra[0]}: the checkpoint has projection biases, the config "
                             "has attention_bias false")
    out = {}
    for key in keys:
        src = key
        if src not in sd and key == _LM_HEAD:
            src = _EMBED  # an untied config over a checkpoint tied implicitly
        if src not in sd:
            raise KeyError(f"HF state dict has no {src!r}")
        t = sd[src]
        t = t.to(dtype) if dtype is not None else t
        out[key] = t.clone() if src != key else t
    return out


def params_to_hf_state_dict(config: LlamaConfig,
                            state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The HF state dict of the port's state_dict: exactly the keys the
    config defines (no lm_head when tied)."""
    keys = state_dict_keys(config)
    missing = [k for k in keys if k not in state]
    if missing:
        raise KeyError(f"state dict has no {missing[0]!r}")
    return {k: state[k] for k in keys}


def hf_config_dict(config: LlamaConfig, torch_dtype: Optional[str] = None) -> dict:
    """The HF config.json of ``config``: every field of LlamaConfig
    (rope_scaling, head_dim, tie_word_embeddings, the biases included) plus
    what transformers reads to build the model. attn_implementation is a
    field of the port's config only (transformers takes no "flash"), so it
    is left out; the port reads a config without it as "flash"."""
    out = {"architectures": ["LlamaForCausalLM"], "hidden_act": "silu"}
    out.update({k: v for k, v in config.to_dict().items() if k != "attn_implementation"})
    if torch_dtype is not None:
        out["torch_dtype"] = torch_dtype
    return out
