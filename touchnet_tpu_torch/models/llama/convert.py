# Copyright (c) 2026 touchnet_tpu authors.
# The JAX package's Llama param tree -> the port's state_dict.
#
# touchnet_tpu keeps params as a nested dict with HF key names and every
# per-layer leaf stacked on a leading [L, ...] axis
# (touchnet_tpu/models/llama/modeling_llama.py:17-23). The port has one
# module per layer, so each stacked leaf is split into
# model.layers.{i}.<name>. The tree arrives as numpy arrays, so this module
# needs no jax: the tests convert with jax.tree.map(np.asarray, params).

import numpy as np
import torch

from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig

_LAYERS = "model.layers."


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
