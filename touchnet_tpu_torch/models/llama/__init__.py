# Llama family of the port (serving slice): configuration, the weight
# module, the JAX-tree converter and KV-cache generation.
#
# check_finite_params and head_weight port touchnet_tpu/models/llama/
# __init__.py:25-40; the JAX module's TrainSpec registration belongs to the
# training slice.

import torch
from torch import nn

from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig


def check_finite_params(model: nn.Module) -> None:
    """NaN/inf guard after init or load."""
    for name, p in model.named_parameters():
        if not bool(torch.isfinite(p).all()):
            raise ValueError(f"non-finite values in param {name}")


def head_weight(model: nn.Module, config: LlamaConfig) -> torch.Tensor:
    """lm_head weight [V, E] (the embedding when tied)."""
    if config.tie_word_embeddings:
        return model.model.embed_tokens.weight
    return model.lm_head.weight
