# Llama family of the port: configuration, the weight module and training
# forward, the JAX-tree converter, KV-cache generation, and the llama
# TrainSpec the trainer looks up by name.
#
# check_finite_params, head_weight and the TrainSpec registration port
# touchnet_tpu/models/llama/__init__.py:25-67. The TrainSpec's param_rules
# is the tensor-parallel plan (parallel/sharding.apply_tp); its
# pipelining_fn is one pipeline stage (pipeline_llama.stage_forward).

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


def _register() -> None:
    from touchnet_tpu_torch.data.dataloader import build_dataloader
    from touchnet_tpu_torch.loss import accuracy, cross_entropy_loss
    from touchnet_tpu_torch.models.llama.modeling_llama import (
        forward,
        get_num_flop_per_token,
        get_num_params,
        init_params,
    )
    from touchnet_tpu_torch.models.llama.pipeline_llama import stage_forward
    from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
    from touchnet_tpu_torch.parallel.sharding import apply_tp
    from touchnet_tpu_torch.utils.train_spec import TrainSpec, register_train_spec

    register_train_spec(
        TrainSpec(
            name="llama",
            config_cls=LlamaConfig,
            init_params_fn=init_params,
            forward_fn=forward,
            loss_fn=cross_entropy_loss,
            acc_fn=accuracy,
            build_dataloader_fn=build_dataloader,
            build_tokenizer_fn=build_tokenizer,
            get_num_flop_per_token_fn=get_num_flop_per_token,
            get_num_params_fn=get_num_params,
            head_weight_fn=head_weight,
            param_rules=apply_tp,
            pipelining_fn=stage_forward,
        )
    )


_register()
