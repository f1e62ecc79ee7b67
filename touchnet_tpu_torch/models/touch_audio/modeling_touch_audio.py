# Copyright (c) 2026 touchnet_tpu authors.
# TouchAudioForCausalLM: a bias-free audio projector and the port's Llama,
# with padding+addition fusion.
#
# Port of touchnet_tpu/models/touch_audio/modeling_touch_audio.py:
# init_params (:29-42), forward (:45-95), get_num_params and
# get_num_flop_per_token (:98-110). The only difference from the text model:
#   inputs_embeds = projector(input_features) + embed_tokens(input_ids)
# Text positions carry pad tokens where audio lives and the features are
# zero where text lives, so the addition interleaves the two streams. Both
# terms are computed in the compute dtype (the f32 master weights and the
# host's f32 features are cast first), then the backbone runs as the text
# model does: K1 and K2 on the card, K3 when the trainer fuses the lm-head.
# The state_dict keys are the HF TouchAudioForCausalLM ones:
#   projector.weight            [E, input_size]
#   language_model.<the Llama keys of models/llama/modeling_llama.py>

from typing import Optional

import torch
from torch import nn

from touchnet_tpu_torch.models.llama import head_weight as llama_head_weight
from touchnet_tpu_torch.models.llama import modeling_llama
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
    TouchAudioConfig,
)
from touchnet_tpu_torch.parallel.sharding import embed, rowwise_linear


class TouchAudioForCausalLM(nn.Module):
    """Weight holder: forward below runs it for training; serving projects
    the features itself and generates with the language model."""

    def __init__(self, config: TouchAudioConfig):
        super().__init__()
        self.config = config
        self.projector = nn.Linear(config.audio_config.input_size,
                                   config.text_config.hidden_size, bias=False)
        self.language_model = modeling_llama.LlamaForCausalLM(config.text_config)


def empty_model(config: TouchAudioConfig, dtype=torch.float32, device="cuda", *,
                requires_grad: bool = False,
                train: bool = False) -> TouchAudioForCausalLM:
    """Model with uninitialised storage on ``device`` (built on the meta
    device); serving's defaults, as modeling_llama.empty_model."""
    with torch.device("meta"):
        model = TouchAudioForCausalLM(config)
    model = model.to(dtype).to_empty(device=device)
    return model.train(train).requires_grad_(requires_grad)


def kaiming_uniform_init(generator: torch.Generator, shape, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """The JAX package's projector init (models/common.py:150):
    uniform(-sqrt(3 / fan_in), sqrt(3 / fan_in)), drawn in f32 from an
    explicit generator, then cast."""
    bound = (3.0 / shape[-1]) ** 0.5
    x = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(2 * bound).sub_(bound).to(dtype)


@torch.no_grad()
def init_params(config: TouchAudioConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, *, requires_grad: bool = False,
                train: bool = False, layers=None) -> TouchAudioForCausalLM:
    """The projector from kaiming_uniform_init, then the Llama's weights as
    modeling_llama.init_params draws them (``layers``: a pipeline stage's,
    as there), both from ``generator`` (which lives on ``device``; default:
    its device). The numbers differ from jax.random's for the same seed."""
    if device is None:
        device = generator.device
    with torch.device("meta"):
        model = TouchAudioForCausalLM(config)
    shape = (config.text_config.hidden_size, config.audio_config.input_size)
    model.projector.weight = nn.Parameter(kaiming_uniform_init(generator, shape, dtype, device))
    model.language_model = modeling_llama.init_params(config.text_config, generator, dtype,
                                                      device, layers=layers)
    return model.train(train).requires_grad_(requires_grad)


def forward(
    model: TouchAudioForCausalLM,
    *,
    input_ids: Optional[torch.Tensor] = None,
    input_features: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    config: TouchAudioConfig,
    compute_dtype=torch.bfloat16,
    remat_mode: str = "none",
    selective_ac_option: str = "op",
    return_hidden: bool = False,
) -> torch.Tensor:
    """Logits [B, T, V] in compute_dtype (or the final-norm hidden state when
    return_hidden, for K3), as modeling_llama.forward, from
    embed_tokens(input_ids) + projector(input_features) in compute_dtype
    (either term alone when the other is None) unless inputs_embeds is
    given."""
    if inputs_embeds is None:
        inputs_embeds = embed_inputs(model, input_ids, input_features, compute_dtype)
    return modeling_llama.forward(
        model.language_model,
        inputs_embeds=inputs_embeds,
        segment_ids=segment_ids,
        position_ids=position_ids,
        config=config.text_config,
        compute_dtype=compute_dtype,
        remat_mode=remat_mode,
        selective_ac_option=selective_ac_option,
        return_hidden=return_hidden,
    )


def embed_inputs(model: TouchAudioForCausalLM, input_ids: Optional[torch.Tensor],
                 input_features: Optional[torch.Tensor], compute_dtype) -> torch.Tensor:
    """embed_tokens(input_ids) + projector(input_features) in compute_dtype
    (either term alone when the other is None)."""
    parts = []
    if input_ids is not None:
        parts.append(embed(input_ids, model.language_model.model.embed_tokens)
                     .to(compute_dtype))
    if input_features is not None:
        parts.append(rowwise_linear(input_features.to(compute_dtype), model.projector))
    if not parts:
        raise ValueError("touch_audio forward: needs input_ids and/or input_features")
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def head_weight(model: TouchAudioForCausalLM, config: TouchAudioConfig) -> torch.Tensor:
    """The language model's lm_head weight [V, E] (its embedding when tied)."""
    return llama_head_weight(model.language_model, config.text_config)


def get_num_params(config: TouchAudioConfig, exclude_embedding: bool = False) -> int:
    return (
        modeling_llama.get_num_params(config.text_config, exclude_embedding)
        + config.text_config.hidden_size * config.audio_config.input_size
    )


def get_num_flop_per_token(num_params: int, config: TouchAudioConfig, seq_len: int) -> float:
    return modeling_llama.get_num_flop_per_token(num_params, config.text_config, seq_len)
