# Copyright (c) 2026 touchnet_tpu authors.
# One pipeline stage of TouchAudioForCausalLM: the pipelining_fn of the
# touch_audio TrainSpec.
#
# Port of touchnet_tpu/models/touch_audio/pipeline_touch_audio.py: the
# fusion projector(input_features) + embed_tokens(input_ids) is the first
# semantic stage's input (JAX computes it before its tick loop), then the
# language model's stage runs as pipeline_llama's. The projector is held on
# every pp rank with the embedding, the final norm and the head, and its
# gradient is summed over pp with theirs.

from typing import Dict, List, Optional

import torch

from touchnet_tpu_torch.models.llama import pipeline_llama
from touchnet_tpu_torch.models.touch_audio import modeling_touch_audio
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import TouchAudioConfig


def stage_forward(model: modeling_touch_audio.TouchAudioForCausalLM, layer_ids: List[int],
                  x: Optional[torch.Tensor], batch: Dict[str, torch.Tensor], *,
                  config: TouchAudioConfig, compute_dtype, remat_mode: str,
                  selective_ac_option: str, first: bool, last: bool) -> torch.Tensor:
    """As pipeline_llama.stage_forward; the first semantic stage's input is
    the fused embedding of modeling_touch_audio.embed_inputs."""
    if first and batch.get("inputs_embeds") is None:
        batch = dict(batch, inputs_embeds=modeling_touch_audio.embed_inputs(
            model, batch.get("input_ids"), batch.get("input_features"), compute_dtype))
    return pipeline_llama.stage_forward(
        model.language_model, layer_ids, x, batch, config=config.text_config,
        compute_dtype=compute_dtype, remat_mode=remat_mode,
        selective_ac_option=selective_ac_option, first=first, last=last)
