# Copyright (c) 2026 touchnet_tpu authors.
# One pipeline stage of the Llama: the pipelining_fn of the llama TrainSpec.
#
# Port of touchnet_tpu/models/llama/pipeline_llama.py. JAX runs the
# embedding, the final norm and the head outside its tick loop, replicated
# over pp (pp_param_rules :222-252), and the layers inside it; here each pp
# rank holds the embedding, the final norm and the head too (the trainer
# sums their gradients over pp), and semantic stage 0 embeds its
# microbatch, the last one applies the norm and the head. Under tensor
# parallelism a stage's layers carry the trainer's plan (each rank its own
# heads, the sums after o_proj and down_proj, parallel/sharding.py: the
# JAX stage body's psum over "tp", :144-164); under context parallelism
# they attend over the stage's cp group (modeling_llama.run_layers reads
# the stack's ContextParallel, JAX's cp_local_attn in the stage body,
# :93-109).

from typing import Dict, List, Optional

import torch

from touchnet_tpu_torch.models.llama import modeling_llama
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.parallel.sharding import embed


def stage_forward(model: modeling_llama.LlamaForCausalLM, layer_ids: List[int],
                  x: Optional[torch.Tensor], batch: Dict[str, torch.Tensor], *,
                  config: LlamaConfig, compute_dtype, remat_mode: str,
                  selective_ac_option: str, first: bool, last: bool) -> torch.Tensor:
    """One chunk of a pipeline stage on one microbatch: the input ``x``
    [b, T, E] (on the first semantic stage the microbatch's embedded
    input_ids, or its inputs_embeds) through the layers ``layer_ids``;
    returns the chunk's output, or on the last stage the logits [b, T, V]
    in compute_dtype. A chunk without layers passes its input on."""
    if first:
        x = batch.get("inputs_embeds")
        if x is None:
            x = embed(batch["input_ids"], model.model.embed_tokens)
        x = x.to(compute_dtype)
    h = modeling_llama.run_layers(
        model, x, layer_ids, segment_ids=batch.get("attention_mask"),
        position_ids=batch.get("position_ids"), config=config, remat_mode=remat_mode,
        selective_ac_option=selective_ac_option)
    if not last:
        return h
    return modeling_llama.final_logits(model, h, config, compute_dtype)
