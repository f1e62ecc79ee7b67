# Copyright (c) 2026 touchnet_tpu authors.
# Qwen2AudioForConditionalGeneration: the whisper audio tower, an avg-pool,
# the tower's final LayerNorm, a projector and the port's Llama (Qwen2: q/k/v
# biases), with the <|AUDIO|> tokens' embeddings replaced by the audio.
#
# Port of touchnet_tpu/models/qwen2_audio/modeling_qwen2_audio.py:
# init_params (:28), get_feat_extract_output_lengths (:46), encode_audio
# (:54), merge_audio_into_text (:82), forward (:96), get_num_params (:142)
# and get_num_flop_per_token (:152). The tower runs causally, also at
# inference (the reference's streamable patch, :63-66), through K1 on the
# card; the language model runs as the text model does (K1, and K4 when
# serving). The merge is the JAX package's cumsum gather: row b's j-th
# <|AUDIO|> token takes row b's j-th pooled audio frame (clipped to the last
# frame when a row has more audio tokens than frames). Training runs forward
# with the JAX forward's remat_mode over the tower's layers (selective option
# "op", as JAX passes none to the tower) and over the text layers (with the
# trainer's selective_ac_option), then the full logits: the qwen2_audio
# TrainSpec has no head weight, so the fused lm-head (K3) is off, as in JAX.
# The state_dict keys are the HF Qwen2AudioForConditionalGeneration ones:
#   audio_tower.<the WhisperEncoder keys of models/whisper_encoder.py>
#   multi_modal_projector.linear.{weight [E, d_model], bias [E]}
#   language_model.<the Llama keys of models/llama/modeling_llama.py>

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from touchnet_tpu_torch.models import whisper_encoder
from touchnet_tpu_torch.models.common import linear
from touchnet_tpu_torch.models.llama import modeling_llama
from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig
from touchnet_tpu_torch.models.touch_audio.modeling_touch_audio import kaiming_uniform_init


class Qwen2AudioMultiModalProjector(nn.Module):
    def __init__(self, config: Qwen2AudioConfig):
        super().__init__()
        self.linear = nn.Linear(config.audio_config.d_model, config.text_config.hidden_size,
                                bias=True)


class Qwen2AudioForConditionalGeneration(nn.Module):
    """Weight holder: encode_audio and forward below run it; serving encodes
    the audio, merges it into the prompt and generates with the language
    model."""

    def __init__(self, config: Qwen2AudioConfig):
        super().__init__()
        self.config = config
        self.audio_tower = whisper_encoder.WhisperEncoder(config.audio_config)
        self.multi_modal_projector = Qwen2AudioMultiModalProjector(config)
        self.language_model = modeling_llama.LlamaForCausalLM(config.text_config)


def empty_model(config: Qwen2AudioConfig, dtype=torch.float32, device="cuda", *,
                requires_grad: bool = False,
                train: bool = False) -> Qwen2AudioForConditionalGeneration:
    """Model with uninitialised storage on ``device``: built on the meta
    device and given its dtype there, so no copy in another dtype is ever
    allocated on ``device``. Serving's defaults, as modeling_llama.empty_model."""
    with torch.device("meta"):
        model = Qwen2AudioForConditionalGeneration(config)
    model = model.to(dtype).to_empty(device=device)
    return model.train(train).requires_grad_(requires_grad)


@torch.no_grad()
def init_params(config: Qwen2AudioConfig, generator: torch.Generator, dtype=torch.float32,
                device=None, *, requires_grad: bool = False,
                train: bool = False) -> Qwen2AudioForConditionalGeneration:
    """The tower as whisper_encoder.init_params draws it, the projector from
    kaiming_uniform_init with a zero bias (the JAX init_params), then the
    Llama's weights as modeling_llama.init_params draws them, all from
    ``generator`` on its device (or ``device``); the numbers differ from
    jax.random's. Serving's defaults (eval mode, no gradients); a trainer
    passes requires_grad=True, train=True: every tensor trains, the tower's
    position table too, as in the JAX trainer."""
    if device is None:
        device = generator.device
    with torch.device("meta"):  # each part is allocated once, by its own init
        model = Qwen2AudioForConditionalGeneration(config)
    model.audio_tower = whisper_encoder.init_params(config.audio_config, generator, dtype,
                                                    device)
    model.multi_modal_projector.to(dtype).to_empty(device=device)
    proj = model.multi_modal_projector.linear
    proj.weight.copy_(kaiming_uniform_init(generator, tuple(proj.weight.shape), dtype, device))
    proj.bias.zero_()
    model.language_model = modeling_llama.init_params(config.text_config, generator, dtype,
                                                      device)
    return model.train(train).requires_grad_(requires_grad)


def get_feat_extract_output_lengths(input_lengths):
    """Conv2 (stride 2) then avg-pool (stride 2): HF
    Qwen2AudioEncoder._get_feat_extract_output_lengths. Ints or tensors."""
    feat_lengths = (input_lengths - 1) // 2 + 1
    output_lengths = (feat_lengths - 2) // 2 + 1
    return feat_lengths, output_lengths


def encode_audio(model: Qwen2AudioForConditionalGeneration, input_features: torch.Tensor,
                 config: Qwen2AudioConfig, compute_dtype=torch.bfloat16,
                 remat_mode: str = "none") -> torch.Tensor:
    """input_features [B, mel, T] -> the projected audio [B, T // 4, E] in
    compute_dtype: the causal tower (its layers under remat_mode), avg-pool
    2 over time, the tower's final LayerNorm, the projector."""
    tower = model.audio_tower
    h = whisper_encoder.forward(tower, input_features, config.audio_config,
                                compute_dtype=compute_dtype, causal=True,
                                apply_final_layer_norm=False,
                                remat_mode=remat_mode)  # [B, T', D]
    B, T, D = h.shape
    h = h[:, :(T // 2) * 2].reshape(B, T // 2, 2, D).mean(dim=2)  # avg_pool1d(2, 2)
    h = tower.layer_norm(h)
    proj = model.multi_modal_projector.linear
    return linear(h, proj.weight.to(compute_dtype), proj.bias.to(compute_dtype))


def merge_audio_into_text(text_embeds: torch.Tensor, audio_embeds: torch.Tensor,
                          input_ids: torch.Tensor, audio_token_index: int) -> torch.Tensor:
    """text_embeds [B, L, E] with row b's j-th <|AUDIO|> position replaced by
    audio_embeds[b, j] ([B, Ta, E]; j clipped to Ta - 1)."""
    mask = input_ids == audio_token_index  # [B, L]
    idx = torch.cumsum(mask.to(torch.int64), dim=1) - 1  # j-th audio token
    idx = idx.clamp(0, audio_embeds.shape[1] - 1)
    gathered = torch.gather(audio_embeds, 1,
                            idx[..., None].expand(-1, -1, audio_embeds.shape[-1]))
    return torch.where(mask[..., None], gathered, text_embeds)


def forward(
    model: Qwen2AudioForConditionalGeneration,
    *,
    input_ids: Optional[torch.Tensor] = None,
    input_features: Optional[torch.Tensor] = None,  # [B, mel, T]
    feature_attention_mask: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    config: Qwen2AudioConfig,
    compute_dtype=torch.bfloat16,
    remat_mode: str = "none",
    selective_ac_option: str = "op",
    return_hidden: bool = False,
) -> torch.Tensor:
    """Logits [B, L, V] in compute_dtype (or the final-norm hidden state
    with return_hidden), as modeling_llama.forward, from
    embed_tokens(input_ids) with the encoded audio merged in (unless
    inputs_embeds is given). feature_attention_mask is taken and not read:
    the tower runs over every padded frame, as in the JAX forward."""
    del feature_attention_mask
    lm = model.language_model
    if inputs_embeds is None:
        inputs_embeds = F.embedding(input_ids, lm.model.embed_tokens.weight).to(compute_dtype)
        if input_features is not None:
            audio_embeds = encode_audio(model, input_features, config, compute_dtype,
                                        remat_mode)
            inputs_embeds = merge_audio_into_text(inputs_embeds, audio_embeds, input_ids,
                                                  config.audio_token_index)
    return modeling_llama.forward(
        lm,
        inputs_embeds=inputs_embeds,
        segment_ids=segment_ids,
        position_ids=position_ids,
        config=config.text_config,
        compute_dtype=compute_dtype,
        remat_mode=remat_mode,
        selective_ac_option=selective_ac_option,
        return_hidden=return_hidden,
    )


def get_num_params(config: Qwen2AudioConfig, exclude_embedding: bool = False) -> int:
    d = config.audio_config.d_model
    hidden = config.text_config.hidden_size
    return (
        whisper_encoder.get_num_params(config.audio_config)
        + d * hidden + hidden  # projector
        + modeling_llama.get_num_params(config.text_config, exclude_embedding)
    )


def get_num_flop_per_token(num_params: int, config: Qwen2AudioConfig, seq_len: int) -> float:
    """6N + 12*l*h*q*t over the text model (the reference excludes the
    speech encoder's flops)."""
    tc = config.text_config
    return 6 * num_params + 12 * tc.num_hidden_layers * (
        tc.num_attention_heads * tc.head_dim
    ) * seq_len
