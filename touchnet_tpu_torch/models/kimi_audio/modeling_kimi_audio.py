# Copyright (c) 2026 touchnet_tpu authors.
# Kimi-Audio (MoonshotKimiaForCausalLM): a Qwen2 backbone whose hidden state
# after layer kimia_mimo_transformer_from_layer_index also feeds
# kimia_mimo_layers more layers (the audio "mimo" stream, with its own norm
# and head), a continuous whisper speech encoder, a frozen WhisperVQ speech
# tokenizer and the VQAdaptor MLP, as nn.Modules with HF's parameter names.
#
# Port of touchnet_tpu/models/kimi_audio/modeling_kimi_audio.py:
# init_vq_params (:42), _causal_conv1d (:84), _block_causal_attention (:94),
# vector_quantize (:109), speech_tokenizer_forward (:118), init_params
# (:192), vq_adaptor_forward (:246), _mask_between_markers (:254),
# prepare_audio_input_embs (:266), forward (:311), get_num_params (:401) and
# get_num_flop_per_token (:433). The JAX forward's shard_fn and remat
# options come with the SFT slice.
#
# Where each attention runs:
#   - the backbone and the mimo stream: the port's Llama layers, K1 on the
#     card (forward here; serving goes through generate_kimi_audio and
#     inference_llama, K1 prefill and K4 decode);
#   - the speech encoder: whisper_encoder.forward, non-causal, with its
#     final LayerNorm: K1 with no segment ids, the JAX static-grid call
#     (attention.py:1445);
#   - the speech tokenizer: block_causal_attention below, plain PyTorch on
#     the CPU and on the card. It is the one attention of the path that is
#     not a kernel: the JAX package computes it in dense jnp, not Pallas,
#     and its mask, "causal OR same quantize_causal_block_size-frame block",
#     AND key padding, is not K1's (causal AND same segment).
#
# The state_dict keys are the HF ones:
#   model.embed_tokens.weight, model.layers.{i}.*, model.norm.weight
#   model.mimo_layers.{i}.* (Qwen2 layers), model.mimo_norm.weight
#   model.vq_adaptor.layers.{0,3}.{weight,bias} (Linear), .4.{weight,bias} (LayerNorm)
#   speech_encoder.<the WhisperEncoder keys of models/whisper_encoder.py>
#   speech_tokenizer.{conv1,conv2}.{weight,bias}, .embed_positions.weight,
#     .embed_positions2.weight (held, never read by the forward),
#     .codebook.weight, .layers.{i}.<a WhisperEncoderLayer's keys>
#   lm_head.weight, mimo_output.weight

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from touchnet_tpu_torch.models import whisper_encoder
from touchnet_tpu_torch.models.common import linear, normal_init, rope_frequencies
from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import (
    KimiAudioConfig,
    WhisperVQConfig,
)
from touchnet_tpu_torch.models.llama import modeling_llama
from touchnet_tpu_torch.ops.attention import DEFAULT_MASK_VALUE

# ---------------------------------------------------------------------------
# WhisperVQ speech tokenizer (frozen)
# ---------------------------------------------------------------------------


def _layer_config(config: WhisperVQConfig) -> whisper_encoder.WhisperEncoderConfig:
    """The whisper config of the tokenizer's layers (the tower's layer
    module serves both)."""
    return whisper_encoder.WhisperEncoderConfig(
        num_mel_bins=config.num_mel_bins, d_model=config.d_model,
        encoder_layers=config.quantize_position,
        encoder_attention_heads=config.encoder_attention_heads,
        encoder_ffn_dim=config.encoder_ffn_dim,
        max_source_positions=config.max_source_positions,
        layer_norm_eps=config.layer_norm_eps)


class WhisperVQEncoder(nn.Module):
    """Weight holder; speech_tokenizer_forward runs it. The convolutions are
    causal (left padding k - 1), applied by causal_conv1d."""

    def __init__(self, config: WhisperVQConfig):
        super().__init__()
        D = config.d_model
        self.config = config
        self.conv1 = nn.Conv1d(config.num_mel_bins, D, 3)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2)
        self.embed_positions = nn.Embedding(config.max_source_positions, D)
        pooled = -(-config.max_source_positions // config.pooling_kernel_size)
        self.embed_positions2 = nn.Embedding(pooled, D)
        self.codebook = nn.Embedding(config.quantize_vocab_size, D)
        layer_cfg = _layer_config(config)
        self.layers = nn.ModuleList(whisper_encoder.WhisperEncoderLayer(layer_cfg)
                                    for _ in range(config.quantize_position))


def causal_conv1d(x: torch.Tensor, conv: nn.Conv1d, stride: int = 1) -> torch.Tensor:
    """GLM-4-Voice CausalConv1d (padding (k - 1, 0)) in x's dtype, then the
    bias: the JAX _causal_conv1d."""
    k = conv.weight.shape[-1]
    out = F.conv1d(F.pad(x, (k - 1, 0)), conv.weight.to(x.dtype), None, stride=stride)
    return out + conv.bias.to(out.dtype)[None, :, None]


def block_causal_attention(q, k, v, frame_mask, block_size: int, scale: float):
    """Dense attention under (causal OR same block) AND key padding.
    q/k/v [B, T, H, Dh], frame_mask [B, T] (1 = valid) -> [B, T, H, Dh] in
    v's dtype. Scores and softmax in f32, p cast to v's dtype for the PV
    product (the JAX function's precision chain)."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    rows, cols = pos[:, None], pos[None, :]
    allowed = (rows >= cols) | ((rows // block_size) == (cols // block_size))
    mask = allowed[None, None] & (frame_mask[:, None, None, :] > 0)
    s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)


def vector_quantize(h: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codeword indices, h [B, T, D], codebook [V, D] -> [B, T]
    int64: argmax of 2 h.c - |c|^2 in f32 (argmin |h - c|^2). A tie goes to
    the smallest index, as jnp.argmax breaks it (torch.argmax returns the
    first maximum too); near-ties may flip between the two frameworks'
    summation orders."""
    cb = codebook.float()
    scores = 2.0 * torch.einsum("btd,vd->btv", h.float(), cb) - (cb * cb).sum(-1)
    return torch.argmax(scores, dim=-1)


def speech_tokenizer_hidden(tok: WhisperVQEncoder, input_features: torch.Tensor,
                            attention_mask: torch.Tensor, config: WhisperVQConfig,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The pooled states the codebook is searched with, [B, ceil(T' / 4), D]
    in compute_dtype (T' = ceil(T / 2)): causal convs with exact GELU, the
    position table, quantize_position whisper layers under the block-causal
    mask, zero-padding to a multiple of pooling_kernel_size, avg (or max)
    pool. Raises when T' outgrows the position table (the JAX forward fails
    there with a shape error)."""
    x = input_features.to(compute_dtype)
    x = F.gelu(causal_conv1d(x, tok.conv1))
    x = F.gelu(causal_conv1d(x, tok.conv2, stride=2))
    h = x.transpose(1, 2)  # [B, T', D]
    B, T, D = h.shape
    table = tok.embed_positions.weight
    if T > table.shape[0]:
        raise ValueError(f"the speech tokenizer's position table holds {table.shape[0]} frames "
                         f"({table.shape[0] / 50:.0f} s); the input has {T}")
    sub_mask = attention_mask[:, ::2][:, :T]
    h = h + table[:T].to(compute_dtype)[None]
    scale = 1.0 / math.sqrt(D // config.encoder_attention_heads)
    block = config.quantize_causal_block_size

    def attend(q, k, v):
        return block_causal_attention(q, k, v, sub_mask, block, scale)

    for layer in tok.layers:
        h = layer(h, attend)
    ksz = config.pooling_kernel_size
    pad = (-T) % ksz
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    pooled = h.reshape(B, (T + pad) // ksz, ksz, D)
    return pooled.mean(dim=2) if config.pooling_type == "avg" else pooled.amax(dim=2)


@torch.no_grad()
def speech_tokenizer_forward(tok: WhisperVQEncoder, input_features: torch.Tensor,
                             attention_mask: torch.Tensor, config: WhisperVQConfig,
                             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The frozen tokenizer: input_features [B, mel, T], attention_mask [B, T]
    frame validity -> codes [B, ceil(T / 8)] int64 (pooling at the last
    layer, pooling_position == quantize_position, as the JAX forward)."""
    pooled = speech_tokenizer_hidden(tok, input_features, attention_mask, config,
                                     compute_dtype)
    return vector_quantize(pooled, tok.codebook.weight)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


class VQAdaptor(nn.Module):
    """Linear -> SiLU -> Dropout(0) -> Linear -> LayerNorm, HF's indices."""

    def __init__(self, config: KimiAudioConfig):
        super().__init__()
        E = config.text_config.hidden_size
        self.layers = nn.Sequential(
            nn.Linear(config.kimia_adaptor_input_dim, E), nn.SiLU(), nn.Dropout(0.0),
            nn.Linear(E, E),
            whisper_encoder.WhisperLayerNorm(E, config.text_config.rms_norm_eps))


class KimiAudioModel(nn.Module):
    def __init__(self, config: KimiAudioConfig):
        super().__init__()
        tc = config.text_config
        self.embed_tokens = nn.Embedding(tc.vocab_size, tc.hidden_size)
        self.layers = nn.ModuleList(modeling_llama.LlamaDecoderLayer(tc)
                                    for _ in range(tc.num_hidden_layers))
        self.norm = modeling_llama.LlamaRMSNorm(tc.hidden_size, tc.rms_norm_eps)
        self.mimo_layers = nn.ModuleList(modeling_llama.LlamaDecoderLayer(tc)
                                         for _ in range(config.kimia_mimo_layers))
        self.mimo_norm = modeling_llama.LlamaRMSNorm(tc.hidden_size, tc.rms_norm_eps)
        self.vq_adaptor = VQAdaptor(config)


class KimiAudioForCausalLM(nn.Module):
    """Weight holder: forward below runs it; serving runs the text stack
    through inference_llama.generate (model.model.layers, model.model.norm,
    model.lm_head: the JAX CLI's lm_params view) and both stacks through
    generate_kimi_audio.generate_dual."""

    def __init__(self, config: KimiAudioConfig):
        super().__init__()
        tc = config.text_config
        self.config = config
        self.model = KimiAudioModel(config)
        self.speech_encoder = whisper_encoder.WhisperEncoder(config.speech_encoder_config)
        self.speech_tokenizer = WhisperVQEncoder(config.speech_tokenizer_config)
        self.lm_head = nn.Linear(tc.hidden_size, tc.vocab_size, bias=False)
        self.mimo_output = nn.Linear(tc.hidden_size, tc.vocab_size, bias=False)


def empty_model(config: KimiAudioConfig, dtype=torch.float32, device="cuda", *,
                requires_grad: bool = False, train: bool = False) -> KimiAudioForCausalLM:
    """Model with uninitialised storage on ``device``, built on the meta
    device and given its dtype there (no copy in another dtype is ever
    allocated on ``device``: in f32 the model alone is 43 GB). Serving's
    defaults, as modeling_llama.empty_model."""
    with torch.device("meta"):
        model = KimiAudioForCausalLM(config)
    model = model.to(dtype).to_empty(device=device)
    return model.train(train).requires_grad_(requires_grad)


_ONES = ("layernorm.weight", "norm.weight", "layer_norm.weight", "vq_adaptor.layers.4.weight")


@torch.no_grad()
def init_params(config: KimiAudioConfig, generator: torch.Generator, dtype=torch.float32,
                device=None) -> KimiAudioForCausalLM:
    """The JAX init_params' distributions, drawn from ``generator`` on its
    device (or ``device``); the numbers differ from jax.random's: the speech
    encoder as whisper_encoder.init_params; the Qwen2 layers (main and mimo)
    and the embedding normal(0, initializer_range); the adaptor's linears,
    the heads and every tokenizer weight (convs, position tables, codebook,
    projections) normal(0, 0.02); norms one, biases zero. Eval mode, no
    gradients."""
    if device is None:
        device = generator.device
    model = empty_model(config, dtype, device)
    model.speech_encoder = whisper_encoder.init_params(config.speech_encoder_config,
                                                       generator, dtype, device)
    std_lm = config.text_config.initializer_range
    for name, p in model.named_parameters():
        if name.startswith("speech_encoder."):
            continue
        if name.endswith(_ONES):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            lm = name.startswith("model.") and not name.startswith("model.vq_adaptor.")
            p.copy_(normal_init(generator, p.shape, std_lm if lm else 0.02, dtype, device))
    return model.eval().requires_grad_(False)


def vq_adaptor_forward(adaptor: VQAdaptor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Linear -> SiLU -> Linear -> LayerNorm (eps: the text config's
    rms_norm_eps, as the JAX forward passes it), weights cast to x's dtype."""
    la = adaptor.layers
    x = F.silu(linear(x, la[0].weight.to(x.dtype), la[0].bias.to(x.dtype)))
    x = linear(x, la[3].weight.to(x.dtype), la[3].bias.to(x.dtype))
    return whisper_encoder.layer_norm(x, la[4].weight, la[4].bias, eps)


def mask_between_markers(ids: torch.Tensor, begin: int, end: int) -> torch.Tensor:
    """[B, T] bool: True strictly between the first begin and the first end
    marker of each row, in either order; all False in a row that lacks
    either marker (the JAX _mask_between_markers)."""
    T = ids.shape[1]
    pos = torch.arange(T, device=ids.device)[None, :]
    begin_pos = torch.where(ids == begin, pos, T).amin(dim=1, keepdim=True)
    end_pos = torch.where(ids == end, pos, T).amin(dim=1, keepdim=True)
    lo, hi = torch.minimum(begin_pos, end_pos), torch.maximum(begin_pos, end_pos)
    has = ((ids == begin).any(dim=1) & (ids == end).any(dim=1))[:, None]
    return (pos > lo) & (pos < hi) & has


def encode_speech(model: KimiAudioForCausalLM, whisper_input_features: torch.Tensor,
                  whisper_attention_mask: torch.Tensor, config: KimiAudioConfig,
                  compute_dtype=torch.bfloat16) -> tuple:
    """(the adaptor's output [B, Tw // 4, E], the VQ codes [B, Ta]) of
    features [B, mel, T]: the non-causal tower with its final LayerNorm
    (K1 on the card), four frames stacked into one, the adaptor; and the
    frozen tokenizer's codes."""
    enc = whisper_encoder.forward(model.speech_encoder, whisper_input_features,
                                  config.speech_encoder_config, compute_dtype=compute_dtype,
                                  causal=False, apply_final_layer_norm=True)  # [B, Tw, D]
    B, Tw, D = enc.shape
    enc = enc[:, :(Tw // 4) * 4].reshape(B, Tw // 4, 4 * D)
    cont = vq_adaptor_forward(model.model.vq_adaptor, enc, config.text_config.rms_norm_eps)
    codes = speech_tokenizer_forward(model.speech_tokenizer, whisper_input_features,
                                     whisper_attention_mask, config.speech_tokenizer_config,
                                     compute_dtype)
    return cont, codes


def prepare_audio_input_embs(model: KimiAudioForCausalLM, audio_input_ids: torch.Tensor,
                             audio_input_embs: torch.Tensor,
                             whisper_input_features: torch.Tensor,
                             whisper_attention_mask: torch.Tensor, config: KimiAudioConfig,
                             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """audio_input_embs [B, T, E] with the positions strictly between the
    media markers replaced, the j-th by speech frame j (clipped to the last
    frame): (adaptor output + embed(code + kimia_token_offset)) * sqrt(2)."""
    cont, codes = encode_speech(model, whisper_input_features, whisper_attention_mask,
                                config, compute_dtype)
    disc = F.embedding(codes + config.kimia_token_offset,
                       model.model.embed_tokens.weight).to(compute_dtype)
    speech = (cont + disc) * math.sqrt(2.0)  # [B, Ta, E]
    mask = mask_between_markers(audio_input_ids, config.kimia_media_begin,
                                config.kimia_media_end)
    idx = (torch.cumsum(mask.to(torch.int64), dim=1) - 1).clamp(0, speech.shape[1] - 1)
    gathered = torch.gather(speech, 1, idx[..., None].expand(-1, -1, speech.shape[-1]))
    return torch.where(mask[..., None], gathered.to(audio_input_embs.dtype), audio_input_embs)


def forward(
    model: KimiAudioForCausalLM,
    *,
    text_input_ids: Optional[torch.Tensor] = None,
    audio_input_ids: torch.Tensor,
    whisper_input_features: Optional[torch.Tensor] = None,
    whisper_attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    config: KimiAudioConfig,
    compute_dtype=torch.bfloat16,
    return_audio_logits: bool = False,
):
    """Text logits [B, T, V] in compute_dtype (and the mimo stream's audio
    logits with return_audio_logits): the audio stream's embeddings with
    the speech merged between the media markers, plus the text stream's;
    the backbone split after layer kimia_mimo_transformer_from_layer_index,
    whose hidden state the mimo layers continue."""
    tc = config.text_config
    mp = model.model
    embed = mp.embed_tokens.weight
    h = F.embedding(audio_input_ids, embed).to(compute_dtype)
    if config.use_whisper_feature and whisper_input_features is not None:
        h = prepare_audio_input_embs(model, audio_input_ids, h, whisper_input_features,
                                     whisper_attention_mask, config, compute_dtype)
    if text_input_ids is not None:
        h = h + F.embedding(text_input_ids, embed).to(compute_dtype)
    B, T, _ = h.shape
    if position_ids is None:
        position_ids = torch.arange(T, device=h.device).expand(B, T)
    inv_freq = rope_frequencies(tc.head_dim, tc.rope_theta, rope_scaling=tc.rope_scaling,
                                device=h.device)
    attend = modeling_llama._train_attention(segment_ids)
    fork = config.kimia_mimo_transformer_from_layer_index + 1
    for layer in mp.layers[:fork]:
        h = layer(h, position_ids, inv_freq, attend)
    mimo_h = h  # the forked stream (the reference captures after layer idx)
    for layer in mp.layers[fork:]:
        h = layer(h, position_ids, inv_freq, attend)
    text_logits = linear(mp.norm(h), model.lm_head.weight.to(compute_dtype))
    if not return_audio_logits:
        return text_logits
    for layer in mp.mimo_layers:
        mimo_h = layer(mimo_h, position_ids, inv_freq, attend)
    audio_logits = linear(mp.mimo_norm(mimo_h), model.mimo_output.weight.to(compute_dtype))
    return text_logits, audio_logits


def get_num_params(config: KimiAudioConfig, exclude_embedding: bool = False) -> int:
    tc = config.text_config
    hidden = tc.hidden_size
    n = modeling_llama.get_num_params(tc, exclude_embedding)
    # mimo layers + norm
    per_layer = (
        2 * hidden
        + (tc.num_attention_heads * tc.head_dim + 2 * tc.num_key_value_heads * tc.head_dim)
        * hidden + hidden * tc.num_attention_heads * tc.head_dim
        + 3 * tc.intermediate_size * hidden
    )
    if tc.attention_bias:
        per_layer += tc.num_attention_heads * tc.head_dim + 2 * tc.num_key_value_heads * tc.head_dim
    n += config.kimia_mimo_layers * per_layer + hidden
    # vq adaptor
    n += (
        hidden * config.kimia_adaptor_input_dim + hidden
        + hidden * hidden + hidden + 2 * hidden
    )
    # speech encoder
    n += whisper_encoder.get_num_params(config.speech_encoder_config)
    # speech tokenizer (frozen, still counted as model params)
    vq = config.speech_tokenizer_config
    D, L, F_ = vq.d_model, vq.quantize_position, vq.encoder_ffn_dim
    n += D * vq.num_mel_bins * 3 + D + D * D * 3 + D  # convs
    n += L * (4 * D * D + 3 * D + 2 * D * F_ + F_ + D + 4 * D)
    n += vq.quantize_vocab_size * D  # codebook
    # mimo_output head (lm_head counted in llama when untied)
    n += tc.vocab_size * hidden
    return n


def get_num_flop_per_token(num_params: int, config: KimiAudioConfig, seq_len: int) -> float:
    """6N + 12*l*h*q*t with l counting the mimo layers too (the reference's
    kimi formula, kimi_audio/__init__.py:63-80)."""
    tc = config.text_config
    layers = tc.num_hidden_layers + config.kimia_mimo_layers
    return 6 * num_params + 12 * layers * (tc.num_attention_heads * tc.head_dim) * seq_len
