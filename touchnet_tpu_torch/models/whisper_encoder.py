# Copyright (c) 2026 touchnet_tpu authors.
# Whisper audio encoder (the audio tower of Qwen2-Audio and Kimi-Audio), as
# nn.Modules with HF's parameter names.
#
# Port of touchnet_tpu/models/whisper_encoder.py: WhisperEncoderConfig
# (:27), sinusoidal_positions (:43), layer_norm (:52), init_params (:61),
# _conv1d (:104), forward (:114) and get_num_params (:218). Two mel convs
# (stride 1, then 2) with exact-erf GELU, the sinusoidal position table
# (tiled when the input runs past max_source_positions, as the JAX forward
# tiles it), then pre-LN blocks (LayerNorm with bias, MHA with q/v/out
# biases and no k bias, GELU MLP), and an optional final LayerNorm (Qwen2-
# Audio pools before it). LayerNorms compute in f32 and cast back; each op
# casts its weights to the compute dtype, as the JAX forward casts each
# layer's params. The convs are F.conv1d (the JAX forward computes them
# outside Pallas, with lax.conv_general_dilated); attention is
# ops.attention.flash_attention, K1 on the card (the JAX tower calls the
# static-grid kernel, attention.py:1445), with no segment ids: one
# document a row, causal or not as the caller asks. The JAX package stacks
# the layers on a leading [L, ...] axis and scans them; here each layer is
# a module. The state_dict keys are the HF WhisperEncoder ones:
#   conv1.{weight [D, mel, 3], bias}, conv2.{weight [D, D, 3], bias}
#   embed_positions.weight                         [max_source_positions, D]
#   layers.{i}.self_attn_layer_norm.{weight, bias}
#   layers.{i}.self_attn.{q,v,out}_proj.{weight, bias}, k_proj.weight
#   layers.{i}.final_layer_norm.{weight, bias}
#   layers.{i}.fc1.{weight, bias}, fc2.{weight, bias}
#   layer_norm.{weight, bias}
# Activation checkpointing over the layers is the Llama's (the JAX forward
# wraps its scan body in modeling_llama._apply_remat, :206-208):
# modeling_llama.remat_layers picks each layer's save set and _run_layer
# runs it, the projections carrying the Llama's dot_* names and K1 its
# flash_out / flash_lse, so every mode saves what it saves in the Llama.

import math
from dataclasses import dataclass
from typing import Callable, FrozenSet, Optional

import torch
import torch.nn.functional as F
from torch import nn

from touchnet_tpu_torch.models.common import normal_init
from touchnet_tpu_torch.models.llama.modeling_llama import (
    _proj,
    _run_layer,
    remat_block,
    remat_layers,
    run_block,
)
from touchnet_tpu_torch.ops import attention as attn_ops


@dataclass
class WhisperEncoderConfig:
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    max_source_positions: int = 1500
    activation_function: str = "gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "WhisperEncoderConfig":
        names = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in names})


def sinusoidal_positions(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoid table [length, channels] f32 (log-spaced
    timescales, sin | cos concatenated)."""
    assert channels % 2 == 0
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv_timescales = torch.exp(-log_timescale * torch.arange(channels // 2, device=device,
                                                             dtype=torch.float32))
    scaled = torch.arange(length, device=device, dtype=torch.float32)[:, None] * \
        inv_timescales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with a cast back to x's dtype (the JAX layer_norm)."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


class WhisperLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class WhisperAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d, bias=True)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=True)
        self.out_proj = nn.Linear(d, d, bias=True)


class WhisperEncoderLayer(nn.Module):
    # the projections' residual names in the order the block runs their
    # matmuls (modeling_llama._save_policy's names)
    DOTS = ("dot_q", "dot_k", "dot_v", "dot_o", "dot_gate", "dot_down")

    def __init__(self, config: WhisperEncoderConfig):
        super().__init__()
        d, eps = config.d_model, config.layer_norm_eps
        self.heads = config.encoder_attention_heads
        self.self_attn_layer_norm = WhisperLayerNorm(d, eps)
        self.self_attn = WhisperAttention(d)
        self.final_layer_norm = WhisperLayerNorm(d, eps)
        self.fc1 = nn.Linear(d, config.encoder_ffn_dim, bias=True)
        self.fc2 = nn.Linear(config.encoder_ffn_dim, d, bias=True)

    def forward(self, h: torch.Tensor, attend: Callable,
                remat: Optional[FrozenSet[str]] = None) -> torch.Tensor:
        """The block under ``remat`` (modeling_llama.run_block: checkpointed,
        and compiled when apply_compile gave the layer a compiled block)."""
        return run_block(self, remat, h, attend)

    def checkpointed_block(self, save, *args):
        """remat_block of this class (modeling_llama.LlamaDecoderLayer's twin)."""
        return remat_block(self, save, *args)

    def block(self, h: torch.Tensor, attend: Callable) -> torch.Tensor:
        """Pre-LN block (the JAX forward's layer, :157-196); the projections
        carry the JAX tower's residual names, as the Llama's do. ``attend(q,
        k, v) -> [B, T, H, hd]`` is the attention (the tower's is
        flash_attention, see forward; Kimi-Audio's speech tokenizer runs the
        same block with its block-causal attention)."""
        B, T, D = h.shape
        hd = D // self.heads
        sa = self.self_attn
        normed = self.self_attn_layer_norm(h)
        q = _proj(sa.q_proj, normed, "dot_q").view(B, T, self.heads, hd)
        k = _proj(sa.k_proj, normed, "dot_k").view(B, T, self.heads, hd)
        v = _proj(sa.v_proj, normed, "dot_v").view(B, T, self.heads, hd)
        attn = attend(q, k, v)
        h = h + _proj(sa.out_proj, attn.reshape(B, T, D), "dot_o")
        mid = F.gelu(_proj(self.fc1, self.final_layer_norm(h), "dot_gate"))  # exact erf GELU
        return h + _proj(self.fc2, mid, "dot_down")


class WhisperEncoder(nn.Module):
    """Weight holder; forward below runs it."""

    def __init__(self, config: WhisperEncoderConfig):
        super().__init__()
        d = config.d_model
        self.config = config
        self.conv1 = nn.Conv1d(config.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(config.max_source_positions, d)
        self.layers = nn.ModuleList(WhisperEncoderLayer(config)
                                    for _ in range(config.encoder_layers))
        self.layer_norm = WhisperLayerNorm(d, config.layer_norm_eps)


@torch.no_grad()
def init_params(config: WhisperEncoderConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> WhisperEncoder:
    """normal(0, 0.02) weights, zero biases, unit LayerNorm scales and the
    sinusoid table (the JAX init_params), drawn from ``generator`` on its
    device (or ``device``); the numbers differ from jax.random's. Eval mode,
    no gradients."""
    if device is None:
        device = generator.device
    with torch.device("meta"):
        model = WhisperEncoder(config)
    model = model.to(dtype).to_empty(device=device)
    for name, p in model.named_parameters():
        if name == "embed_positions.weight":
            p.copy_(sinusoidal_positions(config.max_source_positions, config.d_model, device))
        elif name.endswith("layer_norm.weight"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.copy_(normal_init(generator, p.shape, 0.02, dtype, device))
    return model.eval().requires_grad_(False)


def _conv1d(x, conv: nn.Conv1d, stride: int) -> torch.Tensor:
    """The JAX _conv1d: the convolution in x's dtype, then the bias added."""
    out = F.conv1d(x, conv.weight.to(x.dtype), None, stride=stride, padding=1)
    return out + conv.bias.to(out.dtype)[None, :, None]


def forward(model: WhisperEncoder, input_features: torch.Tensor, config: WhisperEncoderConfig,
            *, compute_dtype=torch.bfloat16, causal: bool = True,
            apply_final_layer_norm: bool = False, remat_mode: str = "none",
            selective_ac_option: str = "op") -> torch.Tensor:
    """input_features [B, mel, T] -> [B, ceil(T / 2), d_model] in compute_dtype.
    causal=True is the reference's streamable patch, which Qwen2-Audio runs
    also at inference; apply_final_layer_norm=False is Qwen2-Audio's (it
    pools first). remat_mode / selective_ac_option checkpoint the layers as
    modeling_llama.remat_layers says (the JAX tower passes no option: "op")."""
    x = input_features.to(compute_dtype)
    x = F.gelu(_conv1d(x, model.conv1, 1))
    x = F.gelu(_conv1d(x, model.conv2, 2))
    h = x.transpose(1, 2)  # [B, T', D]
    T = h.shape[1]
    table = model.embed_positions.weight
    reps = -(-T // table.shape[0])
    # past max_source_positions the table repeats (the JAX jnp.tile)
    h = h + table.repeat(reps, 1)[:T].to(compute_dtype)[None]
    scale = 1.0 / math.sqrt(config.d_model // config.encoder_attention_heads)

    def attend(q, k, v):
        return attn_ops.flash_attention(q, k, v, None, causal, scale)[0]

    remat = remat_layers(remat_mode, selective_ac_option, len(model.layers))
    for layer, save in zip(model.layers, remat):
        h = _run_layer(layer, save, h, attend)
    if apply_final_layer_norm:
        h = model.layer_norm(h)
    return h


def get_num_params(config: WhisperEncoderConfig) -> int:
    D, L, F_, mel = (config.d_model, config.encoder_layers, config.encoder_ffn_dim,
                     config.num_mel_bins)
    conv = D * mel * 3 + D + D * D * 3 + D
    per_layer = (
        4 * D * D + 3 * D  # attention (k has no bias)
        + 2 * D * F_ + F_ + D  # mlp
        + 4 * D  # two layer norms
    )
    return conv + L * per_layer + 2 * D  # + final LN (the position table is frozen)
