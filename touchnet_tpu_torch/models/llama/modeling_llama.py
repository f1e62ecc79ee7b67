# Copyright (c) 2026 touchnet_tpu authors.
# Llama decoder weights as nn.Modules, with HF parameter names.
#
# Port of the serving half of touchnet_tpu/models/llama/modeling_llama.py:
# init_params (:44-90) and get_num_params (:490-510). The JAX package keeps
# per-layer weights stacked on a leading [L, ...] axis and loops with
# lax.scan; here each layer is its own module in a ModuleList and the loop
# is plain Python. The state_dict keys are the HF ones:
#   model.embed_tokens.weight                                  [V, E]
#   model.layers.{i}.input_layernorm.weight                    [E]
#   model.layers.{i}.self_attn.{q,k,v,o}_proj.weight (+ bias)
#   model.layers.{i}.post_attention_layernorm.weight           [E]
#   model.layers.{i}.mlp.{gate,up,down}_proj.weight
#   model.norm.weight                                          [E]
#   lm_head.weight                                             [V, E] (absent when tied)
#
# The training forward (remat modes, packed loss) belongs to the training
# slice and is not here.

from typing import Callable

import torch
from torch import nn

from touchnet_tpu_torch.models.common import (
    apply_rope,
    linear,
    normal_init,
    rms_norm,
    swiglu,
)
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig


class LlamaRMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight.to(x.dtype), self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        H, Hkv, Dh, E = (config.num_attention_heads, config.num_key_value_heads,
                         config.head_dim, config.hidden_size)
        ab = config.attention_bias  # Qwen2-style q/k/v biases
        self.q_proj = nn.Linear(E, H * Dh, bias=ab)
        self.k_proj = nn.Linear(E, Hkv * Dh, bias=ab)
        self.v_proj = nn.Linear(E, Hkv * Dh, bias=ab)
        self.o_proj = nn.Linear(H * Dh, E, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        E, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(E, inter, bias=False)
        self.up_proj = nn.Linear(E, inter, bias=False)
        self.down_proj = nn.Linear(inter, E, bias=False)

    def forward(self, x):
        dt = x.dtype
        return swiglu(x, self.gate_proj.weight.to(dt), self.up_proj.weight.to(dt),
                      self.down_proj.weight.to(dt))


def _proj(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    return linear(x, mod.weight.to(x.dtype), b)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size,
                                                     config.rms_norm_eps)
        self.mlp = LlamaMLP(config)

    def forward(self, h: torch.Tensor, position_ids: torch.Tensor,
                inv_freq: torch.Tensor, attend: Callable) -> torch.Tensor:
        """Pre-norm block. ``attend(q, k, v) -> [B, Tq, H, Dh]`` is the
        attention step after rope (the KV-cache write and the kernel call,
        supplied by inference_llama.forward_step). Weights are cast to h's
        compute dtype (a no-op when the model is stored in it)."""
        c = self.config
        B, Tq, _ = h.shape
        sa = self.self_attn
        normed = self.input_layernorm(h)
        q = _proj(sa.q_proj, normed).view(B, Tq, c.num_attention_heads, c.head_dim)
        k = _proj(sa.k_proj, normed).view(B, Tq, c.num_key_value_heads, c.head_dim)
        v = _proj(sa.v_proj, normed).view(B, Tq, c.num_key_value_heads, c.head_dim)
        q, k = apply_rope(q, k, position_ids, inv_freq)
        attn = attend(q, k, v)
        h = h + _proj(sa.o_proj, attn.reshape(B, Tq, -1))
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config) for _ in range(config.num_hidden_layers)
        )
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps)


class LlamaForCausalLM(nn.Module):
    """Weight holder for serving; inference_llama.forward_step runs it."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False)


def empty_model(config: LlamaConfig, dtype=torch.float32,
                device="cpu") -> LlamaForCausalLM:
    """Model with uninitialised storage on ``device``: built on the meta
    device, so no default nn.Linear init runs over ~1B parameters."""
    with torch.device("meta"):
        model = LlamaForCausalLM(config)
    return model.to_empty(device=device).to(dtype).eval().requires_grad_(False)


@torch.no_grad()
def init_params(config: LlamaConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> LlamaForCausalLM:
    """normal(0, initializer_range) weights, ones for norms, zero biases
    (HF LlamaPreTrainedModel._init_weights semantics, as the JAX
    init_params). Draws come from ``generator``, which must live on
    ``device``; the numbers differ from jax.random's for the same seed."""
    model = empty_model(config, dtype, device)
    std = config.initializer_range
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.copy_(normal_init(generator, p.shape, std, dtype, device))
    return model


def get_num_params(config: LlamaConfig, exclude_embedding: bool = False) -> int:
    E, L = config.hidden_size, config.num_hidden_layers
    H, Hkv, Dh = (
        config.num_attention_heads,
        config.num_key_value_heads,
        config.head_dim,
    )
    inter, V = config.intermediate_size, config.vocab_size
    per_layer = (
        2 * E  # norms
        + (H * Dh + 2 * Hkv * Dh) * E + E * H * Dh  # attention
        + 3 * inter * E  # mlp
    )
    if config.attention_bias:
        per_layer += H * Dh + 2 * Hkv * Dh
    n = V * E + L * per_layer + E
    if not config.tie_word_embeddings:
        n += V * E
    if exclude_embedding:
        n -= V * E
    return n
