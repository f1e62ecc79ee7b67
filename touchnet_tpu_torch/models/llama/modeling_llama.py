# Copyright (c) 2026 touchnet_tpu authors.
# Llama decoder weights as nn.Modules, with HF parameter names.
#
# Port of touchnet_tpu/models/llama/modeling_llama.py: init_params (:44-90),
# the training forward (:427-487) with decoder_layer (:330-424, the bthd
# branch), scan_layers (:226-297) with the int-k branch of
# _selective_layer_freq (:93-134), get_num_params (:490-510) and
# get_num_flop_per_token (:513). The training forward always attends
# through ops.attention.flash_attention (K1/K2 on the card);
# config.attn_implementation is not read, as in serving. The JAX package
# keeps per-layer weights stacked on a leading [L, ...] axis and loops with
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
# Mixed precision as in the JAX forward: the f32 master weights stay in the
# modules and each op casts its weights to the compute dtype (.to(x.dtype)),
# so the casts' gradients come back to the f32 leaves.
#
# Activation checkpointing (remat_mode) is torch.utils.checkpoint with
# use_reentrant=False around a whole layer: "none", "full" (every layer) and
# "selective" with an int k (full checkpointing of every k-th layer, the
# reference's semantics). The JAX modes that save the flash kernel's
# residuals by name ("op", "op_small", "op_names", "save:...", selective +
# "op", the op_every_k / full_every_k hybrids) raise: in PyTorch a
# selective-checkpoint policy can name K1 only once it is a
# torch.library.custom_op, which is later work.

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from touchnet_tpu_torch.models.common import (
    apply_rope,
    linear,
    normal_init,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.ops import attention as attn_ops


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
        attention step after rope (in serving the KV-cache write and the
        kernel call, supplied by inference_llama.forward_step; in training
        the packed flash attention, see forward). Weights are cast to h's
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
    """Weight holder: forward below runs it for training,
    inference_llama.forward_step for serving."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False)


def empty_model(config: LlamaConfig, dtype=torch.float32, device="cuda", *,
                requires_grad: bool = False, train: bool = False) -> LlamaForCausalLM:
    """Model with uninitialised storage on ``device``: built on the meta
    device, so no default nn.Linear init runs over ~1B parameters. The
    default is serving's: eval mode, no gradients; a trainer passes
    requires_grad=True, train=True."""
    with torch.device("meta"):
        model = LlamaForCausalLM(config)
    model = model.to_empty(device=device).to(dtype)
    return model.train(train).requires_grad_(requires_grad)


@torch.no_grad()
def init_params(config: LlamaConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, *, requires_grad: bool = False,
                train: bool = False) -> LlamaForCausalLM:
    """normal(0, initializer_range) weights, ones for norms, zero biases
    (HF LlamaPreTrainedModel._init_weights semantics, as the JAX
    init_params). Draws come from ``generator``, which must live on
    ``device`` (default: the generator's device, so the caller names the
    device through it); the numbers differ from jax.random's for the same
    seed. requires_grad / train as empty_model."""
    if device is None:
        device = generator.device
    model = empty_model(config, dtype, device, requires_grad=requires_grad, train=train)
    std = config.initializer_range
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.copy_(normal_init(generator, p.shape, std, dtype, device))
    return model


_SAVE_NAMED = ("op", "op_small", "op_names")


def remat_layers(remat_mode: str, selective_ac_option: str, num_layers: int) -> List[bool]:
    """Which layers run under torch.utils.checkpoint (scan_layers' choice
    of layers, as a list; "selective" with an int k checkpoints the layers
    with index % k == 0, the int branch of the JAX _selective_layer_freq).
    Raises ValueError for the modes that save named kernel residuals."""
    opt = str(selective_ac_option)
    named = (remat_mode in _SAVE_NAMED or remat_mode.startswith("save:")
             or (remat_mode == "selective" and (opt == "op" or opt.startswith("op_every_"))))
    if named:
        raise ValueError(
            f"remat mode {remat_mode!r} (selective_ac_option {opt!r}) saves the "
            "flash kernel's residuals by name; that needs K1 as a "
            "torch.library.custom_op and is a later slice. Use none, full, or "
            "selective with an int k"
        )
    if remat_mode == "none":
        return [False] * num_layers
    if remat_mode == "full":
        return [True] * num_layers
    if remat_mode == "selective":
        try:
            k = int(opt)
        except ValueError:
            k = 0
        if k < 1:
            raise ValueError(
                f"selective_ac_option must be 'op' or a positive int, got {opt!r}")
        return [i % k == 0 for i in range(num_layers)]
    raise ValueError(f"unknown remat mode {remat_mode!r}")


def _train_attention(segment_ids: Optional[torch.Tensor]) -> Callable:
    """Packed causal attention of the training forward: K1 (and K2 in the
    backward) through ops.attention.flash_attention, which takes its plain
    version only for CPU tensors. Looked up on the module at call time."""
    return lambda q, k, v: attn_ops.flash_attention(q, k, v, segment_ids)[0]


def forward(
    model: LlamaForCausalLM,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    config: LlamaConfig,
    compute_dtype=torch.bfloat16,
    remat_mode: str = "none",
    selective_ac_option: str = "op",
    return_hidden: bool = False,
) -> torch.Tensor:
    """Run the decoder; returns logits [B, T, V] in compute_dtype (or the
    final-norm hidden state [B, T, E] when return_hidden, for K3).
    position_ids restart per packed document; segment_ids is the packed
    document mask (attention_mask in the batch contract, 0 = padding)."""
    mp = model.model
    if inputs_embeds is None:
        inputs_embeds = F.embedding(input_ids, mp.embed_tokens.weight)
    h = inputs_embeds.to(compute_dtype)
    B, T, _ = h.shape
    if position_ids is None:
        position_ids = torch.arange(T, device=h.device).expand(B, T)
    inv_freq = rope_frequencies(config.head_dim, config.rope_theta,
                                rope_scaling=config.rope_scaling, device=h.device)
    attend = _train_attention(segment_ids)
    remat = remat_layers(remat_mode, selective_ac_option, len(mp.layers))
    for layer, ckpt in zip(mp.layers, remat):
        if ckpt:
            h = checkpoint(layer, h, position_ids, inv_freq, attend, use_reentrant=False)
        else:
            h = layer(h, position_ids, inv_freq, attend)
    h = mp.norm(h)
    if return_hidden:
        return h
    head_w = mp.embed_tokens.weight if config.tie_word_embeddings else model.lm_head.weight
    return linear(h, head_w.to(compute_dtype))


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


def get_num_flop_per_token(num_params: int, config: LlamaConfig, seq_len: int) -> float:
    """6N + 12*l*h*q*t (the JAX function, reference llama/__init__.py:39-54)."""
    return 6 * num_params + 12 * config.num_hidden_layers * (
        config.num_attention_heads * config.head_dim
    ) * seq_len
