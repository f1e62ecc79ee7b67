# Copyright (c) 2026 touchnet_tpu authors.
# Llama decoder weights as nn.Modules, with HF parameter names.
#
# Port of touchnet_tpu/models/llama/modeling_llama.py: init_params (:44-90),
# the training forward (:427-487) with decoder_layer (:330-424, the bthd
# branch), scan_layers (:226-297) with _selective_layer_freq (:93-134) and
# the save sets of _apply_remat (:137-223), get_num_params (:490-510) and
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
# use_reentrant=False around a whole layer, with the JAX modes and layer
# choices (_apply_remat :137-223, scan_layers :226-297): "full" recomputes
# the whole layer; the modes that save named residuals run a selective
# checkpoint policy (create_selective_checkpoint_contexts) that saves the
# outputs of the ops named in the mode's save set, by the names of the JAX
# checkpoint_name tags (decoder_layer :392-423):
#   flash_out, flash_lse    the outputs of K1's custom op (ops.attention);
#                           one op gives both, so it is saved when both
#                           names are in the set and re-run otherwise (as
#                           JAX re-runs the kernel for a residual it lacks);
#   dot_q/k/v/o, dot_gate/up/down   the projections' matmuls. A bare aten.mm
#                           carries no name, so the layer sets a tag around
#                           each projection (_tagged) and the policy reads
#                           it; the recompute runs the same code, sets the
#                           same tags, and so decides the same way.
# Everything else (norms, rope, casts, the SwiGLU product) is recomputed.

import contextlib
import functools
import threading
from typing import Callable, FrozenSet, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from touchnet_tpu_torch.models.common import (
    apply_rope,
    linear,
    normal_init,
    rms_norm,
    rope_frequencies,
)
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.ops import attention as attn_ops
from touchnet_tpu_torch.parallel.sharding import (
    embed,
    head_logits,
    local,
    sum_backward,
    sum_forward,
    tp_group,
)


class LlamaRMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, local(self.weight).to(x.dtype), self.eps)


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
        """SwiGLU, down(silu(gate(x)) * up(x)) (the JAX common.swiglu), with
        each matmul under its residual name. Under tensor parallelism (the
        plan of parallel/sharding.py) gate/up hold this rank's columns and
        down its rows: x's gradient and down's output are summed over tp."""
        group = tp_group(self)
        x = sum_backward(x, group)
        g = _proj(self.gate_proj, x, "dot_gate")
        u = _proj(self.up_proj, x, "dot_up")
        return sum_forward(_proj(self.down_proj, F.silu(g) * u, "dot_down"), group)


class _Tag(threading.local):
    name: Optional[str] = None


_TAG = _Tag()


@contextlib.contextmanager
def _tagged(name: str):
    """While open, the matmuls this thread dispatches carry ``name`` for
    the checkpoint policy (_save_policy)."""
    prev, _TAG.name = _TAG.name, name
    try:
        yield
    finally:
        _TAG.name = prev


def _proj(mod: nn.Linear, x: torch.Tensor, name: str) -> torch.Tensor:
    b = None if mod.bias is None else local(mod.bias).to(x.dtype)
    w = local(mod.weight).to(x.dtype)
    with _tagged(name):
        return linear(x, w, b)


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
        compute dtype (a no-op when the model is stored in it). Under tensor
        parallelism q/k/v hold this rank's heads (the kernels see them
        alone) and o its rows: the normed input's gradient and o's output
        are summed over tp."""
        c = self.config
        B, Tq, _ = h.shape
        sa = self.self_attn
        group = tp_group(sa)
        normed = sum_backward(self.input_layernorm(h), group)
        q = _proj(sa.q_proj, normed, "dot_q").view(B, Tq, -1, c.head_dim)
        k = _proj(sa.k_proj, normed, "dot_k").view(B, Tq, -1, c.head_dim)
        v = _proj(sa.v_proj, normed, "dot_v").view(B, Tq, -1, c.head_dim)
        q, k = apply_rope(q, k, position_ids, inv_freq)
        attn = attend(q, k, v)
        h = h + sum_forward(_proj(sa.o_proj, attn.reshape(B, Tq, -1), "dot_o"), group)
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
    # the dtype is set on the meta device: no f32 copy of the weights is
    # ever allocated on `device` (for an 8 B model in bf16 that copy is 32 GB)
    model = model.to(dtype).to_empty(device=device)
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


FLASH_NAMES = ("flash_out", "flash_lse")
ATTN_DOTS = ("dot_q", "dot_k", "dot_v", "dot_o")
MLP_DOTS = ("dot_gate", "dot_up", "dot_down")
RESIDUAL_NAMES = FLASH_NAMES + ATTN_DOTS + MLP_DOTS
# the save sets of _apply_remat's named policies; "op" saves what
# dots_with_no_batch_dims_saveable picks in the layer, every projection
SAVE_SETS = {
    "op": frozenset(RESIDUAL_NAMES),
    "op_names": frozenset(RESIDUAL_NAMES),
    "op_small": frozenset(FLASH_NAMES + ATTN_DOTS),
    "selective": frozenset(FLASH_NAMES),  # selective + "op"
}
FULL = frozenset()  # a layer recomputed whole
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _layer_freq(remat_mode: str, opt: str) -> int:
    """k of the every-k-th-layer modes, 0 when the mode uses none: the JAX
    _selective_layer_freq (:93-134)."""
    for prefix, mode in (("full_every_", "op"), ("op_every_", "selective")):
        if opt.startswith(prefix):
            if remat_mode != mode:
                if remat_mode == "selective":
                    raise ValueError(f"selective_ac_option {opt!r} applies to mode {mode!r}")
                return 0
            k = int(opt[len(prefix):])
            if k < 1:
                raise ValueError(f"{prefix}<k> needs k >= 1, got {k}")
            return k
    if remat_mode != "selective" or opt == "op":
        return 0
    try:
        k = int(opt)
    except ValueError:
        k = 0
    if k < 1:
        raise ValueError(f"selective_ac_option must be 'op' or a positive int, got {opt!r}")
    return k


def _save_set(remat_mode: str) -> Optional[FrozenSet[str]]:
    """The save set of a mode applied to every layer (None: no remat)."""
    if remat_mode == "none":
        return None
    if remat_mode == "full":
        return FULL
    if remat_mode.startswith("save:"):
        names = frozenset(n for n in remat_mode[len("save:"):].split(",") if n)
        if not names:
            raise ValueError("remat_mode 'save:' needs at least one name")
        unknown = sorted(names - set(RESIDUAL_NAMES))
        if unknown:
            raise ValueError(f"remat_mode {remat_mode!r}: no residual named {unknown}; "
                             f"the names are {RESIDUAL_NAMES}")
        return names
    if remat_mode in SAVE_SETS:
        return SAVE_SETS[remat_mode]
    raise ValueError(f"unknown remat mode {remat_mode!r}")


def remat_layers(remat_mode: str, selective_ac_option: str,
                 num_layers: int) -> List[Optional[FrozenSet[str]]]:
    """Each layer's checkpointing, as scan_layers chooses it: None (the
    layer keeps all its activations), FULL (recomputed whole) or the set of
    residual names it saves (the rest recomputed). With an every-k-th mode,
    the layers with index % k == 0 are the first of their group:
      selective + int k:       FULL on those, None on the rest;
      op + full_every_<k>:     FULL on those, op's set on the rest;
      selective + op_every_<k>: op's set on those, the flash residuals on
                               the rest;
    k == 1 puts every layer in the first group. Raises ValueError for an
    unknown mode or option."""
    opt = str(selective_ac_option)
    k = _layer_freq(remat_mode, opt)
    op_every = opt.startswith("op_every_")
    if k == 0:  # selective without a k is selective + "op"
        return [_save_set(remat_mode)] * num_layers
    first = SAVE_SETS["op"] if op_every else FULL
    rest = SAVE_SETS["selective"] if op_every else (
        SAVE_SETS["op"] if remat_mode == "op" else None)
    return [first if i % k == 0 else rest for i in range(num_layers)]


def _save_policy(names: FrozenSet[str]) -> Callable:
    """The selective-checkpoint policy of a save set: MUST_SAVE for K1's op
    when both flash names are in the set and for a matmul whose tag is;
    everything else is recomputed."""
    save_flash = set(FLASH_NAMES) <= names

    def policy(ctx, op, *args, **kwargs):
        if op is attn_ops.FLASH_FWD_OP:
            keep = save_flash
        else:
            keep = op in _MATMULS and _TAG.name in names
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _run_layer(layer: "LlamaDecoderLayer", save: Optional[FrozenSet[str]], *args):
    if save is None:
        return layer(*args)
    if not save:
        return checkpoint(layer, *args, use_reentrant=False)
    context_fn = functools.partial(create_selective_checkpoint_contexts, _save_policy(save))
    return checkpoint(layer, *args, use_reentrant=False, context_fn=context_fn)


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
        inputs_embeds = embed(input_ids, mp.embed_tokens)
    h = inputs_embeds.to(compute_dtype)
    B, T, _ = h.shape
    if position_ids is None:
        position_ids = torch.arange(T, device=h.device).expand(B, T)
    inv_freq = rope_frequencies(config.head_dim, config.rope_theta,
                                rope_scaling=config.rope_scaling, device=h.device)
    attend = _train_attention(segment_ids)
    remat = remat_layers(remat_mode, selective_ac_option, len(mp.layers))
    for layer, save in zip(mp.layers, remat):
        h = _run_layer(layer, save, h, position_ids, inv_freq, attend)
    h = mp.norm(h)
    if return_hidden:
        return h
    return head_logits(h, mp.embed_tokens if config.tie_word_embeddings else model.lm_head,
                       compute_dtype)


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
