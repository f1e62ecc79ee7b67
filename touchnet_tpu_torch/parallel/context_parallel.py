# Copyright (c) 2026 touchnet_tpu authors.
# Context parallelism: the attention of one rank's sequence slice against
# the whole sequence of its cp group.
#
# Port of touchnet_tpu/parallel/context_parallel.py: cp_local_attn
# (:29-70), the body JAX runs in every shard_map with an active "cp" axis.
# Each rank of a cp group holds the [B, T/cp, H/tp, D] slice of q, k and v
# at positions [r * T/cp, (r + 1) * T/cp) (bin/train.py splits every
# per-position batch array so; position ids travel with their tokens, so
# RoPE needs nothing). The two rotate methods of
# --training_context_parallel_rotate_method:
#   allgather  k, v and the kv segment ids are all-gathered over cp (an
#              autograd function whose backward reduce-scatters dk and dv,
#              JAX's all_gather transpose), then one K1 call with
#              q_offset = r * T/cp against the whole sequence;
#   alltoall   the ring (ops/ring_attention.py): K1 and K2 once per ring
#              step with (q_offset, kv_offset).
# Both go through ops.attention's wrappers: K1 and K2 on CUDA tensors, their
# plain versions on CPU tensors. The reference's alltoall branch runs its
# dense ring unless use_pallas is set (context_parallel.py:50-55); the port
# has no such switch. JAX's grouped layout (_make_grouped_attn_fn) is
# TPU-only and not ported.

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from touchnet_tpu_torch.ops import attention as attn_ops
from touchnet_tpu_torch.ops import ring_attention

ROTATE_METHODS = ("allgather", "alltoall")


class _GatherSeq(torch.autograd.Function):
    """x [B, T/cp, ...] -> [B, T, ...], the cp ranks' slices in rank order;
    the backward sums the gradient over cp and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        B, T = g.shape[:2]
        parts = g.reshape(B, n, T // n, *g.shape[2:]).transpose(0, 1).reshape(
            n * B, T // n, *g.shape[2:])
        out = torch.empty((B, T // n, *g.shape[2:]), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, parts, group=ctx.group)
        return out, None


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    B, Tl = x.shape[:2]
    buf = torch.empty((n * B, Tl, *x.shape[2:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(buf, x.contiguous(), group=group)
    return buf.view(n, B, Tl, *x.shape[2:]).transpose(0, 1).reshape(B, n * Tl, *x.shape[2:])


def cp_local_attn(q, k, v, seg, *, cp: int, rotate_method: str = "allgather", group=None):
    """Causal packed attention of this rank's slice q [B, T/cp, H, D], k, v
    [B, T/cp, Hkv, D], seg [B, T/cp] (None: one segment) against the cp
    group's whole sequence; returns out [B, T/cp, H, D]. cp 1 is the plain
    K1 call. An unknown rotate method raises a ValueError naming its flag."""
    if rotate_method not in ROTATE_METHODS:
        raise ValueError(f"training_context_parallel_rotate_method={rotate_method!r}: one of "
                         f"{ROTATE_METHODS}")
    if cp == 1:
        return attn_ops.flash_attention(q, k, v, seg)[0]
    if dist.get_world_size(group) != cp:
        raise ValueError(f"cp_local_attn: cp={cp}, the group has {dist.get_world_size(group)} "
                         "ranks")
    if seg is None:
        seg = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    seg = seg.to(torch.int32).contiguous()
    if rotate_method == "alltoall":
        return ring_attention.RingAttention.apply(q, k, v, seg, group)[0]
    k_all = _GatherSeq.apply(k, group)
    v_all = _GatherSeq.apply(v, group)
    seg_all = _gather_seq(seg, group)
    q_offset = dist.get_rank(group) * q.shape[1]
    return attn_ops.flash_attention(q, k_all, v_all, seg, True, None, seg_all, q_offset, 0)[0]


@dataclass
class ContextParallel:
    """What a model's training forward needs of its cp group: the group
    and the rotate method (bin/train.py gives it to the model, apply_cp)."""
    group: object
    rotate_method: str = "allgather"

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @torch.compiler.disable
    def attend(self, q, k, v, seg):
        """cp_local_attn over the group. A compiled block's graph ends here
        (--training_compile): the ring's point-to-point through host buffers
        cannot be traced, and the allgather runs eagerly alike."""
        return cp_local_attn(q, k, v, seg, cp=self.size, rotate_method=self.rotate_method,
                             group=self.group)


def apply_cp(model: torch.nn.Module, group, rotate_method: str) -> None:
    """Every Llama stack in ``model`` (llama's, touch_audio's language model)
    attends over ``group`` from now on (modeling_llama.forward reads it)."""
    from touchnet_tpu_torch.models.llama.modeling_llama import LlamaModel

    for mod in model.modules():
        if isinstance(mod, LlamaModel):
            mod._cp = ContextParallel(group, rotate_method)


def context_parallel(module: torch.nn.Module):
    """The ContextParallel a Llama stack attends over (None: no cp)."""
    return getattr(module, "_cp", None)


def split_sequence(x: np.ndarray, cp: int, rank: int, axis: int = 1) -> np.ndarray:
    """This cp rank's slice [r*T/cp, (r+1)*T/cp) of a host array's sequence
    ``axis`` (1; 2 for gradient accumulation's [G, B, ...] stacks), as JAX's
    batch_specs and microbatch_specs shard every per-position array on cp;
    an array without that axis stays whole. A T that cp does not divide
    raises a ValueError naming training_context_parallel_degree (JAX's
    _shrink_spec_to_shape would leave such an array unsplit)."""
    if cp == 1 or x.ndim <= axis:
        return x
    T = x.shape[axis]
    if T % cp:
        raise ValueError(f"training_context_parallel_degree={cp} does not divide the batch's "
                         f"sequence length {T}")
    n = T // cp
    return np.ascontiguousarray(x[(slice(None),) * axis + (slice(rank * n, (rank + 1) * n),)])
