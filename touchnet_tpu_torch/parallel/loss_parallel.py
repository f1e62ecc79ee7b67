# Copyright (c) 2026 touchnet_tpu authors.
# Fused linear + cross-entropy ("liger analog") and the vocab-parallel pack
# loss.
#
# Port of touchnet_tpu/parallel/loss_parallel.py: fused_linear_cross_entropy
# (:266), _rows_sums with its vocab-parallel branch (:87-128), _finalize
# (:236-244) and _sharded_ce (:338-402). The pack-loss sums come from K3
# (ops/fused_ce.fused_ce_rows): the [B, T, V] logits never exist. The JAX
# module's lax.scan chunk body is a fallback for shapes its Pallas kernel
# declines; K3 declines none, so it has no counterpart here.
#
# Under tensor parallelism (tp_group) each rank holds the vocab shard
# [vocab_start, vocab_start + V_local) of the head, and K3 runs on it with
# labels - vocab_start (a label outside the shard gives a label logit of 0).
# combine_vocab_shards then merges the shards' row statistics as JAX's
# shard_map body does with pmax / psum / pmin: the max of m2, gmax = that
# max * ln 2, lse = gmax + log(sum of exp(lse_local - gmax)), the sum of the
# label logits, and the smallest global index among the shards that hold
# the row max (ties to the smallest index). Autograd: every rank computes
# the same loss from the summed statistics, so the sum's backward is the
# identity (a reduction that summed again in its backward would count the
# gradient tp times); and each shard's K3 gives only its part of dh, so the
# hidden state enters through sum_backward, whose backward sums dh over tp.
#
# Over data parallelism (dp_group) each rank holds its own rows. The four
# sums are summed over the data ranks for the values (the logged losses and
# accuracy are the global batch's, as JAX's psum over the data axes), while
# the gradient stays that of this rank's rows over the global sentence
# count: the data-parallel reduction of the gradients (FSDP's
# reduce-scatter, set to sum) adds the ranks' parts.

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from touchnet_tpu_torch.loss.cross_entropy import IGNORE_INDEX
from touchnet_tpu_torch.ops import fused_ce
from touchnet_tpu_torch.parallel.sharding import sum_backward, sum_forward

LN2 = 0.6931471805599453
_INT_MAX = torch.iinfo(torch.int32).max
_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def group_all_reduce(group) -> Callable:
    """The reduction of combine_vocab_shards over a process group: "sum"
    through sum_forward (identity backward), "max" and "min" on tensors
    that carry no gradient."""

    def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        if op == "sum":
            return sum_forward(t, group)
        t = t.detach().clone()
        dist.all_reduce(t, op=_OPS[op], group=group)
        return t

    return all_reduce


def combine_vocab_shards(lse, tl, m2, ai, vocab_start, all_reduce: Callable) -> tuple:
    """(lse, true_logit, argmax) over the whole vocab from one shard's K3
    statistics. ``all_reduce(t, op)`` with op "max", "sum" or "min" reduces
    a tensor over the shards (group_all_reduce for a process group; any
    reduction over a stacked shard axis stands in for it in one process)."""
    m2 = m2.detach()  # statistics only: K3's backward takes no dm2
    gval = all_reduce(m2, "max")
    gmax = gval * LN2
    lse = gmax + torch.log(all_reduce(torch.exp(lse - gmax), "sum"))
    tl = all_reduce(tl, "sum")
    cand = torch.where(m2 == gval, ai + vocab_start, torch.full_like(ai, _INT_MAX))
    return lse, tl, all_reduce(cand, "min")


def _rows_sums(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               sentence_lens: torch.Tensor, ignore_index: int,
               tp_group=None, vocab_start: int = 0) -> tuple:
    """(sum ce / slen, sum ce, valid tokens, argmax hits) over N rows; under
    tp_group, w is this rank's vocab shard starting at vocab_start."""
    if tp_group is None:
        lse, tl, _m2, ai = fused_ce.fused_ce_rows(hidden, w, labels)
    else:
        hidden = sum_backward(hidden, tp_group)
        lse, tl, m2, ai = fused_ce.fused_ce_rows(hidden, w, labels - vocab_start)
        lse, tl, ai = combine_vocab_shards(lse, tl, m2, ai, vocab_start,
                                           group_all_reduce(tp_group))
    valid = labels != ignore_index
    zero = torch.zeros((), dtype=torch.float32, device=lse.device)
    ce = torch.where(valid, lse - tl, zero)
    # mask BEFORE dividing: an ignored position may carry sentence_lens == 0
    # from the loader pad path; 0 * (1/0) would be NaN, not 0
    inv_slen = torch.where(valid, 1.0 / sentence_lens.clamp(min=1).float(), zero)
    return (
        (ce * inv_slen).sum(),
        ce.sum(),
        valid.sum(),
        ((ai == labels) & valid).sum(),
    )


def sum_over(sums: tuple, group) -> tuple:
    """The four sums summed over ``group`` in one f64 all-reduce (the
    counts stay exact), their gradients this rank's own: sum_forward's
    backward is the identity, and the data-parallel reduction of the
    gradients adds the ranks' parts."""
    if group is None:
        return sums
    vals = sum_forward(torch.stack([s.double() for s in sums]), group)
    return tuple(v.to(s.dtype) for s, v in zip(sums, vals))


def _finalize(sums, num_sentence) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    ce_over_slen, ce_total, ntok, hits = sums
    loss_per_sample = ce_over_slen / num_sentence
    ntok_f = ntok.float()
    zero = torch.zeros((), dtype=torch.float32, device=ce_total.device)
    # the loss-per-token guard: no division by an empty or zero-loss batch
    loss_per_token = torch.where((ce_total > 1e-6) & (ntok > 0),
                                 ce_total / ntok_f.clamp(min=1), zero)
    acc = torch.where(ntok > 0, hits.float() / ntok_f.clamp(min=1), zero)
    return loss_per_sample, loss_per_token, acc


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    head_w: torch.Tensor,
    labels: torch.Tensor,
    sentence_lens: torch.Tensor,
    num_sentence,
    *,
    mesh: Optional[object] = None,
    compute_dtype=torch.bfloat16,
    ignore_index: int = IGNORE_INDEX,
    tp_group=None,
    vocab_start: int = 0,
    dp_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack loss from final hidden states [B, T, E] and the lm-head weight
    [V, E] (or, under ``tp_group``, this rank's vocab shard of it, which
    starts at ``vocab_start``), without materialising [B, T, V] logits.

    labels / sentence_lens [B, T] hold this rank's rows; num_sentence is the
    global packed-sentence count. ``dp_group`` sums the four sums over the
    data ranks (the values only; see sum_over). Returns (loss_per_sample,
    loss_per_token, accuracy), f32 scalars; accuracy takes argmax ties at
    the smallest global index. Both operands are cast to compute_dtype, as
    the JAX function does; their gradients come back through the casts.
    JAX's ``mesh`` argument has no counterpart: a mesh raises."""
    if mesh is not None:
        raise ValueError("fused_linear_cross_entropy: the port's multi-device loss takes "
                         "process groups (tp_group and vocab_start, dp_group), not a mesh")
    hidden = hidden.to(compute_dtype)
    head_w = head_w.to(compute_dtype).contiguous()
    n = hidden.shape[0] * hidden.shape[1]
    sums = _rows_sums(hidden.reshape(n, -1).contiguous(), head_w, labels.reshape(n),
                      sentence_lens.reshape(n), ignore_index, tp_group, vocab_start)
    return _finalize(sum_over(sums, dp_group), num_sentence)
