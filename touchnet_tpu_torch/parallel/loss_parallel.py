# Copyright (c) 2026 touchnet_tpu authors.
# Fused linear + cross-entropy ("liger analog"), single-device path.
#
# Port of touchnet_tpu/parallel/loss_parallel.py: fused_linear_cross_entropy
# (:266), _rows_sums (:87-128) and _finalize (:236-244). The pack-loss sums
# come from K3 (ops/fused_ce.fused_ce_rows): the [B, T, V] logits never
# exist. The JAX module's lax.scan chunk body is a fallback for shapes its
# Pallas kernel declines; K3 declines none, so it has no counterpart here.
# The vocab-parallel combine (a mesh with tp > 1) and the dp/cp shard_map
# wait for the multi-device slice: a mesh argument raises.

from typing import Optional, Tuple

import torch

from touchnet_tpu_torch.loss.cross_entropy import IGNORE_INDEX
from touchnet_tpu_torch.ops import fused_ce


def _rows_sums(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               sentence_lens: torch.Tensor, ignore_index: int) -> tuple:
    """(sum ce / slen, sum ce, valid tokens, argmax hits) over N rows."""
    lse, tl, _m2, ai = fused_ce.fused_ce_rows(hidden, w, labels)
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack loss from final hidden states [B, T, E] and the lm-head weight
    [V, E], without materialising [B, T, V] logits.

    labels / sentence_lens [B, T]; num_sentence is the global packed-sentence
    count. Returns (loss_per_sample, loss_per_token, accuracy), f32 scalars;
    accuracy takes argmax ties at the smallest index. Both operands are
    cast to compute_dtype, as the JAX function does; their gradients come
    back through the casts to the f32 masters."""
    if mesh is not None:
        raise ValueError(
            "fused_linear_cross_entropy: mesh is not None; the vocab-parallel "
            "and sharded-batch paths are the multi-device slice"
        )
    hidden = hidden.to(compute_dtype)
    head_w = head_w.to(compute_dtype).contiguous()
    n = hidden.shape[0] * hidden.shape[1]
    sums = _rows_sums(hidden.reshape(n, -1).contiguous(), head_w, labels.reshape(n),
                      sentence_lens.reshape(n), ignore_index)
    return _finalize(sums, num_sentence)
