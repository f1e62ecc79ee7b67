# Copyright (c) 2026 touchnet_tpu authors.
# Packed-sequence cross-entropy ("pack loss").
#
# Port of touchnet_tpu/loss/cross_entropy.py:25-77. Two reductions from one
# per-position CE:
#   loss_per_sample (the training objective): sum over positions of
#     ce / sentence_lens, summed over the batch, divided by the GLOBAL
#     num_sentence;
#   loss_per_token (logging): sum(ce) / num_valid_tokens.
# Computed in f32 from (possibly bf16) logits with a stable logsumexp. With
# the liger flag the trainer uses parallel/loss_parallel.py's fused
# linear + CE instead, which never materialises the [B, T, V] logits.

from typing import Tuple

import torch

IGNORE_INDEX = -100


def per_position_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                               ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """CE per position, 0 at ignored positions. logits [..., V], labels [...]."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, lse - true_logit, torch.zeros_like(lse))


def cross_entropy_loss(
    pred: torch.Tensor,
    labels: torch.Tensor,
    sentence_lens: torch.Tensor,
    num_sentence,
    ignore_index: int = IGNORE_INDEX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack loss: (loss_per_sample, loss_per_token) from logits [B, L, V],
    labels and sentence_lens [B, L] and the global sentence count."""
    ce = per_position_cross_entropy(pred, labels, ignore_index)  # [B, L]
    num_tokens = (labels != ignore_index).sum()
    total = ce.sum()
    loss_per_token = torch.where((total > 1e-6) & (num_tokens > 0),
                                 total / num_tokens, torch.zeros_like(total))
    per_sample = (ce / sentence_lens.float()).sum(dim=-1)  # [B]
    loss_per_sample = per_sample.sum() / num_sentence
    return loss_per_sample, loss_per_token


def accuracy(pred: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Token accuracy over non-ignored positions (argmax ties go to the
    smallest index)."""
    valid = labels != ignore_index
    hits = (pred.argmax(dim=-1) == labels) & valid
    num = valid.sum()
    return torch.where(num > 0, hits.sum() / num.clamp(min=1),
                       torch.zeros((), device=pred.device))
