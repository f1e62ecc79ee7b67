# Copyright (c) 2026 touchnet_tpu authors.
# AdamW / Adam hyperparameters, the WSD learning-rate schedule and the
# global gradient norm.
#
# Port of touchnet_tpu/utils/optimizer.py:20-124. The JAX module builds an
# optax transform; here the update itself is ops/fused_adamw.py and this
# module carries what it reads: the hyperparameters (b1 0.9, b2 0.95,
# weight decay 0.1 for AdamW and 0 for Adam, eps from the config) and the
# schedule. The schedule takes a python int or a device tensor, so the
# trainer evaluates it on the optimizer's device-side count without a sync.
# Over sharded gradients (DTensors: FSDP's shards, TP's) the norm is the
# whole gradient's: each tensor's local sum of squares, summed over the mesh
# dimensions the tensor is sharded on (a replicated dimension holds copies),
# then the square root; every rank gets the same value.

import math
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from touchnet_tpu_torch.bin import TrainConfig


def linear_warmup_stable_decay(current_step, warmup_steps: int, stable_steps: int,
                               decay_steps: int, lr_decay_type: str, lr_min: float):
    """Multiplicative LR factor in [lr_min, 1]: linear warmup -> stable ->
    {linear | sqrt | cosine} decay. Returns an f32 tensor on the step's
    device (the CPU for a python int)."""
    warmup_stable = warmup_steps + stable_steps
    step = torch.as_tensor(current_step).to(torch.float32)
    warm = (step + 1.0) / (warmup_steps + 1)
    progress = ((step - warmup_stable) / max(decay_steps, 1)).clamp(0.0, 1.0)
    if lr_decay_type == "linear":
        dec = 1.0 - progress
    elif lr_decay_type == "sqrt":
        dec = 1.0 - torch.sqrt(progress)
    elif lr_decay_type == "cosine":
        dec = 0.5 * (1.0 + torch.cos(math.pi * progress))
    else:
        raise ValueError(f"unknown lr_decay_type {lr_decay_type!r}")
    dec = lr_min + (1 - lr_min) * dec
    one = torch.ones_like(step)
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < warmup_stable, one, dec))


def build_lr_schedule(job_config: TrainConfig) -> Callable:
    """Returns schedule(step) -> absolute LR (an f32 tensor)."""
    training_steps = job_config.lr_scheduler_steps
    warmup_steps = int(job_config.lr_scheduler_warmup_steps)
    if job_config.lr_scheduler_decay_ratio is not None:
        decay_steps = round(training_steps * job_config.lr_scheduler_decay_ratio)
        if warmup_steps + decay_steps > training_steps:
            decay_steps = training_steps - warmup_steps
    else:
        decay_steps = training_steps - warmup_steps
    stable_steps = training_steps - warmup_steps - decay_steps

    def schedule(step):
        return job_config.optimizer_lr * linear_warmup_stable_decay(
            step, warmup_steps, stable_steps, decay_steps,
            job_config.lr_scheduler_decay_type, job_config.lr_scheduler_lr_min,
        )

    return schedule


class OptimizerBundle(NamedTuple):
    """The schedule and the hyperparameters the AdamW step reads."""

    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def build_optimizer(job_config: TrainConfig) -> OptimizerBundle:
    """AdamW or Adam (Adam: no weight decay) under the WSD schedule."""
    name = job_config.optimizer_name
    if name == "AdamW":
        wd = 0.1
    elif name == "Adam":
        wd = 0.0
    else:
        raise NotImplementedError(f"optimizer {name} not added")
    return OptimizerBundle(schedule=build_lr_schedule(job_config), b1=0.9, b2=0.95,
                           eps=job_config.optimizer_eps, weight_decay=wd)


def global_grad_norm(grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in f32 (optax
    global_norm); a None gradient counts as zero. A DTensor gradient counts
    its whole tensor: its shards' squares are summed over the mesh
    dimensions it is sharded on."""
    from torch.distributed.tensor import DTensor

    plain, sharded = [], {}
    for g in grads:
        if g is None:
            continue
        if isinstance(g, DTensor):
            loc = g.to_local().float()
            dims = tuple(i for i, p in enumerate(g.placements) if not p.is_replicate())
            sharded.setdefault((g.device_mesh, dims), []).append(torch.sum(loc * loc))
        else:
            plain.append(torch.sum(g.float() * g.float()))
    total = torch.stack(plain).sum() if plain else None
    for (mesh, dims), sq in sharded.items():
        part = torch.stack(sq).sum()
        for d in dims:
            dist.all_reduce(part, group=mesh.get_group(d))
        total = part if total is None else total + part
    return torch.sqrt(total)
