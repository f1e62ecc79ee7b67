# Copyright (c) 2026 touchnet_tpu authors.
# One AdamW step over lists of tensors: gradient clip, update and the
# non-finite hold in one pass per tensor.
#
# Port of touchnet_tpu/ops/fused_adamw.py:47-120. It is not a Pallas kernel
# there either (XLA fuses the elementwise update); here it is plain PyTorch,
# a short chain of elementwise ops per tensor, updating params and moments
# in place. Numerics follow optax.adamw as the JAX function does: bias
# correction on count + 1, eps outside the square root, decoupled weight
# decay on every tensor inside the lr scale, the clip scale folded into the
# gradient. When the gradient norm is not finite, params, both moments and
# the count are held: the hold is a torch.where on a device bool, so the
# step never waits for the device (no .item()).

from typing import List, Optional

import torch


def fused_adamw_step(
    grads: List[torch.Tensor],
    params: List[torch.Tensor],
    mu: List[torch.Tensor],
    nu: List[torch.Tensor],
    count: torch.Tensor,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_scale: Optional[torch.Tensor] = None,
    finite: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """In place over the lists:

        g <- g * clip_scale
        mu <- b1 mu + (1-b1) g ;  nu <- b2 nu + (1-b2) g^2
        p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd p)
        (all three held when finite is False)

    count: int32 scalar tensor, steps completed so far (bias correction uses
    count + 1). lr: a scalar, or a 0-d f32 tensor on the params' device.
    Returns the new count (count + 1, or count when held)."""
    device = count.device
    f32 = dict(dtype=torch.float32, device=device)
    # every constant an f32 scalar, as the JAX function's ctrl vector, so the
    # arithmetic rounds where the reference's does
    b1, b2, eps, wd = (torch.tensor(x, **f32) for x in (b1, b2, eps, weight_decay))
    cnt1 = (count + 1).to(torch.float32)
    c1 = 1.0 / (1.0 - b1 ** cnt1)
    c2 = 1.0 / (1.0 - b2 ** cnt1)
    scale = torch.ones((), **f32) if clip_scale is None else clip_scale.to(**f32)
    keep = torch.ones((), dtype=torch.bool, device=device) if finite is None else finite
    lr = torch.as_tensor(lr).to(**f32)
    for g, p, m, v in zip(grads, params, mu, nu):
        g = g.float() * scale
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * (g * g)
        upd = (m_new * c1) / (torch.sqrt(v_new * c2) + eps) + wd * p
        p_new = p - lr * upd
        p.copy_(torch.where(keep, p_new, p))
        m.copy_(torch.where(keep, m_new, m))
        v.copy_(torch.where(keep, v_new, v))
    return torch.where(keep, count + 1, count).to(count.dtype)
