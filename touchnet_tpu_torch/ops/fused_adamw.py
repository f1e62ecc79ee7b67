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
#
# streamed_adamw_step is the same chain with the moments in pinned host
# memory (training_enable_cpu_offload; JAX puts the optimizer state in
# pinned_host memory, touchnet_tpu/bin/train.py:457-470): StreamedMoments
# streams them through two device slots on a copy stream, so the card holds
# a few slices of the moments instead of all of them.

from typing import List, Optional

import torch


class _Hyper:
    """The step's constants as f32 device scalars, as the JAX function's
    ctrl vector, so the arithmetic rounds where the reference's does."""

    def __init__(self, count, lr, b1, b2, eps, weight_decay, clip_scale, finite):
        device = count.device
        f32 = dict(dtype=torch.float32, device=device)
        self.b1, self.b2, self.eps, self.wd = (
            torch.tensor(x, **f32) for x in (b1, b2, eps, weight_decay))
        cnt1 = (count + 1).to(torch.float32)
        self.c1 = 1.0 / (1.0 - self.b1 ** cnt1)
        self.c2 = 1.0 / (1.0 - self.b2 ** cnt1)
        self.scale = torch.ones((), **f32) if clip_scale is None else clip_scale.to(**f32)
        self.keep = torch.ones((), dtype=torch.bool, device=device) if finite is None else finite
        self.lr = torch.as_tensor(lr).to(**f32)

    def update(self, g, p, m, v) -> None:
        """One tensor's update, in place on p, m and v."""
        g = g.float() * self.scale
        m_new = self.b1 * m + (1.0 - self.b1) * g
        v_new = self.b2 * v + (1.0 - self.b2) * (g * g)
        upd = (m_new * self.c1) / (torch.sqrt(v_new * self.c2) + self.eps) + self.wd * p
        p_new = p - self.lr * upd
        p.copy_(torch.where(self.keep, p_new, p))
        m.copy_(torch.where(self.keep, m_new, m))
        v.copy_(torch.where(self.keep, v_new, v))


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
    A gradient of another dtype (bf16 under bf16 reduction) is upcast to f32
    here, tensor by tensor. Returns the new count (count + 1, or count when
    held)."""
    hp = _Hyper(count, lr, b1, b2, eps, weight_decay, clip_scale, finite)
    for g, p, m, v in zip(grads, params, mu, nu):
        hp.update(g, p, m, v)
    return torch.where(hp.keep, count + 1, count).to(count.dtype)


def stream_pieces(sizes: List[int], chunk: int):
    """(tensor index, begin, end) of the streamed step's pieces: each tensor
    of ``sizes`` elements in slices of at most ``chunk``."""
    for i, n in enumerate(sizes):
        for a in range(0, n, chunk):
            yield i, a, min(a + chunk, n)


class StreamedMoments:
    """AdamW moments held in pinned host memory (CPU offload): the step
    streams them through the card piece by piece (a tensor, or a slice of
    STREAM_CHUNK elements of a large one) on a copy stream of its own, with
    two device slots: the host-to-device copy of the next piece's mu and nu
    runs under the current piece's update, and the device-to-host copy of
    the updated piece after it. ``mu``/``nu`` are the host tensors (what
    checkpoints save and load); ``pinned_bytes`` their size."""

    STREAM_CHUNK = 1 << 25  # elements per piece: 128 MiB of f32 a moment

    def __init__(self, params: List[torch.Tensor]):
        self.mu = [torch.zeros(p.shape, dtype=p.dtype, pin_memory=True) for p in params]
        self.nu = [torch.zeros(p.shape, dtype=p.dtype, pin_memory=True) for p in params]
        self.pinned_bytes = sum(2 * m.numel() * m.element_size() for m in self.mu)
        self.device = params[0].device
        self.stream = torch.cuda.Stream(self.device)
        self.done: Optional[torch.cuda.Event] = None
        size = min(max(p.numel() for p in params), self.STREAM_CHUNK)
        self.slots = [(torch.empty(size, dtype=params[0].dtype, device=self.device),
                       torch.empty(size, dtype=params[0].dtype, device=self.device))
                      for _ in range(2)]

    def synchronize(self) -> None:
        """Block the host until the last step's moments are back in host
        memory (before a checkpoint reads them)."""
        if self.done is not None:
            self.done.synchronize()


def streamed_adamw_step(
    grads: List[torch.Tensor],
    params: List[torch.Tensor],
    moments: StreamedMoments,
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
    """fused_adamw_step with the moments in host memory (StreamedMoments):
    the same per-tensor chain on each piece, so params, moments and count
    equal the resident step's bit for bit (every op is elementwise). The
    host issues everything and never waits; count and the schedule stay on
    the card. Returns the new count."""
    hp = _Hyper(count, lr, b1, b2, eps, weight_decay, clip_scale, finite)
    compute = torch.cuda.current_stream(moments.device)
    copy = moments.stream
    pieces = list(stream_pieces([p.numel() for p in params], moments.STREAM_CHUNK))
    loaded = [None] * len(pieces)

    def load(k):
        i, a, b = pieces[k]
        sm, sv = moments.slots[k % 2]
        with torch.cuda.stream(copy):  # after the slot's last D2H: same stream
            sm[:b - a].copy_(moments.mu[i].view(-1)[a:b], non_blocking=True)
            sv[:b - a].copy_(moments.nu[i].view(-1)[a:b], non_blocking=True)
            loaded[k] = torch.cuda.Event()
            loaded[k].record(copy)

    for k in range(min(2, len(pieces))):
        load(k)
    for k, (i, a, b) in enumerate(pieces):
        sm, sv = moments.slots[k % 2]
        m, v = sm[:b - a], sv[:b - a]
        compute.wait_event(loaded[k])
        hp.update(grads[i].view(-1)[a:b], params[i].view(-1)[a:b], m, v)
        updated = torch.cuda.Event()
        updated.record(compute)
        with torch.cuda.stream(copy):
            copy.wait_event(updated)
            moments.mu[i].view(-1)[a:b].copy_(m, non_blocking=True)
            moments.nu[i].view(-1)[a:b].copy_(v, non_blocking=True)
        if k + 2 < len(pieces):
            load(k + 2)
    moments.done = torch.cuda.Event()
    moments.done.record(copy)
    return torch.where(hp.keep, count + 1, count).to(count.dtype)
