# The port's AdamW step (ops/fused_adamw.py) and WSD schedule
# (utils/optimizer.py) against the JAX functions. AdamW over 3 steps at
# rtol 2e-6 (the JAX package's bound for its fused step against optax,
# tests/touchnet_tpu/ops/test_fused_adamw.py:56); the schedule at rtol 1e-6
# (one f32 expression either side).

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.ops.fused_adamw import fused_adamw_step as jstep
from touchnet_tpu.utils.optimizer import build_lr_schedule as jschedule
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.ops.fused_adamw import fused_adamw_step
from touchnet_tpu_torch.utils.optimizer import build_lr_schedule, global_grad_norm

SHAPES = [(7, 5), (16,), (3, 4, 2)]
HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _tree(rng, scale=1.0):
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]


def test_adamw_matches_jax_over_three_steps():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp, jm, jv = ([jnp.asarray(x) for x in params],
                  [jnp.zeros(s, jnp.float32) for s in SHAPES],
                  [jnp.zeros(s, jnp.float32) for s in SHAPES])
    jc = jnp.asarray(0, jnp.int32)
    tp = [torch.from_numpy(x.copy()) for x in params]
    tm = [torch.zeros(s) for s in SHAPES]
    tv = [torch.zeros(s) for s in SHAPES]
    tc = torch.zeros((), dtype=torch.int32)
    for step in range(3):
        grads = _tree(rng, 0.5)
        lr = 1e-2 * (step + 1)
        scale = np.float32(0.7)
        jp, jm, jv, jc = jstep([jnp.asarray(g) for g in grads], jp, jm, jv, jc, lr=lr,
                               clip_scale=jnp.asarray(scale), finite=jnp.asarray(True), **HP)
        tc = fused_adamw_step([torch.from_numpy(g) for g in grads], tp, tm, tv, tc, lr=lr,
                              clip_scale=torch.tensor(scale),
                              finite=torch.tensor(True), **HP)
    assert int(tc) == int(jc) == 3
    for a, b in zip(tp + tm + tv, jp + jm + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-9)


def test_adamw_holds_everything_on_a_non_finite_norm():
    rng = np.random.default_rng(1)
    tp = [torch.from_numpy(x) for x in _tree(rng)]
    tm = [torch.from_numpy(x) for x in _tree(rng, 0.1)]
    tv = [torch.from_numpy(np.abs(x)) for x in _tree(rng, 0.1)]
    before = [x.clone() for x in tp + tm + tv]
    grads = [torch.full(s, float("nan")) for s in SHAPES]
    gnorm = global_grad_norm(grads)
    count = torch.tensor(5, dtype=torch.int32)
    new = fused_adamw_step(grads, tp, tm, tv, count, lr=1e-2, finite=torch.isfinite(gnorm),
                           clip_scale=torch.clamp(1.0 / (gnorm + 1e-6), max=1.0), **HP)
    assert int(new) == 5
    for a, b in zip(tp + tm + tv, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adamw_folds_the_clip_scale_into_the_gradient():
    """A clip scale s on g is the step on s * g; global_grad_norm is
    optax's global norm."""
    rng = np.random.default_rng(2)
    params, grads = _tree(rng), _tree(rng, 3.0)
    gnorm = global_grad_norm([torch.from_numpy(g) for g in grads])
    np.testing.assert_allclose(gnorm.item(), np.sqrt(sum((g * g).sum() for g in grads)),
                               rtol=1e-6)
    scale = torch.clamp(1.0 / (gnorm + 1e-6), max=1.0)
    assert scale.item() < 1.0
    outs = []
    for g, s in (([torch.from_numpy(g) for g in grads], scale),
                 ([torch.from_numpy(g) * scale for g in grads], None)):
        tp = [torch.from_numpy(x.copy()) for x in params]
        fused_adamw_step(g, tp, [torch.zeros(x) for x in SHAPES],
                         [torch.zeros(x) for x in SHAPES],
                         torch.zeros((), dtype=torch.int32), lr=1e-2, clip_scale=s, **HP)
        outs.append(tp)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("decay_type", ["linear", "sqrt", "cosine"])
def test_wsd_schedule_matches_jax_at_its_edges(decay_type):
    kw = dict(optimizer_lr=1e-3, lr_scheduler_steps=100, lr_scheduler_warmup_steps=10,
              lr_scheduler_decay_ratio=0.3, lr_scheduler_decay_type=decay_type,
              lr_scheduler_lr_min=0.1)
    ours, theirs = build_lr_schedule(TrainConfig(**kw)), jschedule(JTrainConfig(**kw))
    # warmup 0-9, stable 10-69, decay 70-99, past the end
    for step in (0, 1, 9, 10, 11, 69, 70, 71, 85, 99, 100, 120):
        np.testing.assert_allclose(float(ours(step)), float(theirs(step)), rtol=1e-6,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(ours(torch.tensor(step, dtype=torch.int32))),
                                   float(theirs(step)), rtol=1e-6)
