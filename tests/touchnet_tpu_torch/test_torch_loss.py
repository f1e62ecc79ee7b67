# The port's pack loss (loss/cross_entropy.py) and single-device fused
# linear + cross-entropy (parallel/loss_parallel.py, K3's plain version on
# the CPU) against the JAX functions on the same numpy inputs. f32; loss,
# accuracy and gradients at rtol 1e-5 (the JAX package's own bound,
# tests/touchnet_tpu/parallel/test_loss_parallel.py:37-63), with atol 1e-7
# on gradients for entries near zero.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.loss import cross_entropy as jloss
from touchnet_tpu.parallel import loss_parallel as jlp
from touchnet_tpu_torch.loss import cross_entropy as tloss
from touchnet_tpu_torch.parallel import loss_parallel as tlp

B, T, E, V = 2, 24, 32, 50


def _batch(seed, zero_lens=False):
    """Two packed rows: documents with per-position sentence lengths, an
    ignored tail. zero_lens: the tail carries sentence_lens 0 (the loader's
    pad path), which must not turn the loss into NaN."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    slen = np.ones((B, T), np.int32)
    slen[:, :10], slen[:, 10:20] = 10, 10
    labels[:, 20:] = -100
    labels[0, 5] = -100
    if zero_lens:
        slen[:, 20:] = 0
    hidden = rng.standard_normal((B, T, E)).astype(np.float32)
    w = (0.3 * rng.standard_normal((V, E))).astype(np.float32)
    return hidden, w, labels, slen, 4.0


def test_cross_entropy_and_accuracy_match_jax():
    hidden, w, labels, slen, ns = _batch(0)
    logits = np.einsum("bte,ve->btv", hidden, w).astype(np.float32)
    want = jloss.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(slen), jnp.asarray(ns))
    got = tloss.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(slen), ns)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w_), rtol=1e-5)
    np.testing.assert_allclose(
        tloss.accuracy(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(jloss.accuracy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    np.testing.assert_allclose(
        tloss.per_position_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(labels)).numpy(),
        np.asarray(jloss.per_position_cross_entropy(jnp.asarray(logits),
                                                    jnp.asarray(labels))), rtol=1e-5)


@pytest.mark.parametrize("zero_lens", [False, True], ids=["lens", "zero_lens_on_ignored"])
def test_fused_linear_cross_entropy_matches_jax(zero_lens):
    hidden, w, labels, slen, ns = _batch(1, zero_lens)

    def f(h_, w_):
        out = jlp.fused_linear_cross_entropy(
            h_, w_, jnp.asarray(labels), jnp.asarray(slen), jnp.asarray(ns),
            compute_dtype=jnp.float32)
        return out[0], out

    (_, want), (jdh, jdw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tlp.fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                         torch.from_numpy(slen), ns,
                                         compute_dtype=torch.float32)
    got[0].backward()
    for g, w_ in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.item(), float(w_), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-7)
    assert torch.isfinite(th.grad).all() and torch.isfinite(tw.grad).all()


def test_fused_linear_cross_entropy_rejects_a_mesh():
    hidden, w, labels, slen, ns = _batch(2)
    with pytest.raises(ValueError, match="multi-device"):
        tlp.fused_linear_cross_entropy(torch.from_numpy(hidden), torch.from_numpy(w),
                                       torch.from_numpy(labels), torch.from_numpy(slen),
                                       ns, mesh=object())
