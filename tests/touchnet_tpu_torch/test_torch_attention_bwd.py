# K2's plain version (touchnet_tpu_torch.ops.attention.flash_attention_bwd,
# which CPU tensors take: the kernel's formula from out and lse, here those
# of packed_attention_reference)
# against jax.grad of touchnet_tpu's flash_attention in interpret mode, which
# runs the Pallas backward kernels (dq / dkv, and the fused single pass) on
# the same numpy inputs. f32, atol 5e-4: the JAX kernel test's own bound
# for f32 gradients (tests/touchnet_tpu/ops/test_attention.py:78-96). The
# cotangent is zero on rows with no valid key (the JAX kernel and the plain
# version treat such rows differently; the training path has none).

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.ops import attention as jattn
from touchnet_tpu_torch.ops import attention as attn

ATOL = 5e-4


def _packed(rng, B, T):
    """Three documents then a padding tail (segment 0) in every row."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        c = np.sort(rng.choice(np.arange(1, T - 4), 3, replace=False))
        seg[b, :c[0]], seg[b, c[0]:c[1]], seg[b, c[1]:c[2]] = 1, 2, 3
    return seg


@pytest.mark.parametrize(
    "B,T,S,H,Hkv,D,causal,packed,q_off,kv_off,dynamic",
    [
        (2, 100, 100, 4, 2, 64, True, True, 0, 0, True),  # packed docs + padding, GQA
        (1, 100, 100, 4, 1, 64, True, True, 0, 0, False),  # static-grid kernels, G = 4
        (1, 64, 128, 2, 2, 64, True, False, 64, 0, True),  # q offset
        (1, 64, 96, 4, 2, 64, True, False, 96, 32, True),  # q and kv offsets
        (1, 70, 70, 2, 1, 128, False, False, 0, 0, True),  # non-causal, D = 128
    ],
    ids=["packed_gqa", "static_grid", "q_offset", "kv_offset", "noncausal_d128"],
)
def test_plain_backward_matches_jax_kernels(B, T, S, H, Hkv, D, causal, packed,
                                            q_off, kv_off, dynamic):
    rng = np.random.default_rng(T + S + H + D)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    seg = _packed(rng, B, T) if packed else None

    def jloss(q_, k_, v_):
        out = jattn.flash_attention(
            q_, k_, v_, None if seg is None else jnp.asarray(seg), causal,
            block_q=128, block_kv=128, use_pallas=True, interpret=True,
            q_offset=q_off if (q_off or kv_off) else None,
            kv_offset=kv_off if (q_off or kv_off) else None, dynamic=dynamic,
        )
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tseg = None if seg is None else torch.from_numpy(seg)
    n0 = attn.flash_attention_bwd.launches
    got = attn.flash_attention_bwd(tq, tk, tv, tseg, tseg, None, None, tg, causal,
                                   None, q_off, kv_off)
    assert attn.flash_attention_bwd.launches == n0  # CPU: plain version, no launch
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)

    # the public entry differentiates out (and only out) to the same grads
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    out, lse = attn.flash_attention(qq, kk, vv, tseg, causal, q_offset=q_off,
                                    kv_offset=kv_off)
    assert not lse.requires_grad
    (out * tg).sum().backward()
    for x, b in zip((qq, kk, vv), want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(b), atol=ATOL)
