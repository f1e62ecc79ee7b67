# K1's plain version (touchnet_tpu_torch.ops.attention, which CPU tensors
# take) against touchnet_tpu's Pallas flash forward in interpret mode and
# its packed_attention_reference, on the same numpy inputs. f32, out atol
# 2e-5 on rows with at least one valid key (the JAX kernel averages a
# fully masked row's values; the tests do not pin that row); lse against a
# float64 logsumexp of the masked scores.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.ops import attention as jattn
from touchnet_tpu_torch.ops import attention as attn

ATOL = 2e-5


def _inputs(seed, B, T, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return rng, q, k, v


def _mask(B, T, S, causal, seg, kv_seg, q_off, kv_off):
    m = np.ones((B, T, S), bool)
    if causal:
        m &= (q_off + np.arange(T))[:, None] >= (kv_off + np.arange(S))[None, :]
    if seg is not None:
        m &= seg[:, :, None] == kv_seg[:, None, :]
    return m


def _lse64(q, k, mask, scale):
    H, Hkv = q.shape[2], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=2)
    s = np.einsum("bthd,bshd->bhts", q.astype(np.float64), kk) * scale
    s = np.where(mask[:, None], s, -np.inf)
    mx = s.max(-1, keepdims=True)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    return (np.log(np.exp(s - mx).sum(-1)) + mx[..., 0])  # [B, H, T]


def _packed(rng, B, T):
    """Three documents then a padding tail (segment 0) in every row."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        c = np.sort(rng.choice(np.arange(1, T - 4), 3, replace=False))
        seg[b, :c[0]], seg[b, c[0]:c[1]], seg[b, c[1]:c[2]] = 1, 2, 3
    return seg


@pytest.mark.parametrize(
    "B,T,S,H,Hkv,D,causal,packed,q_off",
    [
        (2, 150, 150, 4, 2, 64, True, True, 0),  # packed, causal, GQA, unaligned T
        (1, 130, 130, 2, 2, 128, False, False, 0),  # non-causal
        (1, 64, 128, 4, 1, 64, True, False, 64),  # q_offset, G = 4
    ],
    ids=["packed_causal_gqa", "noncausal", "q_offset"],
)
def test_plain_version_matches_jax_kernel(B, T, S, H, Hkv, D, causal, packed, q_off):
    rng, q, k, v = _inputs(T + S, B, T, S, H, Hkv, D)
    seg = _packed(rng, B, T) if packed else None
    scale = 1.0 / np.sqrt(D)
    n0 = attn.flash_attention.launches
    out, lse = attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if seg is None else torch.from_numpy(seg), causal,
        q_offset=q_off,
    )
    assert attn.flash_attention.launches == n0  # CPU: plain version, no launch
    j_kernel = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if seg is None else jnp.asarray(seg), causal,
        block_q=128, block_kv=128, use_pallas=True, interpret=True,
        q_offset=q_off if q_off else None,
    )
    j_ref = jattn.packed_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if seg is None else jnp.asarray(seg), causal, q_offset=q_off,
    )
    mask = _mask(B, T, S, causal, seg, seg, q_off, 0)
    valid = mask.any(-1)  # [B, T]
    got = out.numpy()
    np.testing.assert_allclose(got[valid], np.asarray(j_kernel)[valid], atol=ATOL)
    np.testing.assert_allclose(got[valid], np.asarray(j_ref)[valid], atol=ATOL)
    lse_valid = np.broadcast_to(valid[:, None, :], lse.shape)
    np.testing.assert_allclose(
        lse.numpy()[lse_valid], _lse64(q, k, mask, scale)[lse_valid], atol=1e-4
    )


def test_chunked_prefill_matches_jax_grouped_entry():
    """A 64-row chunk at offset 128 over the packed cache halves, against
    flash_prefill_grouped in interpret mode (the JAX chunked-prefill call,
    inference_llama.py:318)."""
    rng = np.random.default_rng(4)
    B, Hkv, G, D, S, C, off = 2, 2, 2, 64, 256, 64, 128
    cache = rng.standard_normal((B, Hkv, S, 2 * D)).astype(np.float32)
    q = rng.standard_normal((B, C, Hkv * G, D)).astype(np.float32)
    q_seg = np.ones((B, C), np.int32)
    kv_seg = np.broadcast_to((np.arange(S) < off + C).astype(np.int32), (B, S)).copy()
    got = attn.flash_prefill(
        torch.from_numpy(q), torch.from_numpy(cache), torch.from_numpy(q_seg),
        torch.from_numpy(kv_seg), q_offset=off,
    )
    jc = jnp.asarray(cache)
    want = jattn._ungroup_q(jattn.flash_prefill_grouped(
        jattn._regroup_q(jnp.asarray(q), Hkv), jc[..., :D], jc[..., D:],
        jnp.asarray(q_seg), jnp.asarray(kv_seg), q_offset=off,
        block_q=64, block_kv=128, use_pallas=True, interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_prefill_passes_cache_views(monkeypatch):
    """The chunked entry hands the kernel views of the cache halves: no copy
    of the layer's cache per chunk."""
    seen = {}

    def spy(q, k, v, *args):
        seen.update(k=k, v=v)
        return torch.zeros_like(q), None

    monkeypatch.setattr(attn, "flash_attention", spy)
    cache = torch.randn(2, 3, 40, 2 * 64)
    q = torch.randn(2, 8, 6, 64)
    attn.flash_prefill(q, cache, torch.ones(2, 8, dtype=torch.int32),
                       torch.ones(2, 40, dtype=torch.int32), q_offset=0)
    k, v = seen["k"], seen["v"]
    assert k.shape == v.shape == (2, 40, 3, 64)
    assert k.data_ptr() == cache.data_ptr()
    assert v.data_ptr() == cache.data_ptr() + 64 * cache.element_size()
    assert not k.is_contiguous() and k.stride(-1) == 1
    torch.testing.assert_close(k, cache.transpose(1, 2)[..., :64], rtol=0, atol=0)


def test_fully_masked_row_is_finite_in_the_plain_version():
    q = torch.randn(1, 4, 2, 64)
    seg = torch.tensor([[1, 1, 2, 2]], dtype=torch.int32)
    kv_seg = torch.tensor([[1, 1, 1, 1]], dtype=torch.int32)
    out, lse = attn.flash_attention(q, q, q, seg, False, kv_segment_ids=kv_seg)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
