# The CUDA kernels K1 (flash-attention forward) and K4 (flash-decode)
# against their plain PyTorch versions on the card. These tests need a CUDA
# card and skip elsewhere; chip_smoke.py runs the same comparison at the
# serving path's full shapes.
#
# Tolerances: bf16 kernels are held to the plain version run in f32 on the
# same bf16-rounded inputs (max abs 2e-2, mean abs 2e-3 on out at unit-scale
# inputs: the kernel rounds out to bf16 once; lse 1e-3, f32 throughout).
# f32 kernels are held to 1e-4 with TF32 off (FMA order differs from the
# matmul's).

import numpy as np
import pytest
import torch

from touchnet_tpu_torch.ops.attention import (
    flash_attention,
    flash_prefill,
    packed_attention_reference,
)
from touchnet_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _check(got, want, dtype, valid=None):
    got, want = got.float(), want.float()
    if valid is not None:
        got, want = got[valid], want[valid]
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, err.max().item()
    else:
        assert err.max().item() <= 1e-4, err.max().item()


def _packed_segments(B, T, rng):
    """Three documents and a padding tail (segment 0) per row."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, T - 8), 3, replace=False))
        seg[b, :cuts[0]] = 1
        seg[b, cuts[0]:cuts[1]] = 2
        seg[b, cuts[1]:cuts[2]] = 3
    return seg


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,T,S,H,Hkv,D,causal,packed,q_off,kv_off",
    [
        (2, 300, 300, 8, 2, 64, True, True, 0, 0),
        (1, 257, 257, 4, 4, 128, False, False, 0, 0),
        (2, 100, 356, 10, 2, 64, True, False, 256, 0),
        (1, 64, 200, 6, 3, 128, True, True, 300, 200),
    ],
)
def test_flash_attention_kernel(dev, dtype, B, T, S, H, Hkv, D, causal, packed,
                                q_off, kv_off):
    rng = np.random.default_rng(T + S + H)
    q = _randn(rng, (B, T, H, D), dtype, dev)
    k = _randn(rng, (B, S, Hkv, D), dtype, dev)
    v = _randn(rng, (B, S, Hkv, D), dtype, dev)
    seg = kv_seg = None
    if packed:
        seg_np = _packed_segments(B, max(T, S), rng)
        seg = torch.from_numpy(seg_np[:, :T]).to(dev)
        kv_seg = torch.from_numpy(seg_np[:, :S]).to(dev)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, seg, causal, None, kv_seg, q_off, kv_off)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    want, want_lse = packed_attention_reference(
        q.float(), k.float(), v.float(), seg, causal, None, kv_seg, q_off, kv_off
    )
    # rows with at least one valid key
    rows = q_off + torch.arange(T, device=dev)[:, None]
    cols = kv_off + torch.arange(S, device=dev)[None, :]
    m = torch.ones((B, T, S), dtype=torch.bool, device=dev)
    if causal:
        m = m & (rows >= cols)
    if seg is not None:
        m = m & (seg[:, :, None] == kv_seg[:, None, :])
    valid = m.any(-1)  # [B, T]
    _check(out, want, dtype, valid)
    lse_valid = valid[:, None, :].expand(B, H, T)
    assert (lse[lse_valid] - want_lse[lse_valid]).abs().max().item() <= 1e-3
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_on_cache_halves(dev, dtype):
    """A chunk attends the strided K/V halves of a packed cache layer."""
    rng = np.random.default_rng(5)
    B, Hkv, H, D, S, C, off = 2, 2, 8, 128, 1024, 128, 384
    cache = _randn(rng, (B, Hkv, S, 2 * D), dtype, dev)
    q = _randn(rng, (B, C, H, D), dtype, dev)
    q_seg = torch.ones((B, C), dtype=torch.int32, device=dev)
    kv_seg = (torch.arange(S, device=dev) < off + C).int().expand(B, S)
    out = flash_prefill(q, cache, q_seg, kv_seg, q_offset=off)
    kv = cache.float().transpose(1, 2)
    want, _ = packed_attention_reference(
        q.float(), kv[..., :D], kv[..., D:], q_seg, True, None, kv_seg, off, 0
    )
    _check(out, want, dtype)


def test_flash_attention_rejects_what_it_cannot_run(dev):
    q = torch.zeros((1, 8, 2, 80), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Hkv,G", [(1, 4), (3, 2), (5, 1), (7, 2), (8, 4)])
def test_decode_kernel(dev, dtype, D, Hkv, G):
    rng = np.random.default_rng(Hkv * 10 + G)
    L, B, S = 3, 4, 1536
    q = _randn(rng, (B, Hkv * G, D), dtype, dev)
    kv = _randn(rng, (L, B, Hkv, S, 2 * D), dtype, dev)
    plen = torch.tensor([1000, 300, 1, 1024], dtype=torch.int32, device=dev)
    base, last = 1024, 1100
    n0 = decode_attention.launches
    got = decode_attention(q, kv, plen, base, last, layer_idx=1)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    want = decode_attention_reference(q.float(), kv.float(), plen, base, last, layer_idx=1)
    _check(got, want, dtype)


def test_decode_kernel_skips_dead_columns(dev):
    """NaN in the gap [plen, base) and past `last` never reaches the output;
    a row with no valid column gets 0, not NaN."""
    rng = np.random.default_rng(11)
    B, Hkv, G, D, S = 3, 2, 4, 64, 2048
    q = _randn(rng, (B, Hkv * G, D), torch.bfloat16, dev)
    kv = _randn(rng, (B, Hkv, S, 2 * D), torch.bfloat16, dev)
    plen = torch.tensor([100, 700, 0], dtype=torch.int32, device=dev)
    base, last = 1024, 1040
    clean = decode_attention(q, kv, plen, base, last)
    poisoned = kv.clone()
    poisoned[0, :, 100:1024] = float("nan")
    poisoned[:, :, 1041:] = float("nan")
    got = decode_attention(q, poisoned, plen, base, last)
    torch.testing.assert_close(got, clean, rtol=0, atol=0)
    empty = decode_attention(q, kv, plen, 1, 0)  # row 2: no valid column
    assert torch.isfinite(empty).all() and (empty[2] == 0).all()
