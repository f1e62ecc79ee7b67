# The CUDA kernels K1 (flash-attention forward), K2 (its backward), K3
# (fused lm-head + cross-entropy, forward and backward) and K4 (flash-decode)
# against their plain PyTorch versions on the card. These tests need a CUDA
# card and skip elsewhere; chip_smoke.py runs the same comparison at the
# serving and training paths' full shapes. bf16 and f16 K1 and K2 run on
# tensor cores (one kernel body for both types) and f32 on FMA kernels;
# ATTENTION_CASES cover both routes at tile edges, GQA groups, masks and
# offsets.
#
# K4's bf16 and f16 kernel streams the cache through a cp.async ring into
# mma.sync; K3's bf16 and f16 forward and backward run on a TMA + wgmma
# mainloop where E is a
# multiple of 8 (the cases below cover both of its sides and the kept wmma
# tiles); the forward's blocks walk vocab splits of several tiles, which
# the tests force at small shapes.
#
# Tolerances: bf16 kernels are held to the plain version run in f32 on the
# same bf16-rounded inputs (max abs 2e-2, mean abs 2e-3 on out at unit-scale
# inputs: the kernel rounds out to bf16 once; lse 1e-3, f32 throughout).
# f16 kernels are held to the same limits (f16 keeps 3 more mantissa bits
# than bf16, so its rounding is 8x smaller: no limit is looser for f16).
# f32 kernels are held to 1e-4 with TF32 off (FMA order differs from the
# matmul's). Gradients (K2, K3 backward) are held relative to the largest
# reference value: f32 1e-4 (summation order only), bf16 1e-2 (the kernel
# rounds each output to bf16 once, 2^-9 = 2e-3 of the value, and K2's delta
# reads K1's bf16 out where the plain version recomputes it in f32); f16
# the same 1e-2.

import numpy as np
import pytest
import torch

from touchnet_tpu_torch.ops import fused_ce
from touchnet_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_prefill,
    packed_attention_reference,
)
from touchnet_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)

pytestmark = pytest.mark.cuda
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


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
    if dtype != torch.float32:
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


def _segments_of(kind, B, T, rng):
    """None (one segment), "packed" (three documents + a padding tail),
    "boundary" (documents that end inside the 64/128-row diagonal tiles),
    "long" (two long documents, so most tiles are wholly live) or
    "rightpad" (dynamic_batch's rows: segment 1 on a row's tokens, 0 on its
    right padding, which attends itself; the first row full)."""
    if kind is None:
        return None
    if kind == "packed":
        return _packed_segments(B, T, rng)
    if kind == "rightpad":
        seg = np.zeros((B, T), np.int32)
        for b, n in enumerate([T, *rng.integers(T // 3, T, B - 1)]):
            seg[b, :n] = 1
        return seg
    seg = np.zeros((B, T), np.int32)
    cuts = [0, 100, 141, T - 5] if kind == "boundary" else [0, T // 2 + 3, T]
    for i, (a, e) in enumerate(zip(cuts[:-1], cuts[1:])):
        seg[:, a:e] = i + 1
    return seg


# bf16 K1/K2 run on tensor cores in 64-row / 64-column tiles: the cases
# below cover ragged tile edges, GQA groups 1-8 and an odd one (G 3), D 128,
# offsets, document boundaries inside the causal diagonal tile and wholly
# live tiles (the unmasked fast path)
ATTENTION_CASES = [
    (2, 300, 300, 8, 2, 64, True, "packed", 0, 0),
    (1, 257, 257, 4, 4, 128, False, None, 0, 0),
    (2, 100, 356, 10, 2, 64, True, None, 256, 0),
    (1, 64, 200, 6, 3, 128, True, "packed", 300, 200),
    (1, 200, 200, 4, 4, 64, True, "packed", 0, 0),
    (2, 333, 333, 16, 4, 64, True, "packed", 0, 0),
    (1, 190, 190, 16, 2, 64, True, "boundary", 0, 0),
    (2, 150, 150, 6, 2, 64, True, "packed", 0, 0),
    (1, 100, 100, 6, 3, 128, False, None, 0, 0),
    (1, 77, 300, 8, 2, 128, True, None, 223, 0),
    (1, 520, 520, 8, 2, 64, True, "long", 0, 0),
    (1, 400, 400, 32, 8, 64, True, None, 0, 0),
    # the qwen2_audio ASR path: (f) the whisper tower's causal MHA at D64
    # over 1500 frames (23 tiles and a 28-row tail) and over 1750 (a 35 s
    # utterance: the tiled position table); (g) Qwen2-Audio-7B's prefill,
    # 28 query heads over 4 kv heads (G 7: 9 positions a 64-row block, one
    # dead row), D128, and G 7 over packed documents
    (2, 1500, 1500, 20, 20, 64, True, None, 0, 0),
    (1, 1750, 1750, 20, 20, 64, True, None, 0, 0),
    (3, 401, 401, 28, 4, 128, True, None, 0, 0),
    (2, 300, 300, 7, 1, 128, True, "packed", 0, 0),
    # the kimi_audio ASR path (f32 in the recipe): (i) the whisper tower,
    # non-causal, 1500 frames at D64 G1; (j) Kimi-Audio-7B's prefill of one
    # utterance, B1 G7 D128 causal
    (1, 1500, 1500, 20, 20, 64, False, None, 0, 0),
    (1, 390, 390, 28, 4, 128, True, None, 0, 0),
    # qwen2_audio's SFT (dynamic_batch): (m) Qwen2-Audio-7B's text layers on
    # right-padded rows, G 7 D128 causal, segment 1 on tokens and 0 on the
    # padding; the tower's training shape (l) is (f) above, through K2 too
    (3, 401, 401, 28, 4, 128, True, "rightpad", 0, 0),
    (2, 130, 130, 7, 1, 128, True, "rightpad", 0, 0),
    # kimi_audio's SFT: (n) the tower's training shape, several rows of 1500
    # frames, H20/20 D64 non-causal with no segment ids, so no causal mask
    # trims the ragged last block (1500 = 23 x 64 + 28); the text layers are
    # (m)'s shape
    (3, 1500, 1500, 20, 20, 64, False, None, 0, 0),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal,segs,q_off,kv_off", ATTENTION_CASES)
def test_flash_attention_kernel(dev, dtype, B, T, S, H, Hkv, D, causal, segs,
                                q_off, kv_off):
    rng = np.random.default_rng(T + S + H)
    q = _randn(rng, (B, T, H, D), dtype, dev)
    k = _randn(rng, (B, S, Hkv, D), dtype, dev)
    v = _randn(rng, (B, S, Hkv, D), dtype, dev)
    seg = kv_seg = None
    seg_np = _segments_of(segs, B, max(T, S), rng)
    if seg_np is not None:
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,S,C,off", [(128, 1024, 128, 384), (64, 700, 77, 301)])
def test_flash_prefill_on_cache_halves(dev, dtype, D, S, C, off):
    """A chunk attends the strided K/V halves of a packed cache layer, also
    at a length and offset that are not tile multiples."""
    rng = np.random.default_rng(5)
    B, Hkv, H = 2, 2, 8
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
    # f16 is a kernel dtype (it launches); float64 is not and raises
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float16)
    n0 = flash_attention.launches
    out, _ = flash_attention(q, q, q)
    assert flash_attention.launches == n0 + 1 and out.dtype == torch.float16
    q = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    # bf16 and f16 rows move by 16-byte cp.async: a K view 2 bytes in, with
    # a row stride of 65 elements, raises (no fallback)
    for dtype in (torch.bfloat16, torch.float16):
        q = torch.zeros((1, 64, 4, 64), device=dev, dtype=dtype)
        k = torch.zeros((1, 64, 2, 65), device=dev, dtype=dtype)[..., 1:]
        assert k.stride(-1) == 1 and k.shape == (1, 64, 2, 64)
        with pytest.raises(ValueError, match="16 bytes"):
            flash_attention(q, k, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
# L cache rows, the layer read: (k) is Kimi-Audio-7B's decode, G 7 over the
# packed cache of both stacks (28 main rows, then 6 mimo rows), on a main
# row and on the last mimo row
@pytest.mark.parametrize("Hkv,G,L,layer", [(1, 4, 3, 1), (3, 2, 3, 1), (5, 1, 3, 1),
                                           (7, 2, 3, 1), (8, 4, 3, 1), (2, 16, 3, 1),
                                           (4, 7, 3, 1), (4, 7, 34, 0), (4, 7, 34, 33)])
def test_decode_kernel(dev, dtype, D, Hkv, G, L, layer):
    rng = np.random.default_rng(Hkv * 10 + G)
    B, S = 4, 1536
    q = _randn(rng, (B, Hkv * G, D), dtype, dev)
    kv = _randn(rng, (L, B, Hkv, S, 2 * D), dtype, dev)
    plen = torch.tensor([1000, 300, 1, 1024], dtype=torch.int32, device=dev)
    base, last = 1024, 1100
    n0 = decode_attention.launches
    got = decode_attention(q, kv, plen, base, last, layer_idx=layer)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    want = decode_attention_reference(q.float(), kv.float(), plen, base, last, layer_idx=layer)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,G", [(64, 4), (128, 1), (128, 16), (128, 7)])
def test_decode_kernel_balanced_splits(dev, dtype, D, G):
    """Prompt lengths with a 4x spread over an 8192-column cache (the split
    plan's fixed budget of live columns per split: a long row takes more
    splits, and splits straddle the [prompt_len, base) gap), a prompt that
    runs past base, and, with last < base, a row with no live column (0);
    two launches give the same bits."""
    rng = np.random.default_rng(D + G)
    B, Hkv, S = 5, 2, 8192
    q = _randn(rng, (B, Hkv * G, D), dtype, dev)
    kv = _randn(rng, (B, Hkv, S, 2 * D), dtype, dev)
    for plen, base, last in (([2048, 8191, 4000, 5000, 3001], 7936, 8000),
                             ([2048, 8191, 0, 6000, 2500], 7000, 6999)):
        plen = torch.tensor(plen, dtype=torch.int32, device=dev)
        got = decode_attention(q, kv, plen, base, last)
        again = decode_attention(q, kv, plen, base, last)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        want = decode_attention_reference(q.float(), kv.float(), plen, base, last)
        live = (plen > 0) | (base <= last)
        _check(got, want, dtype, live)
        assert (got[~live] == 0).all()


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


def _check_grad(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    rel = ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
    assert rel <= (1e-4 if dtype == torch.float32 else 1e-2), rel


def _attention_case(dev, dtype, B, T, S, H, Hkv, D, segs, seed):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, T, H, D), dtype, dev)
    k = _randn(rng, (B, S, Hkv, D), dtype, dev)
    v = _randn(rng, (B, S, Hkv, D), dtype, dev)
    g = _randn(rng, (B, T, H, D), dtype, dev)
    seg = kv_seg = None
    seg_np = _segments_of(segs, B, max(T, S), rng)
    if seg_np is not None:
        seg = torch.from_numpy(seg_np[:, :T]).to(dev)
        kv_seg = torch.from_numpy(seg_np[:, :S]).to(dev)
    return q, k, v, g, seg, kv_seg


def _valid_rows(B, T, S, causal, seg, kv_seg, q_off, kv_off, dev):
    m = torch.ones((B, T, S), dtype=torch.bool, device=dev)
    if causal:
        m &= (q_off + torch.arange(T, device=dev))[:, None] >= \
            (kv_off + torch.arange(S, device=dev))[None, :]
    if seg is not None:
        m &= seg[:, :, None] == kv_seg[:, None, :]
    return m.any(-1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal,segs,q_off,kv_off",
                         ATTENTION_CASES + [(1, 130, 130, 32, 8, 64, True, "packed", 0, 0)])
def test_flash_attention_bwd_kernel(dev, dtype, B, T, S, H, Hkv, D, causal, segs,
                                    q_off, kv_off):
    """K2 against autograd through the plain version, f32 math on the same
    inputs; dout is zero on rows with no valid key."""
    q, k, v, g, seg, kv_seg = _attention_case(dev, dtype, B, T, S, H, Hkv, D, segs,
                                              T + S + H)
    valid = _valid_rows(B, T, S, causal, seg, kv_seg, q_off, kv_off, dev)
    g = g * valid[:, :, None, None].to(dtype)
    out, lse = flash_attention(q, k, v, seg, causal, None, kv_seg, q_off, kv_off)
    n0 = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, seg, kv_seg, out, lse, g, causal, None, q_off, kv_off)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    want = flash_attention_bwd_reference(q.float(), k.float(), v.float(), seg, kv_seg, None,
                                         None, g.float(), causal, None, q_off, kv_off)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _check_grad(a, b, dtype)


@pytest.mark.parametrize("dtype,T,causal", [(torch.float32, 64, False),
                                            (torch.bfloat16, 64, False),
                                            (torch.bfloat16, 150, True),
                                            (torch.float16, 150, True)])
def test_flash_attention_bwd_gives_zero_for_rows_without_keys(dev, dtype, T, causal):
    """A row with no live key (lse = -inf from K1) gets out 0 and zero
    gradients, not NaN, and adds nothing to dk, dv."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, T, 4, 64), dtype, dev)
    k = _randn(rng, (1, T, 2, 64), dtype, dev)
    v = _randn(rng, (1, T, 2, 64), dtype, dev)
    cut = T // 2
    seg = torch.ones((1, T), dtype=torch.int32, device=dev)
    seg[:, cut:] = 2
    kv_seg = torch.ones((1, T), dtype=torch.int32, device=dev)  # rows cut+ see nothing
    out, lse = flash_attention(q, k, v, seg, causal, None, kv_seg)
    assert torch.isinf(lse[:, :, cut:]).all() and (out[:, cut:] == 0).all()
    g = torch.ones_like(q)
    dq, dk, dv = flash_attention_bwd(q, k, v, seg, kv_seg, out, lse, g, causal)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all() and torch.isfinite(dv).all()
    assert (dq[:, cut:] == 0).all()
    g2 = g.clone()
    g2[:, cut:] = 0
    _, dk2, dv2 = flash_attention_bwd(q, k, v, seg, kv_seg, out, lse, g2, causal)
    torch.testing.assert_close(dk, dk2, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv2, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_autograd_goes_through_k2(dev, dtype):
    """The repair of the forward-only wrapper: on CUDA tensors that require
    grad, flash_attention's out has a grad_fn, and q, k, v get K2's
    gradients, equal to the plain version's."""
    q, k, v, g, seg, kv_seg = _attention_case(dev, dtype, 2, 200, 200, 8, 2, 64, "packed", 9)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    out, lse = flash_attention(q, k, v, seg)
    assert out.grad_fn is not None and not lse.requires_grad
    (out.float() * g.float()).sum().backward()
    assert flash_attention.launches == n_fwd + 1
    assert flash_attention_bwd.launches == n_bwd + 1
    want = flash_attention_bwd_reference(q.detach().float(), k.detach().float(),
                                         v.detach().float(), seg, seg, None, None, g.float())
    for x, b in zip((q, k, v), want):
        assert x.grad is not None and x.grad.dtype == dtype
        _check_grad(x.grad, b, dtype)


def _ce_case(dev, dtype, N, E, V, seed, tie=False, w_scale=0.1):
    rng = np.random.default_rng(seed)
    h = _randn(rng, (N, E), dtype, dev)
    w = (w_scale * _randn(rng, (V, E), torch.float32, dev)).to(dtype)
    labels = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).to(dev)
    labels[::5] = -100
    labels[1] = V + 3
    if tie:
        h[:64, 0] = 8.0
        w[7] = w[V - 1] = 0.0
        w[7, 0] = w[V - 1, 0] = 8.0  # logit 64 in both: argmax 7
    return h.contiguous(), w.contiguous(), labels


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,E,V", [(300, 256, 1000), (64, 128, 64), (1000, 64, 4099),
                                   (1000, 36, 4099), (300, 2048, 128256)])
def test_fused_ce_kernel(dev, dtype, N, E, V):
    """K3 forward and backward against the plain versions on the same
    inputs: ragged row tiles (N not a multiple of 64 or 128) and a ragged
    vocab tail, ignored and out-of-range labels; bf16 takes the TMA + wgmma
    forward and backward where E is a multiple of 8 and the wmma tiles at
    E 36; the
    training path's E and V at a few hundred rows, with w at the model's
    init scale (0.02, as chip_smoke.py), so |lse| ~ 12 as in training."""
    h, w, labels = _ce_case(dev, dtype, N, E, V, N + V, w_scale=0.02 if V > 10**5 else 0.1)
    n0 = (fused_ce.fused_ce_fwd.launches, fused_ce.fused_ce_bwd.launches)
    lse, tl, m2, ai = fused_ce.fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    want = fused_ce._rows_reference(h, w, labels)
    for a, b in zip((lse, tl, m2), want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    agree = (ai == want[3]).float().mean().item()
    assert agree >= 0.999, agree
    rng = np.random.default_rng(1)
    dlse = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    dtl = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    dh, dw = fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, dtl)
    torch.cuda.synchronize()
    assert (fused_ce.fused_ce_fwd.launches, fused_ce.fused_ce_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    wdh, wdw = fused_ce._rows_backward_reference(h, w, labels, lse, dlse, dtl)
    assert dh.dtype == dw.dtype == dtype
    _check_grad(dh, wdh, dtype)
    _check_grad(dw, wdw, dtype)
    dh2, dw2 = fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, dtl)
    torch.testing.assert_close(dw2, dw, rtol=0, atol=0)  # no atomics: same bits
    torch.testing.assert_close(dh2, dh, rtol=0, atol=0)


def test_fused_ce_kernel_at_touch_audio_7bs_head(dev):
    """(q): K3 at Touch-Audio-7B's head (E 4096, V 128256) at the SFT
    recipe's 2 x 8192 rows in bf16, against the plain versions: the row
    statistics within 1e-3 (chip_smoke.py's CE_STAT_TOL at this E), argmax
    agreement >= 0.999 and rows 0-63's tie of columns 7 and V - 1 to 7, dh
    and dw under the bf16 gradient limit with the mean CE's cotangents."""
    N, E, V = 16384, 4096, 128256
    gen = torch.Generator(device=dev).manual_seed(17)
    h = torch.randn((N, E), generator=gen, device=dev).to(torch.bfloat16)
    w = (0.02 * torch.randn((V, E), generator=gen, device=dev)).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    labels[::9] = -100
    h[:64, 0] = 8.0
    w[7] = w[V - 1] = 0.0
    w[7, 0] = w[V - 1, 0] = 8.0  # logit 64 in both: argmax 7
    lse, tl, m2, ai = fused_ce.fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    want = fused_ce._rows_reference(h, w, labels)
    for a, b in zip((lse, tl, m2), want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    assert (ai[:64] == 7).all()
    assert (ai == want[3]).float().mean().item() >= 0.999
    del want
    valid = (labels != -100).float()
    dh, dw = fused_ce.fused_ce_bwd(h, w, labels, lse, valid / N, -valid / N)
    torch.cuda.synchronize()
    wdh, wdw = fused_ce._rows_backward_reference(h, w, labels, lse, valid / N, -valid / N)
    _check_grad(dh, wdh, torch.bfloat16)
    _check_grad(dw, wdw, torch.bfloat16)


def test_fused_ce_argmax_tie_and_small_chunks(dev, monkeypatch):
    """Ties go to the smallest index across vocab tiles and splits; the
    backward over several row chunks equals one chunk."""
    h, w, labels = _ce_case(dev, torch.float32, 200, 64, 3000, 4, tie=True)
    _, _, _, ai = fused_ce.fused_ce_rows(h, w, labels)
    assert (ai[:64] == 7).all()
    lse = fused_ce.fused_ce_fwd(h, w, labels)[0]
    g = torch.ones_like(lse)
    dh, dw = fused_ce.fused_ce_bwd(h, w, labels, lse, g, -g)
    monkeypatch.setattr(fused_ce, "DL_SCRATCH_BYTES", 64 * 3000 * 4)  # 64-row chunks
    dh2, dw2 = fused_ce.fused_ce_bwd(h, w, labels, lse, g, -g)
    torch.testing.assert_close(dh2, dh, rtol=0, atol=0)
    _check_grad(dw2, dw, torch.float32)  # the row sums split in another order


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_ce_chunked_bwd_matches_plain(dev, dtype, monkeypatch):
    """The backward over several row chunks (dw accumulated across them,
    a ragged last chunk) against the plain version, in both dtypes."""
    N, E, V = 1000, 128, 4099
    h, w, labels = _ce_case(dev, dtype, N, E, V, 11)
    monkeypatch.setattr(fused_ce, "DL_SCRATCH_BYTES",
                        256 * fused_ce.dl_stride(V) * h.element_size())
    assert -(-N // fused_ce.bwd_plan(N, E, V, dtype).chunk) == 4
    lse = fused_ce.fused_ce_fwd(h, w, labels)[0]
    rng = np.random.default_rng(2)
    dlse = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    dtl = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    dh, dw = fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, dtl)
    torch.cuda.synchronize()
    wdh, wdw = fused_ce._rows_backward_reference(h, w, labels, lse, dlse, dtl)
    _check_grad(dh, wdh, dtype)
    _check_grad(dw, wdw, dtype)
    dh2, dw2 = fused_ce.fused_ce_bwd(h, w, labels, lse, dlse, dtl)
    assert torch.equal(dw2, dw) and torch.equal(dh2, dh)  # chunks in order: same bits


def test_flash_attention_bwd_is_bit_stable(dev):
    """No atomics: two K2 runs on the same inputs give the same bits."""
    q, k, v, g, seg, kv_seg = _attention_case(dev, torch.bfloat16, 1, 700, 700, 32, 8, 64,
                                              "packed", 21)
    out, lse = flash_attention(q, k, v, seg, True, None, kv_seg)
    first = flash_attention_bwd(q, k, v, seg, kv_seg, out, lse, g, True)
    again = flash_attention_bwd(q, k, v, seg, kv_seg, out, lse, g, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _force_fwd_plan(monkeypatch, **fields):
    """The forward's plan with some fields replaced (splits, group)."""
    real = fused_ce.fwd_plan
    monkeypatch.setattr(fused_ce, "fwd_plan", lambda *a: real(*a)._replace(**fields))


@pytest.mark.parametrize("splits,group", [(1, 8), (3, 1), (5, 3), (17, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_ce_fwd_walks_vocab_splits(dev, monkeypatch, splits, group, dtype):
    """The TMA + wgmma forward with blocks that walk several vocab tiles
    (the ring runs across tiles; the last tile is the ragged tail) in other
    raster orders: the same statistics as the plain version."""
    N, E, V = 1000, 64, 4099
    h, w, labels = _ce_case(dev, dtype, N, E, V, 5)
    _force_fwd_plan(monkeypatch, splits=splits, group=group)
    assert fused_ce.fwd_plan(N, E, V, dtype, 132).mainloop == "wgmma"
    lse, tl, m2, ai = fused_ce.fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    want = fused_ce._rows_reference(h, w, labels)
    for a, b in zip((lse, tl, m2), want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert (ai == want[3]).float().mean().item() >= 0.999


# exact ties of the TMA + wgmma forward, each set of columns dominant in its
# own rows. A consumer thread holds columns 8 j + 2 (lane % 4) + {0, 1} of a
# 256-wide tile, so 4 and 12 are one thread's; 1 and 3 lie in lanes that
# merge first (shfl_xor 1), 2 and 7 in lanes that merge second (xor 2); 100
# and 300 lie in tiles 0 and 1; with two splits of 9 tiles, 40 and 2400 lie
# in splits 0 and 1; 4096 and 4098 in the tail tile; the last set has all
# of these at once.
CE_TIES = ((4, 12), (3, 1), (7, 2), (300, 100), (2400, 40), (4098, 4096), (15, 10, 600, 2500))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("splits", [None, 1, 2])
def test_fused_ce_fwd_ties_go_to_the_smallest_index(dev, monkeypatch, splits, dtype):
    """bf16 and f16 argmax ties inside one thread's columns, across the
    lanes of a quad, across two tiles of one split, across two splits and
    in the tail: every tie gives the smallest index (None: the plan's own 17
    one-tile splits)."""
    N, E, V = 256, 64, 4099
    h, w, labels = _ce_case(dev, dtype, N, E, V, 9)
    for g, cols in enumerate(CE_TIES):  # rows 32 g.. against columns `cols`
        h[32 * g:32 * (g + 1), g + 1] = 8.0
        w[list(cols)] = 0.0
        w[list(cols), g + 1] = 8.0  # logit 64, exactly, in each column of the set
    if splits is not None:
        _force_fwd_plan(monkeypatch, splits=splits)
    _, _, m2, ai = fused_ce.fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    want = fused_ce._rows_reference(h, w, labels)
    for g, cols in enumerate(CE_TIES):
        rows = slice(32 * g, 32 * (g + 1))
        assert (ai[rows] == min(cols)).all(), (cols, ai[rows].unique().tolist())
    torch.testing.assert_close(m2, want[2], rtol=0, atol=1e-4)
    assert torch.equal(ai, want[3])


@pytest.mark.parametrize("N,E,V", [(1000, 64, 4099), (300, 2048, 128256)])
def test_fused_ce_fwd_is_bit_stable(dev, N, E, V):
    """The TMA + wgmma forward gives the same bits in two runs."""
    h, w, labels = _ce_case(dev, torch.bfloat16, N, E, V, 13, w_scale=0.02)
    first = fused_ce.fused_ce_fwd(h, w, labels)
    again = fused_ce.fused_ce_fwd(h, w, labels)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("which", ["h", "w"])
def test_fused_ce_refuses_unaligned_bf16(dev, which, direction, dtype):
    """A bf16 or f16 h or w that does not start on 16 bytes cannot be a
    TMA tensor: both directions raise instead of launching."""
    N, E, V = 128, 64, 512
    h, w, labels = _ce_case(dev, dtype, N, E, V, 3)
    x = h if which == "h" else w
    moved = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    moved.copy_(x)
    assert moved.is_contiguous() and moved.data_ptr() % 16
    h, w = (moved, w) if which == "h" else (h, moved)
    with pytest.raises(ValueError, match="16 bytes"):
        if direction == "fwd":
            fused_ce.fused_ce_fwd(h, w, labels)
        else:
            g = torch.ones(N, device=dev)
            fused_ce.fused_ce_bwd(h, w, labels, g, g, g)


@pytest.mark.parametrize("chunk", [1000, 1 << 25])
def test_streamed_adamw_equals_resident(dev, chunk, monkeypatch):
    """CPU offload's streamed AdamW (moments in pinned host memory, two
    device slots on a copy stream) against the resident step on the same
    inputs, three steps: params, mu, nu and count bit for bit, with pieces
    of `chunk` elements (1000: a tensor in several pieces)."""
    from touchnet_tpu_torch.ops import fused_adamw

    monkeypatch.setattr(fused_adamw.StreamedMoments, "STREAM_CHUNK", chunk)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(300, 64), (64,), (7, 9), (4099,)]
    params = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    res_p = [p.clone() for p in params]
    res_m = [torch.zeros_like(p) for p in params]
    res_v = [torch.zeros_like(p) for p in params]
    moments = fused_adamw.StreamedMoments(params)
    assert all(m.is_pinned() and not m.is_cuda for m in moments.mu + moments.nu)
    c_res = c_off = torch.zeros((), dtype=torch.int32, device=dev)
    for step in range(3):
        grads = [torch.randn(s, generator=gen, device=dev).to(torch.bfloat16) for s in shapes]
        kw = dict(lr=torch.tensor(1e-2, device=dev), clip_scale=torch.tensor(0.5, device=dev),
                  finite=torch.tensor(step != 1, device=dev))
        c_res = fused_adamw.fused_adamw_step(grads, res_p, res_m, res_v, c_res, **kw)
        c_off = fused_adamw.streamed_adamw_step(grads, params, moments, c_off, **kw)
    moments.synchronize()
    assert int(c_res) == int(c_off) == 2
    for a, b in zip(res_p + res_m + res_v, params + moments.mu + moments.nu):
        assert torch.equal(a.cpu(), b.cpu())
