# K3's plain version (touchnet_tpu_torch.ops.fused_ce.fused_ce_rows, which
# CPU tensors take) against touchnet_tpu's fused_ce_rows with its Pallas
# forward and backward kernels in interpret mode, on the same numpy inputs:
# lse, label logit, m2 (base-2 row max) and argmax, and the gradients dh, dw
# of a loss that weights lse and label logit. f32; atol 1e-4 on the row
# statistics (|lse| ~ 6-7: a few f32 ulps of different summation orders)
# and atol 1e-5 with rtol 1e-5 on the gradients (sums of 256-512 terms of
# unit scale in another order: dw entries reach ~4, where f32 rounding of
# the sum alone is a few 1e-6).

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.ops import fused_ce as jce
from touchnet_tpu_torch.ops import fused_ce as ce

N, E, V = 256, 128, 512  # the smallest shape the Pallas kernel takes


def _inputs(seed, tie=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, E)).astype(np.float32)
    w = (0.5 * rng.standard_normal((V, E))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[::7] = -100  # ignored positions
    labels[3] = V + 5  # outside [0, V): label logit 0
    if tie:
        # rows 11 and 300 of w are equal, and one feature makes them
        # dominate every logit of the first 64 rows (100 against ~N(0, 6)):
        # an exact tie, whose argmax must be the smaller index, 11
        h[:64, 0] = 10.0
        w[11] = w[300] = 0.0
        w[11, 0] = w[300, 0] = 10.0
    a = rng.standard_normal(N).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    return h, w, labels, a, b


@pytest.mark.parametrize("tie", [False, True], ids=["random", "argmax_tie"])
def test_plain_version_matches_jax_kernel(tie):
    h, w, labels, a, b = _inputs(7 + tie, tie)

    def jloss(h_, w_):
        lse, tl, m2, ai = jce.fused_ce_rows(h_, w_, jnp.asarray(labels), interpret=True)
        return jnp.sum(lse * a + tl * b), (lse, tl, m2, ai)

    (_, jrows), (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))

    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    n0 = (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches)
    lse, tl, m2, ai = ce.fused_ce_rows(th, tw, torch.from_numpy(labels))
    assert not m2.requires_grad and not ai.requires_grad
    (lse * torch.from_numpy(a) + tl * torch.from_numpy(b)).sum().backward()
    assert (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches) == n0  # CPU: plain

    for name, got, want in zip(("lse", "true_logit", "m2"), (lse, tl, m2), jrows[:3]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(ai.numpy(), np.asarray(jrows[3]))
    assert (tl.detach().numpy()[labels < 0] == 0).all() and tl[3].item() == 0
    if tie:
        assert (ai[:64] == 11).all()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)


def test_plain_route_on_any_device_is_the_same_function():
    """fused_ce_rows_reference (the plain route chip_smoke swaps in on the
    card) gives what the CPU wrapper gives, values and gradients."""
    h, w, labels, a, _ = _inputs(3)
    outs = []
    for fn in (ce.fused_ce_rows, ce.fused_ce_rows_reference):
        th = torch.from_numpy(h).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        lse, tl, m2, ai = fn(th, tw, torch.from_numpy(labels))
        (lse * torch.from_numpy(a) - tl).sum().backward()
        outs.append((lse, tl, m2, ai, th.grad, tw.grad))
    for x, y in zip(*outs):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("N,itemsize,rows,chunks", [
    (16384, 2, 8320, 2),  # the training path's 1x16384 in bf16: dW accumulates
    (16384, 4, 4160, 4),
    (4096, 2, 4096, 1),
    (100, 4, 128, 1),  # one ragged row tile
])
def test_bwd_chunk_rows(N, itemsize, rows, chunks):
    """The backward's dl chunk at V = 128256 under the 2 GiB scratch budget:
    whole 64-row tiles, capped at what N needs."""
    got = ce.bwd_chunk_rows(N, 128256, itemsize)
    assert got == rows and got % 64 == 0 and -(-N // got) == chunks


@pytest.mark.parametrize("N,E,V,dtype,want", [
    # the training path: TMA + wgmma in 128-row tiles, two chunks
    (16384, 2048, 128256, torch.bfloat16, ("wgmma", 128, 8320, 128256)),
    (16384, 2048, 128256, torch.float32, ("fma", 64, 4160, 128256)),
    (300, 2048, 128256, torch.bfloat16, ("wgmma", 128, 384, 128256)),
    # a ragged vocab: the dl stride pads 4099 to 4104
    (1000, 64, 4099, torch.bfloat16, ("wgmma", 128, 1024, 4104)),
    # E not a multiple of 8: TMA cannot describe the rows, the wmma tiles run
    (1000, 36, 4099, torch.bfloat16, ("wmma", 64, 1024, 4104)),
    (100, 64, 4099, torch.float32, ("fma", 64, 128, 4104)),
])
def test_bwd_plan(N, E, V, dtype, want):
    """Which mainloop the backward takes for a (dtype, E, V), its row tile,
    the dl chunk in whole row tiles and the padded dl stride."""
    assert tuple(ce.bwd_plan(N, E, V, dtype)) == want


def test_bwd_plan_refuses_other_dtypes():
    """f16 is planned as bf16 is (one kernel body for both 16-bit types);
    float64 is no kernel dtype and raises."""
    for E in (2048, 36):
        assert ce.bwd_plan(16384, E, 128256, torch.float16) == \
            ce.bwd_plan(16384, E, 128256, torch.bfloat16)
    with pytest.raises(ValueError):
        ce.bwd_plan(64, 64, 64, torch.float64)


@pytest.mark.parametrize("V", [1, 7, 8, 9, 4099, 128256, 128257])
def test_dl_stride(V):
    """Every dl row starts on 16 bytes: the stride is V rounded up to 8."""
    ldl = ce.dl_stride(V)
    assert ldl % 8 == 0 and V <= ldl < V + 8


@pytest.mark.parametrize("N", [1, 127, 128, 129, 8320, 8321, 16384, 40000])
def test_bwd_chunks_are_whole_row_tiles(N, monkeypatch):
    """Under a small scratch budget the chunks are whole 128-row tiles of
    the wgmma mainloop, fit the budget, and cover every row."""
    V = 4099
    monkeypatch.setattr(ce, "DL_SCRATCH_BYTES", 1000 * ce.dl_stride(V) * 2)
    plan = ce.bwd_plan(N, 64, V, torch.bfloat16)
    assert plan.chunk % 128 == 0 and plan.chunk <= 896
    assert plan.chunk * plan.ldl * 2 <= ce.DL_SCRATCH_BYTES
    assert -(-N // plan.chunk) * plan.chunk >= N
    assert plan.chunk == min(896, -(-N // 128) * 128)


@pytest.mark.parametrize("N,E,V,dtype,want", [
    # the training path: TMA + wgmma, 128 x 256 tiles, 36 splits of 14 tiles
    # (35 waves of 132 blocks), raster groups of 32 row tiles (16 MB of h)
    (16384, 2048, 128256, torch.bfloat16, ("wgmma", 128, 256, 36, 32)),
    (300, 2048, 128256, torch.bfloat16, ("wgmma", 128, 256, 84, 3)),
    (1000, 64, 4099, torch.bfloat16, ("wgmma", 128, 256, 17, 8)),
    # E not a multiple of 8: TMA cannot describe the rows, the wmma tiles run
    (1000, 36, 4099, torch.bfloat16, ("wmma", 64, 64, 65, 16)),
    (100, 64, 4099, torch.float32, ("fma", 64, 64, 65, 2)),
    (16384, 2048, 128256, torch.float32, ("fma", 64, 64, 9, 256)),
])
def test_fwd_plan(N, E, V, dtype, want):
    """Which mainloop the forward takes for a (dtype, E), its tile, its
    vocab splits and raster group on a 132-SM card."""
    assert tuple(ce.fwd_plan(N, E, V, dtype, 132)) == want


def test_fwd_plan_refuses_other_dtypes():
    """f16 is planned as bf16 is; float64 raises."""
    for E in (2048, 36):
        assert ce.fwd_plan(16384, E, 128256, torch.float16, 132) == \
            ce.fwd_plan(16384, E, 128256, torch.bfloat16, 132)
    with pytest.raises(ValueError):
        ce.fwd_plan(64, 64, 64, torch.float64, 132)


@pytest.mark.parametrize("V", [64, 4099, 128256, 151936])
@pytest.mark.parametrize("N", [1, 300, 16384])
def test_fwd_splits_cover_the_vocab(N, V):
    """The TMA + wgmma forward's grid as the kernel computes it (split_run,
    fwd_block): every (row tile, split) has one block, no split is empty,
    every 256-column tile lies in exactly one split, and the columns left
    after masking those >= V are exactly [0, V)."""
    plan = ce.fwd_plan(N, 2048, V, torch.bfloat16, 132)
    row_tiles, tiles = -(-N // 128), -(-V // 256)
    runs = [ce.split_run(plan, V, s) for s in range(plan.splits)]
    assert all(count >= 1 for _, count in runs)
    walked = [t for first, count in runs for t in range(first, first + count)]
    assert walked == list(range(tiles))  # once each, splits in vocab order
    cols = [c for t in walked for c in range(t * 256, (t + 1) * 256) if c < V]
    assert cols == list(range(V)) and 0 < V - (tiles - 1) * 256 <= 256
    blocks = [ce.fwd_block(plan, N, b) for b in range(row_tiles * plan.splits)]
    assert sorted(blocks) == [(r, s) for r in range(row_tiles) for s in range(plan.splits)]
    # the blocks in flight (one per SM) hold one raster group's rows, unless
    # the vocab has fewer tiles than that takes splits
    assert len({r for r, _ in blocks[:132]}) <= max(plan.group, -(-132 // tiles))
