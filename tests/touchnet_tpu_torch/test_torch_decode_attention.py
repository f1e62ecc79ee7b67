# K4's plain version (touchnet_tpu_torch.ops.decode_attention, which CPU
# tensors take) against touchnet_tpu's Pallas flash-decode kernel in
# interpret mode, on the cases of tests/touchnet_tpu/ops/
# test_decode_attention.py: head dims 64 and 128, ragged prompt lengths
# down to 1, Hkv in {1, 3, 5, 7}, a rank-5 cache with a layer index.
# f32 inputs from numpy, atol 2e-5.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.ops.decode_attention import decode_attention as j_decode
from touchnet_tpu_torch.ops import decode_attention as dec

ATOL = 2e-5


def _inputs(seed, shape_q, shape_kv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _both(q, kv, plen, base, last, layer_idx=None, block_s=256):
    n0 = dec.decode_attention.launches
    got = dec.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(plen),
        base, last, layer_idx=layer_idx,
    )
    assert dec.decode_attention.launches == n0  # CPU: plain version, no launch
    want = j_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(plen), base,
                    last, block_s=block_s, interpret=True, layer_idx=layer_idx)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,base,last", [(640, 512, 570), (1024, 768, 768)])
def test_matches_jax_kernel(D, S, base, last):
    q, kv = _inputs(D + S, (3, 6, D), (3, 2, S, 2 * D))
    plen = np.asarray([512, 300, 1], np.int32)  # ragged, incl. a 1-token prompt
    got, want = _both(q, kv, plen, base, last)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("Hkv", [1, 3, 5, 7])
def test_kv_head_counts(Hkv):
    q, kv = _inputs(Hkv, (2, 2 * Hkv, 64), (2, Hkv, 512, 128))
    got, want = _both(q, kv, np.asarray([300, 64], np.int32), 384, 400)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rank5_cache_layer_index():
    q, kv = _inputs(3, (2, 4, 64), (3, 2, 2, 512, 128))
    plen = np.asarray([100, 300], np.int32)
    for li in range(3):
        got, want = _both(q, kv, plen, 384, 387, layer_idx=li)
        np.testing.assert_allclose(got, want, atol=ATOL)
        alone = dec.decode_attention(torch.from_numpy(q), torch.from_numpy(kv[li]),
                                     torch.from_numpy(plen), 384, 387)
        np.testing.assert_array_equal(alone.numpy(), got)


def test_dead_columns_are_masked():
    """Garbage in the prompt gap and past `last` does not change the result
    (the dense plain version reads it and masks it exactly; the CUDA kernel
    never reads it, see test_torch_kernels_cuda.py)."""
    q, kv = _inputs(1, (2, 4, 64), (2, 2, 1024, 128))
    plen = np.asarray([128, 64], np.int32)
    clean = dec.decode_attention(torch.from_numpy(q), torch.from_numpy(kv),
                                 torch.from_numpy(plen), 256, 511)
    kv[0, :, 128:256] = 1e4
    kv[:, :, 512:] = -1e4
    got = dec.decode_attention(torch.from_numpy(q), torch.from_numpy(kv),
                               torch.from_numpy(plen), 256, 511)
    np.testing.assert_array_equal(got.numpy(), clean.numpy())


def test_num_splits():
    assert dec.num_splits(32, 8, 8192, 132) == 3
    assert dec.num_splits(1, 1, 100, 132) == 1
    assert dec.num_splits(1, 8, 1024, 132) == 8  # no split under 128 columns
