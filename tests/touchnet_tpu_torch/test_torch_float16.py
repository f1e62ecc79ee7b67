# float16 through the port on the CPU, against the JAX package in float16 on
# the same numpy inputs (each f16-rounded once, in numpy):
#   - the kernels' plain versions (what CPU tensors take) against JAX's own
#     functions in f16: K1's forward against packed_attention_reference (the
#     plain reference JAX's tests use) and, once, the Pallas forward in
#     interpret mode; K2's three gradients against jax.grad through
#     packed_attention_reference; K3's four row statistics and its dh, dw
#     against fused_ce_rows with its custom VJP (whose reference backward
#     rounds dl to h's dtype, fused_ce.py:345, as the port does); K4 on a
#     packed f16 cache against the Pallas decode kernel in interpret mode;
#   - greedy generate with an f16 cache and compute dtype against JAX's
#     generate in f16: the prefill logits and the tokens;
#   - one step of the port's Trainer at --training_mixed_precision_param
#     float16 against the JAX Trainer's at float16.
# Tolerances, each with its reason at its constant. An f16 value keeps 11
# significant bits: half an ulp is 2^-11 of the value (4.9e-4), 8x finer
# than bf16's 2^-8, so no limit here is looser than the bf16 one for the
# same comparison (the card's bf16 limits are 2e-2 on out, 1e-2 on
# gradients relative to the largest value).

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.models.llama import inference_llama as jinf
from touchnet_tpu.ops import attention as jattn
from touchnet_tpu.ops import fused_ce as jce
from touchnet_tpu.ops.decode_attention import decode_attention as j_decode
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.llama import inference_llama as inf
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.ops import attention as attn
from touchnet_tpu_torch.ops import decode_attention as dec
from touchnet_tpu_torch.ops import fused_ce as ce
from touchnet_tpu_torch.tokenizer import TokenizerConfig

from test_torch_attention import _mask, _packed
from test_torch_inference import _pair, _prompts
from test_torch_train import CFG, _flags, build_corpus

F16 = np.float16
# out of attention (|out| < 4 at unit-scale inputs): the two sides round p
# to f16 for the PV product and out to f16 once each, in other places and
# summation orders; a few f16 ulps at |out| ~ 2 (measured: 4.9e-4)
OUT_ATOL = 2e-3
# JAX's Pallas forward in interpret mode also scales k in f16 before QK^T
# (attention.py:197), one more f16 rounding (measured: 2.0e-3)
INTERPRET_ATOL = 5e-3
# gradients relative to the largest reference value: each side rounds its
# outputs to f16 once, and JAX's autodiff chain differs from K2's formula
# (measured: 7.0e-4)
GRAD_RTOL = 2e-3
# one training step's loss, accuracy and grad norm, f16 compute on both
# sides with the roundings in other places (measured: loss 8.0e-7, grad
# norm 3.6e-5, accuracy equal)
F16_STEP_RTOL = 2e-4


def _attention_inputs(seed, B, T, S, H, Hkv, D, packed):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((B, T, H, D)).astype(F16) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(F16) for _ in range(2))
    return q, k, v, g, (_packed(rng, B, T) if packed else None)


def _valid(B, T, S, causal, seg, q_off):
    """[B, T]: the rows with at least one valid key."""
    return _mask(B, T, S, causal, seg, seg, q_off, 0).any(-1)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


ATTENTION_CASES = [
    (2, 150, 150, 4, 2, 64, True, True, 0),  # packed, causal, GQA, unaligned T
    (1, 130, 130, 2, 2, 128, False, False, 0),  # non-causal, D 128
    (1, 64, 128, 4, 1, 64, True, False, 64),  # q_offset, G 4
]
ATTENTION_IDS = ["packed_causal_gqa", "noncausal_d128", "q_offset"]


@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal,packed,q_off", ATTENTION_CASES,
                         ids=ATTENTION_IDS)
def test_k1_plain_version_matches_jax_in_f16(B, T, S, H, Hkv, D, causal, packed, q_off):
    q, k, v, _, seg = _attention_inputs(T + S, B, T, S, H, Hkv, D, packed)
    tseg = None if seg is None else torch.from_numpy(seg)
    n0 = attn.flash_attention.launches
    out, lse = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), tseg, causal, q_offset=q_off)
    assert attn.flash_attention.launches == n0  # CPU: the plain version
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    want = jattn.packed_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if seg is None else jnp.asarray(seg), causal, q_offset=q_off)
    assert want.dtype == jnp.float16
    valid = _valid(B, T, S, causal, seg, q_off)
    np.testing.assert_allclose(out.float().numpy()[valid], np.asarray(want, np.float32)[valid],
                               atol=OUT_ATOL)


def test_k1_plain_version_matches_jax_pallas_forward_in_f16():
    """One case against the Pallas forward itself, in interpret mode."""
    q, k, v, _, seg = _attention_inputs(1, 2, 150, 150, 4, 2, 64, True)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(seg), True, block_q=128, block_kv=128,
                                 use_pallas=True, interpret=True)
    assert want.dtype == jnp.float16
    out, _ = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(seg), True)
    valid = _valid(2, 150, 150, True, seg, 0)
    np.testing.assert_allclose(out.float().numpy()[valid], np.asarray(want, np.float32)[valid],
                               atol=INTERPRET_ATOL)


@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal,packed,q_off", ATTENTION_CASES,
                         ids=ATTENTION_IDS)
def test_k2_plain_version_matches_jax_grad_in_f16(B, T, S, H, Hkv, D, causal, packed, q_off):
    """dq, dk, dv of sum(out * g) from K2's plain version (its formula from
    the forward's out and lse, f32 inside, each gradient rounded to f16)
    against jax.grad through JAX's reference in f16; g is zero on rows with
    no valid key."""
    q, k, v, g, seg = _attention_inputs(T + S + 1, B, T, S, H, Hkv, D, packed)
    g = g * _valid(B, T, S, causal, seg, q_off)[:, :, None, None].astype(F16)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q_, k_, v_):
        o = jattn.packed_attention_reference(q_, k_, v_, jseg, causal, q_offset=q_off)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g, jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tseg = None if seg is None else torch.from_numpy(seg)
    n0 = attn.flash_attention_bwd.launches
    got = attn.flash_attention_bwd(*map(torch.from_numpy, (q, k, v)), tseg, tseg, None, None,
                                   torch.from_numpy(g), causal, None, q_off, 0)
    assert attn.flash_attention_bwd.launches == n0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float16 and b.dtype == jnp.float16
        assert _rel(a.numpy(), b) <= GRAD_RTOL, name
    # the public entry's autograd (the custom op's backward) gives the same
    qq, kk, vv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, _ = attn.flash_attention(qq, kk, vv, tseg, causal, q_offset=q_off)
    (out.float() * torch.from_numpy(g).float()).sum().backward()
    for x, a in zip((qq, kk, vv), got):
        assert torch.equal(x.grad, a)


def test_k3_plain_version_matches_jax_in_f16():
    """K3's row statistics (f32 from f16 products: within 1e-4 absolute, as
    the f32 test; argmax equal) and dh, dw (dl rounded to f16 on both
    sides, then f32 products rounded to f16: rtol 1e-3 of the largest value,
    two f16 roundings of |dh| ~ 4.6 differ by one ulp, 3.9e-3 = 8.5e-4 of
    it)."""
    N, E, V = 256, 128, 512
    rng = np.random.default_rng(7)
    h = rng.standard_normal((N, E)).astype(F16)
    w = (0.5 * rng.standard_normal((V, E))).astype(F16)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[::7] = -100
    labels[3] = V + 5
    a, b = (rng.standard_normal(N).astype(np.float32) for _ in range(2))

    def jloss(h_, w_):
        lse, tl, m2, ai = jce.fused_ce_rows(h_, w_, jnp.asarray(labels))
        return jnp.sum(lse * a + tl * b), (lse, tl, m2, ai)

    (_, jrows), (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    n0 = (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches)
    lse, tl, m2, ai = ce.fused_ce_rows(th, tw, torch.from_numpy(labels))
    (lse * torch.from_numpy(a) + tl * torch.from_numpy(b)).sum().backward()
    assert (ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches) == n0
    for name, got, want in zip(("lse", "true_logit", "m2"), (lse, tl, m2), jrows[:3]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(ai.numpy(), np.asarray(jrows[3]))
    assert th.grad.dtype == tw.grad.dtype == torch.float16
    assert jdh.dtype == jdw.dtype == jnp.float16
    assert _rel(th.grad.numpy(), jdh) <= 1e-3
    assert _rel(tw.grad.numpy(), jdw) <= 1e-3


@pytest.mark.parametrize("D", [64, 128])
def test_k4_plain_version_matches_jax_kernel_in_f16(D):
    """One decode step over a packed f16 cache (ragged prompts, one of 1
    token) against the Pallas decode kernel in interpret mode; out within
    OUT_ATOL."""
    rng = np.random.default_rng(D)
    q = rng.standard_normal((3, 6, D)).astype(F16)
    kv = rng.standard_normal((3, 2, 640, 2 * D)).astype(F16)
    plen = np.asarray([512, 300, 1], np.int32)
    n0 = dec.decode_attention.launches
    got = dec.decode_attention(torch.from_numpy(q), torch.from_numpy(kv),
                               torch.from_numpy(plen), 512, 570)
    assert dec.decode_attention.launches == n0 and got.dtype == torch.float16
    want = j_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(plen), 512, 570,
                    block_s=256, interpret=True)
    assert want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=OUT_ATOL)


def test_greedy_generate_matches_jax_in_f16():
    """inference_llama.generate with compute dtype float16 (its packed
    cache in f16, K1's and K4's plain versions on f16) against JAX's
    generate in float16 on the same f32 weights: the cache is f16 on both
    sides, the first prefill's logits agree within 2e-3 (f16 roundings in
    other places; measured 3.1e-4 on logits up to 0.51), and the greedy
    tokens are equal, single-shot and chunked."""
    cfg, model, jcfg, params = _pair("tiny_llama")
    emb, plen = _prompts(params, [16, 10], 3)
    B, T = emb.shape[:2]
    want, jcache = jinf.forward_step(
        params, jnp.asarray(emb), jinf.init_cache(jcfg, B, T, jnp.float16),
        jnp.zeros((B,), jnp.int32), jcfg, jnp.float16)
    got, cache = inf.forward_step(
        model, torch.from_numpy(emb), inf.init_cache(cfg, B, T, torch.float16, "cpu"),
        torch.zeros((B,), dtype=torch.long), cfg, torch.float16)
    assert cache.kv.dtype == torch.float16 and jcache.kv.dtype == jnp.float16
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-3)
    for kw in ({}, {"prefill_chunk": 8}):
        jtok = jinf.generate(params, jcfg, jnp.asarray(emb), jnp.asarray(plen), 8, eos_id=-1,
                             compute_dtype=jnp.float16, **kw)
        ttok = inf.generate(model, cfg, torch.from_numpy(emb), torch.from_numpy(plen), 8,
                            eos_id=-1, compute_dtype=torch.float16, **kw)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_train_step_matches_jax_trainer(tmp_path):
    """One step of the port's Trainer at --training_mixed_precision_param
    float16 (f32 masters, f16 compute: K1, K2 and K3's plain versions in
    f16, no loss scaler, as JAX) against the JAX Trainer's jitted step at
    float16 on the same weights and the first batch of the same shards (8
    packed rows of the tiny Llama, the JAX trainer's dp 8 over the 8 CPU
    devices): loss per sample, loss per token, accuracy and grad norm within
    F16_STEP_RTOL."""
    listfile = build_corpus(tmp_path)
    kw = dict(dataset_batchsize=8, dataset_text_seqlen=64,
              training_mixed_precision_param="float16",
              training_activation_checkpoint_mode="none")
    tok, data, job = ttrain.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], _flags(tmp_path / "port", listfile, 10, **kw))
    trainer = ttrain.Trainer(tok, data, job, device=torch.device("cpu"))
    gc_on = gc.isenabled()
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig],
                          _flags(tmp_path / "jax", listfile, 10, **kw)))
    try:
        assert trainer.compute_dtype == torch.float16
        trainer.model.load_state_dict(params_from_jax_numpy(
            jax.tree.map(np.asarray, jt.params), LlamaConfig.from_json_file(CFG)))
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())  # masters
        batch = next(iter(trainer.dataloader))
        db, jns = jt._put_batch(batch)
        _, _, jm = jt.train_step_fn(jt.params, jt.opt_state, db, jns, 1)
        device_batch, ns = trainer._put_batch(batch)
        tm = trainer.train_step(device_batch, ns)
        for key in ("loss/per_sample", "loss/per_token", "acc", "grad_norm"):
            assert np.isfinite(float(tm[key]))
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=F16_STEP_RTOL,
                                       err_msg=key)
    finally:
        jt.close()
        trainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()
