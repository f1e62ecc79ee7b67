# Context parallelism (touchnet_tpu_torch/parallel/context_parallel.py,
# ops/ring_attention.py) against the JAX package on the CPU. Spawned gloo
# ranks (dist_workers.spawn) run cp_local_attn on their sequence slices of
# the inputs of tests/touchnet_tpu/ops/test_ring_attention.py (B4 T256 H4/2
# D32, three packed documents and a padding tail a row, here made from a
# numpy seed), at cp 2 and cp 4 for both rotate methods; the slices' out and
# gradients of sum(out * g), put back together, are held to
#   - alltoall: ring_attention_sharded (its jnp ring) on the 8-device CPU
#     mesh, dp_shard 8/cp x cp;
#   - allgather: make_sharded_attn_fn(mesh, rotate_method="allgather");
# in f32 at atol/rtol 3e-5 on out and 1e-4 on dq, dk, dv (JAX's own ring
# test holds its gradients to 2e-3). The CPU branch of the port runs the
# plain versions of K1 and K2 inside the ring: the ring's combine and its
# K2 calls on the final out and lse are what is held. One 4-rank case at
# cp 2 x tp 2 runs each rank on its local heads against JAX at the same
# cp x tp. And: combine on a step with no live pair, the tiny Llama's
# forward at cp 2 equal to the whole forward on each rank's half (position
# ids sliced with their tokens, or the forward's global default), and the
# two flags' refusals (an unknown rotate method, a T that cp does not
# divide). touch_audio at cp 2 through bin.train.main, its training lines
# and its dev lines against the JAX Trainer at the same layout.

import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dist_workers import cp_attention, cp_forward, spawn

from touchnet_tpu.ops.ring_attention import ring_attention_sharded
from touchnet_tpu.parallel.context_parallel import make_sharded_attn_fn
from touchnet_tpu.parallel.dims import ParallelDims as JParallelDims
from touchnet_tpu_torch.ops.ring_attention import combine
from touchnet_tpu_torch.parallel.context_parallel import cp_local_attn, split_sequence

OUT_TOL, GRAD_TOL = 3e-5, 1e-4
CFG = os.path.join(os.path.dirname(__file__), "..", "assets", "config", "tiny_llama.json")


def make_inputs(B=4, T=256, H=4, Hkv=2, D=32, seed=0):
    """test_ring_attention.make_inputs' shapes and segments, from numpy;
    and a cotangent g."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    seg = np.ones((B, T), np.int32)
    for b in range(B):
        seg[b, T // 3: 2 * T // 3] = 2
        seg[b, 2 * T // 3:] = 3
        seg[b, T - 9:] = 0  # padding
    return q, k, v, seg, g


def _jax(method, cp, tp, q, k, v, seg, g):
    """out and (dq, dk, dv) of sum(out * g) from JAX's CP attention on the
    8-device CPU mesh dp_shard x cp x tp."""
    mesh = JParallelDims(world_size=8, dp_shard=8 // (cp * tp), cp=cp, tp=tp).build_mesh()
    if method == "alltoall":
        attn = ring_attention_sharded(mesh, block_q=128, block_kv=128, use_pallas=False)
    else:
        attn = make_sharded_attn_fn(mesh, rotate_method="allgather")
    jseg, jg = jnp.asarray(seg), jnp.asarray(g)

    def loss(q_, k_, v_):
        return jnp.sum(attn(q_, k_, v_, jseg) * jg)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    with mesh:
        out = jax.jit(attn)(*args, jseg)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _assemble(ranks, cp, tp):
    """The ranks' (out, dq, dk, dv) slices put back into whole arrays."""
    whole = []
    for i in range(1, 5):
        rows = [np.concatenate([r[i] for r in ranks if r[0]["cp"] == c], axis=2)
                for c in range(cp)] if tp > 1 else [r[i] for r in ranks]
        whole.append(np.concatenate(rows, axis=1))
    return whole


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("method", ["allgather", "alltoall"])
def test_cp_local_attn_matches_jax(tmp_path, method, cp):
    q, k, v, seg, g = make_inputs()
    want = _jax(method, cp, 1, q, k, v, seg, g)
    got = _assemble(spawn(cp_attention, cp, tmp_path, method, q, k, v, seg, g, cp), cp, 1)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        tol = OUT_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=f"{method} cp {cp} {name}")


def test_cp2_tp2_attends_on_local_heads(tmp_path):
    """4 ranks, cp 2 x tp 2 (allgather): each rank's K1/K2 on its half of
    the heads and of the sequence; put together, JAX's attention at
    dp_shard 2 x cp 2 x tp 2."""
    q, k, v, seg, g = make_inputs()
    want = _jax("allgather", 2, 2, q, k, v, seg, g)
    ranks = spawn(cp_attention, 4, tmp_path, "allgather", q, k, v, seg, g, 2, 2)
    assert sorted((r[0]["cp"], r[0]["tp"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), _assemble(ranks, 2, 2), want):
        tol = OUT_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


def test_combine_takes_a_step_with_no_live_pair():
    """A ring step whose chunk every row masks (out 0, lse -inf, as K1
    gives) leaves the running state as it was, and a first step of lse
    -inf on an empty state makes no NaN; a live step then takes over."""
    B, T, H, D = 1, 3, 2, 4
    rng = np.random.default_rng(1)
    out_p = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))
    lse_p = torch.from_numpy(rng.standard_normal((B, H, T)).astype(np.float32))
    zero_out = torch.zeros(B, T, H, D)
    dead = torch.full((B, H, T), float("-inf"))
    num, den, m = torch.zeros(B, T, H, D), torch.zeros(B, H, T), dead.clone()

    n1, d1, m1 = combine(num, den, m, zero_out, dead)  # empty + dead
    assert torch.equal(n1, num) and torch.equal(d1, den) and torch.equal(m1, dead)
    n2, d2, m2 = combine(n1, d1, m1, out_p, lse_p)  # then a live step
    assert torch.equal(m2, lse_p) and torch.equal(d2, torch.ones_like(d2))
    assert torch.equal(n2, out_p)
    n3, d3, m3 = combine(n2, d2, m2, zero_out, dead)  # live + dead
    assert torch.equal(n3, n2) and torch.equal(d3, d2) and torch.equal(m3, m2)
    assert all(bool(torch.isfinite(x).all()) for x in (n1, d1, n2, d2, m2, n3, d3))


@pytest.mark.parametrize("method", ["allgather", "alltoall"])
def test_llama_forward_at_cp2_equals_whole_forward(tmp_path, method):
    """The tiny Llama's logits at cp 2, each rank on its half of two packed
    rows (position ids restarting per document, sliced with their tokens;
    and with no position ids, the forward's global default), equal the
    one-process forward's halves (f32, atol 1e-5)."""
    from touchnet_tpu_torch.models.llama import modeling_llama
    from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig

    cfg = LlamaConfig.from_json_file(CFG)
    gen = torch.Generator().manual_seed(0)
    model = modeling_llama.init_params(cfg, gen)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    B, T = 2, 64
    rng = np.random.default_rng(2)
    ids = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    seg = np.repeat([[1] * 20 + [2] * 30 + [3] * 10 + [0] * 4], B, 0).astype(np.int32)
    pos = np.concatenate([np.arange(20), np.arange(30), np.arange(10), np.arange(4)])
    pos = np.repeat(pos[None], B, 0).astype(np.int32)
    kw = dict(input_ids=torch.from_numpy(ids), segment_ids=torch.from_numpy(seg), config=cfg,
              compute_dtype=torch.float32)
    with torch.no_grad():
        want = modeling_llama.forward(model, position_ids=torch.from_numpy(pos), **kw).numpy()
        want_default = modeling_llama.forward(model, **kw).numpy()
    ranks = spawn(cp_forward, 2, tmp_path, method, CFG, state, ids, pos, seg)
    for got, w in ((np.concatenate([r[0] for r in ranks], 1), want),
                   (np.concatenate([r[1] for r in ranks], 1), want_default)):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-5)


def test_unknown_rotate_method_and_undivided_sequence_raise(tmp_path):
    """An unknown --training_context_parallel_rotate_method raises naming
    the flag, in the trainer (before any work) and in cp_local_attn; a
    sequence length that cp does not divide raises naming
    training_context_parallel_degree (JAX would leave it unsplit)."""
    from test_torch_train import _flags

    from touchnet_tpu_torch.bin import train as ttrain

    with pytest.raises(ValueError, match="training_context_parallel_rotate_method"):
        ttrain.main(_flags(tmp_path, "unused.list", 2,
                           training_context_parallel_rotate_method="ring"),
                    device=torch.device("cpu"))
    x = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="training_context_parallel_rotate_method='ring'"):
        cp_local_attn(x, x, x, None, cp=2, rotate_method="ring")
    with pytest.raises(ValueError, match="training_context_parallel_degree=4"):
        split_sequence(np.zeros((2, 10), np.int32), 4, 1)
    # what divides is split on the sequence axis; arrays without it stay whole
    a = np.arange(24).reshape(2, 12)
    np.testing.assert_array_equal(split_sequence(a, 3, 2), a[:, 8:])
    stack = np.arange(48).reshape(2, 2, 12)
    np.testing.assert_array_equal(split_sequence(stack, 2, 1, axis=2), stack[:, :, 6:])
    np.testing.assert_array_equal(split_sequence(np.arange(5), 2, 1), np.arange(5))


def test_touch_audio_cp2_equals_world_one(tmp_path):
    """touch_audio reaches cp through modeling_llama.forward: bin.train.main
    on BEST-RQ shards at cp 2 (allgather; its packed features split on the
    sequence with the ids, labels and positions) gives the world-1 run's
    losses and grad norms over 3 steps (f32, rtol 1e-5 and 1e-4: the
    gathered keys and the reduce-scattered gradients sum in another
    order)."""
    from dist_workers import train_main
    from test_torch_touch_audio import _flags as audio_flags
    from test_torch_touch_audio import _shards

    from touchnet_tpu_torch.bin import train as ttrain

    listfile = _shards(tmp_path, count=16)
    want = ttrain.main(audio_flags(tmp_path / "one", listfile, 3),
                       device=torch.device("cpu")).metrics_processor.history
    got = spawn(train_main, 2, tmp_path, audio_flags(
        tmp_path / "cp2", listfile, 3, training_context_parallel_degree=2,
        training_data_parallel_shard_degree=1))
    for r in got:
        assert len(r["history"]) == 3
        for g, w in zip(r["history"], want):
            np.testing.assert_allclose(g["loss/per_sample"], w["loss/per_sample"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)


def _jax_trainer(argv, world, to_port):
    """The JAX Trainer on ``argv`` over ``world`` of the CPU devices
    (jax.device_count patched, as test_torch_parallel_train does): its
    params at init as the port's state dict (``to_port``), its logged
    training lines and its dev lines."""
    from touchnet_tpu.bin import TrainConfig as JTrainConfig
    from touchnet_tpu.bin.train import Trainer as JTrainer
    from touchnet_tpu.data import DataConfig as JDataConfig
    from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
    from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "device_count", lambda *a: world)
    gc_on = gc.isenabled()
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig], argv))
    try:
        init = to_port(jax.tree.map(np.asarray, jt.params))
        logs, dev = [], []
        jt.metrics_processor.log = lambda step, host: logs.append(dict(host))
        jt.metrics_processor.log_dev = lambda step, m: dev.append({"step": step, **m})
        jt.train()
    finally:
        jt.close()
        mp.undo()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()
    return init, logs, dev


def test_touch_audio_cp2_and_its_dev_lines_match_jax_trainer(tmp_path):
    """touch_audio at cp 2 (alltoall: the ring, over the packed features
    split on the sequence with the ids, labels and positions) through
    bin.train.main against the JAX Trainer at the same layout from the same
    init: 3 steps' losses, per-token losses and accuracies (rtol 1e-5) and
    grad norms (1e-4), and the dev lines after the saves at steps 1 and 3
    (the dev pass under the same split, rtol 1e-5)."""
    from dist_workers import train_main
    from test_torch_parallel_train import _seeded
    from test_torch_touch_audio import CFG as AUDIO_CFG
    from test_torch_touch_audio import _flags as audio_flags
    from test_torch_touch_audio import _shards

    from touchnet_tpu_torch.models.touch_audio import convert
    from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import (
        TouchAudioConfig,
    )

    listfile = _shards(tmp_path, count=16)
    kw = dict(audio_speed_perturb="false", datalist_dev_path=listfile,
              training_enable_ckpt="true", training_ckpt_interval=100,
              training_context_parallel_degree=2, training_data_parallel_shard_degree=1,
              training_context_parallel_rotate_method="alltoall")
    tcfg = TouchAudioConfig.from_json_file(AUDIO_CFG)
    init, want, want_dev = _jax_trainer(audio_flags(tmp_path / "jax", listfile, 3, **kw), 2,
                                        lambda p: convert.params_from_jax_numpy(p, tcfg))
    assert [d["step"] for d in want_dev] == [1, 3]
    _seeded(tmp_path / "port" / "exp", init)
    got = spawn(train_main, 2, tmp_path, audio_flags(tmp_path / "port", listfile, 3, **kw))
    for r, ranks in enumerate(got):
        assert len(ranks["history"]) == 3 and len(ranks["dev"]) == len(want_dev), r
        for step, (g, j) in enumerate(zip(ranks["history"], want), 1):
            for key, rtol in (("loss/per_sample", 1e-5), ("grad_norm", 1e-4),
                              ("loss/per_token", 1e-5), ("acc", 1e-5)):
                np.testing.assert_allclose(g[key], j[key], rtol=rtol,
                                           err_msg=f"rank {r} step {step} {key}")
        for g, j in zip(ranks["dev"], want_dev):
            assert g["step"] == j["step"]
            for key in ("loss_per_sample", "loss_per_token", "acc"):
                np.testing.assert_allclose(g[key], j[key], rtol=1e-5,
                                           err_msg=f"rank {r} dev step {g['step']} {key}")


def test_cp2_dev_and_resume(tmp_path):
    """The tiny Llama at cp 2 (alltoall) with sharded checkpoints (steps 1,
    2 and 4) and a dev pass after each: its losses and its dev lines (the dev pass runs
    under the same split) equal the one-process run's (rtol 1e-5); stopped
    by SIGTERM on rank 0 in step 2 and resumed at the same layout, steps
    3-4 give the straight run's losses and final params, moments and count
    bit for bit."""
    from dist_workers import train_main
    from test_torch_train import _flags, build_corpus

    from touchnet_tpu_torch.bin import train as ttrain

    listfile = build_corpus(tmp_path)
    kw = dict(datalist_dev_path=listfile, training_enable_ckpt="true",
              training_ckpt_interval=2)
    cp = dict(training_context_parallel_degree=2, training_data_parallel_shard_degree=1,
              training_context_parallel_rotate_method="alltoall")
    one = ttrain.main(_flags(tmp_path / "one", listfile, 4, **kw), device=torch.device("cpu"))
    (tmp_path / "straight").mkdir()
    straight = spawn(train_main, 2, tmp_path / "straight",
                     _flags(tmp_path / "straight", listfile, 4, **kw, **cp), True)
    mp = one.metrics_processor
    for r in straight:
        assert [d["step"] for d in r["dev"]] == [d["step"] for d in mp.dev_history] == [1, 2, 4]
        for g, w in zip(r["dev"] + r["history"], mp.dev_history + mp.history):
            for key in ("loss_per_sample", "loss/per_sample", "acc"):
                if key in w:
                    np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)
    argv = _flags(tmp_path, listfile, 4, **kw, **cp)
    first = spawn(train_main, 2, tmp_path, argv, False, 2)
    assert [r["step"] for r in first] == [2, 2]
    second = spawn(train_main, 2, tmp_path, argv, True)
    want = [h["loss/per_sample"] for h in straight[0]["history"]]
    for r in range(2):
        assert [h["loss/per_sample"] for h in first[r]["history"] + second[r]["history"]] == want
        for k, v in straight[0]["state"].items():
            np.testing.assert_array_equal(second[r]["state"][k], v, err_msg=k)
