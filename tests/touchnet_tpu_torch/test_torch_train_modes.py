# The trainer's single-device modes against the JAX trainer on the CPU, tiny
# Llama (tests/assets/config/tiny_llama.json), f32 compute:
#   - gradient accumulation (G=2): three steps of the port's train_step
#     against the JAX Trainer's jitted step (its lax.scan over microbatches)
#     on the same weights and stacked batches: losses rtol 1e-5, params
#     after the 3 steps within test_train_step_matches_assembled_jax_step's
#     limits (99.9 % of each tensor's entries within 1e-6, all within 1e-4);
#     the G=2 x B gradients against one flat 2B batch's within 1e-6
#     relative L2 (only the summation order differs), as JAX's
#     test_grad_accum_matches_large_batch; a resume under G=2 bit-exact;
#   - bf16 gradient reduction: the leaf gradients are bf16; their error
#     against the f32-reduce gradients at most 1.5x the error of JAX's
#     bf16 reduction (Trainer._value_and_grad) against JAX's f32 gradients
#     on the same weights and batch (both are one bf16 rounding of each
#     gradient, so the ratio sits near 1); under G=2 the bf16 gradients of
#     each microbatch add up in f32, as JAX's scan sums them, at the same
#     1.5x bound against JAX's G=2 bf16 reduction;
#   - CPU offload: on the CPU the flag changes nothing (the run equals the
#     resident one bit for bit, and a resume with it is bit-exact); the
#     streamed update's arithmetic on slices equals the whole-tensor update
#     bit for bit, and its pieces tile every tensor. The streamed path
#     itself (pinned memory, the copy stream) runs on the card only:
#     test_torch_kernels_cuda.py's test_streamed_adamw_equals_resident and
#     chip_smoke's phase 8.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.models.llama import head_weight as jhead_weight
from touchnet_tpu.models.llama import modeling_llama as jmodel
from touchnet_tpu.parallel import loss_parallel as jlp
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.ops import fused_adamw
from test_torch_checkpoint import _final_state, _run, _trainer, assert_state_equal
from test_torch_train import _configs, _flags, build_corpus

ROWS, T = 8, 32


def _batch(seed, vocab, rows=ROWS):
    """Packed rows (documents of 4-15 tokens, positions restarting at 0,
    segment ids from 1, a padding tail with ignored labels)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (rows, T)).astype(np.int32)
    labels = rng.integers(3, vocab, (rows, T)).astype(np.int32)
    seg = np.zeros((rows, T), np.int32)
    pos = np.zeros((rows, T), np.int32)
    slen = np.ones((rows, T), np.int32)
    docs = 0
    for b in range(rows):
        start, i = 0, 1
        while True:
            n = int(rng.integers(4, 16))
            if start + n > T - 3:
                break
            seg[b, start:start + n] = i
            pos[b, start:start + n] = np.arange(n)
            slen[b, start:start + n] = n
            start, i, docs = start + n, i + 1, docs + 1
        labels[b, start:] = -100
    return dict(input_ids=ids, labels=labels, attention_mask=seg, position_ids=pos,
                sentence_lens=slen), docs


def _stack(parts):
    """_AccumBatcher's group of host batches."""
    return {k: np.stack([p[0][k] for p in parts]) for k in parts[0][0]}, \
        sum(p[1] for p in parts)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_trainer(tmp_path, listfile, **over):
    return _trainer(_flags(tmp_path, listfile, 10,
                           **{"training_activation_checkpoint_mode": "none", **over}))


def _close(diff):
    return np.quantile(diff, 0.999) <= 1e-6 and diff.max() <= 1e-4


def test_grad_accum_matches_jax_trainer(tmp_path):
    """lr 1e-3: each Adam step moves a weight by ~lr whatever its gradient,
    so an entry whose gradient is within a few eps of zero moves by up to
    ~lr between two runs that differ in the gradients' last digits; over 3
    steps at lr 1e-2 that reached 7.5e-5 (41 of 8192 entries past 1e-6).
    At 1e-3 the decay, lr * wd * p ~ 8e-6, and the step itself still move
    every entry past 1e-6."""
    listfile = build_corpus(tmp_path)
    kw = dict(training_activation_checkpoint_mode="none", training_gradient_accumulation_steps=2,
              optimizer_lr=1e-3)
    jargv = _flags(tmp_path / "jax", listfile, 10, **kw)
    jtok, jdata, jjob = jparse([JTokenizerConfig, JDataConfig, JTrainConfig], jargv)
    jt = JTrainer(jtok, jdata, jjob)  # dp_shard 8 over the 8 CPU devices
    _, tcfg = _configs()
    trainer = _port_trainer(tmp_path / "port", listfile, **kw)
    try:
        trainer.model.load_state_dict(
            params_from_jax_numpy(jax.tree.map(np.asarray, jt.params), tcfg))
        params, opt = jt.params, jt.opt_state
        for step in range(1, 4):
            batch, ns = _stack([_batch(10 * step + g, tcfg.vocab_size) for g in range(2)])
            db, jns = jt._put_batch({**batch, "num_sentence": ns})
            params, opt, jm = jt.train_step_fn(params, opt, db, jns, step)
            tm = trainer.train_step(_torch(batch), float(ns))
            for key in ("loss/per_sample", "loss/per_token", "acc"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                           err_msg=f"step {step} {key}")
        assert int(trainer.count) == 3
        want = params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg)
        for name, p in trainer.model.state_dict().items():
            diff = np.abs(p.numpy() - want[name].numpy())
            assert _close(diff), (name, diff.max())
    finally:
        jt.close()
        trainer.close()


def test_grad_accum_matches_large_batch(tmp_path):
    """G=2 microbatches of B rows against one flat 2B batch: the gradients
    within 1e-6 relative L2, the per-sample loss rtol 1e-6."""
    listfile = build_corpus(tmp_path)
    flat_t = _port_trainer(tmp_path / "flat", listfile)
    acc_t = _port_trainer(tmp_path / "acc", listfile, training_gradient_accumulation_steps=2)
    acc_t.model.load_state_dict(flat_t.model.state_dict())
    try:
        _, tcfg = _configs()
        parts = [_batch(g, tcfg.vocab_size, rows=4) for g in range(2)]
        stacked, ns = _stack(parts)
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in stacked.items()}
        g1, l1, _, _ = flat_t._grads_and_metrics(_torch(flat), float(ns))
        g2, l2, _, _ = acc_t._grads_and_metrics(_torch(stacked), float(ns))
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
        a, b = torch.cat([g.flatten() for g in g1]), torch.cat([g.flatten() for g in g2])
        assert float((a - b).norm() / a.norm()) <= 1e-6
    finally:
        flat_t.close()
        acc_t.close()


def _state(trainer):
    return {k: v.clone() for k, v in {**trainer.model.state_dict(),
                                       **trainer._opt_state()}.items()}


@pytest.mark.parametrize("over", [
    {"training_gradient_accumulation_steps": 2},
    {"training_enable_cpu_offload": "true"},
], ids=["accum2", "offload"])
def test_mode_resume_is_bit_exact(tmp_path, over):
    """4 steps straight against 2 steps, a save, and a new Trainer for steps
    3-4: every logged loss and the final params, moments, count and loader
    state bit-equal (under G=2 the checkpoint holds the loader after the
    whole group)."""
    listfile = build_corpus(tmp_path)
    kw = dict(training_enable_ckpt="true", training_ckpt_interval=100,
              dataloader_device_prefetch=2, **over)
    straight = _trainer(_flags(tmp_path / "a", listfile, 4, **kw))
    want_losses = _run(straight)
    want = _final_state(straight)
    first = _trainer(_flags(tmp_path / "b", listfile, 4, **kw))
    losses = _run(first, stop_at=2)
    second = _trainer(_flags(tmp_path / "b", listfile, 4, **kw))
    assert second.step == 2 and int(second.count) == 2
    losses += _run(second)
    assert losses == want_losses and len(losses) == 4
    got = _final_state(second)
    assert_state_equal(got[0], want[0])
    assert_state_equal(got[1], want[1])
    assert got[2] == want[2]


def test_cpu_offload_changes_nothing_on_the_cpu(tmp_path, monkeypatch):
    listfile = build_corpus(tmp_path)
    lines = []
    monkeypatch.setattr(ttrain.logger, "info", lambda msg, *a, **k: lines.append(str(msg)))
    runs = {}
    for tag, over in (("resident", {}), ("offload", {"training_enable_cpu_offload": "true"})):
        trainer = _trainer(_flags(tmp_path / tag, listfile, 3, **over))
        runs[tag] = _run(trainer), _state(trainer)
    assert runs["resident"][0] == runs["offload"][0]
    assert_state_equal(runs["resident"][1], runs["offload"][1])
    assert any("cpu offload" in ln and "changes nothing" in ln for ln in lines)


def test_streamed_update_on_slices_is_bit_exact():
    """The streamed step's pieces tile every tensor, and the update applied
    slice by slice equals the whole-tensor update bit for bit."""
    sizes = [5, 37, 64, 1]
    got = {}
    for i, a, b in fused_adamw.stream_pieces(sizes, 16):
        got.setdefault(i, []).append((a, b))
    for i, n in enumerate(sizes):
        spans = got[i]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(x[1] == y[0] and x[1] - x[0] <= 16 for x, y in zip(spans, spans[1:]))
    gen = torch.Generator().manual_seed(0)
    g, p, m, v = (torch.randn(100, generator=gen) for _ in range(4))
    v = v.abs()
    hp = fused_adamw._Hyper(torch.tensor(3, dtype=torch.int32), 1e-2, 0.9, 0.95, 1e-8, 0.1,
                            torch.tensor(0.7), torch.tensor(True))
    whole = [t.clone() for t in (p, m, v)]
    hp.update(g, *whole)
    pieces = [t.clone() for t in (p, m, v)]
    for _, a, b in fused_adamw.stream_pieces([100], 32):
        hp.update(g[a:b], *(t[a:b] for t in pieces))
    for x, y in zip(whole, pieces):
        assert torch.equal(x, y)


def _jax_loss_fn(jcfg):
    def loss_fn(params, b, n):
        hidden = jmodel.forward(
            params, input_ids=b["input_ids"], segment_ids=b["attention_mask"],
            position_ids=b["position_ids"], config=jcfg, compute_dtype=jnp.float32,
            return_hidden=True)
        out = jlp.fused_linear_cross_entropy(
            hidden, jhead_weight(params, jcfg), b["labels"], b["sentence_lens"], n,
            compute_dtype=jnp.float32)
        return out[0], (out[1], out[2])
    return loss_fn


def _jax_grads(jcfg, tcfg, jparams, microbatches, ns):
    """JAX's gradients of the step for each reduce dtype: Trainer._value_and_grad
    per microbatch, summed in f32 from zeros as the accumulation scan
    (touchnet_tpu/bin/train.py _grads_and_metrics) sums them."""
    grads = {}
    for reduce in ("float32", "bfloat16"):
        fake = type("T", (), {"job_config": JTrainConfig(training_mixed_precision_reduce=reduce)})
        vg = JTrainer._value_and_grad(fake, _jax_loss_fn(jcfg))
        acc = jax.tree.map(jnp.zeros_like, jparams)
        for mb in microbatches:
            _, jg = vg(jparams, {k: jnp.asarray(v) for k, v in mb.items()},
                       jnp.asarray(ns, jnp.float32))
            acc = jax.tree.map(jnp.add, acc, jg)
        grads[reduce] = params_from_jax_numpy(jax.tree.map(np.asarray, acc), tcfg)
    return grads


def _flat(gs):
    return np.concatenate([np.asarray(g, np.float64).ravel() for g in gs])


def _rel_errs(grads, names, g16, g32):
    """(port's bf16-reduce error, JAX's), each against its f32-reduce gradients."""
    ref = _flat(grads["float32"][n].numpy() for n in names)
    j_err = np.linalg.norm(_flat(grads["bfloat16"][n].numpy() for n in names) - ref) / \
        np.linalg.norm(ref)
    t_err = np.linalg.norm(_flat(g.float().numpy() for g in g16) - _flat(
        g.numpy() for g in g32)) / np.linalg.norm(ref)
    return t_err, j_err


def _init_pair(tmp_path, listfile, **over):
    """f32-reduce and bf16-reduce port trainers on one JAX init."""
    jcfg, tcfg = _configs()
    f32_t = _port_trainer(tmp_path / "f32", listfile, **over)
    bf_t = _port_trainer(tmp_path / "bf16", listfile,
                         training_mixed_precision_reduce="bfloat16", **over)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    state = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    f32_t.model.load_state_dict(state)
    bf_t.model.load_state_dict(state)
    return jcfg, tcfg, jparams, f32_t, bf_t


def test_bf16_reduce_gradients(tmp_path):
    listfile = build_corpus(tmp_path)
    jcfg, tcfg, jparams, f32_t, bf_t = _init_pair(tmp_path, listfile)
    batch, ns = _batch(7, tcfg.vocab_size, rows=2)
    try:
        g32, l32, _, _ = f32_t._grads_and_metrics(_torch(batch), float(ns))
        g16, l16, _, _ = bf_t._grads_and_metrics(_torch(batch), float(ns))
        assert all(g.dtype == torch.bfloat16 for g in g16)
        assert all(p.grad is None for p in bf_t.params)  # the masters get none
        np.testing.assert_allclose(float(l16), float(l32), rtol=1e-2)
    finally:
        f32_t.close()
        bf_t.close()
    grads = _jax_grads(jcfg, tcfg, jparams, [batch], ns)
    t_err, j_err = _rel_errs(grads, f32_t.param_names, g16, g32)
    assert 0 < t_err <= 1.5 * j_err, (t_err, j_err)


def test_bf16_reduce_accumulates_in_f32(tmp_path):
    """G=2 under bf16 reduction: the step's gradients are f32, bit-equal to
    the f32 sum of the two microbatches' bf16 gradients (each taken alone at
    G=1 with the group's sentence count), and their error against the
    f32-reduce G=2 gradients is at most 1.5x the error of JAX's G=2 bf16
    reduction against its f32 one."""
    listfile = build_corpus(tmp_path)
    jcfg, tcfg, jparams, f32_t, bf_t = _init_pair(
        tmp_path, listfile, training_gradient_accumulation_steps=2)
    one_t = _port_trainer(tmp_path / "one", listfile, training_mixed_precision_reduce="bfloat16")
    one_t.model.load_state_dict(bf_t.model.state_dict())
    parts = [_batch(20 + g, tcfg.vocab_size, rows=2) for g in range(2)]
    stacked, ns = _stack(parts)
    try:
        g32, _, _, _ = f32_t._grads_and_metrics(_torch(stacked), float(ns))
        g16, _, _, _ = bf_t._grads_and_metrics(_torch(stacked), float(ns))
        assert all(g.dtype == torch.float32 for g in g16)
        per_mb = [one_t._grads_and_metrics({k: v[g] for k, v in _torch(stacked).items()},
                                           float(ns))[0] for g in range(2)]
        for got, a, b in zip(g16, *per_mb):
            assert a.dtype == torch.bfloat16
            assert torch.equal(got, a.float() + b.float())
    finally:
        f32_t.close()
        bf_t.close()
        one_t.close()
    grads = _jax_grads(jcfg, tcfg, jparams, [p[0] for p in parts], ns)
    t_err, j_err = _rel_errs(grads, f32_t.param_names, g16, g32)
    assert 0 < t_err <= 1.5 * j_err, (t_err, j_err)
