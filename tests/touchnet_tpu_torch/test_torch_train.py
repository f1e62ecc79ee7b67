# The port's training slice against the JAX package on the CPU, tiny Llama
# (tests/assets/config/tiny_llama.json), f32 throughout:
#   - the training forward (logits and final hidden) against JAX forward for
#     every remat mode (remat must not change values: atol 2e-5, float
#     rounding of two frameworks' matmuls over 2 layers at unit scale); for
#     the modes that save named residuals also the gradients against
#     jax.grad of the same mode, and what the backward re-runs (K1's op,
#     the named projections);
#   - one train step (forward + fused linear CE + backward + clip + AdamW)
#     against a JAX step assembled from the JAX functions on the same weights
#     and batch: loss and grad norm rtol 1e-5; params after the step: 99.9 %
#     of each tensor's entries within 1e-6 and all within 1e-4. The first
#     Adam step moves each weight by lr = 1e-2 times g / (|g| + eps) plus
#     the decay lr * wd * p (~2e-5), so it is insensitive to the gradients'
#     last digits except for the few entries with |g| within a few eps =
#     1e-8 of zero (one of 8192 moved 1.7e-5); a fault in the decay or the
#     lr moves every entry by more than 1e-6;
#   - the causal_lm loader: the first 3 batches identical to the JAX
#     loader's on the same DataBuilder shards;
#   - bin.train.main on the tiny config: the loss drops over 8 steps,
#     op_small gives the losses of no remat, each parallel degree raises
#     in one process (dp and tp do not fit a world of 1; cp and pp are
#     later slices; the multi-process runs are test_torch_parallel_train),
#     and each single-device mode runs.

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.data.dataloader import build_dataloader as jbuild_dataloader
from touchnet_tpu.models.llama import head_weight as jhead_weight
from touchnet_tpu.models.llama import modeling_llama as jmodel
from touchnet_tpu.models.llama.configuration_llama import LlamaConfig as JLlamaConfig
from touchnet_tpu.ops.fused_adamw import fused_adamw_step as jadamw
from touchnet_tpu.parallel import loss_parallel as jlp
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.tokenizer.tokenizer import build_tokenizer as jbuild_tokenizer
from touchnet_tpu.utils.optimizer import build_lr_schedule as jschedule
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.bin.make_data import DataBuilder
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data.dataloader import build_dataloader
from touchnet_tpu_torch.models.llama import modeling_llama as tmodel
from touchnet_tpu_torch.models.llama.configuration_llama import LlamaConfig
from touchnet_tpu_torch.models.llama.convert import params_from_jax_numpy
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer

CFG = os.path.join(os.path.dirname(__file__), "..", "assets", "config", "tiny_llama.json")
B, T = 2, 32


def _configs():
    return JLlamaConfig.from_json_file(CFG), LlamaConfig.from_json_file(CFG)


def _weights(jcfg, tcfg):
    """JAX init from a key, converted into the port's trainable model."""
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = tmodel.empty_model(tcfg, device="cpu", requires_grad=True, train=True)
    model.load_state_dict(params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return jparams, model


def _packed_batch(seed, vocab):
    """Packed rows: documents with positions restarting at 0, segment ids
    1, 2, 3, a padding tail (segment 0, ignored labels), sentence_lens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (B, T)).astype(np.int32)
    labels = rng.integers(3, vocab, (B, T)).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    slen = np.ones((B, T), np.int32)
    lens = [[9, 12, 7], [20, 8]]
    for b, row in enumerate(lens):
        start = 0
        for i, n in enumerate(row):
            seg[b, start:start + n] = i + 1
            pos[b, start:start + n] = np.arange(n)
            slen[b, start:start + n] = n
            start += n
        labels[b, start:] = -100
    return dict(input_ids=ids, labels=labels, attention_mask=seg, position_ids=pos,
                sentence_lens=slen), float(sum(len(r) for r in lens))


def test_init_params_trainable_choice():
    _, tcfg = _configs()
    serving = tmodel.init_params(tcfg, torch.Generator().manual_seed(0))
    assert not serving.training
    assert not any(p.requires_grad for p in serving.parameters())
    trainable = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                   requires_grad=True, train=True)
    assert trainable.training
    assert all(p.requires_grad for p in trainable.parameters())
    for a, b in zip(serving.parameters(), trainable.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # same draws


@pytest.mark.parametrize("remat,opt", [("none", "op"), ("full", "op"), ("selective", "1"),
                                       ("selective", "2")])
def test_forward_matches_jax(remat, opt):
    jcfg, tcfg = _configs()
    jparams, model = _weights(jcfg, tcfg)
    batch, _ = _packed_batch(1, tcfg.vocab_size)
    jkw = dict(input_ids=jnp.asarray(batch["input_ids"]),
               segment_ids=jnp.asarray(batch["attention_mask"]),
               position_ids=jnp.asarray(batch["position_ids"]), config=jcfg,
               compute_dtype=jnp.float32)
    tkw = dict(input_ids=torch.from_numpy(batch["input_ids"]),
               segment_ids=torch.from_numpy(batch["attention_mask"]),
               position_ids=torch.from_numpy(batch["position_ids"]), config=tcfg,
               compute_dtype=torch.float32, remat_mode=remat, selective_ac_option=opt)
    for hidden in (False, True):
        want = jmodel.forward(jparams, return_hidden=hidden, **jkw)
        got = tmodel.forward(model, return_hidden=hidden, **tkw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    # and the gradients do not depend on the remat mode
    logits = tmodel.forward(model, **tkw)
    logits.square().mean().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    tkw.update(remat_mode="none")
    tmodel.forward(model, **tkw).square().mean().backward()
    for a, p in zip(grads, model.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["flash", "eager"])
def test_training_forward_ignores_attn_implementation(impl, monkeypatch):
    """The training forward reads no attn_implementation (as serving): an
    "eager" config attends through the same kernel wrapper, once per layer,
    so CUDA tensors always reach K1 and K2."""
    _, tcfg = _configs()
    cfg = LlamaConfig.from_dict({**tcfg.__dict__, "attn_implementation": impl})
    calls = []
    wrapper = tmodel.attn_ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return wrapper(*a, **kw)

    monkeypatch.setattr(tmodel.attn_ops, "flash_attention", counted)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    tmodel.forward(model, input_ids=torch.zeros((1, 8), dtype=torch.int32), config=cfg,
                   compute_dtype=torch.float32)
    assert cfg.attn_implementation == impl
    assert len(calls) == cfg.num_hidden_layers


RESIDUAL_MODES = [("op", "2"), ("op_small", "2"), ("op_names", "2"),
                  ("save:flash_out,dot_q", "2"), ("selective", "op"),
                  ("selective", "op_every_2"), ("op", "full_every_2")]


@pytest.mark.parametrize("remat,opt", RESIDUAL_MODES)
def test_residual_saving_remat_matches_jax(remat, opt):
    """Each mode that saves named residuals against JAX's same mode on the
    same weights: the f32 forward at atol 2e-5 (as test_forward_matches_jax),
    and the gradients of sum(logits * r) per tensor within 1e-5 of the
    tensor's largest gradient (remat changes no value; only the two
    frameworks' summation orders differ)."""
    jcfg, tcfg = _configs()
    jparams, model = _weights(jcfg, tcfg)
    batch, _ = _packed_batch(3, tcfg.vocab_size)
    r = np.random.default_rng(4).standard_normal((B, T, tcfg.vocab_size)).astype(np.float32)
    jkw = dict(input_ids=jnp.asarray(batch["input_ids"]),
               segment_ids=jnp.asarray(batch["attention_mask"]),
               position_ids=jnp.asarray(batch["position_ids"]), config=jcfg,
               compute_dtype=jnp.float32, remat_mode=remat, selective_ac_option=opt)

    def jloss(params):
        logits = jmodel.forward(params, **jkw)
        return (logits * jnp.asarray(r)).sum(), logits

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    logits = tmodel.forward(
        model, input_ids=torch.from_numpy(batch["input_ids"]),
        segment_ids=torch.from_numpy(batch["attention_mask"]),
        position_ids=torch.from_numpy(batch["position_ids"]), config=tcfg,
        compute_dtype=torch.float32, remat_mode=remat, selective_ac_option=opt)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), atol=2e-5)
    (logits * torch.from_numpy(r)).sum().backward()
    jg = params_from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        ref = jg[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (name, err, np.abs(ref).max())


class _CountRecompute(TorchDispatchMode):
    """Counts, while open, the K1 op calls and the tagged projection
    matmuls that run. Opened around backward(): a residual the checkpoint
    policy saved is handed back by the checkpoint's own mode, above this
    one, and never reaches it."""

    def __init__(self):
        super().__init__()
        self.flash = 0
        self.dots = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is tmodel.attn_ops.FLASH_FWD_OP:
            self.flash += 1
        elif func in tmodel._MATMULS and tmodel._TAG.name:
            self.dots[tmodel._TAG.name] = self.dots.get(tmodel._TAG.name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat,opt", [("op_small", "2"), ("op", "2"), ("full", "2"),
                                       ("selective", "op"), ("op", "full_every_2")])
def test_remat_recompute_counts(remat, opt):
    """What the backward re-runs: K1's op never under op_small, op and
    selective + "op" (its (out, lse) are saved), once per layer under full,
    on the full-every-2 layers only under op + full_every_2; op_small
    re-runs the gate and up matmuls but no q/k/v/o projection, op none."""
    _, tcfg = _configs()
    L = tcfg.num_hidden_layers
    model = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), requires_grad=True,
                               train=True)
    batch, _ = _packed_batch(5, tcfg.vocab_size)
    logits = tmodel.forward(
        model, input_ids=torch.from_numpy(batch["input_ids"]),
        segment_ids=torch.from_numpy(batch["attention_mask"]),
        position_ids=torch.from_numpy(batch["position_ids"]), config=tcfg,
        compute_dtype=torch.float32, remat_mode=remat, selective_ac_option=opt)
    with _CountRecompute() as counts:
        logits.square().mean().backward()
    want_flash = {"full": L, "op": -(-L // 2) if opt == "full_every_2" else 0}.get(remat, 0)
    assert counts.flash == want_flash, counts.flash
    attn_dots = sum(counts.dots.get(n, 0) for n in tmodel.ATTN_DOTS)
    if remat == "op_small":
        assert attn_dots == 0 and counts.dots["dot_gate"] == counts.dots["dot_up"] == L
    if remat == "op" and opt == "2":
        assert not counts.dots, counts.dots
    if remat == "full":
        assert attn_dots == 4 * L, counts.dots


@pytest.mark.parametrize("remat,opt,layers,want", [
    ("none", "op", 3, [False] * 3),
    ("full", "op", 3, [True] * 3),
    ("selective", "1", 3, [True] * 3),
    ("selective", "2", 5, [True, False, True, False, True]),
    ("selective", "3", 4, [True, False, False, True]),
])
def test_remat_layer_choice(remat, opt, layers, want):
    """The checkpointed layers are scan_layers' choice: every layer under
    "full", those with index % k == 0 under "selective" + k (the JAX
    _selective_layer_freq gives the same k), each recomputed whole."""
    assert tmodel.remat_layers(remat, opt, layers) == [tmodel.FULL if w else None
                                                       for w in want]
    if remat == "selective":
        assert jmodel._selective_layer_freq(remat, opt) == int(opt)


@pytest.mark.parametrize("remat,opt", [("selective", "0"), ("selective", "full_every_2"),
                                       ("selective", "two"), ("recompute", "2")])
def test_bad_remat_options_raise(remat, opt):
    with pytest.raises(ValueError):
        tmodel.remat_layers(remat, opt, 4)


def _flags(tmp_path, listfile, steps, **over):
    args = {
        "tokenizer_type": "RawTokenizer",
        "tokenizer_raw_vocab_size": "64",
        "datapipe_type": "causal_lm",
        "datalist_path": listfile,
        "datalist_epoch": "100",
        "dataset_batchsize": "1",
        "dataset_text_seqlen": "128",
        "dataloader_num_workers": "1",
        "training_model_name": "llama",
        "training_model_config_path": CFG,
        "training_trace_dump_folder": str(tmp_path / "exp"),
        "training_log_freq": "1",
        "training_seed": "0",
        "training_activation_checkpoint_mode": "full",
        "training_mixed_precision_param": "float32",
        "training_enable_liger_kernel": "true",
        "lr_scheduler_steps": str(steps),
        "lr_scheduler_warmup_steps": "2",
        "optimizer_lr": "1e-2",
    }
    args.update({k: str(v) for k, v in over.items()})
    return [x for k, v in args.items() for x in (f"--{k}", v)]


def build_corpus(tmp_path, num_shards=4, samples=64, vocab=64, maxlen=30):
    """tests/touchnet_tpu/bin/test_train.py's corpus, through the port's
    DataBuilder: ascending ids mod the vocab."""
    rng = np.random.default_rng(0)
    paths = []
    for s in range(num_shards):
        d = tmp_path / f"{s:09d}"
        d.mkdir()
        b = DataBuilder(str(d / "texttoken.bin"), np.int32)
        for _ in range(samples):
            n = rng.integers(5, maxlen)
            start = rng.integers(3, vocab)
            b.add_item((np.arange(n) + start) % (vocab - 3) + 3)
            b.end_document()
        b.finalize(str(d / "texttoken.idx"))
        paths.append(str(d))
    listfile = tmp_path / "data.list"
    listfile.write_text("".join(f"{p} texttoken\n" for p in paths))
    return str(listfile)


def test_train_step_matches_assembled_jax_step(tmp_path):
    listfile = build_corpus(tmp_path)
    argv = _flags(tmp_path, listfile, 10, training_activation_checkpoint_mode="none")
    tok, data, job = ttrain.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, ttrain.TrainConfig], argv)
    trainer = ttrain.Trainer(tok, data, job, device=torch.device("cpu"))
    jcfg, tcfg = _configs()
    jparams, model = _weights(jcfg, tcfg)
    trainer.model.load_state_dict(model.state_dict())
    batch, ns = _packed_batch(2, tcfg.vocab_size)

    def loss_fn(params):
        hidden = jmodel.forward(
            params, input_ids=jnp.asarray(batch["input_ids"]),
            segment_ids=jnp.asarray(batch["attention_mask"]),
            position_ids=jnp.asarray(batch["position_ids"]), config=jcfg,
            compute_dtype=jnp.float32, return_hidden=True)
        return jlp.fused_linear_cross_entropy(
            hidden, jhead_weight(params, jcfg), jnp.asarray(batch["labels"]),
            jnp.asarray(batch["sentence_lens"]), jnp.asarray(ns),
            compute_dtype=jnp.float32)[0]

    loss, grads = jax.value_and_grad(loss_fn)(jparams)
    gnorm = optax.global_norm(grads)
    jjob = JTrainConfig(optimizer_lr=1e-2, lr_scheduler_steps=10, lr_scheduler_warmup_steps=2)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    new_params, _, _, _ = jadamw(
        grads, jparams, zeros, zeros, jnp.asarray(0, jnp.int32),
        lr=jschedule(jjob)(0), clip_scale=jnp.minimum(1.0, 1.0 / (gnorm + 1e-6)),
        finite=jnp.isfinite(gnorm))

    metrics = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, ns)
    np.testing.assert_allclose(metrics["loss/per_sample"].item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(gnorm), rtol=1e-5)
    assert float(gnorm) > 1.0  # the clip engaged
    assert int(trainer.count) == 1
    want = params_from_jax_numpy(jax.tree.map(np.asarray, new_params), tcfg)
    for name, p in trainer.model.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert np.quantile(diff, 0.999) <= 1e-6 and diff.max() <= 1e-4, (name, diff.max())


def test_causal_lm_loader_matches_jax(tmp_path):
    listfile = build_corpus(tmp_path)
    kw = dict(datapipe_type="causal_lm", datalist_path=listfile, datalist_epoch=2,
              dataset_batchsize=2, dataset_text_seqlen=64, dataloader_num_workers=2)
    tkw = dict(tokenizer_type="RawTokenizer", tokenizer_raw_vocab_size=64)
    ours = build_dataloader(DataConfig(**kw), build_tokenizer(TokenizerConfig(**tkw)), 0, 1)
    theirs = jbuild_dataloader(JDataConfig(**kw), jbuild_tokenizer(JTokenizerConfig(**tkw)),
                               0, 1)
    try:
        for n, (a, b) in enumerate(zip(ours, theirs)):
            assert a.keys() == b.keys()
            assert a["num_sentence"] == b["num_sentence"] > 0
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype == np.int32
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k]
            if n == 2:
                break
        assert n == 2
    finally:
        ours.shutdown()
        theirs.shutdown()


def test_trainer_main_loss_drops(tmp_path):
    listfile = build_corpus(tmp_path)
    trainer = ttrain.main(_flags(tmp_path, listfile, 8), device=torch.device("cpu"))
    losses = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
    assert trainer.step == 8 and len(losses) == 8
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses
    assert (tmp_path / "exp" / "train_config.json").exists()


# the single-device modes (since the slice that ported them) run; in one
# process every parallel degree raises: dp and tp do not fit its world of 1,
# cp and pp are still later slices
SINGLE_DEVICE_MODES = ("training_gradient_accumulation_steps",
                       "training_mixed_precision_reduce", "training_enable_cpu_offload")


@pytest.mark.parametrize("flag,value", [
    ("training_tensor_parallel_degree", 2),
    ("training_data_parallel_shard_degree", 2),
    ("training_context_parallel_degree", 2),
    ("training_pipeline_parallel_degree", 2),
    ("training_data_parallel_replicate_degree", 2),
    ("training_gradient_accumulation_steps", 2),
    ("training_mixed_precision_reduce", "bfloat16"),
    ("training_enable_cpu_offload", "true"),
])
def test_trainer_rejects_later_slices(tmp_path, flag, value):
    """A parallel degree above 1 raises naming its flag (without a process
    group: the world is 1); each single-device mode runs 2 CPU steps with
    finite losses."""
    if flag not in SINGLE_DEVICE_MODES:
        with pytest.raises(ValueError, match=flag):
            ttrain.main(_flags(tmp_path, "unused.list", 2, **{flag: value}),
                        device=torch.device("cpu"))
        return
    listfile = build_corpus(tmp_path)
    trainer = ttrain.main(_flags(tmp_path, listfile, 2, **{flag: value}),
                          device=torch.device("cpu"))
    losses = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
    assert trainer.step == 2 and len(losses) == 2 and all(np.isfinite(losses))


def test_trainer_op_small_equals_none(tmp_path):
    """bin.train.main under the recipe's op_small: the losses of 3 steps
    equal those without remat bit for bit (the recompute gives the same
    values on the CPU)."""
    listfile = build_corpus(tmp_path)
    losses = {}
    for mode in ("op_small", "none"):
        trainer = ttrain.main(_flags(tmp_path / mode, listfile, 3,
                                     training_activation_checkpoint_mode=mode),
                              device=torch.device("cpu"))
        losses[mode] = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
    assert len(losses["none"]) == 3
    assert losses["op_small"] == losses["none"]


def test_kimi_audio_train_spec_matches_jax():
    """The kimi_audio TrainSpec as JAX's (touchnet_tpu/models/kimi_audio/
    __init__.py:22-43): data-parallel only, the four kimi batch keys, no
    head weight (so the liger flag leaves the full-logits loss), the frozen
    regex text; plus the mel-bin check JAX lacks."""
    from touchnet_tpu.utils.train_spec import get_train_spec as jget_train_spec
    from touchnet_tpu_torch.models.kimi_audio import check_mel_bins
    from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
    from touchnet_tpu_torch.utils.train_spec import get_train_spec

    ours, theirs = get_train_spec("kimi_audio"), jget_train_spec("kimi_audio")
    assert ours.dp_only and theirs.dp_only
    assert ours.forward_batch_keys == theirs.forward_batch_keys
    assert ours.frozen_params_re == theirs.frozen_params_re == (r"speech_tokenizer/.*",)
    assert ours.head_weight_fn is None and theirs.head_weight_fn is None
    assert ours.additional_pre_init_fn is check_mel_bins
    cfg = KimiAudioConfig.from_json_file(os.path.join(
        os.path.dirname(__file__), "..", "..", "examples/audio/sft/asr/wenetspeech/config/"
        "Kimi-Audio-7B.json"))
    check_mel_bins(cfg, DataConfig(audiofeat_num_mel_bins=128))
    with pytest.raises(ValueError, match="takes 128 mel bins"):
        check_mel_bins(cfg, DataConfig(audiofeat_num_mel_bins=80))
