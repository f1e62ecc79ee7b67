# The port's TouchAudioForCausalLM and its training path against the JAX
# package on the CPU, tiny config (tests/assets/config/tiny_touch_audio.json,
# read-only: input 161 = 23 mel bins x stack 7, the DataConfig defaults),
# f32:
#   - the forward from weights carried over from JAX init_params
#     (convert.params_from_jax_numpy): logits and final hidden at atol 2e-5
#     (as test_torch_train.py), for features only, ids only and both; the
#     gradients of sum(logits * r) per tensor within 1e-5 of the tensor's
#     largest (rtol 1e-5, as test_torch_train.py);
#   - get_num_params and the init's parameter count, the init's
#     distributions, and its generator's device;
#   - one trainer step on a batch of a BEST-RQ shard against the JAX
#     Trainer's jitted step on the same weights: loss and grad norm rtol
#     1e-5; and bin.train.main on such shards: losses finite, falling;
#   - the HF converters: the port's state dict -> HF -> the port exactly;
#     a text backbone's HF directory -> convert_hf_to_ckpt --model_type
#     touch_audio -> a step_0 whose language model is that backbone and
#     whose projector is a fresh draw; the trainer's checkpoint ->
#     convert_ckpt_to_hf --model_type touch_audio -> the trained tensors bit
#     for bit, with a config.json both packages load;
#   - features whose width is not the projector's raise at setup, in the
#     trainer and in the CLI (the SFT recipe's log-mel 128 x stack 7).

import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.models.touch_audio import modeling_touch_audio as jmodel
from touchnet_tpu.models.touch_audio.configuration_touch_audio import (
    TouchAudioConfig as JTouchAudioConfig,
)
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import convert_ckpt_to_hf, convert_hf_to_ckpt
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.bin.convert_ckpt_to_hf import read_model
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.models.touch_audio import check_feature_width, convert
from touchnet_tpu_torch.models.touch_audio import modeling_touch_audio as tmodel
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import TouchAudioConfig
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors
from test_torch_audio_frontend import build_audio_shards, write_audio_jsonl

CFG = os.path.join(os.path.dirname(__file__), "..", "assets", "config", "tiny_touch_audio.json")
ROWS, T = 8, 32


def _configs():
    return JTouchAudioConfig.from_json_file(CFG), TouchAudioConfig.from_json_file(CFG)


def _weights(jcfg, tcfg):
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = tmodel.empty_model(tcfg, device="cpu", requires_grad=True, train=True)
    model.load_state_dict(convert.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return jparams, model


def _batch(seed, tcfg, audio=True, text=True):
    """Packed rows: audio spans (features, pad ids) then text spans (ids,
    zero features) per document, segment ids from 1, positions restarting."""
    rng = np.random.default_rng(seed)
    V, F = tcfg.text_config.vocab_size, tcfg.audio_config.input_size
    ids = rng.integers(3, V, (2, T)).astype(np.int32)
    feats = rng.standard_normal((2, T, F)).astype(np.float32)
    seg = np.zeros((2, T), np.int32)
    pos = np.zeros((2, T), np.int32)
    for b, docs in enumerate([[(6, 4), (9, 5)], [(14, 6)]]):
        start = 0
        for i, (na, nt) in enumerate(docs):
            ids[b, start:start + na] = 0
            feats[b, start + na:start + na + nt] = 0.0
            seg[b, start:start + na + nt] = i + 1
            pos[b, start:start + na + nt] = np.arange(na + nt)
            start += na + nt
    out = dict(segment_ids=seg, position_ids=pos)
    if audio:
        out["input_features"] = feats
    if text:
        out["input_ids"] = ids
    return out


@pytest.mark.parametrize("audio,text", [(True, False), (False, True), (True, True)],
                         ids=["features", "ids", "both"])
def test_forward_and_grads_match_jax(audio, text):
    jcfg, tcfg = _configs()
    jparams, model = _weights(jcfg, tcfg)
    batch = _batch(1, tcfg, audio, text)
    V = tcfg.text_config.vocab_size
    r = np.random.default_rng(2).standard_normal((2, T, V)).astype(np.float32)
    for hidden in (False, True):
        want = jmodel.forward(jparams, config=jcfg, compute_dtype=jnp.float32,
                              return_hidden=hidden,
                              **{k: jnp.asarray(v) for k, v in batch.items()})
        got = tmodel.forward(model, config=tcfg, compute_dtype=torch.float32,
                             return_hidden=hidden,
                             **{k: torch.from_numpy(v) for k, v in batch.items()})
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)

    def jloss(params):
        logits = jmodel.forward(params, config=jcfg, compute_dtype=jnp.float32,
                                **{k: jnp.asarray(v) for k, v in batch.items()})
        return (logits * jnp.asarray(r)).sum()

    jgrads = jax.grad(jloss)(jparams)
    logits = tmodel.forward(model, config=tcfg, compute_dtype=torch.float32,
                            **{k: torch.from_numpy(v) for k, v in batch.items()})
    (logits * torch.from_numpy(r)).sum().backward()
    want = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        if p.grad is None:  # a weight the inputs do not reach (the projector
            assert not ref.any(), name  # without features, the embedding without ids)
            continue
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_forward_needs_an_input():
    _, tcfg = _configs()
    model = tmodel.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="input_ids and/or input_features"):
        tmodel.forward(model, config=tcfg, compute_dtype=torch.float32)


def test_num_params_and_init():
    jcfg, tcfg = _configs()
    model = tmodel.init_params(tcfg, torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    assert n == tmodel.get_num_params(tcfg) == jmodel.get_num_params(jcfg)
    assert tmodel.get_num_params(tcfg, exclude_embedding=True) == \
        jmodel.get_num_params(jcfg, exclude_embedding=True)
    assert tmodel.get_num_flop_per_token(1000, tcfg, 64) == \
        jmodel.get_num_flop_per_token(1000, jcfg, 64)
    proj = model.projector.weight
    bound = (3.0 / tcfg.audio_config.input_size) ** 0.5
    assert proj.abs().max() <= bound and proj.std() > 0.5 * bound / 3 ** 0.5
    emb = model.language_model.model.embed_tokens.weight
    assert abs(float(emb.std()) - tcfg.text_config.initializer_range) < 2e-3
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    again = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), requires_grad=True,
                               train=True)
    assert again.training and all(p.requires_grad for p in again.parameters())
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    # the Touch-Audio-1B count the recipe trains
    cfg1b = TouchAudioConfig.from_json_file(os.path.join(
        os.path.dirname(__file__), "..", "..", "examples", "audio", "pretrain", "wenetspeech",
        "config", "Touch-Audio-1B.json"))
    assert tmodel.get_num_params(cfg1b) == 976_064_512


# -- training ------------------------------------------------------------------

def _shards(tmp_path, count=40):
    jsonl = write_audio_jsonl(tmp_path / "wav", count, seed=11, lo=0.6, hi=1.6)
    return build_audio_shards(tmp_path / "shards", jsonl, per_shard=10)


def _flags(tmp_path, listfile, steps, **over):
    args = {
        "tokenizer_type": "BestRQTokenizer", "tokenizer_bestrq_vocab_size": 63,
        "tokenizer_bestrq_input_size": 161, "tokenizer_bestrq_emb_size": 8,
        "datapipe_type": "touch_audio", "datalist_path": listfile, "datalist_epoch": 100,
        "dataset_enable_pack": "true", "dataset_batchsize": 1, "dataset_audio_seqlen": T,
        "dataset_text_seqlen": T, "audio_speed_perturb": "true", "audiofeat_spec_aug": "false",
        "audiofeat_spec_sub": "false", "dataloader_num_workers": 1,
        "training_model_name": "touch_audio", "training_model_config_path": CFG,
        "training_trace_dump_folder": str(tmp_path / "exp"), "training_log_freq": 1,
        "training_seed": 0, "training_activation_checkpoint_mode": "none",
        "training_mixed_precision_param": "float32", "training_enable_liger_kernel": "true",
        "training_max_norm": 5.0, "lr_scheduler_steps": steps, "lr_scheduler_warmup_steps": 2,
        "optimizer_lr": 1e-2,
    }
    args.update({k: str(v) for k, v in over.items()})
    return [x for k, v in args.items() for x in (f"--{k}", str(v))]


def _trainer(argv):
    tok, data, job = ttrain.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], argv)
    return ttrain.Trainer(tok, data, job, device=torch.device("cpu"))


def test_train_step_matches_jax_trainer(tmp_path):
    """The first batch of a BEST-RQ shard (8 packed rows, the JAX trainer's
    dp 8 over the 8 CPU devices) through the port's train_step and the JAX
    Trainer's jitted step on the same weights: loss and grad norm rtol
    1e-5."""
    listfile = _shards(tmp_path)
    kw = dict(dataset_batchsize=ROWS, audio_speed_perturb="false")
    trainer = _trainer(_flags(tmp_path / "port", listfile, 10, **kw))
    gc_on = gc.isenabled()
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig],
                          _flags(tmp_path / "jax", listfile, 10, **kw)))
    try:
        _, tcfg = _configs()
        trainer.model.load_state_dict(
            convert.params_from_jax_numpy(jax.tree.map(np.asarray, jt.params), tcfg))
        batch = next(iter(trainer.dataloader))
        assert batch["input_features"].shape == (ROWS, T, 161) and batch["input_ids"] is None
        db, jns = jt._put_batch(batch)
        _, _, jm = jt.train_step_fn(jt.params, jt.opt_state, db, jns, 1)
        device_batch, ns = trainer._put_batch(batch)
        tm = trainer.train_step(device_batch, ns)
        for key in ("loss/per_sample", "loss/per_token", "acc", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    finally:
        jt.close()
        trainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()


def test_bin_train_on_audio_shards(tmp_path):
    listfile = _shards(tmp_path, count=24)
    trainer = ttrain.main(_flags(tmp_path, listfile, 8), device=torch.device("cpu"))
    losses = [h["loss/per_sample"] for h in trainer.metrics_processor.history]
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert trainer.num_flop_per_token == tmodel.get_num_flop_per_token(
        tmodel.get_num_params(trainer.model_config, exclude_embedding=True),
        trainer.model_config, T)


def test_trainer_refuses_features_of_another_width(tmp_path):
    with pytest.raises(ValueError, match="projector takes input_size 161"):
        _trainer(_flags(tmp_path, str(tmp_path / "data.list"), 2,
                        audiofeat_num_mel_bins=80, tokenizer_bestrq_input_size=560))


def test_sft_recipe_features_do_not_fit_touch_audio_7b():
    """examples/audio/sft/asr/wenetspeech/run.sh: log-mel 128 bins with the
    default stack 7 is 896 wide; Touch-Audio-7B's projector takes 400.
    fbank 80 x stack 5 fits."""
    cfg = TouchAudioConfig.from_json_file(os.path.join(
        os.path.dirname(__file__), "..", "..", "examples", "audio", "sft", "asr", "wenetspeech",
        "config", "Touch-Audio-7B.json"))
    with pytest.raises(ValueError, match="896 wide"):
        check_feature_width(cfg, DataConfig(audio_feat_type="log_mel_spectrogram",
                                            audiofeat_num_mel_bins=128))
    check_feature_width(cfg, DataConfig(audiofeat_num_mel_bins=80, audiofeat_stack_length=5,
                                        audiofeat_stride_length=4))


# -- converters ----------------------------------------------------------------

def test_hf_state_dict_round_trip_is_exact():
    _, tcfg = _configs()
    model = tmodel.init_params(tcfg, torch.Generator().manual_seed(3), torch.bfloat16)
    state = model.state_dict()
    hf = convert.params_to_hf_state_dict(tcfg, state)
    assert set(hf) == set(state) and convert.PROJECTOR in hf
    back = convert.params_from_hf_state_dict(tcfg, hf)
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    f32 = convert.params_from_hf_state_dict(tcfg, hf, dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in f32.values())
    bad = dict(hf)
    bad[convert.PROJECTOR] = bad[convert.PROJECTOR][:, :5]
    with pytest.raises(ValueError, match="projector.weight"):
        convert.params_from_hf_state_dict(tcfg, bad)


def _backbone_hf_dir(path, tcfg):
    """An HF text-backbone directory (the recipe's stage-1 input)."""
    from touchnet_tpu_torch.models.llama import convert as llama_convert
    from touchnet_tpu_torch.models.llama import modeling_llama

    lm = modeling_llama.init_params(tcfg.text_config, torch.Generator().manual_seed(5),
                                    torch.bfloat16)
    os.makedirs(path)
    sd = llama_convert.params_to_hf_state_dict(tcfg.text_config, lm.state_dict())
    write_safetensors(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(llama_convert.hf_config_dict(tcfg.text_config, "bfloat16"), f)
    return sd


def test_converters_cli_round_trip(tmp_path):
    """Stage 1: a text backbone -> step_0 (its tensors upcast under
    language_model., a fresh f32 projector); the trainer starts from it;
    stage 3: step_2 -> an HF directory whose tensors are the trained ones
    bit for bit and whose config.json loads in both packages."""
    _, tcfg = _configs()
    sd = _backbone_hf_dir(str(tmp_path / "hf"), tcfg)
    exp = tmp_path / "run"
    convert_hf_to_ckpt.main(["--ckpt_dir", str(exp), "--huggingface_model",
                             str(tmp_path / "hf"), "--training_model_config_path", CFG,
                             "--model_type", "touch_audio"])
    step0 = read_model(str(exp / "checkpoint" / "step_0" / "model"))
    for k, v in sd.items():
        assert torch.equal(step0["language_model." + k], v.float()), k
    proj = step0[convert.PROJECTOR]
    assert proj.dtype == torch.float32 and proj.shape == (64, 161) and proj.std() > 0
    listfile = _shards(tmp_path, count=16)
    trainer = ttrain.main(_flags(tmp_path, listfile, 2, training_trace_dump_folder=str(exp),
                                 training_enable_ckpt="true", training_ckpt_load_step=-1,
                                 training_ckpt_interval=100), device=torch.device("cpu"))
    final = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out = convert_ckpt_to_hf.main(["--ckpt_dir", str(exp), "--step", "-1", "--config", CFG,
                                   "--model_type", "touch_audio"])
    assert out.endswith("step-2")
    got = read_safetensors(os.path.join(out, "model.safetensors"))
    assert set(got) == set(final)
    for k, v in final.items():
        assert torch.equal(got[k], v), k
    with open(os.path.join(out, "config.json")) as f:
        written = json.load(f)
    assert TouchAudioConfig.from_dict(written) == tcfg
    assert JTouchAudioConfig.from_dict(written).to_dict() == \
        JTouchAudioConfig.from_json_file(CFG).to_dict()
    with pytest.raises(ValueError, match="training_model_config_path is required"):
        convert_hf_to_ckpt.main(["--ckpt_dir", str(tmp_path / "x"), "--huggingface_model",
                                 str(tmp_path / "hf"), "--model_type", "touch_audio"])
