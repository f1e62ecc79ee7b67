# touch_audio's ASR SFT path on the port (stages 1-4 of examples/audio/sft/
# asr/wenetspeech/run.sh with model_type touch_audio) against the JAX
# package on the CPU, on the tiny config (tests/assets/config/
# tiny_touch_audio.json), a hermetic char-level HF tokenizer ([PAD] 0,
# [BOS] 1, [EOS] 2, [UNK] 3, then the characters; built in a temporary
# directory as tests/touchnet_tpu/bin/test_task_metric_loop.py builds it)
# and the closed loop's tone language (each character a pure tone;
# chip_smoke.tone_jsonl), in f32:
#   - the port's loader against JAX's build_dataloader on the same
#     make_data shards, for both batchers (batch_pairaudio_pairtext_packed,
#     batch_pairaudio_pairtext), with the recipe's text-length, duration and
#     text/audio-ratio filters (a shard holds one sample each filter drops)
#     and the card's features (fbank 80 x stack 5 stride 4, 400 wide): ids,
#     labels, masks, positions and num_sentence equal; features within atol
#     1e-5; sentence_lens equal for the packed batcher, and for the dynamic
#     one JAX's plus 1 on every labelled row (the reference's fault, not
#     copied: JAX's batch_pairaudio_pairtext, processing_touch_audio.py:223,
#     :237, divides the len(ids) + 1 labels of a row by len(ids));
#   - the port's dynamic batcher: each row's sentence_lens is its label
#     count, as the packed batcher's and every other batcher's;
#   - the port's Trainer against the JAX Trainer (its jitted train_step_fn
#     on the same weights and the same batches, the port loader's first 3),
#     3 steps for each batcher with liger on (K3's plain version against
#     JAX's fused_linear_cross_entropy) and off (the full-logits pack loss):
#     loss per sample, loss per token, accuracy and grad norm rtol 1e-5
#     each step; the parameters after step 1 as test_torch_train.py holds
#     them (99.9 % of each tensor's entries within 1e-6, all within 1e-4:
#     the first Adam step moves an entry by lr x g / (|g| + eps)); and one
#     dev line (the packed batcher, liger on: Trainer.dev against JAX's
#     eval_step_fn averaged over the same dev batches): rtol 1e-5;
#   - bin.train.main with the dynamic batcher, liger on, a dev list and a
#     save every step, resumed from step 1: steps 2-3's losses and the final
#     parameters bit-equal to the straight run;
#   - stage 1 and stage 3: an HF text backbone with its untied lm_head ->
#     convert_hf_to_ckpt --model_type touch_audio (its language model equal
#     to JAX's converter's exactly) -> convert_ckpt_to_hf --step 0: every
#     tensor back bit for bit, the head apart from the embedding;
#   - (slow, as JAX's) test_asr_task_metric_closed_loop: JAX's closed loop
#     (tests/touchnet_tpu/bin/test_task_metric_loop.py) through the port's
#     entry points at world 1 (JAX's runs dp_shard 4 x tp 2), its flags,
#     200 steps and its margins (chip_smoke.closed_loop, which phase 18b
#     runs on the card).

import copy
import gc
import os

import jax
import numpy as np
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.convert_hf_to_ckpt import load_hf_state_dict as jload_hf_state_dict
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.data import native as jnative
from touchnet_tpu.data.dataloader import build_dataloader as jbuild_dataloader
from touchnet_tpu.models.touch_audio import convert as jconvert
from touchnet_tpu.models.touch_audio.configuration_touch_audio import (
    TouchAudioConfig as JTouchAudioConfig,
)
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.tokenizer.tokenizer import build_tokenizer as jbuild_tokenizer
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import convert_ckpt_to_hf, convert_hf_to_ckpt
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.bin.convert_ckpt_to_hf import read_model
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data.dataloader import build_dataloader
from touchnet_tpu_torch.models.touch_audio import convert
from touchnet_tpu_torch.models.touch_audio import processing_touch_audio as proc
from touchnet_tpu_torch.models.touch_audio.configuration_touch_audio import TouchAudioConfig
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.safetensors_io import read_safetensors
from test_torch_audio_frontend import build_audio_shards
from test_torch_bestrq import _take
from test_torch_chip_smoke import chip_smoke
from test_torch_touch_audio import _backbone_hf_dir

CFG = os.path.join(os.path.dirname(__file__), "..", "assets", "config", "tiny_touch_audio.json")
# the recipe's filters (run.sh:94-97): text 1-400 tokens, audio 200 ms-30 s,
# text/audio ratio 0.0005-1.0 tokens a 10 ms frame
RECIPE_FILTERS = dict(audio_max_length_in_ms_for_filter=30000,
                      audio_min_length_in_ms_for_filter=200,
                      text_max_length_in_tokens_for_filter=400,
                      text_min_length_in_tokens_for_filter=1,
                      max_text_audio_ratio=1.0, min_text_audio_ratio=0.0005)
# one sample each filter drops: 150 ms of audio; no text; 30 tokens over 25
# frames
FILTERED = (("short", 0.15, "一"), ("empty", 1.0, ""), ("dense", 0.25, "一二三四五六" * 5))
# the JAX Trainer's dp 8 over its 8 CPU devices takes rows in multiples of
# 8: the packed batcher's 8 rows; the dynamic batcher's budget of 1 x 220
# tokens holds 8 rows of 25-27 tokens and never 9 ((n + 1) x longest > 220)
PACKED_8 = dict(dataset_batchsize=8, dataset_audio_seqlen=64, dataset_text_seqlen=64)
DYNAMIC_8 = dict(dataset_batchsize=1, dataset_audio_seqlen=220, dataset_text_seqlen=220)
# the card's features (chip_smoke phases 11 and 18): 400 wide
FBANK_400 = dict(audio_feat_type="fbank", audiofeat_num_mel_bins=80, audiofeat_stack_length=5,
                 audiofeat_stride_length=4)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("touch_audio_sft")
    rng = np.random.default_rng(0)
    tones = chip_smoke.tone_jsonl
    return {
        "tok": chip_smoke.tone_tokenizer_dir(root / "tok"),
        "train": build_audio_shards(root / "train",
                                    tones(root / "train_wav", 24, rng, "tr", FILTERED)),
        # 4 characters of 0.300-0.325 s: 25-27 tokens under the default
        # features, so DYNAMIC_8 gives 8 right-padded rows a batch
        "train8": build_audio_shards(root / "train8", tones(
            root / "train8_wav", 32, rng, "t8", chars=(4, 5), seconds=(0.3, 0.325))),
        "dev": build_audio_shards(root / "dev", tones(root / "dev_wav", 4, rng, "dv")),
    }


@pytest.fixture(autouse=True)
def numpy_frontend(monkeypatch):
    """The numpy frontend on both sides (the native ones agree with it,
    test_torch_audio_frontend.py; JAX's loader builds its native library
    into one shared path, which xdist workers would race)."""
    monkeypatch.setenv("TOUCHNET_NATIVE", "0")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", False)


def _tok_kw(env):
    return dict(tokenizer_type="HuggingFaceTokenizer", tokenizer_model=env["tok"])


def _data_kw(env, pack, **over):
    kw = dict(datapipe_type="touch_audio", datalist_path=env["train"], datalist_epoch=4,
              dataset_enable_pack=pack, dataset_batchsize=2, dataset_audio_seqlen=64,
              dataset_text_seqlen=64, audio_speed_perturb=False, audiofeat_spec_aug=False,
              audiofeat_spec_sub=False, dataloader_num_workers=1, **RECIPE_FILTERS)
    kw.update(over)
    return kw


# -- the loader ------------------------------------------------------------------

@pytest.mark.parametrize("pack", [True, False], ids=["packed", "dynamic"])
def test_loader_matches_jax(env, pack):
    """Every batch of one epoch of the port's loader against JAX's on the
    same shards (the reference: touchnet_tpu/data/dataloader.build_dataloader
    over touch_audio_datapipe); the three filtered samples reach neither."""
    kw = _data_kw(env, pack, datalist_epoch=1, dataloader_drop_last_batch=False, **FBANK_400)
    got = list(build_dataloader(DataConfig(**kw), build_tokenizer(TokenizerConfig(**_tok_kw(env))),
                                0, 1))
    want = list(jbuild_dataloader(JDataConfig(**kw),
                                  jbuild_tokenizer(JTokenizerConfig(**_tok_kw(env))), 0, 1))
    assert len(got) == len(want) > 1
    assert sum(b["num_sentence"] for b in got) == 24  # FILTERED dropped
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["num_sentence"] == w["num_sentence"] > 0
        assert g["input_features"].shape[-1] == 400
        np.testing.assert_allclose(g["input_features"], w["input_features"], atol=1e-5)
        for k in ("input_ids", "labels", "shift_labels", "attention_mask", "position_ids"):
            if w[k] is None:
                assert g[k] is None, k
            else:
                assert g[k].dtype == w[k].dtype == np.int32, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        labelled = (w["labels"] != -100).any(1)
        np.testing.assert_array_equal(g["sentence_lens"],
                                      w["sentence_lens"] + (0 if pack else labelled[:, None]
                                                            * w["attention_mask"]))
        assert (g["input_ids"] == 1).sum() == g["num_sentence"]  # one [BOS] a sentence


def test_dynamic_batcher_divides_by_the_label_count():
    """A row's sentence_lens is its label count (len(ids) + 1: the ids and
    eos), as the packed batcher's; JAX's dynamic batcher gives len(ids)."""
    rng = np.random.default_rng(1)
    samples = [{"audiofeat": rng.standard_normal((int(rng.integers(3, 9)), 161))
                .astype(np.float32),
                "input_ids": [int(x) for x in rng.integers(4, 10, int(rng.integers(1, 6)))]}
               for _ in range(6)]

    class Tok:
        bos, eos, pad = 1, 2, 0

    cfg = DataConfig(dataset_batchsize=2, dataset_audio_seqlen=16, dataset_text_seqlen=16,
                     dataloader_drop_last_batch=False)
    for pack in (proc.batch_pairaudio_pairtext, proc.batch_pairaudio_pairtext_packed):
        batches = list(pack(iter(copy.deepcopy(samples)), cfg, Tok()))
        assert sum(b["num_sentence"] for b in batches) == len(samples)
        for b in batches:
            seg = b["attention_mask"]
            for r in range(seg.shape[0]):
                for s in set(seg[r].tolist()) - {0}:
                    span = seg[r] == s
                    assert set(b["sentence_lens"][r, span].tolist()) == \
                        {int((b["labels"][r, span] != -100).sum())}


# -- the trainer -----------------------------------------------------------------

def _flags(env, exp, pack, liger, steps=3, **over):
    args = {**_tok_kw(env), **_data_kw(env, pack), "datalist_dev_path": env["dev"],
            "training_model_name": "touch_audio", "training_model_config_path": CFG,
            "training_trace_dump_folder": str(exp), "training_log_freq": 1,
            "training_seed": 0, "training_activation_checkpoint_mode": "none",
            "training_mixed_precision_param": "float32", "training_enable_liger_kernel": liger,
            "training_max_norm": 5.0, "lr_scheduler_steps": steps,
            "lr_scheduler_warmup_steps": 1, "optimizer_lr": 1e-2}
    args.update(over)
    return [x for k, v in args.items() for x in (f"--{k}", str(v).lower()
                                                  if isinstance(v, bool) else str(v))]


def _trainer(argv):
    tok, data, job = ttrain.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], argv)
    return ttrain.Trainer(tok, data, job, device=torch.device("cpu"))


@pytest.mark.parametrize("liger", [True, False], ids=["liger", "full_logits"])
@pytest.mark.parametrize("pack", [True, False], ids=["packed", "dynamic"])
def test_trainer_matches_jax_trainer(env, tmp_path, pack, liger):
    """3 steps of the port's Trainer.train_step and the JAX Trainer's
    train_step_fn from the same weights on the same batches (the port
    loader's first three): the metrics at rtol 1e-5 each step, the
    parameters after step 1, and (packed, liger) the dev line against JAX's
    eval_step_fn on the same dev batches at rtol 1e-5."""
    rows = PACKED_8 if pack else dict(DYNAMIC_8, datalist_path=env["train8"])
    trainer = _trainer(_flags(env, tmp_path / "port", pack, liger, **rows))
    gc_on = gc.isenabled()
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig],
                          _flags(env, tmp_path / "jax", pack, liger, **rows)))
    try:
        tcfg = TouchAudioConfig.from_json_file(CFG)
        assert trainer._fused_ce == liger and trainer.tokenizer.bos == 1
        trainer.model.load_state_dict(
            convert.params_from_jax_numpy(jax.tree.map(np.asarray, jt.params), tcfg))
        batches = _take(trainer.dataloader, 3)
        assert all((b["position_ids"] is None) != pack and b["labels"].shape[0] == 8
                   for b in batches)
        if not pack:  # right-padded rows
            assert any((b["attention_mask"] == 0).any() for b in batches)
        params, opt = jt.params, jt.opt_state
        for step, batch in enumerate(batches, 1):
            db, jns = jt._put_batch(batch)
            params, opt, jm = jt.train_step_fn(params, opt, db, jns, step)
            tm = trainer.train_step(*trainer._put_batch(batch))
            for key in ("loss/per_sample", "loss/per_token", "acc", "grad_norm"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                           err_msg=f"step {step} {key}")
            if step == 1:
                want = convert.params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg)
                for name, p in trainer.model.state_dict().items():
                    diff = np.abs(p.numpy() - want[name].numpy())
                    assert np.quantile(diff, 0.999) <= 1e-6 and diff.max() <= 1e-4, \
                        (name, diff.max())
        if pack and liger:  # JAX's eval step on the port's dev batches (JAX's dev
            # loader splits the dev shards over its 8 dp ranks)
            trainer.dev()
            (got,) = trainer.metrics_processor.dev_history
            loader = trainer._loader("dev")
            dev = _take(loader, 100)
            loader.shutdown()
            want = {}
            for batch in dev:
                db, jns = jt._put_batch(batch, stacked=False)
                for k, v in jax.device_get(jt.eval_step_fn(params, db, jns)).items():
                    want[k] = want.get(k, 0.0) + float(v) / len(dev)
            for key in ("loss_per_sample", "loss_per_token", "acc"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    finally:
        jt.close()
        trainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()


def test_resume_from_step_1_is_bit_equal(env, tmp_path):
    """bin.train.main, the dynamic batcher under liger, a save and a dev line
    after every step: a run resumed from step 1 gives steps 2-3 and the
    final parameters of the straight run bit for bit."""
    ckpt = dict(training_enable_ckpt="true", training_ckpt_interval=1,
                training_ckpt_keep_latest_k=4, training_ckpt_load_step=-1)
    straight = ttrain.main(_flags(env, tmp_path / "a", False, True, **ckpt),
                           device=torch.device("cpu"))
    losses = [h["loss/per_sample"] for h in straight.metrics_processor.history]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert [d["step"] for d in straight.metrics_processor.dev_history] == [1, 2, 3]
    final = {k: v.clone() for k, v in straight.model.state_dict().items()}
    resumed = ttrain.main(_flags(env, tmp_path / "a", False, True,
                                 **{**ckpt, "training_ckpt_load_step": 1}),
                          device=torch.device("cpu"))
    assert [h["loss/per_sample"] for h in resumed.metrics_processor.history] == losses[1:]
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, final[k]), k


# -- the converters --------------------------------------------------------------

def test_converters_round_trip_with_the_untied_head(tmp_path):
    """Stage 1 on an HF text backbone with its own lm_head (the tiny config
    is untied): the seed's language model equals JAX's converter's
    (touchnet_tpu/models/touch_audio/convert.params_from_hf_backbone_state_dict)
    exactly, its projector a fresh f32 draw; stage 3 on that seed (step 0):
    every tensor back bit for bit, the head apart from the embedding."""
    tcfg = TouchAudioConfig.from_json_file(CFG)
    assert not tcfg.text_config.tie_word_embeddings
    _backbone_hf_dir(str(tmp_path / "hf"), tcfg)
    exp = tmp_path / "exp"
    step_dir = convert_hf_to_ckpt.main(["--ckpt_dir", str(exp), "--huggingface_model",
                                        str(tmp_path / "hf"), "--training_model_config_path",
                                        CFG, "--model_type", "touch_audio"])
    seed = read_model(os.path.join(step_dir, "model"))
    jparams = jconvert.params_from_hf_backbone_state_dict(
        JTouchAudioConfig.from_json_file(CFG), jload_hf_state_dict(str(tmp_path / "hf")))
    want = convert.params_from_jax_numpy(jparams, tcfg)
    assert seed.keys() == want.keys()
    for k in want:
        assert seed[k].dtype == torch.float32, k
        if k != convert.PROJECTOR:
            assert torch.equal(seed[k], want[k]), k
    head, emb = "language_model.lm_head.weight", "language_model.model.embed_tokens.weight"
    assert not torch.equal(seed[head], seed[emb])
    out = convert_ckpt_to_hf.main(["--ckpt_dir", str(exp), "--step", "0", "--config", CFG,
                                   "--model_type", "touch_audio"])
    got = read_safetensors(os.path.join(out, "model.safetensors"))
    assert got.keys() == seed.keys()
    for k, v in seed.items():
        assert torch.equal(got[k], v), k


# -- the closed loop ---------------------------------------------------------------

@pytest.mark.slow
def test_asr_task_metric_closed_loop(tmp_path):
    """JAX's closed loop (chip_smoke.closed_loop: its data, flags and 200
    steps) on the tiny config at world 1, held to JAX's margins
    (test_task_metric_loop.py:228-232): CER at step 0 >= 60, trained <= 50
    and below half of step 0's."""
    out = chip_smoke.closed_loop(tmp_path, CFG, torch.device("cpu"))
    assert out["stats0"]["utts"] == out["stats"]["utts"] == 8
    assert out["cer0"] >= chip_smoke.LOOP_CER0_MIN, out
    assert out["cer"] <= chip_smoke.LOOP_CER_MAX, out
    assert out["cer"] < out["cer0"] / 2, out
