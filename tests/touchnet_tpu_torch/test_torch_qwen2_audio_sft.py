# qwen2_audio's SFT path on the port (stages 0-3 of examples/audio/sft/asr/
# wenetspeech/run.sh with model_type qwen2_audio) against the JAX package on
# the CPU, on the TINY config of test_torch_qwen2_audio.py (whisper tower 32
# mel x d64 x 2 layers, Qwen2 text model 2 layers 4 heads over 2, vocab 64),
# a char-level tokenizer with the audio special ids at 57-60
# (chip_smoke.write_char_tokenizer) and seeded synthetic wavs:
#   - dynamic_batch against JAX's on the same samples: the batch boundaries
#     and every array equal, with the skips of both packages (no txt, audio
#     past the length filter, ids past the text filters, a clip too short
#     for one <|AUDIO|> token);
#   - the two span faults of the JAX batcher, pinned: a tokenizer that does
#     not map <|AUDIO|> to the config's one id raises at setup (JAX switches
#     its span checks off, processing_qwen2_audio.py:133-134), and a sample
#     with two <|AUDIO|> spans is logged and skipped (JAX raises and ends
#     the run, :190-197);
#   - HFQwen2AudioFrontend against JAX's on one locally built
#     Qwen2AudioProcessor (AutoProcessor from a directory; no download),
#     with a wav past 30 s; the datapipe through --processor_model;
#   - the datapipe end to end from make_data shards against JAX's loader,
#     and its resume: k batches, the loader state, then a new loader from
#     it gives the straight run's batches;
#   - the tower under remat none, full, op_small, op and selective: equal
#     outputs and gradients;
#   - forward, the pack loss and every gradient against jax.grad of JAX's
#     forward plus cross_entropy_loss, f32, on a dynamic_batch batch (JAX on
#     its plain attention, as its own tests run the tower on the CPU): loss
#     rtol 1e-5, the whole gradient rel L2 <= 1e-4 (each tensor too);
#   - one trainer step against the JAX Trainer's on the same weights and
#     batch: loss and grad norm rtol 1e-5; the liger flag leaves the
#     full-logits route (no head weight, as JAX);
#   - both converter CLIs with --model_type qwen2_audio: HF -> step_0 equal
#     to JAX's params_from_hf_state_dict, the export read back bit-equal by
#     both packages;
#   - bin.train.main with the recipe's stage-2 flags (dp 1; remat full).

import contextlib
import copy
import gc
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.convert_hf_to_ckpt import load_hf_state_dict as jload_hf_state_dict
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.data.dataloader import build_dataloader as jbuild_dataloader
from touchnet_tpu.loss import cross_entropy_loss as jcross_entropy_loss
from touchnet_tpu.models.qwen2_audio import convert as jconvert
from touchnet_tpu.models.qwen2_audio import modeling_qwen2_audio as jm
from touchnet_tpu.models.qwen2_audio import processing_qwen2_audio as jproc
from touchnet_tpu.models.qwen2_audio.configuration_qwen2_audio import (
    Qwen2AudioConfig as JConfig,
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
from touchnet_tpu_torch.loss import cross_entropy_loss
from touchnet_tpu_torch.models import whisper_encoder
from touchnet_tpu_torch.models.qwen2_audio import check_mel_bins, convert
from touchnet_tpu_torch.models.qwen2_audio import modeling_qwen2_audio as tm
from touchnet_tpu_torch.models.qwen2_audio import processing_qwen2_audio as proc
from touchnet_tpu_torch.models.qwen2_audio.configuration_qwen2_audio import Qwen2AudioConfig
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors
from touchnet_tpu_torch.utils.train_spec import get_train_spec
from test_torch_audio_frontend import build_audio_shards, synth_wave, write_audio_jsonl
from test_torch_bestrq import _equal_batches, _take
from test_torch_inference_qwen2_audio import INSTRUCT, SPECIALS, _tokenizer
from test_torch_qwen2_audio import TINY

MEL = TINY["audio_config"]["num_mel_bins"]
AUDIO_ID = TINY["audio_token_index"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The char tokenizer, the TINY config file, and make_data shards of 16
    seeded wavs of 0.3-2 s (4 a shard)."""
    root = tmp_path_factory.mktemp("qwen2_sft")
    cfg = root / "config.json"
    cfg.write_text(json.dumps(TINY))
    jsonl = write_audio_jsonl(str(root / "wav"), 16, seed=41, lo=0.3, hi=2.0)
    listfile = build_audio_shards(root / "shards", jsonl, per_shard=4)
    devlist = root / "dev.list"  # the first shard
    devlist.write_text(open(listfile).readline())
    return dict(root=root, tok=_tokenizer(root / "tok"), cfg=str(cfg), jsonl=jsonl,
                listfile=listfile, devlist=str(devlist))


def _tokenizers(tok_dir):
    kw = dict(tokenizer_type="HuggingFaceTokenizer", tokenizer_model=tok_dir)
    return build_tokenizer(TokenizerConfig(**kw)), jbuild_tokenizer(JTokenizerConfig(**kw))


def _samples(seed=43):
    """Decoded-sample dicts as the root datapipe yields them: 10 wavs of
    0.3-2 s, one at 8 kHz, and one each that both batchers skip: no txt, a
    txt past the text filter, 20 ms of audio (0 <|AUDIO|> tokens), 3 s of
    audio (past the audio filter)."""
    rng = np.random.default_rng(seed)

    def wav(seconds, rate=16000):
        return synth_wave(rng, seconds * rate / 16000).astype(np.float32) / 32768.0

    out = [{"key": f"utt{i}", "waveform": wav(float(rng.uniform(0.3, 2.0))),
            "sample_rate": 16000, "txt": "word" * int(rng.integers(1, 6))} for i in range(10)]
    out.insert(3, {"key": "rate8k", "waveform": wav(1.2, 8000), "sample_rate": 8000,
                   "txt": "eight"})
    out.insert(5, {"key": "notxt", "waveform": wav(1.0), "sample_rate": 16000})
    out.insert(7, {"key": "longtxt", "waveform": wav(0.5), "sample_rate": 16000,
                   "txt": "x" * 200})
    out.insert(9, {"key": "clip", "waveform": wav(0.02), "sample_rate": 16000, "txt": "a"})
    out.insert(11, {"key": "longaudio", "waveform": wav(3.0), "sample_rate": 16000,
                    "txt": "long"})
    return out


@contextlib.contextmanager
def _logged():
    """The messages the port's logger emits while open (it does not
    propagate to the root logger once init_logger ran)."""
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    proc.logger.addHandler(handler)
    level = proc.logger.level
    proc.logger.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        proc.logger.removeHandler(handler)
        proc.logger.setLevel(level)


def _data_kw(**over):
    kw = dict(dataset_batchsize=2, dataset_text_seqlen=64, audiofeat_num_mel_bins=MEL,
              audio_max_length_in_ms_for_filter=2500, text_max_length_in_tokens_for_filter=150,
              text_min_length_in_tokens_for_filter=1, dataloader_drop_last_batch=False)
    kw.update(over)
    return kw


def _both_batches(env, samples, **over):
    ours, theirs = _tokenizers(env["tok"])
    kw = _data_kw(**over)
    got = list(proc.dynamic_batch(iter(copy.deepcopy(samples)), DataConfig(**kw),
                                  proc.ManualQwen2AudioFrontend(ours, MEL), AUDIO_ID))
    want = list(jproc.dynamic_batch(iter(copy.deepcopy(samples)), JDataConfig(**kw),
                                    jproc.ManualQwen2AudioFrontend(theirs, MEL)))
    return got, want


# -- dynamic_batch ---------------------------------------------------------------

@pytest.mark.parametrize("batchsize,seqlen,drop_last", [(2, 64, False), (1, 200, False),
                                                        (4, 80, True)])
def test_dynamic_batch_matches_jax(env, batchsize, seqlen, drop_last):
    got, want = _both_batches(env, _samples(), dataset_batchsize=batchsize,
                              dataset_text_seqlen=seqlen, dataloader_drop_last_batch=drop_last)
    assert len(got) == len(want) >= 2
    _equal_batches(got, want)
    rows = sum(b["num_sentence"] for b in got)
    assert rows <= 11 and (drop_last or rows == 11)  # the 5 skipped samples never appear
    for b in got:
        B, L = b["input_ids"].shape
        assert b["input_features"].shape == (B, MEL, 3000)
        assert (B * L <= batchsize * seqlen) or B == 1
        assert all(proc.count_audio_spans(r, AUDIO_ID) == 1 for r in b["input_ids"])
        np.testing.assert_array_equal(b["labels"], b["shift_labels"])


def test_dynamic_batch_rows_and_labels(env):
    """A row: <|audio_bos|>, one <|AUDIO|> per pooled frame, <|audio_eos|>,
    the instruct, the response; labels shifted by one, the prompt masked,
    the response and eos supervised; the mask 1 on tokens; features padded
    to 30 s with the frame mask on the audio's own frames."""
    got, _ = _both_batches(env, _samples()[:1], dataset_text_seqlen=400)
    b = got[0]
    ids, labels = b["input_ids"][0], b["labels"][0]
    frames = int(b["feature_attention_mask"][0].sum())
    n = tm.get_feat_extract_output_lengths(frames)[1]
    assert ids[0] == 58 and (ids[1:1 + n] == AUDIO_ID).all() and ids[1 + n] == 59
    prompt = n + 2 + len(INSTRUCT)
    assert (labels[:prompt - 1] == -100).all() and labels[-1] == 57
    np.testing.assert_array_equal(labels[prompt - 1:-1], ids[prompt:])
    assert b["attention_mask"].tolist() == [[1] * len(ids)]
    assert (b["sentence_lens"][0] == len(ids) - prompt + 1).all()


def test_zero_span_sample_is_skipped_as_in_jax(env):
    """A 20 ms clip pools to zero audio frames: both packages skip it (the
    JAX batcher's own skip, processing_qwen2_audio.py:182-189)."""
    clip = [s for s in _samples() if s["key"] == "clip"]
    with _logged() as lines:
        got, want = _both_batches(env, clip)
    assert got == [] and want == []
    assert any("'clip' expands to 0 <|AUDIO|> spans" in ln for ln in lines)


def test_two_span_sample_is_skipped_not_fatal(env):
    """An instruct holding <|AUDIO|> gives its row two spans. The JAX
    batcher raises and ends the run (processing_qwen2_audio.py:190-197);
    the port logs the key and skips it: the other samples batch as JAX
    batches them without it."""
    samples = _samples()[:6]
    bad = dict(samples[2], key="twospans", instruct="Repeat <|AUDIO|> now:")
    ours, theirs = _tokenizers(env["tok"])
    with pytest.raises(ValueError, match="2 <\\|AUDIO\\|> spans"):
        list(jproc.dynamic_batch(iter(copy.deepcopy(samples[:2] + [bad])),
                                 JDataConfig(**_data_kw()),
                                 jproc.ManualQwen2AudioFrontend(theirs, MEL)))
    with _logged() as lines:
        got = list(proc.dynamic_batch(iter(copy.deepcopy(samples[:2] + [bad] + samples[2:])),
                                      DataConfig(**_data_kw()),
                                      proc.ManualQwen2AudioFrontend(ours, MEL), AUDIO_ID))
    assert any("'twospans' expands to 2 <|AUDIO|> spans" in ln for ln in lines)
    want = list(jproc.dynamic_batch(iter(copy.deepcopy(samples)), JDataConfig(**_data_kw()),
                                    jproc.ManualQwen2AudioFrontend(theirs, MEL)))
    _equal_batches(got, want)


@pytest.mark.parametrize("specials,match", [
    ({**SPECIALS, "<|AUDIO|>": 61}, r"maps '<\|AUDIO\|>' to \[61\]"),
    ({k: v for k, v in SPECIALS.items() if k != "<|AUDIO|>"},  # split into characters
     r"maps '<\|AUDIO\|>' to \[\d+, \d+, "),
], ids=["another_id", "several_ids"])
def test_datapipe_raises_unless_audio_is_the_configs_one_id(env, tmp_path, specials, match):
    """JAX's batcher takes audio_id = None when <|AUDIO|> is several ids and
    then checks no span (processing_qwen2_audio.py:133-134); the port's
    datapipe raises at setup, and so does a token mapped to another id."""
    tok = build_tokenizer(TokenizerConfig(tokenizer_type="HuggingFaceTokenizer",
                                          tokenizer_model=_tokenizer(tmp_path, specials)))
    cfg = DataConfig(**_data_kw(datalist_path=env["listfile"], datapipe_type="qwen2_audio"))
    with pytest.raises(ValueError, match=match):
        proc.qwen2_audio_datapipe(cfg, tok, 0, 1, audio_token_index=AUDIO_ID)
    with pytest.raises(ValueError, match=match):
        build_dataloader(cfg, tok, 0, 1, model_config=Qwen2AudioConfig.from_dict(TINY))


@pytest.mark.parametrize("row", [[1, 60, 60, 2], [60, 60, 3, 60], [5, 6, 7], [60, 1, 60, 1, 60]],
                         ids=["one", "two", "none", "three"])
def test_count_audio_spans_matches_jax(row):
    assert proc.count_audio_spans(np.asarray(row), 60) == \
        jproc.count_audio_spans(np.asarray(row), 60)


def test_build_dataloader_needs_the_model_config(env):
    tok, _ = _tokenizers(env["tok"])
    cfg = DataConfig(**_data_kw(datalist_path=env["listfile"], datapipe_type="qwen2_audio"))
    with pytest.raises(ValueError, match="audio_token_index"):
        build_dataloader(cfg, tok, 0, 1)
    # kimi_audio's datapipe needs a Kimi config (its marker ids), not this one
    with pytest.raises(ValueError, match="--training_model_name kimi_audio"):
        build_dataloader(DataConfig(**_data_kw(datapipe_type="kimi_audio")), tok, 0, 1,
                         model_config=Qwen2AudioConfig.from_dict(TINY))


# -- the HF frontend (--processor_model) ---------------------------------------

@pytest.fixture(scope="module")
def processor_dir(env):
    """A Qwen2AudioProcessor built here (WhisperFeatureExtractor at 32 mel
    bins, the char tokenizer) and saved, as --processor_model names one."""
    import transformers

    proc_dir = env["root"] / "processor"
    transformers.Qwen2AudioProcessor(
        feature_extractor=transformers.WhisperFeatureExtractor(feature_size=MEL),
        tokenizer=transformers.AutoTokenizer.from_pretrained(env["tok"]),
    ).save_pretrained(str(proc_dir))
    return str(proc_dir)


def _hf_frontends(processor_dir):
    import transformers

    p = transformers.AutoProcessor.from_pretrained(processor_dir, trust_remote_code=True)
    return proc.HFQwen2AudioFrontend(p), jproc.HFQwen2AudioFrontend(p)


@pytest.mark.parametrize("seconds", [1.3, 31.0])
def test_hf_frontend_matches_jax(processor_dir, seconds):
    ours, theirs = _hf_frontends(processor_dir)
    wav = synth_wave(np.random.default_rng(7), seconds).astype(np.float32) / 32768.0
    got, got_mask = ours.extract(wav, 16000)
    want, want_mask = theirs.extract(wav, 16000)
    assert got.shape == (max(3000, int(seconds * 100)), MEL)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.all() if seconds > 30 else got_mask.sum() == int(seconds * 100)
    text = "<|audio_bos|><|AUDIO|><|AUDIO|><|audio_eos|>" + INSTRUCT
    assert ours.tokenize(text) == theirs.tokenize(text)
    assert (ours.pad_id, ours.eos_id) == (theirs.pad_id, theirs.eos_id) == (57, 57)


def test_hf_frontend_resamples_to_its_rate(processor_dir):
    """JAX's HF frontend hands an 8 kHz waveform over as 16 kHz (its
    feature extractor then reads twice the speed); the port resamples it
    first, to the features of the 16 kHz resampled wave."""
    from touchnet_tpu_torch.data import dsp

    ours, theirs = _hf_frontends(processor_dir)
    wav = synth_wave(np.random.default_rng(8), 0.6).astype(np.float32) / 32768.0
    got, mask = ours.extract(wav, 8000)
    want, want_mask = ours.extract(dsp.resample(wav, 8000, 16000), 16000)
    np.testing.assert_array_equal(got, want)
    assert mask.sum() == want_mask.sum() == int(1.2 * 100)
    assert theirs.extract(wav, 8000)[1].sum() == int(0.6 * 100)


def test_datapipe_with_processor_model_matches_jax(env, processor_dir):
    ours, theirs = _tokenizers(env["tok"])
    kw = _data_kw(datalist_path=env["listfile"], datapipe_type="qwen2_audio",
                  processor_model=processor_dir, datalist_epoch=1, dataloader_num_workers=1)
    got = list(build_dataloader(DataConfig(**kw), ours, 0, 1,
                                model_config=Qwen2AudioConfig.from_dict(TINY)))
    want = list(jbuild_dataloader(JDataConfig(**kw), theirs, 0, 1))
    assert len(got) >= 4
    _equal_batches(got, want)


# -- the datapipe from make_data shards ---------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
def test_datapipe_matches_jax(env, workers):
    ours, theirs = _tokenizers(env["tok"])
    kw = _data_kw(datalist_path=env["listfile"], datapipe_type="qwen2_audio", datalist_epoch=1,
                  dataloader_num_workers=workers, dataset_text_seqlen=100)
    got = list(build_dataloader(DataConfig(**kw), ours, 0, 1,
                                model_config=Qwen2AudioConfig.from_dict(TINY)))
    want = list(jbuild_dataloader(JDataConfig(**kw), theirs, 0, 1))
    assert len(got) >= 4 and sum(b["num_sentence"] for b in got) == 16
    _equal_batches(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_datapipe_resume_is_exact(env, k):
    """N batches straight against k, the loader's state, and N - k from a
    new loader built on it: every array equal (dynamic_batch yields when
    the sample it pulled does not fit; the root counts that sample only
    when the next is pulled, so the resumed run batches it again)."""
    tok, _ = _tokenizers(env["tok"])
    cfg = DataConfig(**_data_kw(datalist_path=env["listfile"], datapipe_type="qwen2_audio",
                                datalist_epoch=3, dataloader_num_workers=2))
    mcfg = Qwen2AudioConfig.from_dict(TINY)
    N = 6
    straight = build_dataloader(cfg, tok, 0, 1, model_config=mcfg)
    want = _take(straight, N)
    straight.shutdown()
    first = build_dataloader(cfg, tok, 0, 1, model_config=mcfg)
    got = _take(first, k)
    state = copy.deepcopy(first.state_dict())
    first.shutdown()
    second = build_dataloader(cfg, tok, 0, 1, model_config=mcfg)
    second.load_state_dict(state)
    got += _take(second, N - k)
    second.shutdown()
    _equal_batches(got, want)


# -- the model -------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """JAX params of TINY and the port's trainable model with the same
    weights."""
    jc, tc = JConfig.from_dict(TINY), Qwen2AudioConfig.from_dict(TINY)
    jp = jm.init_params(jc, jax.random.PRNGKey(3))
    state = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jp), tc)
    return jp, jc, tc, state


def _trainable(tc, state):
    model = tm.empty_model(tc, torch.float32, "cpu", requires_grad=True, train=True)
    model.load_state_dict(state)
    return model


@pytest.fixture(scope="module")
def sft_batch(env):
    """One dynamic_batch batch of 2 rows (the samples' first two)."""
    tok, _ = _tokenizers(env["tok"])
    (b,) = proc.dynamic_batch(iter(copy.deepcopy(_samples()[:2])),
                              DataConfig(**_data_kw(dataset_text_seqlen=400)),
                              proc.ManualQwen2AudioFrontend(tok, MEL), AUDIO_ID)
    assert b["num_sentence"] == 2
    return b


@pytest.mark.parametrize("mode", ["full", "op_small", "op", "selective"])
def test_tower_remat_modes_equal_none(weights, mode):
    """The tower's layers under each remat mode give the output and the
    gradients of remat none (the recompute runs the same ops on the same
    inputs), bit for bit on the CPU."""
    _, _, tc, state = weights
    feats = torch.from_numpy(np.random.default_rng(5).standard_normal((2, MEL, 240))
                             .astype(np.float32))
    r = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 120, 64))
                         .astype(np.float32))
    out = {}
    for m in ("none", mode):
        model = _trainable(tc, state)
        h = whisper_encoder.forward(model.audio_tower, feats, tc.audio_config,
                                    compute_dtype=torch.float32, remat_mode=m)
        (h * r).sum().backward()
        out[m] = (h.detach(), {n: p.grad for n, p in model.audio_tower.named_parameters()})
    assert torch.equal(out[mode][0], out["none"][0])
    for name, g in out["none"][1].items():
        if g is None:  # the final LayerNorm, which Qwen2-Audio applies after its pool
            assert name.startswith("layer_norm.") and out[mode][1][name] is None
            continue
        assert torch.equal(out[mode][1][name], g), name


def test_tower_remat_full_recomputes_attention(weights, monkeypatch):
    """remat full re-runs each layer's attention in the backward; op_small
    saves its residuals (K1 once a layer)."""
    from touchnet_tpu_torch.ops import attention as attn

    _, _, tc, state = weights
    feats = torch.zeros(1, MEL, 40)
    # per layer: the forward, the CPU's K2 (autograd through the plain
    # forward), and under full the recompute
    for mode, want in (("full", 6), ("op_small", 4), ("none", 4)):
        calls = []
        real = attn.packed_attention_reference
        monkeypatch.setattr(attn, "packed_attention_reference",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        model = _trainable(tc, state)
        whisper_encoder.forward(model.audio_tower, feats, tc.audio_config,
                                compute_dtype=torch.float32, remat_mode=mode).sum().backward()
        monkeypatch.undo()
        assert len(calls) == want, (mode, len(calls))


@pytest.fixture(scope="module")
def jax_loss_and_grads(weights, sft_batch):
    """jax.value_and_grad of JAX's forward plus cross_entropy_loss, f32."""
    jp, jc, _, _ = weights
    batch = sft_batch

    def loss(params):
        logits = jm.forward(params, input_ids=jnp.asarray(batch["input_ids"]),
                            input_features=jnp.asarray(batch["input_features"]),
                            segment_ids=jnp.asarray(batch["attention_mask"]),
                            config=jc, compute_dtype=jnp.float32)
        ps, _ = jcross_entropy_loss(logits, jnp.asarray(batch["labels"]),
                                    jnp.asarray(batch["sentence_lens"]), batch["num_sentence"])
        return ps

    return jax.value_and_grad(loss)(jp)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(weights, sft_batch, jax_loss_and_grads, remat):
    """The port under remat none and full against JAX's (remat changes no
    value)."""
    _, _, tc, _ = weights
    jloss, jgrads = jax_loss_and_grads
    model = _trainable(tc, weights[3])
    b = {k: torch.from_numpy(v) for k, v in sft_batch.items() if isinstance(v, np.ndarray)}
    logits = tm.forward(model, input_ids=b["input_ids"], input_features=b["input_features"],
                        feature_attention_mask=b["feature_attention_mask"],
                        segment_ids=b["attention_mask"], config=tc,
                        compute_dtype=torch.float32, remat_mode=remat)
    loss, _ = cross_entropy_loss(logits, b["labels"], b["sentence_lens"],
                                 sft_batch["num_sentence"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jgrads), tc)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    num = den = 0.0
    for name, ref in want.items():
        d = float((got[name] - ref).norm()) ** 2
        r = float(ref.norm()) ** 2
        num, den = num + d, den + r
        assert d <= (1e-4) ** 2 * max(r, 1e-20) or d <= 1e-20, name
    assert (num / den) ** 0.5 <= 1e-4


def test_init_params_and_counts(weights):
    jp, jc, tc, _ = weights
    model = tm.init_params(tc, torch.Generator().manual_seed(0), requires_grad=True,
                           train=True)
    assert model.training and all(p.requires_grad for p in model.parameters())
    serving = tm.init_params(tc, torch.Generator().manual_seed(0))
    assert not serving.training and not any(p.requires_grad for p in serving.parameters())
    for a, b in zip(model.parameters(), serving.parameters()):
        assert torch.equal(a, b)
    n = sum(p.numel() for p in model.parameters())
    table = tc.audio_config.max_source_positions * tc.audio_config.d_model
    assert n - table == tm.get_num_params(tc) == jm.get_num_params(jc)


# -- the trainer -------------------------------------------------------------------

def _flags(env, exp, steps, **over):
    """run.sh's stage-2 flags (:76-141) on one device (dp 1), at the TINY
    config and the char tokenizer, f32, remat full (the card's cut); the
    recipe's dev list, checkpoint, TensorBoard, profiling and compile flags
    come through ``over``."""
    args = {
        "tokenizer_type": "HuggingFaceTokenizer", "tokenizer_model": env["tok"],
        "datapipe_type": "qwen2_audio", "datalist_path": env["listfile"],
        "datalist_sharding": "true",
        "datalist_epoch": 10000, "datalist_shuffling": "true", "dataset_shuffling": "true",
        "dataset_mmap": "true", "dataset_batchsize": 2, "dataset_audio_seqlen": 64,
        "dataset_text_seqlen": 64, "audio_max_length_in_ms_for_filter": 30000,
        "audio_min_length_in_ms_for_filter": 200, "text_max_length_in_tokens_for_filter": 400,
        "text_min_length_in_tokens_for_filter": 1, "max_text_audio_ratio": 1.0,
        "min_text_audio_ratio": 0.0005, "audio_resample_rate": 16000,
        "audio_speed_perturb": "false", "audio_feat_type": "log_mel_spectrogram",
        "audiofeat_num_mel_bins": MEL, "audiofeat_n_fft": 400, "audiofeat_hop_length": 160,
        "dataloader_num_workers": 2, "dataloader_prefetch_factor": 2,
        "training_description": "wenetspeech asr sft (qwen2_audio)", "training_seed": 2025,
        "training_model_name": "qwen2_audio", "training_model_config_path": env["cfg"],
        "training_print_args": "true", "training_trace_dump_folder": str(exp),
        "training_fsdp_reshard_after_forward": "default",
        "training_context_parallel_degree": 1, "training_tensor_parallel_degree": 1,
        "training_data_parallel_shard_degree": 1, "training_pipeline_parallel_degree": 1,
        "training_enable_liger_kernel": "true", "training_log_freq": 1,
        "training_mixed_precision_param": "float32", "training_mixed_precision_reduce": "float32",
        "training_gc_freq": 1000, "training_deterministic": "false", "training_max_norm": 1.0,
        "training_activation_checkpoint_mode": "full", "optimizer_name": "AdamW",
        "optimizer_lr": 1e-3, "optimizer_impl": "fused", "lr_scheduler_steps": steps,
        "lr_scheduler_warmup_steps": 1, "lr_scheduler_decay_type": "linear",
        "lr_scheduler_lr_min": 0.0,
    }
    args.update(over)
    return [x for k, v in args.items() for x in (f"--{k}", str(v))]


def _trainer(argv):
    tok, data, job = ttrain.parse_args_into_dataclasses(
        [TokenizerConfig, DataConfig, TrainConfig], argv)
    return ttrain.Trainer(tok, data, job, device=torch.device("cpu"))


def test_train_step_matches_jax_trainer(env, tmp_path):
    """A dynamic_batch batch of 8 rows (JAX's dp 8 over its 8 CPU devices
    needs a multiple of 8) through the port's train_step and the JAX
    Trainer's jitted step on the same weights: loss, grad norm and acc rtol
    1e-5. The liger flag is on and both take the full-logits loss."""
    argv = _flags(env, tmp_path / "port", 4, training_activation_checkpoint_mode="none",
                  dataloader_num_workers=1, training_data_parallel_shard_degree=-1)
    trainer = _trainer(argv)
    assert not trainer._fused_ce and trainer.train_spec.head_weight_fn is None
    gc_on = gc.isenabled()
    jargv = [a.replace(str(tmp_path / "port"), str(tmp_path / "jax")) for a in argv]
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig], jargv))
    try:
        tc = trainer.model_config
        trainer.model.load_state_dict(
            convert.params_from_jax_numpy(jax.tree.map(np.asarray, jt.params), tc))
        rows = [s for s in _samples() if s["key"].startswith("utt")][:8]
        (batch,) = proc.dynamic_batch(
            iter(rows), DataConfig(**_data_kw(dataset_batchsize=8, dataset_text_seqlen=400)),
            proc.ManualQwen2AudioFrontend(trainer.tokenizer, MEL), AUDIO_ID)
        assert batch["input_features"].shape == (8, MEL, 3000)
        db, jns = jt._put_batch(batch)
        _, _, jmet = jt.train_step_fn(jt.params, jt.opt_state, db, jns, 1)
        device_batch, ns = trainer._put_batch(batch)
        assert device_batch["feature_attention_mask"] is not None
        met = trainer.train_step(device_batch, ns)
        for key in ("loss/per_sample", "loss/per_token", "acc", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-5,
                                       err_msg=key)
    finally:
        jt.close()
        trainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()


def test_bin_train_runs_the_recipe_flags(env, tmp_path):
    """bin.train.main with run.sh's stage-2 flags (checkpoints every 2 and
    the dev list as the recipe's) on the CPU: losses finite, a dev line
    after each save (steps 1, 2 and 4: the JAX cadence), and a resume from
    step 2 equal to the straight run."""
    exp = tmp_path / "exp"
    flags = dict(datalist_dev_path=env["devlist"], training_enable_ckpt="true",
                 training_ckpt_load_step=-1, training_ckpt_interval=2,
                 training_ckpt_keep_latest_k=2, training_ckpt_async_mode="async",
                 training_compile="true")
    first = ttrain.main(_flags(env, exp, 4, **flags), device=torch.device("cpu"))
    hist = first.metrics_processor.history
    losses = [h["loss/per_sample"] for h in hist]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert [d["step"] for d in first.metrics_processor.dev_history] == [1, 2, 4]
    final = {k: v.clone() for k, v in first.model.state_dict().items()}
    resumed = ttrain.main(_flags(env, exp, 4, **{**flags, "training_ckpt_load_step": 2}),
                          device=torch.device("cpu"))
    assert [h["loss/per_sample"] for h in resumed.metrics_processor.history] == losses[2:]
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, final[k]), k


def test_trainer_refuses_other_mel_bins(env, tmp_path):
    with pytest.raises(ValueError, match="takes 32 mel bins"):
        _trainer(_flags(env, tmp_path, 2, audiofeat_num_mel_bins=128))
    cfg = Qwen2AudioConfig.from_dict(TINY)
    check_mel_bins(cfg, DataConfig(audiofeat_num_mel_bins=MEL))
    spec = get_train_spec("qwen2_audio")
    assert spec.dp_only and spec.head_weight_fn is None
    assert spec.forward_batch_keys == ("input_ids", "inputs_embeds", "input_features",
                                       "feature_attention_mask")


# -- the converters (stages 1 and 3) ------------------------------------------------

def test_converters_cli_round_trip(env, weights, tmp_path):
    """Stage 1: an HF directory (bf16) -> step_0 equal to the JAX
    converter's params_from_hf_state_dict upcast; stage 3: the trainer's
    step -> an HF directory whose tensors equal the trained ones bit for
    bit, read by the port's reader and by JAX's loader, with a config both
    packages load."""
    jp, jc, tc, state = weights
    hf = tmp_path / "hf"
    hf.mkdir()
    sd = convert.params_to_hf_state_dict(tc, {k: v.to(torch.bfloat16) for k, v in state.items()})
    write_safetensors(sd, str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps(convert.hf_config_dict(tc, "bfloat16")))
    exp = tmp_path / "exp"
    convert_hf_to_ckpt.main(["--ckpt_dir", str(exp), "--huggingface_model", str(hf),
                             "--model_type", "qwen2_audio"])
    step0 = read_model(str(exp / "checkpoint" / "step_0" / "model"))
    want = convert.params_from_jax_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jconvert.params_from_hf_state_dict(jc, jload_hf_state_dict(str(hf)))), tc)
    assert set(step0) == set(want)
    for k, v in want.items():
        assert step0[k].dtype == torch.float32 and torch.equal(step0[k], v), k

    trainer = ttrain.main(_flags(env, exp, 2, training_enable_ckpt="true",
                                 training_ckpt_load_step=-1, training_ckpt_interval=100),
                          device=torch.device("cpu"))
    final = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out = convert_ckpt_to_hf.main(["--ckpt_dir", str(exp), "--step", "-1", "--config",
                                   env["cfg"], "--model_type", "qwen2_audio"])
    assert out.endswith("step-2")
    got = read_safetensors(os.path.join(out, "model.safetensors"))
    theirs = jload_hf_state_dict(out)
    assert set(got) == set(final) == set(theirs)
    for k, v in final.items():
        assert torch.equal(got[k], v), k
        np.testing.assert_array_equal(np.asarray(theirs[k]), v.numpy())
    written = json.loads(open(os.path.join(out, "config.json")).read())
    for cfg, ref in ((Qwen2AudioConfig.from_dict(written), tc), (JConfig.from_dict(written), jc)):
        want = ref.to_dict()  # the export names the kernel route, TINY the JAX eager one
        want["text_config"]["attn_implementation"] = "flash"
        assert cfg.to_dict() == want


def test_converters_take_qwen2_audio_and_refuse_kimi(env, tmp_path):
    """qwen2_audio converts; kimi_audio converts too now
    (test_torch_converters.test_kimi_audio_round_trip) and refuses this
    Qwen2-Audio seed, whose tensors are not a Kimi-Audio model's."""
    with pytest.raises(FileNotFoundError, match="no step_<N>"):
        convert_ckpt_to_hf.main(["--ckpt_dir", str(tmp_path), "--model_type", "qwen2_audio",
                                 "--step", "-1", "--config", env["cfg"]])
    with pytest.raises(FileNotFoundError):
        convert_hf_to_ckpt.main(["--ckpt_dir", str(tmp_path), "--model_type", "qwen2_audio",
                                 "--huggingface_model", str(tmp_path)])
    hf = tmp_path / "hf"
    hf.mkdir()
    jp = jax.jit(lambda key: jm.init_params(JConfig.from_dict(TINY), key))(
        jax.random.PRNGKey(0))
    tc = Qwen2AudioConfig.from_dict(TINY)
    write_safetensors(convert.params_to_hf_state_dict(
        tc, convert.params_from_jax_numpy(jax.tree.map(np.asarray, jp), tc)),
        str(hf / "model.safetensors"))
    from test_torch_kimi_audio_sft import RAW as KIMI_RAW

    kimi_cfg = tmp_path / "kimi.json"
    kimi_cfg.write_text(json.dumps(KIMI_RAW))
    with pytest.raises(KeyError, match="HF state dict has no 'model.embed_tokens.weight'"):
        convert_hf_to_ckpt.main(["--ckpt_dir", str(tmp_path), "--model_type", "kimi_audio",
                                 "--huggingface_model", str(hf),
                                 "--training_model_config_path", str(kimi_cfg)])
