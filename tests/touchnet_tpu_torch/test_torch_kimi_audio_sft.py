# kimi_audio's SFT path on the port (stages 0-3 of examples/audio/sft/asr/
# wenetspeech/run.sh with model_type kimi_audio) against the JAX package on
# the CPU, on a tiny Kimi config (test_torch_kimi_audio.TINY with 2 text
# layers, the mimo stream forked after layer 0 with 1 mimo layer, and the
# whisper position tables at their real 1500 rows, since the features are
# padded to 30 s), a char-level tokenizer holding Kimi's special tokens at
# the config's ids (test_torch_inference_kimi_audio._tokenizer) and seeded
# synthetic wavs:
#   - dynamic_batch against JAX's on the same samples: every array and
#     num_sentence equal, through budget flushes and both text filters;
#   - the JAX batcher's faults, pinned: a tokenizer whose media marker is
#     one id other than the config's raises at the port's setup (JAX's
#     batcher takes it and its merge finds no span, processing_kimi_audio.
#     py:56-64); a sample whose audio stream holds two begin markers is
#     logged and skipped (JAX raises and ends the run, :118-125);
#   - the datapipe from make_data shards against JAX's loader, with the
#     offline whisper features and with --processor_model (an HF
#     WhisperFeatureExtractor, which the port hands a resampled wave), and
#     its exact resume through the port's loader;
#   - the speech tokenizer's row-chunked block-causal attention: the codes
#     of one row a chunk equal those of all rows at once;
#   - forward under each remat mode against JAX's text logits, and the pack
#     loss and every gradient against jax.grad, f32 (JAX on its plain
#     attention): logits rtol/atol 1e-5, loss rtol 1e-5, the whole gradient
#     rel L2 <= 1e-4 (each tensor too); the tokenizer and the mimo stack get
#     no gradient on either side;
#   - 3 trainer steps against the JAX Trainer's under --optimizer_impl fused
#     (JAX swaps in its optax chain when a parameter is frozen): losses rtol
#     1e-5, then params, mu and nu rtol 2e-6 (test_torch_optimizer.py's
#     bound) with each step's gradients the same on both sides, the speech
#     tokenizer bit-unchanged and JAX's moments for it zero, the mimo stack
#     decayed by prod(1 - lr_t * wd) as JAX decays it;
#   - the frozen regex matching exactly the speech_tokenizer.* tensors;
#   - bin.train.main with the recipe's stage-2 flags and a bit-equal resume.

import contextlib
import copy
import gc
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from touchnet_tpu.bin import TrainConfig as JTrainConfig
from touchnet_tpu.bin.train import Trainer as JTrainer
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.data.dataloader import build_dataloader as jbuild_dataloader
from touchnet_tpu.loss import cross_entropy_loss as jcross_entropy_loss
from touchnet_tpu.models.kimi_audio import modeling_kimi_audio as jm
from touchnet_tpu.models.kimi_audio import processing_kimi_audio as jproc
from touchnet_tpu.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig as JConfig
from touchnet_tpu.models.qwen2_audio.processing_qwen2_audio import (
    whisper_features as jwhisper_features,
)
from touchnet_tpu.tokenizer import TokenizerConfig as JTokenizerConfig
from touchnet_tpu.tokenizer.tokenizer import build_tokenizer as jbuild_tokenizer
from touchnet_tpu.utils.cli import parse_args_into_dataclasses as jparse
from touchnet_tpu_torch.bin import TrainConfig
from touchnet_tpu_torch.bin import train as ttrain
from touchnet_tpu_torch.data import DataConfig
from touchnet_tpu_torch.data.dataloader import build_dataloader
from touchnet_tpu_torch.loss import cross_entropy_loss
from touchnet_tpu_torch.models.kimi_audio import check_mel_bins, convert
from touchnet_tpu_torch.models.kimi_audio import modeling_kimi_audio as tm
from touchnet_tpu_torch.models.kimi_audio import processing_kimi_audio as proc
from touchnet_tpu_torch.models.kimi_audio.configuration_kimi_audio import KimiAudioConfig
from touchnet_tpu_torch.models.qwen2_audio.processing_qwen2_audio import whisper_features
from touchnet_tpu_torch.tokenizer import TokenizerConfig
from touchnet_tpu_torch.tokenizer.tokenizer import build_tokenizer
from touchnet_tpu_torch.utils.train_spec import get_train_spec, is_frozen
from test_torch_audio_frontend import build_audio_shards, synth_wave, write_audio_jsonl
from test_torch_bestrq import _equal_batches, _take
from test_torch_inference_kimi_audio import SPECIALS, _tokenizer
from test_torch_kimi_audio import TINY

RAW = json.loads(json.dumps(TINY))
RAW.update(num_hidden_layers=2, kimia_mimo_layers=1, kimia_mimo_transformer_from_layer_index=0)
RAW["speech_encoder_config"]["max_source_positions"] = 1500
RAW["speech_tokenizer_config"]["max_source_positions"] = 1500
MEL = RAW["speech_encoder_config"]["num_mel_bins"]
BEGIN, END = RAW["kimia_media_begin"], RAW["kimia_media_end"]
MIMO = ("model.mimo_layers.", "model.mimo_norm.", "mimo_output.")
FRAMES = 240  # the model tests' whisper frames (2.4 s)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The char tokenizer, the config file, and make_data shards of 16
    seeded wavs of 0.3-2 s (4 a shard)."""
    root = tmp_path_factory.mktemp("kimi_sft")
    cfg = root / "config.json"
    cfg.write_text(json.dumps(RAW))
    jsonl = write_audio_jsonl(str(root / "wav"), 16, seed=41, lo=0.3, hi=2.0)
    listfile = build_audio_shards(root / "shards", jsonl, per_shard=4)
    devlist = root / "dev.list"  # the first shard
    devlist.write_text(open(listfile).readline())
    return dict(root=root, tok=_tokenizer(root / "tok"), cfg=str(cfg), listfile=listfile,
                devlist=str(devlist))


def _tokenizers(tok_dir):
    kw = dict(tokenizer_type="HuggingFaceTokenizer", tokenizer_model=tok_dir)
    return build_tokenizer(TokenizerConfig(**kw)), jbuild_tokenizer(JTokenizerConfig(**kw))


def _samples(seed=43, n=10):
    """Decoded-sample dicts as the root datapipe yields them: n wavs of
    0.3-2 s, one at 8 kHz, and one whose txt is past the text filter."""
    rng = np.random.default_rng(seed)

    def wav(seconds, rate=16000):
        return synth_wave(rng, seconds * rate / 16000).astype(np.float32) / 32768.0

    out = [{"key": f"utt{i}", "waveform": wav(float(rng.uniform(0.3, 2.0))),
            "sample_rate": 16000, "txt": "word" * int(rng.integers(1, 6))} for i in range(n)]
    out.insert(3, {"key": "rate8k", "waveform": wav(1.2, 8000), "sample_rate": 8000,
                   "txt": "eight"})
    out.insert(7, {"key": "longtxt", "waveform": wav(0.5), "sample_rate": 16000,
                   "txt": "x" * 200})
    return out


@contextlib.contextmanager
def _logged():
    """The messages the port's logger emits while open."""
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
              text_max_length_in_tokens_for_filter=150, text_min_length_in_tokens_for_filter=1,
              dataloader_drop_last_batch=False)
    kw.update(over)
    return kw


def _port_batches(tok, samples, **over):
    return list(proc.dynamic_batch(iter(copy.deepcopy(samples)), DataConfig(**_data_kw(**over)),
                                   lambda w, sr: whisper_features(w, sr, MEL), tok, BEGIN, END,
                                   3000))


def _jax_batches(tok, samples, **over):
    return list(jproc.dynamic_batch(iter(copy.deepcopy(samples)),
                                    JDataConfig(**_data_kw(**over)),
                                    lambda w, sr: jwhisper_features(w, sr, MEL), tok))


# -- dynamic_batch ---------------------------------------------------------------

@pytest.mark.parametrize("batchsize,seqlen,drop_last,min_len", [
    (2, 64, False, 1), (4, 70, True, 1), (3, 90, False, 60)])
def test_dynamic_batch_matches_jax(env, batchsize, seqlen, drop_last, min_len):
    """Budget flushes (a row or more a batch), the max filter (the 200-char
    txt) and, at min_len 60, the min filter (the three shortest rows)."""
    ours, theirs = _tokenizers(env["tok"])
    kw = dict(dataset_batchsize=batchsize, dataset_text_seqlen=seqlen,
              dataloader_drop_last_batch=drop_last, text_min_length_in_tokens_for_filter=min_len)
    got, want = _port_batches(ours, _samples(), **kw), _jax_batches(theirs, _samples(), **kw)
    assert len(got) == len(want) >= 2
    _equal_batches(got, want)
    rows = sum(b["num_sentence"] for b in got)
    assert rows <= 11 and (drop_last or (rows < 11 if min_len > 1 else rows == 11))
    for b in got:
        B, L = b["text_input_ids"].shape
        assert b["audio_input_ids"].shape == (B, L)
        assert b["whisper_input_features"].shape == (B, MEL, 3000)
        assert (B * L <= batchsize * seqlen) or B == 1
        np.testing.assert_array_equal(b["labels"], b["shift_labels"])
        assert ((b["audio_input_ids"] == BEGIN).sum(1) == 1).all()


def test_dynamic_batch_rows_and_labels(env):
    """A row's text stream: user start, the instruct, a blank per audio
    token and five more, the response; its audio stream: a blank per
    instruct token between blank and the media markers holding a blank per
    audio token, then the template's tail and a blank per response token;
    labels the response and eos, shifted by one; sentence_lens the
    response's length + 1 on every position."""
    ours, _ = _tokenizers(env["tok"])
    (b,) = _port_batches(ours, _samples()[:1], dataset_text_seqlen=400)
    text, audio, labels = b["text_input_ids"][0], b["audio_input_ids"][0], b["labels"][0]
    n_tok = int(b["whisper_attention_mask"][0][::2][::4].sum())
    instruct = len(proc.DEFAULT_INSTRUCT)  # one id a character
    blank, eos = SPECIALS[proc.BLANK], SPECIALS[proc.EOS]
    prompt = 1 + instruct + 1 + n_tok + 4
    assert text[0] == SPECIALS["<|im_kimia_user_msg_start|>"]
    assert (text[1 + instruct:prompt] == blank).all()
    assert audio[0] == blank and (audio[1:1 + instruct] == blank).all()
    assert audio[1 + instruct] == BEGIN and audio[2 + instruct + n_tok] == END
    assert (audio[2 + instruct:2 + instruct + n_tok] == blank).all()
    assert (audio[prompt:] == blank).all()
    assert (labels[:prompt - 1] == -100).all() and labels[-1] == eos
    np.testing.assert_array_equal(labels[prompt - 1:-1], text[prompt:])
    assert (b["sentence_lens"][0] == len(text) - prompt + 1).all()


def test_foreign_marker_id_raises_at_setup(env, tmp_path):
    """JAX's setup checks only that each media marker is one id (:56-64):
    with <|im_media_begin|> at another id its batcher runs on and the
    model's _mask_between_markers finds no span, so the speech is never
    merged. The port's datapipe raises at setup, naming the config's id."""
    specials = {**SPECIALS, "<|im_media_begin|>": 199}
    tok_dir = _tokenizer(tmp_path / "tok", specials)
    ours, theirs = _tokenizers(tok_dir)
    (jb,) = _jax_batches(theirs, _samples()[:1], dataset_text_seqlen=400)
    mask = jm._mask_between_markers(jnp.asarray(jb["audio_input_ids"]), BEGIN, END)
    assert not bool(mask.any())
    cfg = DataConfig(**_data_kw(datalist_path=env["listfile"], datapipe_type="kimi_audio"))
    mcfg = KimiAudioConfig.from_dict(RAW)
    with pytest.raises(ValueError, match=r"maps '<\|im_media_begin\|>' to \[199\], not to \[200\]"):
        proc.kimi_audio_datapipe(cfg, ours, 0, 1, model_config=mcfg)
    with pytest.raises(ValueError, match="not to one id"):
        proc.check_special_tokens(
            build_tokenizer(TokenizerConfig(
                tokenizer_type="HuggingFaceTokenizer", tokenizer_model=_tokenizer(
                    tmp_path / "split", {k: v for k, v in SPECIALS.items() if k != proc.BLANK}))),
            mcfg)
    with pytest.raises(ValueError, match="needs the model's config"):
        build_dataloader(cfg, ours, 0, 1)


class _MarkerInBlanks:
    """The char tokenizer, except that a run of exactly `n` blanks (the
    audio stream of a response `n` ids long) holds the begin marker at its
    third id: a tokenizer that passes the setup check and still gives one
    sample's audio stream two begin markers."""

    def __init__(self, tok, n):
        self.tok, self.n, self.pad = tok, n, tok.pad

    def tokenize(self, text, add_special_tokens=False):
        ids = list(self.tok.tokenize(text, add_special_tokens=add_special_tokens))
        if text == proc.BLANK * self.n:
            ids[2] = BEGIN
        return ids


def test_two_span_sample_is_skipped_not_fatal(env):
    """A sample whose audio stream holds two begin markers: the JAX batcher
    raises and ends the run (processing_kimi_audio.py:118-125); the port
    logs the key and skips it, and the other samples batch as JAX batches
    them without it."""
    ours, theirs = _tokenizers(env["tok"])
    samples = _samples()[:6]
    bad = dict(samples[2], key="twospans", txt="abcdefghijk")  # 11 ids
    with pytest.raises(ValueError, match="2 <\\|im_media_begin\\|>"):
        _jax_batches(_MarkerInBlanks(theirs, 11), samples[:2] + [bad])
    with _logged() as lines:
        got = _port_batches(_MarkerInBlanks(ours, 11), samples[:2] + [bad] + samples[2:])
    assert any("'twospans' expands to 2 <|im_media_begin|>" in ln for ln in lines)
    _equal_batches(got, _jax_batches(theirs, samples))


def test_over_30s_sample_is_skipped(env):
    """A wav past 30 s gives the offline extractor more frames than the
    speech tokenizer's position table takes (JAX's forward then fails the
    batch with a shape error); the port logs and skips it."""
    ours, _ = _tokenizers(env["tok"])
    rng = np.random.default_rng(9)
    long = {"key": "long", "waveform": synth_wave(rng, 31.0).astype(np.float32) / 32768.0,
            "sample_rate": 16000, "txt": "long"}
    with _logged() as lines:
        got = _port_batches(ours, [long] + _samples()[:2], dataset_text_seqlen=400)
    assert sum(b["num_sentence"] for b in got) == 2
    assert any("'long' has 3100 whisper frames" in ln for ln in lines)


# -- the datapipe from make_data shards ---------------------------------------

def _loader_kw(env, **over):
    return _data_kw(datalist_path=env["listfile"], datapipe_type="kimi_audio",
                    dataset_text_seqlen=100, **over)


@pytest.mark.parametrize("workers", [1, 2])
def test_datapipe_matches_jax(env, workers):
    ours, theirs = _tokenizers(env["tok"])
    kw = _loader_kw(env, datalist_epoch=1, dataloader_num_workers=workers)
    got = list(build_dataloader(DataConfig(**kw), ours, 0, 1,
                                model_config=KimiAudioConfig.from_dict(RAW)))
    want = list(jbuild_dataloader(JDataConfig(**kw), theirs, 0, 1))
    assert len(got) >= 4 and sum(b["num_sentence"] for b in got) == 16
    _equal_batches(got, want)


@pytest.fixture(scope="module")
def processor_dir(env):
    """A WhisperFeatureExtractor at the tiny config's mel bins, saved as
    --processor_model names one (built here; no download)."""
    import transformers

    path = env["root"] / "processor"
    transformers.WhisperFeatureExtractor(feature_size=MEL).save_pretrained(str(path))
    return str(path)


def test_datapipe_with_processor_model_matches_jax(env, processor_dir):
    """--processor_model: the HF extractor's features (16 kHz shards) in
    both packages' loaders, every batch equal."""
    ours, theirs = _tokenizers(env["tok"])
    kw = _loader_kw(env, datalist_epoch=1, dataloader_num_workers=1,
                    processor_model=processor_dir)
    got = list(build_dataloader(DataConfig(**kw), ours, 0, 1,
                                model_config=KimiAudioConfig.from_dict(RAW)))
    want = list(jbuild_dataloader(JDataConfig(**kw), theirs, 0, 1))
    assert len(got) >= 4 and got[0]["whisper_input_features"].shape[1:] == (MEL, 3000)
    _equal_batches(got, want)


def test_hf_extractor_resamples_to_its_rate(processor_dir):
    """JAX's HF extractor takes an 8 kHz waveform as 16 kHz (:170-179); the
    port's resamples it first, to the features of the resampled wave."""
    from touchnet_tpu_torch.data import dsp

    extract = proc.hf_extractor(processor_dir)
    wav = synth_wave(np.random.default_rng(8), 0.6).astype(np.float32) / 32768.0
    got, mask = extract(wav, 8000)
    want, want_mask = extract(dsp.resample(wav, 8000, 16000), 16000)
    np.testing.assert_array_equal(got, want)
    assert mask.sum() == want_mask.sum() == int(1.2 * 100)


@pytest.mark.parametrize("k", [1, 3])
def test_datapipe_resume_is_exact(env, k):
    """N batches straight against k, the loader's state, and N - k from a
    new loader built on it: every array equal."""
    tok, _ = _tokenizers(env["tok"])
    cfg = DataConfig(**_loader_kw(env, datalist_epoch=3, dataloader_num_workers=2))
    mcfg = KimiAudioConfig.from_dict(RAW)
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
    """JAX params of RAW and the port's state_dict holding them."""
    jc, tc = JConfig.from_dict(RAW), KimiAudioConfig.from_dict(RAW)
    jp = jax.jit(lambda key: jm.init_params(jc, key))(jax.random.PRNGKey(3))
    state = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jp), tc)
    return jp, jc, tc, state


def _trainable(tc, state):
    model = tm.empty_model(tc, torch.float32, "cpu", requires_grad=True, train=True)
    model.load_state_dict(state)
    return model


def _cropped(batch, frames=FRAMES):
    """The batch with its whisper features cut from 30 s to ``frames``
    frames, past every utterance's own (the 0.3-2 s wavs): the speech
    tokenizer's and the tower's frames drop 12x, and every audio token still
    has its speech frame."""
    assert not batch["whisper_attention_mask"][:, frames:].any()
    return {**batch, "whisper_input_features": batch["whisper_input_features"][..., :frames],
            "whisper_attention_mask": batch["whisper_attention_mask"][:, :frames]}


@pytest.fixture(scope="module")
def sft_batch(env):
    """One dynamic_batch batch of 3 rows, its features cropped."""
    tok, _ = _tokenizers(env["tok"])
    (b,) = _port_batches(tok, _samples()[:3], dataset_text_seqlen=400)
    assert b["num_sentence"] == 3
    return _cropped(b)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}


def test_chunked_block_causal_attention_keeps_the_codes(weights, sft_batch):
    """The tokenizer's codes with one row a chunk (chunk_bytes 1) equal those
    of all rows at once, and so do the pooled states."""
    _, _, tc, state = weights
    model = _trainable(tc, state)
    b = _torch_batch(sft_batch)
    feats, mask = b["whisper_input_features"], b["whisper_attention_mask"]
    out = {}
    real = tm.block_causal_attention
    for chunk in (1, 1 << 40):
        tm.block_causal_attention = lambda *a, _c=chunk: real(*a, chunk_bytes=_c)
        try:
            with torch.no_grad():
                out[chunk] = (tm.speech_tokenizer_hidden(
                    model.speech_tokenizer, feats, mask, tc.speech_tokenizer_config,
                    torch.float32),
                    tm.speech_tokenizer_forward(model.speech_tokenizer, feats, mask,
                                                tc.speech_tokenizer_config, torch.float32))
        finally:
            tm.block_causal_attention = real
    assert torch.equal(out[1][1], out[1 << 40][1])
    torch.testing.assert_close(out[1][0], out[1 << 40][0], rtol=0, atol=0)
    q = torch.randn(3, 20, 2, 4, generator=torch.Generator().manual_seed(0))
    fm = torch.ones(3, 20, dtype=torch.int32)
    assert torch.equal(tm.block_causal_attention(q, q, q, fm, 8, 0.5, chunk_bytes=1),
                       tm.block_causal_attention(q, q, q, fm, 8, 0.5))


def _port_logits(tc, model, b, remat):
    return tm.forward(model, text_input_ids=b["text_input_ids"],
                      audio_input_ids=b["audio_input_ids"],
                      whisper_input_features=b["whisper_input_features"],
                      whisper_attention_mask=b["whisper_attention_mask"],
                      segment_ids=b["attention_mask"], config=tc, compute_dtype=torch.float32,
                      remat_mode=remat, selective_ac_option="op")


def _jax_logits(params, jc, batch):
    return jm.forward(params, text_input_ids=jnp.asarray(batch["text_input_ids"]),
                      audio_input_ids=jnp.asarray(batch["audio_input_ids"]),
                      whisper_input_features=jnp.asarray(batch["whisper_input_features"]),
                      whisper_attention_mask=jnp.asarray(batch["whisper_attention_mask"]),
                      segment_ids=jnp.asarray(batch["attention_mask"]), config=jc,
                      compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_logits_loss_and_grads(weights, sft_batch):
    """JAX's text logits, and jax.value_and_grad of its forward plus
    cross_entropy_loss, f32 (jitted: one compile, then the CPU's own
    arithmetic)."""
    jp, jc, _, _ = weights
    batch = sft_batch

    def both(params):
        logits = _jax_logits(params, jc, batch)
        ps, _ = jcross_entropy_loss(logits, jnp.asarray(batch["labels"]),
                                    jnp.asarray(batch["sentence_lens"]), batch["num_sentence"])
        return ps, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(both, has_aux=True))(jp)
    return np.asarray(logits), loss, grads


@pytest.mark.parametrize("remat", ["none", "full", "op_small", "op", "selective"])
def test_forward_under_each_remat_mode_matches_jax(weights, sft_batch,
                                                   jax_logits_loss_and_grads, remat):
    _, _, tc, state = weights
    logits = _port_logits(tc, _trainable(tc, state), _torch_batch(sft_batch), remat)
    np.testing.assert_allclose(logits.detach().numpy(), jax_logits_loss_and_grads[0],
                               rtol=1e-5, atol=1e-5)


def _grad_rel_errors(got, want):
    """Per-tensor squared error and reference norms, summed."""
    num = den = 0.0
    for name, ref in want.items():
        d = float((got[name] - ref).norm()) ** 2
        r = float(ref.norm()) ** 2
        num, den = num + d, den + r
        assert d <= (1e-4) ** 2 * max(r, 1e-20) or d <= 1e-20, name
    return (num / den) ** 0.5


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(weights, sft_batch, jax_logits_loss_and_grads, remat):
    """The loss rtol 1e-5 and every gradient within 1e-4 relative L2 of
    JAX's; the speech tokenizer (no_grad, JAX's stop_gradient) and the mimo
    stack (the text logits do not reach it) get no gradient, where JAX's are
    zeros."""
    _, _, tc, state = weights
    _, jloss, jgrads = jax_logits_loss_and_grads
    model = _trainable(tc, state)
    b = _torch_batch(sft_batch)
    loss, _ = cross_entropy_loss(_port_logits(tc, model, b, remat), b["labels"],
                                 b["sentence_lens"], sft_batch["num_sentence"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jgrads), tc)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    none = {n for n, g in got.items() if g is None}
    assert none == {n for n in got if n.startswith(("speech_tokenizer.",) + MIMO)}
    assert all(not want[n].any() for n in none)
    assert _grad_rel_errors(got, {n: w for n, w in want.items() if n not in none}) <= 1e-4


def test_frozen_regex_matches_the_speech_tokenizer(weights):
    _, _, tc, _ = weights
    spec = get_train_spec("kimi_audio")
    assert spec.frozen_params_re == (r"speech_tokenizer/.*",)
    names = [n for n, _ in tm.empty_model(tc, device="meta").named_parameters()]
    frozen = {n for n in names if is_frozen(spec, n)}
    assert frozen == {n for n in names if n.startswith("speech_tokenizer.")}
    assert len(frozen) == 7 + 15 * RAW["speech_tokenizer_config"]["quantize_position"]
    assert not any(is_frozen(get_train_spec("qwen2_audio"), n) for n in names)


def test_init_params_and_counts(weights):
    _, jc, tc, _ = weights
    model = tm.init_params(tc, torch.Generator().manual_seed(0), requires_grad=True,
                           train=True)
    assert model.training and all(p.requires_grad for p in model.parameters())
    serving = tm.init_params(tc, torch.Generator().manual_seed(0))
    assert not serving.training and not any(p.requires_grad for p in serving.parameters())
    for a, b in zip(model.parameters(), serving.parameters()):
        assert torch.equal(a, b)
    assert tm.get_num_params(tc) == jm.get_num_params(jc)


# -- the trainer -------------------------------------------------------------------

def _flags(env, exp, steps, **over):
    """run.sh's stage-2 flags (:76-141) with model_type kimi_audio on one
    device (dp 1), at the tiny config and the char tokenizer, f32, remat
    full (the card's cut); checkpoints, the dev list and the recipe's
    compile flag come through ``over``."""
    args = {
        "tokenizer_type": "HuggingFaceTokenizer", "tokenizer_model": env["tok"],
        "datapipe_type": "kimi_audio", "datalist_path": env["listfile"],
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
        "training_description": "wenetspeech asr sft (kimi_audio)", "training_seed": 2025,
        "training_model_name": "kimi_audio", "training_model_config_path": env["cfg"],
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


def _adam_state(opt_state):
    return next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))


def _jax_tree_of(like, state):
    """A JAX param tree shaped as ``like`` holding the port's state_dict
    ``state`` (the stacks' layers stacked on [L, ...] again), f32; a None
    tensor becomes zeros."""
    def leaf(path, ref):
        name = ".".join(str(p.key) for p in path)
        stack = next((p for p in convert._STACKS if name.startswith(p)), None)
        names = ([name] if stack is None else
                 [f"{stack}{i}.{name[len(stack):]}" for i in range(ref.shape[0])])
        parts = [np.zeros(ref.shape[1:] if stack else ref.shape, np.float32)
                 if state[n] is None else state[n].numpy() for n in names]
        return jnp.asarray(parts[0] if stack is None else np.stack(parts))

    return jax.tree_util.tree_map_with_path(leaf, like)


def test_train_steps_match_jax_trainer(env, tmp_path, weights):
    """3 steps on a dynamic_batch batch of 8 rows (JAX's dp 8 over its 8
    CPU devices) with its features cropped, through the port's Trainer and
    the JAX Trainer from the same weights, both under --optimizer_impl
    fused. Each step's loss and accuracy come from each side's own forward
    (rtol 1e-5). The gradients are the port's on both sides (held to
    jax.grad's by test_loss_and_grads_match_jax): AdamW turns a last-digit
    gradient difference into an update difference of up to lr on an entry
    whose gradient is near zero, so the optimizers are held to each other on
    equal inputs, params, mu and nu at rtol 2e-6 (atol 1e-9, as
    test_torch_optimizer.py), the grad norm at rtol 1e-6. JAX zeroes the
    frozen tokenizer's gradients and updates; the port gives it none. The
    tokenizer stays bit-unchanged (JAX's moments for it zero, the port holds
    none); the mimo stack, which gets no gradient (JAX's: zeros), decays by
    prod(1 - lr_t * wd) on both sides."""
    _, _, tc, _ = weights
    argv = _flags(env, tmp_path / "port", 3, training_activation_checkpoint_mode="none",
                  dataloader_num_workers=1, training_data_parallel_shard_degree=-1,
                  training_max_norm=0.05)
    trainer = _trainer(argv)
    assert not trainer._fused_ce and trainer.train_spec.head_weight_fn is None
    assert not any(n.startswith("speech_tokenizer.") for n in trainer.param_names)
    gc_on = gc.isenabled()
    jargv = [a.replace(str(tmp_path / "port"), str(tmp_path / "jax")) for a in argv]
    jt = JTrainer(*jparse([JTokenizerConfig, JDataConfig, JTrainConfig], jargv))
    try:
        assert not jt._fused_adamw_enabled(jt.train_spec.frozen_params_re)
        trainer.model.load_state_dict(
            convert.params_from_jax_numpy(jax.tree.map(np.asarray, jt.params), tc))
        seed = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        samples = [s for s in _samples(seed=50) if s["key"].startswith("utt")]

        def forward_only(loss_fn):  # JAX's loss and acc, the port's gradients
            def vg(params, batch, num_sentence):
                grads = batch.pop("grads")
                return loss_fn(params, batch, num_sentence), grads
            return vg

        real_grads, port_grads = trainer._grads_and_metrics, []

        def kept_grads(batch, num_sentence):
            out = real_grads(batch, num_sentence)
            port_grads.append(dict(zip(trainer.param_names, out[0])))
            return out

        jt._value_and_grad = forward_only
        step_fn = jt._build_train_step()
        trainer._grads_and_metrics = kept_grads
        params, opt = jt.params, jt.opt_state
        (batch,) = proc.dynamic_batch(
            iter(samples[:8]), DataConfig(**_data_kw(dataset_batchsize=8, dataset_text_seqlen=400)),
            lambda w, sr: whisper_features(w, sr, MEL), trainer.tokenizer, BEGIN, END, 3000)
        assert batch["num_sentence"] == 8
        batch = _cropped(batch)
        lrs = []
        for step in range(1, 4):  # one batch: JAX compiles its step once
            lrs.append(float(trainer.opt.schedule(trainer.count)))
            met = trainer.train_step(*trainer._put_batch(batch))
            grads = port_grads[-1]
            assert {n for n, g in grads.items() if g is None} == \
                {n for n in trainer.param_names if n.startswith(MIMO)}
            grads = {**{n: None for n in seed}, **grads}
            db, jns = jt._put_batch(batch)
            params, opt, jmet = step_fn(params, opt, {**db, "grads": _jax_tree_of(params, grads)},
                                        jns, step)
            for key in ("loss/per_sample", "loss/per_token", "acc"):
                np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-5,
                                           err_msg=f"step {step} {key}")
            np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                                       rtol=1e-6)
        assert int(trainer.count) == int(_adam_state(opt).count) == 3
        adam = _adam_state(opt)
        want = {"": convert.params_from_jax_numpy(jax.tree.map(np.asarray, params), tc),
                "mu.": convert.params_from_jax_numpy(jax.tree.map(np.asarray, adam.mu), tc),
                "nu.": convert.params_from_jax_numpy(jax.tree.map(np.asarray, adam.nu), tc)}
        got = {"": trainer.model.state_dict(), **{
            k: {n[len(k):]: v for n, v in trainer._opt_state().items() if n.startswith(k)}
            for k in ("mu.", "nu.")}}
        for kind in want:
            for name, ref in want[kind].items():
                if name.startswith("speech_tokenizer."):
                    if kind:
                        assert name not in got[kind] and not ref.any(), kind + name
                    else:
                        assert torch.equal(got[""][name], seed[name])
                        assert torch.equal(ref, seed[name]), name
                    continue
                np.testing.assert_allclose(got[kind][name].numpy(), ref.numpy(), rtol=2e-6,
                                           atol=1e-9, err_msg=kind + name)
        decay = np.prod([np.float32(1) - np.float32(lr) * np.float32(0.1) for lr in lrs])
        for name in got[""]:
            if name.startswith(MIMO):
                np.testing.assert_allclose(got[""][name].numpy(), seed[name].numpy() * decay,
                                           rtol=1e-6, atol=0, err_msg=name)
                assert not got["mu."][name].any() and not got["nu."][name].any()
    finally:
        jt.close()
        trainer.close()
        if gc_on:  # the JAX trainer turns automatic GC off for good
            gc.enable()


def test_bin_train_runs_the_recipe_flags(env, tmp_path):
    """bin.train.main with run.sh's stage-2 flags (checkpoints every 2 and
    the dev list as the recipe's) on the CPU: losses finite, a dev line
    after each save, the speech tokenizer bit-unchanged over the run, and a
    resume from step 2 equal to the straight run."""
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
    init = tm.init_params(KimiAudioConfig.from_json_file(env["cfg"]),
                          torch.Generator().manual_seed(2025))
    for name, p in init.state_dict().items():  # the mimo's zero biases decay to zero
        kept = name.startswith("speech_tokenizer.") or (name.startswith(MIMO) and not p.any())
        assert torch.equal(final[name], p) == kept, name
    resumed = ttrain.main(_flags(env, exp, 4, **{**flags, "training_ckpt_load_step": 2}),
                          device=torch.device("cpu"))
    assert [h["loss/per_sample"] for h in resumed.metrics_processor.history] == losses[2:]
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, final[k]), k
    assert not any(k.startswith("mu.speech_tokenizer.") for k in resumed._opt_state())


def test_trainer_refuses_other_mel_bins(env, tmp_path):
    with pytest.raises(ValueError, match="takes 16 mel bins"):
        _trainer(_flags(env, tmp_path, 2, audiofeat_num_mel_bins=128))
    check_mel_bins(KimiAudioConfig.from_dict(RAW), DataConfig(audiofeat_num_mel_bins=MEL))
