# Copyright (c) 2026 touchnet_tpu authors.
# Port of touchnet_tpu/data/functions.py (framework-free: numpy and the
# standard library): text_tokenize and filter_samples copied, and the audio
# half (:60-256): resample, speed perturb, the fbank / mfcc / log-mel
# frontends, SpecAug / SpecSub / SpecTrim and the low-frame-rate stack.
#
# Two changes in the audio half:
#   - the random draws (speed, masks, substitutions, trims) come from a
#     random.Random that each map function owns, reseeded for every sample
#     from its draw_seed (the root datapipe's epoch, shard and sample
#     counters when it decoded the sample; datapipe.py). The JAX functions
#     draw from the module-level random, shared by every worker thread, so
#     a resumed run draws other speeds than the uninterrupted one; here it
#     draws the same. A sample without a draw_seed raises.
#   - the frontends take the native C++ code (data/native.py) unless
#     TOUCHNET_NATIVE=0, and its build failing raises: the JAX functions
#     fall back to numpy quietly, and their mfcc and log-mel functions
#     raise NameError (they call a `native` module they never import).
#
# Generator map functions of the data pipeline (CPU workers, numpy).
#
# Capability parity: reference touchnet/data/functions.py:32-316 — tokenize,
# length/ratio filters, resample, speed perturb, fbank/mfcc/log-mel frontends,
# SpecAug/SpecSub/SpecTrim, low-frame-rate stacking. Torch/sox/librosa-free:
# the DSP lives in data/dsp.py.

import math
import random

import numpy as np

from touchnet_tpu_torch.data import DataConfig, dsp, native
from touchnet_tpu_torch.tokenizer.tokenizer import BaseTokenizer


def text_tokenize(data, tokenizer: BaseTokenizer):
    """Tokenize sample['txt'] into sample['input_ids'] (bos/eos added later in
    the batchers)."""
    for sample in data:
        if "txt" in sample:
            sample["input_ids"] = tokenizer.tokenize(
                sample["txt"], add_special_tokens=False
            )
            yield sample
        else:
            yield sample


def filter_samples(data, config: DataConfig):
    """Filter by token count, audio duration, and text/audio ratio."""
    for sample in data:
        if "input_ids" in sample:
            num_tokens = len(sample["input_ids"])
            if num_tokens < config.text_min_length_in_tokens_for_filter:
                continue
            if num_tokens > config.text_max_length_in_tokens_for_filter:
                continue
        if "waveform" in sample:
            assert "sample_rate" in sample
            duration = sample["waveform"].shape[1] / sample["sample_rate"] * 1000.0
            if config.audio_speed_perturb:
                duration *= max(config.audio_speed_perturb_speeds)
            if duration < config.audio_min_length_in_ms_for_filter:
                continue
            if duration > config.audio_max_length_in_ms_for_filter:
                continue
            if "input_ids" in sample:
                num_tokens = len(sample["input_ids"])
                if duration > 1e-7:
                    ratio = num_tokens / (duration / 10)
                    if ratio < config.min_text_audio_ratio:
                        continue
                    if ratio > config.max_text_audio_ratio:
                        continue
        yield sample


def _draws(stream: str):
    """reseed(sample) -> the map function's own random.Random, reseeded
    for that sample from its draw_seed (salted by `stream`, so each
    augmentation draws its own numbers)."""
    rng = random.Random()

    def reseed(sample):
        if "draw_seed" not in sample:
            raise ValueError(f"{stream}: the sample has no draw_seed (set by the root "
                             "datapipe's audio decoders); its draws would not be resumable")
        rng.seed(f"{stream}:{sample['draw_seed']}")
        return rng

    return reseed


def audio_resample(data, config: DataConfig):
    for sample in data:
        assert "sample_rate" in sample and "waveform" in sample
        sr = sample["sample_rate"]
        if sr != config.audio_resample_rate:
            sample["sample_rate"] = config.audio_resample_rate
            sample["waveform"] = dsp.resample(
                sample["waveform"], sr, config.audio_resample_rate
            )
        yield sample


def audio_speed_perturb(data, config: DataConfig):
    reseed = _draws("speed")
    for sample in data:
        assert "sample_rate" in sample and "waveform" in sample
        speed = reseed(sample).choice(config.audio_speed_perturb_speeds)
        if speed != 1.0:
            sample["waveform"] = dsp.speed_perturb(
                sample["waveform"], sample["sample_rate"], speed
            )
        yield sample


def audio_compute_fbank(data, config: DataConfig):
    for sample in data:
        assert "sample_rate" in sample and "waveform" in sample
        waveform = sample["waveform"] * (1 << 15)
        if config.audiofeat_dither == 0.0 and native.enabled():
            feat = native.fbank_native(
                waveform,
                num_mel_bins=config.audiofeat_num_mel_bins,
                frame_length=config.audiofeat_frame_length,
                frame_shift=config.audiofeat_frame_shift,
                dither=0.0,
                sample_frequency=sample["sample_rate"],
            )
        else:
            feat = dsp.fbank(
                waveform,
                num_mel_bins=config.audiofeat_num_mel_bins,
                frame_length=config.audiofeat_frame_length,
                frame_shift=config.audiofeat_frame_shift,
                dither=config.audiofeat_dither,
                energy_floor=0.0,
                sample_frequency=sample["sample_rate"],
            )
        sample["audiofeat"] = feat
        yield sample


def audio_compute_mfcc(data, config: DataConfig):
    for sample in data:
        assert "sample_rate" in sample and "waveform" in sample
        waveform = sample["waveform"] * (1 << 15)
        if config.audiofeat_dither == 0.0 and native.enabled():
            feat = native.mfcc_native(
                waveform,
                num_mel_bins=config.audiofeat_num_mel_bins,
                frame_length=config.audiofeat_frame_length,
                frame_shift=config.audiofeat_frame_shift,
                dither=0.0,
                num_ceps=config.audiofeat_num_ceps,
                sample_frequency=sample["sample_rate"],
                low_freq=config.audiofeat_low_freq,
                high_freq=config.audiofeat_high_freq,
            )
        else:
            feat = dsp.mfcc(
                waveform,
                num_mel_bins=config.audiofeat_num_mel_bins,
                frame_length=config.audiofeat_frame_length,
                frame_shift=config.audiofeat_frame_shift,
                dither=config.audiofeat_dither,
                num_ceps=config.audiofeat_num_ceps,
                high_freq=config.audiofeat_high_freq,
                low_freq=config.audiofeat_low_freq,
                sample_frequency=sample["sample_rate"],
            )
        sample["audiofeat"] = feat
        yield sample


def audio_compute_log_mel_spectrogram(data, config: DataConfig):
    """Whisper-style log-mel (see dsp.log_mel_spectrogram)."""
    fn = native.logmel_native if native.enabled() else dsp.log_mel_spectrogram
    for sample in data:
        assert "sample_rate" in sample and "waveform" in sample
        sample["audiofeat"] = fn(
            sample["waveform"],
            sample_rate=sample["sample_rate"],
            n_fft=config.audiofeat_n_fft,
            hop_length=config.audiofeat_hop_length,
            n_mels=config.audiofeat_num_mel_bins,
            padding=config.audiofeat_padding,
        )
        yield sample


FEATURE_FUNCTIONS = {
    "fbank": audio_compute_fbank,
    "mfcc": audio_compute_mfcc,
    "log_mel_spectrogram": audio_compute_log_mel_spectrogram,
}


def feature_function(config: DataConfig):
    """The frontend map function of config.audio_feat_type."""
    if config.audio_feat_type not in FEATURE_FUNCTIONS:
        raise ValueError(f"audio_feat_type {config.audio_feat_type!r}: one of "
                         f"{sorted(FEATURE_FUNCTIONS)}")
    return FEATURE_FUNCTIONS[config.audio_feat_type]


def feature_width(config: DataConfig) -> int:
    """Columns of one stacked feature frame: the frontend's width (num_ceps
    for mfcc, the mel bins otherwise) times the stack length."""
    width = (config.audiofeat_num_ceps if config.audio_feat_type == "mfcc"
             else config.audiofeat_num_mel_bins)
    return width * config.audiofeat_stack_length


def audiofeat_spec_aug(data, config: DataConfig):
    """SpecAugment time/freq masking."""
    reseed = _draws("spec_aug")
    for sample in data:
        assert "audiofeat" in sample
        rng = reseed(sample)
        y = np.array(sample["audiofeat"], copy=True)
        max_frames, max_freq = y.shape
        for _ in range(config.audiofeat_spec_aug_num_t_mask):
            start = rng.randint(0, max_frames - 1)
            length = rng.randint(1, config.audiofeat_spec_aug_max_t)
            end = min(max_frames, start + length)
            y[start:end, :] = 0
        for _ in range(config.audiofeat_spec_aug_num_f_mask):
            start = rng.randint(0, max_freq - 1)
            length = rng.randint(1, config.audiofeat_spec_aug_max_f)
            end = min(max_freq, start + length)
            y[:, start:end] = 0
        sample["audiofeat"] = y
        yield sample


def audiofeat_spec_sub(data, config: DataConfig):
    """Spec substitute (U2++ §3.2.3, arXiv:2106.05642)."""
    reseed = _draws("spec_sub")
    for sample in data:
        assert "audiofeat" in sample
        rng = reseed(sample)
        x = sample["audiofeat"]
        y = np.array(x, copy=True)
        max_frames = y.shape[0]
        for _ in range(config.audiofeat_spec_sub_num_t_sub):
            start = rng.randint(0, max_frames - 1)
            length = rng.randint(1, config.audiofeat_spec_sub_max_t)
            end = min(max_frames, start + length)
            pos = rng.randint(0, start)
            y[start:end, :] = x[start - pos : end - pos, :]
        sample["audiofeat"] = y
        yield sample


def audiofeat_spec_trim(data, config: DataConfig):
    """Trim tailing frames (TrimTail, arXiv:2211.00522)."""
    reseed = _draws("spec_trim")
    for sample in data:
        assert "audiofeat" in sample
        x = sample["audiofeat"]
        max_frames = x.shape[0]
        length = reseed(sample).randint(1, config.audiofeat_spec_trim_max_t)
        if length < max_frames / 2:
            sample["audiofeat"] = np.array(x[: max_frames - length], copy=True)
        yield sample


def audiofeat_stack(data, config: DataConfig):
    """Low-frame-rate stack/stride ([T, D] -> [ceil(T/stride), D*stack]) with
    optional per-frame mean/std normalization (FunASR wav_frontend lineage,
    reference touchnet/data/functions.py:258-286)."""
    stack = config.audiofeat_stack_length
    stride = config.audiofeat_stride_length
    for sample in data:
        assert "audiofeat" in sample
        inputs = np.asarray(sample["audiofeat"])  # (T, D)
        T = inputs.shape[0]
        T_lfr = int(math.ceil(T / stride))
        left_padding = np.tile(inputs[0], ((stack - 1) // 2, 1))
        inputs = np.vstack((left_padding, inputs))
        T = T + (stack - 1) // 2
        feat_dim = inputs.shape[-1]
        last_idx = (T - stack) // stride + 1
        num_padding = stack - (T - last_idx * stride)
        if num_padding > 0:
            num_padding = (
                (2 * stack - 2 * T + (T_lfr - 1 + last_idx) * stride)
                / 2 * (T_lfr - last_idx)
            )
            inputs = np.vstack([inputs] + [inputs[-1:]] * int(num_padding))
        itemsize = inputs.strides[-1]
        outputs = np.lib.stride_tricks.as_strided(
            inputs,
            shape=(T_lfr, stack * feat_dim),
            strides=(stride * feat_dim * itemsize, itemsize),
        )
        if config.audiofeat_normalize:
            outputs = (outputs - outputs.mean(axis=-1, keepdims=True)) / (
                outputs.std(axis=-1, keepdims=True) + 1e-5
            )
        sample["audiofeat"] = np.ascontiguousarray(outputs, dtype=np.float32)
        yield sample
