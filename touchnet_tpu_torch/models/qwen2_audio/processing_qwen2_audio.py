# Copyright (c) 2026 touchnet_tpu authors.
# Qwen2-Audio prompts and whisper features: the inference half of
# touchnet_tpu/models/qwen2_audio/processing_qwen2_audio.py, copied
# (numpy only) with its imports pointed at the port's data/dsp.py:
# QWEN2_AUDIO_TEMPLATE_FOR_S2T (:26) and whisper_features (:32).
#
# whisper_features has WhisperFeatureExtractor's semantics: the waveform is
# resampled to 16 kHz, padded with zeros to at least 30 s, and turned into
# a whisper log-mel [frames, n_mels] (3000 frames for 30 s); the frame mask
# covers the audio's own frames, or every frame past 30 s (the reference's
# workaround for long audio: the tower then reads the whole padded input).
# The training half (dynamic_batch, qwen2_audio_datapipe, the frontends)
# comes with the qwen2_audio training slice.

import numpy as np

from touchnet_tpu_torch.data import dsp

QWEN2_AUDIO_TEMPLATE_FOR_S2T = "<|audio_bos|><|AUDIO|><|audio_eos|><|INSTRUCT|>"
_WHISPER_SR = 16000
_WHISPER_MAX_FRAMES = 3000  # 30 s @ 10 ms hop


def whisper_features(waveform: np.ndarray, sample_rate: int, n_mels: int = 128) -> tuple:
    """(features [T_frames, n_mels] f32, frame mask [T_frames] int32) of one
    waveform, padded to >= 30 s."""
    wav = np.asarray(waveform, dtype=np.float32).reshape(-1)
    if sample_rate != _WHISPER_SR:
        wav = dsp.resample(wav, sample_rate, _WHISPER_SR)
    n_samples = wav.shape[0]
    n_frames = n_samples // 160
    pad_to = max(_WHISPER_MAX_FRAMES * 160, n_frames * 160)
    if n_samples < pad_to:
        wav = np.concatenate([wav, np.zeros(pad_to - n_samples, np.float32)])
    feats = dsp.log_mel_spectrogram(wav, _WHISPER_SR, n_fft=400, hop_length=160,
                                    n_mels=n_mels)
    mask = np.zeros(feats.shape[0], np.int32)
    # the reference's >30 s workaround: an all-ones mask for long audio
    if feats.shape[0] > _WHISPER_MAX_FRAMES:
        mask[:] = 1
    else:
        mask[: max(n_frames, 1)] = 1
    return feats, mask
