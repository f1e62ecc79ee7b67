# Copyright (c) 2026 touchnet_tpu authors.
# On-device audio frontend: batched kaldi fbank, whisper log-mel and the
# low-frame-rate stack as torch functions on tensors.
#
# Port of touchnet_tpu/ops/frontend.py, one function each:
#   fbank                fbank_jax (:25)
#   log_mel_spectrogram  log_mel_spectrogram_jax (:68)
#   lfr_stack            lfr_stack_jax (:95)
#   device_frontend      device_frontend (:115)
# The JAX module has no Pallas kernel, and this one has no kernel either:
# framing is Tensor.unfold (a strided view), torch.fft.rfft stands where
# JAX uses XLA's batched FFT, and the mel projection is one matmul, as in
# JAX. Each function computes where its input lives; device_frontend puts a
# numpy batch on the card unless it is given another device. The filter
# banks and EPSILON come from the port's data/dsp.py, so the numbers match
# the host path (dsp.fbank, dsp.log_mel_spectrogram,
# functions.audiofeat_stack). No CLI or trainer calls these functions, as
# in JAX: the loaders compute features on the host.

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from touchnet_tpu_torch.data import dsp


def _frames(x: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """[B, T] -> [B, 1 + (T - size) // step, size] strided windows (none
    when T < size, as JAX's max(..., 0))."""
    if x.shape[-1] < size:
        return x.new_zeros((x.shape[0], 0, size))
    return x.unfold(-1, size, step)


def fbank(
    waveform: torch.Tensor,  # [B, T] int16-scale float
    num_mel_bins: int = 23,
    frame_length: int = 25,
    frame_shift: int = 10,
    sample_frequency: int = 16000,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> torch.Tensor:
    """Batched kaldi fbank (snip edges, DC removed, pre-emphasis 0.97, povey
    window, power spectrum, log mel; no dither). Returns [B, num_frames,
    num_mel_bins] float32."""
    ws = int(sample_frequency * frame_length / 1000)
    sh = int(sample_frequency * frame_shift / 1000)
    frames = _frames(waveform.float(), ws, sh)  # [B, m, ws]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    first = frames[..., :1]
    frames = torch.cat([first - 0.97 * first, frames[..., 1:] - 0.97 * frames[..., :-1]], -1)
    n = torch.arange(ws, dtype=torch.float32, device=frames.device)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / (ws - 1))) ** 0.85
    padded = 1 << (ws - 1).bit_length()
    spec = torch.fft.rfft(frames * window, n=padded, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[..., : padded // 2]
    banks = torch.from_numpy(dsp.kaldi_mel_banks(
        num_mel_bins, padded, float(sample_frequency), float(low_freq), float(high_freq)
    )).to(power.device)
    mel = torch.matmul(power, banks.t())
    return torch.log(torch.clamp_min(mel, float(dsp.EPSILON)))


def log_mel_spectrogram(
    waveform: torch.Tensor,  # [B, T]
    sample_rate: int = 16000,
    n_fft: int = 400,
    hop_length: int = 160,
    n_mels: int = 128,
) -> torch.Tensor:
    """Batched whisper log-mel: centred (reflect-padded) periodic-hann STFT,
    the last frame dropped, slaney mel, log10 floored at each utterance's
    max over (frames, mels) less 8, then (x + 4) / 4. Returns [B, frames,
    n_mels] float32."""
    pad = n_fft // 2
    x = F.pad(waveform.float()[:, None], (pad, pad), mode="reflect")[:, 0]  # reflect: 3-D
    frames = _frames(x, n_fft, hop_length)
    n = torch.arange(n_fft, dtype=torch.float32, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2 * math.pi * n / n_fft)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :-1]  # drop the last frame
    filters = torch.from_numpy(dsp.slaney_mel_filters(sample_rate, n_fft, n_mels)).to(x.device)
    mel = torch.matmul(power, filters.t())
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def lfr_stack(feats: torch.Tensor, stack: int, stride: int,
              normalize: bool = True) -> torch.Tensor:
    """Low-frame-rate stack, [B, T, D] -> [B, ceil(T / stride), D * stack]:
    (stack - 1) // 2 copies of the first frame in front, the last frame
    repeated past the end as needed, window i the frames [i * stride,
    i * stride + stack); normalized per output frame by its mean and
    population std (+ 1e-5), as data/functions.audiofeat_stack."""
    B, T, D = feats.shape
    T_lfr = math.ceil(T / stride)
    left = feats[:, :1].expand(B, (stack - 1) // 2, D)
    x = torch.cat([left, feats], dim=1)
    need = (T_lfr - 1) * stride + stack
    if x.shape[1] < need:
        x = torch.cat([x, x[:, -1:].expand(B, need - x.shape[1], D)], dim=1)
    # [B, windows, D, stack] -> the first T_lfr windows, [B, T_lfr, stack * D]
    out = x.unfold(1, stack, stride)[:, :T_lfr].transpose(2, 3).reshape(B, T_lfr, stack * D)
    if normalize:
        out = (out - out.mean(-1, keepdim=True)) / (
            out.std(-1, keepdim=True, correction=0) + 1e-5)  # jnp.std: the population std
    return out


def device_frontend(
    waveform,
    config,
    feat_type: Optional[str] = None,
    device=None,
) -> torch.Tensor:
    """The whole chain driven by a DataConfig: features of the [B, T]
    waveform (in [-1, 1); fbank takes it scaled by 32768), then the LFR
    stack. A numpy batch goes to ``device`` ("cuda" unless given); a tensor
    is computed where it lives unless ``device`` says otherwise. Feature
    types other than fbank and log_mel_spectrogram raise
    NotImplementedError, as in JAX."""
    if not isinstance(waveform, torch.Tensor):
        waveform = torch.as_tensor(np.asarray(waveform, dtype=np.float32),
                                   device=device or "cuda")
    elif device is not None:
        waveform = waveform.to(device)
    feat_type = feat_type or config.audio_feat_type
    if feat_type == "fbank":
        feats = fbank(
            waveform * 32768.0,
            num_mel_bins=config.audiofeat_num_mel_bins,
            frame_length=config.audiofeat_frame_length,
            frame_shift=config.audiofeat_frame_shift,
            sample_frequency=config.audio_resample_rate,
        )
    elif feat_type == "log_mel_spectrogram":
        feats = log_mel_spectrogram(
            waveform,
            sample_rate=config.audio_resample_rate,
            n_fft=config.audiofeat_n_fft,
            hop_length=config.audiofeat_hop_length,
            n_mels=config.audiofeat_num_mel_bins,
        )
    else:
        raise NotImplementedError(f"device frontend for {feat_type!r}")
    return lfr_stack(feats, config.audiofeat_stack_length, config.audiofeat_stride_length,
                     config.audiofeat_normalize)
