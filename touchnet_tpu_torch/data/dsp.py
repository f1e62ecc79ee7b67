# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/data/dsp.py (framework-free: numpy and scipy),
# its code unchanged. The port's native frontend
# (native/frontend.cc, data/native.py) computes the same features in C++;
# this module is its reference and the TOUCHNET_NATIVE=0 route.
#
# CPU audio DSP primitives (numpy), kaldi- and whisper-compliant.
#
# Capability parity: the reference delegates to torchaudio.compliance.kaldi
# (fbank/mfcc), torch.stft + librosa mel filters (whisper log-mel), and
# sox/torchaudio for resample/speed-perturb (touchnet/data/functions.py:83-190).
# Those are all native C++ under the hood; this module re-implements their
# numerical semantics in numpy so dataloader workers stay dependency-free.
#
# Deviations (documented per SURVEY.md §7):
# - resample uses scipy polyphase (kaiser window) instead of torchaudio's
#   windowed-sinc — same band-limited semantics, slightly different ripple.
# - speed perturb implements sox's "speed" effect as resample of the time
#   axis (pitch+tempo scaling), which is what sox speed does.

import math
from functools import lru_cache
from typing import Optional

import numpy as np
from scipy.signal import resample_poly

EPSILON = np.finfo(np.float32).eps

# ---------------------------------------------------------------------------
# Mel scales
# ---------------------------------------------------------------------------


def mel_scale_kaldi(freq):
    """HTK/kaldi mel scale: 1127 * ln(1 + f/700)."""
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def inverse_mel_scale_kaldi(mel):
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


def hz_to_mel_slaney(freq):
    """Slaney mel scale (librosa default, htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = freq >= min_log_hz
        mels = np.where(log_t, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    elif freq >= min_log_hz:
        mels = min_log_mel + np.log(freq / min_log_hz) / logstep
    return mels


def mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


# ---------------------------------------------------------------------------
# Filterbanks
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def kaldi_mel_banks(
    num_bins: int,
    window_length_padded: int,
    sample_freq: float,
    low_freq: float,
    high_freq: float,
) -> np.ndarray:
    """Kaldi-style triangular mel filterbank over FFT bins [0, N/2).

    Returns [num_bins, window_length_padded // 2] (nyquist bin excluded,
    matching torchaudio.compliance.kaldi.get_mel_banks + zero-pad behavior).
    """
    assert num_bins > 3, "Must have at least 3 mel bins"
    assert window_length_padded % 2 == 0
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq += nyquist
    assert 0.0 <= low_freq < high_freq <= nyquist

    fft_bin_width = sample_freq / window_length_padded
    mel_low = mel_scale_kaldi(low_freq)
    mel_high = mel_scale_kaldi(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    mel = mel_scale_kaldi(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    bins = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return bins.astype(np.float32)


@lru_cache(maxsize=8)
def slaney_mel_filters(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel equivalent (htk=False, norm='slaney', fmin=0,
    fmax=sr/2). Returns [n_mels, 1 + n_fft // 2]."""
    fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min = hz_to_mel_slaney(0.0)
    mel_max = hz_to_mel_slaney(fmax)
    mels = np.linspace(mel_min, mel_max, n_mels + 2)
    mel_f = mel_to_hz_slaney(mels)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # Slaney normalization: each filter integrates to ~constant energy.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# Framing / windows (kaldi semantics)
# ---------------------------------------------------------------------------


def _next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


@lru_cache(maxsize=8)
def _feature_window(window_size: int, window_type: str, blackman_coeff: float = 0.42) -> np.ndarray:
    n = np.arange(window_size, dtype=np.float64)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (window_size - 1))
    elif window_type == "povey":
        w = (0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(window_size)
    elif window_type == "blackman":
        a = 2 * np.pi / (window_size - 1)
        w = blackman_coeff - 0.5 * np.cos(a * n) + (0.5 - blackman_coeff) * np.cos(2 * a * n)
    else:
        raise ValueError(f"invalid window type {window_type!r}")
    return w.astype(np.float64)


def _get_strided_frames(waveform: np.ndarray, window_size: int, window_shift: int,
                        snip_edges: bool = True) -> np.ndarray:
    """[T] -> [num_frames, window_size] with kaldi snip_edges framing."""
    num_samples = waveform.shape[0]
    if snip_edges:
        if num_samples < window_size:
            return np.empty((0, window_size), dtype=waveform.dtype)
        m = 1 + (num_samples - window_size) // window_shift
        strides = (window_shift * waveform.strides[0], waveform.strides[0])
        return np.lib.stride_tricks.as_strided(
            waveform, shape=(m, window_size), strides=strides
        ).copy()
    else:
        # reflect-pad, kaldi snip_edges=False semantics
        m = (num_samples + window_shift // 2) // window_shift
        pad = window_size // 2 - window_shift // 2
        rev = waveform[::-1]
        padded = np.concatenate([rev[-pad:] if pad > 0 else rev[:0], waveform, rev])
        strides = (window_shift * padded.strides[0], padded.strides[0])
        return np.lib.stride_tricks.as_strided(
            padded, shape=(m, window_size), strides=strides
        ).copy()


def _kaldi_window_frames(
    waveform: np.ndarray,
    window_size: int,
    window_shift: int,
    window_type: str = "povey",
    dither: float = 0.0,
    remove_dc_offset: bool = True,
    preemphasis_coefficient: float = 0.97,
    raw_energy: bool = True,
    energy_floor: float = 0.0,
    snip_edges: bool = True,
    rng: Optional[np.random.Generator] = None,
):
    """Kaldi windowing pipeline. Returns (frames [m, window_size] float64,
    log_energy [m])."""
    frames = _get_strided_frames(waveform.astype(np.float64), window_size, window_shift,
                                 snip_edges)
    if dither != 0.0:
        rng = rng or np.random.default_rng()
        frames = frames + dither * rng.standard_normal(frames.shape)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if raw_energy:
        log_energy = np.log(np.maximum((frames**2).sum(axis=1), EPSILON))
    if preemphasis_coefficient != 0.0:
        first = frames[:, :1]
        frames = np.concatenate(
            [first - preemphasis_coefficient * first,
             frames[:, 1:] - preemphasis_coefficient * frames[:, :-1]],
            axis=1,
        )
    frames = frames * _feature_window(window_size, window_type)[None, :]
    if not raw_energy:
        log_energy = np.log(np.maximum((frames**2).sum(axis=1), EPSILON))
    if energy_floor != 0.0:
        log_energy = np.maximum(log_energy, math.log(energy_floor))
    return frames, log_energy


# ---------------------------------------------------------------------------
# Public features
# ---------------------------------------------------------------------------


def fbank(
    waveform: np.ndarray,
    num_mel_bins: int = 23,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    dither: float = 0.0,
    energy_floor: float = 0.0,
    sample_frequency: float = 16000.0,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    use_energy: bool = False,
    use_log_fbank: bool = True,
    use_power: bool = True,
    window_type: str = "povey",
    snip_edges: bool = True,
    round_to_power_of_two: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Kaldi-compatible log-mel filterbank. waveform: [1, T] or [T] in
    int16-scale floats (caller multiplies by 1<<15, matching the reference
    touchnet/data/functions.py:125). Returns [num_frames, num_mel_bins] f32."""
    waveform = np.asarray(waveform).reshape(-1)
    window_size = int(sample_frequency * frame_length * 0.001)
    window_shift = int(sample_frequency * frame_shift * 0.001)
    padded = _next_power_of_2(window_size) if round_to_power_of_two else window_size
    frames, log_energy = _kaldi_window_frames(
        waveform, window_size, window_shift, window_type, dither,
        energy_floor=energy_floor, snip_edges=snip_edges, rng=rng,
    )
    if frames.shape[0] == 0:
        return np.empty((0, num_mel_bins), dtype=np.float32)
    spec = np.fft.rfft(frames, n=padded, axis=1)
    power = np.abs(spec) ** 2 if use_power else np.abs(spec)
    mel_banks = kaldi_mel_banks(
        num_mel_bins, padded, float(sample_frequency), float(low_freq), float(high_freq)
    ).astype(np.float64)
    # nyquist bin excluded by the filterbank; drop it from the spectrum too
    mel_energies = power[:, : padded // 2] @ mel_banks.T
    if use_log_fbank:
        mel_energies = np.log(np.maximum(mel_energies, EPSILON))
    if use_energy:
        mel_energies = np.concatenate([log_energy[:, None], mel_energies], axis=1)
    return mel_energies.astype(np.float32)


@lru_cache(maxsize=4)
def _dct_matrix(num_ceps: int, num_mel_bins: int) -> np.ndarray:
    """Orthonormal DCT-II matrix rows 0..num_ceps-1, [num_mel_bins, num_ceps]."""
    k = np.arange(num_mel_bins, dtype=np.float64)
    dct = np.cos(np.pi / num_mel_bins * (k[:, None] + 0.5) * np.arange(num_mel_bins)[None, :])
    dct[:, 0] *= 1.0 / math.sqrt(2.0)
    dct *= math.sqrt(2.0 / num_mel_bins)
    return dct[:, :num_ceps]


@lru_cache(maxsize=4)
def _lifter_coeffs(num_ceps: int, cepstral_lifter: float) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * cepstral_lifter * np.sin(np.pi * i / cepstral_lifter)


def mfcc(
    waveform: np.ndarray,
    num_mel_bins: int = 23,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    dither: float = 0.0,
    num_ceps: int = 13,
    high_freq: float = 0.0,
    low_freq: float = 20.0,
    sample_frequency: float = 16000.0,
    cepstral_lifter: float = 22.0,
    energy_floor: float = 0.0,
    use_energy: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Kaldi-compatible MFCC: log-mel fbank -> DCT-II -> liftering."""
    feat = fbank(
        waveform,
        num_mel_bins=num_mel_bins,
        frame_length=frame_length,
        frame_shift=frame_shift,
        dither=dither,
        energy_floor=energy_floor,
        sample_frequency=sample_frequency,
        low_freq=low_freq,
        high_freq=high_freq,
        use_energy=False,
        use_log_fbank=True,
        use_power=True,
        rng=rng,
    ).astype(np.float64)
    ceps = feat @ _dct_matrix(num_ceps, num_mel_bins)
    if cepstral_lifter != 0.0:
        ceps = ceps * _lifter_coeffs(num_ceps, cepstral_lifter)[None, :]
    if use_energy:
        _, log_energy = _kaldi_window_frames(
            np.asarray(waveform).reshape(-1),
            int(sample_frequency * frame_length * 0.001),
            int(sample_frequency * frame_shift * 0.001),
            dither=0.0, energy_floor=energy_floor, rng=rng,
        )
        ceps[:, 0] = log_energy
    return ceps.astype(np.float32)


def log_mel_spectrogram(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    n_fft: int = 400,
    hop_length: int = 160,
    n_mels: int = 128,
    padding: int = 0,
) -> np.ndarray:
    """Whisper-style log-mel (reference touchnet/data/functions.py:159-190):
    centered hann STFT, drop last frame, slaney mel, log10 with clamp,
    max-8 floor, (x+4)/4 scaling. Returns [num_frames, n_mels] f32."""
    x = np.asarray(waveform, dtype=np.float64).reshape(-1)
    if padding > 0:
        x = np.concatenate([x, np.zeros(padding)])
    # torch.stft(center=True) reflect-pads n_fft//2 on both sides
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    frames = _get_strided_frames(x, n_fft, hop_length)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)  # periodic hann
    spec = np.fft.rfft(frames * window[None, :], axis=1)  # [T, n_fft//2+1]
    magnitudes = (np.abs(spec) ** 2)[:-1]  # drop last frame (whisper)
    filters = slaney_mel_filters(sample_rate, n_fft, n_mels).astype(np.float64)
    mel_spec = magnitudes @ filters.T
    log_spec = np.log10(np.maximum(mel_spec, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.astype(np.float32)


# ---------------------------------------------------------------------------
# Resampling / speed
# ---------------------------------------------------------------------------


def resample(waveform: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Band-limited polyphase resampling ([..., T] along last axis)."""
    if orig_freq == new_freq:
        return waveform
    g = math.gcd(int(orig_freq), int(new_freq))
    return resample_poly(waveform, new_freq // g, orig_freq // g, axis=-1).astype(
        np.float32
    )


def speed_perturb(waveform: np.ndarray, sample_rate: int, speed: float) -> np.ndarray:
    """sox 'speed' + 'rate' effect: scale both pitch and tempo by `speed`.
    Equivalent to declaring the data at rate sample_rate*speed and resampling
    back to sample_rate."""
    if speed == 1.0:
        return waveform
    orig = int(round(sample_rate * speed))
    return resample(waveform, orig, sample_rate)
