# The on-device audio frontend (touchnet_tpu_torch.ops.frontend) on the CPU
# against touchnet_tpu/ops/frontend.py's XLA functions and against the host
# path (the port's data/dsp.py and data/functions.audiofeat_stack), on the
# same numpy inputs and at the shapes of tests/touchnet_tpu/ops/
# test_frontend.py. Tolerances are that file's: fbank 2e-3 (log of a power
# spectrum from an FFT in f32: two FFT implementations differ by ~1e-6 of
# the power, which the log turns into ~1e-3 where the power is small),
# log-mel and the LFR stack 2e-4.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.ops import frontend as jfrontend
from touchnet_tpu_torch.data import DataConfig, dsp, functions
from touchnet_tpu_torch.ops import frontend

CPU = torch.device("cpu")


def test_fbank_matches_jax_and_host():
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 16000)) * 8000).astype(np.float32)
    got = frontend.fbank(torch.from_numpy(wav), num_mel_bins=40)
    assert got.dtype == torch.float32 and got.shape == (2, 98, 40)
    want = np.asarray(jfrontend.fbank_jax(jnp.asarray(wav), num_mel_bins=40))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    for b in range(2):
        host = dsp.fbank(wav[b], num_mel_bins=40, sample_frequency=16000)
        np.testing.assert_allclose(got[b].numpy(), host, atol=2e-3, rtol=2e-3)


def test_logmel_matches_jax_and_host():
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((2, 8000)).astype(np.float32) * 0.1
    got = frontend.log_mel_spectrogram(torch.from_numpy(wav), n_mels=64)
    assert got.shape == (2, 50, 64)
    want = np.asarray(jfrontend.log_mel_spectrogram_jax(jnp.asarray(wav), n_mels=64))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    for b in range(2):
        host = dsp.log_mel_spectrogram(wav[b], n_mels=64)
        np.testing.assert_allclose(got[b].numpy(), host, atol=2e-4, rtol=2e-4)


def test_logmel_floor_is_per_utterance():
    """The floor is each utterance's own max over (frames, mels) less 8: a
    quiet row beside a loud one keeps its own dynamic range."""
    rng = np.random.default_rng(4)
    wav = rng.standard_normal((2, 4000)).astype(np.float32)
    wav[1] *= 1e-4
    got = frontend.log_mel_spectrogram(torch.from_numpy(wav), n_mels=32).numpy()
    for b in range(2):
        np.testing.assert_allclose(got[b], dsp.log_mel_spectrogram(wav[b], n_mels=32),
                                   atol=2e-4, rtol=2e-4)


# (T, stack, stride): the JAX test's shape (no tail padding), one that pads
# the tail (98 frames: 101 after the left frames, 103 needed), and BEST-RQ's
# stack 5 stride 4 (101 frames: 103 after the left frames, 105 needed)
@pytest.mark.parametrize("T,stack,stride", [(100, 7, 6), (98, 7, 6), (101, 5, 4)])
@pytest.mark.parametrize("normalize", [True, False])
def test_lfr_stack_matches_jax_and_host(T, stack, stride, normalize):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((T, 23)).astype(np.float32)
    cfg = DataConfig(audiofeat_stack_length=stack, audiofeat_stride_length=stride,
                     audiofeat_normalize=normalize)
    host = list(functions.audiofeat_stack(iter([{"audiofeat": feats}]), cfg))[0]["audiofeat"]
    got = frontend.lfr_stack(torch.from_numpy(feats)[None], stack, stride, normalize)[0]
    assert got.shape == host.shape == (-(-T // stride), 23 * stack)
    np.testing.assert_allclose(got.numpy(), host, atol=2e-4, rtol=2e-4)
    want = np.asarray(jfrontend.lfr_stack_jax(jnp.asarray(feats)[None], stack, stride,
                                              normalize))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("feat_type,extra,atol", [
    ("fbank", {}, 2e-3),  # the default 23 bins x stack 7, stride 6
    ("log_mel_spectrogram", dict(audiofeat_num_mel_bins=128), 2e-4),  # the SFT recipe's
])
def test_device_frontend_matches_jax(feat_type, extra, atol):
    """The whole chain on a [2, 16000] batch in [-1, 1), given as numpy
    with device=cpu: JAX's device_frontend within the feature's tolerance."""
    wav = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 16000)).astype(np.float32)
    kw = dict(audio_feat_type=feat_type, **extra)
    got = frontend.device_frontend(wav, DataConfig(**kw), device=CPU)
    want = np.asarray(jfrontend.device_frontend(jnp.asarray(wav), JDataConfig(**kw)))
    assert got.device == CPU and got.shape == want.shape
    if feat_type == "fbank":
        assert got.shape == (2, 17, 23 * 7)  # 98 frames -> ceil(98 / 6)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=atol)


def test_device_frontend_places_its_input():
    """A numpy batch goes to the card unless told otherwise (this machine
    has none: that raises); a tensor is computed where it lives; another
    feature type raises NotImplementedError, as JAX's."""
    cfg = DataConfig()
    wav = np.zeros((1, 1600), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            frontend.device_frontend(wav, cfg)
    out = frontend.device_frontend(torch.from_numpy(wav), cfg)
    assert out.device == CPU and out.shape == (1, 2, 23 * 7)
    with pytest.raises(NotImplementedError, match="mfcc"):
        frontend.device_frontend(wav, cfg, feat_type="mfcc", device=CPU)
