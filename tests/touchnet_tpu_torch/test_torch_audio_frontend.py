# The port's audio frontend against the JAX package on the CPU, on inputs
# made by numpy from a seed:
#   - data/dsp.py (fbank, mfcc, Whisper log-mel, resample, speed perturb)
#     against JAX's numpy: atol 1e-5 (the module is a copy; they agree
#     exactly, the bound is the issue's);
#   - the port's native C++ frontend against its numpy: atol and rtol 1e-3
#     for fbank and mfcc, 1e-4 for log-mel (tests/touchnet_tpu/data/
#     test_native.py's limits), and against JAX's native built from its own
#     source with the same flags: equal;
#   - the native library built by 4 processes at once into one fresh path
#     loads in each and gives the same features; a failed build raises
#     with the compiler's output; TOUCHNET_NATIVE=0 takes numpy;
#   - the map functions: resample, the fbank frontend and audiofeat_stack
#     equal JAX's; speed perturb, SpecAug, SpecSub and SpecTrim equal JAX's
#     under one fixed draw (the JAX functions' global random seeded with
#     the port's per-sample seed), and a sample's draws depend only on its
#     draw_seed (so a resume redraws them);
#   - the audio decoders equal JAX's on make_data shards (whole utterances,
#     segment picks, random cuts, offline codes), and what they return
#     stays valid after the dataset is collected;
#   - make_data's audio, metainfo and audiotoken shards are byte-identical
#     to JAX's on the same jsonl.

import copy
import gc
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from touchnet_tpu.bin.make_data import main as jmake_data
from touchnet_tpu.data import DataConfig as JDataConfig
from touchnet_tpu.data import datapipe as jdatapipe
from touchnet_tpu.data import dsp as jdsp
from touchnet_tpu.data import functions as jfunctions
from touchnet_tpu.data import native as jnative
from touchnet_tpu.data.dataset import TouchDataset as JTouchDataset
from touchnet_tpu_torch.bin.make_data import main as make_data
from touchnet_tpu_torch.data import DataConfig, datapipe, dsp, functions, native
from touchnet_tpu_torch.data.dataset import TouchDataset

SR = 16000


def synth_wave(rng, seconds) -> np.ndarray:
    """A voiced tone with a drifting pitch (harmonics 1-5) plus noise, int16."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220) * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t
                                                  + rng.uniform(0, 6)))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.25
    x = x * (0.5 + 0.5 * np.abs(np.sin(2 * np.pi * rng.uniform(1, 4) * t)))
    x = x + 0.01 * rng.standard_normal(n)
    return np.clip(x * 20000, -32768, 32767).astype(np.int16)


def write_audio_jsonl(root, count, seed, lo=0.6, hi=2.5, txt_vocab=None, segments=False):
    """`count` seeded wavs under root and a jsonl of {key, wav, txt} lines:
    txt a list of ids below txt_vocab (RawTokenizer text), else a word; with
    segments, two labelled segments per utterance in info.segments."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(count):
        seconds = float(rng.uniform(lo, hi))
        path = os.path.join(root, f"utt{i}.wav")
        wavfile.write(path, SR, synth_wave(rng, seconds))
        txt = ([int(x) for x in rng.integers(3, txt_vocab, int(rng.integers(2, 6)))]
               if txt_vocab else f"word{i}")
        rec = {"key": f"utt{i}", "wav": path, "txt": txt}
        if segments:
            half = seconds / 2
            rec["info"] = {"segments": [{"start": 0.0, "end": half, "txt": "a"},
                                        {"start": half, "end": seconds, "txt": "b"}]}
        lines.append(json.dumps(rec))
    jsonl = os.path.join(root, "data.jsonl")
    with open(jsonl, "w") as f:
        f.write("\n".join(lines) + "\n")
    return jsonl


def build_audio_shards(save_dir, jsonl, datatypes="audio+metainfo", per_shard=4, extra=()):
    make_data(["--save_dir", str(save_dir), "--jsonl_path", str(jsonl),
               "--num_utt_per_shard", str(per_shard), "--num_workers", "2",
               "--datatypes", datatypes, *extra])
    return os.path.join(str(save_dir), "data.list")


@pytest.fixture(scope="module")
def jax_native_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture
def jax_native(jax_native_dir, monkeypatch):
    """JAX's native library built into a directory of this module's own (its
    loader writes one shared cache path and cannot be raced safely)."""
    monkeypatch.setattr(jnative, "_CACHE_DIR", jax_native_dir)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", False)
    monkeypatch.delenv("TOUCHNET_NATIVE", raising=False)
    assert jnative.get_lib() is not None, "JAX's native frontend did not build"
    return jnative


def _wave(seed, seconds=1.3):
    return synth_wave(np.random.default_rng(seed), seconds).astype(np.float32)


# -- dsp ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fbank", "mfcc", "logmel", "resample", "speed"])
def test_dsp_matches_jax(kind):
    wav = _wave(1)
    if kind == "fbank":
        args = (wav,), dict(num_mel_bins=80, frame_length=25, frame_shift=10, dither=0.0,
                            sample_frequency=SR)
    elif kind == "mfcc":
        args = (wav,), dict(num_mel_bins=40, num_ceps=20, low_freq=40.0, high_freq=-400.0,
                            sample_frequency=SR)
    elif kind == "logmel":
        args = (wav / 32768.0,), dict(sample_rate=SR, n_fft=400, hop_length=160, n_mels=128,
                                      padding=479)
    elif kind == "resample":
        args = (wav[None] / 32768.0, 22050, SR), {}
    else:
        args = (wav[None] / 32768.0, SR, 1.1), {}
    name = {"logmel": "log_mel_spectrogram", "speed": "speed_perturb"}.get(kind, kind)
    got = getattr(dsp, name)(*args[0], **args[1])
    want = getattr(jdsp, name)(*args[0], **args[1])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- native ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fbank", "mfcc", "mfcc_lifter", "logmel400", "logmel512"])
def test_native_matches_numpy_and_jax_native(kind, jax_native):
    wav = _wave(2, 2.0)
    if kind == "fbank":
        call = ("fbank_native", (wav, 80, 25, 10, 0.0, SR), {})
        want = dsp.fbank(wav, num_mel_bins=80, frame_length=25, frame_shift=10,
                         sample_frequency=SR)
        tol = 1e-3
    elif kind.startswith("mfcc"):
        kw = (dict(cepstral_lifter=30.0, low_freq=40.0, high_freq=-400.0)
              if kind == "mfcc_lifter" else {})
        call = ("mfcc_native", (wav, 40, 25, 10, 0.0, 20, SR), kw)
        want = dsp.mfcc(wav, num_mel_bins=40, num_ceps=20, sample_frequency=SR, **kw)
        tol = 1e-3
    else:
        n_fft = int(kind[-3:])
        padding = 479 if n_fft == 400 else 0
        x = wav / 32768.0
        call = ("logmel_native", (x, SR, n_fft, 160, 80), dict(padding=padding))
        want = dsp.log_mel_spectrogram(x, SR, n_fft=n_fft, hop_length=160, n_mels=80,
                                       padding=padding)
        tol = 1e-4
    name, args, kw = call
    got = getattr(native, name)(*args, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got, getattr(jax_native, name)(*args, **kw))


def test_native_short_audio_gives_no_frames():
    assert native.fbank_native(np.zeros(100, np.float32), 23, 25, 10, 0.0, SR).shape == (0, 23)


_BUILD_AND_RUN = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from touchnet_tpu_torch.data import native
lib = native.load({path!r})
native._lib = lib
wav = (np.random.default_rng(0).standard_normal(16000) * 8000).astype(np.float32)
np.save({out!r}, native.fbank_native(wav, 40, 25, 10, 0.0, 16000))
"""


def test_native_concurrent_builds_load_in_each(tmp_path):
    """4 processes build the library into one fresh path at once: each
    loads a whole library (written under a temporary name, then renamed)
    and computes the same features; no temporary file is left behind."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = native.library_path(tmp_path / "build")
    assert not path.exists()
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_RUN.format(
        root=root, path=str(path), out=str(tmp_path / f"out{i}.npy"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    outs = [np.load(tmp_path / f"out{i}.npy") for i in range(4)]
    assert outs[0].shape[1] == 40 and all(np.array_equal(outs[0], o) for o in outs[1:])
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [path.name]


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(tmp_path / "lib.so")
    assert "bad.cc" in str(err.value)
    assert list(tmp_path.iterdir()) == [bad]


def test_native_switch_takes_numpy(monkeypatch):
    """TOUCHNET_NATIVE=0: the fbank function takes the numpy DSP, and the
    native entry points refuse to run."""
    monkeypatch.setenv("TOUCHNET_NATIVE", "0")
    cfg = DataConfig(audiofeat_num_mel_bins=80)
    sample = {"waveform": _wave(3)[None] / 32768.0, "sample_rate": SR}
    got = next(functions.audio_compute_fbank(iter([dict(sample)]), cfg))["audiofeat"]
    want = dsp.fbank(sample["waveform"] * 32768, num_mel_bins=80, sample_frequency=SR)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="TOUCHNET_NATIVE=0"):
        native.fbank_native(sample["waveform"], 80, 25, 10, 0.0, SR)


# -- map functions -------------------------------------------------------------

def _samples(n, seed=4, seconds=(0.6, 2.0)):
    rng = np.random.default_rng(seed)
    return [{"waveform": synth_wave(rng, rng.uniform(*seconds))[None].astype(np.float32)
             / 32768.0, "sample_rate": SR, "draw_seed": f"0.0.0.{i}.{i}"} for i in range(n)]


def _run_port(fn, samples, cfg):
    return list(fn(iter(copy.deepcopy(samples)), cfg))


def _run_jax(fn, samples, cfg, stream=None):
    """The JAX map function sample by sample; with `stream`, the global
    random seeded before each sample as the port seeds its own."""
    out = []
    for s in copy.deepcopy(samples):
        if stream is not None:
            random.seed(f"{stream}:{s['draw_seed']}")
        out += list(fn(iter([s]), cfg))
    return out


def _features(samples, cfg):
    return _run_port(functions.audiofeat_stack, _run_port(
        functions.audio_compute_fbank, samples, cfg), cfg)


@pytest.mark.parametrize("stack,stride,normalize", [(5, 4, True), (7, 6, True), (3, 1, False)])
def test_stack_and_fbank_match_jax(stack, stride, normalize, monkeypatch):
    """Both frontends on numpy (JAX's loader reads TOUCHNET_NATIVE only
    until it has loaded its library once in the process)."""
    monkeypatch.setenv("TOUCHNET_NATIVE", "0")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", False)
    kw = dict(audiofeat_num_mel_bins=80, audiofeat_stack_length=stack,
              audiofeat_stride_length=stride, audiofeat_normalize=normalize)
    samples = _samples(3)
    got = _features(samples, DataConfig(**kw))
    jcfg = JDataConfig(**kw)
    want = _run_jax(jfunctions.audiofeat_stack,
                    _run_jax(jfunctions.audio_compute_fbank, samples, jcfg), jcfg)
    for g, w in zip(got, want):
        assert g["audiofeat"].shape == w["audiofeat"].shape
        assert g["audiofeat"].shape[1] == 80 * stack
        np.testing.assert_array_equal(g["audiofeat"], w["audiofeat"])


def test_resample_matches_jax():
    samples = [dict(s, sample_rate=22050) for s in _samples(2)]
    got = _run_port(functions.audio_resample, samples, DataConfig())
    want = _run_jax(jfunctions.audio_resample, samples, JDataConfig())
    for g, w in zip(got, want):
        assert g["sample_rate"] == w["sample_rate"] == SR
        np.testing.assert_array_equal(g["waveform"], w["waveform"])


AUG = {
    "speed": (functions.audio_speed_perturb, jfunctions.audio_speed_perturb, "waveform", {}),
    "spec_aug": (functions.audiofeat_spec_aug, jfunctions.audiofeat_spec_aug, "audiofeat",
                 dict(audiofeat_spec_aug_max_t=10)),
    "spec_sub": (functions.audiofeat_spec_sub, jfunctions.audiofeat_spec_sub, "audiofeat",
                 dict(audiofeat_spec_sub_max_t=8)),
    "spec_trim": (functions.audiofeat_spec_trim, jfunctions.audiofeat_spec_trim, "audiofeat",
                  dict(audiofeat_spec_trim_max_t=8)),
}


@pytest.mark.parametrize("name", sorted(AUG))
def test_augmentation_matches_jax_under_one_draw(name, monkeypatch):
    monkeypatch.setenv("TOUCHNET_NATIVE", "0")
    fn, jfn, key, kw = AUG[name]
    samples = _samples(6)
    if key == "audiofeat":
        samples = _features(samples, DataConfig(audiofeat_num_mel_bins=40))
    got = _run_port(fn, samples, DataConfig(**kw))
    want = _run_jax(jfn, samples, JDataConfig(**kw), stream=name)
    changed = 0
    for g, w, s in zip(got, want, samples):
        assert g[key].shape == w[key].shape
        np.testing.assert_array_equal(g[key], w[key])
        changed += g[key].shape != s[key].shape or not np.array_equal(g[key], s[key])
    assert changed > 0  # the draws did something
    # the draws depend on the sample's draw_seed alone: the samples in another
    # order (another position in the stream) give the same outputs
    again = _run_port(fn, samples[::-1], DataConfig(**kw))[::-1]
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g[key], a[key])


def test_augmentation_without_draw_seed_raises():
    sample = {"waveform": np.zeros((1, 1600), np.float32), "sample_rate": SR}
    with pytest.raises(ValueError, match="draw_seed"):
        next(functions.audio_speed_perturb(iter([sample]), DataConfig()))


def test_feature_width_and_function():
    assert functions.feature_width(DataConfig(audiofeat_num_mel_bins=80,
                                              audiofeat_stack_length=5)) == 400
    assert functions.feature_width(DataConfig(audio_feat_type="mfcc", audiofeat_num_ceps=13,
                                              audiofeat_stack_length=2)) == 26
    assert functions.feature_function(DataConfig(audio_feat_type="mfcc")) is \
        functions.audio_compute_mfcc
    with pytest.raises(ValueError, match="audio_feat_type"):
        functions.feature_function(DataConfig(audio_feat_type="stft"))


# -- decoders and make_data ----------------------------------------------------

BESTRQ = ["--tokenizer_type", "BestRQTokenizer", "--tokenizer_bestrq_vocab_size", "64",
          "--tokenizer_bestrq_input_size", "161", "--tokenizer_bestrq_emb_size", "8"]


def test_make_data_audio_shards_match_jax(tmp_path, jax_native):
    """audio+metainfo+audiotoken and audio alone: every .bin/.idx byte for
    byte the JAX CLI's, data.list the same up to the directory. Both CLIs'
    frontends run native (the same source and flags), so the offline
    BEST-RQ codes agree too."""
    jsonl = write_audio_jsonl(tmp_path / "wav", 7, seed=5)
    for datatypes, extra in (("audio+metainfo+audiotoken", BESTRQ), ("audio", [])):
        outs = {}
        for name, fn in (("port", make_data), ("jax", jmake_data)):
            save = tmp_path / f"{name}_{datatypes}"
            fn(["--save_dir", str(save), "--jsonl_path", jsonl, "--num_utt_per_shard", "3",
                "--num_workers", "2", "--datatypes", datatypes, *extra])
            outs[name] = save
        port, jax_ = outs["port"], outs["jax"]
        lines = (port / "data.list").read_text().splitlines()
        assert lines == (jax_ / "data.list").read_text().replace(
            str(jax_), str(port)).splitlines()
        assert len(lines) == 3
        for line in lines:
            shard = line.split()[0]
            files = sorted(p.name for p in (port / shard).iterdir())
            assert files == sorted(f"{d}.{e}" for d in datatypes.split("+")
                                   for e in ("bin", "idx"))
            for f in files:
                assert (port / shard / f).read_bytes() == (jax_ / shard / f).read_bytes(), f


def _decode_all(mod, dataset_cls, listfile, datatypes, cfg):
    with open(listfile) as f:
        dirs = [ln.split()[0] for ln in f if ln.strip()]
    items = []
    for d in dirs:
        ds = dataset_cls(d, True, datatypes)
        for i in range(len(ds)):
            items.append(mod._DECODERS[datatypes](ds, i, cfg, seed=i + 3))
    return items


@pytest.mark.parametrize("mode", ["whole", "segments", "random_cut", "audio", "offline_codes"])
def test_decoders_match_jax(tmp_path, mode, jax_native):
    jsonl = write_audio_jsonl(tmp_path / "wav", 6, seed=6, lo=1.0, hi=3.0,
                              segments=mode == "segments")
    datatypes = {"audio": "audio", "offline_codes": "audio+metainfo+audiotoken"}.get(
        mode, "audio+metainfo")
    listfile = build_audio_shards(tmp_path / "shards", jsonl, datatypes, per_shard=3,
                                  extra=BESTRQ if mode == "offline_codes" else ())
    kw = dict(audio_speed_perturb=mode != "offline_codes",
              dataset_load_audio_via_segments=mode == "segments",
              dataset_random_cut_audio=mode == "random_cut",
              dataset_random_cut_audio_min_length_in_ms=500,
              dataset_random_cut_audio_max_length_in_ms=1500)
    got = _decode_all(datapipe, TouchDataset, listfile, datatypes, DataConfig(**kw))
    want = _decode_all(jdatapipe, JTouchDataset, listfile, datatypes, JDataConfig(**kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k
    if mode == "random_cut":
        assert all(0.5 * SR <= g["waveform"].shape[1] <= 1.5 * SR for g in got)


def test_decoded_audio_outlives_its_dataset(tmp_path):
    """The audio decoders copy what they read out of the mmap: the arrays of
    a decoded item are still right after the TouchDataset (and its mmap)
    is collected."""
    jsonl = write_audio_jsonl(tmp_path / "wav", 3, seed=7)
    listfile = build_audio_shards(tmp_path / "shards", jsonl,
                                  "audio+metainfo+audiotoken", per_shard=3, extra=BESTRQ)
    shard = open(listfile).read().split()[0]
    cfg = DataConfig(audio_speed_perturb=False)
    ds = TouchDataset(shard, True, "audio+metainfo+audiotoken")
    items = [datapipe._DECODERS["audio+metainfo+audiotoken"](ds, i, cfg, seed=0)
             for i in range(len(ds))]
    del ds
    gc.collect()
    fresh = TouchDataset(shard, False, "audio+metainfo+audiotoken")
    for i, item in enumerate(items):
        assert item["waveform"].flags.owndata or item["waveform"].base.flags.owndata
        np.testing.assert_array_equal(
            item["waveform"][0], fresh.get(i, "audio").astype(np.float32) / 32768.0)
        np.testing.assert_array_equal(item["audiotoken"], fresh.get(i, "audiotoken"))
