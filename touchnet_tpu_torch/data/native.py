# Copyright (c) 2026 touchnet_tpu authors.
# The native audio frontend (native/frontend.cc: kaldi fbank, kaldi MFCC,
# Whisper log-mel), built by g++ at first use and bound with ctypes.
#
# Port of touchnet_tpu/data/native.py, with its build made safe for many
# workers at once. The library lands in build/touchnet_tpu_torch/ under the
# checkout's root (as the CUDA kernels' library, ops/_build.py), named by a
# hash of the source, the flags and the host CPU (-march=native code runs
# only on the CPU it was built for, and the checkout may move to another
# host). g++ writes it under a temporary name in that directory and
# os.replace moves it into place, so a process never loads a half-written
# file, whichever of several concurrent builders finishes first. A failed
# build raises with the compiler's output; nothing falls back to numpy
# quietly. TOUCHNET_NATIVE=0 is the one switch to the numpy DSP
# (data/dsp.py): the map functions of data/functions.py read enabled().
# Nothing is built when the module is imported.

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "frontend.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "touchnet_tpu_torch"
# the JAX package's flags: the same source under the same flags gives the
# same features bit for bit
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_F32P = ctypes.POINTER(ctypes.c_float)
_I, _F, _U64 = ctypes.c_int, ctypes.c_float, ctypes.c_uint64
_SIGNATURES = {
    "touchnet_fbank": [_F32P, _I, _I, _I, _I, _I, _F, _U64, _F32P],
    "touchnet_fbank_num_frames": [_I] * 4,
    "touchnet_mfcc": [_F32P, _I, _I, _I, _I, _I, _F, _U64, _I, _F, _F, _F, _F32P],
    "touchnet_logmel_num_frames": [_I] * 4,
    "touchnet_logmel": [_F32P, _I, _I, _I, _I, _I, _I, _F32P],
}

_lock = threading.Lock()
_lib = None


def enabled() -> bool:
    """False when TOUCHNET_NATIVE=0 asks for the numpy DSP."""
    return os.environ.get("TOUCHNET_NATIVE", "1") != "0"


def _host_cpu() -> str:
    """What -march=native compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    h.update(SRC.read_bytes())
    return Path(build_dir) / f"libtouchnet_frontend_{h.hexdigest()[:16]}.so"


def build(out: Path) -> None:
    """g++ the frontend into ``out``: written under a temporary name in the
    same directory and renamed, so a concurrent loader sees no file or the
    whole one. Raises with the compiler's output when the build fails."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp", dir=out.parent)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) building the native audio "
                               f"frontend from {SRC}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path``, built first when it is not there."""
    path = Path(path)
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL:
    """The process's library, built and loaded on first call (raises when
    TOUCHNET_NATIVE=0 or the build fails)."""
    global _lib
    if not enabled():
        raise RuntimeError("the native audio frontend is off (TOUCHNET_NATIVE=0)")
    with _lock:
        if _lib is None:
            _lib = load(library_path())
    return _lib


def _wave(waveform) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(waveform).reshape(-1), np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _run(fn, frames: int, width: int, *args) -> np.ndarray:
    out = np.empty((max(frames, 0), width), np.float32)
    if frames <= 0:
        return out
    written = fn(*args, _ptr(out))
    if written != frames:
        raise RuntimeError(f"{fn.__name__}: wrote {written} frames, expected {frames}")
    return out


def fbank_native(waveform, num_mel_bins: int, frame_length: int, frame_shift: int,
                 dither: float, sample_frequency: int, dither_seed: int = 0) -> np.ndarray:
    """Kaldi fbank [frames, num_mel_bins]; waveform in int16-scale floats."""
    lib = get_lib()
    wave = _wave(waveform)
    frames = lib.touchnet_fbank_num_frames(wave.size, int(sample_frequency),
                                           int(frame_length), int(frame_shift))
    return _run(lib.touchnet_fbank, frames, num_mel_bins, _ptr(wave), wave.size,
                int(sample_frequency), int(num_mel_bins), int(frame_length),
                int(frame_shift), float(dither), int(dither_seed))


def mfcc_native(waveform, num_mel_bins: int, frame_length: int, frame_shift: int,
                dither: float, num_ceps: int, sample_frequency: int,
                cepstral_lifter: float = 22.0, low_freq: float = 20.0,
                high_freq: float = 0.0, dither_seed: int = 0) -> np.ndarray:
    """Kaldi MFCC [frames, num_ceps] (fbank, DCT-II, lifter); waveform in
    int16-scale floats."""
    lib = get_lib()
    wave = _wave(waveform)
    frames = lib.touchnet_fbank_num_frames(wave.size, int(sample_frequency),
                                           int(frame_length), int(frame_shift))
    return _run(lib.touchnet_mfcc, frames, num_ceps, _ptr(wave), wave.size,
                int(sample_frequency), int(num_mel_bins), int(frame_length),
                int(frame_shift), float(dither), int(dither_seed), int(num_ceps),
                float(cepstral_lifter), float(low_freq), float(high_freq))


def logmel_native(waveform, sample_rate: int, n_fft: int, hop_length: int, n_mels: int,
                  padding: int = 0) -> np.ndarray:
    """Whisper log-mel [frames, n_mels]; waveform in [-1, 1]."""
    lib = get_lib()
    wave = _wave(waveform)
    frames = lib.touchnet_logmel_num_frames(wave.size, int(padding), int(n_fft),
                                            int(hop_length))
    return _run(lib.touchnet_logmel, frames, n_mels, _ptr(wave), wave.size, int(sample_rate),
                int(n_fft), int(hop_length), int(n_mels), int(padding))

