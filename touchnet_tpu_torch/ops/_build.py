# Copyright (c) 2026 touchnet_tpu authors.
# Builds the port's CUDA kernels (ops/csrc/*.cu) at first use and binds them
# with ctypes.
#
# nvcc compiles every source into an object, one nvcc process per source,
# all started together, then links them into one shared library with a
# plain C interface (no PyTorch headers, so the build takes seconds). The
# library
# lands in build/touchnet_tpu_torch/ under the checkout's root, named by a
# hash of the sources and flags, so an edited kernel is rebuilt and an
# unchanged one is loaded as it is. Nothing is built when the module is
# imported: the CPU tests import every module on machines without nvcc.

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "touchnet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "tn_flash_fwd": [_P] * 7 + [_I64] * 9 + [_I] * 10 + [_F, _P],
    "tn_flash_decode": [_P] * 7 + [_I] * 10 + [_F, _P],
    "tn_flash_bwd": [_P] * 12 + [_I] * 10 + [_F, _P, _P],
    "tn_ce_fwd": [_P] * 11 + [_I] * 7 + [_P],
    "tn_ce_bwd": [_P] * 9 + [_I] * 7 + [_P],
}

_lib = None


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "touchnet_tpu_torch are built from source at first use"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtouchnet_tpu_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds) -> None:
    """Run the commands concurrently; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(out: Path) -> None:
    """nvcc every csrc/*.cu (one process each, in parallel) and link them
    into ``out``; written under a temporary name and renamed, so concurrent
    builders never load a half-written file."""
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [os.path.join(tmpdir, f.stem + ".o") for f in cu]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(f)] for f, o in zip(cu, objs)])
        tmp = os.path.join(tmpdir, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call (raises if it cannot be)."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tn_error_string.argtypes = [ctypes.c_int]
        lib.tn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        text = _lib.tn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
