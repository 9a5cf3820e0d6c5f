"""Build and load the hand-written CUDA kernels (``accel/csrc/*.cu``).

The sources have a plain C interface, so they are compiled by nvcc alone
into a shared library and bound with ctypes; no PyTorch headers are
compiled, which keeps the build to seconds.  The library is built at first
use into ``build/tpupt_torch_kernels/`` under a name keyed on the sources
and flags, so an edited source is rebuilt.  Nothing here runs at import.

Flags: ``-O3 -gencode=arch=compute_90a,code=sm_90a --fmad=false``.  There
is no ``--use_fast_math``, and FMA contraction is off on purpose: with it
the kernels round every operation as the torch twins do and agree with
them bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "accel", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpupt_torch_kernels")
NVCC_FLAGS = [
    "-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtpupt_torch_kernels_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the kernels if their library is missing; returns its path.
    nvcc's register and shared-memory report goes to ``<library>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *srcs, "-o", tmp],
                          capture_output=True, text=True, timeout=900)
    with open(path + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    lib.tpupt_treelet_smem_bytes.restype = ctypes.c_size_t
    lib.tpupt_treelet_smem_bytes.argtypes = [_I, _I]
    lib.tpupt_treelet_closest_hit.restype = _I
    lib.tpupt_treelet_closest_hit.argtypes = [_P] * 12 + [_I, _I, _I] + [_P] * 7
    lib.tpupt_winner_step.restype = _I
    lib.tpupt_winner_step.argtypes = [_P] * 11 + [_I, _I, _I] + [_P] * 7
    lib.tpupt_cuda_error_string.restype = ctypes.c_char_p
    lib.tpupt_cuda_error_string.argtypes = [_I]
    return lib


def check(lib, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.tpupt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
