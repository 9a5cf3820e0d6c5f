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


def library_path(extra_flags=()) -> str:
    """Where the library for the current sources (``*.cu`` and the headers
    they include, ``*.cuh``) and flags lives."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtpupt_torch_kernels_{h.hexdigest()[:12]}.so")


def build(extra_flags=()) -> str:
    """Compile the kernels if their library is missing; returns its path.
    One nvcc per source, all started together, then one link.  nvcc's
    register and shared-memory report goes to ``<library>.log``.
    ``extra_flags`` (e.g. ``-DTPUPT_SWEEP_PROFILE``) builds a variant."""
    path = library_path(extra_flags)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([_nvcc(), *compile_flags, *extra_flags, "-c", s, "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    failed = [(s, p.returncode) for s, p in zip(srcs, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra_flags, *objs, "-o", tmp],
                              capture_output=True, text=True, timeout=900)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    with open(path + ".log", "w") as fh:
        fh.write("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed {failed}:\n" + "".join(logs)[-6000:])
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    return bind(build())


def bind(path: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.tpupt_treelet_smem_bytes.restype = ctypes.c_size_t
    lib.tpupt_treelet_smem_bytes.argtypes = [_I, _I]
    lib.tpupt_any_hit_smem_bytes.restype = ctypes.c_size_t
    lib.tpupt_any_hit_smem_bytes.argtypes = [_I, _I]
    lib.tpupt_winner_step_smem_bytes.restype = ctypes.c_size_t
    lib.tpupt_winner_step_smem_bytes.argtypes = [_I]
    lib.tpupt_treelet_closest_hit.restype = _I
    lib.tpupt_treelet_closest_hit.argtypes = [_P] * 12 + [_I, _I, _I] + [_P] * 8
    lib.tpupt_treelet_any_hit.restype = _I
    lib.tpupt_treelet_any_hit.argtypes = [_P] * 12 + [_I, _I, _I] + [_P] * 2
    lib.tpupt_winner_step.restype = _I
    lib.tpupt_winner_step.argtypes = [_P] * 11 + [_I, _I, _I] + [_P] * 7
    lib.tpupt_trip_head.restype = _I
    lib.tpupt_trip_head.argtypes = [_P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P]
    lib.tpupt_trip_nee.restype = _I
    lib.tpupt_trip_nee.argtypes = [_P, _P, _I, _I] + [_P] * 9 + [_I] * 7 + [_P] * 5
    lib.tpupt_trip_tail.restype = _I
    lib.tpupt_trip_tail.argtypes = ([_P, _P, _I] + [_P] * 9 + [_I] * 3 + [_P] + [_I] * 11
                                    + [_P] * 6)
    lib.tpupt_trip_drain_wave.restype = _I
    lib.tpupt_trip_drain_wave.argtypes = [_I, ctypes.POINTER(_I)]
    lib.tpupt_trip_drain.restype = _I
    lib.tpupt_trip_drain.argtypes = ([_P, _P, _I, _P] + [_I] * 5 + [_P] + [_I] * 9
                                     + [_P, _I, _P, _P, _P])
    lib.tpupt_diff_trip_fwd.restype = _I
    lib.tpupt_diff_trip_fwd.argtypes = [_P, _P, _I] + [_P] * 13 + [_I] * 6 + [_P] * 4
    lib.tpupt_diff_trip_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.tpupt_diff_trip_bwd_smem_bytes.argtypes = [_I, _I]
    lib.tpupt_diff_trip_bwd.restype = _I
    lib.tpupt_diff_trip_bwd.argtypes = [_P, _I] + [_P] * 4 + [_I, _P] + [_I] * 7 + [_P] * 4
    lib.tpupt_slot_scatter.restype = _I
    lib.tpupt_slot_scatter.argtypes = [_P, _I, _P, _P, _I, _I, _I, _P]
    lib.tpupt_rcp_check.restype = _I
    lib.tpupt_rcp_check.argtypes = [_P, _P]
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
