"""The native SAH BVH builder, compiled on first use.

The JAX package builds its BVHs with ``tpupt/native/bvh_builder.cpp``, a
framework-free C++ file with a plain C interface.  The port compiles that
same source with g++ and the same flags into ``build/tpupt_torch_native/``
and binds it with ctypes, so both packages produce equal trees (and so
equal treelet tables).  The library file that the JAX package keeps next
to its source is never loaded.  Without a source file or a compiler the
port falls back to its numpy builder, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "tpupt", "native", "bvh_builder.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "tpupt_torch_native")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


@functools.lru_cache(maxsize=1)
def _lib():
    """The loaded library, or None when it cannot be built here."""
    if not os.path.exists(_SOURCE):
        return None
    with open(_SOURCE, "rb") as fh:
        tag = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    path = os.path.join(_BUILD_DIR, f"libbvh_{tag}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            subprocess.run(["g++", *_FLAGS, _SOURCE, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    f = lib.tpupt_build_bvh
    f.restype = ctypes.c_int64
    f.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def build_bvh_native(positions: np.ndarray, tris: np.ndarray):
    """FlatBVH from the native builder, or None if it is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    from tpupt_torch.accel.bvh import FlatBVH

    positions = np.ascontiguousarray(positions, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    t = tris.shape[0]
    b = 2 * t - 1
    node_min = np.empty((b, 3), np.float32)
    node_max = np.empty((b, 3), np.float32)
    node_tri = np.empty((b,), np.int32)
    node_skip = np.empty((b,), np.int32)
    rc = lib.tpupt_build_bvh(
        positions.ctypes.data, positions.shape[0], tris.ctypes.data, t,
        node_min.ctypes.data, node_max.ctypes.data,
        node_tri.ctypes.data, node_skip.ctypes.data,
    )
    if rc != b:
        raise RuntimeError(f"native BVH build failed (rc={rc})")
    return FlatBVH(node_min, node_max, node_tri, node_skip)
