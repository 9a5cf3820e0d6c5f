"""Variants of the port's kernel library for the experiments that compare
a design choice on one NVIDIA GPU.

A variant is a copy of ``tpupt_torch/accel/csrc/*.cu`` with text
substitutions, each of which must match the sources exactly once, built
with the library's own nvcc flags under ``build/tpupt_torch_kernels/
variants/``, so the shipped sources keep one value of every choice.
``torch_anyhit_cta.py --variants`` and ``torch_winner_step.py --sweep``
use it; ``torch_trip_head.py`` builds another checkout's sources with no
substitution (``csrc``).
"""

import hashlib
import os
import subprocess


def build(kernels, subs, extra_flags=(), csrc=None):
    """Path of the library built from ``kernels``' sources (or those in
    the directory ``csrc``) with each (old, new) of ``subs`` applied, and
    ``extra_flags`` added; built once per sources, substitutions and
    flags."""
    csrc = csrc or kernels._CSRC
    names = sorted(n for n in os.listdir(csrc) if n.endswith(".cu"))
    text = {}
    for n in names:
        with open(os.path.join(csrc, n)) as fh:
            text[n] = fh.read()
    for old, new in subs:
        hits = [n for n in names if old in text[n]]
        if len(hits) != 1 or text[hits[0]].count(old) != 1:
            raise ValueError(f"variant: {old!r} does not match the sources exactly once")
        text[hits[0]] = text[hits[0]].replace(old, new)
    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS + list(extra_flags)).encode())
    for n in names:
        h.update(text[n].encode())
    out_dir = os.path.join(kernels.BUILD_DIR, "variants", h.hexdigest()[:12])
    path = os.path.join(out_dir, "libtpupt_torch_kernels.so")
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    for n in names:
        with open(os.path.join(out_dir, n), "w") as fh:
            fh.write(text[n])
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *extra_flags,
                           *(os.path.join(out_dir, n) for n in names), "-o", path],
                          capture_output=True, text=True, timeout=900)
    with open(path + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on a variant ({proc.returncode}):\n{proc.stderr}")
    return path
