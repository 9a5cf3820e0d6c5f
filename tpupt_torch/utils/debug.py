"""Opt-in NaN guards (counterpart of ``tpupt/utils/debug.py``).

With ``TPUPT_DEBUG`` set, ``check_finite`` raises on a non-finite value in
the tensors it is given; the integrator calls it on the outputs of every
bounce (radiance, throughput, the scattered ray and the normal), not on
everything, because the slab tests compute with infinities on purpose.
Unset, it returns at once.

The JAX package's ``checked_jit`` has no counterpart: it discharges
``checkify`` checks from compiled code and adds index checks, while torch
runs eagerly, so the check raises where it runs, and torch checks its
indices itself.

Usage: ``TPUPT_DEBUG=1 python -m tpupt_torch.cli scene.json -o out.png``.
"""

from __future__ import annotations

import os

import torch


def enabled() -> bool:
    """Read TPUPT_DEBUG each time (tests toggle it per case)."""
    return bool(os.environ.get("TPUPT_DEBUG"))


def check_finite(name: str, *tensors) -> None:
    """Under TPUPT_DEBUG, raise ``RuntimeError`` if a float tensor holds a
    non-finite value.  Each check waits for the device."""
    if not enabled():
        return
    for i, t in enumerate(tensors):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite value in {name}[{i}]")
