"""Wavefront OBJ loading (counterpart of ``tpupt/scene/obj_loader.py``).

Positions and fan-triangulated faces, negative indices supported,
everything else ignored.  The port uses the pure-Python parser; its arrays
equal the JAX package's native parser's on the shipped scenes.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns (positions (V, 3) f32, tris (T, 3) i32)."""
    positions: list = []
    tris: list = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    # f v, f v/vt, f v/vt/vn, f v//vn
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))
    if not positions or not tris:
        raise ValueError(f"OBJ file {path!r} has no triangles")
    return np.asarray(positions, np.float32), np.asarray(tris, np.int32)
