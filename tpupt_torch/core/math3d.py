"""Host-side numpy matrix constructors (counterpart of
``tpupt/core/math3d.py``; the port's device-side vector math is
``core/vec.py``).

Matrices are row-major with the column-vector convention: world = M @ v.
"""

from __future__ import annotations

import itertools

import numpy as np


def _np_normalize(v):
    v = np.asarray(v, np.float64)
    return v / max(float(np.linalg.norm(v)), 1e-30)


def mat_translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def mat_scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    return np.diag(np.concatenate([s, np.ones((1,), np.float32)]))


def mat_rotate(angle_rad: float, axis) -> np.ndarray:
    """Axis-angle rotation (glm::rotate semantics)."""
    x, y, z = _np_normalize(axis)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s, 0.0],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s, 0.0],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def mat_look_at(from_, at, up) -> np.ndarray:
    """Camera-to-world from from/at/up: columns [left, new_up, dir, from]
    with dir = normalize(from - at)."""
    from_ = np.asarray(from_, np.float64)
    dir_ = _np_normalize(from_ - np.asarray(at, np.float64))
    left = _np_normalize(np.cross(np.asarray(up, np.float64), dir_))
    new_up = _np_normalize(np.cross(dir_, left))
    m = np.stack([left, new_up, dir_, from_], axis=1)  # columns
    return np.concatenate([m, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0).astype(
        np.float32
    )


def transform_aabb_np(m, bmin, bmax):
    """8-corner transform of an AABB on the host."""
    m = np.asarray(m, np.float64)
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    pts = []
    for sx, sy, sz in itertools.product([0, 1], repeat=3):
        c = np.array(
            [
                bmax[0] if sx else bmin[0],
                bmax[1] if sy else bmin[1],
                bmax[2] if sz else bmin[2],
            ]
        )
        pts.append(m[:3, :3] @ c + m[:3, 3])
    pts = np.stack(pts, axis=0)
    return pts.min(axis=0), pts.max(axis=0)
