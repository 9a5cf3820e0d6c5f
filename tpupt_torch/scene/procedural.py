"""Procedural test meshes (counterpart of ``tpupt/scene/procedural.py``,
numpy only and output-identical to it, so both packages read the same
generated .obj files).

The reference ships git-LFS models (assets/models/*.obj) that are pointer
files only in this checkout (SURVEY.md §2.4), so the framework generates
its own geometry: an icosphere stands in for the Stanford bunny at a
comparable triangle count, plus a torus knot.
"""

from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 3, radius: float = 1.0):
    """Geodesic sphere: 20 * 4**s triangles (s=4 -> 5120, bunny-scale)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )

    for _ in range(subdivisions):
        edge_mid: dict = {}
        verts_list = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def bunny_substitute():
    """Bunny-scale stand-in: 5120-triangle icosphere squashed into a blobby
    shape so it is not trivially a sphere (BVH still gets real work)."""
    v, f = icosphere(4, 0.5)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    bump = 1.0 + 0.25 * np.sin(4.0 * x) * np.cos(3.0 * z) + 0.15 * np.sin(5.0 * y)
    v = v * bump[:, None]
    v[:, 1] *= 1.15
    return v.astype(np.float32), f


def torus_knot(p: int = 2, q: int = 3, segments: int = 200, sides: int = 16,
               radius: float = 1.0, tube: float = 0.18):
    """(p,q) torus-knot tube mesh: 2 * segments * sides triangles."""
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    r = np.cos(q * t) + 2.0
    center = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1
    ) * (radius / 3.0)
    # frames via finite differences
    nxt = np.roll(center, -1, axis=0)
    tang = nxt - center
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    n1 = np.cross(tang, ref)
    bad = np.linalg.norm(n1, axis=1) < 1e-6
    n1[bad] = np.cross(tang[bad], np.array([0.0, 1.0, 0.0]))
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 = np.cross(tang, n1)

    theta = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False)
    ring = (
        np.cos(theta)[None, :, None] * n1[:, None, :]
        + np.sin(theta)[None, :, None] * n2[:, None, :]
    )
    verts = (center[:, None, :] + tube * ring).reshape(-1, 3)

    faces = []
    for i in range(segments):
        for j in range(sides):
            a = i * sides + j
            b = i * sides + (j + 1) % sides
            c = ((i + 1) % segments) * sides + j
            d = ((i + 1) % segments) * sides + (j + 1) % sides
            faces += [[a, c, b], [b, c, d]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def write_obj(path: str, positions: np.ndarray, tris: np.ndarray, header: str) -> None:
    """Minimal OBJ writer for generated assets.  ``header`` goes into the
    first comment line (assets_gen uses it as a generator-version tag to
    regenerate stale files)."""
    with open(path, "w") as fh:
        fh.write(f"# {header}\n")
        for p in positions:
            fh.write(f"v {p[0]:.7g} {p[1]:.7g} {p[2]:.7g}\n")
        for t in tris:
            fh.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
