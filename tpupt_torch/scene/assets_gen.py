"""Generated stand-in model assets (counterpart of
``tpupt/scene/assets_gen.py``).

The scene JSONs reference ``../models/*.obj`` files that are generated
locally, never downloaded.  Generators, versions and the version tag in
each file's first line are the JAX package's, so the two packages share
one set of files.
"""

from __future__ import annotations

import os

import numpy as np

from tpupt_torch.scene import procedural


def _bump_ajax(v, f):
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    bump = (
        1.0
        + 0.18 * np.sin(6 * x) * np.sin(5 * z)
        + 0.1 * np.cos(7 * y)
        + 0.04 * np.sin(23 * x + 11 * y)
        + 0.02 * np.cos(41 * z - 17 * x)
    )
    v = v * bump[:, None]
    v[:, 0] = v[:, 0] * 4.5 + 0.053126335
    v[:, 1] = v[:, 1] * 14.0 + 17.469807
    v[:, 2] = v[:, 2] * 4.5 - 17.283958
    return v.astype(np.float32), f


def _gen_bunny():
    return procedural.bunny_substitute()  # 5120 tris, bunny-scale


def _gen_ajax():
    return _bump_ajax(*procedural.icosphere(6, 1.0))  # 81,920 tris


def _gen_ajax_hi():
    return _bump_ajax(*procedural.icosphere(7, 1.0))  # 327,680 tris


def _gen_blob():
    v, f = procedural.icosphere(3, 0.5)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    v = v * (1.0 + 0.2 * np.sin(5 * x + 2 * y) * np.cos(4 * z))[:, None]
    return v.astype(np.float32), f


def _gen_knot():
    return procedural.torus_knot(radius=0.9, tube=0.16)


def _gen_quad():
    """Unit quad in the XZ plane centred at the origin (2 triangles)."""
    v = np.array(
        [[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.5, 0.0, 0.5],
         [-0.5, 0.0, 0.5]], np.float32,
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


# name -> (generator, version); the version tags the file's first line
_GENERATORS = {
    "bunny.obj": (_gen_bunny, 1),
    "ajax.obj": (_gen_ajax, 2),
    "ajax_hi.obj": (_gen_ajax_hi, 1),
    "blob.obj": (_gen_blob, 1),
    "knot.obj": (_gen_knot, 1),
    "quad.obj": (_gen_quad, 1),
}


def default_models_dir() -> str:
    return os.path.join(locate_asset_path(), "models")


def locate_asset_path(start: str | None = None) -> str:
    """Walk up from the working directory looking for an assets/ dir,
    falling back to the repository's own."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        cand = os.path.join(d, "assets")
        if os.path.isdir(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "assets",
    )


def ensure_models(models_dir: str | None = None, names=None) -> str:
    """Write any missing or version-stale generated .obj models (all of
    them, or only ``names``); returns the models dir."""
    models_dir = models_dir or default_models_dir()
    os.makedirs(models_dir, exist_ok=True)
    for name in names or _GENERATORS:
        gen, version = _GENERATORS[name]
        path = os.path.join(models_dir, name)
        tag = f"tpupt-gen {name} v{version}"
        if os.path.exists(path):
            with open(path) as fh:
                if fh.readline().strip() == f"# {tag}":
                    continue
        v, f = gen()
        # write-then-rename: a concurrent reader sees the old file or the
        # whole new one, never a partial one
        tmp = f"{path}.tmp{os.getpid()}"
        procedural.write_obj(tmp, v, f, header=tag)
        os.replace(tmp, path)
    return models_dir
