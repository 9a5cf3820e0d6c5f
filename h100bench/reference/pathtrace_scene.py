"""The plain reference for a scene that ``pathtrace.py`` cannot render as
it is stated: ``pathtrace.py`` itself, loaded as a module of its own (so
the configurations that name ``pathtrace`` run it unchanged), with three
repairs.

* The scene's top-level "background" key (a color, or one number for all
  three channels) replaces the sky, as the program's
  ``scene_from_json(..., honor_background=True)`` reads it.
* A mesh hit's rows are picked in its own object, whatever the other mesh
  objects' triangle counts (``pathtrace._pick`` indexes every object by
  the winner's index, and fails where another object has fewer
  triangles).
* A ray whose closest t two objects share is flagged tied, as
  ``pathtrace.py`` flags two triangles of one object: brute force gives
  such a tie to the later object, a walk over treelets to the later
  visit, and neither is the scene's answer.

Everything else (parsing, the RNG, shading, next-event estimation with
MIS, the widened box test, the sample loop) is ``pathtrace.py``'s, and
every name not defined here is read from it.  Like it, this module
imports nothing of the program or of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

_SPEC = importlib.util.spec_from_file_location(
    __name__ + "._base", os.path.join(os.path.dirname(os.path.abspath(__file__)), "pathtrace.py"))
_base = importlib.util.module_from_spec(_SPEC)
sys.modules[_SPEC.name] = _base
_SPEC.loader.exec_module(_base)
_mesh_closest = _base.mesh_closest


def __getattr__(name):
    return getattr(_base, name)


def load_scene(scene_path: str, device):
    """``pathtrace.load_scene``, the sky replaced by the scene's
    "background" color where it states one."""
    scene = _base.load_scene(scene_path, device)
    with open(scene_path) as fh:
        bg = json.load(fh).get("background")
    if bg is not None:
        color = [float(bg)] * 3 if isinstance(bg, (int, float)) else [float(c) for c in bg]
        for key in ("bg_down", "bg_up"):
            scene.leaves[key] = torch.tensor(color, dtype=torch.float32, device=scene.device)
    return scene


def _pick(world, obj, idx, key, comp):
    """Component ``comp`` of row ``key`` of each lane's winner, triangle
    ``idx`` of object ``obj``, each object indexed within its own rows."""
    out = torch.zeros(obj.shape, device=obj.device)
    for tris in world:
        col = tris[key][comp]
        out = torch.where(obj == tris["obj"], col[idx.clamp(0, col.shape[0] - 1)], out)
    return out


def mesh_closest(tris, ro, rd, t_min, t_cap, active, ties=None, tie_tris=None):
    """``pathtrace.mesh_closest``; where ``ties`` is given it also gains the
    lanes whose hit here equals ``t_cap``, an earlier object's closest t."""
    hit, t, i = _mesh_closest(tris, ro, rd, t_min, t_cap, active, ties, tie_tris)
    if ties is not None:
        ties |= hit & (t == t_cap)
    return hit, t, i


_base._pick = _pick
_base.mesh_closest = mesh_closest
