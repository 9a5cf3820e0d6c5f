"""JSON scene parsing (counterpart of ``tpupt/scene/json_parser.py``) —
same schema as the reference
(src/lib/assets/json_parser.cpp:174-224), so the reference's shipped scenes
load unmodified.

Schema (all reference cites are into json_parser.cpp):
  materials: [{name, type: lambertian|dielectric|metal, ...}]   (:101-122)
  surfaces:  [{type: sphere{radius,transform,material} |
                     mesh{filename,transform,material}}]        (:133-160)
  transform: object {translate|scale|rotate+axis|from/at/up} or an ordered
             array composed left-multiplied m = elem @ m        (:78-95)
  camera:    {transform?, vfov (degrees), resolution?}          (:187-209)
  sampler:   {samples} -> spp, default 1                        (:211-221)

Divergences (documented, deliberate):
  * {"o": [x,y,z]} / {"origin": ...} in a transform is accepted as a
    translation.  The shipped three_balls.json uses "o" which the
    reference's parser would actually `panic` on (json_parser.cpp:70-73) —
    the scene is unusable upstream as shipped.
  * the top-level "background" key, *ignored* by the reference (SURVEY.md
    §2.1 #27), is honored when ``honor_background=True`` (default False for
    reference parity): vec3 or scalar -> constant background color.
  * "accelerator" remains ignored (we always build the BVH).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from tpupt_torch.core.camera import camera_from_matrix, make_camera
from tpupt_torch.core import math3d
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.obj_loader import load_obj


def _mat_from_command(j: dict) -> np.ndarray:
    if "translate" in j:
        return np.asarray(math3d.mat_translate(j["translate"]), np.float64)
    if "o" in j or "origin" in j:
        return np.asarray(math3d.mat_translate(j.get("o", j.get("origin"))), np.float64)
    if "scale" in j:
        return np.asarray(math3d.mat_scale(j["scale"]), np.float64)
    if "rotate" in j:
        angle = math.radians(float(j["rotate"]))
        return np.asarray(math3d.mat_rotate(angle, j["axis"]), np.float64)
    if "from" in j and "at" in j and "up" in j:
        return np.asarray(math3d.mat_look_at(j["from"], j["at"], j["up"]), np.float64)
    raise ValueError(f"Unrecognized transform command: {j}")


def parse_transform(j) -> np.ndarray:
    """Object = single command; array = ordered commands composed
    left-multiplied (m = elem @ m, json_parser.cpp:85-90)."""
    m = np.eye(4)
    if isinstance(j, dict):
        m = _mat_from_command(j)
    elif isinstance(j, list):
        for elem in j:
            m = _mat_from_command(elem) @ m
    else:
        raise ValueError("Transform must be an object or an array")
    return m


def scene_from_json(
    filename: str,
    honor_background: bool = False,
    mesh_loader=load_obj,
) -> SceneDescription:
    with open(filename) as fh:
        j = json.load(fh)
    file_dir = os.path.dirname(os.path.abspath(filename))

    desc = SceneDescription(filename=filename)

    # --- materials ---------------------------------------------------
    for m in j["materials"]:
        name, mtype = m["name"], m["type"]
        if mtype == "lambertian":
            desc.add_material(name, "lambertian", albedo=tuple(m["albedo"]))
        elif mtype == "dielectric":
            desc.add_material(name, "dielectric", refraction_index=float(m["refraction_index"]))
        elif mtype == "metal":
            desc.add_material(name, "metal", albedo=tuple(m["albedo"]), fuzz=float(m["fuzz"]))
        elif mtype == "diffuse_light":  # emissive extension (not in the reference)
            desc.add_material(name, "diffuse_light", emit=tuple(m["emit"]))
        else:
            raise ValueError(f"Unsupported material type {mtype}")

    # --- surfaces ----------------------------------------------------
    for s in j["surfaces"]:
        stype = s["type"]
        material = s["material"]
        transform = parse_transform(s["transform"])
        if stype == "sphere":
            desc.add_sphere(float(s["radius"]), transform, material)
        elif stype == "mesh":
            path = os.path.normpath(os.path.join(file_dir, s["filename"]))
            if desc.get_mesh(path) is None:
                pos, tris = mesh_loader(path)
                desc.add_mesh(path, pos, tris)
            desc.add_mesh_object(path, transform, material)
        else:
            raise ValueError(f"Not supported surface type {stype}")

    # --- camera -------------------------------------------------------
    camera = j["camera"]
    vfov = math.radians(float(camera["vfov"]))
    if "transform" in camera:
        m = parse_transform(camera["transform"])
        desc.camera = camera_from_matrix(m, vfov)
    else:
        desc.camera = make_camera(vfov=vfov)
    if "resolution" in camera:
        w, h = camera["resolution"]
        desc.resolution = (int(w), int(h))

    # --- sampler ------------------------------------------------------
    desc.spp = int(j.get("sampler", {}).get("samples", 1))

    # --- background (extension, see module docstring) -----------------
    if honor_background and "background" in j:
        bg = j["background"]
        if isinstance(bg, (int, float)):
            bg = (float(bg),) * 3
        desc.bg_down = tuple(bg)
        desc.bg_up = tuple(bg)

    return desc
