"""The scene's differentiable parameters (counterpart of
``tpupt/diff/params.py``).

``extract_params`` splits a ``SceneArrays`` into the float leaves a
gradient makes sense for (materials, the background "light", sphere
geometry, mesh vertex positions) as leaf tensors that require grad;
``with_params`` puts them back into a scene for a differentiable render:

    params = extract_params(scene)
    buf, rays = render_image(with_params(scene, params), camera, w, h,
                             differentiable=True)
    (buf.color ** 2).sum().backward()   # params[...].grad
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpupt_torch.core.types import SceneArrays

PARAM_LEAVES = (
    "sphere_center",
    "sphere_radius",
    "positions",
    "bg_down",
    "bg_up",
)
# emission included: light radiance is an optimizer parameter like the rest
MATERIAL_LEAVES = ("albedo", "fuzz", "ior", "emission")


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def extract_params(scene: SceneArrays) -> dict:
    """{leaf name: tensor} with "materials" a dict of the material leaves:
    copies of the scene's, on its device, that require grad."""
    p = {name: _leaf(getattr(scene, name)) for name in PARAM_LEAVES}
    p["materials"] = {n: _leaf(getattr(scene.materials, n)) for n in MATERIAL_LEAVES}
    return p


def with_params(scene: SceneArrays, params: dict) -> SceneArrays:
    """The scene with its parameter leaves replaced by ``params``'."""
    mats = dataclasses.replace(scene.materials, **params["materials"])
    rest = {k: v for k, v in params.items() if k != "materials"}
    return dataclasses.replace(scene, materials=mats, **rest)


def params_from_numpy(np_params: dict, device="cuda") -> dict:
    """Params of the same layout from numpy arrays, as float32 leaf tensors
    that require grad on ``device`` (the card unless the caller names
    another).  This is how parameters of a scene built elsewhere cross
    over: the caller converts them to numpy on its own side."""

    def leaf(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device).requires_grad_(True)

    p = {name: leaf(np_params[name]) for name in PARAM_LEAVES}
    p["materials"] = {n: leaf(np_params["materials"][n]) for n in MATERIAL_LEAVES}
    return p
