"""Inverse rendering: fit scene parameters to a target image
(counterpart of ``tpupt/diff/fit.py``).

Gradients with respect to the materials (and optionally the background
light and the geometry) through the renderer and the differentiable
a-trous denoiser: BASELINE config 4.  The optimizer is
``torch.optim.Adam`` with the JAX package's optax defaults (b1 0.9, b2
0.999, eps 1e-8 added outside the square root).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from tpupt_torch.core.types import Camera, SceneArrays
from tpupt_torch.denoise.atrous import atrous_denoise
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES, with_params
from tpupt_torch.render.integrator import render_image
from tpupt_torch.scene.bake import rebake_treelets

GEOMETRY = ("sphere_center", "sphere_radius", "positions")


def render_loss(params: dict, scene: SceneArrays, camera: Camera, target: torch.Tensor,
                width: int, height: int, spp: int, max_bounces: int, denoise: bool,
                rebake: bool) -> torch.Tensor:
    """Mean squared error of the differentiable render of ``scene`` with
    ``params`` (``diff.params`` layout) against ``target`` (H*W, 3);
    ``denoise`` filters the render first (``atrous_denoise``,
    filter_size=4), ``rebake`` refreshes the treelet table from the
    positions first."""
    scene = with_params(scene, params)
    if rebake:
        scene = rebake_treelets(scene)
    buf, _ = render_image(scene, camera, width, height, spp, max_bounces=max_bounces,
                          differentiable=True)
    img = buf.color
    if denoise:
        img = atrous_denoise(
            buf.color.reshape(height, width, 3),
            buf.normal.reshape(height, width, 3),
            buf.depth.reshape(height, width),
            camera,
            filter_size=4,
        ).reshape(-1, 3)
    return torch.mean((img - target) ** 2)


def _leaf(t: torch.Tensor, train: bool) -> torch.Tensor:
    """A trained leaf is a copy that requires grad; a frozen one is the
    scene's own tensor."""
    return t.detach().clone().requires_grad_(True) if train else t.detach()


def fit_scene(
    scene: SceneArrays,
    camera: Camera,
    target,  # (H*W, 3) linear-radiance target image
    width: int,
    height: int,
    steps: int = 100,
    learning_rate: float = 5e-2,
    spp: int = 1,
    max_bounces: int = 4,
    denoise: bool = False,
    fit_geometry: bool = False,
    param_filter: Iterable[str] | None = ("materials", "bg_down", "bg_up"),
    material_filter: Iterable[str] | None = None,
    callback: Callable[[int, float], None] | None = None,
):
    """Adam-optimize scene parameters toward ``target``, on the scene's
    device.

    ``param_filter`` names the top-level parameter groups to optimize
    (others stay frozen); pass None for all.  ``material_filter``
    optionally restricts the "materials" group to named leaves (e.g.
    ("albedo", "emission")): unconstrained steps on ``ior`` can walk a
    dielectric through ior = -1, where Schlick's (1-ior)/(1+ior) divides by
    zero.  ``fit_geometry=True`` adds the sphere and vertex parameters and
    rebakes the treelet table every step and once more on the fitted
    scene.  Frozen groups and material leaves are not given to the
    optimizer and come back bit-unchanged.  ``callback(step, loss)`` runs
    after every step.

    Returns (fitted SceneArrays, list of float losses), the loss of step i
    taken before its update."""
    groups = set(PARAM_LEAVES) | {"materials"} if param_filter is None else set(param_filter)
    if fit_geometry:
        groups |= set(GEOMETRY)
    mats = set(MATERIAL_LEAVES) if material_filter is None else set(material_filter)
    params = {name: _leaf(getattr(scene, name), name in groups) for name in PARAM_LEAVES}
    params["materials"] = {
        name: _leaf(getattr(scene.materials, name), "materials" in groups and name in mats)
        for name in MATERIAL_LEAVES
    }
    trained = [t for t in (*params.values(), *params["materials"].values())
               if isinstance(t, torch.Tensor) and t.requires_grad]
    opt = torch.optim.Adam(trained, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device)

    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = render_loss(params, scene, camera, target, width, height, spp, max_bounces,
                           denoise, rebake=fit_geometry)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1])

    with torch.no_grad():
        fitted = with_params(scene, {
            **{k: v.detach() for k, v in params.items() if k != "materials"},
            "materials": {k: v.detach() for k, v in params["materials"].items()},
        })
        if fit_geometry:
            fitted = rebake_treelets(fitted)
    return fitted, losses
