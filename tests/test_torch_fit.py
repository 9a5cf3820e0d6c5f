"""Inverse rendering with the PyTorch port (``tpupt_torch.diff.fit``).

The port's and the JAX package's fits cannot be held step for step:
Adam's first step is lr * sign(g), so a leaf whose gradient is near zero
may step either way in each package, and the trajectories part although
both are right.  So the pieces are held apart: ``render_loss`` and its
gradients against the JAX package's in tests/test_torch_fit_loss.py; here
the optimizer against optax on the same gradient arrays (from a numpy
seed), and the port's own counterparts of tests/test_fit.py's three
cases, at its sizes and thresholds, with every frozen leaf bit-unchanged;
and a geometry fit, which rebakes the treelet table.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from test_torch_scene import port_scene
from tpupt_torch.core.camera import make_camera
from tpupt_torch.diff import fit_scene
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES
from tpupt_torch.render.integrator import render_image
from tpupt_torch.scene.bake import rebake_treelets

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

LEAVES = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)
W = H = 24  # test_fit.py's
SPP = 2
MB = 3


def _cam():
    return make_camera(vfov=np.pi / 2)


def _get(params, leaf):
    if leaf.startswith("materials."):
        return params["materials"][leaf.split(".", 1)[1]]
    return params[leaf]


def test_adam_matches_optax():
    """Three steps on the same gradients (one leaf's entries across six
    orders of magnitude, signs mixed): the port's Adam, with the params
    zeroed before each step so that they read back the update itself,
    against optax.adam's updates.  optax runs in float64: in float32 its
    bias correction 1 - 0.999^t starts from 0.999 rounded to float32, 1.3e-5
    relative off, which moves its update 6.7e-6 relative from the exact
    formula that torch evaluates in float64."""
    r = np.random.default_rng(1)
    lr = 5e-2
    grads = [(r.standard_normal((5, 3)) * 10.0 ** r.integers(-6, 1, (5, 3))).astype(np.float32)
             for _ in range(3)]
    p = torch.zeros((5, 3), requires_grad=True)
    torch_opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with jax.enable_x64(True):
        opt = optax.adam(lr)
        state = opt.init(jnp.zeros((5, 3), jnp.float64))
        for g in grads:
            want, state = opt.update(jnp.asarray(g, jnp.float64), state)
            with torch.no_grad():
                p.zero_()
            p.grad = torch.from_numpy(g)
            torch_opt.step()
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6)


# --- the port's own fits (tests/test_fit.py's cases) ----------------------

def _with_materials(scene, **leaves):
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **leaves))


def _target(scene, spp=SPP):
    buf, _ = render_image(scene, _cam(), W, H, spp, max_bounces=MB, differentiable=True)
    return buf.color.detach()


def _assert_frozen(fitted, scene, trained):
    """Every parameter leaf outside ``trained`` is the scene's, bit for
    bit."""
    for leaf in LEAVES:
        if leaf not in trained:
            a = _get({**vars(fitted), "materials": vars(fitted.materials)}, leaf)
            b = _get({**vars(scene), "materials": vars(scene.materials)}, leaf)
            assert torch.equal(a, b), leaf


def test_fit_recovers_albedo(sphere_scene):
    scene = port_scene(sphere_scene)
    target = _target(scene)
    wrong = _with_materials(scene, albedo=torch.tensor([[0.3, 0.3, 0.3], [0.6, 0.6, 0.6]]))
    steps = []
    fitted, losses = fit_scene(wrong, _cam(), target, W, H, steps=60, learning_rate=0.05, spp=SPP,
                               max_bounces=MB, callback=lambda i, loss: steps.append((i, loss)))
    assert steps == list(enumerate(losses)) and len(losses) == 60
    assert losses[-1] < 0.05 * losses[0]
    np.testing.assert_allclose(fitted.materials.albedo.numpy(), scene.materials.albedo.numpy(),
                               atol=0.08)
    _assert_frozen(fitted, wrong, {"materials.albedo", "materials.fuzz", "materials.ior",
                                   "materials.emission", "bg_down", "bg_up"})


def test_fit_background_through_denoiser(sphere_scene):
    """Gradients flow through the a-trous filter (config 4)."""
    scene = port_scene(sphere_scene)
    target = _target(scene, spp=1)
    wrong = dataclasses.replace(scene, bg_down=torch.tensor([0.9, 0.2, 0.2]),
                                bg_up=torch.tensor([0.2, 0.9, 0.2]))
    fitted, losses = fit_scene(wrong, _cam(), target, W, H, steps=50, learning_rate=0.05, spp=1,
                               max_bounces=MB, denoise=True, param_filter=("bg_down", "bg_up"))
    assert losses[-1] < 0.2 * losses[0]
    assert abs(float(fitted.bg_up[1]) - 1.0) < 0.25
    _assert_frozen(fitted, wrong, {"bg_down", "bg_up"})


def test_fit_material_filter_freezes_physical_leaves(full_scene):
    """material_filter restricts the materials group: fuzz and ior come
    back untouched and the fit stays finite on a scene with dielectric and
    metal materials."""
    scene = port_scene(full_scene)
    target = _target(scene)
    wrong = _with_materials(scene, albedo=torch.full_like(scene.materials.albedo, 0.5))
    fitted, losses = fit_scene(wrong, _cam(), target, W, H, steps=25, learning_rate=0.05,
                               spp=SPP, max_bounces=MB, material_filter=("albedo", "emission"))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    _assert_frozen(fitted, wrong, {"materials.albedo", "materials.emission", "bg_down", "bg_up"})


def test_fit_geometry_rebakes(full_scene):
    """fit_geometry=True trains the vertices and spheres too, rebaking the
    treelet table every step: finite losses, moved vertices, and the
    fitted scene's table is the rebake of its own positions."""
    scene = port_scene(full_scene)
    target = _target(scene)
    moved = dataclasses.replace(scene, positions=scene.positions * 1.02)
    fitted, losses = fit_scene(moved, _cam(), target, W, H, steps=3, learning_rate=1e-3, spp=SPP,
                               max_bounces=MB, fit_geometry=True, param_filter=())
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert not torch.equal(fitted.positions, moved.positions)
    assert torch.equal(fitted.tre_tris, rebake_treelets(fitted).tre_tris)
    _assert_frozen(fitted, moved, {"positions", "sphere_center", "sphere_radius"})
