"""The differentiable render and the denoiser of the PyTorch port against
the JAX package, and the port's own finite-difference checks (CPU: the
port runs its torch twins).

Setting: ``tests/test_grads.py``'s, 24^2, 1 spp, 4 bounces, loss
sum(color^2) (``bench.py``'s fwd+bwd loss against a zero target), gradients
to every ``extract_params`` leaf.  The traced-segment count must be EQUAL;
the loss is held at test_torch_render.py's IMAGE tolerance (rtol 1e-4, atol
1e-5: the two packages' float32 sqrt, rsqrt, sin and cos differ in the
last bit); each leaf's gradient at rtol 1e-4 with an absolute floor of
1e-4 x max|g| of the leaf (BASELINE.json's 1e-4 pixel-gradient tolerance).
The largest gap, 8e-5 x max|g|, is the radius of the radius-100 ground
sphere, whose quadratic cancels ~10^4 down to ~10 (ROADMAP section 3).

The denoiser is held at rtol 1e-5, atol 1e-6 forward (the two packages'
float32 exp rounds differently in the last bit) and its gradients at rtol
1e-4 with a floor of 1e-5 x max|g|: the backward pass sums each pixel's
cotangent over the 25 taps of three passes, in another order in each
package (measured: 2.4e-6 of a max|g| of 1.34 on depth).  The reference
runs op by op, as test_grads.py runs it (compiling its gradient takes
minutes).

JAX references are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.denoise.atrous import atrous_denoise as jax_atrous_denoise
from tpupt.diff.params import extract_params as jax_extract_params
from tpupt.diff.params import with_params as jax_with_params
from tpupt.render.integrator import render_image as jax_render_image

from test_torch_scene import port_scene
from tpupt_torch import atrous_denoise, extract_params, params_from_numpy, with_params
from tpupt_torch.core import math3d as m3
from tpupt_torch.core.camera import make_camera
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES
from tpupt_torch.render.integrator import render_image
from tpupt_torch.scene.description import SceneDescription

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

W = H = 24
IMAGE = dict(rtol=1e-4, atol=1e-5)
LEAVES = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)
SCENES = ("sphere_scene", "full_scene")


def _cam():
    return make_camera(vfov=np.pi / 2)


def _get(params, leaf):
    if leaf.startswith("materials."):
        return params["materials"][leaf.split(".", 1)[1]]
    return params[leaf]


def _render(scene, params, w=W, h=H, max_bounces=4):
    return render_image(with_params(scene, params), _cam(), w, h, 1, max_bounces=max_bounces,
                        differentiable=True)


def _port_grads(pscene, params):
    """(loss, rays, {leaf: gradient as numpy}); a leaf the render does not
    reach gets zeros, as jax.grad gives."""
    buf, rays = _render(pscene, params)
    loss = (buf.color ** 2).sum()
    leaves = [_get(params, k) for k in LEAVES]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), int(rays), {k: g.numpy() for k, g in zip(LEAVES, grads)}


@pytest.fixture(scope="module")
def both(request):
    """Per scene: the JAX package's loss, ray count and gradients, and the
    port's, from the same parameters."""
    out = {}
    for name in SCENES:
        jscene = request.getfixturevalue(name)

        def loss_fn(p):
            buf, rays = jax_render_image(jax_with_params(jscene, p), jax_make_camera(vfov=np.pi / 2),
                                         W, H, 1, max_bounces=4, differentiable=True)
            return jnp.sum(buf.color ** 2), rays

        jp = jax_extract_params(jscene)
        (jl, jr), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
        jg = jax.tree_util.tree_map(np.asarray, jg)
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        pscene = port_scene(jscene)
        out[name] = dict(
            jax=(float(jl), int(jr), {k: _get(jg, k) for k in LEAVES}),
            port=_port_grads(pscene, params_from_numpy(np_params, "cpu")),
            pscene=pscene, np_params=np_params,
        )
    return out


@pytest.mark.parametrize("name", SCENES)
def test_loss_and_ray_count_match_jax(both, name):
    (jl, jr, _), (pl, pr, _) = both[name]["jax"], both[name]["port"]
    assert pr == jr > W * H
    np.testing.assert_allclose(pl, jl, **IMAGE)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", SCENES)
def test_leaf_gradient_matches_jax(both, name, leaf):
    want, got = both[name]["jax"][2][leaf], both[name]["port"][2][leaf]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_russian_roulette_render_matches_jax(both, sphere_scene):
    """With rr_start the differentiable bounce applies roulette to every
    lane from that bounce on: equal ray count, loss and albedo gradient."""
    kw = dict(max_bounces=4, differentiable=True, rr_start=1)

    def loss_fn(a):
        s = sphere_scene.replace(materials=sphere_scene.materials.replace(albedo=a))
        buf, rays = jax_render_image(s, jax_make_camera(vfov=np.pi / 2), 16, 16, 1, **kw)
        return jnp.sum(buf.color ** 2), rays

    (jl, jr), jg = jax.value_and_grad(loss_fn, has_aux=True)(sphere_scene.materials.albedo)
    pscene = both["sphere_scene"]["pscene"]
    params = extract_params(pscene)
    buf, pr = render_image(with_params(pscene, params), _cam(), 16, 16, 1, **kw)
    loss = (buf.color ** 2).sum()
    (g,) = torch.autograd.grad(loss, params["materials"]["albedo"])
    assert int(pr) == int(jr) and int(pr) < 4 * 16 * 16
    np.testing.assert_allclose(float(loss.detach()), float(jl), **IMAGE)
    want = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_grads_reach_geometry(both):
    """The full scene's vertices and spheres get non-zero gradients."""
    g = both["full_scene"]["port"][2]
    for leaf in ("positions", "sphere_center", "sphere_radius", "materials.albedo"):
        assert np.abs(g[leaf]).max() > 0, leaf


def test_params_round_trip(both):
    """params_from_numpy carries the JAX package's params across unchanged,
    equal to the port's own extract_params of the carried scene, and
    with_params puts them back in place."""
    pscene, np_params = both["full_scene"]["pscene"], both["full_scene"]["np_params"]
    pp = params_from_numpy(np_params, "cpu")
    own = extract_params(pscene)
    for leaf in LEAVES:
        p = _get(pp, leaf)
        assert p.requires_grad and p.is_leaf and p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), _get(np_params, leaf))
        assert torch.equal(_get(own, leaf), p) and _get(own, leaf).requires_grad
    s = with_params(pscene, pp)
    assert s.positions is pp["positions"] and s.materials.albedo is pp["materials"]["albedo"]
    assert s.tre_tris is pscene.tre_tris


# --- the port's own finite-difference checks (mirroring test_grads.py) ----

def _fd(f, x, idx, eps):
    with torch.no_grad():
        xp, xm = x.detach().clone(), x.detach().clone()
        xp[idx] += eps
        xm[idx] -= eps
        return (float(f(xp)) - float(f(xm))) / (2 * eps)


def test_albedo_grad_matches_fd(both):
    pscene = both["sphere_scene"]["pscene"]
    params = extract_params(pscene)

    def loss(a):
        p = dict(params, materials=dict(params["materials"], albedo=a))
        return _render(pscene, p)[0].color.mean()

    a0 = params["materials"]["albedo"]
    (g,) = torch.autograd.grad(loss(a0), a0)
    for idx in [(0, 0), (1, 2)]:
        fd = _fd(loss, a0, idx, 1e-3)
        assert abs(float(g[idx]) - fd) < 2e-3 * max(1.0, abs(fd))


@pytest.mark.parametrize("leaf", ["bg_down", "bg_up"])
def test_background_grad_matches_fd(both, leaf):
    pscene = both["sphere_scene"]["pscene"]
    params = extract_params(pscene)

    def loss(b):
        return _render(pscene, dict(params, **{leaf: b}))[0].color.mean()

    b0 = params[leaf]
    (g,) = torch.autograd.grad(loss(b0), b0)
    fd = _fd(loss, b0, 1, 1e-3)
    assert abs(float(g[1]) - fd) < 2e-3 * max(1.0, abs(fd))


def test_vertex_position_grad_matches_fd(both):
    """A hit's depth moves smoothly with its triangle's vertices (a colour
    loss would be dominated by silhouette flips, which the estimator holds
    constant)."""
    pscene = both["full_scene"]["pscene"]
    params = extract_params(pscene)
    center = (H // 2) * W + W // 2

    def depth_at_center(p):
        return _render(pscene, dict(params, positions=p), max_bounces=2)[0].depth[center]

    p0 = params["positions"]
    (g,) = torch.autograd.grad(depth_at_center(p0), p0)
    ga = g.abs().numpy()
    assert ga.max() > 0  # the centre pixel hits the mesh
    idx = np.unravel_index(np.argmax(ga), ga.shape)
    fd = _fd(depth_at_center, p0, idx, 3e-4)
    assert abs(float(g[idx]) - fd) < 5e-2 * max(0.1, abs(fd))


def test_sphere_radius_grad_through_depth():
    """Growing a sphere in front of a z-axis camera moves its front surface
    toward the camera: d(depth)/d(radius) ~ -1, AD equal to FD."""
    d = SceneDescription()
    d.add_material("dark", "lambertian", albedo=(0.05, 0.05, 0.05))
    d.add_sphere(0.5, np.asarray(m3.mat_translate([0, 0, -2.0])), "dark")
    scene = d.build(device="cpu")
    params = extract_params(scene)
    center = (H // 2) * W + W // 2

    def center_depth(r):
        return _render(scene, dict(params, sphere_radius=r), max_bounces=2)[0].depth[center]

    r0 = params["sphere_radius"]
    (g,) = torch.autograd.grad(center_depth(r0), r0)
    fd = _fd(center_depth, r0, 0, 1e-3)
    assert -1.5 < float(g[0]) < -0.8
    np.testing.assert_allclose(float(g[0]), fd, rtol=1e-2)


# --- the denoiser ---------------------------------------------------------

def _denoise_inputs(h=16, w=16, seed=0):
    r = np.random.default_rng(seed)
    color = r.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    color[:, : w // 2] = 0.3  # a flat region: edge weights of exactly 1
    normal = r.standard_normal((h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = r.uniform(1.0, 3.0, (h, w)).astype(np.float32)
    weights = r.standard_normal((h, w, 3)).astype(np.float32)
    return color, normal, depth, weights


@pytest.fixture(scope="module")
def denoised():
    color, normal, depth, weights = _denoise_inputs()
    jcam = jax_make_camera(position=(0.1, 0.2, 1.0), vfov=np.pi / 3)

    def jloss(c, n, d):
        return jnp.sum(jax_atrous_denoise(c, n, d, jcam, filter_size=4) * weights)

    jin = [jnp.asarray(a) for a in (color, normal, depth)]
    j_img = np.asarray(jax_atrous_denoise(*jin, jcam, filter_size=4))
    j_grads = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1, 2))(*jin)]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (color, normal, depth)]
    img = atrous_denoise(*ins, make_camera(position=(0.1, 0.2, 1.0), vfov=np.pi / 3),
                         filter_size=4)
    p_grads = torch.autograd.grad((img * torch.from_numpy(weights)).sum(), ins)
    return j_img, j_grads, img.detach().numpy(), [g.numpy() for g in p_grads]


def test_atrous_denoise_matches_jax(denoised):
    j_img, _, p_img, _ = denoised
    assert p_img.shape == (16, 16, 3)
    np.testing.assert_allclose(p_img, j_img, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("i,what", [(0, "color"), (1, "normal"), (2, "depth")])
def test_atrous_denoise_grads_match_jax(denoised, i, what):
    _, j_grads, _, p_grads = denoised
    want, got = j_grads[i], p_grads[i]
    assert np.abs(want).max() > 0 and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def test_grads_through_denoiser(both):
    """BASELINE config 4: a 1-spp render, the differentiable denoise, and
    material gradients through the filter, AD against FD."""
    pscene = both["sphere_scene"]["pscene"]
    params = extract_params(pscene)

    def loss(albedo):
        p = dict(params, materials=dict(params["materials"], albedo=albedo))
        buf, _ = _render(pscene, p)
        img = atrous_denoise(buf.color.reshape(H, W, 3), buf.normal.reshape(H, W, 3),
                             buf.depth.reshape(H, W), _cam(), filter_size=4)
        return img.mean()

    a0 = params["materials"]["albedo"]
    (g,) = torch.autograd.grad(loss(a0), a0)
    assert torch.isfinite(g).all()
    fd = _fd(loss, a0, (1, 0), 1e-3)
    assert abs(float(g[1, 0]) - fd) < 2e-3 * max(1.0, abs(fd))
