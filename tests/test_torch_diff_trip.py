"""The differentiable trip (``tpupt_torch.render.diff_trip``) on the CPU,
where its wrappers run their twins: the route against the body route and
against the JAX package, through the denoiser and the fit, the route's
choice, and slot_scatter's twin.

(a) The route (``render_route`` "diff_trip": ``DiffTrip``, a hand
backward a bounce) against the body route on the same ids pass
(``functools.partial(intersect_scene_ids_diff)``, torch autograd over
``_bounce_body``): the loss, the image, normal, depth and the segment count
bit-equal (the twins are the body's own functions); every leaf's gradient
at rtol 1e-5 with a floor of 1e-5 x the leaf's max |grad| (the backward
sums a bounce's cotangents per bounce, autograd over the whole graph, in
another order).  The loss takes colour, normal and depth, so every output
row's cotangent is exercised.

(b) The route against the JAX package's ``render_image(differentiable=
True)`` gradients, every leaf, at tests/test_torch_grads.py's tolerances
(rtol 1e-4, floor 1e-4 x max|g|: the two packages' float32 sqrt, rsqrt, sin
and cos differ in the last bit), on spheres only, a mesh, and the scene
with metal, glass and two meshes with roulette.  The JAX reference runs op
by op.

(c) A denoised loss and two ``fit_scene`` steps on the route against the
body route's.

(d) ``render_route``'s choice for each case of its docstring.

(e) is in tests/test_torch_refine.py (``slot_scatter``'s twin is the
``index_add_`` of the gather VJP on the rows with a triangle).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.diff.params import extract_params as jax_extract_params
from tpupt.diff.params import with_params as jax_with_params
from tpupt.render.integrator import render_image as jax_render_image
from tpupt.scene.description import SceneDescription as JaxSceneDescription
from tpupt.scene.procedural import icosphere as jax_icosphere

from conftest import S, T
from test_torch_scene import port_scene
from test_torch_trip import nine_spheres_desc
from tpupt_torch import atrous_denoise, extract_params, params_from_numpy, with_params
from tpupt_torch.core.camera import make_camera
from tpupt_torch.cpu_ref.renderer import intersect_scene_ids_brute
from tpupt_torch.diff import fit_scene
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES
from tpupt_torch.accel import sweep_kernel
from tpupt_torch.render import diff_trip, integrator, trip_kernel
from tpupt_torch.render.integrator import render_image, render_route
from tpupt_torch.render.intersect import intersect_scene_ids_bvh, intersect_scene_ids_diff

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead
torch.set_num_threads(1)

LEAVES = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)
BODY = functools.partial(intersect_scene_ids_diff)  # the same ids pass, the body route
W, H = 32, 24


def _cam():
    return make_camera(vfov=np.pi / 2)


def _get(params, name):
    return params["materials"][name[10:]] if name.startswith("materials.") else params[name]


@pytest.fixture(scope="module")
def scenes(sphere_scene, full_scene):
    return {"spheres": port_scene(sphere_scene), "full": port_scene(full_scene)}


def _step(scene, intersect_fn=None, loss="rows", w=W, h=H, **kw):
    """A differentiable render from fresh params: (buffers, segments, loss,
    {leaf: gradient})."""
    params = extract_params(scene)
    kw = dict(dict(spp=2, max_bounces=4), **kw)
    buf, rays = render_image(with_params(scene, params), _cam(), w, h, differentiable=True,
                             intersect_fn=intersect_fn, **kw)
    if loss == "rows":
        value = ((buf.color ** 2).sum() + 0.1 * buf.normal.sum()
                 + 0.01 * buf.depth.clamp(max=20.0).sum())
    else:  # denoised: the filter reads colour, normal and depth
        rows = buf.color.shape[0] // w
        img = atrous_denoise(buf.color.reshape(rows, w, 3), buf.normal.reshape(rows, w, 3),
                             buf.depth.reshape(rows, w), _cam(), filter_size=4)
        value = (img ** 2).mean()
    grads = torch.autograd.grad(value, [_get(params, k) for k in LEAVES], allow_unused=True,
                                materialize_grads=True)
    return buf, int(rays), value.detach(), dict(zip(LEAVES, grads))


def _assert_route_equals_body(got, want):
    (bk, rk, lk, gk), (bp, rp, lp, gp) = got, want
    assert rk == rp > 0
    assert torch.equal(lk, lp)
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(bk, key), getattr(bp, key)), key
    for k in LEAVES:
        a, b = gk[k], gp[k]
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), k
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.fixture
def launches(monkeypatch):
    """Calls of the differentiable trip's wrappers and of trip_tail (the
    twins' too: on the CPU the wrappers run them)."""
    calls = {"diff_trip_fwd": 0, "diff_trip_bwd": 0, "trip_tail": 0}
    for mod, name in ((diff_trip, "diff_trip_fwd"), (diff_trip, "diff_trip_bwd"),
                      (trip_kernel, "trip_tail")):
        fn = getattr(mod, name)

        def counting(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counting)
    return calls


@pytest.mark.parametrize("rr_start", [None, 1])
@pytest.mark.parametrize("name", ["spheres", "full"])
def test_route_equals_body_route(scenes, launches, name, rr_start):
    scene = scenes[name]
    assert render_route(scene, True) == "diff_trip"
    got = _step(scene, rr_start=rr_start)
    assert launches["diff_trip_fwd"] > 0 and launches["diff_trip_bwd"] == launches["diff_trip_fwd"]
    assert launches["trip_tail"] == 0
    _assert_route_equals_body(got, _step(scene, BODY, rr_start=rr_start))


def test_route_equals_body_route_on_a_band(scenes):
    """Rows [8, 16) of the image: the band's renders and gradients."""
    kw = dict(row0=8, rows=8)
    _assert_route_equals_body(_step(scenes["full"], **kw), _step(scenes["full"], BODY, **kw))


def test_route_without_a_gradient(scenes):
    """Under no_grad (a fit's target render) the route keeps no residuals
    and renders what it renders with them."""
    scene = scenes["full"]
    with torch.no_grad():
        a, ra = render_image(scene, _cam(), W, H, 1, max_bounces=3, differentiable=True)
    b, rb = render_image(scene, _cam(), W, H, 1, max_bounces=3, differentiable=True,
                         intersect_fn=BODY)
    assert int(ra) == int(rb) and torch.equal(a.color, b.color.detach())


def test_denoised_loss_equals_body_route(scenes):
    """Gradients through the denoiser, which reads normal and depth."""
    got = _step(scenes["full"], loss="denoised", spp=1)
    _assert_route_equals_body(got, _step(scenes["full"], BODY, loss="denoised", spp=1))


def test_fit_steps_equal_body_route(scenes, monkeypatch):
    """Two fit_scene steps (the denoiser on, the albedos trained) on the
    route and on the body route: the first loss equal, the second and the
    fitted albedos at rtol 1e-5 (the first step's gradients differ in the
    last bits)."""
    scene = scenes["full"]
    with torch.no_grad():
        target = render_image(scene, _cam(), W, H, 1, max_bounces=3, differentiable=True)[0].color
    start = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=torch.full_like(scene.materials.albedo, 0.5)))
    kw = dict(steps=2, max_bounces=3, denoise=True, material_filter=("albedo",))
    fit_a, losses_a = fit_scene(start, _cam(), target, W, H, **kw)
    route = integrator.render_route

    def body_route(*args, **k):
        r = route(*args, **k)
        return "body" if r == "diff_trip" else r

    monkeypatch.setattr(integrator, "render_route", body_route)
    fit_b, losses_b = fit_scene(start, _cam(), target, W, H, **kw)
    assert losses_a[0] == losses_b[0] and losses_a[1] > 0
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-5)
    torch.testing.assert_close(fit_a.materials.albedo, fit_b.materials.albedo, rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(fit_a.materials.fuzz, scene.materials.fuzz)


# --- (b) against the JAX package ----------------------------------------------

def _jax_mesh_scene():
    """An icosphere mesh over a ground sphere, both diffuse."""
    d = JaxSceneDescription()
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.0))
    d.add_material("grey", "lambertian", albedo=(0.6, 0.6, 0.7))
    d.add_sphere(100.0, T([0, -100.5, -1.0]), "ground")
    v, f = jax_icosphere(2)
    d.add_mesh("ico", v, f)
    d.add_mesh_object("ico", T([0, 0, -1.4]) @ S(0.6), "grey")
    return d.build()


JAX_CASES = {"spheres": None, "mesh": None, "full, roulette": 1}
JW = JH = 16


@pytest.fixture(scope="module")
def jax_refs(sphere_scene, full_scene):
    out = {}
    for name, rr in JAX_CASES.items():
        jscene = {"spheres": sphere_scene, "mesh": _jax_mesh_scene(), "full, roulette": full_scene}[
            name]

        def loss_fn(p, jscene=jscene, rr=rr):
            buf, rays = jax_render_image(jax_with_params(jscene, p), jax_make_camera(vfov=np.pi / 2),
                                         JW, JH, 1, max_bounces=3, differentiable=True,
                                         rr_start=rr)
            return jnp.sum(buf.color ** 2), rays

        jp = jax_extract_params(jscene)
        (jl, jr), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
        out[name] = dict(loss=float(jl), rays=int(jr), np_params=jax.tree_util.tree_map(np.asarray, jp),
                         grads={k: np.asarray(_get(jg, k)) for k in LEAVES},
                         pscene=port_scene(jscene))
    return out


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_route_gradients_match_jax(jax_refs, name):
    ref = jax_refs[name]
    scene = ref["pscene"]
    assert render_route(scene, True) == "diff_trip"
    params = params_from_numpy(ref["np_params"], "cpu")
    buf, rays = render_image(with_params(scene, params), _cam(), JW, JH, 1, max_bounces=3,
                             differentiable=True, rr_start=JAX_CASES[name])
    loss = (buf.color ** 2).sum()
    grads = torch.autograd.grad(loss, [_get(params, k) for k in LEAVES], allow_unused=True,
                                materialize_grads=True)
    assert int(rays) == ref["rays"]
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-4, atol=1e-5)
    for k, g in zip(LEAVES, grads):
        want = ref["grads"][k]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=k)


def test_route_gradients_match_jax_nine_spheres():
    """tests/test_torch_trip.py's nine spheres (an exact-t tie, a
    radius-1000 ground) at 16^2, 2 spp, 4 bounces on the route against the
    JAX package's ``value_and_grad``: the rays equal, the loss and every
    leaf's gradient at the tolerances above, the two coincident spheres'
    (primitives 1 and 2) as their sum.  Which of the two a pixel's path
    hits turns on the last bit of each package's rsqrt (the object ray's
    normalize decides whether the later sphere's root lies in the window
    the earlier one's world t closes), so the packages split the pair's
    gradient differently while its sum, the gradient of the geometry both
    share, agrees; the card and emulation tests hold the split itself to
    the port's twins."""
    jscene = nine_spheres_desc(JaxSceneDescription).build()

    def loss_fn(p):
        buf, rays = jax_render_image(jax_with_params(jscene, p), jax_make_camera(vfov=np.pi / 2),
                                     JW, JH, 2, max_bounces=4, differentiable=True)
        return jnp.sum(buf.color ** 2), rays

    jp = jax_extract_params(jscene)
    (jl, jr), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    scene = port_scene(jscene)
    assert render_route(scene, True) == "diff_trip" and len(scene.s_obj_kind) == 9
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    buf, rays = render_image(with_params(scene, params), _cam(), JW, JH, 2, max_bounces=4,
                             differentiable=True)
    loss = (buf.color ** 2).sum()
    grads = torch.autograd.grad(loss, [_get(params, k) for k in LEAVES], allow_unused=True,
                                materialize_grads=True)
    assert int(rays) == int(jr)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4, atol=1e-5)
    for k, g in zip(LEAVES, grads):
        got, want = g.numpy(), np.asarray(_get(jg, k))
        if k in ("sphere_center", "sphere_radius"):
            got, want = (np.concatenate([x[:1], x[1:2] + x[2:3], x[3:]]) for x in (got, want))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=k)


# --- (d) the route's choice ----------------------------------------------------

def _emitter_scene():
    d = JaxSceneDescription()
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.8))
    d.add_material("lamp", "diffuse_light", emission=(4.0, 4.0, 4.0))
    d.add_sphere(100.0, T([0, -100.5, -1.0]), "ground")
    d.add_sphere(0.3, T([0, 1.0, -1.0]), "lamp")
    return port_scene(d.build())


TWIN = functools.partial(intersect_scene_ids_diff,
                         closest_hit=sweep_kernel.treelet_closest_hit_plain)
GROUP = object()  # a process group: render_route only asks whether there is one
CHOICES = {
    "differentiable": (dict(), "diff_trip"),
    "intersect_scene_ids_diff named": (dict(intersect_fn=intersect_scene_ids_diff), "diff_trip"),
    "sharded post hoc": (dict(grad_psum_axis=GROUP, grad_psum_overlap=False), "diff_trip"),
    "emitters": (dict(scene="emitters"), "body"),
    "bvh oracle": (dict(intersect_fn=intersect_scene_ids_bvh), "body"),
    "brute force": (dict(intersect_fn=intersect_scene_ids_brute), "body"),
    "sweep twin passed in": (dict(intersect_fn=TWIN), "body"),
    "ids pass wrapped": (dict(intersect_fn=BODY), "body"),
    "sharded per bounce": (dict(grad_psum_axis=GROUP, grad_psum_overlap=True), "body"),
    "object matrices take a gradient": (dict(scene="obj_m"), "body"),
    "camera takes a gradient": (dict(camera="grad"), "body"),
    "forward": (dict(differentiable=False), "trip"),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_render_route_choice(scenes, case):
    kw, want = CHOICES[case]
    kw = dict(kw)
    scene = {"emitters": _emitter_scene(), None: scenes["full"],
             "obj_m": dataclasses.replace(scenes["full"],
                                          obj_m=scenes["full"].obj_m.clone().requires_grad_(True))
             }[kw.pop("scene", None)]
    cam = _cam()
    if kw.pop("camera", None):
        cam = dataclasses.replace(cam, camera_matrix=cam.camera_matrix.clone().requires_grad_(True))
    diff = kw.pop("differentiable", True)
    assert render_route(scene, diff, camera=cam, **kw) == want
