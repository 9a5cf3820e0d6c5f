"""Forward intersection, shading and rendering of the PyTorch port against
the JAX package (CPU: the port runs its torch twins).

Discrete results must be EQUAL: hit kind, object, material, primitive,
and the render's traced-segment count, which proves every lane's path
lived exactly as long in both.  Floats: the two packages' float32 rsqrt,
sqrt, sin and cos differ in the last bit, and XLA contracts multiply-adds
into FMAs in compiled loops, so
  * hit t, point and normal are held at rtol 1e-5 with an absolute floor
    of 1e-5 world units (the scene is ~2 units across): components near 0
    have no relative scale, and the radius-100 ground sphere's quadratic
    (|oc|^2 - r^2 cancels ~10^4 down to ~10) turns a 1-ulp difference in
    the normalized direction into up to 4e-5 relative in t for rays that
    start near its surface (measured max |dt| 9.3e-6);
  * shading outputs from the same hit record at rtol 1e-5, atol 1e-6;
  * images at rtol 1e-4, atol 1e-5: test_chained.py's tolerance for
    the same kind of ulp differences amplified through bounces.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.core.math3d as jm3
from tpupt.core.camera import generate_rays as jax_generate_rays
from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.core.types import RenderBuffers as JaxBuffers
from tpupt.render.integrator import accumulate as jax_accumulate
from tpupt.render.integrator import render_image as jax_render_image
from tpupt.render.intersect import intersect_scene_ids as jax_intersect
from tpupt.render.materials import russian_roulette as jax_rr
from tpupt.render.materials import shade as jax_shade
from tpupt.core.vec import Vec3 as JVec3

from test_torch_scene import port_scene
from tpupt_torch.core.camera import make_camera
from tpupt_torch.core.types import Hit, RenderBuffers
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.integrator import accumulate, render_image
from tpupt_torch.render.intersect import intersect_scene_ids
from tpupt_torch.render.materials import russian_roulette, shade
from tpupt_torch.scene.description import SceneDescription

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

GEOM = dict(rtol=1e-5, atol=1e-5)
SHADE = dict(rtol=1e-5, atol=1e-6)
IMAGE = dict(rtol=1e-4, atol=1e-5)


def _rays(w=32, h=32, seed=3):
    """Jittered primaries from a tilted camera, plus random rays from
    inside the scene (secondary-ray-like origins and directions)."""
    rot = jm3.mat_rotate(-0.15, [1.0, 0.0, 0.0])[:3, :3]
    cam = jax_make_camera((0.0, 0.3, 1.0), rot, np.pi / 2)
    r = np.random.default_rng(seed)
    n = w * h
    fx = jnp.asarray((np.arange(n) % w + r.random(n)).astype(np.float32))
    fy = jnp.asarray((np.arange(n) // w + r.random(n)).astype(np.float32))
    ro, rd = jax_generate_rays(cam, w, h, fx, fy)
    ro2 = r.uniform([-1.5, -0.4, -2.5], [1.5, 1.0, -0.5], (n, 3)).astype(np.float32)
    rd2 = r.standard_normal((n, 3)).astype(np.float32)
    rd2 /= np.linalg.norm(rd2, axis=1, keepdims=True)
    ro = [np.concatenate([np.asarray(a), ro2[:, i]]) for i, a in enumerate(ro)]
    rd = [np.concatenate([np.asarray(a), rd2[:, i]]) for i, a in enumerate(rd)]
    return ro, rd


def _both_intersect(jscene, pscene, ro, rd, t_min, active):
    jids, jhit = jax_intersect(
        jscene, JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
        jnp.asarray(t_min), jnp.asarray(active),
    )
    pids, phit = intersect_scene_ids(
        pscene, Vec3(*map(torch.from_numpy, ro)), Vec3(*map(torch.from_numpy, rd)),
        torch.from_numpy(t_min), torch.from_numpy(active),
    )
    return jids, jhit, pids, phit


def test_intersect_scene_ids_matches_jax(full_scene):
    pscene = port_scene(full_scene)
    ro, rd = _rays()
    n = ro[0].shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    active = np.random.default_rng(4).random(n) < 0.95
    jids, jhit, pids, phit = _both_intersect(full_scene, pscene, ro, rd, t_min, active)

    kind = np.asarray(jids.kind)
    np.testing.assert_array_equal(pids.kind.numpy(), kind)
    np.testing.assert_array_equal(pids.obj_id.numpy(), np.asarray(jids.obj_id))
    np.testing.assert_array_equal(pids.prim_id.numpy(), np.asarray(jids.prim_id))
    np.testing.assert_array_equal(phit.mask.numpy(), np.asarray(jhit.mask))
    np.testing.assert_array_equal(phit.mat_id.numpy(), np.asarray(jhit.mat_id))
    np.testing.assert_array_equal(phit.front.numpy(), np.asarray(jhit.front))
    hit = kind >= 0
    assert (kind == 0).sum() > 200 and (kind == 1).sum() > 200  # spheres and meshes
    np.testing.assert_allclose(phit.t.numpy()[hit], np.asarray(jhit.t)[hit], **GEOM)
    for a, b in zip((*jhit.point, *jhit.normal), (*phit.point, *phit.normal)):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit], **GEOM)


def test_shade_and_roulette_match_jax(full_scene):
    """All three lobes (the fixture has lambertian, metal and glass)."""
    pscene = port_scene(full_scene)
    ro, rd = _rays(seed=5)
    n = ro[0].shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    active = np.ones(n, bool)
    jids, jhit, _pids, phit = _both_intersect(full_scene, pscene, ro, rd, t_min, active)
    # feed both the SAME hit record (the JAX one), so this tests shading only
    tt = lambda a: torch.from_numpy(np.array(a))
    hit = Hit(
        mask=tt(jhit.mask), t=tt(jhit.t), point=Vec3(*map(tt, jhit.point)),
        normal=Vec3(*map(tt, jhit.normal)), front=tt(jhit.front), mat_id=tt(jhit.mat_id).long(),
    )
    r = np.random.default_rng(6)
    tp = r.uniform(0.05, 1.0, (3, n)).astype(np.float32)
    seed = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    bounce = (np.arange(n) % 9).astype(np.int32)
    jout = jax_shade(
        full_scene, jhit, JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
        jnp.asarray(t_min), JVec3(*map(jnp.asarray, tp)), jnp.asarray(seed), jnp.asarray(bounce),
    )
    pout = shade(
        pscene, hit, Vec3(*map(torch.from_numpy, ro)), Vec3(*map(torch.from_numpy, rd)),
        torch.from_numpy(t_min), Vec3(*map(torch.from_numpy, tp)),
        torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(bounce),
    )
    m = np.asarray(jhit.mask)
    mt = np.asarray(full_scene.materials.mat_type)[np.asarray(jhit.mat_id)][m]
    assert all((mt == k).sum() > 50 for k in (0, 1, 2))
    for j, p in zip(jout[:5], pout[:5]):  # ro, rd, t_min, throughput, emitted
        for a, b in zip(j, p) if isinstance(j, JVec3) else [(j, p)]:
            np.testing.assert_allclose(b.numpy()[m], np.asarray(a)[m], **SHADE)
    for j, p in zip(jout[5:7], pout[5:7]):  # terminate, specular
        np.testing.assert_array_equal(p.numpy()[m], np.asarray(j)[m])
    np.testing.assert_allclose(pout[7].numpy()[m], np.asarray(jout[7])[m], **SHADE)

    jtp, jal = jax_rr(JVec3(*map(jnp.asarray, tp)), jnp.asarray(active), jnp.asarray(seed),
                      jnp.asarray(bounce))
    ptp, pal = russian_roulette(Vec3(*map(torch.from_numpy, tp)), torch.from_numpy(active),
                                torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(bounce))
    np.testing.assert_array_equal(pal.numpy(), np.asarray(jal))
    for a, b in zip(jtp, ptp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("fixture,w,h", [("sphere_scene", 48, 40), ("full_scene", 32, 32)])
def test_render_image_matches_jax(request, fixture, w, h):
    jscene = request.getfixturevalue(fixture)
    pscene = port_scene(jscene)
    kw = dict(spp=2, max_bounces=8, rr_start=2)
    jbuf, jrays = jax_render_image(jscene, jax_make_camera(vfov=np.pi / 2), w, h, **kw)
    pbuf, prays = render_image(pscene, make_camera(vfov=np.pi / 2), w, h, device="cpu", **kw)
    assert int(prays) == int(jrays)
    assert pbuf.iteration == int(jbuf.iteration) == 2
    for k in ("color", "normal", "depth"):
        got, want = getattr(pbuf, k).numpy(), np.asarray(getattr(jbuf, k))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, err_msg=k, **IMAGE)


def test_render_image_start_iteration_matches_jax(sphere_scene):
    pscene = port_scene(sphere_scene)
    kw = dict(spp=1, max_bounces=4, start_iteration=3)
    jbuf, jrays = jax_render_image(sphere_scene, jax_make_camera(vfov=np.pi / 2), 16, 16, **kw)
    pbuf, prays = render_image(pscene, make_camera(vfov=np.pi / 2), 16, 16, **kw)
    assert int(prays) == int(jrays) and pbuf.iteration == 4
    np.testing.assert_allclose(pbuf.color.numpy(), np.asarray(jbuf.color), **IMAGE)


@pytest.mark.parametrize("iteration", [0, 3])
def test_accumulate_matches_jax(iteration):
    r = np.random.default_rng(iteration)
    old = [r.random(s).astype(np.float32) for s in ((64, 3), (64, 3), (64,))]
    new = [r.random(s).astype(np.float32) for s in ((64, 3), (64, 3), (64,))]
    jb = jax_accumulate(JaxBuffers(*map(jnp.asarray, old), jnp.int32(iteration)),
                        *map(jnp.asarray, new))
    pb = accumulate(RenderBuffers(*map(torch.from_numpy, old), iteration),
                    *map(torch.from_numpy, new))
    assert pb.iteration == int(jb.iteration) == iteration + 1
    for k in ("color", "normal", "depth"):
        np.testing.assert_allclose(getattr(pb, k).numpy(), np.asarray(getattr(jb, k)), rtol=1e-6)


def test_unported_paths_raise(sphere_scene):
    pscene = port_scene(sphere_scene)
    cam = make_camera()
    with pytest.raises(NotImplementedError):
        render_image(pscene, cam, 8, 8, differentiable=True)
    with pytest.raises(NotImplementedError):
        render_image(pscene, cam, 8, 8, chain_samples=False)
    d = SceneDescription()
    d.add_material("lamp", "diffuse_light", emit=(4.0, 4.0, 4.0))
    d.add_sphere(0.3, np.eye(4), "lamp")
    with pytest.raises(NotImplementedError):
        render_image(d.build(), cam, 8, 8)
    assert dataclasses.is_dataclass(pscene)
