"""The PyTorch port's reference oracles against the JAX package's: the
per-ray stackless BVH walk (``accel/traverse.py``,
``intersect_scene_ids_bvh``) and the brute-force hit pass and renderer
(``cpu_ref/renderer.py``).

Discrete results must be EQUAL: which lanes hit, the hit kind, object and
triangle.  t: Moller-Trumbore is the same formula in both packages and
equal bit for bit op by op.  The JAX walk is a compiled while loop, where
XLA contracts multiply-adds into FMAs and takes the world vertices from an
``einsum``: t is held at rtol 1e-6 with a floor of 1e-6 world units on the
meshes (measured: at most 4.8e-7 apart, on the soup and the icosphere), and
at test_torch_render.py's GEOM (rtol 1e-5, atol 1e-5) on full_scene, whose
radius-100 ground sphere amplifies torch's vs XLA's last-bit rsqrt
(measured: 9.3e-6 apart on the sphere hits).

The port against itself, as tests/test_render.py holds the JAX package:
the brute-force render equals ``render_image`` (the twin sweep) in
segments, colour and depth at atol 1e-4, also on emitter scenes, where
the reference traces NEE's shadow rays by its own closest hit and no
any-hit sweep runs; and ``trace_sample`` with the BVH oracle gives the
same bits forward and differentiably.  The BVH
oracle also equals the port's treelet sweep hit for hit.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.accel.traverse import moller_trumbore as jax_moller_trumbore
from tpupt.accel.traverse import traverse_mesh as jax_traverse_mesh
from tpupt.core.vec import Vec3 as JVec3
from tpupt.cpu_ref.renderer import intersect_scene_ids_brute as jax_brute
from tpupt.render.intersect import intersect_scene_ids_bvh as jax_bvh
from tpupt.scene.description import SceneDescription as JaxDescription
from tpupt.scene.procedural import icosphere

from test_emissive import _many_light_scene
from test_torch_render import _rays
from test_torch_scene import port_scene
from tpupt_torch.accel.traverse import moller_trumbore, traverse_mesh
from tpupt_torch.core.camera import make_camera
from tpupt_torch.core.vec import Vec3
from tpupt_torch.cpu_ref.renderer import intersect_scene_ids_brute, render_image_ref
from tpupt_torch.diff.params import extract_params, with_params
from tpupt_torch.render.integrator import render_image, trace_sample
from tpupt_torch.render.intersect import intersect_scene_ids, intersect_scene_ids_bvh
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
from tpupt_torch.scene.json_parser import scene_from_json

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

GEOM = dict(rtol=1e-5, atol=1e-5)
MESH_T = dict(rtol=1e-6, atol=1e-6)
W = H = 48


def _random_soup(n, seed=0):
    """test_bvh.py's triangle soup."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (n, 3))
    verts = centers[:, None, :] + rng.normal(0, 0.3, (n, 3, 3))
    return verts.reshape(-1, 3).astype(np.float32), np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _mesh_scene(v, f):
    d = JaxDescription()
    d.add_material("m", "lambertian", albedo=(1, 1, 1))
    d.add_mesh("mesh", v, f)
    d.add_mesh_object("mesh", np.eye(4), "m")
    return d.build()


def _random_rays(n, seed, spread, aim_half=False):
    """test_bvh.py's rays; ``aim_half`` points every other one at the
    origin."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    if aim_half:
        rd[::2] = -ro[::2] / np.linalg.norm(ro[::2], axis=1, keepdims=True)
    return ro, rd


# mesh: (vertices and faces, rays, least hits), as test_bvh.py
MESHES = {
    "soup": (lambda: _random_soup(150, seed=3), dict(n=256, seed=1, spread=4.0), 20),
    "icosphere": (lambda: icosphere(2), dict(n=512, seed=7, spread=2.0, aim_half=True), 200),
}


def test_moller_trumbore_matches_jax():
    rng = np.random.default_rng(11)
    n = 4096
    p = rng.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    ro = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    target = p[0] + 0.3 * (p[1] - p[0]) + 0.3 * (p[2] - p[0])
    rd = target - ro + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 3e38, np.float32)
    with jax.disable_jit():
        jok, jt = jax_moller_trumbore(*map(jnp.asarray, (ro, rd, *p, t_min, t_max)))
    ok, t = moller_trumbore(*map(torch.from_numpy, (ro, rd, *p, t_min, t_max)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 1000 < int(ok.sum()) < n
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_traverse_mesh_matches_jax(mesh):
    make, ray_kw, least = MESHES[mesh]
    jscene = _mesh_scene(*make())
    pscene = port_scene(jscene)
    ro, rd = _random_rays(**ray_kw)
    n = ro.shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    jt, jtri, _ = jax_traverse_mesh(
        jscene, jnp.int32(0), jscene.obj_m[0], jscene.obj_inv_m[0], jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(t_min), jnp.full((n,), 3e38), jnp.full((n,), -1, jnp.int32),
        jnp.ones((n,), bool))
    t, tri, steps = traverse_mesh(
        pscene, 0, pscene.obj_m[0], pscene.obj_inv_m[0], torch.from_numpy(ro),
        torch.from_numpy(rd), torch.from_numpy(t_min), torch.full((n,), 3e38),
        torch.full((n,), -1, dtype=torch.int64), torch.ones(n, dtype=torch.bool))
    jtri = np.asarray(jtri)
    np.testing.assert_array_equal(tri.numpy(), jtri)
    hit = jtri >= 0
    assert hit.sum() > least and steps > 0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit], **MESH_T)


def _scene_rays():
    ro, rd = _rays()
    n = ro[0].shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    active = np.random.default_rng(4).random(n) < 0.95
    return ro, rd, t_min, active


@pytest.mark.parametrize("oracle", ["bvh", "brute"])
def test_scene_oracle_matches_jax(full_scene, oracle):
    """``intersect_scene_ids_bvh`` / ``intersect_scene_ids_brute`` on
    full_scene (spheres and two mesh instances)."""
    jfn, pfn = {"bvh": (jax_bvh, intersect_scene_ids_bvh),
                "brute": (jax_brute, intersect_scene_ids_brute)}[oracle]
    pscene = port_scene(full_scene)
    ro, rd, t_min, active = _scene_rays()
    jids, jextra = jfn(full_scene, JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
                       jnp.asarray(t_min), jnp.asarray(active))
    pids, pextra = pfn(pscene, Vec3(*map(torch.from_numpy, ro)), Vec3(*map(torch.from_numpy, rd)),
                       torch.from_numpy(t_min), torch.from_numpy(active))
    assert jextra is None and pextra is None
    kind = np.asarray(jids.kind)
    np.testing.assert_array_equal(pids.kind.numpy(), kind)
    np.testing.assert_array_equal(pids.obj_id.numpy(), np.asarray(jids.obj_id))
    np.testing.assert_array_equal(pids.prim_id.numpy(), np.asarray(jids.prim_id))
    assert (kind == 0).sum() > 200 and (kind == 1).sum() > 200
    hit = kind >= 0
    np.testing.assert_allclose(pids.t.numpy()[hit], np.asarray(jids.t)[hit], **GEOM)


def test_bvh_oracle_matches_the_treelet_sweep(full_scene):
    """The port's treelet sweep (its twin here) and the BVH walk, which
    share no code and no visit order: the same hits."""
    pscene = port_scene(full_scene)
    ro, rd, t_min, active = _scene_rays()
    args = (pscene, Vec3(*map(torch.from_numpy, ro)), Vec3(*map(torch.from_numpy, rd)),
            torch.from_numpy(t_min), torch.from_numpy(active))
    oracle, _ = intersect_scene_ids_bvh(*args)
    sweep, _ = intersect_scene_ids(*args)
    for key in ("kind", "obj_id", "prim_id"):
        assert torch.equal(getattr(sweep, key), getattr(oracle, key)), key
    hit = oracle.kind >= 0
    np.testing.assert_allclose(sweep.t[hit].numpy(), oracle.t[hit].numpy(), **MESH_T)


def test_render_image_ref_matches_render(full_scene):
    """tests/test_render.py's bar: the brute-force render and the
    accelerated one trace the same segments, colour and depth at atol
    1e-4."""
    pscene = port_scene(full_scene)
    cam = make_camera(vfov=np.pi / 2)
    buf, rays = render_image(pscene, cam, W, H, 2, max_bounces=6)
    ref, rays_ref = render_image_ref(pscene, cam, W, H, 2, max_bounces=6)
    assert int(rays) == int(rays_ref)
    np.testing.assert_allclose(buf.color.numpy(), ref.color.numpy(), atol=1e-4)
    np.testing.assert_allclose(buf.depth.numpy(), ref.depth.numpy(), atol=1e-4)


def test_bvh_oracle_forward_equals_differentiable(full_scene):
    """tests/test_render.py's scan-vs-while check: with the BVH oracle both
    loops refine the same hit from the same ids, so the forward and the
    differentiable sample are the same bits; the latter's gradient reaches
    the vertices through the refine from the ids."""
    pscene = port_scene(full_scene)
    cam = make_camera(vfov=np.pi / 2)
    c1, n1, d1, r1 = trace_sample(pscene, cam, W, H, 1, max_bounces=6,
                                  intersect_fn=intersect_scene_ids_bvh)
    params = extract_params(pscene)
    c2, n2, d2, r2 = trace_sample(with_params(pscene, params), cam, W, H, 1, max_bounces=6,
                                  differentiable=True, intersect_fn=intersect_scene_ids_bvh)
    assert torch.equal(c1, c2.detach()) and torch.equal(d1, d2.detach())
    assert int(r1) == int(r2)
    (c2 ** 2).sum().backward()
    assert float(params["positions"].grad.abs().max()) > 0


@pytest.fixture(scope="module")
def emitter_scenes(tmp_path_factory):
    """name -> (port scene, camera): the shipped Cornell JSONs (a sphere
    light; two emissive triangles), beside a private models/ dir, and
    test_emissive.py's 16 sphere lights (one sampled per lane)."""
    root = tmp_path_factory.mktemp("oracle_assets")
    shutil.copytree(os.path.join(locate_asset_path(), "scenes"), root / "scenes")
    ensure_models(str(root / "models"), names=["quad.obj"])
    out = {}
    for name in ("cornell.json", "cornell_area.json"):
        desc = scene_from_json(str(root / "scenes" / name))
        out[name] = (desc.build(device="cpu"), desc.camera)
    out["many16"] = (port_scene(_many_light_scene(16)), make_camera(vfov=np.pi / 2))
    return out


def _no_any_hit(*args, **kw):
    raise AssertionError("the reference render ran the any-hit sweep")


@pytest.mark.parametrize("name", ["cornell.json", "cornell_area.json", "many16"])
def test_render_image_ref_with_emitters(emitter_scenes, name):
    """With NEE, the brute-force render traces its shadow rays by its own
    closest hit, as the JAX package's reference does, so it shares no
    shadow sweep with the render it checks; the two agree at
    tests/test_render.py's bar (the tests differ only at exact-t ties)."""
    scene, cam = emitter_scenes[name]
    assert scene.has_nee
    buf, rays = render_image(scene, cam, 16, 16, 2, max_bounces=4)
    ref, rays_ref = render_image_ref(scene, cam, 16, 16, 2, max_bounces=4, any_hit=_no_any_hit)
    assert int(rays) == int(rays_ref)
    np.testing.assert_allclose(buf.color.numpy(), ref.color.numpy(), atol=1e-4)
    np.testing.assert_allclose(buf.depth.numpy(), ref.depth.numpy(), atol=1e-4)
