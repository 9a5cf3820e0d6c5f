"""The forward trip's kernels (``tpupt_torch/render/trip_kernel.py``:
``trip_head``, ``trip_tail``) and the trip route of ``render_image`` and
``trace_sample``.

On the CPU the wrappers run their twins, which are assembled from the
body route's own functions, so:

* the trip route's buffers are EQUAL to the ``_bounce_body`` route's
  (``BODY``: the default hit pass wrapped, which ``render_route`` sends to
  the body route), with equal segment counts, chained, per sample and on
  a row band, on multi_mesh.json (lambertian, metal and glass meshes in one
  treelet table, a translated ground sphere) at 32^2, 2 spp, 8 bounces, RR
  4, and on a small scene with scaled and rotated spheres of every
  non-emitting material beside an icosphere;
* the trip route matches the JAX package's ``render_image`` at
  test_torch_render.py's IMAGE tolerance (rtol 1e-4, atol 1e-5), the rays
  EQUAL, with the one standing difference of multi_mesh.json, pixel 571
  (test_torch_bench.py's docstring: the compiled JAX render contracts
  multiply-adds into FMAs and one of that pixel's hits flips);
* the SoA lane state survives ``pack_state`` / ``unpack_state``, seeds of
  2^31 and above included;
* ``trip_head`` leaves a dead lane's record and ray rows as they were and
  writes its -BIG seed and mask;
* ``render_route`` and the renders themselves take the trip route exactly
  for forward renders through the default hit pass and, on a scene with
  emitters, the default shadow sweep (the NEE trip itself is held in
  ``test_torch_trip_nee.py``).

The tests marked ``cuda`` run the kernels against their twins on the
card (exact: both round every float32 operation once, in the same
order) and skip where torch sees no card.  This module imports JAX only
inside the test that needs it, so on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trip.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpupt_torch.accel import packets, sweep_kernel
from tpupt_torch.bench import harness as ph
from tpupt_torch.core import math3d as m3
from tpupt_torch.core.camera import make_camera
from tpupt_torch.core.types import OBJ_MESH
from tpupt_torch.cpu_ref.renderer import intersect_scene_ids_brute
from tpupt_torch.render import diff_trip, integrator, trip_kernel
from tpupt_torch.render.integrator import render_image, render_route, trace_sample
from tpupt_torch.render.intersect import (intersect_scene_ids, intersect_scene_ids_bvh,
                                          slot_tri_table)
from tpupt_torch.scene.bake import rebake_treelets
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.procedural import icosphere

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
MM = dict(width=32, height=32, spp=2, max_bounces=8, rr_start=4)
# pixels of multi_mesh.json whose colour lies outside IMAGE against the JAX
# package (module docstring)
MM_FLIPPED = {571}
# the pixel of the nine spheres' 24 x 16 render whose colour lies outside
# IMAGE against the JAX package run op by op: a path over the radius-1000
# ground, whose quadratic cancels about six digits, so the two packages'
# last-bit differences (torch's CPU rsqrt against XLA's) move its bounce
# (5.7e-4 apart at most)
NINE_FLIPPED = {346}
KEYS = ("color", "normal", "depth")
# the default hit pass, wrapped: the body route on the same hits
BODY = functools.partial(intersect_scene_ids)


def _spheres_scene(device="cpu"):
    """Spheres under non-uniform scale and rotation of all four materials
    beside an icosphere and on a radius-100 ground.  The glowing sphere's
    light tables are emptied, so the scene has no emitter to sample (the
    trip route without NEE) and bounces reach the emission lobe of
    ``shade``."""
    v, f = icosphere(2)
    d = SceneDescription(bg_down=(1.0, 0.9, 0.8), bg_up=(0.4, 0.6, 1.0))
    d.add_material("clay", "lambertian", albedo=(0.7, 0.45, 0.3))
    d.add_material("chrome", "metal", albedo=(0.85, 0.88, 0.9), fuzz=0.2)
    d.add_material("glass", "dielectric", refraction_index=1.5)
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.8))
    d.add_material("glow", "diffuse_light", emit=(3.0, 2.5, 2.0))
    d.add_sphere(100.0, np.asarray(m3.mat_translate([0, -100.5, -1])), "ground")
    squash = np.asarray(m3.mat_translate([-1.1, 0, -1.2])) @ np.asarray(
        m3.mat_rotate(0.6, [0, 0, 1])) @ np.diag([1.0, 0.6, 0.9, 1.0])
    d.add_sphere(0.5, squash, "glass")
    d.add_sphere(0.45, np.asarray(m3.mat_translate([1.1, 0, -1.3])), "chrome")
    d.add_sphere(0.3, np.asarray(m3.mat_translate([0.2, 0.9, -1.2])), "glow")
    d.add_mesh("ico", v, f)
    d.add_mesh_object("ico", np.asarray(m3.mat_translate([0, 0.1, -1.6])) @ np.diag(
        [0.5, 0.5, 0.5, 1.0]), "clay")
    scene = dataclasses.replace(d.build(device=device), s_light_objs=(), s_light_mats=())
    assert not scene.has_nee
    return scene, make_camera(position=(0, 0.4, 1.5),
                              rotation=m3.mat_rotate(-0.2, [1, 0, 0])[:3, :3], vfov=np.pi / 2.5)


def nine_spheres_desc(cls=SceneDescription):
    """Nine spheres, no emitter and no mesh (``cls``: the port's
    SceneDescription or the JAX package's, which take the same calls): a
    radius-1000 ground, two coincident spheres (an exact-t tie, which the
    later one wins), glass, fuzzy metal and small diffuse spheres, one
    scaled."""
    def t(x, y, z):
        return np.asarray(m3.mat_translate([x, y, z]), np.float64)

    d = cls(bg_down=(1.0, 0.95, 0.9), bg_up=(0.45, 0.65, 1.0))
    d.add_material("ground", "lambertian", albedo=(0.75, 0.75, 0.7))
    d.add_material("red", "lambertian", albedo=(0.8, 0.25, 0.2))
    d.add_material("blue", "lambertian", albedo=(0.2, 0.3, 0.8))
    d.add_material("chrome", "metal", albedo=(0.85, 0.85, 0.9), fuzz=0.15)
    d.add_material("glass", "dielectric", refraction_index=1.5)
    d.add_sphere(1000.0, t(0, -1000.5, -1), "ground")
    d.add_sphere(0.5, t(0, 0, -1.2), "red")
    d.add_sphere(0.5, t(0, 0, -1.2), "red")  # coincident with the one before
    d.add_sphere(0.45, t(-1.05, 0, -1.1), "glass")
    d.add_sphere(0.45, t(1.05, 0, -1.1), "chrome")
    d.add_sphere(0.15, t(-0.45, -0.35, -0.55), "blue")
    d.add_sphere(0.12, t(0.4, -0.38, -0.6), "glass")
    d.add_sphere(0.2, t(0.2, 0.75, -1.6) @ np.diag([1.5, 0.7, 1.0, 1.0]), "chrome")
    d.add_sphere(0.1, t(-0.2, 0.55, -0.8), "red")
    return d


def nine_spheres(device="cpu"):
    return nine_spheres_desc().build(device=device), make_camera(vfov=np.pi / 2)


# the emitter-free scenes of the kernel-level cases: nine spheres (no
# mesh, so trip_head writes no packed rows), and spheres beside a mesh
FREE_SCENES = {"nine_spheres": nine_spheres, "spheres_mesh": _spheres_scene}
# the lanes alive in the kernel-level cases: every one, one in 41 (a late
# trip), none.  Their 23 x 7 lanes are no multiple of a warp's 64-lane
# chunk, of the forward's four-lane loads or of a packet, so each case has
# a ragged chunk and, with a mesh, pad lanes
STATES = {"dense": 1, "sparse": 41, "all_dead": 0}
W_ODD, H_ODD = 23, 7
HEAD_OUT = ("hrec", "hint", "rows", "act_p")


def _alive_as(I, state):
    every = STATES[state]
    lane = torch.arange(I.shape[1], device=I.device)
    alive = lane % every == 3 if every > 1 else torch.full_like(lane, every, dtype=torch.bool)
    I[trip_kernel.I_KEYS.index("alive")] = alive.to(torch.int32)
    return int(alive.sum())


def head_inputs(name, state, device="cpu"):
    """(plan, F, I) of a one-sample trip plan of FREE_SCENES[name] at
    W_ODD x H_ODD on its primary rays, the lanes of ``state`` alive."""
    scene, cam = FREE_SCENES[name](device=device)
    plan = integrator._trip_plan(scene, cam, W_ODD, H_ODD, spp=1, max_bounces=4, rr_start=None,
                                 iteration=5, chained=False)
    F, I = integrator._trip_start(plan)
    _alive_as(I, state)
    return plan, F, I


def diff_inputs(name, state, bounce, device="cpu", rr_start=1):
    """(dp, F, I, buf, sweep): a differentiable one-sample plan of
    FREE_SCENES[name] at W_ODD x H_ODD (with a mesh, the slot table of
    the rebaked scene), its primary rays with the lanes of ``state``
    alive, and trip_head and the payload sweep run on them: the inputs of
    diff_trip_fwd's bounce ``bounce``."""
    scene, cam = FREE_SCENES[name](device=device)
    table = None
    if OBJ_MESH in scene.s_obj_kind:
        with torch.no_grad():
            scene = rebake_treelets(scene)
            table = slot_tri_table(scene)
    plan = integrator._trip_plan(scene, cam, W_ODD, H_ODD, spp=1, max_bounces=4,
                                 rr_start=rr_start, iteration=5, chained=False)
    dp = diff_trip.DiffPlan(plan, table, functools.partial(integrator._trip_start, plan),
                            functools.partial(integrator._diff_bounce, rr_start=rr_start))
    F, I = dp.start()
    _alive_as(I, state)
    buf = trip_kernel.trip_buffers(plan)
    trip_kernel.trip_head(plan, F, I, buf)
    sweep = None
    if plan.mesh:
        sweep = sweep_kernel.treelet_closest_hit(buf.sweep_rows, buf.act_p, scene.tre_min,
                                                 scene.tre_max, scene.tre_tris, scene.s_leaf_size,
                                                 payload=True)
    return dp, F, I, buf, sweep


def fwd_run(fn, dp, F, I, buf, sweep, bounce):
    """``fn`` (diff_trip_fwd or its twin) on copies of the state, with
    residuals that hold 7s beforehand: (F, I, float residuals, int
    residuals, the lanes left)."""
    F, I = F.clone(), I.clone()
    res = diff_trip.residuals(dp.trip.n, F.device)
    res.f.fill_(7.0)
    res.i.fill_(7)
    b = trip_kernel.trip_buffers(dp.trip)
    b.hint.copy_(buf.hint)
    b.count.fill_(-1)
    fn(dp, F, I, b, sweep, bounce, res)
    return F, I, res.f, res.i, b.count


def head_run(fn, plan, F, I):
    """``fn`` (trip_head or its twin) on buffers that hold 7s (-7 in hint,
    True in the mask) beforehand, so what a lane leaves shows."""
    buf = trip_kernel.trip_buffers(plan)
    for k in ("hrec", "rows"):
        if getattr(buf, k) is not None:
            getattr(buf, k).fill_(7.0)
    buf.hint.fill_(-7)
    if buf.act_p is not None:
        buf.act_p.fill_(True)
    fn(plan, F, I, buf)
    return buf


def assert_head_equal(got, want):
    for k in HEAD_OUT:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None and b is None) or torch.equal(a, b), k


@pytest.fixture(scope="module")
def multimesh():
    return ph.CONFIGS["multimesh"]["scene"](device="cpu")


@pytest.fixture(scope="module")
def spheres():
    return _spheres_scene()


@pytest.fixture(scope="module")
def multimesh_trip_render(multimesh):
    scene, cam = multimesh
    return render_image(scene, cam, **MM)


def _assert_equal(a, b):
    (ba, ra), (bb, rb) = a, b
    assert int(ra) == int(rb)
    for key in KEYS:
        assert torch.equal(getattr(ba, key), getattr(bb, key)), key


# --- the trip route against the body route ------------------------------------

MODES = {"chained": {}, "per_sample": dict(chain_samples=False), "band": dict(row0=12, rows=8)}


@pytest.mark.parametrize("mode", MODES)
def test_trip_route_equals_body_route_multimesh(multimesh, multimesh_trip_render, mode):
    scene, cam = multimesh
    kw = dict(MM, **MODES[mode])
    trip = multimesh_trip_render if mode == "chained" else render_image(scene, cam, **kw)
    body = render_image(scene, cam, intersect_fn=BODY, **kw)
    _assert_equal(trip, body)
    assert int(trip[1]) > kw["width"] * kw.get("rows", kw["height"]) * kw["spp"]


@pytest.mark.parametrize("mode", MODES)
def test_trip_route_equals_body_route_spheres(spheres, mode):
    scene, cam = spheres
    kw = dict(width=24, height=20, spp=3, max_bounces=6, rr_start=2, start_iteration=5,
              **MODES[mode])
    _assert_equal(render_image(scene, cam, **kw), render_image(scene, cam, intersect_fn=BODY, **kw))


def test_trace_sample_trip_equals_body(spheres):
    scene, cam = spheres
    kw = dict(max_bounces=5, rr_start=None, row0=4, rows=6)
    got = trace_sample(scene, cam, 24, 20, 7, **kw)
    want = trace_sample(scene, cam, 24, 20, 7, intersect_fn=BODY, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sphere_only_scene_takes_no_sweep():
    """A scene without meshes (harness config "sphere"): no packed rows,
    and the route still equals the body route."""
    scene, cam = ph.CONFIGS["sphere"]["scene"](device="cpu")
    plan = integrator._trip_plan(scene, cam, 16, 16, spp=1, max_bounces=2, rr_start=None,
                                 iteration=0, chained=True)
    buf = trip_kernel.trip_buffers(plan)
    assert not plan.mesh and buf.rows is None and buf.act_p is None
    kw = dict(width=16, height=16, spp=2, max_bounces=3)
    _assert_equal(render_image(scene, cam, **kw), render_image(scene, cam, intersect_fn=BODY, **kw))


# --- the trip route against the JAX package ------------------------------------

def test_trip_route_matches_jax_multimesh(multimesh_trip_render):
    jh = pytest.importorskip("tpupt.bench.harness")
    pytest.importorskip("tpupt.render.integrator")  # the JAX package and what it imports
    from tpupt.render.integrator import render_image as jax_render_image

    jscene, jcam = jh.CONFIGS["multimesh"]["scene"]()
    jbuf, jrays = jax_render_image(jscene, jcam, MM["width"], MM["height"], MM["spp"],
                                   max_bounces=MM["max_bounces"], rr_start=MM["rr_start"])
    pbuf, prays = multimesh_trip_render
    assert int(prays) == int(jrays) > MM["width"] * MM["height"] * MM["spp"]
    for key in KEYS:
        got, want = getattr(pbuf, key).numpy(), np.asarray(getattr(jbuf, key))
        assert got.shape == want.shape and np.isfinite(got).all(), key
        inside = np.abs(got - want) <= IMAGE["atol"] + IMAGE["rtol"] * np.abs(want)
        if key == "color":
            outside = set(np.nonzero(~inside.all(axis=1))[0].tolist())
            assert outside <= MM_FLIPPED, outside
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **IMAGE)


# --- the lane state --------------------------------------------------------------

def test_state_round_trip():
    rng = np.random.default_rng(9)
    n = 333
    f = lambda: torch.from_numpy(rng.standard_normal(n).astype(np.float32))  # noqa: E731
    from tpupt_torch.core.vec import Vec3

    state = dict(ro=Vec3(f(), f(), f()), rd=Vec3(f(), f(), f()), t_min=f(),
                 radiance=Vec3(f(), f(), f()), color=Vec3(f(), f(), f()),
                 normal=Vec3(f(), f(), f()), depth=f(),
                 alive=torch.from_numpy(rng.random(n) < 0.5))
    seed = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.int64))
    seed[:4] = torch.tensor([0, 2**31 - 1, 2**31, 2**32 - 1])
    bounce = torch.from_numpy(rng.integers(0, 50, n))
    chain = dict(k=torch.from_numpy(rng.integers(0, 16, n)),
                 segs=torch.from_numpy(rng.integers(0, 800, n)),
                 done=torch.from_numpy(rng.random(n) < 0.3),
                 color=Vec3(f(), f(), f()), normal=Vec3(f(), f(), f()), depth=f())
    F, I = trip_kernel.pack_state(state, seed, bounce, chain)
    assert F.shape == (len(trip_kernel.F_KEYS), n) and F.dtype == torch.float32
    assert I.shape == (len(trip_kernel.I_KEYS), n) and I.dtype == torch.int32
    assert F.is_contiguous() and I.is_contiguous()
    assert int(I[trip_kernel.I_KEYS.index("seed"), 2]) == -(2**31)  # the uint32 bits
    out = trip_kernel.unpack_state(F, I)
    assert torch.equal(out["seed"], seed) and out["seed"].dtype == torch.int64
    assert torch.equal(out["bounce"], bounce)
    for key, v in state.items():
        got = out["state"][key]
        pairs = zip(got, v) if isinstance(v, Vec3) else [(got, v)]
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), key
    for key, v in chain.items():
        got = out["chain"][key]
        pairs = zip(got, v) if isinstance(v, Vec3) else [(got, v)]
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), key
    F2, I2 = trip_kernel.pack_state(out["state"], out["seed"], out["bounce"], out["chain"])
    assert torch.equal(F2, F) and torch.equal(I2, I)


def test_trip_head_keeps_dead_lanes(spheres):
    """A dead lane's record and seven ray rows keep what they held, its
    seed t is -BIG and its mask False; a live lane's outputs do not depend
    on what the buffers held; the pad lanes are ``_pack_rows``'s."""
    scene, cam = spheres
    plan = integrator._trip_plan(scene, cam, 20, 15, spp=1, max_bounces=2, rr_start=None,
                                 iteration=3, chained=True)
    F, I = integrator._trip_start(plan)
    n, dead = plan.n, torch.arange(plan.n) % 3 == 1
    I[trip_kernel.I_KEYS.index("alive")] = (~dead).to(torch.int32)
    fresh = trip_kernel.trip_head(plan, F, I, trip_kernel.trip_buffers(plan))
    buf = trip_kernel.trip_buffers(plan)
    buf.hrec.fill_(7.0)
    buf.rows.fill_(7.0)
    buf.hint.fill_(-7)
    buf.act_p.fill_(True)
    trip_kernel.trip_head(plan, F, I, buf)
    assert bool((buf.hrec[:, dead] == 7.0).all()) and bool((buf.hint[dead] == -7).all())
    assert torch.equal(buf.hrec[:, ~dead], fresh.hrec[:, ~dead])
    assert torch.equal(buf.hint[~dead], fresh.hint[~dead])
    rows, act, frows = buf.rows.reshape(8, -1), buf.act_p.reshape(-1), fresh.rows.reshape(8, -1)
    assert torch.equal(act[:n], ~dead) and not bool(act[n:].any())
    assert bool((rows[:7, :n][:, dead] == 7.0).all())
    assert bool((rows[7, :n][dead] == -packets.BIG).all())
    assert torch.equal(rows[:, :n][:, ~dead], frows[:, :n][:, ~dead])
    pad = torch.tensor([0.0, 0, 0, 1, 1, 1, 0, -packets.BIG])[:, None].expand(8, plan.n_pad - n)
    assert plan.n_pad > n and torch.equal(rows[:, n:], pad)


def test_trip_route_matches_jax_nine_spheres():
    """Nine spheres (an exact-t tie, a radius-1000 ground) at 24 x 16, 2
    spp, 4 bounces, RR 2, the trip route against the JAX package's
    ``render_image`` on the CPU: the rays equal, normal and depth at
    IMAGE, the colour too but for NINE_FLIPPED.  The JAX render runs op by
    op (``jax.disable_jit``: compiled, XLA contracts multiply-adds into
    FMAs).  The tie's two spheres share a material: which of them wins
    turns on the last bit of each package's rsqrt (the object ray's
    normalize), which the kernel tests hold bit for bit against the twins,
    not against JAX."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("tpupt.render.integrator")  # the JAX package and what it imports
    from tpupt.core.camera import make_camera as jax_make_camera
    from tpupt.render.integrator import render_image as jax_render_image
    from tpupt.scene.description import SceneDescription as JaxSceneDescription

    kw = dict(spp=2, max_bounces=4, rr_start=2)
    scene, cam = nine_spheres()
    assert render_route(scene) == "trip" and OBJ_MESH not in scene.s_obj_kind
    pbuf, prays = render_image(scene, cam, 24, 16, **kw)
    with jax.disable_jit():
        jbuf, jrays = jax_render_image(nine_spheres_desc(JaxSceneDescription).build(),
                                       jax_make_camera(vfov=np.pi / 2), 24, 16, **kw)
    assert int(prays) == int(jrays) > 24 * 16 * 2
    for key in KEYS:
        got, want = getattr(pbuf, key).numpy(), np.asarray(getattr(jbuf, key))
        assert np.isfinite(got).all()
        if key == "color":
            inside = np.abs(got - want) <= IMAGE["atol"] + IMAGE["rtol"] * np.abs(want)
            assert set(np.nonzero(~inside.all(axis=1))[0].tolist()) <= NINE_FLIPPED
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **IMAGE)


# --- which route a render takes ----------------------------------------------

def _nee_scene():
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_material("lamp", "diffuse_light", emit=(4.0, 4.0, 4.0))
    d.add_sphere(100.0, np.asarray(m3.mat_translate([0, -100.5, -1])), "m")
    d.add_sphere(0.2, np.asarray(m3.mat_translate([0, 1.0, -1])), "lamp")
    return d.build(device="cpu")


TWIN = functools.partial(intersect_scene_ids, closest_hit=sweep_kernel.treelet_closest_hit_plain)
ROUTES = {  # (scene, differentiable, intersect_fn, any_hit) -> route
    "forward": ("spheres", False, None, None, "trip"),
    "forward, intersect_scene_ids named": ("spheres", False, intersect_scene_ids, None, "trip"),
    "nee": ("nee", False, None, None, "trip"),
    "nee, treelet_any_hit named": ("nee", False, None, sweep_kernel.treelet_any_hit, "trip"),
    "nee, any_hit passed": ("nee", False, None, sweep_kernel.treelet_any_hit_plain, "body"),
    "nee, differentiable": ("nee", True, None, None, "body"),
    "differentiable": ("spheres", True, None, None, "diff_trip"),
    "bvh oracle": ("spheres", False, intersect_scene_ids_bvh, None, "body"),
    "brute force": ("spheres", False, intersect_scene_ids_brute, None, "body"),
    "sweep twin passed in": ("spheres", False, TWIN, None, "body"),
    "default hit pass wrapped": ("spheres", False, BODY, None, "body"),
}


@pytest.fixture
def head_calls(monkeypatch):
    """Counts trip_head calls (the twin's too, unlike LAUNCHES)."""
    calls = []
    head = trip_kernel.trip_head

    def counting(*args):
        calls.append(1)
        return head(*args)

    monkeypatch.setattr(trip_kernel, "trip_head", counting)
    return calls


@pytest.mark.parametrize("case", ROUTES)
def test_render_route(spheres, head_calls, case):
    name, diff, fn, any_hit, want = ROUTES[case]
    scene, cam = spheres if name == "spheres" else (_nee_scene(), make_camera())
    assert render_route(scene, diff, fn, any_hit) == want
    kw = dict(max_bounces=2, intersect_fn=fn, differentiable=diff, any_hit=any_hit)
    buf, rays = render_image(scene, cam, 8, 8, spp=1, **kw)
    # the differentiable trip runs trip_head too (tests/test_torch_diff_trip.py)
    assert (len(head_calls) > 0) == (want != "body") and int(rays) > 0
    del head_calls[:]
    trace_sample(scene, cam, 8, 8, 0, **kw)
    assert (len(head_calls) > 0) == (want != "body")


def test_route_body_takes_no_trip_kernel(spheres, head_calls):
    """The reference the trip route is held to (``BODY``) runs no trip
    kernel, chained, per sample or in ``trace_sample``."""
    scene, cam = spheres
    render_image(scene, cam, 8, 8, spp=1, max_bounces=2, intersect_fn=BODY)
    render_image(scene, cam, 8, 8, spp=1, max_bounces=2, intersect_fn=BODY, chain_samples=False)
    trace_sample(scene, cam, 8, 8, 0, max_bounces=2, intersect_fn=BODY)
    assert not head_calls


# --- the kernels against their twins (card only) --------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _head_out(buf):
    return {k: None if getattr(buf, k) is None else getattr(buf, k).clone() for k in HEAD_OUT}


def _recorded_trips(scene, cam, w, h, kw, keep):
    """Run the trip route on the card with the inputs of trips ``keep``
    cloned: {trip: (plan, F, I, head buffers before, hrec, hint, sweep)},
    the state taken before the tail."""
    got, pre, heads, count = {}, {}, [0], [0]
    head, tail = trip_kernel.trip_head, trip_kernel.trip_tail

    def recording_head(plan, F, I, buf):
        if heads[0] in keep:
            pre[heads[0]] = _head_out(buf)
        heads[0] += 1
        return head(plan, F, I, buf)

    def recording(plan, F, I, buf, sweep=None):
        if count[0] in keep:
            got[count[0]] = (plan, F.clone(), I.clone(), pre[count[0]], buf.hrec.clone(),
                             buf.hint.clone(),
                             None if sweep is None else tuple(o.clone() for o in sweep))
        count[0] += 1
        return tail(plan, F, I, buf, sweep)

    trip_kernel.trip_head, trip_kernel.trip_tail = recording_head, recording
    try:
        render_image(scene, cam, w, h, **kw)
    finally:
        trip_kernel.trip_head, trip_kernel.trip_tail = head, tail
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_trip_kernels_equal_twins(cuda_device, mode):
    scene, cam = _spheres_scene(device=cuda_device)
    kw = dict(spp=3, max_bounces=6, rr_start=2, **MODES[mode])
    got = _recorded_trips(scene, cam, 40, 32, kw, keep={0, 2, 5})
    assert got
    for trip, (plan, F, I, before, hrec, hint, sweep) in got.items():
        # the head on the trip's state, from the buffers the render's head found
        bk, bp = trip_kernel.trip_buffers(plan), trip_kernel.trip_buffers(plan)
        for b in (bk, bp):
            for k in HEAD_OUT:
                if getattr(b, k) is not None:
                    getattr(b, k).copy_(before[k])
        h0 = trip_kernel.LAUNCHES["trip_head"]
        trip_kernel.trip_head(plan, F.clone(), I.clone(), bk)
        trip_kernel.trip_head_plain(plan, F.clone(), I.clone(), bp)
        torch.cuda.synchronize()
        assert trip_kernel.LAUNCHES["trip_head"] == h0 + 1
        assert torch.equal(bk.hrec, hrec) and torch.equal(bk.hint, hint)
        for a, b in ((bk.hrec, bp.hrec), (bk.hint, bp.hint), (bk.rows, bp.rows),
                     (bk.act_p, bp.act_p)):
            assert (a is None and b is None) or torch.equal(a, b), trip
        # the tail on the recorded record and sweep
        Fk, Ik, Fp, Ip = F.clone(), I.clone(), F.clone(), I.clone()
        for b in (bk, bp):
            b.hrec.copy_(hrec)
            b.hint.copy_(hint)
        trip_kernel.trip_tail(plan, Fk, Ik, bk, sweep)
        trip_kernel.trip_tail_plain(plan, Fp, Ip, bp, sweep)
        torch.cuda.synchronize()
        assert torch.equal(Ik, Ip), trip
        assert torch.equal(Fk, Fp), (trip, (Fk != Fp).sum(dim=1).tolist())
        assert int(bk.count) == int(bp.count), trip


@pytest.mark.cuda
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("name", FREE_SCENES)
def test_trip_head_equals_twin_on_states(cuda_device, name, state):
    """trip_head against its twin on every output (the record, hint, the
    packed rows and mask with their pad lanes, and the 7s a lane that is
    not live leaves), the lanes of ``state`` alive, at 23 x 7 lanes."""
    plan, F, I = head_inputs(name, state, cuda_device)
    h0 = trip_kernel.LAUNCHES["trip_head"]
    got = head_run(trip_kernel.trip_head, plan, F, I)
    want = head_run(trip_kernel.trip_head_plain, plan, F, I)
    torch.cuda.synchronize()
    assert trip_kernel.LAUNCHES["trip_head"] == h0 + 1
    assert_head_equal(got, want)
    assert plan.mesh == (name == "spheres_mesh") and plan.n_pad > plan.n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_trip_route_equals_body_route_nine_spheres_on_card(cuda_device, mode):
    scene, cam = nine_spheres(device=cuda_device)
    kw = dict(width=40, height=24, spp=2, max_bounces=5, rr_start=2, **MODES[mode])
    before = trip_kernel.launch_counts()["trip_head"]
    trip = render_image(scene, cam, **kw)
    assert trip_kernel.launch_counts()["trip_head"] > before
    _assert_equal(trip, render_image(scene, cam, intersect_fn=BODY, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("rr_start", [2, None])
@pytest.mark.parametrize("mode", MODES)
def test_trip_route_equals_body_route_on_card(cuda_device, mode, rr_start):
    scene, cam = _spheres_scene(device=cuda_device)
    kw = dict(width=48, height=40, spp=2, max_bounces=6, rr_start=rr_start, **MODES[mode])
    before = trip_kernel.launch_counts()
    trip = render_image(scene, cam, **kw)
    after = trip_kernel.launch_counts()
    assert after["trip_tail"] > before["trip_tail"] and after["trip_head"] > before["trip_head"]
    _assert_equal(trip, render_image(scene, cam, intersect_fn=BODY, **kw))


@pytest.mark.cuda
def test_trip_wrappers_check_their_inputs(cuda_device):
    scene, cam = _spheres_scene(device=cuda_device)
    plan = integrator._trip_plan(scene, cam, 16, 8, spp=1, max_bounces=2, rr_start=None,
                                 iteration=0, chained=True)
    F, I = integrator._trip_start(plan)
    buf = trip_kernel.trip_buffers(plan)
    with pytest.raises(ValueError, match="F must be"):
        trip_kernel.trip_head(plan, F[:, :-1], I, buf)
    with pytest.raises(ValueError, match="I must be"):
        trip_kernel.trip_head(plan, F, I.long(), buf)
    with pytest.raises(ValueError, match="sweep"):
        trip_kernel.trip_tail(plan, F, I, buf, None)
