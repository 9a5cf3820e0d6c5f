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
from tpupt_torch.cpu_ref.renderer import intersect_scene_ids_brute
from tpupt_torch.render import integrator, trip_kernel
from tpupt_torch.render.integrator import render_image, render_route, trace_sample
from tpupt_torch.render.intersect import intersect_scene_ids, intersect_scene_ids_bvh
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
    "differentiable": ("spheres", True, None, None, "body"),
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
    assert (len(head_calls) > 0) == (want == "trip") and int(rays) > 0
    del head_calls[:]
    trace_sample(scene, cam, 8, 8, 0, **kw)
    assert (len(head_calls) > 0) == (want == "trip")


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


HEAD_OUT = ("hrec", "hint", "rows", "act_p")


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
