"""The trip route of scenes with emitters: ``trip_head``, the new
``trip_nee`` (the body up to next-event estimation's shadow rays, and
their sphere test), the any-hit sweep on every NEE term's rows in one
call, and ``trip_tail``'s NEE mode (``tpupt_torch/render/trip_kernel.py``).

Scenes: the five emitter scenes of ``test_torch_nee.py``: one sphere lamp
(``lamp``: one unrolled light), sixteen (``many16``: one light sampled
per lane, its sphere test excluding that light per lane), the quad light
with a sphere lamp beside it (``quad_mixed``: the mesh term, then a
sphere term; both sweeps), ``cornell.json`` (no mesh: no sweep at all)
and ``cornell_area.json`` (the light is the only mesh, K = 1); and an
emissive icosphere of 320 triangles beside a diffuse floor
(``ico_light``: the mesh light's area CDF has 320 entries, which
``trip_nee`` inverts by binary search; both packages cap a scene's
emissive triangles at 512, ``TRI_LIGHT_MAX``).  The small scenes are built here
with the port's own description, as ``tests/test_emissive.py`` builds the
first three for the JAX package (``ico_light``'s JAX side is built here
too).

On the CPU the wrappers run their twins, which are assembled from the
body route's own functions, so:

* the trip route's buffers and segments are EQUAL to the body route's
  (``BODY``: the default hit pass wrapped), chained and per sample, with
  roulette and without, and ``trace_sample``'s outputs too;
* no ``_bounce_body`` runs on the trip route, and every trip runs
  ``trip_nee`` once;
* one any-hit call over every term's packet-aligned region equals one
  call per term;
* the trip route matches the JAX package's forward ``trace_sample``
  (``jax.disable_jit()``) at ``test_torch_nee.py``'s tolerances: IMAGE,
  normals at atol 1e-4, and on the Cornell scenes at least 97% of the
  colour values inside IMAGE, all of them once the JAX package's float32
  sqrt, rsqrt, sin and cos bits are patched into torch.

The tests marked ``cuda`` hold ``trip_head``, ``trip_nee`` and the NEE
mode of ``trip_tail`` to their twins on recorded trips (exact) and the
two routes' renders bit-equal on the card; they skip where torch sees no
card.  This module imports JAX only inside the tests that need it, so on
a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trip_nee.py
"""

import contextlib
import functools
import os
import shutil

import numpy as np
import pytest
import torch

from tpupt_torch.accel import sweep_kernel
from tpupt_torch.core import math3d as m3
from tpupt_torch.core.camera import make_camera
from tpupt_torch.core.types import OBJ_MESH
from tpupt_torch.render import integrator, trip_kernel
from tpupt_torch.render.integrator import render_image, render_route, trace_sample
from tpupt_torch.render.intersect import intersect_scene_ids
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.json_parser import scene_from_json
from tpupt_torch.scene.procedural import icosphere

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

CORNELL = ("cornell.json", "cornell_area.json")
SCENES = ("lamp", "many16", "quad_mixed", "ico_light") + CORNELL
KEYS = ("color", "normal", "depth")
W = H = 16
# the default hit pass, wrapped: the body route on the same hits
BODY = functools.partial(intersect_scene_ids)


def _T(xyz):
    return np.asarray(m3.mat_translate(xyz))


def _lamp(d):
    d.add_material("floor", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_material("lamp", "diffuse_light", emit=(10.0, 8.0, 6.0))
    d.add_sphere(100.0, _T([0, -100.5, -1]), "floor")
    d.add_sphere(0.3, _T([0, 0.7, -1.5]), "lamp")


def _many16(d):
    d.add_material("floor", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_sphere(100.0, _T([0, -100.5, -1]), "floor")
    for i in range(16):
        d.add_material(f"lamp{i}", "diffuse_light", emit=(2.0 + 0.2 * i, 2.0, 1.0))
        d.add_sphere(0.15, _T([-1.5 + 3.0 * i / 15, 0.8, -1.5]), f"lamp{i}")


def _quad_mixed(d):
    d.add_material("floor", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_material("qlamp", "diffuse_light", emit=(8.0, 6.0, 4.0))
    d.add_sphere(100.0, _T([0, -100.5, -1]), "floor")
    quad_v = np.array([[-0.5, 0.8, -1.0], [0.5, 0.8, -1.0], [0.5, 0.8, -2.0], [-0.5, 0.8, -2.0]],
                      np.float32)
    d.add_mesh("quad", quad_v, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    d.add_mesh_object("quad", np.eye(4), "qlamp")
    d.add_material("slamp", "diffuse_light", emit=(4.0, 4.0, 8.0))
    d.add_sphere(0.2, _T([1.2, 0.6, -1.5]), "slamp")


def _ico_light(d, ico=icosphere):
    """An emissive icosphere of 320 triangles (``ico``: the port's or the
    JAX package's ``procedural.icosphere``) beside a diffuse floor."""
    d.add_material("floor", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_material("ilamp", "diffuse_light", emit=(6.0, 5.0, 4.0))
    d.add_sphere(100.0, _T([0, -100.5, -1]), "floor")
    v, f = ico(2)
    d.add_mesh("ico", v, f)
    d.add_mesh_object("ico", _T([0.4, 0.2, -1.6]) @ np.diag([0.35, 0.35, 0.35, 1.0]), "ilamp")


BUILDERS = {"lamp": _lamp, "many16": _many16, "quad_mixed": _quad_mixed, "ico_light": _ico_light}


@pytest.fixture(scope="module")
def scenes_dir(tmp_path_factory):
    """The shipped Cornell JSONs beside a private models/ dir (other test
    files generate the shared assets/models concurrently)."""
    root = tmp_path_factory.mktemp("trip_nee_assets")
    shutil.copytree(os.path.join(locate_asset_path(), "scenes"), root / "scenes")
    ensure_models(str(root / "models"), names=["quad.obj"])
    return str(root / "scenes")


def _port_scene(name, scenes_dir, device="cpu"):
    """(scene, camera) built by the port's own scene code."""
    if name in CORNELL:
        d = scene_from_json(os.path.join(scenes_dir, name))
        return d.build(device=device), d.camera
    d = SceneDescription(bg_down=(0, 0, 0), bg_up=(0, 0, 0))  # dark world
    BUILDERS[name](d)
    return d.build(device=device), make_camera(vfov=np.pi / 2)


@pytest.fixture(scope="module")
def scenes(scenes_dir):
    return {name: _port_scene(name, scenes_dir) for name in SCENES}


def _assert_equal(a, b):
    (ba, ra), (bb, rb) = a, b
    assert int(ra) == int(rb) > 0
    for key in KEYS:
        assert torch.equal(getattr(ba, key), getattr(bb, key)), key


def test_scenes_cover_every_term_kind(scenes):
    kinds = {name: integrator._nee_kinds(s) for name, (s, _) in scenes.items()}
    assert kinds == {"lamp": ("light",), "many16": ("sampled",), "quad_mixed": ("mesh", "light"),
                     "ico_light": ("mesh",), "cornell.json": ("light",),
                     "cornell_area.json": ("mesh",)}
    meshes = {name: OBJ_MESH in s.s_obj_kind for name, (s, _) in scenes.items()}
    assert meshes == {"lamp": False, "many16": False, "quad_mixed": True, "ico_light": True,
                      "cornell.json": False, "cornell_area.json": True}
    assert scenes["ico_light"][0].s_tri_light_count == 320
    for name, (s, _) in scenes.items():
        assert s.has_nee and render_route(s) == "trip", name


# --- the trip route against the body route (CPU: the twins) ---------------------

MODES = {"chained": {}, "per_sample": dict(chain_samples=False)}


@pytest.mark.parametrize("rr_start", [None, 2], ids=["no_rr", "rr2"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SCENES)
def test_trip_route_equals_body_route(scenes, name, mode, rr_start):
    scene, cam = scenes[name]
    kw = dict(width=W, height=H, spp=2, max_bounces=4, rr_start=rr_start, start_iteration=3,
              **MODES[mode])
    trip = render_image(scene, cam, **kw)
    _assert_equal(trip, render_image(scene, cam, intersect_fn=BODY, **kw))
    assert float(trip[0].color.max()) > 0.05  # the emitters light the scene


@pytest.mark.parametrize("name", SCENES)
def test_trace_sample_trip_equals_body(scenes, name):
    scene, cam = scenes[name]
    kw = dict(max_bounces=4, rr_start=2, row0=3, rows=10)
    got = trace_sample(scene, cam, W, H, 5, **kw)
    want = trace_sample(scene, cam, W, H, 5, intersect_fn=BODY, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture
def trip_calls(monkeypatch):
    """Counts the trip kernels' calls (the twins' too, unlike LAUNCHES)
    and fails on any ``_bounce_body``."""
    calls = {k: 0 for k in trip_kernel.LAUNCHES}
    for name in calls:
        fn = getattr(trip_kernel, name)

        def counting(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(trip_kernel, name, counting)

    def no_body(*args, **kw):
        raise AssertionError("_bounce_body ran on the trip route")

    monkeypatch.setattr(integrator, "_bounce_body", no_body)
    return calls


@pytest.mark.parametrize("name", ["quad_mixed", "cornell.json"])
def test_trip_route_runs_trip_nee_every_trip(scenes, trip_calls, name):
    scene, cam = scenes[name]
    render_image(scene, cam, W, H, spp=2, max_bounces=3, rr_start=2)
    assert trip_calls["trip_head"] == trip_calls["trip_nee"] == trip_calls["trip_tail"] > 2
    trace_sample(scene, cam, W, H, 1, max_bounces=3)
    assert trip_calls["trip_head"] == trip_calls["trip_nee"] == trip_calls["trip_tail"]


def test_one_any_hit_call_equals_one_per_term():
    """quad_mixed with a clay icosphere under both lights: its NEE terms
    (the mesh light, the sphere lamp) in their packet-aligned regions of
    one row buffer.  One any-hit call over all of them equals a call per
    term, on a trip where the blocker occludes lanes of both terms."""
    d = SceneDescription(bg_down=(0, 0, 0), bg_up=(0, 0, 0))
    _quad_mixed(d)
    v, f = icosphere(1)
    d.add_material("clay", "lambertian", albedo=(0.6, 0.5, 0.4))
    d.add_mesh("blocker", v, f)
    d.add_mesh_object("blocker", _T([0.5, 0.2, -1.5]) @ np.diag([0.3, 0.3, 0.3, 1.0]), "clay")
    scene, cam = d.build(device="cpu"), make_camera(vfov=np.pi / 2)
    plan = integrator._trip_plan(scene, cam, 24, 24, spp=1, max_bounces=4, rr_start=None,
                                 iteration=0, chained=True)
    assert plan.nee_kinds == ("mesh", "light")
    F, I = integrator._trip_start(plan)
    buf = trip_kernel.trip_buffers(plan)
    tre = (scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
    trip_kernel.trip_head(plan, F, I, buf)
    sweep = sweep_kernel.treelet_closest_hit(buf.sweep_rows, buf.act_p, *tre)
    trip_kernel.trip_nee(plan, F, I, buf, sweep)
    np_ = plan.n_pad // 256
    assert buf.nee_mask.shape == (2 * np_, 256)
    whole = sweep_kernel.treelet_any_hit(buf.shadow_rows, buf.nee_mask, *tre)
    for t in range(2):
        region = slice(t * np_, (t + 1) * np_)
        rows = {k: v[region].contiguous() for k, v in buf.shadow_rows.items()}
        part = sweep_kernel.treelet_any_hit(rows, buf.nee_mask[region].contiguous(), *tre)
        assert torch.equal(whole[region], part), t
        assert bool(part.any()) and bool((buf.nee_mask[region] & ~part).any()), t


# --- the trip route against the JAX package ------------------------------------

def _jax_ico_light():
    """``ico_light`` built by the JAX package's description."""
    from tpupt.scene.description import SceneDescription as JaxDescription
    from tpupt.scene.procedural import icosphere as jax_icosphere

    d = JaxDescription(bg_down=(0, 0, 0), bg_up=(0, 0, 0))
    _ico_light(d, jax_icosphere)
    return d.build()



@pytest.mark.parametrize("name", SCENES)
def test_trace_sample_matches_jax(scenes_dir, name):
    """The forward ``trace_sample`` (the trip route here, the JAX
    package's own forward loop there), 4 bounces, RR 2."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("tpupt.render.integrator")  # the JAX package and what it imports
    from test_emissive import _lamp_scene, _many_light_scene, _quad_light_scene
    from test_torch_nee import _check_buffers, _xla_elementary
    from test_torch_scene import port_scene
    from tpupt.core.camera import make_camera as jax_make_camera
    from tpupt.render import integrator as jax_integrator
    from tpupt.scene.json_parser import scene_from_json as jax_scene_from_json

    if name in CORNELL:
        jdesc = jax_scene_from_json(os.path.join(scenes_dir, name))
        jscene, jcam = jdesc.build(), jdesc.camera
        pscene, pcam = _port_scene(name, scenes_dir)
    else:
        build = {"lamp": _lamp_scene, "many16": lambda: _many_light_scene(16),
                 "quad_mixed": lambda: _quad_light_scene(extra_sphere_lamp=True),
                 "ico_light": _jax_ico_light}[name]
        jscene, jcam = build(), jax_make_camera(vfov=np.pi / 2)
        pscene, pcam = port_scene(jscene), make_camera(vfov=np.pi / 2)
    with jax.disable_jit():
        want = jax_integrator.trace_sample(jscene, jcam, W, H, 2, max_bounces=4, rr_start=2)
    assert render_route(pscene) == "trip"
    for patched in (False, True) if name in CORNELL else (False,):
        with _xla_elementary() if patched else contextlib.nullcontext():
            got = trace_sample(pscene, pcam, W, H, 2, max_bounces=4, rr_start=2)
        assert int(got[3]) == int(want[3]) > W * H
        _check_buffers(name, patched, [t.numpy() for t in got[:3]],
                       [np.asarray(t) for t in want[:3]])


# --- the kernels against their twins (card only) --------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


HEAD_OUT = ("hrec", "hint", "rows", "act_p")
NEE_OUT = ("alive_next", "nee_contrib", "nee_mask", "nee_rows")


def _clone(buf, keys):
    return {k: None if getattr(buf, k) is None else getattr(buf, k).clone() for k in keys}


def _recorded_trips(render, keep):
    """``render()`` with the inputs of its trips ``keep`` cloned as each
    kernel receives them: {trip: dict(plan, F, I before the head, F, I
    before trip_nee, buffers before each, the sweep's and the any-hit
    sweep's outputs)}."""
    got, n = {}, {"head": 0, "nee": 0, "tail": 0}
    head, nee, tail = trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail

    def rec_head(plan, F, I, buf):
        if n["head"] in keep:
            got[n["head"]] = dict(plan=plan, F0=F.clone(), I0=I.clone(),
                                  head_pre=_clone(buf, HEAD_OUT))
        n["head"] += 1
        return head(plan, F, I, buf)

    def rec_nee(plan, F, I, buf, sweep=None):
        if n["nee"] in keep:
            got[n["nee"]].update(F1=F.clone(), I1=I.clone(), head=_clone(buf, HEAD_OUT),
                                 nee_pre=_clone(buf, NEE_OUT),
                                 sweep=None if sweep is None else tuple(o.clone() for o in sweep))
        n["nee"] += 1
        return nee(plan, F, I, buf, sweep)

    def rec_tail(plan, F, I, buf, sweep=None, occ=None):
        if n["tail"] in keep:
            got[n["tail"]].update(F2=F.clone(), I2=I.clone(), nee=_clone(buf, NEE_OUT),
                                  occ=None if occ is None else occ.clone())
        n["tail"] += 1
        return tail(plan, F, I, buf, sweep, occ)

    trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail = rec_head, rec_nee, rec_tail
    try:
        render()
    finally:
        trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail = head, nee, tail
    return got


def _buffers_from(plan, saved):
    buf = trip_kernel.trip_buffers(plan)
    for k, v in saved.items():
        if v is not None:
            getattr(buf, k).copy_(v)
    return buf


@pytest.mark.cuda
@pytest.mark.parametrize("chained", [True, False], ids=["chained", "per_sample"])
@pytest.mark.parametrize("name", SCENES)
def test_trip_nee_kernels_equal_twins(cuda_device, scenes_dir, name, chained):
    scene, cam = _port_scene(name, scenes_dir, device=cuda_device)
    kw = dict(spp=2, max_bounces=4, rr_start=2, chain_samples=chained)
    got = _recorded_trips(lambda: render_image(scene, cam, 40, 32, **kw), keep={0, 2, 3})
    assert got
    for trip, r in got.items():
        plan = r["plan"]
        # the head
        bk, bp = _buffers_from(plan, r["head_pre"]), _buffers_from(plan, r["head_pre"])
        trip_kernel.trip_head(plan, r["F0"].clone(), r["I0"].clone(), bk)
        trip_kernel.trip_head_plain(plan, r["F0"].clone(), r["I0"].clone(), bp)
        for k in HEAD_OUT:
            a, b = getattr(bk, k), getattr(bp, k)
            assert (a is None and b is None) or torch.equal(a, b), (trip, k)
        # trip_nee on the recorded record and sweep
        saved = dict(r["head"], **r["nee_pre"])
        bk, bp = _buffers_from(plan, saved), _buffers_from(plan, saved)
        Fk, Ik, Fp, Ip = r["F1"].clone(), r["I1"].clone(), r["F1"].clone(), r["I1"].clone()
        n0 = trip_kernel.LAUNCHES["trip_nee"]
        trip_kernel.trip_nee(plan, Fk, Ik, bk, r["sweep"])
        trip_kernel.trip_nee_plain(plan, Fp, Ip, bp, r["sweep"])
        torch.cuda.synchronize()
        assert trip_kernel.LAUNCHES["trip_nee"] == n0 + 1
        assert torch.equal(Fk, Fp), (trip, (Fk != Fp).sum(dim=1).tolist())
        assert torch.equal(Ik, Ip), trip
        for k in NEE_OUT:
            a, b = getattr(bk, k), getattr(bp, k)
            assert (a is None and b is None) or torch.equal(a, b), (trip, k)
        # the NEE tail on the recorded trip_nee outputs and occlusion
        saved = dict(r["head"], **r["nee"])
        bk, bp = _buffers_from(plan, saved), _buffers_from(plan, saved)
        Fk, Ik, Fp, Ip = r["F2"].clone(), r["I2"].clone(), r["F2"].clone(), r["I2"].clone()
        trip_kernel.trip_tail(plan, Fk, Ik, bk, occ=r["occ"])
        trip_kernel.trip_tail_plain(plan, Fp, Ip, bp, occ=r["occ"])
        torch.cuda.synchronize()
        assert torch.equal(Ik, Ip), trip
        assert torch.equal(Fk, Fp), (trip, (Fk != Fp).sum(dim=1).tolist())
        assert int(bk.count) == int(bp.count), trip


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_trip_route_equals_body_route_on_card(cuda_device, scenes_dir, name):
    scene, cam = _port_scene(name, scenes_dir, device=cuda_device)
    kw = dict(width=48, height=40, spp=2, max_bounces=4, rr_start=2)
    before = trip_kernel.launch_counts()
    trip = render_image(scene, cam, **kw)
    after = trip_kernel.launch_counts()
    assert after["trip_nee"] > before["trip_nee"] and after["trip_tail"] > before["trip_tail"]
    _assert_equal(trip, render_image(scene, cam, intersect_fn=BODY, **kw))


def _nee_outputs(plan, r, F, I, alive=None, kernel=True):
    """trip_nee (or its twin) on a recorded trip's inputs, with the alive
    row replaced by ``alive`` if given: (F, I, buffers)."""
    buf = _buffers_from(plan, dict(r["head"], **r["nee_pre"]))
    F, I = F.clone(), I.clone()
    if alive is not None:
        I[trip_kernel.I_KEYS.index("alive")] = alive
    (trip_kernel.trip_nee if kernel else trip_kernel.trip_nee_plain)(plan, F, I, buf, r["sweep"])
    return F, I, buf


def _assert_nee_equal(got, want, what):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), what
    for k in NEE_OUT:
        a, b = getattr(got[2], k), getattr(want[2], k)
        assert (a is None and b is None) or torch.equal(a, b), (what, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["quad_mixed", "ico_light", "cornell.json"])
def test_trip_nee_sparse_trip_and_pad_lanes_equal_twin(cuda_device, scenes_dir, name):
    """trip_nee on bounce 1 of a 45x37 sample (1,665 lanes padded to
    1,792: 127 pad lanes) with only five lanes left alive, spread over
    the lanes, the last real lane among them; and with every lane dead:
    each output equal to the twin's (a dead chunk writes only its masks
    and -BIG seeds, the pad lanes their rows)."""
    scene, cam = _port_scene(name, scenes_dir, device=cuda_device)
    got = _recorded_trips(lambda: render_image(scene, cam, 45, 37, spp=1, max_bounces=4,
                                               chain_samples=False), keep={1})
    r = got[1]
    plan = r["plan"]
    assert plan.n == 1665 and plan.n_pad == 1792
    for keep in ([3, 700, 1100, 1500, 1664], []):
        alive = torch.zeros(plan.n, dtype=torch.int32, device=cuda_device)
        alive[keep] = r["I1"][trip_kernel.I_KEYS.index("alive")][keep]
        kern = _nee_outputs(plan, r, r["F1"], r["I1"], alive)
        twin = _nee_outputs(plan, r, r["F1"], r["I1"], alive, kernel=False)
        torch.cuda.synchronize()
        _assert_nee_equal(kern, twin, keep)


@pytest.mark.cuda
def test_trip_nee_back_to_back_launches_equal_twin(cuda_device, scenes_dir):
    """Three trip_nee launches in a row on one stream, with no host sync
    between them, on copies of one trip's inputs: every launch's outputs
    equal to the twin's, so no launch leaves state that the next one
    reads (each warp takes its chunks by its index in the grid)."""
    scene, cam = _port_scene("cornell_area.json", scenes_dir, device=cuda_device)
    got = _recorded_trips(lambda: render_image(scene, cam, 64, 48, spp=1, max_bounces=3),
                          keep={0})
    r, plan = got[0], got[0]["plan"]
    runs = [_nee_outputs(plan, r, r["F1"], r["I1"]) for _ in range(3)]
    twin = _nee_outputs(plan, r, r["F1"], r["I1"], kernel=False)
    torch.cuda.synchronize()
    for j, run in enumerate(runs):
        _assert_nee_equal(run, twin, j)
