"""The Cornell box of *Ray Tracing: The Next Week* (the benchmark's
configuration ``h100bench/configs/cornell_box.json``) on the port, and
the cull's repair for axis-aligned quads.

* The box at 32x32, 2 spp, 8 bounces through ``scene_from_json`` (its
  black background read) and ``desc.build``, on the trip route's torch
  twins (with the sweep, ``trip_nee`` and any-hit on every trip) and on the
  body route, equals the configuration's plain reference
  (``h100bench/reference/pathtrace_scene.py``) bit for bit outside tied
  pixels, segments included, for three sample starts.
* Rays that meet the book's zero-thickness lamp quad at or just inside an
  edge keep their hit: the sweep's slab test and its walk's exit test give
  each bound ``packets.SLAB_EPS`` of itself, where the exact tests rounded
  some of them out of the box, or put the box's entry past their t.  Held
  in the sweep, the any-hit sweep and one trip of the trip route, on the
  CPU twins and, on a card, the kernels.  A hit a hair after the origin
  keeps its box too: each slab is widened by an ulp of its coordinates
  over the direction (``packets._slab_pad``), where SLAB_EPS's share of t
  is far too small.
* An exact-t tie of two objects goes to the later visit, the JAX package's
  rule (``tests/test_torch_sweep.py`` holds the twin to it); the reference
  flags such pixels tied.
* The configuration's JSON and OBJ files give the book's corners: the
  walls and lamp as its quads, each box one object of the unit cube's six
  quads turned +15 and -18 degrees about y, in the program's scene and in
  the reference's.

This file imports no JAX, so its card tests run where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cornell_box.py -m cuda
"""

from __future__ import annotations

import functools
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch

from h100bench import run
from h100bench.jobs import render as render_job
from h100bench.reference import pathtrace
from tpupt_torch.accel import packets, sweep_kernel
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render import integrator
from tpupt_torch.render import trip_kernel as tk
from tpupt_torch.render.intersect import intersect_scene_ids
from tpupt_torch.scene.assets_gen import ensure_models
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.json_parser import scene_from_json

torch.set_num_threads(1)

CONFIG = run.load_json(run.HERE, "configs", "cornell_box.json")
# the configuration's plain reference
ref = importlib.import_module(f"h100bench.reference.{CONFIG['reference']}")
BIG = packets.BIG
TRAFFIC = dict(job="render", width=32, height=32, spp=2, max_bounces=8, rr_start=None,
               first_sample_modulus=1 << 20)
# the book's quads (Q, u, v), in the configuration's surface order
WALLS = {"cornell_box_green": ((555, 0, 0), (0, 555, 0), (0, 0, 555)),
         "cornell_box_red": ((0, 0, 0), (0, 555, 0), (0, 0, 555)),
         "cornell_box_lamp": ((343, 554, 332), (-130, 0, 0), (0, 0, -105)),
         "cornell_box_floor": ((0, 0, 0), (555, 0, 0), (0, 0, 555)),
         "cornell_box_ceiling": ((555, 555, 555), (-555, 0, 0), (0, 0, -555)),
         "cornell_box_back": ((0, 0, 555), (555, 0, 0), (0, 555, 0))}
# box(a, b) of the book: its six quads (Q, u, v) in terms of a, b
FACES = {"front": lambda a, b, d: ((a[0], a[1], b[2]), (d[0], 0, 0), (0, d[1], 0)),
         "right": lambda a, b, d: ((b[0], a[1], b[2]), (0, 0, -d[2]), (0, d[1], 0)),
         "back": lambda a, b, d: ((b[0], a[1], a[2]), (-d[0], 0, 0), (0, d[1], 0)),
         "left": lambda a, b, d: ((a[0], a[1], a[2]), (0, 0, d[2]), (0, d[1], 0)),
         "top": lambda a, b, d: ((a[0], b[1], b[2]), (d[0], 0, 0), (0, 0, -d[2])),
         "bottom": lambda a, b, d: ((a[0], a[1], a[2]), (d[0], 0, 0), (0, 0, d[2]))}
# the book's two boxes: far corner, turn about y (degrees), move
BOXES = (((165, 330, 165), 15.0, (265, 0, 295)), ((165, 165, 165), -18.0, (130, 0, 65)))


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return run.prepare(str(tmp_path_factory.mktemp("cornell_box")), CONFIG)


@pytest.fixture(scope="module")
def faces_path(tmp_path_factory):
    """The scene with each box's six quads as objects of their own (the
    layout in which the card's recorded misses arose): the same vertices,
    one OBJ file a face of the unit cube."""
    base = tmp_path_factory.mktemp("cornell_box_faces")
    path = run.prepare(str(base), CONFIG)
    lines = open(os.path.join(run.HERE, "models", "unit_box.obj")).read().splitlines()
    verts = [ln for ln in lines if ln.startswith("v ")]
    j = json.load(open(path))
    boxes = [sf for sf in j["surfaces"] if sf["filename"].endswith("unit_box.obj")]
    j["surfaces"] = [sf for sf in j["surfaces"] if sf not in boxes]
    for face in range(6):
        name = f"unit_box_face{face}.obj"
        with open(os.path.join(os.path.dirname(path), "..", "models", name), "w") as fh:
            fh.write("\n".join(verts[4 * face:4 * face + 4] + ["f 1 2 3", "f 1 3 4"]) + "\n")
    j["surfaces"] += [dict(sf, filename=f"../models/unit_box_face{face}.obj")
                      for sf in boxes for face in range(6)]
    out = os.path.join(os.path.dirname(path), "cornell_box_faces.json")
    json.dump(j, open(out, "w"))
    return out


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counting(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counting)


@pytest.mark.parametrize("route", ["trip", "body"])
@pytest.mark.parametrize("start", [0, 4099, 2**20 - 5])
def test_cornell_box_equals_reference(scene_path, monkeypatch, route, start):
    """The whole 32x32 image, segments included, equals the reference's."""
    desc = scene_from_json(scene_path, honor_background=True)
    scene = desc.build(leaf_size=CONFIG["leaf_size"], device="cpu")
    fn = functools.partial(intersect_scene_ids) if route == "body" else None
    assert integrator.render_route(scene, False, fn, None, None, True, desc.camera) == route
    calls = {}
    for name in ("trip_head", "trip_nee", "trip_tail"):
        _counting(monkeypatch, tk, name, calls)
    for name in ("treelet_closest_hit", "treelet_any_hit"):
        _counting(monkeypatch, sweep_kernel, name, calls)
    t = TRAFFIC
    buf, rays = integrator.render_image(scene, desc.camera, t["width"], t["height"], t["spp"],
                                        max_bounces=t["max_bounces"], rr_start=None,
                                        start_iteration=start, intersect_fn=fn)
    got = dict(color=buf.color, normal=buf.normal, depth=buf.depth, segs=int(rays))
    want = render_job.reference(ref, scene_path, t, start, "cpu")
    assert render_job.numbers(got, want) == dict(pixels_off=0.0, segments_gap=0.0)
    assert int(want["tied"].sum()) < 8
    if route == "trip":
        # the lit mesh trip: the sweep, trip_nee and any-hit on every trip
        trips = calls["trip_tail"]
        assert trips > 8 and all(calls[k] == trips for k in calls), calls
    else:
        assert "trip_head" not in calls


# --- the cull's repair -----------------------------------------------------------

def _lamp():
    """The scene of the lamp alone, as the configuration's OBJ file holds
    it."""
    pos, tris = pathtrace.read_obj(os.path.join(run.HERE, "models", "cornell_box_lamp.obj"))
    d = SceneDescription()
    d.add_material("light", "diffuse_light", emit=(15.0, 15.0, 15.0))
    d.add_mesh("lamp", pos, tris.astype(np.int32))
    d.add_mesh_object("lamp", np.eye(4), "light")
    return d


def _edge_rays(n=6000, seed=5):
    """float32 rays from points of the room below the lamp to points on
    its four edges or up to 1e-3 inside them, unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((5, 5, 5), (550, 540, 550), (n, 3))
    edge = rng.integers(0, 4, n)
    s = rng.uniform(0, 1, n)
    inside = rng.uniform(0, 1e-3, n) * (rng.random(n) < 0.5)
    x = np.where(edge == 0, 213 + inside, np.where(edge == 1, 343 - inside, 213 + 130 * s))
    z = np.where(edge == 2, 227 + inside, np.where(edge == 3, 332 - inside, 227 + 105 * s))
    tgt = np.stack([x, np.full(n, 554.0), z], axis=1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _one_lane_rows(o, d, t_cap, device):
    """One packet a ray, the ray in lane 0, every other lane dead: no
    other lane's slab test can keep a box in the packet."""
    n = o.shape[0]
    shape = (n, packets.PACKET)
    rows = {k: torch.zeros(shape, device=device) for k in packets._ROW_KEYS}
    for i, k in enumerate(("rox", "roy", "roz")):
        rows[k][:, 0] = torch.from_numpy(o[:, i]).to(device)
    for i, k in enumerate(("rdx", "rdy", "rdz")):
        rows[k][:] = 1.0
        rows[k][:, 0] = torch.from_numpy(d[:, i]).to(device)
    rows["tmin"][:, 0] = 1e-4
    act = torch.zeros(shape, dtype=torch.bool, device=device)
    act[:, 0] = True
    rows["t"] = torch.where(act, torch.as_tensor(t_cap, device=device)[:, None], -BIG)
    return rows, act


def _exact_entry(lo, hi, rows):
    """Lane 0's entry of each packet into the box (lo, hi) by the slab test
    without tolerance (``packets._entry_dense`` before it had one): BIG
    where the rounded slabs miss."""
    near, far = None, None
    for a, (o_k, d_k) in enumerate((("rox", "rdx"), ("roy", "rdy"), ("roz", "rdz"))):
        iv = 1.0 / rows[d_k][:, 0]
        t0, t1 = (lo[a] - rows[o_k][:, 0]) * iv, (hi[a] - rows[o_k][:, 0]) * iv
        n_, f_ = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = n_ if near is None else torch.maximum(near, n_)
        far = f_ if far is None else torch.minimum(far, f_)
    hit = (far >= near) & (far >= rows["tmin"][:, 0]) & (near <= rows["t"][:, 0])
    return torch.where(hit, torch.clamp(near, min=0.0), BIG)


def _faults(scene, o, d):
    """Of the edge rays that Moller-Trumbore takes to the lamp: those the
    exact slab test drops (``dropped``) and those whose exact entry lies
    past their t (``late``), with each ray's t and triangle."""
    rows, act = _one_lane_rows(o, d, np.full(o.shape[0], BIG, np.float32), "cpu")
    entry = _exact_entry(scene.tre_min[0], scene.tre_max[0], rows)
    K, L = scene.tre_tris.shape[0], scene.s_leaf_size
    tri = [scene.tre_tris.view(K, 13, L)[0, c, :2][None, :] for c in range(9)]
    ray = {k: rows[k][:, :1] for k in ("rox", "roy", "roz", "rdx", "rdy", "rdz", "tmin")}
    ok, t = packets._dense_mt(tri, ray, torch.full((o.shape[0], 1), BIG))
    t_hit, j = torch.where(ok, t, BIG).min(dim=1)
    hit = t_hit < BIG
    return hit & (entry >= BIG), hit & (entry < BIG) & (entry > t_hit), t_hit, j


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_quad_edge_hits_keep_their_hit(device):
    """The twins on the CPU, the kernels on a card: the exact tests lose
    some edge hits, the sweep's tolerances keep every one."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    desc = _lamp()
    scene = desc.build(leaf_size=32, device="cpu")
    o, d = _edge_rays()
    dropped, late, t_hit, j = _faults(scene, o, d)
    # the exact tests drop some of these hits and put the entry past others
    assert int(dropped.sum()) >= 10 and int(late.sum()) >= 10
    dev_scene = scene.to(device)
    tre = (dev_scene.tre_min, dev_scene.tre_max, dev_scene.tre_tris, dev_scene.s_leaf_size)
    for name, sel, cap in (("dropped", dropped, None), ("late", late, t_hit)):
        idx = torch.nonzero(sel).reshape(-1).numpy()
        t_cap = np.full(len(idx), BIG, np.float32) if cap is None else cap[sel].numpy()
        rows, act = _one_lane_rows(o[idx], d[idx], t_cap, device)
        t, slot = (x[:, 0].cpu() for x in sweep_kernel.treelet_closest_hit(rows, act, *tre)[:2])
        assert torch.equal(slot, j[sel].to(torch.int32)), f"{name}: the sweep lost the lamp"
        assert torch.equal(t, t_hit[sel]), name
        # shadow rays to the same points: the lamp occludes each of them
        rows["t"] = torch.where(act, (t_hit[sel] * 1.001).to(device)[:, None], -BIG)
        occ = sweep_kernel.treelet_any_hit(rows, act, *tre)[:, 0].cpu()
        assert bool(occ.all()), f"{name}: the any-hit sweep lost the lamp"

    # one trip of the trip route on the dropped rays, one live lane a packet:
    # trip_head's rows, the sweep, trip_nee, any-hit and the NEE tail; each
    # ray takes the lamp's emission and ends there
    idx = torch.nonzero(dropped).reshape(-1).numpy()
    m = len(idx)
    plan, F, I, buf = integrator._trip_setup(
        dev_scene, desc.camera, packets.PACKET, m, spp=1, max_bounces=1, rr_start=None,
        iteration=0, chained=False)
    lane = torch.arange(m, device=device) * packets.PACKET
    for i, k in enumerate(("rox", "roy", "roz")):
        F[tk.F_KEYS.index(k)][lane] = torch.from_numpy(o[idx, i]).to(device)
    for i, k in enumerate(("rdx", "rdy", "rdz")):
        F[tk.F_KEYS.index(k)][lane] = torch.from_numpy(d[idx, i]).to(device)
    alive = I[tk.I_KEYS.index("alive")]
    alive.zero_()
    alive[lane] = 1
    tk.trip_head(plan, F, I, buf)
    sweep = sweep_kernel.treelet_closest_hit(buf.sweep_rows, buf.act_p, *tre)
    assert torch.equal(sweep[1].reshape(-1)[lane].cpu(), j[dropped].to(torch.int32))
    tk.trip_nee(plan, F, I, buf, sweep)
    occ = sweep_kernel.treelet_any_hit(buf.shadow_rows, buf.nee_mask, *tre)
    tk.trip_tail(plan, F, I, buf, occ=occ)
    st = tk.unpack_state(F, I)["state"]
    assert not bool(st["alive"][lane].any())
    for c in st["radiance"]:
        assert torch.equal(c[lane].cpu(), torch.full((m,), 15.0))



def _tie_scene(device):
    """Two objects holding the same quad (the same vertices, so every ray
    meets both at exactly one t); the later one also has a small triangle
    nearer the camera, so its box is entered first and the walk visits it
    first."""
    quad = [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]
    near = quad + [[-1, -1, 1], [-0.9, -1, 1], [-1, -0.9, 1]]
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(0.5, 0.5, 0.5))
    d.add_mesh("quad", np.asarray(quad, np.float32), np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    d.add_mesh("quad_and_near", np.asarray(near, np.float32),
               np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32))
    d.add_mesh_object("quad", np.eye(4), "m")
    d.add_mesh_object("quad_and_near", np.eye(4), "m")
    return d.build(device=device)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_exact_tie_of_two_objects_goes_to_the_later(device):
    """The later visit keeps an exact tie of two objects, as the JAX
    package's sweep does: where the walk visits the later object's treelet
    first, the earlier object, visited later, wins."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    scene = _tie_scene(device)
    g = torch.linspace(-0.83, 0.77, 24, device=device)
    x, y = (a.reshape(-1) for a in torch.meshgrid(g, g + 0.013, indexing="ij"))
    n = x.numel()
    one, zero = torch.ones(n, device=device), torch.zeros(n, device=device)
    rows, act = packets._pack_rows(Vec3(x, y, 3.0 * one), Vec3(zero, zero, -one),
                                   torch.full((n,), 1e-4, device=device),
                                   torch.full((n,), BIG, device=device),
                                   torch.ones(n, dtype=torch.bool, device=device))
    tre = (scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
    entry = packets._cull_entries(*tre[:2], rows, act)
    assert bool((entry[:, 1] < entry[:, 0]).all())  # the later object's treelet comes first
    t, slot, nx, ny, nz, obj = (o.reshape(-1)[:n].cpu()
                                for o in sweep_kernel.treelet_closest_hit(rows, act, *tre))
    assert bool((slot >= 0).all()) and torch.equal(t, torch.full((n,), 3.0))
    assert torch.equal(obj, torch.zeros(n))


# lanes of the card's 2048^2 renders whose closest hit the exact tests lost
# (experiments/torch_quad_miss.py before the repair; the Cornell box with
# each box face an object of its own): the scene, the packed ray (origin,
# direction, t_min, seed t), the hit's t by brute force
RECORDED = [
    ("cornell_area", (0.4654768705368042, 2.0000832080841064, 0.4320804178714752,
                      -0.5454841256141663, -0.7078366279602051, -0.4487919807434082,
                      9.999999747378752e-05, 1.5735183954238892), 0.028372636064887047),
    ("cornell_area", (-0.6131747364997864, 0.861583411693573, -0.15723885595798492,
                      0.32624074816703796, 0.835772693157196, 0.45377877354621887,
                      9.999999747378752e-05, 1.3696357011795044), 1.3381826877593994),
    ("cornell_area", (-0.609434962272644, -0.0003882813034579158, 0.7733435034751892,
                      0.19776901602745056, 0.8339630365371704, -0.515163242816925,
                      9.999999747378752e-06, 2.39880108833313), 2.374671697616577),
    ("cornell_box", (217.31655883789062, 98.50634002685547, 266.8620300292969,
                     -0.0683363825082779, -0.4947280287742615, -0.8663569688796997,
                     9.999999747378752e-05, BIG), 199.11209106445312),
    ("cornell_box", (140.8759002685547, 14.480640411376953, 242.02499389648438,
                     0.007158694788813591, -0.12135330587625504, -0.9925836324691772,
                     9.999999747378752e-05, BIG), 119.32628631591797),
]


@pytest.mark.parametrize("case", range(len(RECORDED)))
def test_recorded_card_misses_keep_their_hit(faces_path, case):
    """Each recorded lane, alone in its packet, on the CPU twin: the exact
    slab test drops its hit's treelet (the lamp's edge) or puts the
    treelet's entry past the hit (a box's bottom face on the floor, the
    floor's treelet visited first); the sweep now finds the hit at the
    card's brute-force t.  The fault was the cull's rule, not the card."""
    name, ray, t_hit = RECORDED[case]
    if name == "cornell_area":
        ensure_models(names=["quad.obj"])
        path = os.path.join(run.ROOT, "assets", "scenes", "cornell_area.json")
    else:
        path = faces_path
    scene = scene_from_json(path).build(leaf_size=32, device="cpu")
    o = np.asarray([ray[:3]], np.float32)
    d = np.asarray([ray[3:6]], np.float32)
    rows, act = _one_lane_rows(o, d, np.asarray([ray[7]], np.float32), "cpu")
    rows["tmin"][0, 0] = ray[6]
    tre = (scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
    t, slot = (x[0, 0] for x in sweep_kernel.treelet_closest_hit(rows, act, *tre)[:2])
    assert float(t) == t_hit and int(slot) >= 0
    k = int(slot) // scene.s_leaf_size
    exact = float(_exact_entry(scene.tre_min[k], scene.tre_max[k], rows)[0])
    assert exact >= BIG or exact > t_hit  # the exact tests lose this hit
    entry = float(packets._cull_entries(scene.tre_min, scene.tre_max, rows, act)[0, k])
    assert float(packets._walk_bound(torch.tensor(entry))) <= t_hit < BIG


# a shadow ray of the card's 2048^2 Cornell box renders (each box face an
# object of its own) whose occluder the any-hit sweep lost with SLAB_EPS
# alone: it leaves a face of the second box 1e-4 out, beside a vertical
# edge, and meets the face across that edge at t 3.4e-4 (brute force);
# origin, direction, t_min, the light's distance
EDGE_SHADOW_RAY = (79.01209259033203, 51.781150817871094, 221.92428588867188, 0.2849549353122711,
                   0.9493229985237122, 0.13261429965496063, 9.999999747378752e-05,
                   528.4994506835938)
# that face (box() of the unit cube's x = 0 quad, scaled by 165, turned
# -18 degrees about y, moved by (130, 0, 65)), its corners as the
# program's table holds them in float32
EDGE_FACE = ((130.0, 0.0, 65.0), (79.01219177246094, 0.0, 221.92433166503906),
             (79.01219177246094, 165.0, 221.92433166503906), (130.0, 165.0, 65.0))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_hit_a_hair_after_the_origin_keeps_its_box(device):
    """The recorded shadow ray against that face alone: the exact slab
    test, and the one with SLAB_EPS's share of near and far, put near past
    far by ~3e-6, where Moller-Trumbore takes the face at t 3.4e-4; the
    slab widened by an ulp of its coordinates over the direction keeps the
    box, so the any-hit sweep finds the occluder and the closest-hit sweep
    the face, on the CPU twins and, on a card, the kernels."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    d = SceneDescription()
    d.add_material("white", "lambertian", albedo=(0.73, 0.73, 0.73))
    d.add_mesh("face", np.asarray(EDGE_FACE, np.float32), np.asarray([[0, 1, 2], [0, 2, 3]],
                                                                    np.int32))
    d.add_mesh_object("face", np.eye(4), "white")
    scene = d.build(leaf_size=32, device="cpu")
    ray = EDGE_SHADOW_RAY
    rows, act = _one_lane_rows(np.asarray([ray[:3]], np.float32),
                               np.asarray([ray[3:6]], np.float32),
                               np.asarray([ray[7]], np.float32), "cpu")
    _, _, t_hit, _ = _faults(scene, np.asarray([ray[:3]], np.float32),
                             np.asarray([ray[3:6]], np.float32))
    assert 3e-4 < float(t_hit[0]) < 4e-4
    lo, hi = scene.tre_min[0], scene.tre_max[0]
    assert float(_exact_entry(lo, hi, rows)[0]) >= BIG  # the exact test drops the box
    near = max(min(float((lo[a] - ray[a]) / ray[3 + a]), float((hi[a] - ray[a]) / ray[3 + a]))
               for a in range(3))
    far = min(max(float((lo[a] - ray[a]) / ray[3 + a]), float((hi[a] - ray[a]) / ray[3 + a]))
              for a in range(3))
    assert near * (1 - packets.SLAB_EPS) > far * (1 + packets.SLAB_EPS)  # so does SLAB_EPS alone
    dev_scene = scene.to(device)
    tre = (dev_scene.tre_min, dev_scene.tre_max, dev_scene.tre_tris, dev_scene.s_leaf_size)
    rows = {k: v.to(device) for k, v in rows.items()}
    act = act.to(device)
    assert bool(sweep_kernel.treelet_any_hit(rows, act, *tre)[0, 0])
    rows["t"] = torch.where(act, BIG, -BIG)
    t, slot = (x[0, 0].cpu() for x in sweep_kernel.treelet_closest_hit(rows, act, *tre)[:2])
    assert float(t) == float(t_hit[0]) and int(slot) >= 0


# --- the configuration's files ---------------------------------------------------

def _book_quads():
    """Every quad of the book's scene as its four corners (float64), in the
    configuration's surface order, each box's six in ``box()``'s order."""
    out = []
    for q, u, v in WALLS.values():
        q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
        out.append(np.stack([q, q + u, q + u + v, q + v]))
    for b, turn, move in BOXES:
        a = np.zeros(3)
        b = np.asarray(b, np.float64)
        th = math.radians(turn)
        c, s = math.cos(th), math.sin(th)
        for face in FACES.values():
            q, u, v = (np.asarray(x, np.float64) for x in face(a, b, b - a))
            corners = np.stack([q, q + u, q + u + v, q + v])
            # rotate_y of the book: x' = cos x + sin z, z' = -sin x + cos z
            x, y, z = corners.T
            out.append(np.stack([c * x + s * z, y, -s * x + c * z], axis=1) + np.asarray(move))
    return out


def _program_tris(scene_path):
    """Each mesh object's world triangles in the program's treelet table:
    {object: (T, 3, 3) float64 vertices}."""
    scene = scene_from_json(scene_path).build(leaf_size=CONFIG["leaf_size"], device="cpu")
    K, L = scene.tre_tris.shape[0], scene.s_leaf_size
    blk = scene.tre_tris.view(K, 13, L).permute(0, 2, 1).reshape(K * L, 13).double()
    out = {}
    for slot in torch.nonzero(scene.slot_obj >= 0).reshape(-1).tolist():
        p0, e1, e2 = blk[slot, 0:3], blk[slot, 3:6], blk[slot, 6:9]
        out.setdefault(int(scene.slot_obj[slot]), []).append(torch.stack([p0, p0 + e1, p0 + e2]))
    return {k: torch.stack(v).numpy() for k, v in out.items()}


@pytest.mark.parametrize("quad", range(18))
def test_files_give_the_books_corners(scene_path, quad):
    """The book's quad ``quad`` (six walls and lamp, then each box's six
    faces) is two triangles of its object that cover exactly its four
    corners, in the program's scene and in the reference's; a wall is an
    object of two triangles, a box one of twelve."""
    want = _book_quads()[quad]
    obj = quad if quad < 6 else 6 + (quad - 6) // 6
    tris = _program_tris(scene_path)[obj]
    assert tris.shape == ((2, 3, 3) if quad < 6 else (12, 3, 3))
    # the object's triangles with every vertex at one of the quad's corners
    near = np.abs(tris[:, :, None, :] - want[None, None]).max(axis=3).min(axis=2) < 1e-3
    got = tris[near.all(axis=1)]
    assert got.shape == (2, 3, 3)
    corners = np.unique(got.reshape(-1, 3).round(3), axis=0)
    assert len(corners) == 4
    for w in want:
        assert np.abs(corners - w).max(axis=1).min() < 1e-3, (quad, w)
    # the reference's world triangles of the object start at the same
    # float32 vertices
    inst = ref.load_scene(scene_path, "cpu").inst[obj]
    rp0 = torch.stack(list(inst["p0"]), dim=1).double().numpy()
    assert np.array_equal(np.sort(rp0, axis=0), np.sort(tris[:, 0], axis=0))


# --- on the card: whole rows against the reference --------------------------------

# rows of cornell_area.json at 2048^2, 16 spp, 50 bounces, in which the
# trip route before the repair left pixels off the reference: {sample
# start: rows} (job 1 of seeds 2147492001 and 2147492003)
AREA_ROWS = {8369: [1686], 8371: [33, 1199]}


def _rows_equal_reference(device, path, size, start, rows, reference=pathtrace,
                          background=False):
    """``rows`` (None: every row) of ``path``'s render at ``size``^2, 16 spp,
    50 bounces, no roulette, from sample ``start`` on the trip route, held to
    the plain reference ``reference`` (the scene's background read where
    ``background``): (pixels off outside ties, the launch counts of the
    render)."""
    from tpupt_torch.utils import trace

    desc = scene_from_json(path, honor_background=background)
    scene = desc.build(leaf_size=32, device=device)
    before = trace.launch_counts()
    if rows is None:
        buf, _ = integrator.render_image(scene, desc.camera, size, size, 16, max_bounces=50,
                                         rr_start=None, start_iteration=start)
        got = {k: getattr(buf, k) for k in ("color", "normal", "depth")}
        rows = list(range(size))
    else:
        parts = [integrator.render_image(scene, desc.camera, size, size, 16, max_bounces=50,
                                         rr_start=None, start_iteration=start, row0=r,
                                         rows=1)[0] for r in rows]
        got = {k: torch.cat([getattr(b, k) for b in parts]) for k in ("color", "normal", "depth")}
    launched = {k: v - before[k] for k, v in trace.launch_counts().items()}
    r = torch.tensor(rows, dtype=torch.int64, device=device)
    pix = (r[:, None] * size + torch.arange(size, device=device)).reshape(-1)
    color, normal, depth, _, tied = reference.render_forward(reference.load_scene(path, device),
                                                             size, size, 16, 50, start, pix=pix)
    off = torch.zeros_like(tied)
    for a, b in ((got["color"], color), (got["normal"], normal), (got["depth"], depth)):
        off |= (a != b).reshape(a.shape[0], -1).any(dim=1)
    return int((off & ~tied).sum()), launched


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell_area rows", "cornell_box 512"])
def test_lit_mesh_render_equals_reference_on_card(scene_path, case):
    """On the card: cornell_area.json's rows that the repair brought back
    to the reference (2048^2), and the whole Cornell box at 512^2, equal
    the reference outside ties; each trip ran the sweep, trip_nee and the
    any-hit sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if case == "cornell_box 512":
        checks = [(scene_path, 512, 9001, None, ref, True)]
    else:
        ensure_models(names=["quad.obj"])
        area = os.path.join(run.ROOT, "assets", "scenes", "cornell_area.json")
        checks = [(area, 2048, start, rows, pathtrace, False)
                  for start, rows in AREA_ROWS.items()]
    assert checks
    for path, size, start, rows, reference, background in checks:
        off, launched = _rows_equal_reference("cuda", path, size, start, rows, reference,
                                              background)
        assert off == 0, (case, start)
        trips = launched["trip_tail"]
        assert trips > 0 and all(launched[k] == trips for k in (
            "trip_head", "trip_nee", "treelet_closest_hit", "treelet_any_hit")), launched
