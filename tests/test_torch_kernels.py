"""The PyTorch port's CUDA kernels against their torch twins.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX).  Kernel and twin round
every float32 operation once and in the same order (the kernels are
built with --fmad=false), so every comparison here is exact.  The tests
marked ``cuda`` skip where torch sees no card.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpupt_torch.accel import kernels, packets, step_kernel, sweep_kernel
from tpupt_torch.core import math3d as m3
from tpupt_torch.core.camera import generate_rays, make_camera, pixel_centers
from tpupt_torch.core.vec import Vec3
from tpupt_torch.diff.params import PARAM_LEAVES, extract_params, with_params
from tpupt_torch.render.integrator import render_image
from tpupt_torch.render.intersect import intersect_scene_ids, intersect_scene_ids_diff
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.procedural import icosphere

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ico():
    v, f = icosphere(2)
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.0))
    d.add_mesh("mesh", v, f)
    d.add_mesh_object("mesh", np.eye(4), "m")
    d.add_mesh_object("mesh", np.asarray(m3.mat_translate([1.5, 0, -1])), "m")
    d.add_sphere(100.0, np.asarray(m3.mat_translate([0, -101.0, -1.0]), np.float64), "ground")
    return d.build(device="cpu")


def _icospheres(subdiv, offsets):
    v, f = icosphere(subdiv)
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_mesh("mesh", v, f)
    for off in offsets:
        d.add_mesh_object("mesh", np.asarray(m3.mat_translate(off)), "m")
    return d.build(device="cpu")


@pytest.fixture(scope="module")
def lex():
    """test_lex_selection.py's scene: two icosphere(3) instances, K >= 96."""
    scene = _icospheres(3, ([0, 0, 0], [1.5, 0.3, -1]))
    assert scene.tre_min.shape[0] >= packets._TWOLEVEL_MIN_K
    return scene


def lex_shadow_rays(window, device, seed=5):
    """test_lex_selection.py's 32 x 32 pixel-centre rays with a t window:
    "fixed", 4.0 on every lane, or "random", per-lane ends from [0.5, 6]
    and a random active mask (test_torch_nee.py's inputs)."""
    cam = make_camera(position=(0.13, 0.071, 3.03), vfov=1.35)
    fx, fy = pixel_centers(32, 32, device=device)
    ro, rd = generate_rays(cam, 32, 32, fx, fy)
    n = fx.shape[0]
    t_min = torch.full((n,), 1e-4, device=device)
    if window == "fixed":
        return ro, rd, t_min, torch.full((n,), 4.0, device=device), torch.ones(
            n, dtype=torch.bool, device=device)
    r = np.random.default_rng(seed)
    t_limit = torch.from_numpy(r.uniform(0.5, 6.0, n).astype(np.float32)).to(device)
    return ro, rd, t_min, t_limit, torch.from_numpy(r.random(n) < 0.8).to(device)


@pytest.fixture(scope="module")
def big():
    """K = 172 treelets: the kernel and the twin run the two-level cull."""
    scene = _icospheres(3, ([0, 0, 0], [1.5, 0.3, -1], [-1.4, -0.2, -0.6]))
    assert scene.tre_min.shape[0] >= packets._TWOLEVEL_MIN_K
    return scene


def super_plane_rays(tre_min, tre_max, centre=(0.1, 0.05, -0.3)):
    """(n, 6) float32 rays (origin, direction) with a zero direction
    component that start exactly on a super-box plane and travel within it
    towards ``centre``: the input where a super-box slab test is NaN (the
    two-level cull's caveat, ``tpupt/accel/packets.py`` _entry_twolevel)."""
    sup_min, sup_max = (b.cpu().numpy() for b in packets._super_boxes(tre_min, tre_max))
    centre = np.asarray(centre)
    rays = []
    for s in range(sup_min.shape[0]):
        for axis in range(3):
            for bound in (sup_min[s, axis], sup_max[s, axis]):
                for sign in (1.0, -1.0):
                    o = centre.copy()
                    o[(axis + 1) % 3] += 3.0 * sign
                    o[axis] = bound
                    d = centre - o
                    d[axis] = 0.0
                    rays.append(np.concatenate([o, d / np.linalg.norm(d)]))
    return np.asarray(rays, np.float32)


def tie_grid_description(instances, n=12, desc_cls=SceneDescription):
    """test_tie_breaking.py's planar n x n grid of unit squares at z = 0, as
    `instances` coplanar copies (16 treelets each at n = 12), for either
    package's SceneDescription."""
    xs, ys = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1).astype(np.float32)
    vid = lambda i, j: i * (n + 1) + j
    tris = []
    for i in range(n):
        for j in range(n):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i, j + 1), vid(i + 1, j + 1)
            tris += [[a, c, b], [b, c, d]]
    desc = desc_cls()
    desc.add_material("m", "lambertian", albedo=(1, 1, 1))
    desc.add_mesh("grid", pos, np.asarray(tris, np.int32))
    for _ in range(instances):
        desc.add_mesh_object("grid", np.eye(4), "m")
    return desc


def tie_grid_scene(instances, n=12, device="cpu"):
    return tie_grid_description(instances, n).build(device=device)


def tie_grid_rays(device="cpu"):
    """Rays straight down onto the tie grid at the centres of a half-unit
    lattice: (ro, rd, t_min, t_seed, active)."""
    g = torch.arange(0.25, 12.0, 0.5, device=device)
    gx, gy = torch.meshgrid(g, g, indexing="ij")
    m = gx.numel()
    full = lambda v: torch.full((m,), v, device=device)
    return (Vec3(gx.reshape(-1), gy.reshape(-1), full(1.0)), Vec3(full(0.0), full(0.0), full(-1.0)),
            full(1e-4), full(3.0e38), torch.ones(m, dtype=torch.bool, device=device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rays(n_side, device, seed=0):
    """Pixel-centre primaries (exact-t ties on shared edges) followed by
    random rays with seeds and dead lanes; not a packet multiple."""
    cam = make_camera(position=(0, 0, 3), vfov=np.pi / 2)
    fx, fy = pixel_centers(n_side, n_side, device=device)
    ro, rd = generate_rays(cam, n_side, n_side, fx, fy)
    r = np.random.default_rng(seed)
    m = 1000
    o = r.uniform(-2.5, 2.5, (m, 3)).astype(np.float32)
    o[:, 2] += 3.0
    d = r.uniform(-1.0, 1.0, (m, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cat = lambda a, b: torch.cat([a, torch.from_numpy(np.ascontiguousarray(b)).to(device)])
    ro = Vec3(*(cat(a, o[:, i]) for i, a in enumerate(ro)))
    rd = Vec3(*(cat(a, d[:, i]) for i, a in enumerate(rd)))
    n = ro.x.shape[0]
    t_min = torch.full((n,), 1e-4, device=device)
    seed_t = np.where(r.random(n) < 0.2, r.uniform(1.0, 4.0, n), 3.0e38).astype(np.float32)
    active = torch.from_numpy(r.random(n) < 0.9).to(device)
    return ro, rd, t_min, torch.from_numpy(seed_t).to(device), active


def test_wrappers_refuse_other_devices(ico):
    meta = ico.to("meta")
    rows = {k: torch.empty((1, 256), device="meta") for k in sweep_kernel._ROW_KEYS}
    act = torch.empty((1, 256), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        sweep_kernel.treelet_closest_hit(
            rows, act, meta.tre_min, meta.tre_max, meta.tre_tris, meta.s_leaf_size
        )
    with pytest.raises(ValueError):
        sweep_kernel.treelet_any_hit(
            rows, act, meta.tre_min, meta.tre_max, meta.tre_tris, meta.s_leaf_size
        )
    with pytest.raises(ValueError):
        step_kernel.winner_step(
            rows, torch.empty((1, 13, 64), device="meta"),
            torch.empty((1, 64), device="meta"),
            torch.empty((1, 64), dtype=torch.int32, device="meta"),
        )


def test_twin_agrees_across_packet_layouts(ico):
    """Packets are independent: the same rays give the same hits whether
    they come alone or behind a batch of other rays."""
    ro, rd, t_min, t_seed, active = _rays(16, "cpu")
    t, slot, ex = packets.intersect_treelets(ico, ro, rd, t_min, t_seed, active)
    k = 256 * 2
    sub = lambda v: Vec3(*(c[k:] for c in v))
    t2, slot2, ex2 = packets.intersect_treelets(
        ico, sub(ro), sub(rd), t_min[k:], t_seed[k:], active[k:]
    )
    assert torch.equal(slot[k:], slot2) and torch.equal(t[k:], t2)
    assert torch.equal(ex["obj"][k:], ex2["obj"])
    assert int((slot >= 0).sum()) > 50


def _kernel_equals_twin(scene, ro, rd, t_min, t_seed, active, diff_payload=False):
    """One kernel launch against the twin on the same rays: every channel
    (6, or 15 with the payload) exactly equal.  Returns the kernel's slots
    and extras."""
    fn = sweep_kernel.treelet_closest_hit
    counter = "payload_launches" if diff_payload else "launches"
    before = getattr(fn, counter)
    tk, sk, ek = packets.intersect_treelets(scene, ro, rd, t_min, t_seed, active,
                                            diff_payload=diff_payload)
    tp, sp, ep = packets.intersect_treelets(
        scene, ro, rd, t_min, t_seed, active,
        closest_hit=sweep_kernel.treelet_closest_hit_plain, diff_payload=diff_payload,
    )
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 1
    assert torch.equal(sk, sp) and torch.equal(tk, tp)
    assert ek.keys() == ep.keys() and len(ek) == (13 if diff_payload else 4)
    for key in ek:
        assert torch.equal(ek[key], ep[key]), key
    return sk, ek


@pytest.mark.cuda
def test_treelet_closest_hit_kernel_equals_twin(ico, cuda_device):
    sk, _ = _kernel_equals_twin(ico.to(cuda_device), *_rays(64, cuda_device))
    assert int((sk >= 0).sum()) > 500


@pytest.mark.cuda
@pytest.mark.parametrize("n_live", [1, 37, 256])
@pytest.mark.parametrize("scene_name", ["ico", "big"])
def test_kernel_equals_twin_by_live_lanes(request, scene_name, n_live, cuda_device):
    """Dense (K < 96) and two-level (K >= 96) culls, with n_live live lanes
    in every packet."""
    scene = request.getfixturevalue(scene_name).to(cuda_device)
    ro, rd, t_min, t_seed, _ = _rays(32, cuda_device)
    n = ro.x.shape[0]
    r = np.random.default_rng(n_live)
    act = np.zeros(n, bool)
    for p0 in range(0, n, 256):
        m = min(256, n - p0)
        act[p0 + r.choice(m, min(n_live, m), replace=False)] = True
    sk, _ = _kernel_equals_twin(scene, ro, rd, t_min, t_seed, torch.from_numpy(act).to(cuda_device))
    assert int((sk >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("diff_payload", [False, True])
@pytest.mark.parametrize("instances", [2, 12, 40])
def test_kernel_equals_twin_on_tie_grid(instances, diff_payload, cuda_device):
    """Coplanar copies of a planar grid tie bit-exactly on every hit; the
    last instance is visited last and wins (K = 32 dense, K = 192 and 640
    two-level; at 640 a packet has more finite entries than the block has
    threads, so the kernel compacts and sorts them in several chunks)."""
    scene = tie_grid_scene(instances, device=cuda_device)
    assert (scene.tre_min.shape[0] >= packets._TWOLEVEL_MIN_K) == (instances >= 12)
    sk, ek = _kernel_equals_twin(scene, *tie_grid_rays(cuda_device), diff_payload=diff_payload)
    assert bool((sk >= 0).all()) and bool((ek["obj"] == instances - 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["ico", "big"])
def test_payload_kernel_equals_twin(request, scene_name, cuda_device):
    """The payload form: all 15 outputs equal to the twin's, the payload a
    copy of the winner's block row, the unit triangle where no triangle
    won."""
    scene = request.getfixturevalue(scene_name).to(cuda_device)
    sk, ek = _kernel_equals_twin(scene, *_rays(48, cuda_device), diff_payload=True)
    hit = sk >= 0
    assert int(hit.sum()) > 200 and not bool(hit.all())
    K, L = scene.tre_tris.shape[0], scene.s_leaf_size
    rows = scene.tre_tris.view(K, 13, L)[sk[hit] // L, :9, sk[hit] % L]
    unit = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    for c, key in enumerate(packets._DIFF_KEYS):
        assert torch.equal(ek[key][hit], rows[:, c]), key
        assert bool((ek[key][~hit] == unit[c]).all()), key


@pytest.mark.cuda
def test_kernel_equals_twin_on_super_plane_rays(big, cuda_device):
    """The two-level cull's NaN caveat, beside ordinary rays in the same
    packets."""
    scene = big.to(cuda_device)
    rays = torch.from_numpy(super_plane_rays(big.tre_min, big.tre_max)).to(cuda_device)
    ro, rd, t_min, t_seed, active = _rays(16, cuda_device)
    cat = lambda a, b: torch.cat([b, a])
    ro = Vec3(*(cat(a, rays[:, i]) for i, a in enumerate(ro)))
    rd = Vec3(*(cat(a, rays[:, 3 + i]) for i, a in enumerate(rd)))
    k = rays.shape[0]
    on = torch.ones(k, dtype=torch.bool, device=cuda_device)
    sk, _ = _kernel_equals_twin(scene, ro, rd, cat(t_min, t_min[:k]), cat(t_seed, t_seed[:k]),
                                cat(active, on))
    assert int((sk[:k] >= 0).sum()) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["fixed", "random"])
def test_treelet_any_hit_kernel_equals_twin(lex, window, cuda_device):
    """The any-hit mode against its twin on the lex scene's rays, the
    two-level cull included: every lane's occlusion equal."""
    scene = lex.to(cuda_device)
    ro, rd, t_min, t_limit, active = lex_shadow_rays(window, cuda_device)
    before = sweep_kernel.treelet_any_hit.launches
    occ_k = packets.intersect_treelets_anyhit(scene, ro, rd, t_min, t_limit, active)
    occ_p = packets.intersect_treelets_anyhit(scene, ro, rd, t_min, t_limit, active,
                                              any_hit=sweep_kernel.treelet_any_hit_plain)
    torch.cuda.synchronize()
    assert sweep_kernel.treelet_any_hit.launches == before + 1
    assert occ_k.dtype == torch.bool and torch.equal(occ_k, occ_p)
    assert 0 < int(occ_k.sum()) < int(active.sum()) and not bool(occ_k[~active].any())


@pytest.fixture(scope="module")
def grid640():
    """The tie grid at 40 instances: K = 640 > 512, where every packet
    takes the any-hit block route."""
    return tie_grid_scene(40)


# live lanes per packet, by packet (cycled): the any-hit kernels' routes
# (<= 32 live lanes: one warp; more: a CTA), the ray-to-thread ways (8 at
# <= 4 rays a warp or <= 32 a CTA, ..., 1) and one call mixing them
ANY_HIT_LIVE = {
    "0": (0,), "1": (1,), "2": (2,), "5": (5,), "13": (13,), "32": (32,), "33": (33,),
    "64": (64,), "65": (65,), "129": (129,), "256": (256,), "mixed": (0, 13, 200, 32, 33, 1),
}


def _any_hit_inputs(scene_name, live, device):
    """Shadow-ray inputs on a scene with per-packet live counts ``live``:
    the tie grid's vertical rays with window ends in [0.5, 1.5] around
    the plane at t = 1; elsewhere _rays(32) with ends in [0.5, 6]."""
    if scene_name == "grid640":
        ro, rd, t_min, _, _ = tie_grid_rays(device)
        lo, hi = 0.5, 1.5
    else:
        ro, rd, t_min, _, _ = _rays(32, device)
        lo, hi = 0.5, 6.0
    n = ro.x.shape[0]
    r = np.random.default_rng(sum(live))
    t_limit = torch.from_numpy(r.uniform(lo, hi, n).astype(np.float32)).to(device)
    act = np.zeros(n, bool)
    for i, p0 in enumerate(range(0, n, 256)):
        m = min(256, n - p0)
        act[p0 + r.choice(m, min(live[i % len(live)], m), replace=False)] = True
    return ro, rd, t_min, t_limit, torch.from_numpy(act).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("live", list(ANY_HIT_LIVE))
@pytest.mark.parametrize("scene_name", ["ico", "big", "grid640"])
def test_any_hit_kernel_equals_twin_by_live_lanes(request, scene_name, live, cuda_device):
    """The walk kernel alone (K < 96), the warp route and the block route
    (96 <= K <= 512) and the block route alone (K = 640), at every live count where
    the route or the threads a ray takes change: every lane's occlusion
    equal to the twin's, one call counted."""
    scene = request.getfixturevalue(scene_name).to(cuda_device)
    ro, rd, t_min, t_limit, active = _any_hit_inputs(scene_name, ANY_HIT_LIVE[live], cuda_device)
    before = sweep_kernel.treelet_any_hit.launches
    occ_k = packets.intersect_treelets_anyhit(scene, ro, rd, t_min, t_limit, active)
    occ_p = packets.intersect_treelets_anyhit(scene, ro, rd, t_min, t_limit, active,
                                              any_hit=sweep_kernel.treelet_any_hit_plain)
    torch.cuda.synchronize()
    assert sweep_kernel.treelet_any_hit.launches == before + 1
    assert occ_k.dtype == torch.bool and torch.equal(occ_k, occ_p)
    assert not bool(occ_k[~active].any())
    if int(active.sum()) >= 100:
        assert 0 < int(occ_k.sum()) < int(active.sum())


@pytest.mark.cuda
def test_nee_render_kernel_equals_twin(cuda_device):
    """A mesh, an emissive quad and a sphere lamp: the forward render
    through both kernels equals the render through both twins."""
    v, f = icosphere(2)
    d = SceneDescription(bg_down=(0, 0, 0), bg_up=(0, 0, 0))
    d.add_material("m", "lambertian", albedo=(0.7, 0.7, 0.7))
    d.add_material("qlamp", "diffuse_light", emit=(8.0, 6.0, 4.0))
    d.add_material("slamp", "diffuse_light", emit=(4.0, 4.0, 8.0))
    d.add_sphere(100.0, np.asarray(m3.mat_translate([0, -101.0, -1.0])), "m")
    d.add_mesh("mesh", v, f)
    d.add_mesh_object("mesh", np.asarray(m3.mat_translate([0, 0, -1.5])), "m")
    quad = np.array([[-0.5, 1.2, -1.0], [0.5, 1.2, -1.0], [0.5, 1.2, -2.0], [-0.5, 1.2, -2.0]],
                    np.float32)
    d.add_mesh("quad", quad, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    d.add_mesh_object("quad", np.eye(4), "qlamp")
    d.add_sphere(0.2, np.asarray(m3.mat_translate([1.2, 0.6, -1.5])), "slamp")
    scene = d.build(device=cuda_device)
    cam = make_camera(position=(0, 0, 1.5), vfov=np.pi / 2)
    kw = dict(spp=2, max_bounces=4, rr_start=2)
    twin = functools.partial(
        intersect_scene_ids, closest_hit=sweep_kernel.treelet_closest_hit_plain
    )
    before = sweep_kernel.treelet_any_hit.launches
    bk, rk = render_image(scene, cam, 48, 40, **kw)
    launched = sweep_kernel.treelet_any_hit.launches - before
    bp, rp = render_image(scene, cam, 48, 40, intersect_fn=twin,
                          any_hit=sweep_kernel.treelet_any_hit_plain, **kw)
    assert launched > 0 and sweep_kernel.treelet_any_hit.launches - before == launched
    assert int(rk) == int(rp) > 48 * 40 * 2
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(bk, key), getattr(bp, key)), key
    assert float(bk.color.max()) > 0.05


@pytest.mark.cuda
def test_winner_step_kernel_equals_twin(ico, cuda_device):
    r = np.random.default_rng(1)
    sz, p, rl = 64, 256, 64
    K = ico.tre_min.shape[0]
    o = r.uniform(-2, 2, (sz, p, 3)).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    dev = cuda_device
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    rows = dict(rox=f(o[..., 0]), roy=f(o[..., 1]), roz=f(o[..., 2]),
                rdx=f(d[..., 0]), rdy=f(d[..., 1]), rdz=f(d[..., 2]),
                tmin=f(np.full((sz, p), 1e-3)),
                t=f(np.where(r.random((sz, p)) < 0.3, 2.0, 3.0e38)))
    tids = r.integers(0, K, (sz, rl // 32))
    blocks = ico.tre_tris.view(K, 13, 32)[torch.from_numpy(tids)]  # (sz, R, 13, 32)
    comps = blocks.permute(0, 2, 1, 3).reshape(sz, 13, rl).contiguous().to(dev)
    slots = torch.from_numpy((tids[:, :, None] * 32 + np.arange(32)).reshape(sz, rl)).int().to(dev)
    live = f(r.random((sz, rl)) < 0.9)
    before = step_kernel.winner_step.launches
    out_k = step_kernel.winner_step(rows, comps, live, slots)
    out_p = step_kernel.winner_step_plain(rows, comps, live, slots)
    torch.cuda.synchronize()
    assert step_kernel.winner_step.launches == before + 1
    for a, b in zip(out_k, out_p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((out_k[0] < 3.0e38).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("sz,p,rl,offset", [
    (3, 256, 61, 0),    # rl not a multiple of 4, fewer rows than the grid holds
    (5, 100, 7, 0),     # a row narrower than a CTA's threads
    (2, 1024, 36, 0),   # four passes of a CTA over a row
    (1, 300, 1, 0),     # one pair
    (700, 64, 32, 0),   # more rows than CTAs: every CTA strides, both stages
    (4, 256, 64, 1),    # rl % 4 == 0 but comps not 16-byte aligned: scalar copies
])
def test_winner_step_kernel_equals_twin_shapes(ico, sz, p, rl, offset, cuda_device):
    """winner_step at shapes off its float4 path and off a full grid: all
    six outputs equal to the twin's, earliest pair winning exact-t ties
    (each row repeats its first pairs at its end)."""
    r = np.random.default_rng(sz * 1000 + rl)
    K, L = ico.tre_min.shape[0], 32
    o = r.uniform(-2, 2, (sz, p, 3)).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    dev = cuda_device
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    rows = dict(rox=f(o[..., 0]), roy=f(o[..., 1]), roz=f(o[..., 2]),
                rdx=f(d[..., 0]), rdy=f(d[..., 1]), rdz=f(d[..., 2]),
                tmin=f(np.full((sz, p), 1e-3)),
                t=f(np.where(r.random((sz, p)) < 0.3, 2.0, 3.0e38)))
    slot_ids = r.integers(0, K * L, (sz, rl))
    slot_ids[:, rl - min(rl, 4) // 2:] = slot_ids[:, :min(rl, 4) // 2]  # duplicates: exact ties
    blocks = ico.tre_tris.view(K, 13, L)
    comps = blocks[torch.from_numpy(slot_ids // L), :, torch.from_numpy(slot_ids % L)]
    comps = comps.permute(0, 2, 1)  # (sz, 13, rl)
    flat = torch.empty(comps.numel() + offset, device=dev)
    comps_d = flat[offset:].view(sz, 13, rl)
    comps_d.copy_(comps)
    slots = torch.from_numpy(slot_ids).int().to(dev)
    live = f(r.random((sz, rl)) < 0.9)
    before = step_kernel.winner_step.launches
    out_k = step_kernel.winner_step(rows, comps_d, live, slots)
    out_p = step_kernel.winner_step_plain(rows, comps_d, live, slots)
    torch.cuda.synchronize()
    assert step_kernel.winner_step.launches == before + 1
    for a, b in zip(out_k, out_p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if rl >= 32:
        assert int((out_k[0] < 3.0e38).sum()) > 0


@pytest.mark.cuda
def test_fast_reciprocal_equals_division_on_every_float(cuda_device):
    """The any-hit walk's and winner_step's reciprocal (one Newton step
    from the hardware's approximation, the division where it declines)
    against `1.0f / a` on all 2^32 float bit patterns: equal wherever it
    is used, so those kernels stay bit-equal to their twins."""
    lib = kernels.load()
    by_exp = torch.zeros(257, dtype=torch.int64, device=cuda_device)
    kernels.check(lib, lib.tpupt_rcp_check(by_exp.data_ptr(), kernels.stream_of(by_exp)),
                  "rcp_check")
    assert int(by_exp[256]) == 0, by_exp.nonzero().flatten().tolist()


@pytest.mark.cuda
def test_kernel_refuses_bad_layout(ico, cuda_device):
    scene = ico.to(cuda_device)
    rows = {k: torch.zeros((2, 512), device=cuda_device)[:, ::2] for k in sweep_kernel._ROW_KEYS}
    act = torch.ones((2, 256), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        sweep_kernel.treelet_closest_hit(
            rows, act, scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size
        )


@pytest.mark.cuda
def test_diff_render_kernel_equals_twin(ico, cuda_device):
    """The differentiable render through the payload kernel against the
    twin: equal ray counts, the loss and every gradient at rtol 1e-5
    (index_add_ adds each slot's cotangents with atomics, in an order that
    changes from run to run)."""
    scene = ico.to(cuda_device)
    cam = make_camera(position=(0, 0, 3), vfov=np.pi / 2)
    twin = functools.partial(
        intersect_scene_ids_diff, closest_hit=sweep_kernel.treelet_closest_hit_plain
    )
    out = []
    for fn in (None, twin):
        params = extract_params(scene)
        before = sweep_kernel.treelet_closest_hit.payload_launches
        buf, rays = render_image(with_params(scene, params), cam, 48, 40, spp=1, max_bounces=4,
                                 differentiable=True, intersect_fn=fn)
        launched = sweep_kernel.treelet_closest_hit.payload_launches - before
        loss = (buf.color ** 2).sum()
        leaves = [params[k] for k in PARAM_LEAVES] + list(params["materials"].values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        out.append((int(rays), loss.detach(), grads, launched))
    (rk, lk, gk, nk), (rp, lp, gp, np_) = out
    assert nk > 0 and np_ == 0
    assert rk == rp > 48 * 40
    assert torch.allclose(lk, lp, rtol=1e-5)
    for a, b in zip(gk, gp):
        assert bool(torch.isfinite(a).all())
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_render_kernel_equals_twin(ico, cuda_device):
    scene = ico.to(cuda_device)
    cam = make_camera(position=(0, 0, 3), vfov=np.pi / 2)
    kw = dict(spp=2, max_bounces=8, rr_start=2)
    twin = functools.partial(
        intersect_scene_ids, closest_hit=sweep_kernel.treelet_closest_hit_plain
    )
    bk, rk = render_image(scene, cam, 48, 40, **kw)
    bp, rp = render_image(scene, cam, 48, 40, intersect_fn=twin, **kw)
    assert int(rk) == int(rp) > 48 * 40 * 2
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(bk, key), getattr(bp, key)), key


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["ico", "big"])
def test_wavefront_kernels_equal_megakernel(request, scene_name, cuda_device):
    """Streaming equals the megakernel bit for bit with the kernels, and
    the sweep on each compacted wavefront bounce (live lanes at the front,
    the tail inactive padding) equals its twin."""
    from tpupt_torch.render.integrator import trace_sample
    from tpupt_torch.render.wavefront import trace_sample_wavefront

    scene = request.getfixturevalue(scene_name).to(cuda_device)
    cam = make_camera(position=(0, 0, 3), vfov=np.pi / 2)
    seen = []

    def checked(*args, **kw):
        got = sweep_kernel.treelet_closest_hit(*args, **kw)
        for a, b in zip(got, sweep_kernel.treelet_closest_hit_plain(*args, **kw)):
            assert torch.equal(a, b)
        seen.append(int(args[1].sum()))
        return got

    hit = functools.partial(intersect_scene_ids, closest_hit=checked)
    kw = dict(max_bounces=8, rr_start=2)
    a = trace_sample(scene, cam, 64, 48, 3, **kw)
    b = trace_sample_wavefront(scene, cam, 64, 48, 3, intersect_fn=hit, **kw)
    assert int(a[3]) == int(b[3]) == sum(seen) and seen[-1] < 64 * 48
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


# --- the differentiable trip: diff_trip_fwd, diff_trip_bwd, slot_scatter ----

def _diff_scene(device):
    """Spheres of the four materials and two icosphere meshes, one metal,
    one glass (scaled down): every lobe and both refine branches."""
    v, f = icosphere(2)
    d = SceneDescription()
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.0))
    d.add_material("blue", "lambertian", albedo=(0.1, 0.2, 0.5))
    d.add_material("glass", "dielectric", refraction_index=1.5)
    d.add_material("metal", "metal", albedo=(0.8, 0.6, 0.2), fuzz=0.3)
    t = lambda off: np.asarray(m3.mat_translate(off), np.float64)  # noqa: E731
    d.add_sphere(100.0, t([0, -100.5, -1.0]), "ground")
    d.add_sphere(0.5, t([0, 0, -1.0]), "blue")
    d.add_sphere(0.5, t([-1, 0, -1.0]), "glass")
    d.add_sphere(0.5, t([1, 0, -1.0]), "metal")
    d.add_mesh("ico", v, f)
    d.add_mesh_object("ico", t([0.3, 0.6, -1.5]), "metal")
    d.add_mesh_object("ico", t([-0.4, 0.5, -0.6]) @ np.diag([0.3, 0.3, 0.3, 1.0]), "glass")
    return d.build(device="cpu").to(device), make_camera(vfov=np.pi / 2)


def _diff_step(scene, cam, fn=None, rr_start=None):
    params = extract_params(scene)
    buf, rays = render_image(with_params(scene, params), cam, 48, 40, spp=2, max_bounces=4,
                             differentiable=True, intersect_fn=fn, rr_start=rr_start)
    loss = (buf.color ** 2).sum() + 0.1 * buf.normal.sum() + 0.01 * buf.depth.clamp(max=20).sum()
    leaves = [params[k] for k in PARAM_LEAVES] + list(params["materials"].values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return buf, int(rays), grads


@pytest.mark.cuda
@pytest.mark.parametrize("rr_start", [None, 1])
def test_diff_trip_route_equals_body_route_on_card(cuda_device, rr_start):
    """The differentiable trip's kernels against the body route on the same
    hit pass: the forward bit-equal, every gradient at rtol 1e-5 (atomic
    sums in no fixed order, the backward's in another order than
    autograd's); the diff kernels launch, one diff_trip_bwd a bounce, which
    scatters the slot table's gradient itself: no slot_scatter, no
    trip_tail."""
    from tpupt_torch.render import diff_trip, trip_kernel

    scene, cam = _diff_scene(cuda_device)
    before = dict(diff_trip.launch_counts(), **trip_kernel.launch_counts())
    bk, rk, gk = _diff_step(scene, cam, rr_start=rr_start)
    after = dict(diff_trip.launch_counts(), **trip_kernel.launch_counts())
    bp, rp, gp = _diff_step(scene, cam, functools.partial(intersect_scene_ids_diff), rr_start)
    torch.cuda.synchronize()
    moved = {k: after[k] - before[k] for k in after}
    assert moved["diff_trip_fwd"] > 0 and moved["diff_trip_bwd"] == moved["diff_trip_fwd"], moved
    assert moved["slot_scatter"] == 0 and moved["trip_tail"] == 0, moved
    assert rk == rp > 48 * 40 * 2
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(bk, key), getattr(bp, key)), key
    for a, b in zip(gk, gp):
        assert bool(torch.isfinite(a).all())
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("rr_start", [None, 1])
def test_diff_trip_route_equals_body_route_nine_spheres(cuda_device, rr_start):
    """tests/test_torch_trip.py's nine spheres (an exact-t tie, a
    radius-1000 ground, no mesh) on the differentiable trip against the
    body route: the forward bit-equal, every gradient within 1e-5 of its
    leaf's max |grad| (rtol 1e-5)."""
    from test_torch_trip import nine_spheres
    from tpupt_torch.render import diff_trip

    scene, cam = nine_spheres(device=cuda_device)
    before = diff_trip.launch_counts()["diff_trip_fwd"]
    bk, rk, gk = _diff_step(scene, cam, rr_start=rr_start)
    assert diff_trip.launch_counts()["diff_trip_fwd"] > before
    bp, rp, gp = _diff_step(scene, cam, functools.partial(intersect_scene_ids_diff), rr_start)
    torch.cuda.synchronize()
    assert rk == rp > 48 * 40 * 2
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(bk, key), getattr(bp, key)), key
    for a, b in zip(gk, gp):
        assert bool(torch.isfinite(a).all())
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense, bounce 0", "sparse, bounce 2", "all dead"])
@pytest.mark.parametrize("name", ["nine_spheres", "spheres_mesh"])
def test_diff_trip_fwd_equals_twin_on_states(cuda_device, name, case):
    """diff_trip_fwd against its twin on every output (the lane state, the
    residuals it writes and the 7s it leaves, the lanes left): every lane,
    one in 41 or none alive, at 23 x 7 lanes, which fill no chunk, no
    four-lane load and no packet (the sweep's pad lanes), on nine spheres
    with an exact-t tie and on spheres beside a mesh."""
    from test_torch_trip import diff_inputs, fwd_run
    from tpupt_torch.render import diff_trip

    state, bounce = {"dense, bounce 0": ("dense", 0), "sparse, bounce 2": ("sparse", 2),
                     "all dead": ("all_dead", 2)}[case]
    args = diff_inputs(name, state, bounce, device=cuda_device)
    before = diff_trip.launch_counts()["diff_trip_fwd"]
    got = fwd_run(diff_trip.diff_trip_fwd, *args, bounce)
    want = fwd_run(diff_trip.diff_trip_fwd_plain, *args, bounce)
    torch.cuda.synchronize()
    assert diff_trip.launch_counts()["diff_trip_fwd"] == before + 1
    for label, a, b in zip(("F", "I", "res_f", "res_i", "count"), got, want):
        assert torch.equal(a, b), label


@pytest.mark.cuda
def test_diff_trip_kernels_equal_twins(cuda_device, monkeypatch):
    """diff_trip_fwd and diff_trip_bwd against their twins on every bounce
    of a render: the forward's state, residuals and count exact; the
    backward's cotangent rows, per-leaf gradients and the slot table's
    gradient at rtol 1e-5 with a floor of 1e-5 x the row's, leaf's or
    column's max."""
    from tpupt_torch.render import diff_trip, trip_kernel as tk

    scene, cam = _diff_scene(cuda_device)
    fwd, bwd, seen = diff_trip.diff_trip_fwd, diff_trip.diff_trip_bwd, {"fwd": [], "bwd": []}

    def rec_fwd(dp, F, I, buf, sweep, b, res=None):
        seen["fwd"].append((dp, F.clone(), I.clone(), buf.hint.clone(),
                            None if sweep is None else tuple(o.clone() for o in sweep), b))
        return fwd(dp, F, I, buf, sweep, b, res)

    def rec_bwd(dp, G, res, seed, b, gtab, g_slot=None):
        seen["bwd"].append((dp, G.clone(), res, seed, b))
        return bwd(dp, G, res, seed, b, gtab, g_slot)

    monkeypatch.setattr(diff_trip, "diff_trip_fwd", rec_fwd)
    monkeypatch.setattr(diff_trip, "diff_trip_bwd", rec_bwd)
    _diff_step(scene, cam, rr_start=1)
    assert len(seen["fwd"]) >= 3 and len(seen["bwd"]) == len(seen["fwd"])
    for dp, F, I, hint, sweep, b in seen["fwd"]:
        outs = []
        for run in (fwd, diff_trip.diff_trip_fwd_plain):
            Fx, Ix, buf = F.clone(), I.clone(), tk.trip_buffers(dp.trip)
            buf.hint.copy_(hint)
            res = diff_trip.residuals(dp.trip.n, cuda_device)
            res.f.zero_()
            run(dp, Fx, Ix, buf, sweep, b, res)
            outs.append((Fx, Ix, res, int(buf.count)))
        (Fk, Ik, rk, ck), (Fp, Ip, rp, cp) = outs
        assert torch.equal(Fk, Fp) and torch.equal(Ik, Ip) and ck == cp, b
        assert torch.equal(rk.i, rp.i), b
        assert torch.equal(rk.f, rp.f), b
    for dp, G, res, seed, b in seen["bwd"]:
        outs = []
        for run in (bwd, diff_trip.diff_trip_bwd_plain):
            Gx, gtab = G.clone(), diff_trip.leaf_table_zeros(dp.trip)
            g_slot = torch.zeros_like(dp.table)
            run(dp, Gx, res, seed, b, gtab, g_slot)
            outs.append((Gx, diff_trip.split_leaf_table(dp.trip, gtab), g_slot))
        (Gk, lk, sk), (Gp, lp, sp) = outs
        for a, c in [*zip(Gk, Gp), *((lk[k], lp[k]) for k in lp), *zip(sk.t(), sp.t())]:
            assert torch.allclose(a, c, rtol=1e-5, atol=1e-5 * float(c.abs().max())), b


@pytest.mark.cuda
@pytest.mark.parametrize("live", ["no lane", "one warp across a chunk's end"])
def test_diff_trip_bwd_on_dead_and_ragged_bounces(cuda_device, monkeypatch, live):
    """diff_trip_bwd against its twin where its queues are empty or ragged:
    bounce 0 of a 95 x 81 render (7,695 lanes: four chunks of the kernel's
    2,048, the last cut short at a lane count that is not a multiple of 4)
    with every lane dead, or with only the 32 lanes across the first
    chunk's end live.  G, each leaf and the slot table's gradient at rtol
    1e-5 (floor 1e-5 x the max), the dead lanes' G untouched, and with no
    lane live no gradient at all."""
    from tpupt_torch.render import diff_trip

    scene, cam = _diff_scene(cuda_device)
    seen, bwd = [], diff_trip.diff_trip_bwd

    def rec_bwd(dp, G, res, seed, b, gtab, g_slot=None):
        if b == 0 and not seen:
            seen.append((dp, G.clone(), res, seed))
        return bwd(dp, G, res, seed, b, gtab, g_slot)

    monkeypatch.setattr(diff_trip, "diff_trip_bwd", rec_bwd)
    params = extract_params(scene)
    buf, _ = render_image(with_params(scene, params), cam, 95, 81, spp=1, max_bounces=2,
                          differentiable=True)
    torch.autograd.grad((buf.color ** 2).sum() + 0.1 * buf.normal.sum(), [params["positions"]])
    dp, G, res, seed = seen[0]
    assert dp.trip.n == 95 * 81
    keep = torch.zeros(dp.trip.n, dtype=torch.bool, device=cuda_device)
    if live != "no lane":
        keep[2048 - 16:2048 + 16] = True
    res = diff_trip.Residuals(res.f, torch.stack([
        torch.where(keep, res.i[0], diff_trip.DEAD), torch.where(keep, res.i[1], -1)]).contiguous())
    outs = []
    for run in (bwd, diff_trip.diff_trip_bwd_plain):
        Gx, gtab, g_slot = G.clone(), diff_trip.leaf_table_zeros(dp.trip), torch.zeros_like(dp.table)
        run(dp, Gx, res, seed, 0, gtab, g_slot)
        outs.append((Gx, gtab, diff_trip.split_leaf_table(dp.trip, gtab), g_slot))
    torch.cuda.synchronize()
    (Gk, tk_, lk, sk), (Gp, _, lp, sp) = outs
    assert torch.equal(Gk[:, ~keep], G[:, ~keep])
    for a, c in [*zip(Gk, Gp), *((lk[k], lp[k]) for k in lp), *zip(sk.t(), sp.t())]:
        assert torch.allclose(a, c, rtol=1e-5, atol=1e-5 * float(c.abs().max()))
    if live == "no lane":
        assert torch.equal(Gk, G) and not tk_.any() and not sk.any()
    else:
        assert not torch.equal(Gk[:, keep], G[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("slots", ["every slot -1", "every lane on one row"])
def test_slot_scatter_kernel_on_empty_and_one_row(cuda_device, slots):
    """slot_scatter where no lane has a row, and where every lane has the
    same one (each warp's 32 lanes matched into one group, 5,003 lanes'
    rows in one row's atomics): equal to index_add_ of the rows with slot
    >= 0.  The rows are small integers, so every order of the sums is
    exact."""
    from tpupt_torch.accel.slot_scatter import slot_scatter

    r = np.random.default_rng(7)
    n, rows = 5003, 300
    slot = torch.full((n,), -1 if slots == "every slot -1" else 123, dtype=torch.int32,
                      device=cuda_device)
    cot = torch.from_numpy(r.integers(-8, 9, (n, 9)).astype(np.float32)).to(cuda_device)
    before = slot_scatter.launches
    got = slot_scatter(torch.zeros((rows, 9), device=cuda_device), slot, cot)
    keep = slot >= 0
    want = torch.zeros((rows, 9), device=cuda_device).index_add_(0, slot[keep].long(), cot[keep])
    torch.cuda.synchronize()
    assert slot_scatter.launches == before + 1
    assert torch.equal(got, want)
    assert bool(got.any()) == (slots != "every slot -1")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["(N, 9)", "(9, N) transposed"])
def test_slot_scatter_kernel_equals_index_add(cuda_device, layout):
    """slot_scatter against index_add_ of the rows with slot >= 0: runs of
    equal slots in a warp, slot -1 lanes with nonzero cotangents (which
    add nothing), both layouts; at rtol 1e-6 (atomic order)."""
    from tpupt_torch.accel.slot_scatter import slot_scatter

    r = np.random.default_rng(5)
    n, rows = 5000, 300
    slot = r.integers(0, rows, n)
    slot[r.random(n) < 0.5] = -1
    slot[1000:1100] = 7  # whole warps on one row
    slot = torch.from_numpy(slot).to(cuda_device)
    cot = torch.from_numpy(r.standard_normal((n, 9)).astype(np.float32)).to(cuda_device)
    if layout != "(N, 9)":
        cot = cot.t().contiguous().t()
    before = slot_scatter.launches
    got = slot_scatter(torch.zeros((rows, 9), device=cuda_device), slot, cot)
    keep = slot >= 0
    want = torch.zeros((rows, 9), device=cuda_device).index_add_(0, slot[keep], cot[keep])
    torch.cuda.synchronize()
    assert slot_scatter.launches == before + 1
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


SLOT_PAST_END = """
import torch
from tpupt_torch.accel.slot_scatter import slot_scatter
g = torch.zeros((300, 9), device="cuda")
slot = torch.tensor([3, -1, 300, 5], device="cuda")
slot_scatter(g, slot, torch.ones((4, 9), device="cuda"))
torch.cuda.synchronize()
"""


@pytest.mark.cuda
def test_slot_scatter_kernel_fails_on_a_slot_past_the_table(cuda_device):
    """A slot past the table's end is an error, as index_add_'s: the
    kernel's assert fails the launch (in a process of its own, since the
    failure ends its CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", SLOT_PAST_END], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode != 0 and "assert" in (run.stdout + run.stderr), run.stderr[-2000:]


BWD_SLOT_PAST_END = """
import sys
import torch
sys.path.insert(0, "tests")
import test_torch_kernels as t
from tpupt_torch.render import diff_trip
seen, bwd = [], diff_trip.diff_trip_bwd
def rec_bwd(dp, G, res, seed, b, gtab, g_slot=None):
    if b == 0 and not seen:
        seen.append((dp, G.clone(), res, seed))
    return bwd(dp, G, res, seed, b, gtab, g_slot)
diff_trip.diff_trip_bwd = rec_bwd
t._diff_step(*t._diff_scene(torch.device("cuda")))
dp, G, res, seed = seen[0]
code = res.i[0]
i = int(((code >= 0) & (code % 2 == 1)).nonzero()[0])
res.i[1, i] = dp.table.shape[0]
bwd(dp, G, res, seed, 0, diff_trip.leaf_table_zeros(dp.trip), torch.zeros_like(dp.table))
torch.cuda.synchronize()
"""


@pytest.mark.cuda
def test_diff_trip_bwd_kernel_fails_on_a_slot_past_the_table(cuda_device):
    """diff_trip_bwd on bounce 0 of a render with one triangle lane's slot
    moved past the slot table's end: the kernel's assert fails the launch,
    as slot_scatter's does (in a process of its own, since the failure ends
    its CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", BWD_SLOT_PAST_END], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode != 0 and "device-side assert" in (run.stdout + run.stderr), \
        run.stderr[-2000:]
