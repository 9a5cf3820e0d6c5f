"""The PyTorch port's CUDA kernels against their torch twins.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX).  Kernel and twin round
every float32 operation once and in the same order (the kernels are
built with --fmad=false), so every comparison here is exact.  The tests
marked ``cuda`` skip where torch sees no card.
"""

import functools

import numpy as np
import pytest
import torch

from tpupt_torch.accel import packets, step_kernel, sweep_kernel
from tpupt_torch.core import math3d as m3
from tpupt_torch.core.camera import generate_rays, make_camera, pixel_centers
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.integrator import render_image
from tpupt_torch.render.intersect import intersect_scene_ids
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


@pytest.mark.cuda
def test_treelet_closest_hit_kernel_equals_twin(ico, cuda_device):
    scene = ico.to(cuda_device)
    ro, rd, t_min, t_seed, active = _rays(64, cuda_device)
    before = sweep_kernel.treelet_closest_hit.launches
    tk, sk, ek = packets.intersect_treelets(scene, ro, rd, t_min, t_seed, active)
    tp, sp, ep = packets.intersect_treelets(
        scene, ro, rd, t_min, t_seed, active,
        closest_hit=sweep_kernel.treelet_closest_hit_plain,
    )
    torch.cuda.synchronize()
    assert sweep_kernel.treelet_closest_hit.launches == before + 1
    assert torch.equal(sk, sp) and torch.equal(tk, tp)
    for key in ("nx", "ny", "nz", "obj"):
        assert torch.equal(ek[key], ep[key]), key
    assert int((sk >= 0).sum()) > 500


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
def test_kernel_refuses_bad_layout(ico, cuda_device):
    scene = ico.to(cuda_device)
    rows = {k: torch.zeros((2, 512), device=cuda_device)[:, ::2] for k in sweep_kernel._ROW_KEYS}
    act = torch.ones((2, 256), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        sweep_kernel.treelet_closest_hit(
            rows, act, scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size
        )


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
