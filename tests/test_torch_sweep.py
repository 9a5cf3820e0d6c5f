"""Closest-hit treelet sweep of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their torch twins; they are held to
``tpupt.accel.packets.intersect_treelets`` (the reference the Pallas
kernels are held to in test_pallas_sweep.py / test_pallas_step.py) on the
same inputs.  Winner identity (slot, object, hit mask, the winner's
normal) must be exact, t within rtol 1e-6 (test_pallas_sweep.py's
tolerance).  The JAX reference runs under ``jax.disable_jit()``: compiled,
XLA's CPU backend contracts multiply-adds of the fused MT into FMAs, which
moved one grazing t of the pixel grid by 1.5e-6 relative; op by op every
operation rounds once, as in the port, and t comes out equal.

The CUDA kernels are held to these twins on the card by
test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.core.math3d as jm3
from tpupt.accel.packets import BIG as JBIG
from tpupt.accel.packets import _comp, _dense_mt, _winner_reduce
from tpupt.accel.packets import intersect_treelets as jax_intersect_treelets
from tpupt.core.camera import generate_rays as jax_generate_rays
from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.core.vec import Vec3 as JVec3
from tpupt.scene.description import SceneDescription as JaxDescription
from tpupt.scene.procedural import icosphere

from test_torch_scene import port_scene
from tpupt_torch.accel import packets, step_kernel
from tpupt_torch.core.vec import Vec3
from tpupt_torch.scene.description import SceneDescription

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)


def _ico_scene():
    """test_pallas_sweep.py's scene: two icosphere(2) instances."""
    v, f = icosphere(2)
    d = JaxDescription()
    d.add_material("m", "lambertian", albedo=(1, 1, 1))
    d.add_mesh("mesh", v, f)
    d.add_mesh_object("mesh", np.eye(4), "m")
    d.add_mesh_object("mesh", np.asarray(jm3.mat_translate([1.5, 0, -1])), "m")
    return d.build()


def _grid_rays(w=32, h=32):
    """Unjittered pixel-centre primaries (shared-edge exact-t ties)."""
    cam = jax_make_camera(position=(0, 0, 3), vfov=np.pi / 2)
    idx = jnp.arange(w * h, dtype=jnp.float32)
    ro, rd = jax_generate_rays(cam, w, h, idx % w + 0.5, idx // w + 0.5)
    return [np.asarray(c) for c in (*ro, *rd)]


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _port_treelets(pscene, comps, t_min, t_seed, active, device="cpu", **kw):
    ro = Vec3(*[_t(c, device) for c in comps[:3]])
    rd = Vec3(*[_t(c, device) for c in comps[3:]])
    return packets.intersect_treelets(
        pscene, ro, rd, _t(t_min, device), _t(t_seed, device), _t(active, device), **kw
    )


def _jax_treelets(jscene, comps, t_min, t_seed, active):
    with jax.disable_jit():
        return jax_intersect_treelets(
            jscene, JVec3(*map(jnp.asarray, comps[:3])), JVec3(*map(jnp.asarray, comps[3:])),
            jnp.asarray(t_min), jnp.asarray(t_seed), jnp.asarray(active),
        )


@pytest.fixture(scope="module")
def ico():
    jscene = _ico_scene()
    return jscene, port_scene(jscene)


def _check_against_jax(jout, pout):
    t_j, slot_j, ex_j = (np.asarray(x) if not isinstance(x, dict) else x for x in jout)
    t_p, slot_p, ex_p = pout
    slot_p = slot_p.cpu().numpy()
    hit = slot_j >= 0
    np.testing.assert_array_equal(slot_p >= 0, hit)
    np.testing.assert_array_equal(slot_p, slot_j)
    for k in ("nx", "ny", "nz", "obj"):
        np.testing.assert_array_equal(ex_p[k].cpu().numpy()[hit], np.asarray(ex_j[k])[hit], err_msg=k)
    np.testing.assert_allclose(t_p.cpu().numpy()[hit], t_j[hit], rtol=1e-6)
    return hit


def test_intersect_treelets_matches_jax_on_pixel_grid(ico):
    jscene, pscene = ico
    comps = _grid_rays()
    n = comps[0].shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    t_seed = np.full(n, 3.0e38, np.float32)
    active = np.ones(n, bool)
    jout = _jax_treelets(jscene, comps, t_min, t_seed, active)
    hit = _check_against_jax(jout, _port_treelets(pscene, comps, t_min, t_seed, active))
    assert hit.sum() > 100


def test_intersect_treelets_matches_jax_with_seeds_and_dead_lanes(ico):
    """Random rays with a finite seed t on some lanes (the sphere-pass
    seed) and dead lanes, at a size that is not a packet multiple (but
    packs to the pixel grid's 4 packets, so the op-by-op JAX reference
    reuses that test's compiled shapes)."""
    jscene, pscene = ico
    rng = np.random.default_rng(7)
    n = 1000
    ro = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    ro[:, 2] += 3.0
    tgt = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32) + np.array([0.7, 0, -0.5], np.float32)
    rd = tgt - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    comps = [ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2]]
    t_min = np.full(n, 1e-4, np.float32)
    t_seed = np.where(rng.random(n) < 0.3, rng.uniform(1.0, 4.0, n), 3.0e38).astype(np.float32)
    active = rng.random(n) < 0.9
    jout = _jax_treelets(jscene, comps, t_min, t_seed, active)
    hit = _check_against_jax(jout, _port_treelets(pscene, comps, t_min, t_seed, active))
    assert hit.sum() > 100 and not hit[~active].any()


def _tie_grid_scene(pkg_desc, instances, n=12):
    """test_tie_breaking.py's planar grid, as `instances` coplanar copies."""
    xs, ys = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1).astype(np.float32)
    vid = lambda i, j: i * (n + 1) + j
    tris = []
    for i in range(n):
        for j in range(n):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i, j + 1), vid(i + 1, j + 1)
            tris += [[a, c, b], [b, c, d]]
    d = pkg_desc()
    d.add_material("m", "lambertian", albedo=(1, 1, 1))
    d.add_mesh("grid", pos, np.asarray(tris, np.int32))
    for _ in range(instances):
        d.add_mesh_object("grid", np.eye(4), "m")
    return d.build()


def test_exact_t_ties_go_to_the_later_visit():
    """Two identical coplanar instances tie bit-exactly on every hit; the
    sequential later-visit-wins rule gives object 1 everywhere, which is
    what test_tie_breaking.py asserts of the JAX package."""
    pscene = _tie_grid_scene(SceneDescription, 2)
    g = np.arange(0.25, 12.0, 0.5, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    n = gx.size
    comps = [gx.ravel(), gy.ravel(), np.full(n, 1.0, np.float32),
             np.zeros(n, np.float32), np.zeros(n, np.float32), np.full(n, -1.0, np.float32)]
    t_min = np.full(n, 1e-4, np.float32)
    t_seed = np.full(n, 3.0e38, np.float32)
    active = np.ones(n, bool)
    t, slot, ex = _port_treelets(pscene, comps, t_min, t_seed, active)
    assert (slot >= 0).all()
    assert (ex["obj"] == 1.0).all()
    assert torch.equal(t, torch.ones_like(t))


def _step_inputs(scene):
    """test_pallas_step.py's inputs: rays aimed at the origin, R=2 treelet
    blocks per packet row in reverse-fetch order."""
    L = scene.s_leaf_size
    K = scene.tre_min.shape[0]
    sz, P, R = 16, 256, 2
    key = jax.random.PRNGKey(0)
    k1, _k2, k3 = jax.random.split(key, 3)
    ro3 = jax.random.uniform(k1, (sz, P, 3), minval=-2, maxval=2)
    rd3 = -ro3 / jnp.linalg.norm(ro3, axis=-1, keepdims=True)
    rows = dict(
        rox=ro3[..., 0], roy=ro3[..., 1], roz=ro3[..., 2],
        rdx=rd3[..., 0], rdy=rd3[..., 1], rdz=rd3[..., 2],
        tmin=jnp.full((sz, P), 1e-3), t=jnp.full((sz, P), JBIG),
    )
    tids = jax.random.randint(k3, (sz,), 0, K)
    iota_l = jnp.arange(L, dtype=jnp.int32)[None, :]
    blocks, slots = [], []
    for ri in range(R):
        tid = (tids + ri * 131) % K
        blocks.append(scene.tre_tris[tid])
        slots.append(tid[:, None] * L + iota_l)
    slot_pairs = jnp.concatenate(slots, axis=1)
    live = jnp.ones((sz, R * L), bool).at[3].set(False)  # one dead pair row
    comps = jnp.stack([_comp(blocks, c, L)[:, :, 0] for c in range(13)], axis=1)
    return rows, blocks, comps, live, slot_pairs


def test_winner_step_twin_matches_jax_dense_mt_and_reduce(ico):
    jscene, _ = ico
    L = jscene.s_leaf_size
    rows, blocks, comps, live, slot_pairs = _step_inputs(jscene)
    ok, t = _dense_mt(jscene, blocks, rows, live, L)
    ref = [np.asarray(x) for x in _winner_reduce(jnp.where(ok, t, JBIG), blocks, L, slot_pairs)]

    prows = {k: _t(v) for k, v in rows.items()}
    out = step_kernel.winner_step(
        prows, _t(comps), _t(live).float(), _t(slot_pairs).to(torch.int32)
    )
    out = [o.numpy() for o in out]
    got = ref[0] < 3.0e38
    assert got.sum() > 200
    np.testing.assert_array_equal(out[0] < 3.0e38, got)
    np.testing.assert_allclose(out[0][got], ref[0][got], rtol=1e-6)
    for i in (1, 2, 3, 4, 5):  # slot, nx, ny, nz, obj
        np.testing.assert_array_equal(out[i][got], ref[i][got])
    # no-hit lanes carry the fold's initial winner
    assert (out[1][~got] == 0).all() and (out[5][~got] == -1.0).all()
