"""Closest-hit treelet sweep of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their torch twins; they are held to
``tpupt.accel.packets.intersect_treelets`` (the reference the Pallas
kernels are held to in test_pallas_sweep.py / test_pallas_step.py) on the
same inputs.  Winner identity (slot, object, hit mask, the winner's
normal) must be exact, t within rtol 1e-6 (test_pallas_sweep.py's
tolerance); the differentiable renderer's payload (the winner's p0, e1,
e2, copied out of its block row) must be EQUAL on every lane.  The JAX reference runs under ``jax.disable_jit()``: compiled,
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
from tpupt.accel.packets import _cull_entries as jax_cull_entries
from tpupt.accel.packets import _pack_rows as jax_pack_rows
from tpupt.accel.packets import intersect_treelets as jax_intersect_treelets
from tpupt.core.camera import generate_rays as jax_generate_rays
from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.core.vec import Vec3 as JVec3
from tpupt.scene.description import SceneDescription as JaxDescription
from tpupt.scene.procedural import icosphere

from test_torch_kernels import super_plane_rays, tie_grid_description, tie_grid_rays, tie_grid_scene
from test_torch_scene import port_scene
from tpupt_torch.accel import packets, step_kernel
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.intersect import slot_tri_table
from tpupt_torch.scene.bake import rebake_treelets

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


def _jax_treelets(jscene, comps, t_min, t_seed, active, **kw):
    with jax.disable_jit():
        return jax_intersect_treelets(
            jscene, JVec3(*map(jnp.asarray, comps[:3])), JVec3(*map(jnp.asarray, comps[3:])),
            jnp.asarray(t_min), jnp.asarray(t_seed), jnp.asarray(active), **kw
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


def _tie_rays():
    return [np.asarray(c) for v in tie_grid_rays()[:2] for c in v]


@pytest.mark.parametrize("case", ["pixel_grid", "tie_grid"])
def test_intersect_treelets_payload_matches_jax(ico, case):
    """diff_payload=True: the port's twin against the JAX package's sweep,
    on test_pallas_sweep.py's scene and on two coplanar copies of the tie
    grid (every hit an exact-t tie, won by the later visit)."""
    if case == "pixel_grid":
        jscene, pscene = ico
        comps = _grid_rays()
    else:
        jscene = tie_grid_description(2, desc_cls=JaxDescription).build()
        pscene = tie_grid_scene(2)
        comps = _tie_rays()
    n = comps[0].shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    t_seed = np.full(n, 3.0e38, np.float32)
    active = np.ones(n, bool)
    active[::7] = False
    jout = _jax_treelets(jscene, comps, t_min, t_seed, active, diff_payload=True)
    pout = _port_treelets(pscene, comps, t_min, t_seed, active, diff_payload=True)
    hit = _check_against_jax(jout, pout)
    assert hit.sum() > 100 and not hit.all()
    assert set(pout[2]) == set(jout[2])
    for k in packets._DIFF_KEYS:
        np.testing.assert_array_equal(pout[2][k].numpy(), np.asarray(jout[2][k]), err_msg=k)


def test_payload_is_the_slot_table_row(ico):
    """On a rebaked scene the payload of a hit lane is bit-equal to its
    slot's row of slot_tri_table, the table the backward pass scatters
    into; a lane that never hit carries the unit triangle."""
    _, pscene = ico
    scene = rebake_treelets(pscene)
    comps = _grid_rays()
    n = comps[0].shape[0]
    active = np.ones(n, bool)
    active[::5] = False
    _t_out, slot, ex = _port_treelets(scene, comps, np.full(n, 1e-4, np.float32),
                                      np.full(n, 3.0e38, np.float32), active, diff_payload=True)
    pay = torch.stack([ex[k] for k in packets._DIFF_KEYS], dim=1)
    hit = slot >= 0
    assert int(hit.sum()) > 100 and not bool(hit.all())
    assert torch.equal(pay[hit], slot_tri_table(scene)[slot[hit].long()])
    unit = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    assert torch.equal(pay[~hit], unit.expand(int((~hit).sum()), 9))


def _big_scene():
    """Three icosphere(3) instances: K = 172 treelets, so both packages run
    the two-level cull (K >= 96) over 11 super-boxes."""
    v, f = icosphere(3)
    d = JaxDescription()
    d.add_material("m", "lambertian", albedo=(1, 1, 1))
    d.add_mesh("mesh", v, f)
    for off in ([0, 0, 0], [1.5, 0.3, -1], [-1.4, -0.2, -0.6]):
        d.add_mesh_object("mesh", np.asarray(jm3.mat_translate(off)), "m")
    return d.build()


@pytest.fixture(scope="module")
def big():
    jscene = _big_scene()
    pscene = port_scene(jscene)
    assert pscene.tre_min.shape[0] >= packets._TWOLEVEL_MIN_K
    return jscene, pscene


def _big_rays(pscene):
    """2048 rays (8 packets): the pixel grid, random rays, and rays with a
    zero direction component starting exactly on a super-box plane (the
    two-level cull's NaN caveat), with seeds and dead lanes."""
    rng = np.random.default_rng(11)
    grid = np.stack(_grid_rays(), axis=1)
    caveat = super_plane_rays(pscene.tre_min, pscene.tre_max)
    centre = np.array([0.1, 0.05, -0.3])
    m = 2048 - grid.shape[0] - len(caveat)
    o = rng.uniform(-2.5, 2.5, (m, 3))
    o[:, 2] += 3.0
    d = rng.uniform(-1.0, 1.0, (m, 3)) + centre - o
    rand = np.concatenate([o, d / np.linalg.norm(d, axis=1, keepdims=True)], axis=1)
    rays = np.concatenate([grid, caveat, rand]).astype(np.float32)
    n = rays.shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    t_seed = np.where(rng.random(n) < 0.2, rng.uniform(1.0, 4.0, n), 3.0e38).astype(np.float32)
    active = rng.random(n) < 0.9
    active[grid.shape[0]:grid.shape[0] + len(caveat)] = True
    return [rays[:, i] for i in range(6)], t_min, t_seed, active


def test_cull_entries_match_jax_two_level(big):
    """The port's masked two-level cull equals the JAX package's
    expansion-ladder cull bit for bit, caveat rays included."""
    jscene, pscene = big
    comps, t_min, t_seed, active = _big_rays(pscene)
    K = pscene.tre_min.shape[0]
    rows, act = packets._pack_rows(Vec3(*map(_t, comps[:3])), Vec3(*map(_t, comps[3:])),
                                   _t(t_min), _t(t_seed), _t(active))
    got = packets._cull_entries(pscene.tre_min, pscene.tre_max, rows, act).numpy()
    with jax.disable_jit():
        jrows, jact, _, _ = jax_pack_rows(
            JVec3(*map(jnp.asarray, comps[:3])), JVec3(*map(jnp.asarray, comps[3:])),
            jnp.asarray(t_min), jnp.asarray(t_seed), jnp.asarray(active))
        want = np.asarray(jax_cull_entries(jscene, jrows, jact))
    np.testing.assert_array_equal(got, want[:, :K])
    assert (want[:, K:] >= 3.0e38).all()
    assert (got < 3.0e38).any() and (got >= 3.0e38).any()


def test_intersect_treelets_matches_jax_two_level(big):
    jscene, pscene = big
    comps, t_min, t_seed, active = _big_rays(pscene)
    jout = _jax_treelets(jscene, comps, t_min, t_seed, active)
    hit = _check_against_jax(jout, _port_treelets(pscene, comps, t_min, t_seed, active))
    assert hit.sum() > 300 and not hit[~active].any()


def test_exact_t_ties_go_to_the_later_visit():
    """Two identical coplanar instances tie bit-exactly on every hit; the
    sequential later-visit-wins rule gives object 1 everywhere, which is
    what test_tie_breaking.py asserts of the JAX package."""
    pscene = tie_grid_scene(2)
    comps = _tie_rays()
    n = comps[0].shape[0]
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
