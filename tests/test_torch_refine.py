"""The differentiable renderer's pieces of the PyTorch port against the JAX
package (CPU): the treelet rebake, the slot table, the ids pass with the
sweep's payload, the fetch's custom backward and ``refine_hit``.

Tolerances:
  * the rebake of an unperturbed scene against the build-time bake at
    rtol 1e-6, atol 1e-6, test_rebake.py's: the build bakes in float64 and
    rounds once, the rebake runs float32 transforms;
  * the rebake, the slot table and the payload against the JAX package's
    EQUAL: the same float32 operations in the same order (the JAX side op
    by op, so nothing is contracted into an FMA);
  * the fetch's backward against autograd's gather VJP EQUAL: both add the
    same cotangents into each row in lane order; ``table_rows`` forward
    EQUAL to indexing, its gradient (a matrix product's sums) at rtol 1e-5,
    atol 1e-5;
  * ids EQUAL, and refined t, point and normal at test_torch_render.py's
    GEOM tolerance (rtol 1e-5, atol 1e-5 world units; the reasons are
    given there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.vec import Vec3 as JVec3
from tpupt.render.intersect import intersect_scene_ids_diff as jax_ids_diff
from tpupt.render.intersect import refine_hit as jax_refine_hit
from tpupt.render.intersect import slot_tri_table as jax_slot_tri_table
from tpupt.scene.bake import rebake_treelets as jax_rebake

from test_torch_render import GEOM, _rays
from test_torch_scene import port_scene
from tpupt_torch.accel.packets import _DIFF_KEYS
from tpupt_torch.accel.slot_scatter import slot_scatter
from tpupt_torch.core.types import HitIds, PRIM_TRIANGLE, table_rows
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.intersect import (
    _FetchTriRows,
    intersect_scene_ids_diff,
    refine_hit,
    slot_tri_table,
)
from tpupt_torch.scene.bake import rebake_treelets

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)


def _moved_positions(jscene, seed=0):
    v = np.asarray(jscene.positions)
    return (v + 0.02 * np.random.default_rng(seed).standard_normal(v.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def moved(full_scene):
    """full_scene with perturbed vertices, rebaked by both packages."""
    pos = _moved_positions(full_scene)
    jscene = jax_rebake(full_scene.replace(positions=jnp.asarray(pos)))
    pscene = rebake_treelets(dataclasses.replace(port_scene(full_scene),
                                                 positions=torch.from_numpy(pos)))
    return jscene, pscene


def test_rebake_of_unperturbed_scene_matches_build(full_scene):
    pscene = port_scene(full_scene)
    re = rebake_treelets(pscene)
    for k in ("tre_tris", "tre_min", "tre_max"):
        got, want = getattr(re, k), getattr(pscene, k)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("leaf", ["tre_tris", "tre_min", "tre_max"])
def test_rebake_matches_jax(moved, leaf):
    jscene, pscene = moved
    np.testing.assert_array_equal(getattr(pscene, leaf).numpy(), np.asarray(getattr(jscene, leaf)))


def test_rebake_is_differentiable_in_positions(full_scene):
    pscene = port_scene(full_scene)
    pos = pscene.positions.clone().requires_grad_(True)
    re = rebake_treelets(dataclasses.replace(pscene, positions=pos))
    (g,) = torch.autograd.grad(re.tre_tris.sum() + slot_tri_table(re).sum(), pos)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_slot_tri_table_matches_jax(moved):
    jscene, pscene = moved
    np.testing.assert_array_equal(slot_tri_table(pscene).numpy(),
                                  np.asarray(jax_slot_tri_table(jscene)))


def test_fetch_tri_rows_backward_is_the_gather_vjp():
    """Forward returns the payload; backward equals autograd's VJP of the
    row gather wtable[clamp(slot, 0)], with repeated slots and slot -1, for
    the cotangents refine_hit hands it: zero on a lane with slot -1, whose
    hit is not a triangle.  That backward is ``slot_scatter``, whose twin
    is the index_add_ of the rows with slot >= 0: a slot -1 lane adds
    nothing even with a nonzero cotangent."""
    r = np.random.default_rng(3)
    wtable = torch.from_numpy(r.standard_normal((64, 9)).astype(np.float32)).requires_grad_(True)
    slot = torch.from_numpy(np.concatenate([r.integers(0, 64, 200), [-1, -1, 5, 5, 5, 0]]))
    vals = [c.detach() for c in wtable[slot.clamp(min=0)].unbind(1)]
    cot = torch.from_numpy(r.standard_normal((slot.shape[0], 9)).astype(np.float32))
    cot[slot < 0] = 0.0

    out = _FetchTriRows.apply(wtable, slot, *vals)
    assert all(torch.equal(a, b) for a, b in zip(out, vals))
    (got,) = torch.autograd.grad(out, wtable, grad_outputs=list(cot.unbind(1)))
    (want,) = torch.autograd.grad(wtable[slot.clamp(min=0)], wtable, grad_outputs=cot)
    assert torch.equal(got, want)
    assert got[5].abs().sum() > 0 and got[0].abs().sum() > 0
    # slot_scatter's twin: a slot -1 lane's cotangent goes nowhere, in
    # either layout of the rows
    cot[slot < 0] = 1.0
    keep = slot >= 0
    want = torch.zeros((64, 9)).index_add_(0, slot[keep], cot[keep])
    for rows in (cot, cot.t().contiguous().t()):
        assert torch.equal(slot_scatter(torch.zeros((64, 9)), slot, rows), want)
    (got,) = torch.autograd.grad(_FetchTriRows.apply(wtable, slot, *vals), wtable,
                                 grad_outputs=list(cot.unbind(1)))
    assert torch.equal(got, want)


def test_slot_scatter_raises_on_a_slot_past_the_table():
    """A slot past the table's end is an error, not "no triangle": the
    twin's index_add_ raises on it (the kernel asserts, test_torch_kernels)."""
    slot = torch.tensor([3, -1, 64, 5])
    with pytest.raises((IndexError, RuntimeError)):
        slot_scatter(torch.zeros((64, 9)), slot, torch.ones((4, 9)))


@pytest.mark.parametrize("shape", [(5,), (5, 3)])
def test_table_rows_is_an_exact_gather(shape):
    """Rows of a small table read through the one-hot product equal plain
    indexing bit for bit; their gradient sums the same cotangents per row,
    in the matrix product's order.  Without autograd it indexes."""
    r = np.random.default_rng(4)
    table = torch.from_numpy(r.standard_normal(shape).astype(np.float32)).requires_grad_(True)
    idx = torch.from_numpy(r.integers(0, shape[0], 300))
    cot = torch.from_numpy(r.standard_normal((300,) + shape[1:]).astype(np.float32))
    got = table_rows(table, idx)
    want = table[idx]
    assert got.shape == want.shape and torch.equal(got, want)
    (g_got,) = torch.autograd.grad(got, table, cot)
    (g_want,) = torch.autograd.grad(want, table, cot)
    np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(table_rows(table, idx), want)


@pytest.fixture(scope="module")
def ids_both(moved):
    """Both packages' ids pass on the rebaked scene, on the same rays."""
    jscene, pscene = moved
    ro, rd = _rays(seed=8)
    n = ro[0].shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    active = np.random.default_rng(9).random(n) < 0.95
    jids, jvals = jax_ids_diff(jscene, JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
                               jnp.asarray(t_min), jnp.asarray(active))
    pids, pvals = intersect_scene_ids_diff(
        pscene, Vec3(*map(torch.from_numpy, ro)), Vec3(*map(torch.from_numpy, rd)),
        torch.from_numpy(t_min), torch.from_numpy(active))
    return dict(ro=ro, rd=rd, t_min=t_min, jids=jids, jvals=jvals, pids=pids, pvals=pvals)


def test_ids_pass_with_payload_matches_jax(ids_both):
    jids, jvals, pids, pvals = (ids_both[k] for k in ("jids", "jvals", "pids", "pvals"))
    kind = np.asarray(jids.kind)
    assert (kind == 0).sum() > 200 and (kind == 1).sum() > 200  # spheres and meshes
    for k in ("kind", "obj_id", "prim_id"):
        np.testing.assert_array_equal(getattr(pids, k).numpy(), np.asarray(getattr(jids, k)), k)
    hit = kind >= 0
    np.testing.assert_allclose(pids.t.numpy()[hit], np.asarray(jids.t)[hit], **GEOM)
    np.testing.assert_array_equal(pvals["slot"].numpy(), np.asarray(jvals["slot"]))
    tri = kind == PRIM_TRIANGLE
    for k in _DIFF_KEYS:
        np.testing.assert_array_equal(pvals[k].numpy()[tri], np.asarray(jvals[k])[tri], k)


def test_refine_hit_matches_jax(moved, ids_both):
    """Both refines on the SAME ids and payload (the JAX ones)."""
    jscene, pscene = moved
    jids, jvals = ids_both["jids"], ids_both["jvals"]
    ro, rd, t_min = ids_both["ro"], ids_both["rd"], ids_both["t_min"]
    jhit = jax_refine_hit(jscene, JVec3(*map(jnp.asarray, ro)), JVec3(*map(jnp.asarray, rd)),
                          jnp.asarray(t_min), jids, dict(jvals, table=jax_slot_tri_table(jscene)))
    tt = lambda a: torch.from_numpy(np.array(a))
    ids = HitIds(kind=tt(jids.kind), obj_id=tt(jids.obj_id).long(),
                 prim_id=tt(jids.prim_id).long(), t=tt(jids.t))
    phit = refine_hit(pscene, Vec3(*map(tt, ro)), Vec3(*map(tt, rd)), tt(t_min), ids,
                      {k: tt(v) for k, v in jvals.items()})
    np.testing.assert_array_equal(phit.mask.numpy(), np.asarray(jhit.mask))
    np.testing.assert_array_equal(phit.front.numpy(), np.asarray(jhit.front))
    np.testing.assert_array_equal(phit.mat_id.numpy(), np.asarray(jhit.mat_id))
    m = np.asarray(jhit.mask)
    np.testing.assert_allclose(phit.t.numpy()[m], np.asarray(jhit.t)[m], **GEOM)
    for a, b in zip((*jhit.point, *jhit.normal), (*phit.point, *phit.normal)):
        np.testing.assert_allclose(b.numpy()[m], np.asarray(a)[m], **GEOM)


def test_refine_hit_is_finite_on_every_lane(moved, ids_both):
    """Misses, spheres and triangles in one batch: the gradient of every
    output with respect to the positions and spheres is finite (the
    unselected branch's guards)."""
    _jscene, pscene = moved
    pos = pscene.positions.detach().clone().requires_grad_(True)
    rad = pscene.sphere_radius.detach().clone().requires_grad_(True)
    scene = rebake_treelets(dataclasses.replace(pscene, positions=pos, sphere_radius=rad))
    pids, pvals = ids_both["pids"], ids_both["pvals"]
    tt = torch.from_numpy
    hit = refine_hit(scene, Vec3(*map(tt, ids_both["ro"])), Vec3(*map(tt, ids_both["rd"])),
                     tt(ids_both["t_min"]), pids, dict(pvals, table=slot_tri_table(scene)))
    loss = hit.t.clamp(max=10.0).sum() + sum(c.sum() for c in (*hit.point, *hit.normal))
    g_pos, g_rad = torch.autograd.grad(loss, (pos, rad))
    assert torch.isfinite(g_pos).all() and torch.isfinite(g_rad).all()
    assert g_pos.abs().max() > 0 and g_rad.abs().max() > 0
    assert not bool(hit.mask.all())  # some lanes missed
