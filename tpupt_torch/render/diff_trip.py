"""The differentiable trip as hand-written CUDA kernels with a hand-written
backward: ``diff_trip_fwd`` and ``diff_trip_bwd``
(``accel/csrc/diff_trip_kernels.cu``), their torch twins, and
``DiffTrip``, the ``torch.autograd.Function`` around one differentiable
sample of a scene without emitters.

In the JAX package a differentiable sample (``trace_sample(
differentiable=True)``, ``tpupt/render/integrator.py``) is a ``lax.scan``
over ``_bounce_body`` with ``refine_hit`` and the ``_fetch_tri_rows``
custom VJP, compiled whole by XLA with its transpose.  Here ``DiffTrip``
runs it as the forward trip does (``trip_kernel``), per bounce

  ``trip_kernel.trip_head``  the sphere pass and the sweep's packed rows;
  ``sweep_kernel.treelet_closest_hit(payload=True)`` (scenes with a mesh),
                 the winner's slot, object and world p0, e1, e2;
  ``diff_trip_fwd``  ``intersect.refine_hit``'s closed form and the body
                 without emitters (``integrator._bounce_shade``,
                 ``_bounce_finish``) on the lane state in place, and the
                 bounce's residuals;

and its backward pass, per bounce in reverse, ``diff_trip_bwd``: one
launch of the kernel of the same name, the bounce recomputed from its
residuals and its vector-Jacobian product: the cotangent of its inputs,
the leaf cotangents in the layout of the kernels' scene table, and the
winner triangles' cotangents added straight into the slot table's
gradient (``_fetch_tri_rows``' scatter, fused in; ``accel.slot_scatter``
is that scatter on its own, for the body route).  The kernel runs on a
persistent grid: each CTA takes chunks of lanes from a work counter and
queues each chunk's live lanes by case (miss, sphere, triangle) in shared
memory, and its warps take the queues 32 lanes of one case at a time, so
the work follows the live lanes, a warp runs one branch, and each CTA
adds its leaf sums into the table once.

The residuals follow the JAX package's checkpointed bounce: a bounce keeps
its inputs and its discrete hit (``RES_F_KEYS``, ``RES_I_KEYS``: 48 bytes
a lane that hits; a lane that misses keeps only what its backward reads,
``res_written``), not its intermediates; the triangle rows are read again
from the slot table by slot.  The lane state is ``trip_kernel``'s ``F`` and ``I``;
the cotangent is ``G`` (len(G_KEYS), N) float32.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain twin for CPU tensors.  The twins are assembled from the body
route's functions (``DiffPlan.bounce``: ``refine_hit``, ``_bounce_shade``,
``_bounce_finish``); the backward twin is the VJP of one such bounce by
torch autograd.  Launches are counted in ``utils.trace.launch_counts()``.
A sample's set-up (``tpupt.diff.start``), each bounce's issue and read of
the lanes left (``tpupt.diff.issue``, ``tpupt.diff.wait``) and the
backward pass (``tpupt.diff.backward``) are spans of ``utils.trace``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from tpupt_torch.accel import kernels, sweep_kernel
from tpupt_torch.accel.packets import _DIFF_KEYS
from tpupt_torch.core.types import PRIM_NONE, PRIM_SPHERE, PRIM_TRIANGLE, HitIds
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render import trip_kernel as tk
from tpupt_torch.utils import debug
from tpupt_torch.utils import trace as tracing  # ``trace`` is this module's DiffTrip call

# a bounce's residuals: the ray, t_min and throughput it found, and its hit
# (code: object * 2 + 1 on a triangle, object * 2 on a sphere, MISS or
# DEAD) and the sweep's slot (-1 without a triangle)
RES_F_KEYS = ("rox", "roy", "roz", "rdx", "rdy", "rdz", "t_min", "colx", "coly", "colz")
RES_I_KEYS = ("code", "slot")
MISS, DEAD = -1, -2
# the residual rows a lane that misses keeps (its backward reads no others)
MISS_RES_KEYS = ("rdx", "rdy", "rdz", "colx", "coly", "colz")
# the cotangent rows: of the ray, the radiance, the throughput, the first
# hit's normal and depth
G_KEYS = ("rox", "roy", "roz", "rdx", "rdy", "rdz", "radx", "rady", "radz",
          "colx", "coly", "colz", "nx", "ny", "nz", "depth")
# the leaves a gradient reaches on this path, besides the slot table
LEAVES = ("sphere_center", "sphere_radius", "bg_down", "bg_up")
MATERIAL_LEAVES = ("albedo", "fuzz", "ior", "emission")


class Residuals(NamedTuple):
    f: torch.Tensor  # (len(RES_F_KEYS), N) float32
    i: torch.Tensor  # (len(RES_I_KEYS), N) int32


def residuals(n: int, device) -> Residuals:
    return Residuals(torch.empty((len(RES_F_KEYS), n), dtype=torch.float32, device=device),
                     torch.empty((len(RES_I_KEYS), n), dtype=torch.int32, device=device))


def res_written(code) -> torch.Tensor:
    """(len(RES_F_KEYS), N) bool: the float residuals ``diff_trip_fwd``
    writes for lanes of these codes, every row of a hit, MISS_RES_KEYS of
    a miss, none of a dead lane."""
    miss_rows = torch.tensor([k in MISS_RES_KEYS for k in RES_F_KEYS], device=code.device)
    return (code >= 0) | ((code == MISS) & miss_rows[:, None])


@dataclasses.dataclass
class DiffPlan:
    """One differentiable sample: ``trip`` (``trip_kernel.TripPlan``, one
    sample unchained, on the scene rebaked from its positions), the slot
    table's values (``table``, None without a mesh), ``start()`` -> (F, I)
    the lane state on the sample's primary rays, and ``bounce(scene, state,
    seed, bounce, ids, tri_vals)`` -> the state after one bounce by the body
    route's functions, which the twins are assembled from."""

    trip: tk.TripPlan
    table: torch.Tensor | None
    start: Callable
    bounce: Callable


# --- the twins ----------------------------------------------------------------

def _codes(plan: tk.TripPlan, buf: tk.TripBuffers, sweep, alive):
    """(code, slot) of each lane from ``trip_head``'s hint and the sweep:
    ``intersect.intersect_scene_ids_diff``'s winner."""
    hint = buf.hint.long()
    code = torch.where(hint >= 0, (hint >> 1) * 2, MISS)
    slot = torch.full_like(hint, -1)
    if sweep is not None:
        slot = sweep[1].reshape(-1)[:plan.n].long()
        obj = sweep[5].reshape(-1)[:plan.n].long().clamp(min=0)
        code = torch.where(slot >= 0, obj * 2 + 1, code)
    return torch.where(alive, code, DEAD), torch.where(alive, slot, -1)


def _ids(plan: tk.TripPlan, code) -> HitIds:
    """The ``HitIds`` of codes: kind, object and (on spheres) the sphere
    primitive; t is not read by ``refine_hit``."""
    hit = code >= 0
    tri = hit & (code % 2 == 1)
    kind = torch.where(hit, torch.where(tri, PRIM_TRIANGLE, PRIM_SPHERE), PRIM_NONE)
    obj = torch.where(hit, code >> 1, -1)
    prim_of = torch.tensor(list(plan.scene.s_obj_prim) or [0], device=code.device)
    prim = torch.where(hit & ~tri, prim_of[obj.clamp(min=0)], -1)
    return HitIds(kind=kind.to(torch.int32), obj_id=obj, prim_id=prim,
                  t=torch.zeros(code.shape, device=code.device))


def diff_trip_fwd_plain(dp: DiffPlan, F, I, buf: tk.TripBuffers, sweep, bounce: int,
                        res: Residuals | None = None):
    """Torch twin of ``diff_trip_fwd``: the ids from ``buf`` and the
    payload sweep's outputs, ``dp.bounce`` (``refine_hit``, the body) on
    the live lanes, their state written into F and I (their segments + 1),
    their residuals into ``res``, the lanes left into ``buf.count``.
    Returns (F, I)."""
    plan = dp.trip
    cur = tk.unpack_state(F, I)
    st, seed = cur["state"], cur["seed"]
    alive = st["alive"]
    code, slot = _codes(plan, buf, sweep, alive)
    tri_vals = None
    if sweep is not None:
        rows = [o.reshape(-1)[:plan.n] for o in sweep[6:]]
        tri_vals = dict(zip(_DIFF_KEYS, rows), slot=slot, table=dp.table)
    out = dp.bounce(plan.scene, st, seed, bounce, _ids(plan, code), tri_vals)
    chain = dict(cur["chain"], segs=cur["chain"]["segs"] + alive.long())
    F2, I2 = tk.pack_state(dict(out, alive=out["alive"] & alive), seed, cur["bounce"], chain)
    if res is not None:
        vals = torch.stack([*st["ro"], *st["rd"], st["t_min"], *st["color"]])
        res.f.copy_(torch.where(res_written(code), vals, res.f))
        res.i.copy_(torch.stack([code, slot]).to(torch.int32))
    F.copy_(torch.where(alive, F2, F))
    I.copy_(torch.where(alive, I2, I))
    buf.count.copy_((out["alive"] & alive).sum().reshape(1))
    return F, I


def _leaf_copies(scene):
    """Copies of the scene's leaves that require grad, and the scene with
    them in place."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in LEAVES}
    mats = {k: getattr(scene.materials, k).detach().clone().requires_grad_(True)
            for k in MATERIAL_LEAVES}
    return leaves, mats, dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **mats), **leaves)


def leaf_table_zeros(plan: tk.TripPlan) -> torch.Tensor:
    """A zero leaf table: float64, shaped as ``plan.tables.table``, what
    ``diff_trip_bwd`` accumulates into."""
    return torch.zeros(plan.tables.table.shape, dtype=torch.float64,
                       device=plan.tables.table.device)


def leaf_table(plan: tk.TripPlan, grads: dict) -> torch.Tensor:
    """Leaf gradients ({name: tensor}, names of LEAVES and MATERIAL_LEAVES)
    in the layout of ``plan.tables.table``, the layout ``diff_trip_bwd``
    accumulates (float64): a sphere primitive's in the first sphere row
    naming it."""
    tabs = plan.tables
    g = leaf_table_zeros(plan)
    seen = set()
    for r, (_, p) in enumerate(plan.sphere_rows):
        if p in seen:
            continue
        seen.add(p)
        base = r * tk.SPHERE_ROW
        g[base + 24:base + 27] = grads["sphere_center"][p]
        g[base + 27] = grads["sphere_radius"][p]
    m = plan.scene.materials.albedo.shape[0]
    mats = g[tabs.mat_off:tabs.mat_off + m * tk.MAT_ROW].view(m, tk.MAT_ROW)
    mats[:, 1:4] = grads["albedo"]
    mats[:, 4] = grads["fuzz"]
    mats[:, 5] = grads["ior"]
    mats[:, 6:9] = grads["emission"]
    g[tabs.bg_off:tabs.bg_off + 3] = grads["bg_down"]
    g[tabs.bg_off + 3:tabs.bg_off + 6] = grads["bg_up"]
    return g


def split_leaf_table(plan: tk.TripPlan, g: torch.Tensor) -> dict:
    """The inverse of ``leaf_table``: {name: float32 gradient}, a sphere
    primitive's summed over the rows naming it (in double)."""
    sc, tabs = plan.scene, plan.tables
    out = {"sphere_center": torch.zeros_like(sc.sphere_center),
           "sphere_radius": torch.zeros_like(sc.sphere_radius)}
    if plan.sphere_rows:
        rows = g[:len(plan.sphere_rows) * tk.SPHERE_ROW].view(-1, tk.SPHERE_ROW)
        prims = torch.tensor([p for _, p in plan.sphere_rows], device=g.device)
        per_prim = g.new_zeros((sc.sphere_radius.shape[0], 4)).index_add_(
            0, prims, rows[:, 24:28]).float()
        out.update(sphere_center=per_prim[:, :3].contiguous(),
                   sphere_radius=per_prim[:, 3].contiguous())
    g = g.float()
    m = sc.materials.albedo.shape[0]
    mats = g[tabs.mat_off:tabs.mat_off + m * tk.MAT_ROW].view(m, tk.MAT_ROW)
    out.update(albedo=mats[:, 1:4].clone(), fuzz=mats[:, 4].clone(), ior=mats[:, 5].clone(),
               emission=mats[:, 6:9].clone(), bg_down=g[tabs.bg_off:tabs.bg_off + 3].clone(),
               bg_up=g[tabs.bg_off + 3:tabs.bg_off + 6].clone())
    return out


def diff_trip_bwd_plain(dp: DiffPlan, G, res: Residuals, seed, bounce: int, gtab,
                        g_slot=None):
    """Torch twin of ``diff_trip_bwd``: the VJP by torch autograd of
    ``dp.bounce`` recomputed from the residuals, on the live lanes: G
    replaced by the cotangent of the bounce's inputs, the leaf gradients
    added into ``gtab`` (``leaf_table_zeros``) and the slot table's into
    ``g_slot`` (None: not wanted).  ``seed`` is the lane state's seed row.
    Returns G."""
    plan = dp.trip
    code, slot = res.i[0].long(), res.i[1].long()
    alive = code != DEAD
    leaves, mats, scene = _leaf_copies(plan.scene)
    # the residuals diff_trip_fwd did not write (a dead lane's, a miss's
    # ray origin and t_min): a finite stand-in keeps the masked arithmetic
    # (zero cotangent) finite
    stand_in = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1e-4, 1.0, 1.0, 1.0],
                            device=G.device)[:, None]
    res_f = torch.where(res_written(code), res.f, stand_in)
    ins = [r.clone().requires_grad_(True) for r in res_f[[0, 1, 2, 3, 4, 5, 7, 8, 9]]]
    zeros = [torch.zeros_like(res_f[0]).requires_grad_(True) for _ in range(7)]
    state = dict(ro=Vec3(*ins[0:3]), rd=Vec3(*ins[3:6]), t_min=res_f[6],
                 radiance=Vec3(*zeros[0:3]), color=Vec3(*ins[6:9]), alive=alive,
                 normal=Vec3(*zeros[3:6]), depth=zeros[6])
    tri_vals, table = None, []
    if dp.table is not None:
        # the rows the sweep copied out of the table, and the table that
        # takes their cotangent through the body route's _FetchTriRows
        wtable = dp.table.detach().clone().requires_grad_(g_slot is not None)
        rows = dp.table.detach()[slot.clamp(min=0)].unbind(1)
        tri_vals = dict(zip(_DIFF_KEYS, rows), slot=slot, table=wtable)
        table = [wtable] if g_slot is not None else []
    seeds = seed.long() & 0xFFFFFFFF
    with torch.enable_grad():
        out = dp.bounce(scene, state, seeds, bounce, _ids(plan, code), tri_vals)
        outs = [*out["ro"], *out["rd"], *out["radiance"], *out["color"], *out["normal"],
                out["depth"]]
        wrt = (ins[0:6] + zeros[0:3] + ins[6:9] + zeros[3:7] + list(leaves.values())
               + list(mats.values()) + table)
        grads = torch.autograd.grad(outs, wrt, grad_outputs=list(G), allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)]
    G.copy_(torch.where(alive, torch.stack(grads[:len(G_KEYS)]), G))
    names = LEAVES + MATERIAL_LEAVES
    gtab += leaf_table(plan, dict(zip(names, grads[len(G_KEYS):len(G_KEYS) + len(names)])))
    if table:
        g_slot += grads[-1]
    return G


# --- the kernels ----------------------------------------------------------------

def _check(name, dp: DiffPlan, tensors):
    req = kernels.require
    dev = tensors[0].device
    req(dev.type == "cuda", f"{name}: unsupported device {dev}")
    req(not dp.trip.nee, f"{name}: the scene has emitters (NEE runs on the body route)")
    for x in tensors + [dp.trip.tables.table]:
        req(x.device == dev and x.is_contiguous(),
            f"{name}: every input must be contiguous on {dev}")
    return kernels.load()


def diff_trip_fwd(dp: DiffPlan, F, I, buf: tk.TripBuffers, sweep, bounce: int,
                  res: Residuals | None = None):
    """One bounce of the differentiable trip for the lane state (F, I),
    updated in place on the live lanes: the ids from ``buf`` (``trip_head``)
    and ``sweep`` (``treelet_closest_hit(payload=True)``'s 15 outputs on
    ``buf``'s rows; None for a scene without meshes), ``refine_hit`` and
    the body without emitters; the bounce's residuals into ``res`` (None:
    none kept), the lanes left into ``buf.count``.  Returns (F, I).
    Launches are counted under "diff_trip_fwd" (``utils.trace``)."""
    if F.device.type == "cpu":
        return diff_trip_fwd_plain(dp, F, I, buf, sweep, bounce, res)
    plan = dp.trip
    req, n = kernels.require, plan.n
    req(tuple(F.shape) == (len(tk.F_KEYS), n) and F.dtype == torch.float32,
        f"diff_trip_fwd: F must be ({len(tk.F_KEYS)}, {n}) float32")
    req(tuple(I.shape) == (len(tk.I_KEYS), n) and I.dtype == torch.int32,
        f"diff_trip_fwd: I must be ({len(tk.I_KEYS)}, {n}) int32")
    req(tuple(buf.hint.shape) == (n,) and buf.hint.dtype == torch.int32,
        f"diff_trip_fwd: hint must be ({n},) int32")
    req((sweep is not None) == plan.mesh, "diff_trip_fwd: the sweep goes with a mesh")
    tensors = [F, I, buf.hint, buf.count]
    if sweep is not None:
        req(len(sweep) == 15 and sweep[1].dtype == torch.int32
            and all(o.numel() == plan.n_pad for o in sweep)
            and all(sweep[j].dtype == torch.float32 for j in (0, 2, 3, 4, 5, *range(6, 15))),
            "diff_trip_fwd: sweep must be treelet_closest_hit(payload=True)'s 15 outputs")
        tensors += [sweep[1], sweep[5], *sweep[6:]]
    if res is not None:
        req(tuple(res.f.shape) == (len(RES_F_KEYS), n) and res.f.dtype == torch.float32
            and tuple(res.i.shape) == (len(RES_I_KEYS), n) and res.i.dtype == torch.int32,
            "diff_trip_fwd: residuals of the wrong shape")
        tensors += [res.f, res.i]
    lib = _check("diff_trip_fwd", dp, tensors)
    tabs = plan.tables
    ptrs = [None] * 11 if sweep is None else [sweep[1].data_ptr(), sweep[5].data_ptr(),
                                              *(o.data_ptr() for o in sweep[6:])]
    rr = tk._NO_RR if plan.rr_start is None else int(plan.rr_start)
    if n:
        err = lib.tpupt_diff_trip_fwd(
            F.data_ptr(), I.data_ptr(), n, buf.hint.data_ptr(), *ptrs, tabs.table.data_ptr(),
            tabs.n_sph, tabs.mat_off, tabs.obj_off, tabs.bg_off, bounce, rr,
            None if res is None else res.f.data_ptr(), None if res is None else res.i.data_ptr(),
            buf.count.data_ptr(), kernels.stream_of(F))
        kernels.check(lib, err, "diff_trip_fwd")
        tracing.launched("diff_trip_fwd")
    else:
        buf.count.zero_()
    return F, I


def diff_trip_bwd(dp: DiffPlan, G, res: Residuals, seed, bounce: int, gtab, g_slot=None):
    """The backward pass of one bounce on the live lanes of its residuals
    ``res``: G (len(G_KEYS), N), the cotangent of the bounce's outputs,
    replaced in place by that of its inputs; the leaf cotangents added
    into ``gtab`` (float64, ``leaf_table_zeros``); the slot table's added
    into ``g_slot`` (shaped as ``dp.table``; None: not wanted).  ``seed``
    is the lane state's seed row (int32).  Returns G.

    On the card one launch of the kernel does all of it, the slot table's
    gradient included (the winner rows' scatter runs inside it), on a
    persistent grid whose CTAs take chunks of lanes from a work counter
    and queue each chunk's live lanes by case, so its work follows the
    bounce's live lanes.  A slot past the slot table fails the launch.
    Launches are counted under "diff_trip_bwd" (``utils.trace``)."""
    if G.device.type == "cpu":
        return diff_trip_bwd_plain(dp, G, res, seed, bounce, gtab, g_slot)
    plan = dp.trip
    req, n = kernels.require, plan.n
    tabs = plan.tables
    req(tuple(G.shape) == (len(G_KEYS), n) and G.dtype == torch.float32,
        f"diff_trip_bwd: G must be ({len(G_KEYS)}, {n}) float32")
    req(tuple(res.f.shape) == (len(RES_F_KEYS), n) and tuple(res.i.shape) == (len(RES_I_KEYS), n)
        and res.i.dtype == torch.int32, "diff_trip_bwd: residuals of the wrong shape")
    req(tuple(seed.shape) == (n,) and seed.dtype == torch.int32,
        f"diff_trip_bwd: seed must be ({n},) int32")
    req(gtab.shape == tabs.table.shape and gtab.dtype == torch.float64,
        "diff_trip_bwd: gtab must be float64, shaped as the scene table")
    req((dp.table is not None) == plan.mesh, "diff_trip_bwd: the slot table goes with a mesh")
    tensors = [G, res.f, res.i, seed, gtab]
    if dp.table is not None:
        req(dp.table.dim() == 2 and dp.table.shape[1] == 9 and dp.table.dtype == torch.float32,
            "diff_trip_bwd: the slot table must be (K*L, 9) float32")
        tensors.append(dp.table)
    if g_slot is not None:
        req(dp.table is not None and g_slot.shape == dp.table.shape
            and g_slot.dtype == torch.float32,
            "diff_trip_bwd: g_slot must be shaped as the slot table, float32")
        tensors.append(g_slot)
    lib = _check("diff_trip_bwd", dp, tensors)
    n_mat = plan.scene.materials.albedo.shape[0]
    smem = lib.tpupt_diff_trip_bwd_smem_bytes(tabs.n_sph, n_mat)
    limit = torch.cuda.get_device_properties(G.device).shared_memory_per_block_optin
    req(smem <= limit, f"diff_trip_bwd: the leaf table needs {smem} B of shared memory > {limit}")
    rr = tk._NO_RR if plan.rr_start is None else int(plan.rr_start)
    if n:
        stream = kernels.stream_of(G)
        err = lib.tpupt_diff_trip_bwd(
            G.data_ptr(), n, res.f.data_ptr(), res.i.data_ptr(), seed.data_ptr(),
            None if dp.table is None else dp.table.data_ptr(),
            0 if dp.table is None else dp.table.shape[0], tabs.table.data_ptr(), tabs.n_sph,
            n_mat, tabs.mat_off, tabs.obj_off, tabs.bg_off, bounce, rr, gtab.data_ptr(),
            None if g_slot is None else g_slot.data_ptr(),
            _work_counter(G.device, stream).data_ptr(), stream)
        kernels.check(lib, err, "diff_trip_bwd")
        tracing.launched("diff_trip_bwd")
    return G


_WORK: dict = {}  # (device, stream) -> diff_trip_bwd's work counter


def _work_counter(device, stream) -> torch.Tensor:
    """diff_trip_bwd's work counter for launches on ``stream``: zeroed
    once, when made; each launch's last take sets it back to 0, so a
    bounce's backward is one device operation."""
    key = (str(device), stream)
    if key not in _WORK:
        _WORK[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _WORK[key]


# --- the Function -------------------------------------------------------------

class DiffTrip(torch.autograd.Function):
    """One differentiable sample of a scene without emitters.

    ``DiffTrip.apply(dp, table, *leaves)``, leaves in LEAVES then
    MATERIAL_LEAVES order (``table``: the slot table, differentiable in
    the positions; None without a mesh) -> (color (N, 3), normal (N, 3),
    depth (N,), traced segments as a 0-dim int64 tensor with no gradient).
    The forward runs the bounces while a lane is alive, keeping each one's
    residuals when a gradient is wanted; the backward runs
    ``diff_trip_bwd`` a bounce, in reverse, and hands each leaf that asks for one
    its gradient."""

    @staticmethod
    def forward(ctx, dp: DiffPlan, table, *leaves):
        keep = any(ctx.needs_input_grad[1:])
        plan = dp.trip
        scene, n = plan.scene, plan.n
        tre = (scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
        with tracing.span("tpupt.diff.start", device=scene.device):
            F, I = dp.start()
            buf = tk.trip_buffers(plan)
            seed = I[tk.I_KEYS.index("seed")].clone()
        res, rays, live = [], 0, n
        for b in range(plan.max_bounces):
            if live == 0:
                break
            rays += live
            with tracing.span("tpupt.diff.issue"):
                tk.trip_head(plan, F, I, buf)
                sweep = (sweep_kernel.treelet_closest_hit(buf.sweep_rows, buf.act_p, *tre,
                                                          payload=True) if plan.mesh else None)
                r = residuals(n, F.device) if keep else None
                diff_trip_fwd(dp, F, I, buf, sweep, b, r)
            if debug.enabled():  # TPUPT_DEBUG=1 guards on the bounce's outputs
                debug.check_finite("bounce radiance/throughput",
                                   *tk.rows(F, tk.RADIANCE + tk.COLOR))
                debug.check_finite("bounce scatter", *tk.rows(F, ("rox", "rdx", "nx")))
            with tracing.span("tpupt.diff.wait"):
                live = int(buf.count)
            if keep:
                res.append(r)
        st = tk.unpack_state(F, I)["state"]
        # paths alive at the bounce cap add their raw throughput
        color = torch.where(st["alive"][:, None], (st["radiance"] + st["color"]).to_array(),
                            st["radiance"].to_array())
        rays_t = torch.tensor(rays, dtype=torch.int64, device=F.device)
        ctx.mark_non_differentiable(rays_t)
        if keep:
            ctx.dp, ctx.res, ctx.seed, ctx.alive = dp, res, seed, st["alive"].clone()
        return color, st["normal"].to_array(), st["depth"].clone(), rays_t

    @staticmethod
    @once_differentiable
    def backward(ctx, g_color, g_normal, g_depth, _g_rays):
        with tracing.span("tpupt.diff.backward"):
            dp = ctx.dp
            plan = dp.trip
            G = torch.zeros((len(G_KEYS), plan.n), dtype=torch.float32, device=g_color.device)
            G[6:9] = g_color.t()
            G[9:12] = torch.where(ctx.alive, g_color.t(), 0.0)
            G[12:15] = g_normal.t()
            G[15] = g_depth
            gtab = leaf_table_zeros(plan)
            want_slot = dp.table is not None and ctx.needs_input_grad[1]
            g_slot = torch.zeros_like(dp.table) if want_slot else None
            for b in reversed(range(len(ctx.res))):
                diff_trip_bwd(dp, G, ctx.res[b], ctx.seed, b, gtab, g_slot)
            grads = split_leaf_table(plan, gtab)
            return (None, g_slot) + tuple(grads[k] if ctx.needs_input_grad[2 + j] else None
                                          for j, k in enumerate(LEAVES + MATERIAL_LEAVES))


def trace(dp: DiffPlan, table) -> tuple:
    """``DiffTrip`` on the trip plan's scene leaves: (color, normal, depth,
    segments)."""
    sc = dp.trip.scene
    leaves = [getattr(sc, k) for k in LEAVES] + [getattr(sc.materials, k) for k in MATERIAL_LEAVES]
    return DiffTrip.apply(dp, table, *leaves)
