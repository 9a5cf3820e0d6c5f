"""Scene-level intersection (counterpart of ``tpupt/render/intersect.py``):
the closest hit, and the shadow rays' occlusion test (``occlusion_anyhit``).

Spheres: an unrolled scan over the sphere objects (the reference's object
loop; a later equal-t hit overwrites an earlier one).  Meshes: the packet
treelet sweep (``accel/packets.py``) over the world-baked treelet table,
seeded with the sphere pass's t so treelets behind a sphere hit are
skipped.  The winner's normal and object id come out of the sweep with it.

The differentiable renderer splits a hit in two:

  1. ``intersect_scene_ids_diff`` finds WHICH primitive each ray hits, under
     ``torch.no_grad()``: discrete ids, and the winning triangle's world
     p0, e1, e2 carried out of the sweep (its payload form);
  2. ``refine_hit`` recomputes t, point and normal in closed form from the
     scene parameters and the ray, so gradients reach vertex positions,
     sphere centres and radii.  The triangle's rows enter through
     ``_FetchTriRows``, whose backward scatters their cotangent into the
     slot-ordered table ``slot_tri_table`` (``accel.slot_scatter``).

``intersect_scene_ids_bvh`` is the reference ids pass: the per-ray BVH
walk of ``accel/traverse.py``, whose hits ``refine_hit`` recomputes from
the triangle ids (forward and differentiably).

Visibility is treated as locally constant, as in the JAX package.  Rows
of the small per-sphere and per-material tables are read through
``types.table_rows``, whose backward pass is a dense reduction over the
lanes rather than a scatter into a few rows.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel.packets import _DIFF_KEYS, intersect_treelets, intersect_treelets_anyhit
from tpupt_torch.accel.slot_scatter import slot_scatter
from tpupt_torch.accel.traverse import traverse_mesh
from tpupt_torch.core import vec
from tpupt_torch.core.types import (
    Hit,
    HitIds,
    OBJ_MESH,
    OBJ_SPHERE,
    PRIM_NONE,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    SceneArrays,
    table_rows,
)
from tpupt_torch.core.vec import Vec3
from tpupt_torch.scene.bake import world_slot_tris

BIG_T = 3.0e38


def _sphere_roots(scene, o: int, prim: int, ro: Vec3, rd: Vec3, t_min, t_bound):
    """The object-space quadratic of sphere object ``o``: the ray goes to
    object space with a normalized direction and the t window is checked in
    object units.  Returns (hit, t_obj, object-space origin, direction,
    centre, radius)."""
    inv_m = scene.obj_inv_m[o]
    center = Vec3(*scene.sphere_center[prim].unbind())
    radius = scene.sphere_radius[prim]

    oo = vec.transform_point(inv_m, ro)
    od = vec.transform_vector(inv_m, rd).normalize()
    oc = oo - center
    a = od.dot(od)
    b = 2.0 * od.dot(oc)
    c = oc.dot(oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    use1 = (t1 >= t_min) & (t1 <= t_bound)
    use2 = (t2 >= t_min) & (t2 <= t_bound)
    hit = (disc >= 0.0) & (use1 | use2)
    return hit, torch.where(use1, t1, t2), oo, od, center, radius


def _sphere_candidate(scene, o: int, prim: int, ro: Vec3, rd: Vec3, t_min, t_bound):
    """Object-space quadratic sphere test with the reference's semantics
    (``_sphere_roots``); the winning t is re-measured in world units as
    |world point - origin|.  Returns (hit, t_w, world point, world normal,
    front)."""
    hit, t_obj, oo, od, center, radius = _sphere_roots(scene, o, prim, ro, rd, t_min, t_bound)
    point_obj = oo + od * t_obj
    point_w = vec.transform_point(scene.obj_m[o], point_obj)
    t_w = (point_w - ro).length()

    outward = (point_obj - center) * (1.0 / radius)
    front = od.dot(outward) < 0.0
    normal_obj = vec.where(front, outward, -outward)
    normal_w = vec.transform_normal(scene.obj_inv_m[o], normal_obj)
    return hit, t_w, point_w, normal_w, front


def _sphere_pass(scene, ro: Vec3, rd: Vec3, t_min, active, t_best, kind, obj_id, prim_id):
    """Scan over the sphere objects; also folds the forward hit record
    (point, normal, front, material)."""
    n = t_best.shape[0]
    dev = t_best.device
    point = Vec3.full((n,), 0.0, 0.0, 0.0, device=dev)
    normal = Vec3.full((n,), 0.0, 0.0, 0.0, device=dev)
    front = torch.zeros((n,), dtype=torch.bool, device=dev)
    mat = torch.zeros((n,), dtype=torch.int64, device=dev)
    for o, (okind, oprim) in enumerate(zip(scene.s_obj_kind, scene.s_obj_prim)):
        if okind != OBJ_SPHERE:
            continue
        hit, t_w, pw, nw, fr = _sphere_candidate(scene, o, oprim, ro, rd, t_min, t_best)
        take = active & hit
        t_best = torch.where(take, t_w, t_best)
        kind = torch.where(take, PRIM_SPHERE, kind)
        obj_id = torch.where(take, o, obj_id)
        prim_id = torch.where(take, oprim, prim_id)
        point = vec.where(take, pw, point)
        normal = vec.where(take, nw, normal)
        front = torch.where(take, fr, front)
        mat = torch.where(take, scene.obj_mat[o].long(), mat)
    return t_best, kind, obj_id, prim_id, point, normal, front, mat


def _has_mesh(scene) -> bool:
    return any(k == OBJ_MESH for k in scene.s_obj_kind)


def _blank_ids(n, dev):
    return (
        torch.full((n,), BIG_T, device=dev),
        torch.full((n,), PRIM_NONE, dtype=torch.int32, device=dev),
        torch.full((n,), -1, dtype=torch.int64, device=dev),
        torch.full((n,), -1, dtype=torch.int64, device=dev),
    )


@torch.no_grad()
def intersect_scene_ids(scene: SceneArrays, ro: Vec3, rd: Vec3, t_min, active,
                        closest_hit=None):
    """Discrete closest-hit pass.  Returns (ids, forward Hit).

    ``closest_hit`` picks the treelet sweep (see
    ``packets.intersect_treelets``); the default is the CUDA kernel on the
    card and its twin on the CPU."""
    n = ro.x.shape[0]
    sphere = _sphere_pass(scene, ro, rd, t_min, active, *_blank_ids(n, ro.x.device))
    mesh = None
    if _has_mesh(scene):
        mesh = intersect_treelets(scene, ro, rd, t_min, sphere[0], active,
                                  closest_hit=closest_hit)
    return hit_record(scene, ro, rd, sphere, mesh)


def hit_record(scene: SceneArrays, ro: Vec3, rd: Vec3, sphere, mesh):
    """The forward pass's (ids, Hit) from the sphere pass's fold
    (``_sphere_pass``'s 8-tuple) and the sweep's winner (``mesh`` = (t,
    slot, extras) of ``packets.intersect_treelets``, or None for a scene
    without meshes): the triangle half of the hit record."""
    t_best, kind, obj_id, prim_id, point, normal, front, mat = sphere
    if mesh is not None:
        t_mesh, slot, ex = mesh
        take = slot >= 0
        t_best = torch.where(take, t_mesh, t_best)
        kind = torch.where(take, PRIM_TRIANGLE, kind)
        obj_w = torch.clamp(ex["obj"].long(), min=0)
        obj_id = torch.where(take, obj_w, obj_id)
        safe = torch.clamp(slot, min=0).long()
        prim_id = torch.where(take, scene.slot_src[safe].long(), prim_id)
        # forward triangle hit record: point = ray(t), outward =
        # normalize(cross(e1, e2)), flipped to face the ray
        outward = Vec3(ex["nx"], ex["ny"], ex["nz"]).normalize()
        tri_front = rd.dot(outward) < 0.0
        tri_normal = vec.where(tri_front, outward, -outward)
        tri_point = ro + rd * t_mesh
        point = vec.where(take, tri_point, point)
        normal = vec.where(take, tri_normal, normal)
        front = torch.where(take, tri_front, front)
        mat = torch.where(take, scene.obj_mat[obj_w].long(), mat)

    mask = kind != PRIM_NONE
    fwd = Hit(
        mask=mask,
        t=torch.where(mask, t_best, BIG_T),
        point=point,
        normal=normal,
        front=front & mask,
        mat_id=mat,
    )
    ids = HitIds(kind=kind, obj_id=obj_id, prim_id=prim_id, t=t_best)
    return ids, fwd


@torch.no_grad()
def intersect_scene_ids_diff(scene: SceneArrays, ro: Vec3, rd: Vec3, t_min, active,
                             closest_hit=None):
    """The differentiable renderer's ids pass.  Returns (ids, tri_vals).

    Like ``intersect_scene_ids`` without the forward hit record, and the
    sweep runs in its payload form: ``tri_vals`` = {slot, p0x..e2z} holds
    the winning triangle's world rows (the unit triangle where no triangle
    won), or is None for a scene without meshes.  ``ids.prim_id`` keeps its
    sphere-pass value on triangle lanes.  Nothing here is seen by autograd.

    The caller traces a scene rebaked from its positions
    (``scene.bake.rebake_treelets``), so the payload is a copy of the rows
    of ``slot_tri_table(scene)``."""
    n = ro.x.shape[0]
    t_best, kind, obj_id, prim_id = _blank_ids(n, ro.x.device)
    t_best, kind, obj_id, prim_id, *_ = _sphere_pass(
        scene, ro, rd, t_min, active, t_best, kind, obj_id, prim_id
    )
    tri_vals = None
    if _has_mesh(scene):
        t_mesh, slot, ex = intersect_treelets(
            scene, ro, rd, t_min, t_best, active, closest_hit=closest_hit, diff_payload=True
        )
        take = slot >= 0
        t_best = torch.where(take, t_mesh, t_best)
        kind = torch.where(take, PRIM_TRIANGLE, kind)
        obj_id = torch.where(take, torch.clamp(ex["obj"].long(), min=0), obj_id)
        tri_vals = {"slot": slot, **{k: ex[k] for k in _DIFF_KEYS}}
    return HitIds(kind=kind, obj_id=obj_id, prim_id=prim_id, t=t_best), tri_vals


@torch.no_grad()
def intersect_scene_ids_bvh(scene: SceneArrays, ro: Vec3, rd: Vec3, t_min, active):
    """The per-ray stackless-BVH closest hit (``accel.traverse``): the
    semantic reference of the treelet sweep, sharing neither its code nor
    its visit order.  Returns (ids, None): no forward hit, the integrator
    refines the hit from the ids.  Plug into the integrator via
    ``intersect_fn``."""
    n = ro.x.shape[0]
    t_best, kind, obj_id, prim_id = _blank_ids(n, ro.x.device)
    t_best, kind, obj_id, prim_id, *_ = _sphere_pass(
        scene, ro, rd, t_min, active, t_best, kind, obj_id, prim_id
    )
    ro_a, rd_a = ro.to_array(), rd.to_array()
    for o, (okind, oprim) in enumerate(zip(scene.s_obj_kind, scene.s_obj_prim)):
        if okind != OBJ_MESH:
            continue
        t_new, tri_local, _ = traverse_mesh(
            scene, scene.s_mesh_root[oprim], scene.obj_m[o], scene.obj_inv_m[o], ro_a, rd_a,
            t_min, t_best, torch.full_like(prim_id, -1), active,
        )
        take = tri_local >= 0
        t_best = torch.where(take, t_new, t_best)
        kind = torch.where(take, PRIM_TRIANGLE, kind)
        obj_id = torch.where(take, o, obj_id)
        prim_id = torch.where(take, tri_local, prim_id)
    return HitIds(kind=kind, obj_id=obj_id, prim_id=prim_id, t=t_best), None


# a reference intersector: renders through it trace their shadow rays by
# its closest hit (integrator._closest_hit_shadows)
intersect_scene_ids_bvh.closest_hit_shadows = True


@torch.no_grad()
def sphere_occlusion(scene: SceneArrays, ro: Vec3, rd: Vec3, t_min, t_limit, active, exclude_obj):
    """The sphere half of the shadow test: True where a sphere object other
    than ``exclude_obj`` hits an active lane's ray at t in [t_min,
    t_limit], by the closest-hit pass's quadratic.

    ``exclude_obj`` is an int, the same light for every lane (its sphere
    test is skipped), or a per-lane tensor (the test runs and is masked
    per lane); -1 excludes nothing."""
    static_ex = isinstance(exclude_obj, int)
    occ = torch.zeros_like(active)
    for o, (okind, oprim) in enumerate(zip(scene.s_obj_kind, scene.s_obj_prim)):
        if okind != OBJ_SPHERE or (static_ex and o == exclude_obj):
            continue
        take = active & _sphere_roots(scene, o, oprim, ro, rd, t_min, t_limit)[0]
        occ = occ | (take if static_ex else take & (exclude_obj != o))
    return occ


@torch.no_grad()
def occlusion_anyhit(scene: SceneArrays, ro: Vec3, rd: Vec3, t_min, t_limit, active,
                     exclude_obj, any_hit=None):
    """The shadow test: True where some geometry other than sphere object
    ``exclude_obj`` (the sampled light; as ``sphere_occlusion`` takes it)
    hits an active lane's ray at t in [t_min, t_limit].

    Spheres run ``sphere_occlusion``; meshes run the any-hit sweep
    (``packets.intersect_treelets_anyhit``, with ``any_hit`` as there) on
    the lanes no sphere occludes.  Nothing here is seen by autograd."""
    occ = sphere_occlusion(scene, ro, rd, t_min, t_limit, active, exclude_obj)
    if _has_mesh(scene):
        occ = occ | intersect_treelets_anyhit(scene, ro, rd, t_min, t_limit, active & ~occ,
                                              any_hit=any_hit)
    return occ


def slot_tri_table(scene: SceneArrays) -> torch.Tensor:
    """The (K*L, 9) slot-ordered [p0, e1, e2] world triangle table,
    differentiable in ``scene.positions``: the rows the sweep's payload
    copies and the target ``_FetchTriRows`` scatters cotangents into.
    Built once per sample."""
    w0, w1, w2, _pad = world_slot_tris(scene)
    we1, we2 = w1 - w0, w2 - w0
    return torch.stack([*w0, *we1, *we2], dim=1)


class _FetchTriRows(torch.autograd.Function):
    """The winner rows "fetched" from the slot table.

    Forward: (wtable (K*L, 9), slot (N,), *vals) -> vals, the 9 (N,)
    components the sweep already copied out of the rebaked table, so there
    is no forward gather.  Backward: the VJP of the row gather
    ``wtable[clamp(slot, 0)]`` on the lanes with a triangle (a lane with
    slot -1 has a zero cotangent: ``refine_hit`` selects its other
    branch), ``accel.slot_scatter`` of the stacked (N, 9) cotangent;
    ``slot`` and ``vals`` get none."""

    @staticmethod
    def forward(ctx, wtable, slot, *vals):
        ctx.save_for_backward(slot)
        ctx.rows = wtable.shape[0]
        return vals

    @staticmethod
    def backward(ctx, *cots):
        (slot,) = ctx.saved_tensors
        cot = torch.stack(cots, dim=1)
        g = cot.new_zeros((ctx.rows, cot.shape[1]))
        slot_scatter(g, slot, cot)
        return (g, None) + (None,) * len(cots)


def refine_hit(scene: SceneArrays, ro: Vec3, rd: Vec3, t_min, ids: HitIds,
               tri_vals=None) -> Hit:
    """Differentiable closed-form recomputation of the winning hit, as the
    JAX package's ``refine_hit``.  ``tri_vals`` is the ids pass's payload,
    optionally with "table" = ``slot_tri_table(scene)`` built once by the
    caller; without it a triangle comes from ``ids.prim_id`` (the global
    triangle) and ``ids.obj_id``.

    Both branches run on every lane and ``ids.kind`` selects, so the
    unselected one must stay finite: the sphere root takes
    sqrt(max(disc, 1e-12)) and the triangle's determinant is floored at
    1e-12 in magnitude."""
    n = ro.x.shape[0]
    dev = ro.x.device
    mask = ids.kind != PRIM_NONE
    safe_obj = torch.clamp(ids.obj_id, min=0).long()
    safe_prim = torch.clamp(ids.prim_id, min=0).long()
    m = scene.obj_m[safe_obj]
    inv_m = scene.obj_inv_m[safe_obj]

    # --- sphere branch -------------------------------------------------
    s_prim = torch.where(ids.kind == PRIM_SPHERE, safe_prim, 0)
    center = Vec3(*table_rows(scene.sphere_center, s_prim).unbind(1))
    radius = table_rows(scene.sphere_radius, s_prim)
    oo = vec.transform_point(inv_m, ro)
    od = vec.transform_vector(inv_m, rd).normalize()
    oc = oo - center
    a = od.dot(od)
    b = 2.0 * od.dot(oc)
    c = oc.dot(oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    # the ids pass took t1 when it was in the window; t1 <= t2
    t_obj = torch.where(t1 >= t_min, t1, t2)
    sp_point_obj = oo + od * t_obj
    sp_point = vec.transform_point(m, sp_point_obj)
    sp_t = (sp_point - ro).length()
    sp_outward = (sp_point_obj - center) * (1.0 / radius)
    sp_front = od.dot(sp_outward) < 0.0
    sp_normal = vec.transform_normal(inv_m, vec.where(sp_front, sp_outward, -sp_outward))

    # --- triangle branch -----------------------------------------------
    if _has_mesh(scene) and tri_vals is not None:
        wtable = tri_vals.get("table")
        if wtable is None:
            wtable = slot_tri_table(scene)
        f = _FetchTriRows.apply(wtable, tri_vals["slot"], *(tri_vals[k] for k in _DIFF_KEYS))
        p0, e1, e2 = Vec3(*f[0:3]), Vec3(*f[3:6]), Vec3(*f[6:9])
    elif _has_mesh(scene):
        # from the ids alone (the reference intersectors): the global
        # triangle's vertices through its object's matrix, the same
        # arithmetic as the slot table's rows
        t_prim = torch.where(ids.kind == PRIM_TRIANGLE, safe_prim, 0)
        tri = scene.tri_idx.long()[t_prim]

        def corner(c):
            p = scene.positions.index_select(0, tri[:, c])
            return vec.transform_point(m, Vec3(*p.unbind(1)))

        p0 = corner(0)
        e1, e2 = corner(1) - p0, corner(2) - p0
    else:
        zf = torch.zeros((n,), device=dev)
        p0, e1, e2 = Vec3(zf, zf, zf), Vec3(zf, zf + 1.0, zf), Vec3(zf, zf, zf + 1.0)
    h = rd.cross(e2)
    det = e1.dot(h)
    f = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    q = (ro - p0).cross(e1)
    tr_t = f * e2.dot(q)
    tr_point = ro + rd * tr_t
    tr_outward = e1.cross(e2).normalize()
    tr_front = rd.dot(tr_outward) < 0.0
    tr_normal = vec.where(tr_front, tr_outward, -tr_outward)

    # --- select --------------------------------------------------------
    is_tri = ids.kind == PRIM_TRIANGLE
    zero = Vec3.full((n,), 0.0, 0.0, 0.0, device=dev)
    return Hit(
        mask=mask,
        t=torch.where(mask, torch.where(is_tri, tr_t, sp_t), BIG_T),
        point=vec.where(mask, vec.where(is_tri, tr_point, sp_point), zero),
        normal=vec.where(mask, vec.where(is_tri, tr_normal, sp_normal), zero),
        front=torch.where(is_tri, tr_front, sp_front) & mask,
        mat_id=torch.where(mask, scene.obj_mat[safe_obj].long(), 0),
    )


def background_color(scene: SceneArrays, rd: Vec3) -> Vec3:
    """Sky gradient lerp(bg_down -> bg_up) over the unit direction's y."""
    unit = rd.normalize()
    t = 0.5 * (unit.y + 1.0)
    down, up = scene.bg_down, scene.bg_up
    return Vec3(
        down[0] + t * (up[0] - down[0]),
        down[1] + t * (up[1] - down[1]),
        down[2] + t * (up[2] - down[2]),
    )
