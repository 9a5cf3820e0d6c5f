"""Scene-level closest-hit intersection, forward only (counterpart of
``tpupt/render/intersect.py``).

Spheres: an unrolled scan over the sphere objects (the reference's object
loop; a later equal-t hit overwrites an earlier one).  Meshes: the packet
treelet sweep (``accel/packets.py``) over the world-baked treelet table,
seeded with the sphere pass's t so treelets behind a sphere hit are
skipped.  The winner's normal and object id come out of the sweep with it.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel.packets import intersect_treelets
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
)
from tpupt_torch.core.vec import Vec3

BIG_T = 3.0e38


def _sphere_candidate(scene, o: int, prim: int, ro: Vec3, rd: Vec3, t_min, t_bound):
    """Object-space quadratic sphere test with the reference's semantics:
    the ray goes to object space with a normalized direction, the t window
    is checked in object units, and the winning t is re-measured in world
    units as |world point - origin|.  Returns (hit, t_w, world point, world
    normal, front)."""
    inv_m = scene.obj_inv_m[o]
    m = scene.obj_m[o]
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
    t_obj = torch.where(use1, t1, t2)
    hit = (disc >= 0.0) & (use1 | use2)

    point_obj = oo + od * t_obj
    point_w = vec.transform_point(m, point_obj)
    t_w = (point_w - ro).length()

    outward = (point_obj - center) * (1.0 / radius)
    front = od.dot(outward) < 0.0
    normal_obj = vec.where(front, outward, -outward)
    normal_w = vec.transform_normal(inv_m, normal_obj)
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


@torch.no_grad()
def intersect_scene_ids(scene: SceneArrays, ro: Vec3, rd: Vec3, t_min, active,
                        closest_hit=None):
    """Discrete closest-hit pass.  Returns (ids, forward Hit).

    ``closest_hit`` picks the treelet sweep (see
    ``packets.intersect_treelets``); the default is the CUDA kernel on the
    card and its twin on the CPU."""
    n = ro.x.shape[0]
    dev = ro.x.device
    t_best = torch.full((n,), BIG_T, device=dev)
    kind = torch.full((n,), PRIM_NONE, dtype=torch.int32, device=dev)
    obj_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prim_id = torch.full((n,), -1, dtype=torch.int64, device=dev)

    t_best, kind, obj_id, prim_id, point, normal, front, mat = _sphere_pass(
        scene, ro, rd, t_min, active, t_best, kind, obj_id, prim_id
    )

    if any(k == OBJ_MESH for k in scene.s_obj_kind):
        t_mesh, slot, ex = intersect_treelets(
            scene, ro, rd, t_min, t_best, active, closest_hit=closest_hit
        )
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
