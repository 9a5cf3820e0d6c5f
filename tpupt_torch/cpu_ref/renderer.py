"""Brute-force reference renderer (counterpart of
``tpupt/cpu_ref/renderer.py``).

The hit pass tests every triangle of every mesh object: the same
integrator, shading and RNG as ``render_image``, so a disagreement with
the accelerated render isolates the accelerator.  It runs on the scene's
device (the name follows the JAX package's); the work is O(rays x
triangles), in (rays, 512) blocks.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel.traverse import _transform, moller_trumbore
from tpupt_torch.core.types import OBJ_MESH, PRIM_TRIANGLE, HitIds
from tpupt_torch.render.integrator import render_image, trace_sample
from tpupt_torch.render.intersect import BIG_T, _blank_ids, _sphere_pass

_CHUNK = 512  # triangles per block


@torch.no_grad()
def intersect_scene_ids_brute(scene, ro, rd, t_min, active):
    """Exhaustive closest hit with the accelerated path's winner rule: an
    equal t overwrites and objects are scanned in order; within a block the
    lowest triangle id wins a tie.  Returns (ids, None), as
    ``intersect_scene_ids_bvh``."""
    n = ro.x.shape[0]
    t_best, kind, obj_id, prim_id = _blank_ids(n, ro.x.device)
    t_best, kind, obj_id, prim_id, *_ = _sphere_pass(
        scene, ro, rd, t_min, active, t_best, kind, obj_id, prim_id
    )
    ro_a, rd_a = ro.to_array()[:, None], rd.to_array()[:, None]
    for o, (okind, oprim) in enumerate(zip(scene.s_obj_kind, scene.s_obj_prim)):
        if okind != OBJ_MESH:
            continue
        lo, hi = scene.s_mesh_tri_range[oprim]
        for c0 in range(lo, hi, _CHUNK):
            tri_ids = torch.arange(c0, min(c0 + _CHUNK, hi), device=ro.x.device)
            w = _transform(scene.obj_m[o], scene.positions[scene.tri_idx[tri_ids].long()], 1)
            # (N, C) all-pairs test
            ok, t = moller_trumbore(ro_a, rd_a, w[None, :, 0], w[None, :, 1], w[None, :, 2],
                                    t_min[:, None], t_best[:, None])
            t_masked = torch.where(ok, t, BIG_T)
            best_t, best_c = t_masked.min(dim=1)  # the first index on ties
            best_ok = ok.gather(1, best_c[:, None])[:, 0]
            take = active & best_ok & (best_t <= t_best)
            t_best = torch.where(take, best_t, t_best)
            kind = torch.where(take, PRIM_TRIANGLE, kind)
            obj_id = torch.where(take, o, obj_id)
            prim_id = torch.where(take, tri_ids[best_c], prim_id)
    return HitIds(kind=kind, obj_id=obj_id, prim_id=prim_id, t=t_best), None


# a reference intersector: renders through it trace their shadow rays by
# its closest hit (integrator._closest_hit_shadows)
intersect_scene_ids_brute.closest_hit_shadows = True


def render_image_ref(scene, camera, width, height, spp=1, **kw):
    """Reference render: the shared integrator with the brute-force hit
    pass, which also traces NEE's shadow rays (no any-hit sweep runs)."""
    return render_image(scene, camera, width, height, spp,
                        intersect_fn=intersect_scene_ids_brute, **kw)


def trace_sample_ref(scene, camera, width, height, iteration, **kw):
    return trace_sample(scene, camera, width, height, iteration,
                        intersect_fn=intersect_scene_ids_brute, **kw)
