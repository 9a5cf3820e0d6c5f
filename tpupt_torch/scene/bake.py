"""Re-baking the world-space treelet table from the scene's vertex
positions (counterpart of ``tpupt/scene/bake.py``).

The treelet sweep traces world-space triangle data baked at scene build
(``accel/treelets.py``).  ``rebake_treelets`` recomputes it on the scene's
device from the current ``positions`` and object transforms: which triangle
sits in which slot is kept, only the numbers are refreshed.  It is plain
torch and differentiable in ``positions``; the differentiable renderer
rebakes at the start of every sample, so the sweep's winner payload is a
copy of the rows of ``render.intersect.slot_tri_table``, the table the
backward pass scatters vertex cotangents into.
"""

from __future__ import annotations

import dataclasses

import torch

from tpupt_torch.accel.treelets import BLOCK_COMPONENTS
from tpupt_torch.core import vec
from tpupt_torch.core.types import SceneArrays
from tpupt_torch.core.vec import Vec3

_FAR = 3.0e37  # pad triangles sit out here and are never hit


def world_slot_tris(scene: SceneArrays):
    """World-space triangle vertices in SLOT order, differentiable in
    ``scene.positions``.

    Returns (w0, w1, w2, pad): Vec3s of (K*L,) world vertices per treelet
    slot, and the (K*L,) mask of pad slots (whose vertices are those of
    triangle 0 of object 0 and mean nothing)."""
    pad = scene.slot_src < 0
    src = scene.slot_src.clamp(min=0).long()
    obj = scene.slot_obj.clamp(min=0).long()
    tri = scene.tri_idx.long()[src]  # (K*L, 3)
    m = scene.obj_m[obj]  # (K*L, 4, 4)

    def corner(c):
        # index_select: its backward adds with index_add_, where the VJP of
        # indexing would sum the pad slots' thousands of copies of one
        # vertex serially
        p = scene.positions.index_select(0, tri[:, c])
        return vec.transform_point(m, Vec3(*p.unbind(1)))

    return corner(0), corner(1), corner(2), pad


def rebake_treelets(scene: SceneArrays) -> SceneArrays:
    """The scene with ``tre_tris``, ``tre_min`` and ``tre_max`` recomputed
    from its positions, in the build-time packing: per treelet 13
    component-major runs of L floats [p0, e1, e2, cn = cross(e1, e2), obj],
    pad slots at p0 = 3e37 with zero edges and obj -1; boxes over the valid
    slots."""
    K, ncols = scene.tre_tris.shape
    L = scene.s_leaf_size
    if ncols != BLOCK_COMPONENTS * L:
        raise ValueError(f"tre_tris has {ncols} columns, expected {BLOCK_COMPONENTS} x {L}")

    obj = scene.slot_obj.clamp(min=0)
    w0, w1, w2, pad = world_slot_tris(scene)
    far = Vec3.full(pad.shape, _FAR, _FAR, _FAR, device=pad.device)
    zero = Vec3.full(pad.shape, 0.0, 0.0, 0.0, device=pad.device)
    p0 = vec.where(pad, far, w0)
    e1 = vec.where(pad, zero, w1 - w0)
    e2 = vec.where(pad, zero, w2 - w0)
    cn = e1.cross(e2)  # zero on pad slots
    obj_col = torch.where(pad, -1.0, obj.to(torch.float32))
    comps = [*p0, *e1, *e2, *cn, obj_col]
    tre_tris = torch.cat([c.reshape(K, L) for c in comps], dim=1)

    def minmax(c0, c1, c2):
        lo = torch.minimum(torch.minimum(c0, c1), c2)
        hi = torch.maximum(torch.maximum(c0, c1), c2)
        lo = torch.where(pad, _FAR, lo).reshape(K, L).amin(dim=1)
        hi = torch.where(pad, -_FAR, hi).reshape(K, L).amax(dim=1)
        return lo, hi

    (x0, x1), (y0, y1), (z0, z1) = (minmax(w0[a], w1[a], w2[a]) for a in range(3))
    return dataclasses.replace(
        scene, tre_tris=tre_tris,
        tre_min=torch.stack([x0, y0, z0], dim=1), tre_max=torch.stack([x1, y1, z1], dim=1),
    )
