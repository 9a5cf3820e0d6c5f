"""Stackless per-ray BVH traversal (counterpart of
``tpupt/accel/traverse.py``): the reference oracle of the treelet sweep.

The BVH is flattened depth-first with skip links (``accel/bvh.py``), so a
ray's traversal state is one node index:

    hit inner node  -> next = node + 1          (first child, pre-order)
    miss / leaf     -> next = skip[node]        (-1 terminates)

``traverse_mesh`` steps a flat ray batch until every lane has terminated,
each step over the lanes still walking.  The box test is bounded by
[t_min, t_best] in object space with the unnormalized object-space
direction, so object t is world t; triangles are tested in world space
against the world ray, and an equal t overwrites (``t <= t_best``).
Nothing here shares code or visit order with the treelet sweep.

Rays and points are (..., 3) tensors here, as in the JAX module.
"""

from __future__ import annotations

import torch

MOLLER_EPS = 1e-7  # reference EPSILON


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _transform(m, p, w):
    """(4, 4) affine ``m`` applied to (..., 3) points (``w`` 1) or
    directions (``w`` 0), summed in ``vec.transform_point``'s order."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rows = [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z for i in range(3)]
    return torch.stack([r + m[i, 3] for i, r in enumerate(rows)] if w else rows, dim=-1)


def moller_trumbore(ro, rd, p0, p1, p2, t_min, t_max):
    """Batched Moller-Trumbore (reference ray_triangle_intersection_test).
    Returns (valid, t)."""
    e1 = p1 - p0
    e2 = p2 - p0
    h = _cross(rd, e2)
    a = _dot(e1, h)
    parallel = a.abs() < MOLLER_EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = ro - p0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(rd, q)
    t = f * _dot(e2, q)
    valid = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= t_min) & (t <= t_max))
    return valid, t


def _slab_test(oo, inv_d, bmin, bmax, t_min, t_max):
    """Bounded slab test in object space (world-t parametrization)."""
    t0 = (bmin - oo) * inv_d
    t1 = (bmax - oo) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return (far >= near) & (far >= t_min) & (near <= t_max)


@torch.no_grad()
def traverse_mesh(scene, root: int, m, inv_m, ro, rd, t_min, t_best, tri_best, active,
                  max_steps: int | None = None):
    """Closest-hit traversal of one mesh instance for a flat ray batch.

    ``root`` is the mesh's absolute root node; ``m``/``inv_m`` its (4, 4)
    object-to-world matrix and inverse; ``ro``/``rd`` (N, 3) world rays;
    ``t_best``/``tri_best`` the running closest hit (world t, global
    triangle id or -1); ``active`` (N,) bool, the lanes that traverse.
    Returns updated (t_best, tri_best, steps), steps being the loop's
    iterations."""
    oo = _transform(inv_m, ro, 1)
    inv_d = 1.0 / _transform(inv_m, rd, 0)  # +-inf on zero components is fine
    t_best, tri_best = t_best.clone(), tri_best.clone()
    lane = active.nonzero().flatten()  # the lanes still walking
    node = torch.full_like(lane, root)
    tri_idx, positions = scene.tri_idx.long(), scene.positions
    steps = 0
    while lane.numel() and (max_steps is None or steps < max_steps):
        tri = scene.node_tri[node].long()
        skip = scene.node_skip[node].long()
        leaf = tri >= 0
        # leaf: the world-space triangle test
        lt = lane[leaf]
        w = _transform(m, positions[tri_idx[tri[leaf]]], 1)  # (n, 3, 3)
        ok, t = moller_trumbore(ro[lt], rd[lt], w[:, 0], w[:, 1], w[:, 2], t_min[lt],
                                t_best[lt])
        t_best[lt[ok]] = t[ok]
        tri_best[lt[ok]] = tri[leaf][ok]
        # inner: the bounded slab test in object space
        box_hit = _slab_test(oo[lane], inv_d[lane], scene.node_min[node], scene.node_max[node],
                             t_min[lane], t_best[lane])
        nxt = torch.where(leaf | ~box_hit, skip, node + 1)
        walking = nxt >= 0
        lane, node = lane[walking], nxt[walking]
        steps += 1
    return t_best, tri_best, steps
