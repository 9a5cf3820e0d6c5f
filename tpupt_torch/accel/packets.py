"""Packet-treelet intersection (counterpart of ``tpupt/accel/packets.py``):
the closest hit, and the any-hit occlusion test of shadow rays.

Rays are folded into packets of 256 lanes.  Each packet walks the world
treelet table front to back:

  cull   a treelet's packet entry distance is the min over live lanes of
         max(near, 0) of the lane's slab test, or BIG when no live lane can
         improve on its seed t (``_entry_dense``).  Above
         ``_TWOLEVEL_MIN_K`` treelets the packet first tests 16-treelet
         super-boxes and keeps child entries only under a hit super
         (``_cull_entries``, the JAX package's two-level cull);
  sweep  the packet takes its remaining treelets in strictly increasing
         (entry, index) order, one per step, runs Möller–Trumbore (MT) on
         all 256 x L pairs and keeps a running closest hit; it stops once
         the next entry lies beyond every live lane's best t.

Within a treelet the earliest triangle wins an exact-t tie; across
treelets a later visit replaces an equal t (``t <= best``).  That is the
sequential visit order the JAX package's sweep reproduces with its
reverse-fetch winner reduce, so slots agree with it exactly.  The JAX
package's compaction ladder, fetch-R batching and lex/super selection are
scheduling that leaves its results unchanged; the port keeps the flat
semantics.

The work is done by ``sweep_kernel.treelet_closest_hit`` (and
``treelet_any_hit`` for shadow rays): a hand-written CUDA kernel for CUDA
tensors, and for CPU tensors its plain twin, a lockstep loop built from
the pieces in this module.
"""

from __future__ import annotations

import torch

from tpupt_torch.core.vec import Vec3

PACKET = 256  # rays per packet = threads per CUDA block
BIG = 3.0e38
MOLLER_EPS = 1e-7  # reference EPSILON
_SUPER = 16  # treelets per super-box of the two-level cull
_TWOLEVEL_MIN_K = 96  # the two-level cull runs from this treelet count on
# (packets x lanes x treelets) elements per chunk of the dense cull
_CULL_ELEMS = 1 << 22
# per-lane ray rows the kernels take, in their argument order
_ROW_KEYS = ("rox", "roy", "roz", "rdx", "rdy", "rdz", "tmin", "t")
# the winner's world triangle, block components 0-8: the differentiable
# renderer's payload (extras keys of intersect_treelets(diff_payload=True))
_DIFF_KEYS = ("p0x", "p0y", "p0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def _pack_rows(ro: Vec3, rd: Vec3, t_min, t_cap, active):
    """Pad the flat ray batch to a packet multiple and fold it to
    (np, PACKET) rows.  ``t_cap`` is the per-lane seed best t; dead and pad
    lanes get -BIG so they never keep a packet alive."""
    n = ro.x.shape[0]
    pad = (-n) % PACKET

    def padded(a, fill):
        a = a.contiguous()
        return torch.cat([a, a.new_full((pad,), fill)]) if pad else a

    shp = ((n + pad) // PACKET, PACKET)
    rows = dict(
        rox=padded(ro.x, 0.0).view(shp), roy=padded(ro.y, 0.0).view(shp),
        roz=padded(ro.z, 0.0).view(shp),
        rdx=padded(rd.x, 1.0).view(shp), rdy=padded(rd.y, 1.0).view(shp),
        rdz=padded(rd.z, 1.0).view(shp),
        tmin=padded(t_min, 0.0).view(shp),
    )
    act_p = padded(active, False).view(shp)
    rows["t"] = torch.where(act_p, padded(t_cap, -BIG).view(shp), -BIG)
    return rows, act_p


def _entry_dense(bmin, bmax, rows, act_p):
    """Dense packet-vs-box cull: (np, K) per-packet entry distance per box,
    BIG where no live lane hits.  Chunked over packets so a 1024² batch
    fits in memory; the min over lanes makes the chunking exact."""
    np_, p = rows["rox"].shape
    kb = bmin.shape[0]
    chunk = max(1, _CULL_ELEMS // (p * kb))
    out = []
    for c0 in range(0, np_, chunk):
        sl = slice(c0, c0 + chunk)

        def near_far(axis, o, d):
            iv = (1.0 / rows[d][sl])[:, :, None]
            o = rows[o][sl][:, :, None]
            t0 = (bmin[:, axis][None, None, :] - o) * iv
            t1 = (bmax[:, axis][None, None, :] - o) * iv
            return torch.minimum(t0, t1), torch.maximum(t0, t1)

        nx0, fx0 = near_far(0, "rox", "rdx")
        ny0, fy0 = near_far(1, "roy", "rdy")
        nz0, fz0 = near_far(2, "roz", "rdz")
        near = torch.maximum(torch.maximum(nx0, ny0), nz0)  # (c, p, K)
        far = torch.minimum(torch.minimum(fx0, fy0), fz0)
        hit = (
            (far >= near)
            & (far >= rows["tmin"][sl][:, :, None])
            & (near <= rows["t"][sl][:, :, None])
            & act_p[sl][:, :, None]
        )
        out.append(torch.where(hit, torch.clamp(near, min=0.0), BIG).amin(dim=1))
    return torch.cat(out)


def _super_boxes(bmin, bmax):
    """(ks, 3) min and max corners of the _SUPER-treelet super-boxes; the
    table is padded to a _SUPER multiple with empty boxes (min BIG, max
    -BIG) that never widen a super."""
    pad = (-bmin.shape[0]) % _SUPER
    bmin = torch.cat([bmin, bmin.new_full((pad, 3), BIG)])
    bmax = torch.cat([bmax, bmax.new_full((pad, 3), -BIG)])
    return bmin.view(-1, _SUPER, 3).amin(dim=1), bmax.view(-1, _SUPER, 3).amax(dim=1)


def _cull_entries(bmin, bmax, rows, act_p, stats=None):
    """(np, K) packet entry distances of the JAX package's cull
    (``tpupt/accel/packets.py`` ``_cull_entries``): ``_entry_dense`` below
    _TWOLEVEL_MIN_K treelets; from there on the two-level cull, whose
    entries are ``_entry_dense``'s under a super-box the packet hits and BIG
    elsewhere.  That masked form gives ``_entry_twolevel``'s values, also
    where a ray with a zero direction component starts exactly on a
    super-box plane (a NaN slab test, the caveat in its docstring).

    ``stats``, when a dict, gains the work a two-level cull needs on these
    inputs: ``live_lanes``, ``supers_hit`` (summed over packets) and
    ``slab_tests`` (per live lane: every super, then every child of a hit
    super; every box when dense)."""
    K = bmin.shape[0]
    entry = _entry_dense(bmin, bmax, rows, act_p)
    live = act_p.sum(dim=1)
    if K < _TWOLEVEL_MIN_K:
        if stats is not None:
            stats.update(live_lanes=int(live.sum()), supers_hit=0,
                         slab_tests=int(live.sum()) * K)
        return entry
    hit = _entry_dense(*_super_boxes(bmin, bmax), rows, act_p) < BIG  # (np, ks)
    if stats is not None:
        children = torch.full((hit.shape[1],), _SUPER, device=hit.device)
        children[-1] = K - _SUPER * (hit.shape[1] - 1)
        stats.update(
            live_lanes=int(live.sum()), supers_hit=int(hit.sum()),
            slab_tests=int(live.sum()) * hit.shape[1]
            + int((live * (hit.long() * children).sum(dim=1)).sum()),
        )
    return torch.where(hit.repeat_interleave(_SUPER, dim=1)[:, :K], entry, BIG)


def _dense_mt(tri, ray, t_cap):
    """Möller–Trumbore, component-wise, in the JAX package's operation
    order.  ``tri`` = (p0x, p0y, p0z, e1x, ..., e2z), each broadcastable to
    the pair shape; ``ray`` holds rox..rdz and tmin likewise.  Returns
    (ok, t); ``ok`` excludes pair liveness, which callers add."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    ox, oy, oz = ray["rox"], ray["roy"], ray["roz"]
    dx, dy, dz = ray["rdx"], ray["rdy"], ray["rdz"]

    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(a.abs() < MOLLER_EPS, 1.0, a)
    sx, sy, sz_ = ox - p0x, oy - p0y, oz - p0z
    u = f * (sx * hx + sy * hy + sz_ * hz)
    qx = sy * e1z - sz_ * e1y
    qy = sz_ * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    # v >= 0 and u + v <= 1 imply u <= 1
    ok = (
        (a.abs() >= MOLLER_EPS)
        & (u >= 0.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= ray["tmin"])
        & (t <= t_cap)
    )
    return ok, t


def _winner_fold(t_masked, slots, cnx, cny, cnz, cobj):
    """Closest pair per lane over dim 1 of a (sz, RL, p) pair tensor, the
    earliest pair winning an exact-t tie (a strict-`<` fold from BIG); the
    payloads are (sz, RL).  Returns (t, slot, nx, ny, nz, obj), each
    (sz, p): t is BIG and the rest (0, 0, 0, 0, -1) where no pair hit."""
    t_b, j = torch.min(t_masked, dim=1)  # first index on ties
    got = t_b < BIG

    def pick(c, none):
        return torch.where(got, torch.gather(c, 1, j), none)

    return (t_b, pick(slots, 0), pick(cnx, 0.0), pick(cny, 0.0), pick(cnz, 0.0),
            pick(cobj, -1.0))


def intersect_treelets(scene, ro: Vec3, rd: Vec3, t_min, t_seed, active,
                       closest_hit=None, diff_payload=False):
    """Closest mesh hit for every ray.

    Returns (t (N,), slot (N,) global treelet-slot id or -1, extras) with
    ``extras`` = {nx, ny, nz: the winner's unnormalized cross(e1, e2)
    normal, obj: its object id as float32, -1 for no hit}.  Lanes without a
    hit keep their seed t (-BIG for inactive lanes).  ``diff_payload`` adds
    the winner's world triangle under ``_DIFF_KEYS`` (p0, e1, e2; the unit
    triangle e1 = x, e2 = y where no triangle won, so the differentiable
    refine stays NaN-free).  ``closest_hit`` defaults to
    ``sweep_kernel.treelet_closest_hit``; pass ``treelet_closest_hit_plain``
    to run the twin on any device.
    """
    if closest_hit is None:
        from tpupt_torch.accel.sweep_kernel import treelet_closest_hit as closest_hit
    n = ro.x.shape[0]
    rows, act_p = _pack_rows(ro, rd, t_min, t_seed, active)
    args = (rows, act_p, scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
    out = closest_hit(*args, payload=True) if diff_payload else closest_hit(*args)
    t, slot = out[:2]
    keys = ("nx", "ny", "nz", "obj") + (_DIFF_KEYS if diff_payload else ())
    extras = {k: v.reshape(-1)[:n] for k, v in zip(keys, out[2:])}
    return t.reshape(-1)[:n], slot.reshape(-1)[:n], extras


def intersect_treelets_anyhit(scene, ro: Vec3, rd: Vec3, t_min, t_limit, active, any_hit=None):
    """Any-hit occlusion: True where an active lane's ray hits some
    triangle at t in [t_min, t_limit] (both ends closed, as in
    ``_dense_mt``).

    The shadow-ray form of the walk: the t cap is the window end, an
    occluded lane's t becomes -BIG (which takes it out of the packet's
    liveness and of every later pair test), and a packet is done once its
    next entry lies beyond every unoccluded lane's t.  ``any_hit`` defaults
    to ``sweep_kernel.treelet_any_hit``; pass ``treelet_any_hit_plain`` to
    run the twin on any device."""
    if any_hit is None:
        from tpupt_torch.accel.sweep_kernel import treelet_any_hit as any_hit
    n = ro.x.shape[0]
    rows, act_p = _pack_rows(ro, rd, t_min, t_limit, active)
    occ = any_hit(rows, act_p, scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
    return occ.reshape(-1)[:n]
