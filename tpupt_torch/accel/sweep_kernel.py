"""Per-packet closest-hit walk over the world treelet table (counterpart
of ``tpupt/accel/pallas_sweep.py``).

``treelet_closest_hit`` launches the CUDA kernel
``treelet_closest_hit_kernel`` (``csrc/treelet_kernels.cu``), which
replaces the Pallas ``_sweep_kernel`` together with the XLA cull that fed
it: one 256-thread block per packet computes its treelet entry distances
(the two-level cull above 96 treelets), sorts the hit treelets by (entry,
index) and walks them front to back, each thread folding its ray over the
treelet's L triangles while the next blocks load.  With ``payload=True``
(the differentiable renderer's form) it also returns the winner's world
triangle p0, e1, e2, read from its block row by slot after the walk.  For
CPU tensors it runs ``treelet_closest_hit_plain``, the lockstep loop
described below.

``treelet_any_hit`` launches the any-hit kernels for shadow rays, which
replace the JAX package's XLA ``intersect_treelets_anyhit``: the same
cull, sort and block ring, and a walk in which an occluded ray drops out
of the packet's exit test.  Shadow packets are sparse, so a packet with at
most 32 live lanes is walked by one warp (eight packets to a CTA,
``treelet_any_hit_warp_kernel``, up to 512 treelets) and the others by a
CTA whose threads hold the live rays compacted, several threads to a ray
when they are few (``treelet_any_hit_kernel``).  Below 96 treelets, where
a packet has little to walk, one kernel takes every packet
(``treelet_any_hit_walk_kernel``, the closest-hit walk's any-hit mode).
Its twin is ``treelet_any_hit_plain``.
"""

from __future__ import annotations

import torch

from tpupt_torch.accel import kernels
from tpupt_torch.accel.packets import (
    _DIFF_KEYS, _ROW_KEYS, BIG, PACKET, _cull_entries, _dense_mt, _walk_bound,
)
from tpupt_torch.accel.step_kernel import winner_step_plain
from tpupt_torch.utils import trace


def _payload_rows(tre_tris, leaf, slot):
    """The winner's p0x..e2z, components 0-8 of its block row, gathered by
    slot: 9 tensors shaped like ``slot``, the unit triangle (p0 = 0,
    e1 = x, e2 = y) where ``slot`` is -1, as the JAX package's sweep
    leaves lanes it never updates."""
    K = tre_tris.shape[0]
    safe = slot.clamp(min=0).long()
    rows = tre_tris.view(K, 13, leaf)[safe // leaf, :9, safe % leaf]  # (..., 9)
    got = slot >= 0
    return tuple(torch.where(got, rows[..., k], 1.0 if key in ("e1x", "e2y") else 0.0)
                 for k, key in enumerate(_DIFF_KEYS))


def treelet_closest_hit_plain(rows, act_p, tre_min, tre_max, tre_tris, leaf, stats=None,
                              payload=False):
    """Torch twin of ``treelet_closest_hit``: the cull
    (``packets._cull_entries``), then a lockstep loop, vectorized over
    packets, that advances every live packet by ONE treelet per step
    (argmin over the remaining entries, lowest index on exact ties), runs
    the dense step over its L pairs and keeps the closest hit (a later
    visit replaces an equal t).  A packet whose next entry, lowered by ``packets.SLAB_EPS`` of itself
    (``packets._walk_bound``), lies beyond every live lane's best t is
    done; it stays done because neither its entries nor its t change any
    more.

    ``stats``, when a dict, gains the cull's counts (``_cull_entries``) and
    the walk's: ``visits`` (packet-treelet steps taken), ``visits_max``
    (the most in one packet), ``mt_pairs`` (live lanes times L, summed
    over visits) and ``tri_pairs`` (live lanes times the visited treelet's
    triangles, its pad slots left out).  ``payload`` appends the winner's p0x..e2z
    (``_payload_rows``)."""
    np_, p = rows["rox"].shape
    K = tre_min.shape[0]
    dev = tre_tris.device
    entry = _cull_entries(tre_min, tre_max, rows, act_p, stats)
    live = act_p.sum(dim=1)
    visits = torch.zeros(np_, dtype=torch.int64, device=dev)
    pairs = tri_pairs = 0
    t = rows["t"].clone()
    slot = torch.full((np_, p), -1, dtype=torch.int32, device=dev)
    nx, ny, nz = (torch.zeros((np_, p), device=dev) for _ in range(3))
    obj = torch.full((np_, p), -1.0, device=dev)
    blocks = tre_tris.view(K, 13, leaf)
    ntri = (blocks[:, 12, :] >= 0).sum(dim=1)  # a pad slot's object is -1
    ar = torch.arange(np_, device=dev)
    iota_l = torch.arange(leaf, dtype=torch.int32, device=dev)
    for _ in range(K):
        ent, tid = torch.min(entry, dim=1)  # first index on ties
        valid = (ent < BIG) & (_walk_bound(ent) <= t.amax(dim=1))
        if not bool(valid.any()):
            break
        if stats is not None:
            visits += valid
            pairs += int(live[valid].sum()) * leaf
            tri_pairs += int((live * ntri[tid])[valid].sum())
        entry[ar, tid] = torch.where(valid, BIG, ent)
        safe = torch.where(valid, tid, 0)
        w = winner_step_plain(
            dict(rows, t=t), blocks[safe], valid[:, None].expand(np_, leaf).float(),
            safe[:, None].to(torch.int32) * leaf + iota_l,
        )
        got = w[0] < BIG  # a later visit replaces an equal t
        t = torch.where(got, w[0], t)
        slot = torch.where(got, w[1], slot)
        nx = torch.where(got, w[2], nx)
        ny = torch.where(got, w[3], ny)
        nz = torch.where(got, w[4], nz)
        obj = torch.where(got, w[5], obj)
    if stats is not None:
        stats.update(visits=int(visits.sum()), visits_max=int(visits.max()), mt_pairs=pairs,
                     tri_pairs=tri_pairs)
    out = (t, slot, nx, ny, nz, obj)
    return out + _payload_rows(tre_tris, leaf, slot) if payload else out


def treelet_any_hit_plain(rows, act_p, tre_min, tre_max, tre_tris, leaf, stats=None):
    """Torch twin of ``treelet_any_hit``: ``treelet_closest_hit_plain``'s
    cull and lockstep walk with the fold replaced by "some live pair is
    ok".  A lane with an ok pair in the visited treelet is occluded and its
    t becomes -BIG, so it fails every later pair test and no longer keeps
    its packet alive; a packet is done when its next entry lies beyond
    every unoccluded live lane's t.

    ``stats``, when a dict, gains the cull's counts and the walk's
    ``visits``, ``visits_max`` and ``mt_pairs`` (the lanes not yet occluded
    at a visit times L, summed over visits)."""
    np_, p = rows["rox"].shape
    K = tre_min.shape[0]
    dev = tre_tris.device
    entry = _cull_entries(tre_min, tre_max, rows, act_p, stats)
    visits = torch.zeros(np_, dtype=torch.int64, device=dev)
    pairs = 0
    t = rows["t"].clone()
    blocks = tre_tris.view(K, 13, leaf)
    ar = torch.arange(np_, device=dev)
    ray = {k: rows[k][:, None, :] for k in _ROW_KEYS[:7]}
    for _ in range(K):
        ent, tid = torch.min(entry, dim=1)  # first index on ties
        valid = (ent < BIG) & (_walk_bound(ent) <= t.amax(dim=1))
        if not bool(valid.any()):
            break
        if stats is not None:
            visits += valid
            pairs += int(((t > -BIG) & valid[:, None]).sum()) * leaf
        entry[ar, tid] = torch.where(valid, BIG, ent)
        b = blocks[torch.where(valid, tid, 0)]  # (np, 13, L)
        ok, _ = _dense_mt([b[:, c, :, None] for c in range(9)], ray, t[:, None, :])
        occ = (ok & valid[:, None, None]).any(dim=1)
        t = torch.where(occ, -BIG, t)
    if stats is not None:
        stats.update(visits=int(visits.sum()), visits_max=int(visits.max()), mt_pairs=pairs)
    return act_p & (t == -BIG)


def _checked_launch(name, rows, act_p, tre_min, tre_max, tre_tris, leaf,
                    smem_bytes="tpupt_treelet_smem_bytes"):
    """The checks both walk kernels make of their inputs, which are the
    same, and the kernel library; ``smem_bytes`` names the library's
    function that sizes the launch's shared memory.  Returns (library,
    packets, treelets)."""
    req = kernels.require
    req(tre_tris.is_cuda, f"{name}: unsupported device {tre_tris.device}")
    np_, p = rows["rox"].shape
    K = tre_min.shape[0]
    req(p == PACKET, f"{name}: packets must be {PACKET} wide, got {p}")
    req(tuple(tre_min.shape) == (K, 3) and tuple(tre_max.shape) == (K, 3),
        f"{name}: tre_min/tre_max must be (K, 3)")
    req(tuple(tre_tris.shape) == (K, 13 * leaf),
        f"{name}: tre_tris {tuple(tre_tris.shape)} != ({K}, {13 * leaf})")
    req(tuple(act_p.shape) == (np_, p) and act_p.dtype == torch.bool,
        f"{name}: act_p must be (np, 256) bool")
    f32 = [rows[k] for k in _ROW_KEYS] + [tre_min, tre_max, tre_tris]
    for k in _ROW_KEYS:
        req(tuple(rows[k].shape) == (np_, p), f"{name}: rows[{k!r}] shape")
    for a in f32 + [act_p]:
        req(a.device == tre_tris.device and a.is_contiguous(),
            f"{name}: every input must be contiguous on one device")
    req(all(a.dtype == torch.float32 for a in f32), f"{name}: float32 inputs required")
    # the kernel copies and reads treelet blocks in 16-byte pieces
    req(leaf % 4 == 0, f"{name}: the leaf size {leaf} must be a multiple of 4")
    req(tre_tris.data_ptr() % 16 == 0, f"{name}: tre_tris must be 16-byte aligned")
    lib = kernels.load()
    smem = getattr(lib, smem_bytes)(K, leaf)
    limit = torch.cuda.get_device_properties(tre_tris.device).shared_memory_per_block_optin
    req(smem <= limit, f"{name}: {K} treelets need {smem} B of shared memory > {limit}")
    return lib, np_, K


def _ray_ptrs(rows, act_p, tre_min, tre_max, tre_tris):
    return ([rows[k].data_ptr() for k in _ROW_KEYS]
            + [a.data_ptr() for a in (act_p, tre_min, tre_max, tre_tris)])


def treelet_closest_hit(rows, act_p, tre_min, tre_max, tre_tris, leaf, payload=False):
    """Closest hit per lane for packed rays (``packets._pack_rows``).

    rows: dict of rox..rdz, tmin, t (seed best t, -BIG on dead lanes), each
    (np, 256) f32.  act_p: (np, 256) bool.  tre_min/tre_max: (K, 3) f32.
    tre_tris: (K, 13 * leaf) f32.  Returns (t, slot, nx, ny, nz, obj), each
    (np, 256): lanes without a mesh hit keep their seed t, slot -1, normal
    0 and obj -1.  ``payload=True`` appends the winner's p0x, p0y, p0z, e1x,
    ..., e2z (9 more (np, 256) f32; the unit triangle where slot is -1).

    Launches are counted under "treelet_closest_hit" (6 channels) and
    "treelet_closest_hit(payload=True)" (``utils.trace``).
    """
    if tre_tris.device.type == "cpu":
        return treelet_closest_hit_plain(rows, act_p, tre_min, tre_max, tre_tris, leaf,
                                         payload=payload)
    lib, np_, K = _checked_launch("treelet_closest_hit", rows, act_p, tre_min, tre_max,
                                  tre_tris, leaf)
    dev = tre_tris.device
    out = [torch.empty((np_, PACKET), dtype=dt, device=dev)
           for dt in (torch.float32, torch.int32) + (torch.float32,) * 4]
    pay = torch.empty((9, np_, PACKET), dtype=torch.float32, device=dev) if payload else None
    if np_:
        err = lib.tpupt_treelet_closest_hit(
            *_ray_ptrs(rows, act_p, tre_min, tre_max, tre_tris), np_, K, leaf,
            *[o.data_ptr() for o in out], pay.data_ptr() if payload else None,
            kernels.stream_of(tre_tris),
        )
        kernels.check(lib, err, "treelet_closest_hit")
        trace.launched("treelet_closest_hit(payload=True)" if payload else "treelet_closest_hit")
    return tuple(out) + tuple(pay.unbind(0)) if payload else tuple(out)


def treelet_any_hit(rows, act_p, tre_min, tre_max, tre_tris, leaf):
    """Occlusion per lane for packed shadow rays (``packets._pack_rows``
    with the window end as the t cap): (np, 256) bool, True where an active
    lane hits a triangle at t in [tmin, t].  Inputs as
    ``treelet_closest_hit``'s.  Calls are counted under "treelet_any_hit"
    (``utils.trace``): one per call, which launches the walk
    kernel alone below 96 treelets, the warp route and the block route up
    to 512, and the block route alone above."""
    if tre_tris.device.type == "cpu":
        return treelet_any_hit_plain(rows, act_p, tre_min, tre_max, tre_tris, leaf)
    lib, np_, K = _checked_launch("treelet_any_hit", rows, act_p, tre_min, tre_max, tre_tris,
                                  leaf, smem_bytes="tpupt_any_hit_smem_bytes")
    occ = torch.empty((np_, PACKET), dtype=torch.bool, device=tre_tris.device)
    if np_:
        err = lib.tpupt_treelet_any_hit(
            *_ray_ptrs(rows, act_p, tre_min, tre_max, tre_tris), np_, K, leaf, occ.data_ptr(),
            kernels.stream_of(tre_tris),
        )
        kernels.check(lib, err, "treelet_any_hit")
        trace.launched("treelet_any_hit")
    return occ
