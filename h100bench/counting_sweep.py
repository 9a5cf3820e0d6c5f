"""The work of the closest-hit sweep (``treelet_closest_hit``) on every
trip of one counting job, beside ``counting.count_trips``'s trip kernels.

Each launch's work is what the torch twin's walk counts on the same
inputs (``sweep_kernel.treelet_closest_hit_plain``'s ``stats``): the
cull's slab tests and the walk's Möller–Trumbore pairs of a live lane and
a real triangle of the visited treelet (``tri_pairs``: the kernel also
folds the treelet's pad slots, which no hit needs), at ``SLAB_FLOPS`` and
``MT_FLOPS`` float operations each; its bytes are
each lane's mask read and six outputs written, eight ray rows read per
live lane, and each treelet's box and block read once.  Both rules are a
frozen copy of the repository's card smoke test's.  The bound is
``counting.bound_ms``'s, at the same published peaks.
"""

from __future__ import annotations

from h100bench import counting

# float operations of one slab test and of one Möller–Trumbore pair
SLAB_FLOPS, MT_FLOPS = 27, 56


def sweep_work(stats: dict, lanes: int, treelets: int, leaf: int):
    """(bytes, float operations) of one launch from the twin's ``stats``
    over ``lanes`` launched lanes of a table of ``treelets`` treelets of
    ``leaf`` triangles."""
    nbytes = (lanes * (1 + 6 * 4) + stats["live_lanes"] * 8 * 4
              + treelets * (6 + 13 * leaf) * 4)
    return nbytes, stats["slab_tests"] * SLAB_FLOPS + stats["tri_pairs"] * MT_FLOPS


def count_sweeps(job_fn) -> dict:
    """``job_fn()`` with every closest-hit sweep of its trips counted:
    {"treelet_closest_hit": {launches, bytes, flops, bound_ms}}, empty
    where no sweep ran or the twin counts no ``tri_pairs``."""
    from tpupt_torch.accel import sweep_kernel as sk

    sums = {}
    sweep = sk.treelet_closest_hit

    def counted(rows, act_p, tre_min, tre_max, tre_tris, leaf, *args, **kw):
        out = sweep(rows, act_p, tre_min, tre_max, tre_tris, leaf, *args, **kw)
        # the twin walks the packets with a live lane: the others count 0
        keep = act_p.any(dim=1)
        stats = dict(live_lanes=0, slab_tests=0)
        if not bool(keep.any()):
            stats["tri_pairs"] = 0
        else:
            sk.treelet_closest_hit_plain({k: v[keep] for k, v in rows.items()}, act_p[keep],
                                         tre_min, tre_max, tre_tris, leaf, stats=stats)
        if "tri_pairs" in stats:
            counting.add(sums, "treelet_closest_hit",
                         *sweep_work(stats, act_p.numel(), tre_min.shape[0], leaf))
        return out

    with counting.patched(sk, treelet_closest_hit=counted):
        job_fn()
    return sums
