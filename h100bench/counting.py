"""The work of the program's trip kernels, counted on one job that runs
apart from any timed or traced window.

Each rule counts what a lane's case needs on one launch, each input byte
read once and each output byte written once, and the float operations
its inputs need; a kernel's bound is the larger of bytes over the peak
bandwidth and operations over the peak FP32 rate of one H100 SXM
(``PEAKS``).  The rules are a frozen copy of the repository's card smoke
test's (per-case byte counts of ``trip_head``, ``trip_nee``,
``trip_tail`` and its NEE mode, ``diff_trip_fwd`` and ``diff_trip_bwd``).
The counts wrap the program's kernel wrappers for one job; where the
program no longer has what a rule reads, the count gives nothing and the
metric that needs it is left out.
"""

from __future__ import annotations

import contextlib

import torch

# NVIDIA H100 SXM, published: FP32 outside the tensor cores, HBM3
# bandwidth; both at the 700 W limit
PEAKS = dict(flops=67e12, bytes=3.35e12, power_w=700.0)

# float operations a lane needs: trip_tail per live lane and per lane that
# folds a sample; trip_nee per live lane, per live lane and term, per term
# and sphere; the NEE tail per term; trip_head per lane and sphere and per
# lane a sphere wins; the differentiable trip's hit lane forward and
# backward, and a miss
TAIL_LIVE_FLOPS, TAIL_FOLD_FLOPS = 320, 80
NEE_LIVE_FLOPS, NEE_TERM_FLOPS, NEE_SPHERE_FLOPS, TAIL_TERM_FLOPS = 340, 200, 60, 4
HEAD_SPHERE_FLOPS, HEAD_WIN_FLOPS = NEE_SPHERE_FLOPS, 65
DIFF_HIT_FLOPS, DIFF_BWD_HIT_FLOPS, DIFF_MISS_FLOPS = 340, 800, 60


def bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["flops"], nbytes / PEAKS["bytes"]) * 1e3


def add(sums: dict, name: str, nbytes: float, flops: float) -> None:
    e = sums.setdefault(name, dict(launches=0, bytes=0, flops=0, bound_ms=0.0))
    e["launches"] += 1
    e["bytes"] += nbytes
    e["flops"] += flops
    e["bound_ms"] += bound_ms(flops, nbytes)


def head_work(plan, live: int, wins: int):
    """trip_head: alive of every lane; the ray rows and the record of each
    live lane; with a mesh the seed t and mask of every padded lane and
    the ray rows of each live and pad lane."""
    nbytes = plan.n * 4 + live * (7 * 4 + 8 * 4)
    if plan.mesh:
        nbytes += plan.n_pad * 5 + (live + plan.n_pad - plan.n) * 7 * 4
    return nbytes, live * plan.tables.n_sph * HEAD_SPHERE_FLOPS + wins * HEAD_WIN_FLOPS


def tail_work(tk, plan, I0, I1, sweep, hint):
    """trip_tail without emitters on one trip."""
    keys = tk.I_KEYS
    n = plan.n
    alive = I0[keys.index("alive")] != 0
    done = (I0[keys.index("done")] != 0) if plan.chained else torch.zeros_like(alive)
    live = int(alive.sum())
    touched = int((alive | ~done).sum()) if plan.chained else live
    ended_lanes = I1[keys.index("k")] != I0[keys.index("k")]
    ended = int(ended_lanes.sum())
    fresh = int((ended_lanes & (I1[keys.index("done")] == 0)).sum())
    mesh_hits = int(((sweep[1].reshape(-1)[:n] >= 0) & alive).sum()) if plan.mesh else 0
    wins = int(((hint[:n] >= 0) & alive).sum())
    nbytes = (n * (12 + (4 if plan.chained else 0)) + touched * (17 * 8 + 12)
              + live * (36 + (4 if plan.mesh else 0)) + mesh_hits * 20 + ended * 68
              + fresh * 4 + 4)
    return live, wins, (nbytes, live * TAIL_LIVE_FLOPS + ended * TAIL_FOLD_FLOPS)


def nee_work(tk, plan, I0, I1, sweep, hint, alive_next, nee_mask, occ):
    """trip_nee and trip_tail's NEE mode on one trip of a lit scene."""
    keys = tk.I_KEYS
    n, n_pad, terms, mesh = plan.n, plan.n_pad, len(plan.nee_kinds), plan.mesh
    alive = I0[keys.index("alive")] != 0
    done = (I0[keys.index("done")] != 0) if plan.chained else torch.zeros_like(alive)
    live = int(alive.sum())
    touched = int((alive | ~done).sum()) if plan.chained else live
    on_mesh = (sweep[1].reshape(-1)[:n] >= 0) & alive if mesh else torch.zeros_like(alive)
    hit = (hint >= 0) & alive | on_mesh
    first = hit & (I0[keys.index("bounce")] == 0)
    emissive = hit & ~alive_next
    lit = nee_mask & ~occ if occ is not None else nee_mask
    ended_lanes = I1[keys.index("k")] != I0[keys.index("k")]
    ended = int(ended_lanes.sum())
    fresh = int((ended_lanes & (I1[keys.index("done")] == 0)).sum())
    opens = int(nee_mask.sum())
    nee_bytes = (n * 4 + live * (8 + 48 + 32 + 12 + 1 + (4 if mesh else 0))
                 + int(on_mesh.sum()) * 20 + int(hit.sum()) * 52 + int(first.sum()) * 16
                 + int(emissive.sum()) * 8 + terms * n_pad * (1 + (4 if mesh else 0))
                 + opens * (12 + (28 if mesh else 0))
                 + (terms * (n_pad - n) * 28 if mesh else 0) + plan.tables.table.numel() * 4)
    tail_bytes = (n * (12 + (4 if plan.chained else 0)) + touched * (17 * 8 + 12)
                  + live * (4 + 1 + terms * (1 + (1 if mesh else 0))) + int(lit.sum()) * 12
                  + ended * 68 + fresh * 12 + 4)
    n_sph = plan.tables.n_sph
    nee_flops = live * (NEE_LIVE_FLOPS + terms * (NEE_TERM_FLOPS + n_sph * NEE_SPHERE_FLOPS))
    tail_flops = live * (terms * TAIL_TERM_FLOPS + 20) + ended * TAIL_FOLD_FLOPS
    return (nee_bytes, nee_flops), (tail_bytes, tail_flops)


def diff_fwd_work(dt, plan, code, b):
    """diff_trip_fwd on bounce ``b`` from its code residuals."""
    n = plan.n
    hit = code >= 0
    n_live = int((code != dt.DEAD).sum())
    n_hit, n_tri = int(hit.sum()), int((hit & (code % 2 == 1)).sum())
    n_miss = n_live - n_hit
    first_hits = n_hit if b == 0 else 0
    nbytes = (n * 4 + (n - n_live) * 8 + n_live * (4 + (4 if plan.mesh else 0) + 8 + 4 + 8)
              + n_miss * (36 + 12 + 24) + n_hit * (52 + 4 + 52 + 40) + n_tri * 40
              + first_hits * 16 + plan.tables.table.numel() * 4 + 4)
    return nbytes, n_hit * DIFF_HIT_FLOPS + n_miss * DIFF_MISS_FLOPS


def diff_bwd_work(dt, plan, code, slot, b):
    """diff_trip_bwd on bounce ``b``: every lane's code; a miss's and a
    hit's cotangents and residuals; bounce 0's normal and depth; a
    triangle hit's slot and row; the slot rows added into; the scene
    table and the leaf table."""
    n = plan.n
    hit = code >= 0
    on_tri = hit & (code % 2 == 1)
    n_live = int((code != dt.DEAD).sum())
    n_hit, n_tri = int(hit.sum()), int(on_tri.sum())
    n_miss = n_live - n_hit
    first_hits = n_hit if b == 0 else 0
    n_rows = int(torch.unique(slot[on_tri]).numel())
    n_leaf = plan.tables.n_sph * 4 + plan.scene.materials.albedo.shape[0] * 8 + 6
    nbytes = (n * 4 + n_miss * (36 + 24 + 24) + n_hit * (4 + 48 + 40 + 36) + first_hits * 32
              + n_tri * (4 + 36) + n_rows * 36 + plan.tables.table.numel() * 4 + n_leaf * 16)
    return nbytes, n_hit * DIFF_BWD_HIT_FLOPS + n_miss * DIFF_MISS_FLOPS


@contextlib.contextmanager
def patched(module, **fns):
    old = {k: getattr(module, k) for k in fns}
    for k, f in fns.items():
        setattr(module, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(module, k, f)


def count_trips(job_fn):
    """``job_fn()`` with every forward trip's kernels counted: {kernel:
    launches, bytes, flops, bound_ms}, trip_tail's NEE mode under
    "trip_tail"."""
    from tpupt_torch.render import trip_kernel as tk

    sums, cur = {}, {}
    head, nee, tail = tk.trip_head, tk.trip_nee, tk.trip_tail

    def c_head(plan, F, I, buf):
        cur.update(I=I.clone(), sweep=None)
        return head(plan, F, I, buf)

    def c_nee(plan, F, I, buf, sweep=None):
        cur["sweep"] = sweep
        return nee(plan, F, I, buf, sweep)

    def c_tail(plan, F, I, buf, sweep=None, occ=None):
        out = tail(plan, F, I, buf, sweep, occ)
        sw = cur["sweep"] if plan.nee else sweep
        live, wins, tw = tail_work(tk, plan, cur["I"], I, sw, buf.hint)
        add(sums, "trip_head", *head_work(plan, live, wins))
        if plan.nee:
            nw, ntw = nee_work(tk, plan, cur["I"], I, sw, buf.hint, buf.alive_next,
                               buf.nee_mask, occ)
            add(sums, "trip_nee", *nw)
            add(sums, "trip_tail", *ntw)
        else:
            add(sums, "trip_tail", *tw)
        return out

    with patched(tk, trip_head=c_head, trip_nee=c_nee, trip_tail=c_tail):
        job_fn()
    return sums


def count_diff(job_fn):
    """``job_fn()`` with the differentiable trip's kernels counted:
    trip_head, diff_trip_fwd and diff_trip_bwd."""
    from tpupt_torch.render import diff_trip as dt
    from tpupt_torch.render import trip_kernel as tk

    sums = {}
    head, fwd, bwd = tk.trip_head, dt.diff_trip_fwd, dt.diff_trip_bwd

    def c_head(plan, F, I, buf):
        alive = I[tk.I_KEYS.index("alive")] != 0
        out = head(plan, F, I, buf)
        live, wins = int(alive.sum()), int(((buf.hint >= 0) & alive).sum())
        add(sums, "trip_head", *head_work(plan, live, wins))
        return out

    def c_fwd(dp, F, I, buf, sweep, b, res=None):
        out = fwd(dp, F, I, buf, sweep, b, res)
        add(sums, "diff_trip_fwd", *diff_fwd_work(dt, dp.trip, res.i[0], b))
        return out

    def c_bwd(dp, G, res, seed, b, gtab, g_slot=None):
        add(sums, "diff_trip_bwd", *diff_bwd_work(dt, dp.trip, res.i[0], res.i[1], b))
        return bwd(dp, G, res, seed, b, gtab, g_slot)

    with patched(tk, trip_head=c_head), patched(dt, diff_trip_fwd=c_fwd, diff_trip_bwd=c_bwd):
        job_fn()
    return sums
