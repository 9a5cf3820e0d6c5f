"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels from the sources in this checkout, holds each against its torch
twin at the main path's shapes, renders the bunny scene at full size and
checks the result (the forward trip's kernels, trip_head and trip_tail,
held to their twins on trips of that render and the render to the
``_bounce_body`` route's, in turns), then takes the gradient of a
full-size differentiable render with respect to every scene parameter
through the differentiable trip (trip_head, the payload sweep and
diff_trip_fwd a bounce; one diff_trip_bwd a bounce backward, the slot
table's scatter inside it), in turns with the ``_bounce_body`` route (the
forward bit-equal, the gradients within 1e-4), diff_trip_fwd,
diff_trip_bwd and slot_scatter (the body route's fetch backward) held to
their twins on bounces 0, 2 and the last of a sample, holds the gradient against
the body route on the sweep's twin at 256^2 and runs the denoiser's
backward pass.  Then next-event
estimation: the any-hit shadow kernels against their twin on sparse,
mixed and dense packets (and both forms of the closest-hit kernel on the
area-light scene's own rays), the two Cornell scenes rendered at
BASELINE config 2's size on the trip route (trip_head, trip_nee, the
sweeps and trip_tail's NEE mode), bit-equal to the ``_bounce_body`` route
in turns, the trip kernels held to their twins on recorded trips of both,
of sixteen lamps and of an emissive icosphere, and a fwd+bwd step on the
area-light Cornell box.  Then the user's
surfaces: the progressive engine (``PathTracer``) on the bunny render, its
streaming mode bit-equal to the megakernel and the sweep on a compacted
wavefront bounce; the CLI in subprocesses at the scenes' own settings,
with the sweep held against its twin on the rows of the same 1920x1080
renders (chained trips, a compacted bounce); the headless viewer.  Then
inverse rendering: BASELINE config 4 as a fit of the albedos on the bunny
render at 1024^2 through the denoiser (its loss falls, frozen leaves stay
bit-equal), the fit's loss and gradients held against the twins' at
128^2, and a geometry fit; row bands bit-equal to the full render, the
sharded render and gradients on a one-rank NCCL group and on two gloo
processes sharing the card; and the reference oracles (the per-ray BVH
walk, the brute force) against the sweep's hits, on bunny.json and on
ajax-white-hi.json's 327,680 triangles, the any-hit kernels' occlusion on
that scene's shadow rays against the twin and the BVH walk, and the
brute-force render,
which traces its shadow rays itself, against the render on bunny.json
and cornell_area.json.  Then the bench harness (``tpupt_torch.bench``):
``run_config`` for each of its seven configs at full size, the sweep and
the trip kernels held against their twins on trips of the full
multi_mesh.json, ajax-white.json and ajax-white-hi.json renders, multimesh's sharded branch on two gloo
processes and ``python -m tpupt_torch.bench.scaling 2``.  Last, the tail
handover: three_balls.json at 512^2, 64 spp, 50 bounces (more lanes than
one resident wave of trip_drain) through its issued sphere-only trips,
two of them held to their twins, and trip_drain, held to
trip_drain_plain from the render's own handover state; the render equal
to the issued trips run to the end.  Then the lit mesh trip route against
the benchmark's plain references: the Cornell box of *Ray Tracing: The
Next Week* at 512^2 (``h100bench/reference/pathtrace_scene.py``, its
black background read) and the rows of cornell_area.json at 2048^2 that
the cull's repair brought back (``pathtrace.py``), 16 spp, 50 bounces.  Every phase prints its wall.

    python chip_smoke.py

(``python chip_smoke.py --band-rank R PORT OUT`` and ``--harness-rank R
PORT OUT`` are one rank of phase 16's and phase 18's two-process runs,
which the script starts itself.)

Phases print as they go; any failure raises and the script exits non-zero.
Without a CUDA device, or without the rest of the repository beside it,
it fails before printing any result.  Its standard output ends with:
  * the card's name and power limit, as nvidia-smi reports them,
  * one JSON line {"kernels": [...], "off_path": [...], ...}: per kernel
    its launches on its main path (the forward render; the fwd+bwd step
    for the payload form and the differentiable trip's two kernels; the
    cornell_area render for the any-hit kernel and trip_nee; the
    cornell_area fwd+bwd step, the body route, for slot_scatter; the
    three_balls render for trip_drain), and the trip kernels' (the forward
    render),
    its measured error and times, and its bound (the work its inputs need
    at the card's published peaks), and its launches in each CLI render,
    in a fit step and in each of phase 16's band renders; for the trip
    kernels, ``path_sums``: the bound summed over every trip or bounce of
    the bunny render, the fwd+bwd step and the Cornell renders (phases 4a,
    6, 10) beside the profiler's summed device ms and the share,
  * {"ok": true, "device": {...}} as the last line.
"""

import concurrent.futures
import ctypes
import dataclasses
import functools
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
import zlib

T_START = time.perf_counter()  # the run's wall, imports included

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch sees no CUDA device")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import tpupt_torch  # noqa: E402  (needs the repository beside this script)
from tpupt_torch.accel import kernels, packets, step_kernel, sweep_kernel  # noqa: E402
from tpupt_torch.bench import harness  # noqa: E402
from tpupt_torch.core.camera import generate_rays, make_camera, pixel_centers  # noqa: E402
from tpupt_torch.core.vec import Vec3  # noqa: E402
from tpupt_torch.cpu_ref.renderer import intersect_scene_ids_brute, render_image_ref  # noqa: E402
from tpupt_torch.diff.fit import fit_scene, render_loss  # noqa: E402
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES  # noqa: E402
from tpupt_torch.dist.sharding import (  # noqa: E402
    init_distributed, make_tile_mesh, render_image_sharded, render_loss_and_grads_sharded,
)
from tpupt_torch.interactive.camera_controller import FirstPersonCameraController  # noqa: E402
from tpupt_torch.interactive.viewer import InteractiveViewer  # noqa: E402
from tpupt_torch.accel.slot_scatter import slot_scatter, slot_scatter_plain  # noqa: E402
from tpupt_torch.render import diff_trip, integrator, intersect, trip_kernel, wavefront  # noqa: E402
from tpupt_torch.render.materials import shade  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.bake import rebake_treelets  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402
from tpupt_torch.scene.procedural import icosphere  # noqa: E402
from tpupt_torch.utils import trace  # noqa: E402
from tpupt_torch.utils.image import to_uint8  # noqa: E402

DEV = torch.device("cuda")
SIZE, SPP, MAX_BOUNCES, RR = 1024, 16, 50, 8  # the main path's render
# the forward render's counts on bunny.json; the differentiable path must not move them
FWD_LAUNCHES, FWD_SEGMENTS = 94, 25_417_152
DIFF_SPP, DIFF_BOUNCES = 4, 8  # the fwd+bwd step (bench.py's _bench_fwd_bwd)
# the NEE renders: BASELINE config 2's size, depth and roulette; cornell.json
# at its 4 spp, cornell_area.json at its own sampler's 16; the fwd+bwd step
# on cornell_area at 4 spp
NEE_SIZE, NEE_BOUNCES, NEE_RR = 512, 4, 2
NEE_SPP = {"cornell.json": 4, "cornell_area.json": 16}
NEE_DIFF_SPP = 4
OUT = os.path.join(ROOT, "chiprun_out")
# BASELINE config 4 as a fit (fit_scene's 1 spp and 4 bounces, the
# denoiser on, grads to the albedos); the row bands' render; the
# two-process check's size
FIT_STEPS, BANDS, BAND_SPP = 8, 4, 4
BAND2 = dict(size=512, spp=4, max_bounces=50, rr_start=8, diff_spp=4)
# published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): FP32
# outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# float32 operations of one slab test (6 sub, 6 mul, 10 min/max, max with
# 0, 3 compares + and) and of one Moller-Trumbore pair (cross products, dot
# products, the reciprocal, 6 tests)
SLAB_FLOPS, MT_FLOPS = 27, 56


PHASE_WALLS = {}  # phase id -> wall seconds
_open_phase = []


def phase(name):
    """Start phase ``name`` (its id is the first word), ending the one
    before it and printing that one's wall."""
    now = time.perf_counter()
    if _open_phase:
        prev, t0 = _open_phase.pop()
        PHASE_WALLS[prev] = now - t0
        print(f"-- phase {prev}: {now - t0:.1f} s of wall", flush=True)
    _open_phase.append((name.split()[0], now))
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ulp_gap(a, b):
    """Largest distance in float32 ulps between two float tensors."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def bound(flops, nbytes):
    """Least milliseconds for the work at the card's published peaks, and
    which of the two bounds it."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


LEAVES = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)


def leaf(params, name):
    return params["materials"][name[10:]] if name.startswith("materials.") else params[name]


def band_worker(rank, port, out):
    """One rank of phase 16's two-process run on the one card: gloo over
    CUDA tensors (NCCL takes one rank per device).  Renders its band of
    BAND2 and takes both placements' gradients; saves what it got."""
    init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    ensure_models(names=["bunny.obj"])
    d = scene_from_json(os.path.join(locate_asset_path(ROOT), "scenes", "bunny.json"))
    scn = d.build(leaf_size=32, device=DEV)
    size, spp, mb, rr = BAND2["size"], BAND2["spp"], BAND2["max_bounces"], BAND2["rr_start"]
    res = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf, rays = render_image_sharded(scn, d.camera, size, size, spp, max_bounces=mb, rr_start=rr)
    torch.cuda.synchronize()
    res.update(render_wall=time.perf_counter() - t0, rays=int(rays), color=buf.color.cpu().numpy(),
               normal=buf.normal.cpu().numpy(), depth=buf.depth.cpu().numpy())
    target = torch.zeros((size * size, 3), device=DEV)
    for overlap in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = render_loss_and_grads_sharded(scn, d.camera, target, size, size,
                                                    BAND2["diff_spp"], max_bounces=DIFF_BOUNCES,
                                                    overlap_grad_psum=overlap)
        torch.cuda.synchronize()
        key = "overlap" if overlap else "posthoc"
        res[f"{key}_wall"] = time.perf_counter() - t0
        res[f"{key}_loss"] = float(loss)
        for k in LEAVES:
            res[f"{key}.{k}"] = leaf(grads, k).cpu().numpy()
    np.savez(out, **res)
    torch.distributed.destroy_process_group()


def harness_worker(rank, port, out):
    """One rank of phase 18's two-process run of the harness's sharded
    branch on the one card: ``run_config("multimesh")`` at its full size in
    a gloo group of two; saves the result and the last sharded call's
    gathered buffers and rays."""
    from tpupt_torch.dist import sharding

    init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    render_sharded, last = sharding.render_image_sharded, {}

    def recording(*args, **kw):
        buf, rays = render_sharded(*args, **kw)
        last.update(color=buf.color, normal=buf.normal, depth=buf.depth, call_rays=rays)
        return buf, rays

    sharding.render_image_sharded = recording
    res = harness.run_config("multimesh", iters=1)
    np.savez(out, mrays=res.mrays_per_sec, rays=res.rays, seconds=res.seconds,
             **{k: float(v) for k, v in res.extra.items()},
             **{k: v.cpu().numpy() for k, v in last.items()})
    torch.distributed.destroy_process_group()


def require_equal(name, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            gap = ulp_gap(a.float(), b.float()) if a.is_floating_point() else "n/a"
            raise AssertionError(f"{name}: output {i} differs from the twin (max ulp gap {gap})")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


HEAD_OUT = ("hrec", "hint", "rows", "act_p")  # the TripBuffers trip_head writes
# the TripBuffers trip_nee writes
NEE_OUT = ("alive_next", "nee_contrib", "nee_mask", "nee_rows")


def head_out(buf, keys=HEAD_OUT):
    return {k: None if getattr(buf, k) is None else getattr(buf, k).clone() for k in keys}


def record_trip_inputs(render, keep):
    """``render()`` with the inputs of its trips ``keep`` (0 = the first)
    kept, cloned as the trip kernels receive them: the lane state before
    the trip (``F``, ``I``), trip_head's buffers before (``pre``, the
    earlier trips' values in dead lanes) and after it, the sweep's outputs;
    on a trip of a scene with emitters also trip_nee's buffers before it
    (``nee_pre``) and after it (``nee``), the state after it (``F2``,
    ``I2``) and the any-hit sweep's output (``occ``).  Returns (render()'s
    result, trips, {trip: record})."""
    kept, n = {}, {"head": 0, "nee": 0, "tail": 0}
    head, nee, tail = trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail

    def recording_head(plan, F, I, buf):
        if n["head"] in keep:
            kept[n["head"]] = dict(plan=plan, F=F.clone(), I=I.clone(), pre=head_out(buf))
        n["head"] += 1
        return head(plan, F, I, buf)

    def recording_nee(plan, F, I, buf, sweep=None):
        if n["nee"] in keep:
            kept[n["nee"]].update(**head_out(buf), nee_pre=head_out(buf, NEE_OUT),
                                  sweep=None if sweep is None else tuple(o.clone() for o in sweep))
        n["nee"] += 1
        return nee(plan, F, I, buf, sweep)

    def recording_tail(plan, F, I, buf, sweep=None, occ=None):
        if n["tail"] in keep:
            if plan.nee:
                kept[n["tail"]].update(F2=F.clone(), I2=I.clone(), nee=head_out(buf, NEE_OUT),
                                       occ=None if occ is None else occ.clone())
            else:
                kept[n["tail"]].update(
                    **head_out(buf), sweep=None if sweep is None else tuple(o.clone() for o in sweep))
        n["tail"] += 1
        return tail(plan, F, I, buf, sweep, occ)

    trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail = (
        recording_head, recording_nee, recording_tail)
    try:
        out = render()
    finally:
        trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail = head, nee, tail
    return out, n["tail"], kept


def events_ms(restore, fn, reps):
    """Mean milliseconds of ``fn`` by a CUDA event pair around each call,
    ``restore`` (not timed) before each; one warm-up call."""
    restore()
    fn()
    pairs = []
    for _ in range(reps):
        restore()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def kernel_ms(restore, fn, reps):
    """Mean device milliseconds of ``fn``'s kernel by a CUDA event pair
    around each call, issued while the stream still runs a spin kernel
    (``torch.cuda._sleep``, ~1 ms), so the pair times the kernel, not the
    host's issue of the wrapper; ``restore`` (not timed) before each."""
    restore()
    fn()
    pairs = []
    for _ in range(reps):
        restore()
        torch.cuda._sleep(2_000_000)
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


# float operations a lane needs, counted from trip_kernels.cu and rounded
# up (sinf and cosf at 20 each): trip_tail per live lane (the hit record,
# background or shading, roulette) and per lane that folds a sample and
# restarts
TAIL_LIVE_FLOPS, TAIL_FOLD_FLOPS = 320, 80
# trip_nee per live lane (the hit record, background or shading, the MIS
# weight), per live lane and NEE term (a light sample, sinf and cosf at 20
# each, its contribution), per live lane, term and sphere object (the
# shadow ray's quadratic); the NEE tail per live lane and term (the sum)
NEE_LIVE_FLOPS, NEE_TERM_FLOPS, NEE_SPHERE_FLOPS, TAIL_TERM_FLOPS = 340, 200, 60, 4
# trip_head per live lane and sphere object, the quadratic (sphere_roots,
# as a shadow ray's), and per live lane that a sphere wins, the winner's
# world t and normal; the world t of a sphere in the window that a later
# one beats is not counted (it needs this run's every candidate)
HEAD_SPHERE_FLOPS, HEAD_WIN_FLOPS = NEE_SPHERE_FLOPS, 65


def head_flops(plan_n_sph, live, wins):
    """trip_head's float operations on a trip with ``live`` live lanes,
    ``wins`` of them on a sphere."""
    return live * plan_n_sph * HEAD_SPHERE_FLOPS + wins * HEAD_WIN_FLOPS


def head_bytes(plan, live):
    """trip_head's bytes on a trip with ``live`` live lanes (PERF.md
    section 2's rule): alive of every lane; the ray rows and the record
    (t, point, normal, hint) of each live lane; with a mesh, the seed t and
    mask of every padded lane and the seven ray rows of each live and pad
    lane."""
    nbytes = plan.n * 4 + live * (7 * 4 + 8 * 4)
    return nbytes + (plan.n_pad * 5 + (live + plan.n_pad - plan.n) * 7 * 4 if plan.mesh else 0)


def trip_work(rec, I_after):
    """The bytes and float operations the two kernels need on one
    recorded trip, by what each lane does (each input read once, each
    output written once, as trip_kernels.cu reads and writes them)."""
    plan, I0 = rec["plan"], rec["I"]
    keys = trip_kernel.I_KEYS
    alive = I0[keys.index("alive")] != 0
    done = (I0[keys.index("done")] != 0) if plan.chained else torch.zeros_like(alive)
    n, live = plan.n, int(alive.sum())
    touched = int((alive | ~done).sum()) if plan.chained else live
    ended_lanes = I_after[keys.index("k")] != I0[keys.index("k")]
    ended = int(ended_lanes.sum())
    fresh = int((ended_lanes & (I_after[keys.index("done")] == 0)).sum())
    mesh_hits = int(((rec["sweep"][1].reshape(-1)[:n] >= 0) & alive).sum()) if plan.mesh else 0
    n_sph = plan.tables[1]
    wins = int(((rec["hint"][:n] >= 0) & alive).sum())
    # tail: alive, bounce (and done) of every lane; the 17 state rows, the
    # segments and alive of each lane it touches; the record, seed (and
    # slot) of each live lane, the sweep's winner of each mesh hit; k, the
    # averages and done of each lane that ends; the seed of a restart
    tail_bytes = (n * (12 + (4 if plan.chained else 0)) + touched * (17 * 8 + 12)
                  + live * (36 + (4 if plan.mesh else 0)) + mesh_hits * 20 + ended * 68
                  + fresh * 4 + 4)
    return dict(lanes=n, live=live, touched=touched, ended=ended, restarts=fresh,
                mesh_hits=mesh_hits, head_bytes=head_bytes(plan, live), tail_bytes=tail_bytes,
                head_flops=head_flops(n_sph, live, wins),
                tail_flops=live * TAIL_LIVE_FLOPS + ended * TAIL_FOLD_FLOPS)


def nee_trip_work(rec, I_after):
    """The bytes and float operations trip_nee and the NEE mode of
    trip_tail need on one recorded trip of a scene with emitters, by what
    each lane does (each input read once, each output written once, as
    trip_kernels.cu reads and writes them; the scene table once)."""
    plan, I0 = rec["plan"], rec["I"]
    keys = trip_kernel.I_KEYS
    n, n_pad, terms, mesh = plan.n, plan.n_pad, len(plan.nee_kinds), plan.mesh
    alive = I0[keys.index("alive")] != 0
    done = (I0[keys.index("done")] != 0) if plan.chained else torch.zeros_like(alive)
    live = int(alive.sum())
    touched = int((alive | ~done).sum()) if plan.chained else live
    on_mesh = (rec["sweep"][1].reshape(-1)[:n] >= 0) & alive if mesh else torch.zeros_like(alive)
    hit = (rec["hint"] >= 0) & alive | on_mesh
    first = hit & (I0[keys.index("bounce")] == 0)
    emissive = hit & ~rec["nee"]["alive_next"]
    mask = rec["nee"]["nee_mask"]
    lit = mask & ~rec["occ"] if rec["occ"] is not None else mask
    ended_lanes = I_after[keys.index("k")] != I0[keys.index("k")]
    ended = int(ended_lanes.sum())
    fresh = int((ended_lanes & (I_after[keys.index("done")] == 0)).sum())
    opens = int(mask.sum())
    # trip_nee: alive of every lane; a live lane's seed, bounce, ray,
    # throughput and radiance, its record (and slot), its radiance and
    # alive_next out; a hit's t_min in and scatter out (ray, t_min,
    # throughput, pdf_w, spec), the first hit's normal and depth, an
    # emitter's pdf_w and spec in; each term's mask (and -BIG seed) of every
    # padded lane, an open lane's contribution (and its other 7 rows), the
    # pad lanes' rows
    nee_bytes = (n * 4 + live * (8 + 48 + 32 + 12 + 1 + (4 if mesh else 0))
                 + int(on_mesh.sum()) * 20 + int(hit.sum()) * 52 + int(first.sum()) * 16
                 + int(emissive.sum()) * 8 + terms * n_pad * (1 + (4 if mesh else 0))
                 + opens * (12 + (28 if mesh else 0))
                 + (terms * (n_pad - n) * 28 if mesh else 0) + plan.tables.table.numel() * 4)
    # the NEE tail: as trip_tail's, the record and the sweep's winner out
    # and a live lane's alive_next, each term's mask (and occlusion) and a
    # lit term's contribution in; a restart also writes spec and pdf_w
    tail_bytes = (n * (12 + (4 if plan.chained else 0)) + touched * (17 * 8 + 12)
                  + live * (4 + 1 + terms * (1 + (1 if mesh else 0))) + int(lit.sum()) * 12
                  + ended * 68 + fresh * 12 + 4)
    n_sph = plan.tables.n_sph
    return dict(lanes=n, live=live, hits=int(hit.sum()), mesh_hits=int(on_mesh.sum()),
                terms=terms, open_term_lanes=opens, lit_term_lanes=int(lit.sum()), ended=ended,
                restarts=fresh, nee_bytes=nee_bytes, tail_bytes=tail_bytes,
                nee_flops=live * (NEE_LIVE_FLOPS + terms * (NEE_TERM_FLOPS
                                                            + n_sph * NEE_SPHERE_FLOPS)),
                tail_flops=live * (terms * TAIL_TERM_FLOPS + 20) + ended * TAIL_FOLD_FLOPS)


# float operations a lane of the differentiable trip needs, estimated from
# diff_trip_kernels.cu (sinf and cosf at 20 each): a hit lane's forward
# (refine, shading, roulette) and its backward (the forward again and the
# hand VJP), a miss lane's either way
DIFF_HIT_FLOPS, DIFF_BWD_HIT_FLOPS, DIFF_MISS_FLOPS = 340, 800, 60


def diff_fwd_work(plan, code, b):
    """diff_trip_fwd's bytes and float operations on bounce ``b`` from its
    code residuals (each input read once, each output written once): every
    lane's alive flag; a dead lane's code and slot residuals; a live
    lane's hint, the sweep's slot (with a mesh), its segment count read and
    written, alive written, its code and slot residuals; a miss reads its
    direction, radiance and throughput, writes the radiance and its
    direction and throughput residuals; a hit reads the state and its
    seed, writes the state and its ten float residuals; a triangle hit
    reads the sweep's object and payload; bounce 0's hits write the normal
    and depth; the scene table; the count."""
    n = plan.n
    hit = code >= 0
    n_live = int((code != diff_trip.DEAD).sum())
    n_hit, n_tri = int(hit.sum()), int((hit & (code % 2 == 1)).sum())
    n_miss = n_live - n_hit
    first_hits = n_hit if b == 0 else 0
    nbytes = (n * 4 + (n - n_live) * 8 + n_live * (4 + (4 if plan.mesh else 0) + 8 + 4 + 8)
              + n_miss * (36 + 12 + 24) + n_hit * (52 + 4 + 52 + 40) + n_tri * 40
              + first_hits * 16 + plan.tables.table.numel() * 4 + 4)
    return nbytes, n_hit * DIFF_HIT_FLOPS + n_miss * DIFF_MISS_FLOPS


def add_sum(sums, name, nbytes, flops):
    """One launch's work into ``sums[name]``: its bytes, float operations
    and bound (the larger of the two times, PERF.md section 2), summed."""
    bound_ms, _ = bound(flops, nbytes)
    e = sums.setdefault(name, dict(launches=0, bytes=0, flops=0, bound_ms=0.0))
    e["launches"] += 1
    e["bytes"] += nbytes
    e["flops"] += flops
    e["bound_ms"] += bound_ms


def trip_sums(render):
    """``render()`` with the work of every trip's kernels counted as it
    runs, by trip_work's and nee_trip_work's rules, on the fly from each
    trip's int state (no float state is kept): (render()'s result,
    {kernel: launches, bytes, flops, bound ms, summed over the render}),
    the NEE mode of trip_tail under "trip_tail"."""
    sums, cur = {}, {}
    head, nee, tail = trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail

    def counting_head(plan, F, I, buf):
        cur.update(I=I.clone(), sweep=None)
        return head(plan, F, I, buf)

    def counting_nee(plan, F, I, buf, sweep=None):
        cur["sweep"] = sweep
        return nee(plan, F, I, buf, sweep)

    def counting_tail(plan, F, I, buf, sweep=None, occ=None):
        out = tail(plan, F, I, buf, sweep, occ)
        rec = dict(plan=plan, I=cur["I"], sweep=cur["sweep"] if plan.nee else sweep,
                   hint=buf.hint, occ=occ,
                   nee=dict(alive_next=buf.alive_next, nee_mask=buf.nee_mask))
        w = trip_work(rec, I)
        add_sum(sums, "trip_head", w["head_bytes"], w["head_flops"])
        if plan.nee:
            nw = nee_trip_work(rec, I)
            add_sum(sums, "trip_nee", nw["nee_bytes"], nw["nee_flops"])
            add_sum(sums, "trip_tail", nw["tail_bytes"], nw["tail_flops"])
        else:
            add_sum(sums, "trip_tail", w["tail_bytes"], w["tail_flops"])
        return out

    trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail = (
        counting_head, counting_nee, counting_tail)
    try:
        out = render()
    finally:
        trip_kernel.trip_head, trip_kernel.trip_nee, trip_kernel.trip_tail = head, nee, tail
    return out, sums


def print_sums(label, sums, device_ms):
    """Each kernel's summed bound beside the profiler's summed device ms
    (``device_ms``: {kernel: ms}, None where not measured) and the share;
    returns the entries with those added."""
    out = {}
    for name, e in sums.items():
        dev = device_ms.get(name)
        out[name] = dict(e, device_ms=dev, share_of_bound=e["bound_ms"] / dev if dev else None)
        print(f"  {label}, {name} summed over the path: {e['launches']} launches, "
              f"{e['bytes'] / 1e6:.1f} MB, {e['flops'] / 1e9:.4f} GFLOP, bound "
              f"{e['bound_ms']:.4f} ms; device "
              + (f"{dev:.4f} ms (profiler), {e['bound_ms'] / dev:.1%} of it" if dev else
                 "ms not measured") + f"  [{smi}]")
    return out


def require_equal_state(name, got, want):
    """F and I of two runs exact; on a difference, which rows and how many
    values moved, before failing."""
    for label, a, b, keys in (("F", got[0], want[0], trip_kernel.F_KEYS),
                              ("I", got[1], want[1], trip_kernel.I_KEYS)):
        if not torch.equal(a, b):
            moved = {k: int((a[j] != b[j]).sum()) for j, k in enumerate(keys)
                     if not torch.equal(a[j], b[j])}
            gap = ulp_gap(a, b) if label == "F" else "n/a"
            raise AssertionError(f"{name}: {label} differs from the twin: values moved by row "
                                 f"{moved} (max ulp gap {gap})")


def compare_trip(label, rec, reps=20):
    """trip_head and trip_tail against their twins on one recorded trip,
    every output exact (and the head's equal to what the render's own
    call wrote), each starting from the buffers the render's head found;
    the kernels' time by CUDA events over the wrapper and on the device
    (``kernel_ms``: without the host's issue, which the events over the
    wrapper time on a trip with few live lanes), the twins', the work, the
    bounds (the share of the device time)."""
    plan, F, I = rec["plan"], rec["F"], rec["I"]
    bk, bp = trip_kernel.trip_buffers(plan), trip_kernel.trip_buffers(plan)
    for b in (bk, bp):
        for k in HEAD_OUT:
            if getattr(b, k) is not None:
                getattr(b, k).copy_(rec["pre"][k])
    trip_kernel.trip_head(plan, F, I, bk)
    trip_kernel.trip_head_plain(plan, F, I, bp)
    torch.cuda.synchronize()
    head_k = [bk.hrec, bk.hint] + ([bk.rows, bk.act_p] if plan.mesh else [])
    head_p = [bp.hrec, bp.hint] + ([bp.rows, bp.act_p] if plan.mesh else [])
    require_equal(f"trip_head {label}", head_k, head_p)
    require_equal(f"trip_head {label} vs the render's call", head_k,
                  [rec[k] for k in HEAD_OUT][:len(head_k)])
    for b in (bk, bp):
        b.hrec.copy_(rec["hrec"])
        b.hint.copy_(rec["hint"])
    head_ms = cuda_ms(lambda: trip_kernel.trip_head(plan, F, I, bk), reps)
    head_dev_ms = kernel_ms(lambda: None, lambda: trip_kernel.trip_head(plan, F, I, bk), reps)
    head_plain_ms = cuda_ms(lambda: trip_kernel.trip_head_plain(plan, F, I, bp), 2)
    for b in (bk, bp):  # what the render's head wrote, as the kernels after it read it
        b.hrec.copy_(rec["hrec"])
        b.hint.copy_(rec["hint"])
    timings = {}
    if plan.nee:
        # trip_nee on the render's head and sweep, from the buffers its own
        # trip_nee found; the NEE tail on what the render's trip_nee wrote
        # and the any-hit sweep's occlusion
        def load(keys_from):
            for b in (bk, bp):
                for k, v in keys_from.items():
                    if v is not None:
                        getattr(b, k).copy_(v)

        load(rec["nee_pre"])
        Fk, Ik, Fp, Ip = F.clone(), I.clone(), F.clone(), I.clone()
        trip_kernel.trip_nee(plan, Fk, Ik, bk, rec["sweep"])
        trip_kernel.trip_nee_plain(plan, Fp, Ip, bp, rec["sweep"])
        torch.cuda.synchronize()
        require_equal_state(f"trip_nee {label}", (Fk, Ik), (Fp, Ip))
        nee_k = [getattr(bk, k) for k in NEE_OUT if getattr(bk, k) is not None]
        require_equal(f"trip_nee {label}", nee_k,
                      [getattr(bp, k) for k in NEE_OUT if getattr(bp, k) is not None])
        require_equal_state(f"trip_nee {label} vs the render's call", (Fk, Ik),
                            (rec["F2"], rec["I2"]))
        require_equal(f"trip_nee {label} vs the render's call", nee_k,
                      [v for v in rec["nee"].values() if v is not None])

        def restore_nee():
            Fk.copy_(F)
            Ik.copy_(I)

        timings["trip_nee"] = (
            events_ms(restore_nee, lambda: trip_kernel.trip_nee(plan, Fk, Ik, bk, rec["sweep"]),
                      reps),
            kernel_ms(restore_nee, lambda: trip_kernel.trip_nee(plan, Fk, Ik, bk, rec["sweep"]),
                      reps),
            events_ms(restore_nee, lambda: trip_kernel.trip_nee_plain(plan, Fk, Ik, bp,
                                                                      rec["sweep"]), 2))
        load(rec["nee"])
        F_in, I_in, tail_args = rec["F2"], rec["I2"], dict(occ=rec["occ"])
    else:
        F_in, I_in, tail_args = F, I, dict(sweep=rec["sweep"])
    Fk, Ik, Fp, Ip = F_in.clone(), I_in.clone(), F_in.clone(), I_in.clone()
    trip_kernel.trip_tail(plan, Fk, Ik, bk, **tail_args)
    trip_kernel.trip_tail_plain(plan, Fp, Ip, bp, **tail_args)
    torch.cuda.synchronize()
    mode = " (NEE mode)" if plan.nee else ""
    require_equal_state(f"trip_tail{mode} {label}", (Fk, Ik), (Fp, Ip))
    require_equal(f"trip_tail{mode} {label} count", [bk.count], [bp.count])
    work = trip_work(rec, Ik)
    if plan.nee:
        nee_work = nee_trip_work(rec, Ik)
        work.update(nee_work, tail_flops=nee_work["tail_flops"])

    def restore():
        Fk.copy_(F_in)
        Ik.copy_(I_in)

    timings["trip_tail"] = (
        events_ms(restore, lambda: trip_kernel.trip_tail(plan, Fk, Ik, bk, **tail_args), reps),
        kernel_ms(restore, lambda: trip_kernel.trip_tail(plan, Fk, Ik, bk, **tail_args), reps),
        events_ms(restore, lambda: trip_kernel.trip_tail_plain(plan, Fk, Ik, bp, **tail_args), 2))
    out = {}
    for name, (ms, dev_ms, plain_ms) in dict(trip_head=(head_ms, head_dev_ms, head_plain_ms),
                                             **timings).items():
        nbytes, flops = work[f"{name[5:]}_bytes"], work[f"{name[5:]}_flops"]
        bound_ms, bound_by = bound(flops, nbytes)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, share_of_bound=bound_ms / dev_ms,
                         max_abs_err=0.0, bytes=nbytes, flops=flops)
    nee_note = (f", {work['open_term_lanes']} lanes of {work['terms']} NEE term(s) past the "
                f"sphere test, {work['lit_term_lanes']} lit" if plan.nee else "")
    print(f"{label}: {work['lanes']} lanes, {work['live']} live, {work['ended']} samples ended, "
          f"{work['restarts']} restarts, {work['mesh_hits']} mesh hits{nee_note}; "
          f"{', '.join(out)} equal to their twins (every output)")
    for name, r in out.items():
        print(f"  {name}{' (NEE mode)' if name == 'trip_tail' and plan.nee else ''} "
              f"{r['ms']:.4f} ms a call (events), {r['device_ms']:.4f} ms on the device, "
              f"twin {r['plain_ms']:.3f} ms; {r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.4f} GFLOP; "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['share_of_bound']:.1%} of it")
    return dict(out, work=work)


if sys.argv[1:2] == ["--band-rank"]:
    band_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)
if sys.argv[1:2] == ["--harness-rank"]:
    harness_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)

# --- 0 -------------------------------------------------------------------
phase("0 environment")
smi = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True,
).stdout.strip().splitlines()[0]
print(f"card: {smi}")
try:
    import triton

    triton_version = triton.__version__
except ImportError:
    triton_version = "absent"
nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[-1]
print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
      f"nvcc {nvcc}  triton {triton_version}")
print(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
      f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

# --- 1 -------------------------------------------------------------------
phase("1 build")
t0 = time.perf_counter()
# the library with the walk kernels' per-packet stamps (-DTPUPT_SWEEP_PROFILE),
# built beside the plain one: phase 9 reads from its stamps which route
# walked each packet
builds = concurrent.futures.ThreadPoolExecutor(1)
profile_build = builds.submit(kernels.build, ["-DTPUPT_SWEEP_PROFILE"])
kernels.load()
profile_lib = kernels.bind(profile_build.result())
builds.shutdown()
profile_lib.tpupt_sweep_profile_buffer.restype = ctypes.c_int
profile_lib.tpupt_sweep_profile_buffer.argtypes = [ctypes.c_void_p]
print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {kernels.library_path()}, "
      f"and the profile build")
with open(kernels.library_path() + ".log") as fh:
    print("".join(ln for ln in fh if "registers" in ln or "Compiling" in ln).rstrip())

# --- scene (shared by phases 2-5) ---------------------------------------
ensure_models(names=["bunny.obj"])
desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
t0 = time.perf_counter()
scene = desc.build(leaf_size=32, device=DEV)
K, L = scene.tre_min.shape[0], scene.s_leaf_size
print(f"bunny.json built in {time.perf_counter() - t0:.2f} s: K={K} treelets of L={L}")

# --- 2 -------------------------------------------------------------------
phase("2 winner_step vs twin, sz=4096")
rng = np.random.default_rng(0)
sz, p, rl = 4096, 256, 64
tids = rng.integers(0, K, (sz, rl // L))
comps = (scene.tre_tris.view(K, 13, L)[torch.from_numpy(tids).to(DEV)]
         .permute(0, 2, 1, 3).reshape(sz, 13, rl).contiguous())
# each ray aims from around the scene at a point inside one triangle of its
# row's first treelet (a pad triangle's ray misses)
j = torch.from_numpy(rng.integers(0, L, (sz, p))).to(DEV)
tri = torch.gather(comps[:, :9, :], 2, j[:, None, :].expand(sz, 9, p))  # (sz, 9, p)
target = tri[:, 0:3] + 0.3 * tri[:, 3:6] + 0.3 * tri[:, 6:9]
o = torch.from_numpy(rng.uniform(-3.0, 3.0, (sz, 3, p)).astype(np.float32)).to(DEV)
o[:, 1] += 2.0
d = target - o
d = (d / d.norm(dim=1, keepdim=True)).permute(0, 2, 1)
o = o.permute(0, 2, 1)
rows = {k: v.contiguous() for k, v in dict(
    rox=o[..., 0], roy=o[..., 1], roz=o[..., 2], rdx=d[..., 0], rdy=d[..., 1], rdz=d[..., 2],
    tmin=torch.full((sz, p), 1e-4, device=DEV),
    t=torch.where(torch.rand((sz, p), device=DEV, generator=torch.Generator(DEV).manual_seed(1))
                  < 0.2, 4.0, 3.0e38)).items()}
slots = torch.from_numpy((tids[:, :, None] * L + np.arange(L)).reshape(sz, rl)).int().to(DEV)
live = torch.from_numpy((rng.random((sz, rl)) < 0.9).astype(np.float32)).to(DEV)
out_k = step_kernel.winner_step(rows, comps, live, slots)
out_p = step_kernel.winner_step_plain(rows, comps, live, slots)
torch.cuda.synchronize()
require_equal("winner_step", out_k, out_p)
n_hit = int((out_k[0] < 3.0e38).sum())
assert n_hit > 1000, f"winner_step inputs produced only {n_hit} hits"
ws_ms = cuda_ms(lambda: step_kernel.winner_step(rows, comps, live, slots), 20)
ws_plain_ms = cuda_ms(lambda: step_kernel.winner_step_plain(rows, comps, live, slots), 5)
# every (lane, pair) is tested, the live mask only masks
ws_bound_ms, ws_bound_by = bound(
    sz * p * rl * MT_FLOPS, 4 * (sz * p * (8 + 6) + sz * rl * (13 + 2)))
print(f"equal on all 6 channels ({n_hit} hit lanes); kernel {ws_ms:.4f} ms, twin {ws_plain_ms:.4f} ms; "
      f"bound {ws_bound_ms:.4f} ms ({ws_bound_by}), {ws_bound_ms / ws_ms:.1%} of it  [{smi}]")
# the reciprocal winner_step and the any-hit walk use in place of the
# division, against `1.0f / a` on all 2^32 floats
rcp_by_exp = torch.zeros(257, dtype=torch.int64, device=DEV)
kernels.check(kernels.load(), kernels.load().tpupt_rcp_check(rcp_by_exp.data_ptr(),
                                                             kernels.stream_of(rcp_by_exp)),
              "rcp_check")
rcp_declined = [i for i, v in enumerate(rcp_by_exp[:256].tolist()) if v]
assert int(rcp_by_exp[256]) == 0, f"the fast reciprocal differs from the division: {rcp_by_exp}"
print(f"fast reciprocal: equal to 1.0f / a on every float it takes; it leaves biased exponents "
      f"{rcp_declined} (where it would differ) to the division")

# --- 3 -------------------------------------------------------------------
phase("3 treelet_closest_hit vs twin on bunny.json, 1024^2")
n = SIZE * SIZE
fx, fy = pixel_centers(SIZE, SIZE, device=DEV)
ro, rd = generate_rays(desc.camera.to(DEV), SIZE, SIZE, fx, fy)


def sphere_seed(ro, rd, t_min, active):
    z = torch.zeros(ro.x.shape[0], device=DEV)
    return intersect._sphere_pass(
        scene, ro, rd, t_min, active, z + intersect.BIG_T, z.int() - 1, z.long() - 1,
        z.long() - 1,
    )[0]


def pack(ro, rd, t_min, active):
    """The rows and active mask intersect_treelets hands the sweep on
    bunny.json, the sphere pass's t as the seed."""
    return packets._pack_rows(ro, rd, t_min, sphere_seed(ro, rd, t_min, active), active)


def compare_sweep(label, scn, rows, act_p, same_rays=None, plain_reps=2):
    """The kernel against its twin on one packed batch of ``scn``'s table,
    all six outputs exact; the work the twin's loop counts, the bound and
    the times (the twin's over ``plain_reps`` calls).  ``same_rays`` is this
    function's result on the same rays in another packing: the rays need no
    more work than the lesser of the two counts, so the bound takes that
    one."""
    k3, l3 = scn.tre_min.shape[0], scn.s_leaf_size
    args = (rows, act_p, scn.tre_min, scn.tre_max, scn.tre_tris, l3)
    out_k = sweep_kernel.treelet_closest_hit(*args)
    work = {}
    out_p = sweep_kernel.treelet_closest_hit_plain(*args, stats=work)
    torch.cuda.synchronize()
    require_equal(f"treelet_closest_hit {label}", out_k, out_p)
    hit = out_k[1] >= 0
    err = float((out_k[0][hit] - out_p[0][hit]).abs().max()) if bool(hit.any()) else 0.0
    ms = cuda_ms(lambda: sweep_kernel.treelet_closest_hit(*args), 20)
    plain_ms = cuda_ms(lambda: sweep_kernel.treelet_closest_hit_plain(*args), plain_reps)
    lanes = act_p.numel()
    packed_flops = work["slab_tests"] * SLAB_FLOPS + work["mt_pairs"] * MT_FLOPS
    flops = packed_flops if same_rays is None else min(packed_flops, same_rays["gflop"] * 1e9)
    # each input read once (act per lane, 8 f32 rows per live lane: an
    # inactive lane's rows need no read; boxes and blocks per treelet), each
    # of the 6 outputs written once
    nbytes = lanes * (1 + 6 * 4) + work["live_lanes"] * 8 * 4 + k3 * (6 + 13 * l3) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"{label}: K={k3}; {work['live_lanes']} live lanes in {lanes // packets.PACKET} packets, "
          f"{int(hit.sum())} mesh hits; all 6 outputs equal to the twin")
    print(f"  work: {work['supers_hit']} supers hit, {work['slab_tests']} slab tests, "
          f"{work['visits']} treelet visits (at most {work['visits_max']} in a packet), "
          f"{work['mt_pairs']} MT pairs = {packed_flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.1f} MB"
          + ("" if flops == packed_flops else
             f"; the bound counts the other packing's {flops / 1e9:.4f} GFLOP"))
    print(f"  kernel {ms:.4f} ms, twin {plain_ms:.3f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}, {PEAK_FLOPS / 1e12:.0f} TFLOP/s), "
          f"{bound_ms / ms:.1%} of it")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, hits=int(hit.sum()), work=work, gflop=flops / 1e9,
                packed_gflop=packed_flops / 1e9, share_of_bound=bound_ms / ms, treelets=k3)


def call_ms(ro, rd, t_min, active):
    """The whole intersect_treelets call on bunny.json, packing included."""
    t_seed = sphere_seed(ro, rd, t_min, active)
    ms = cuda_ms(lambda: packets.intersect_treelets(scene, ro, rd, t_min, t_seed, active), 20)
    print(f"  intersect_treelets call {ms:.4f} ms")
    return ms


t_min = torch.full((n,), 1e-4, device=DEV)
all_lanes = torch.ones(n, dtype=torch.bool, device=DEV)
primary = compare_sweep("pixel-centre primaries", scene, *pack(ro, rd, t_min, all_lanes))
primary["call_ms"] = call_ms(ro, rd, t_min, all_lanes)
# secondaries: one bounce of the render's own jittered primaries
pix = torch.arange(n, device=DEV)
st, seed = integrator._fresh_state(scene, desc.camera.to(DEV), SIZE, SIZE, pix, 0)
_ids, hit0 = intersect.intersect_scene_ids(scene, st["ro"], st["rd"], st["t_min"], st["alive"])
ro2, rd2, tmin2, *_ = shade(scene, hit0, st["ro"], st["rd"], st["t_min"], st["color"], seed,
                            torch.zeros_like(pix))
secondary = compare_sweep("secondaries after bounce 0", scene, *pack(ro2, rd2, tmin2, hit0.mask))
secondary["call_ms"] = call_ms(ro2, rd2, tmin2, hit0.mask)

# --- 3a ------------------------------------------------------------------
phase("3a treelet_closest_hit(payload=True) vs twin, same inputs, on the rebaked table")
with torch.no_grad():
    scene_r = rebake_treelets(scene)  # the table the differentiable render traces
UNIT = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=DEV)


def compare_payload(label, scn_r, rows, act_p):
    """The payload form on one packed batch of the rebaked table ``scn_r``
    against its twin (all 15 outputs exact) and against the 6-channel
    kernel (its 6 outputs exact); the payload against the slot table's
    rows; both kernels' times in turns."""
    k3, l3 = scn_r.tre_min.shape[0], scn_r.s_leaf_size
    with torch.no_grad():
        table_r = intersect.slot_tri_table(scn_r)
    args = (rows, act_p, scn_r.tre_min, scn_r.tre_max, scn_r.tre_tris, l3)
    out_k = sweep_kernel.treelet_closest_hit(*args, payload=True)
    work = {}
    out_p = sweep_kernel.treelet_closest_hit_plain(*args, stats=work, payload=True)
    six = sweep_kernel.treelet_closest_hit(*args)
    torch.cuda.synchronize()
    assert len(out_k) == len(out_p) == 15
    require_equal(f"payload form {label}", out_k, out_p)
    require_equal(f"payload form {label} vs the 6-channel kernel", out_k[:6], six)
    slot = out_k[1].reshape(-1)
    pay = torch.stack([o.reshape(-1) for o in out_k[6:]], dim=1)
    hit = slot >= 0
    assert torch.equal(pay[hit], table_r[slot[hit].long()]), f"{label}: payload != slot table rows"
    assert torch.equal(pay[~hit], UNIT.expand(int((~hit).sum()), 9)), f"{label}: no-hit payload"
    # in turns: 6-channel, payload, payload, 6-channel
    six_ms, pay_ms = [], []
    for which in (six_ms, pay_ms, pay_ms, six_ms):
        kw = dict(payload=True) if which is pay_ms else {}
        which.append(cuda_ms(lambda: sweep_kernel.treelet_closest_hit(*args, **kw), 20))
    plain_ms = cuda_ms(lambda: sweep_kernel.treelet_closest_hit_plain(*args, payload=True), 2)
    lanes = act_p.numel()
    flops = work["slab_tests"] * SLAB_FLOPS + work["mt_pairs"] * MT_FLOPS
    nbytes = lanes * (1 + 6 * 4 + 9 * 4) + work["live_lanes"] * 8 * 4 + k3 * (6 + 13 * l3) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    ms = sum(pay_ms) / 2
    print(f"{label}: K={k3}; {int(hit.sum())} mesh hits; all 15 outputs equal to the twin, the "
          f"first 6 to the 6-channel kernel's, the payload to the slot table's rows")
    print(f"  work: {work['slab_tests']} slab tests, {work['visits']} visits, {work['mt_pairs']} MT "
          f"pairs = {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.1f} MB")
    print(f"  payload kernel {pay_ms[0]:.4f}, {pay_ms[1]:.4f} ms; 6-channel kernel {six_ms[0]:.4f}, "
          f"{six_ms[1]:.4f} ms (in turns): payload/6-channel {ms / (sum(six_ms) / 2):.3f}; "
          f"twin {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it")
    return dict(ms=ms, ms_runs=pay_ms, six_ms_runs=six_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=0.0, hits=int(hit.sum()), work=work,
                gflop=flops / 1e9)


pay_primary = compare_payload("pixel-centre primaries", scene_r, *pack(ro, rd, t_min, all_lanes))
pay_secondary = compare_payload("secondaries after bounce 0", scene_r,
                                *pack(ro2, rd2, tmin2, hit0.mask))

# --- 4 -------------------------------------------------------------------
phase(f"4 main path: bunny.json render {SIZE}^2, {SPP} spp, {MAX_BOUNCES} bounces, rr {RR}")
counts_at_reset = trace.launch_counts()


def reset_counts():
    counts_at_reset.update(trace.launch_counts())


def read_counts():
    """Every hand-written kernel's launches since the last reset_counts()."""
    return {k: n - counts_at_reset[k] for k, n in trace.launch_counts().items()}


reset_counts()
torch.cuda.synchronize()
t0 = time.perf_counter()
buf, rays = tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=SPP,
                                     max_bounces=MAX_BOUNCES, rr_start=RR, device=DEV)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
launches = read_counts()
rays = int(rays)
img = buf.color
assert launches["treelet_closest_hit"] > 0, launches
assert launches["treelet_closest_hit(payload=True)"] == 0, launches
assert launches["treelet_any_hit"] == 0, launches  # bunny.json has no emitter
assert (launches["treelet_closest_hit"], rays) == (FWD_LAUNCHES, FWD_SEGMENTS), \
    f"the forward render's counts moved: {launches}, {rays} segments"
# the main path is the trip route: one trip_head and one trip_tail a trip
assert integrator.render_route(scene) == "trip"
assert launches["trip_head"] == launches["trip_tail"] == FWD_LAUNCHES, launches
assert launches["trip_nee"] == 0, launches  # bunny.json has no emitter
assert rays > n, rays
assert tuple(img.shape) == (n, 3) and bool(torch.isfinite(img).all()), "non-finite image"
assert bool(torch.isfinite(buf.normal).all() and torch.isfinite(buf.depth).all())
mean = img.mean(dim=0).tolist()
assert 0.05 < min(mean) and max(mean) < 1.5, f"implausible mean colour {mean}"
print(f"first call {first_s:.2f} s; the trip route; launches {launches}; {rays} traced "
      f"segments; mean colour {[round(x, 4) for x in mean]}")
walls = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf2, rays2 = tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=SPP,
                                           max_bounces=MAX_BOUNCES, rr_start=RR, device=DEV)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    assert int(rays2) == rays and torch.equal(buf2.color, img), "render is not deterministic"
wall = sorted(walls)[1]
print(f"calls 2-4: {', '.join(f'{w:.3f}' for w in walls)} s wall; median {wall:.3f} s = "
      f"{rays / wall / 1e6:.3f} traced Mrays/s  [{smi}]")
os.makedirs(OUT, exist_ok=True)
np.save(os.path.join(OUT, "bunny_1024_16spp.npy"),
        img.reshape(SIZE, SIZE, 3).cpu().numpy().astype(np.float16))
# device time of one more render, by kernel (torch.profiler over CUPTI)
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=SPP, max_bounces=MAX_BOUNCES,
                             rr_start=RR, device=DEV)
    torch.cuda.synchronize()
kav = prof.key_averages()
kern = [e for e in kav if e.self_device_time_total > 0]
with open(os.path.join(OUT, "render_profile.txt"), "w") as fh:
    fh.write(kav.table(sort_by="self_device_time_total", row_limit=40))
busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
sweep = [e for e in kern if "treelet_closest_hit_kernel" in e.key]
sweep_ms = sum(e.self_device_time_total for e in sweep) / 1e3
if busy_ms > 0:
    print(f"profiled render: device busy {busy_ms:.1f} ms = {busy_ms / 1e3 / wall:.1%} of the median "
          f"wall; treelet_closest_hit_kernel {sweep_ms:.1f} ms in {sum(e.count for e in sweep)} "
          f"launches = {sweep_ms / busy_ms:.1%} of busy; {sum(e.count for e in kern)} kernels")
else:
    print("profiled render: the profiler recorded no device time (not measured)")

# --- 4a ------------------------------------------------------------------
phase("4a trip_head and trip_tail vs their twins on bunny.json trips 0, 2 and the last; the "
      "render by the trip route and by the body route, in turns")


# the default hit pass wrapped: render_route sends any other intersect_fn,
# this one too, to the body route (``_bounce_body``)
BODY_ROUTE = functools.partial(intersect.intersect_scene_ids)


def bunny_render(route="trip"):
    """Phase 4's render by ``route``: "trip" (the route the call picks) or
    "body" (``_bounce_body``, on the same hit pass)."""
    fn = BODY_ROUTE if route == "body" else None
    assert integrator.render_route(scene, False, fn) == route
    return tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=SPP,
                                    max_bounces=MAX_BOUNCES, rr_start=RR, device=DEV,
                                    intersect_fn=fn)


LAST_TRIP = FWD_LAUNCHES - 1
_, trips_b, kept_b = record_trip_inputs(bunny_render, {0, 2, LAST_TRIP})
assert trips_b == FWD_LAUNCHES, trips_b
trip_checks = {}
for t in (0, 2, LAST_TRIP):
    trip_checks[f"bunny_trip{t}"] = compare_trip(
        f"bunny.json {SIZE}^2 trip {t}{' (the last)' if t == LAST_TRIP else ''}", kept_b.pop(t))
del kept_b
# the whole render by each route, in turns: bit-equal, the same counts
route_walls = {"trip": [], "body": []}
for route in ("trip", "body", "body", "trip"):
    reset_counts()
    (b_r, r_r), w_r = timed(lambda: bunny_render(route=route))
    c_r = read_counts()
    assert (int(r_r), c_r["treelet_closest_hit"]) == (FWD_SEGMENTS, FWD_LAUNCHES), (route, c_r)
    assert c_r["trip_tail"] == c_r["trip_head"] == (FWD_LAUNCHES if route == "trip" else 0), c_r
    assert c_r["trip_nee"] == 0, c_r
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(b_r, key), getattr(buf, key)), f"{route} route: {key} differs"
    route_walls[route].append(w_r)
    del b_r
route_info = {}
for route in ("trip", "body"):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        bunny_render(route=route)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    wall_r = sum(route_walls[route]) / len(route_walls[route])

    def dev_ms(name):
        return sum(e.self_device_time_total for e in kern if name in e.key) / 1e3

    r_busy = sum(e.self_device_time_total for e in kern) / 1e3
    n_kern = sum(e.count for e in kern)
    route_info[route] = dict(walls_s=route_walls[route], profiled_device_busy_ms=r_busy,
                             busy_share=r_busy / 1e3 / wall_r, kernels=n_kern,
                             kernels_per_trip=n_kern / FWD_LAUNCHES,
                             sweep_ms=dev_ms("treelet_closest_hit_kernel"),
                             trip_head_ms=dev_ms("trip_head_kernel"),
                             trip_tail_ms=dev_ms("trip_tail_kernel"))
    print(f"{route} route: walls {', '.join(f'{w:.3f}' for w in route_walls[route])} s "
          f"({FWD_SEGMENTS / wall_r / 1e6:.3f} Mrays/s); "
          + (f"profiled: device busy {r_busy:.1f} ms = {r_busy / 1e3 / wall_r:.1%} of the mean "
             f"wall, {n_kern} kernels = {n_kern / FWD_LAUNCHES:.1f} a trip; the sweep "
             f"{route_info[route]['sweep_ms']:.1f} ms, trip_head "
             f"{route_info[route]['trip_head_ms']:.1f} ms, trip_tail "
             f"{route_info[route]['trip_tail_ms']:.1f} ms" if r_busy > 0 else
             "the profiler recorded no device time (not measured)") + f"  [{smi}]")
print(f"the two routes' renders are bit-equal, {FWD_SEGMENTS} segments and {FWD_LAUNCHES} sweep "
      f"launches each; body/trip mean wall "
      f"{sum(route_walls['body']) / sum(route_walls['trip']):.2f}")
# the trip kernels' work summed over every trip of the render, beside
# their device ms summed over the profiled render
_, sums_b = trip_sums(bunny_render)
bunny_sums = print_sums("bunny.json render", sums_b, {
    k: route_info["trip"][f"{k}_ms"] for k in ("trip_head", "trip_tail")})
assert all(e["launches"] == FWD_LAUNCHES for e in bunny_sums.values()), bunny_sums

# --- 5 -------------------------------------------------------------------
phase("5 render parity, kernel vs twin: 256^2, 2 spp, 8 bounces")
twin = lambda *a: intersect.intersect_scene_ids(
    *a, closest_hit=sweep_kernel.treelet_closest_hit_plain)
bk, rk = tpupt_torch.render_image(scene, desc.camera, 256, 256, spp=2, max_bounces=8, device=DEV)
bp, rp = tpupt_torch.render_image(scene, desc.camera, 256, 256, spp=2, max_bounces=8,
                                  intersect_fn=twin, device=DEV)
assert int(rk) == int(rp), (int(rk), int(rp))
for key in ("color", "normal", "depth"):
    a, b = getattr(bk, key), getattr(bp, key)
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), key
    print(f"{key}: max |kernel - twin| = {float((a - b).abs().max()):.3g}")
print(f"ray count equal: {int(rk)}")

# --- 6 -------------------------------------------------------------------
phase(f"6 main path, fwd+bwd: bunny.json {SIZE}^2, {DIFF_SPP} spp, {DIFF_BOUNCES} bounces, "
      f"loss sum(color^2), backward to every extract_params leaf; the diff_trip route and the "
      f"body route in turns; diff_trip_fwd, diff_trip_bwd and slot_scatter vs their twins on "
      f"bounces 0, 2 and the last of a sample")


def fwd_bwd(size=SIZE, spp=DIFF_SPP, max_bounces=DIFF_BOUNCES, intersect_fn=None, denoise=False,
            scn=None, cam=None, any_hit=None):
    """One step: a differentiable render from fresh params, the loss, its
    backward, on ``scn`` seen by ``cam`` (bunny.json's by default).  Returns
    (loss, segments, {leaf: grad}, buffers, forward s, backward s), the two
    times on the host clock between synchronisations."""
    scn, cam = (scene, desc.camera) if scn is None else (scn, cam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tpupt_torch.extract_params(scn)
    buf, rays = tpupt_torch.render_image(
        tpupt_torch.with_params(scn, params), cam, size, size, spp=spp,
        max_bounces=max_bounces, differentiable=True, intersect_fn=intersect_fn, any_hit=any_hit)
    if denoise:
        img = tpupt_torch.atrous_denoise(buf.color.reshape(size, size, 3),
                                         buf.normal.reshape(size, size, 3),
                                         buf.depth.reshape(size, size), cam, filter_size=10)
        loss = (img ** 2).sum()
    else:
        loss = (buf.color ** 2).sum()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    leaves = [leaf(params, k) for k in LEAVES]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return loss.detach(), int(rays), dict(zip(LEAVES, grads)), buf, t1 - t0, t2 - t1


# the same ids pass wrapped: render_route sends it to the body route
# (autograd over ``_bounce_body``, the fetch's backward in slot_scatter)
BODY_DIFF = functools.partial(intersect.intersect_scene_ids_diff)
assert integrator.render_route(scene, True) == "diff_trip"
assert integrator.render_route(scene, True, BODY_DIFF) == "body"
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
mem0 = torch.cuda.memory_allocated()
reset_counts()
t0 = time.perf_counter()
d_loss, d_rays, d_grads, d_buf, _, _ = fwd_bwd()
torch.cuda.synchronize()
d_first_s = time.perf_counter() - t0
d_launches = read_counts()
d_peak = torch.cuda.max_memory_allocated() - mem0
assert d_launches["treelet_closest_hit"] == 0 and d_launches["winner_step"] == 0, d_launches
# the main path is the differentiable trip: a bounce is trip_head, the
# payload sweep and diff_trip_fwd, its backward one diff_trip_bwd, which
# scatters the winner rows into the slot table's gradient itself (no
# slot_scatter); no trip_tail
assert (d_launches["diff_trip_fwd"] == d_launches["trip_head"]
        == d_launches["treelet_closest_hit(payload=True)"] > 0), d_launches
assert d_launches["diff_trip_bwd"] == d_launches["diff_trip_fwd"], d_launches
assert d_launches["slot_scatter"] == 0, d_launches
assert d_launches["trip_tail"] == d_launches["trip_nee"] == 0, d_launches
assert d_rays > n, d_rays
assert bool(torch.isfinite(d_loss)), d_loss
for k, g in d_grads.items():
    assert bool(torch.isfinite(g).all()), f"non-finite gradient of {k}"
assert float(d_grads["positions"].abs().max()) > 0, "no gradient reached the vertex positions"
print(f"first call {d_first_s:.3f} s; the diff_trip route; launches {d_launches}; {d_rays} primal "
      f"segments; loss {float(d_loss):.6g}; peak memory {d_peak / 2**30:.2f} GiB above the "
      f"{mem0 / 2**30:.2f} GiB resident before it")
print("  max |grad|: " + ", ".join(f"{k} {float(g.abs().max()):.4g}" for k, g in d_grads.items()))
d_walls, d_split = [], []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss2, rays2, grads2, _, f_s, b_s = fwd_bwd()
    torch.cuda.synchronize()
    d_walls.append(time.perf_counter() - t0)
    d_split.append((f_s, b_s))
    assert rays2 == d_rays, "the fwd+bwd step's segment count is not deterministic"
d_wall = sorted(d_walls)[1]
print(f"calls 2-4: {', '.join(f'{w:.3f}' for w in d_walls)} s wall; median {d_wall:.3f} s = "
      f"{d_rays / d_wall / 1e6:.3f} fwd+bwd Mrays/s (primal segments)  [{smi}]")
print("  forward + loss / backward: " + ", ".join(f"{f:.3f} / {b:.3f} s" for f, b in d_split))
del loss2, grads2

# the two routes in turns (diff_trip, body, body, diff_trip), one process:
# the forward bit-equal (loss, image, normal, depth, segments), every
# gradient within BASELINE's 1e-4 (rtol, and 1e-4 x the leaf's max |grad|)
# and no further from the first step's than 1e-5 x the leaf's max |grad|
route_steps, d_grads_body = {"diff_trip": [], "body": []}, None
for route in ("diff_trip", "body", "body", "diff_trip"):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    l_r, r_r, g_r, b_r, f_s, b_s = fwd_bwd(intersect_fn=BODY_DIFF if route == "body" else None)
    torch.cuda.synchronize()
    w_r = time.perf_counter() - t0
    c_r, peak_r = read_counts(), torch.cuda.max_memory_allocated() - m0
    assert (c_r["diff_trip_fwd"] > 0) == (route == "diff_trip") and c_r["trip_tail"] == 0, c_r
    assert r_r == d_rays and torch.equal(l_r, d_loss), (route, r_r, float(l_r), float(d_loss))
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(b_r, key), getattr(d_buf, key)), f"{route} route: {key} differs"
    gap = {}
    for k in LEAVES:
        scale = float(d_grads[k].abs().max())
        assert torch.allclose(g_r[k], d_grads[k], rtol=1e-4, atol=1e-4 * scale), (route, k)
        gap[k] = float((g_r[k] - d_grads[k]).abs().max()) / scale if scale > 0 else 0.0
        assert gap[k] <= 1e-5, (route, k, gap[k])
    route_steps[route].append(dict(wall_s=w_r, forward_s=f_s, backward_s=b_s, peak_bytes=peak_r,
                                   grad_gap=max(gap.values()), launches=c_r))
    if route == "body" and d_grads_body is None:
        d_grads_body = g_r  # phase 16's per-bounce placement runs this route
    del l_r, g_r, b_r
# device time of one more step of each route, by kernel and by op
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def dev_total(e):
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


route_prof = {}
for route, fname in (("diff_trip", "fwd_bwd_profile.txt"), ("body", "fwd_bwd_body_profile.txt")):
    with torch.profiler.profile(activities=acts) as prof:
        fwd_bwd(intersect_fn=BODY_DIFF if route == "body" else None)
        torch.cuda.synchronize()
    kav = prof.key_averages()
    with open(os.path.join(OUT, fname), "w") as fh:
        fh.write(kav.table(sort_by="self_device_time_total", row_limit=60))
    on_card = [e for e in kav if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(name):
        return sum(e.self_device_time_total for e in on_card if name in e.key) / 1e3

    index_add = [e for e in kav if e.key == "aten::index_add_"]
    route_prof[route] = dict(
        busy_ms=sum(e.self_device_time_total for e in on_card) / 1e3,
        kernels=sum(e.count for e in on_card), sweep_ms=dev_ms("treelet_closest_hit_kernel"),
        sweep_launches=sum(e.count for e in on_card if "treelet_closest_hit_kernel" in e.key),
        **{f"{k}_ms": dev_ms(f"{k}_kernel") for k in ("trip_head", "diff_trip_fwd",
                                                      "diff_trip_bwd", "slot_scatter")},
        index_add_calls=sum(e.count for e in index_add),
        index_add_ms=sum(dev_total(e) for e in index_add) / 1e3)
for route in ("diff_trip", "body"):
    st, pr = route_steps[route], route_prof[route]
    walls = [x["wall_s"] for x in st]
    wall_r = sum(walls) / len(walls)
    print(f"{route} route: walls {', '.join(f'{w:.3f}' for w in walls)} s "
          f"({d_rays / wall_r / 1e6:.3f} fwd+bwd Mrays/s); forward / backward "
          + ", ".join(f"{x['forward_s']:.3f} / {x['backward_s']:.3f}" for x in st)
          + " s; peak " + ", ".join(f"{x['peak_bytes'] / 2**30:.2f}" for x in st) + " GiB; largest "
          f"gradient gap to the first step's {max(x['grad_gap'] for x in st):.3g} of its leaf's "
          f"max |grad|  [{smi}]")
    if pr["busy_ms"] > 0:
        print(f"  profiled: device busy {pr['busy_ms']:.1f} ms = {pr['busy_ms'] / 1e3 / wall_r:.1%} "
              f"of the mean wall, {pr['kernels']} kernels; the payload sweep {pr['sweep_ms']:.1f} "
              f"ms in {pr['sweep_launches']}, trip_head {pr['trip_head_ms']:.2f}, diff_trip_fwd "
              f"{pr['diff_trip_fwd_ms']:.2f}, diff_trip_bwd {pr['diff_trip_bwd_ms']:.2f}, "
              f"slot_scatter {pr['slot_scatter_ms']:.2f} ms; index_add_ {pr['index_add_ms']:.1f} "
              f"ms in {pr['index_add_calls']} calls (not the fetch's, which is slot_scatter on "
              f"the body route and inside diff_trip_bwd on the diff_trip route: the positions' "
              f"gather backward in world_slot_tris, 3 a sample, and on the diff_trip route the "
              f"sphere leaves' sum per primitive, 1 a sample)")
    else:
        print("  profiled: the profiler recorded no device time (not measured)")
d_busy_ms, d_kernels = route_prof["diff_trip"]["busy_ms"], route_prof["diff_trip"]["kernels"]
d_sweep_ms, d_index_add_ms = route_prof["diff_trip"]["sweep_ms"], route_prof["diff_trip"]["index_add_ms"]
print(f"the two routes' steps: the forward bit-equal, {d_rays} segments each; body/diff_trip mean "
      f"wall {sum(x['wall_s'] for x in route_steps['body']) / sum(x['wall_s'] for x in route_steps['diff_trip']):.2f}")
del d_buf

# the three kernels against their twins on bounces 0, 2 and the last of
# the first sample of one more step: diff_trip_fwd every output exact (the
# residuals it writes); diff_trip_bwd's cotangent rows, leaf gradients and
# slot table gradient (its fused scatter's) within rtol 1e-5 (floor 1e-5 x
# the row's, leaf's or column's max) of the twin's VJP; slot_scatter on the
# winner rows of that bounce's twin VJP (what the twin's _FetchTriRows
# hands it) against index_add_ (the body route's old call) and its twin.
# Times on the device (``kernel_ms``), by events over the kernel's
# wrapper, the twins'; work by what each lane's case needs (each input
# read once, each output written once; diff_fwd_work).  The same step also
# sums trip_head's and diff_trip_fwd's work over all of its bounces
rec_fwd, rec_bwd, first_dp = {}, {}, []


def check_slot_scatter(label, rows, slot, cot):
    """slot_scatter on one (slot, cot) that a fetch backward hands it
    (slots as int32, as the kernel reads them; cot (N, 9), zero where the
    slot is -1) into a (rows, 9) table: against its twin and index_add_ of
    the clamped slots (the same function) at rtol 1e-5, floor 1e-5 x the
    max; timed (events, on the device), and its work: every lane's slot, a
    triangle lane's row, each row it adds into once."""
    slot = slot.to(torch.int32)
    g_k = slot_scatter(torch.zeros((rows, 9), device=DEV), slot, cot)
    g_p = slot_scatter_plain(torch.zeros((rows, 9), device=DEV), slot, cot)
    clamped = slot.clamp(min=0).long()
    g_lib = torch.zeros((rows, 9), device=DEV).index_add_(0, clamped, cot)
    torch.cuda.synchronize()
    scale = float(g_p.abs().max())
    for name, other in (("its twin", g_p), ("index_add_", g_lib)):
        assert torch.allclose(g_k, other, rtol=1e-5, atol=1e-5 * scale), \
            f"slot_scatter on {label} vs {name}"
    g_buf = torch.zeros((rows, 9), device=DEV)
    ms = events_ms(g_buf.zero_, lambda: slot_scatter(g_buf, slot, cot), 10)
    dev = kernel_ms(g_buf.zero_, lambda: slot_scatter(g_buf, slot, cot), 10)
    plain = events_ms(g_buf.zero_, lambda: slot_scatter_plain(g_buf, slot, cot), 3)
    lib = kernel_ms(g_buf.zero_, lambda: g_buf.index_add_(0, clamped, cot), 10)
    on = slot >= 0
    n_l, n_tri = slot.numel(), int(on.sum())
    n_rows = int(torch.unique(slot[on]).numel())
    nbytes = n_l * 4 + n_tri * 36 + n_rows * 36
    bound_ms, bound_by = bound(n_tri * 9, nbytes)
    return dict(ms=ms, device_ms=dev, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / dev, bytes=nbytes, flops=n_tri * 9,
                max_abs_err=float((g_k - g_p).abs().max()), library_ms=lib,
                work=dict(lanes=n_l, triangle_hits=n_tri, slot_rows=n_rows))

fwd_w, bwd_w = diff_trip.diff_trip_fwd, diff_trip.diff_trip_bwd


step_sums, head_w = {}, trip_kernel.trip_head


def recording_fwd(dp, F, I, buf, sweep, b, res=None):
    if not first_dp:
        first_dp.append(dp)
    if dp is first_dp[0]:
        rec_fwd[b] = dict(dp=dp, F=F.clone(), I=I.clone(), hint=buf.hint.clone(),
                          sweep=None if sweep is None else tuple(o.clone() for o in sweep))
    out = fwd_w(dp, F, I, buf, sweep, b, res)
    add_sum(step_sums, "diff_trip_fwd", *diff_fwd_work(dp.trip, res.i[0], b))
    return out


def counting_head(plan, F, I, buf):
    alive = I[trip_kernel.I_KEYS.index("alive")] != 0
    out = head_w(plan, F, I, buf)
    live, wins = int(alive.sum()), int(((buf.hint >= 0) & alive).sum())
    add_sum(step_sums, "trip_head", head_bytes(plan, live),
            head_flops(plan.tables.n_sph, live, wins))
    return out


def recording_bwd(dp, G, res, seed, b, gtab, g_slot=None):
    if dp is first_dp[0]:
        rec_bwd[b] = dict(G=G.clone(), res=res, seed=seed)
    return bwd_w(dp, G, res, seed, b, gtab, g_slot)


diff_trip.diff_trip_fwd, diff_trip.diff_trip_bwd = recording_fwd, recording_bwd
trip_kernel.trip_head = counting_head
try:
    fwd_bwd()
finally:
    diff_trip.diff_trip_fwd, diff_trip.diff_trip_bwd = fwd_w, bwd_w
    trip_kernel.trip_head = head_w
diff_dp = first_dp[0]
# trip_head's and diff_trip_fwd's work summed over the step's bounces,
# beside their device ms summed over the profiled step of this phase
path_sums = {"bunny_render": bunny_sums, "bunny_step": print_sums(
    "the fwd+bwd step", step_sums,
    {k: route_prof["diff_trip"][f"{k}_ms"] for k in ("trip_head", "diff_trip_fwd")})}
assert path_sums["bunny_step"]["diff_trip_fwd"]["launches"] == d_launches["diff_trip_fwd"], \
    path_sums
del step_sums
LAST_BOUNCE = max(rec_fwd)
assert sorted(rec_fwd) == sorted(rec_bwd) == list(range(LAST_BOUNCE + 1)), (rec_fwd, rec_bwd)
for b in list(rec_fwd):
    if b not in (0, 2, LAST_BOUNCE):
        del rec_fwd[b], rec_bwd[b]
diff_checks = {}
for b in (0, 2, LAST_BOUNCE):
    rf, rb = rec_fwd.pop(b), rec_bwd.pop(b)
    plan, n_l = diff_dp.trip, diff_dp.trip.n
    # diff_trip_fwd and its twin from the recorded state
    runs = []
    for fn in (fwd_w, diff_trip.diff_trip_fwd_plain):
        Fx, Ix, bx = rf["F"].clone(), rf["I"].clone(), trip_kernel.trip_buffers(plan)
        bx.hint.copy_(rf["hint"])
        rx = diff_trip.residuals(n_l, DEV)
        rx.f.zero_()
        fn(diff_dp, Fx, Ix, bx, rf["sweep"], b, rx)
        runs.append((Fx, Ix, rx, bx))
    torch.cuda.synchronize()
    (Fk, Ik, rk, bk_), (Fp, Ip, rp, bp_) = runs
    require_equal_state(f"diff_trip_fwd bounce {b}", (Fk, Ik), (Fp, Ip))
    require_equal(f"diff_trip_fwd bounce {b} residuals and count",
                  [rk.i, bk_.count], [rp.i, bp_.count])
    code = rk.i[0]
    live = code != diff_trip.DEAD
    written = diff_trip.res_written(code)
    require_equal(f"diff_trip_fwd bounce {b} residuals written", [rk.f[written]], [rp.f[written]])
    res_b = rb["res"]
    assert torch.equal(res_b.i, rk.i) and torch.equal(res_b.f[written], rk.f[written]), \
        f"bounce {b}: the step's residuals differ from the recorded forward's"

    def restore_fwd():
        Fk.copy_(rf["F"])
        Ik.copy_(rf["I"])

    def call_fwd():
        fwd_w(diff_dp, Fk, Ik, bk_, rf["sweep"], b, rk)

    fwd_ms = events_ms(restore_fwd, call_fwd, 10)
    fwd_dev = kernel_ms(restore_fwd, call_fwd, 10)
    fwd_plain = events_ms(restore_fwd, lambda: diff_trip.diff_trip_fwd_plain(
        diff_dp, Fk, Ik, bp_, rf["sweep"], b, rp), 1)
    # diff_trip_bwd and its twin's VJP on the step's own cotangent, the
    # slot table's gradient included (the kernel's by its fused scatter,
    # the twin's through _FetchTriRows, whose (slot, rows) are kept)
    runs, twin_rows, fetch_scatter = [], [], intersect.slot_scatter

    def recording_scatter(g, slot, cot):
        twin_rows.append((slot.clone(), cot.clone()))
        return fetch_scatter(g, slot, cot)

    for fn in (bwd_w, diff_trip.diff_trip_bwd_plain):
        Gx, gtab = rb["G"].clone(), diff_trip.leaf_table_zeros(plan)
        g_slot = torch.zeros_like(diff_dp.table)
        intersect.slot_scatter = fetch_scatter if fn is bwd_w else recording_scatter
        try:
            fn(diff_dp, Gx, res_b, rb["seed"], b, gtab, g_slot)
        finally:
            intersect.slot_scatter = fetch_scatter
        runs.append((Gx, diff_trip.split_leaf_table(plan, gtab), g_slot))
    assert len(twin_rows) == 1, len(twin_rows)
    torch.cuda.synchronize()
    (Gk, lk, gsk), (Gp, lp, gsp) = runs
    bwd_gaps = {}  # per row, leaf and slot table column: |kernel - twin| over its max
    for label, a, c in ([(f"G[{k}]", Gk[j], Gp[j]) for j, k in enumerate(diff_trip.G_KEYS)]
                        + [(k, lk[k], lp[k]) for k in lp]
                        + [(f"g_slot[:, {j}]", gsk[:, j], gsp[:, j]) for j in range(9)]):
        scale = float(c.abs().max()) if c.numel() else 0.0
        bwd_gaps[label] = float((a - c).abs().max()) / scale if scale > 0 else 0.0
        assert torch.allclose(a, c, rtol=1e-5, atol=1e-5 * scale), \
            f"diff_trip_bwd bounce {b}: {label} (gaps {bwd_gaps})"
    bwd_gap = max(bwd_gaps.values())
    bwd_err = max(float((Gk - Gp).abs().max()), max(float((lk[k] - lp[k]).abs().max()) for k in lp),
                  float((gsk - gsp).abs().max()))
    # the kernel as the step launches it (the slot table's gradient
    # wanted), its twin the same
    gtk, gsk_t = diff_trip.leaf_table_zeros(plan), torch.zeros_like(diff_dp.table)

    def restore_bwd():
        Gk.copy_(rb["G"])
        gtk.zero_()
        gsk_t.zero_()

    def call_bwd():
        bwd_w(diff_dp, Gk, res_b, rb["seed"], b, gtk, gsk_t)

    bwd_ms = events_ms(restore_bwd, call_bwd, 10)
    bwd_dev = kernel_ms(restore_bwd, call_bwd, 10)
    bwd_plain = events_ms(restore_bwd, lambda: diff_trip.diff_trip_bwd_plain(
        diff_dp, Gk, res_b, rb["seed"], b, gtk, gsp), 1)
    # slot_scatter on this bounce's slots and the twin VJP's (N, 9) winner
    # rows, as the body route's fetch would hand it them (its main path
    # is phase 11's, where it is held on the rows that route hands it)
    slot_b, cot_b = res_b.i[1], twin_rows.pop()[1]
    ss = check_slot_scatter(f"bunny bounce {b}", diff_dp.table.shape[0], slot_b, cot_b)
    # the work
    hit = code >= 0
    on_tri = hit & (code % 2 == 1)
    n_live, n_hit, n_tri = int(live.sum()), int(hit.sum()), int(on_tri.sum())
    first_hits = n_hit if b == 0 else 0
    n_rows = ss["work"]["slot_rows"]
    n_miss = n_live - n_hit
    table_b = plan.tables.table.numel() * 4
    n_leaf = plan.tables.n_sph * 4 + plan.scene.materials.albedo.shape[0] * 8 + 6
    # what each lane's case needs, read once and written once (what a
    # bounce leaves as it is moves nothing)
    fwd_bytes, fwd_flops = diff_fwd_work(plan, code, b)
    # diff_trip_bwd: every lane's code; a miss reads the cotangents of its
    # direction, radiance and throughput and its direction and throughput
    # residuals, writes the first and last of those cotangents; a hit reads
    # its seed, the cotangents of its ray, radiance and throughput and its
    # ten float residuals, writes those of its ray and throughput; bounce
    # 0's hits read and write the normal's and depth's; a triangle hit
    # reads its slot and its table row (a sphere hit needs no slot); the
    # slot table gradient's rows the bounce adds into, once each; the scene
    # table read, the leaf table's entries added to
    bwd_bytes = (n_l * 4 + n_miss * (36 + 24 + 24) + n_hit * (4 + 48 + 40 + 36)
                 + first_hits * 32 + n_tri * (4 + 36) + n_rows * 36 + table_b + n_leaf * 16)
    bwd_flops = n_hit * DIFF_BWD_HIT_FLOPS + n_miss * DIFF_MISS_FLOPS
    out = {}
    for name, ms, dev_ms_, plain_ms, nbytes, flops, err in (
            ("diff_trip_fwd", fwd_ms, fwd_dev, fwd_plain, fwd_bytes, fwd_flops, 0.0),
            ("diff_trip_bwd", bwd_ms, bwd_dev, bwd_plain, bwd_bytes, bwd_flops, bwd_err)):
        bound_ms, bound_by = bound(flops, nbytes)
        out[name] = dict(ms=ms, device_ms=dev_ms_, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, share_of_bound=bound_ms / dev_ms_, bytes=nbytes,
                         flops=flops, max_abs_err=err, library_ms=None)
    out["slot_scatter"] = {k: v for k, v in ss.items() if k != "work"}
    out["work"] = dict(lanes=n_l, live=n_live, hits=n_hit, triangle_hits=n_tri, slot_rows=n_rows,
                       bwd_rel_gap=bwd_gap, bwd_rel_gaps=bwd_gaps)
    diff_checks[f"bunny_step_bounce{b}"] = out
    print(f"bounce {b}{' (the last)' if b == LAST_BOUNCE else ''} of sample 0: {n_l} lanes, "
          f"{n_live} live, {n_hit} hits, {n_tri} on triangles in {n_rows} slots; diff_trip_fwd "
          f"equal to its twin (every output), diff_trip_bwd within {bwd_gap:.3g} of its twin's "
          f"VJP (of each row's or leaf's max; the largest {max(bwd_gaps, key=bwd_gaps.get)}), "
          f"slot_scatter equal to index_add_ and its twin")
    for name in ("diff_trip_fwd", "diff_trip_bwd", "slot_scatter"):
        r = out[name]
        print(f"  {name} {r['ms']:.4f} ms a call (events), {r['device_ms']:.4f} ms on the device, "
              f"twin {r['plain_ms']:.3f} ms"
              + (f", index_add_ {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
              + f"; {r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.4f} GFLOP; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['share_of_bound']:.1%} of it")
    del runs, Fk, Ik, Fp, Ip, Gk, Gp, gsk, gsp, gtk, gsk_t, cot_b, rf, rb, res_b
del diff_dp, first_dp

# --- 7 -------------------------------------------------------------------
phase("7 gradient parity, kernels vs twins: 256^2, 1 spp, 4 bounces; the diff_trip route's "
      "kernels against the body route on the sweep's twin")
twin_diff = functools.partial(intersect.intersect_scene_ids_diff,
                              closest_hit=sweep_kernel.treelet_closest_hit_plain)
reset_counts()
lk, rk2, gk, *_ = fwd_bwd(256, 1, 4)
p7_launches = read_counts()
assert p7_launches["diff_trip_fwd"] > 0 and p7_launches["trip_tail"] == 0, p7_launches
lp, rp2, gp, *_ = fwd_bwd(256, 1, 4, intersect_fn=twin_diff)
assert rk2 == rp2, (rk2, rp2)
assert torch.allclose(lk, lp, rtol=1e-5), (float(lk), float(lp))
grad_gap = {}
for k in LEAVES:
    a, b = gk[k], gp[k]
    scale = float(b.abs().max())
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale), k
    grad_gap[k] = float((a - b).abs().max()) / scale if scale > 0 else 0.0
print(f"ray count equal: {rk2}; loss {float(lk):.7g} vs {float(lp):.7g}; every gradient within rtol "
      f"1e-5 (largest gap {max(grad_gap.values()):.3g} of its leaf's max |grad|)")

# --- 8 -------------------------------------------------------------------
phase(f"8 atrous_denoise (filter_size=10) on the fwd+bwd render's buffers, backward to the "
      f"materials")
torch.cuda.synchronize()
t0 = time.perf_counter()
_, _, dn_grads, dn_buf, _, _ = fwd_bwd(denoise=True)
torch.cuda.synchronize()
dn_wall = time.perf_counter() - t0
for k, g in dn_grads.items():
    assert bool(torch.isfinite(g).all()), f"non-finite gradient of {k} through the denoiser"
assert float(dn_grads["materials.albedo"].abs().max()) > 0
# the filter alone, forward and backward, on the render's buffers as leaves
dn_in = [t.detach().reshape(SIZE, SIZE, -1).squeeze(-1).requires_grad_(True)
         for t in (dn_buf.color, dn_buf.normal, dn_buf.depth)]


def denoise_step():
    img = tpupt_torch.atrous_denoise(*dn_in, desc.camera, filter_size=10)
    torch.autograd.grad((img ** 2).sum(), dn_in)


dn_ms = cuda_ms(denoise_step, 3)
print(f"render + denoise + backward {dn_wall:.3f} s wall (the step without the denoiser: "
      f"{d_wall:.3f} s); the filter's forward and backward alone {dn_ms:.2f} ms; "
      f"albedo grad max {float(dn_grads['materials.albedo'].abs().max()):.4g}")

# --- 9 -------------------------------------------------------------------
phase("9 treelet_any_hit vs twin: shadow rays on bunny.json (1024^2 secondaries' hits; 1024^2 "
      "primaries' mesh hits, mixed) and cornell_area.json (512^2, first bounce); that bounce's "
      "treelet_closest_hit rows, both forms")


def device_ms(fn, name, calls=10):
    """Device milliseconds per call of the kernels whose names hold
    ``name`` (torch.profiler), summed over them: the device time of a call
    without the host's issue; None where the profiler recorded none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if name in e.key)
    return total / 1e3 / calls if total > 0 else None


def shadow_rows(hit, mask, light):
    """Packed shadow rays from ``hit``'s points, offset along the normal,
    toward the point ``light``, on the lanes of ``mask``; the window ends
    short of the light.  Also returns the flat rays (ro, rd, t_min,
    t_limit)."""
    p = hit.point + hit.normal * 1e-4
    to = Vec3(*(torch.full_like(p.x, v) for v in light)) - p
    dist = to.length()
    flat = (p, to * (1.0 / dist), torch.full_like(dist, 1e-4), 0.999 * dist)
    return (*packets._pack_rows(*flat, mask), flat)


def any_hit_routes(args, want):
    """(packets one warp walked, packets a CTA walked) among those with a
    live lane, in one call of the profile build (stamp 4's bit 32 marks
    a warp's packet), whose occlusion must equal ``want``."""
    act_p = args[1]
    stamps = torch.zeros((act_p.shape[0], 6), dtype=torch.int64, device=DEV)
    kernels.check(profile_lib, profile_lib.tpupt_sweep_profile_buffer(stamps.data_ptr()), "profile")
    load, kernels.load = kernels.load, lambda: profile_lib
    try:
        got = sweep_kernel.treelet_any_hit(*args)
        torch.cuda.synchronize()
    finally:
        kernels.load = load
        kernels.check(profile_lib, profile_lib.tpupt_sweep_profile_buffer(None), "profile")
    require_equal("treelet_any_hit, profile build", (got,), (want,))
    busy = act_p.any(dim=1)
    by_warp = (stamps[:, 4] >> 32) == 1
    assert bool((stamps[busy, 3] > 0).all()), "a packet with a live lane left no stamp"
    return int((busy & by_warp).sum()), int((busy & ~by_warp).sum())


def compare_any_hit(label, scn, rows, act_p):
    """The any-hit kernels against their twin on one packed batch (every
    lane's occlusion equal); the work the twin counts, the packets each
    route walked (read from the profile build's stamps), the bound, the
    time of a call (CUDA events over the wrapper) and the kernels' device
    time (torch.profiler)."""
    k9, l9 = scn.tre_min.shape[0], scn.s_leaf_size
    args = (rows, act_p, scn.tre_min, scn.tre_max, scn.tre_tris, l9)
    out_k = sweep_kernel.treelet_any_hit(*args)
    work = {}
    out_p = sweep_kernel.treelet_any_hit_plain(*args, stats=work)
    torch.cuda.synchronize()
    require_equal(f"treelet_any_hit {label}", (out_k,), (out_p,))
    ms = cuda_ms(lambda: sweep_kernel.treelet_any_hit(*args), 20)
    dev_ms = device_ms(lambda: sweep_kernel.treelet_any_hit(*args), "treelet_any_hit")
    plain_ms = cuda_ms(lambda: sweep_kernel.treelet_any_hit_plain(*args), 2)
    warp, block = any_hit_routes(args, out_p)
    smem = kernels.load().tpupt_any_hit_smem_bytes(k9, l9)
    lanes = act_p.numel()
    flops = work["slab_tests"] * SLAB_FLOPS + work["mt_pairs"] * MT_FLOPS
    # each input read once (act per lane, 8 f32 rows per live lane, boxes
    # and blocks per treelet), one byte written per lane
    nbytes = lanes * (1 + 1) + work["live_lanes"] * 8 * 4 + k9 * (6 + 13 * l9) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    occluded = int(out_k.sum())
    print(f"{label}: K={k9}; {work['live_lanes']} live lanes in {lanes // packets.PACKET} packets, "
          f"{occluded} occluded; every lane equal to the twin")
    print(f"  routes (the profile build's stamps): {warp} packets walked by one warp each, "
          f"{block} by a CTA; shared memory {smem} B (the largest launch)")
    print(f"  work: {work['supers_hit']} supers hit, {work['slab_tests']} slab tests, "
          f"{work['visits']} treelet visits (at most {work['visits_max']} in a packet), "
          f"{work['mt_pairs']} MT pairs of unoccluded lanes = {flops / 1e9:.4f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB")
    dev = (f"the kernels' device time {dev_ms:.4f} ms" if dev_ms else
           "the kernels' device time not measured (the profiler recorded none)")
    print(f"  call {ms:.4f} ms, {dev}, twin {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of the call" + (f", {bound_ms / dev_ms:.1%} of the device time"
                                                if dev_ms else "") + f"  [{smi}]")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=0.0, occluded=occluded, work=work, gflop=flops / 1e9, treelets=k9,
                warp_route_packets=warp, block_route_packets=block, smem_bytes=smem)


# bunny.json: the hits of phase 3's secondaries, offset along the normal,
# toward a fixed point above the scene: sparse packets
BUNNY_LIGHT = (0.0, 4.0, -1.5)
with torch.no_grad():
    _ids1, hit1 = intersect.intersect_scene_ids(scene, ro2, rd2, tmin2, hit0.mask)
    rows_sh, act_sh, _ = shadow_rows(hit1, hit1.mask, BUNNY_LIGHT)
shadow_bunny = compare_any_hit("bunny.json shadow rays", scene, rows_sh, act_sh)
# mixed: from the mesh hits of phase 3's pixel-centre primaries toward the
# same point, packets dense over the bunnies and empty elsewhere, so both
# routes run in one call
with torch.no_grad():
    ids_m, hit_m = intersect.intersect_scene_ids(scene, ro, rd, t_min, all_lanes)
    rows_mx, act_mx, _ = shadow_rows(hit_m, hit_m.mask & (ids_m.kind == intersect.PRIM_TRIANGLE),
                                     BUNNY_LIGHT)
shadow_mixed = compare_any_hit("bunny.json mixed shadow rays (the 1024^2 primaries' mesh hits)",
                               scene, rows_mx, act_mx)
assert shadow_mixed["warp_route_packets"] > 0 and shadow_mixed["block_route_packets"] > 0, \
    shadow_mixed
del rows_mx, act_mx, ids_m, hit_m

# cornell_area.json: the rows the first bounce of the render hands the
# any-hit kernel (its only light is the quad, so one call) and the
# closest-hit kernel (K = 1: the one-level cull)
ensure_models(names=["quad.obj"])
nee_desc = {name: scene_from_json(os.path.join(locate_asset_path(), "scenes", name))
            for name in NEE_SPP}
nee_scene = {name: d.build(leaf_size=32, device=DEV) for name, d in nee_desc.items()}
area, area_cam = nee_scene["cornell_area.json"], nee_desc["cornell_area.json"].camera.to(DEV)
captured, captured_ch = [], []


def record_any_hit(*args):
    captured.append(args)
    return sweep_kernel.treelet_any_hit(*args)


def record_closest_hit(*args, **kw):
    captured_ch.append(args)
    return sweep_kernel.treelet_closest_hit(*args, **kw)


with torch.no_grad():
    pix_a = torch.arange(NEE_SIZE * NEE_SIZE, device=DEV)
    st_a, seed_a = integrator._fresh_state(area, area_cam, NEE_SIZE, NEE_SIZE, pix_a, 0)
    integrator._bounce_body(
        area, seed_a, st_a, torch.zeros_like(pix_a), None,
        functools.partial(intersect.intersect_scene_ids, closest_hit=record_closest_hit),
        any_hit=record_any_hit)
    area_r = rebake_treelets(area)  # the table the fwd+bwd step traces
assert len(captured) == len(captured_ch) == 1, (len(captured), len(captured_ch))
shadow_area = compare_any_hit("cornell_area.json bounce-0 shadow rays", area, *captured[0][:2])
# the same bounce's closest-hit rows, through both forms: the forward
# render's 6-channel call and, on the rebaked table, the fwd+bwd step's
# payload call (its first bounce packs the same rows)
closest_area = compare_sweep("cornell_area.json bounce-0 rays", area, *captured_ch[0][:2])
pay_area = compare_payload("cornell_area.json bounce-0 rays", area_r, *captured_ch[0][:2])

# --- 10 ------------------------------------------------------------------
phase(f"10 NEE renders on the trip route: cornell.json and cornell_area.json, {NEE_SIZE}^2, "
      f"{NEE_BOUNCES} bounces, rr {NEE_RR}; spp {NEE_SPP}; the body route in turns; trip_head, "
      f"trip_nee and trip_tail's NEE mode vs their twins on trips 0, 2 and the last of each, "
      f"of sixteen lamps and of an emissive icosphere at {NEE_SIZE}^2")


def nee_render(name, size=NEE_SIZE, route="trip", intersect_fn=None, any_hit=None):
    """(buffers, segments, trips) of the NEE render by ``route``: "trip"
    (the route the call picks; trips count trip_head's launches) or "body"
    (``_bounce_body`` on the hit pass ``intersect_fn``, by default the
    default one wrapped; trips count its calls)."""
    fn = None
    if route == "body":
        inner = intersect_fn or intersect.intersect_scene_ids

        def fn(*args):
            fn.calls += 1
            return inner(*args)

        fn.calls = 0
    assert integrator.render_route(nee_scene[name], False, fn, any_hit) == route, (name, route)
    heads = trace.launch_counts()["trip_head"]
    buf, rays = tpupt_torch.render_image(
        nee_scene[name], nee_desc[name].camera, size, size, spp=NEE_SPP[name],
        max_bounces=NEE_BOUNCES, rr_start=NEE_RR, intersect_fn=fn, any_hit=any_hit, device=DEV)
    calls = fn.calls if route == "body" else trace.launch_counts()["trip_head"] - heads
    return buf, int(rays), calls


def drive_nee(name, calls):
    """The main path on one scene, the trip route: counts reset before and
    read after each call, equal between calls; first-call time, walls of
    the next calls."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf, rays, trips = nee_render(name)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = read_counts()
    img = buf.color
    assert tuple(img.shape) == (NEE_SIZE * NEE_SIZE, 3) and bool(torch.isfinite(img).all()), name
    assert bool(torch.isfinite(buf.normal).all() and torch.isfinite(buf.depth).all()), name
    mean = img.mean(dim=0).tolist()
    assert 0.02 < min(mean) and max(mean) < 10.0, f"{name}: implausible mean colour {mean}"
    # one trip_head, trip_nee and trip_tail a trip; with a mesh one
    # closest-hit and one any-hit call a trip, without none
    mesh = any(k == intersect.OBJ_MESH for k in nee_scene[name].s_obj_kind)
    assert counts["trip_head"] == counts["trip_nee"] == counts["trip_tail"] == trips > 0, counts
    assert counts["treelet_closest_hit"] == counts["treelet_any_hit"] == (trips if mesh else 0), \
        counts
    walls = []
    for _ in range(calls):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _buf2, rays2, trips2 = nee_render(name)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        assert (rays2, trips2, read_counts()) == (rays, trips, counts), \
            f"{name}: segments, trips or launches moved between calls"
        assert torch.equal(_buf2.color, img), f"{name}: render is not deterministic"
    wall = float(np.median(walls))
    print(f"{name}: first call {first:.3f} s; the trip route; {trips} trips, {rays} traced "
          f"segments, launches {counts}; mean colour {[round(x, 4) for x in mean]}")
    print(f"  calls 2-{calls + 1}: {', '.join(f'{w:.3f}' for w in walls)} s wall; median {wall:.3f} s = "
          f"{rays / wall / 1e6:.3f} traced Mrays/s  [{smi}]")
    np.save(os.path.join(OUT, f"{name[:-5]}_{NEE_SIZE}_{NEE_SPP[name]}spp.npy"),
            img.reshape(NEE_SIZE, NEE_SIZE, 3).cpu().numpy().astype(np.float16))
    return buf, dict(rays=rays, trips=trips, launches=counts, first_call_s=first, walls_s=walls,
                     wall_s=wall, mrays_per_s=rays / wall / 1e6, mean_colour=mean)


# two timed calls after the first: the run's wall is bounded
nee_fwd, nee_bufs = {}, {}
for name in NEE_SPP:
    nee_bufs[name], nee_fwd[name] = drive_nee(name, 2)
area_launches = nee_fwd["cornell_area.json"]["launches"]

# each render by each route, in turns (trip, body, body, trip): bit-equal,
# the same segments and trips; then each route once under torch.profiler
NEE_KERNELS = ("trip_head_kernel", "trip_nee_kernel", "trip_tail_kernel",
               "treelet_closest_hit_kernel", "treelet_any_hit")
for name in NEE_SPP:
    want, info = nee_bufs[name], nee_fwd[name]
    walls_r = {"trip": [], "body": []}
    for route in ("trip", "body", "body", "trip"):
        reset_counts()
        (b_r, r_r, t_r), w_r = timed(lambda: nee_render(name, route=route))
        c_r = read_counts()
        assert (r_r, t_r) == (info["rays"], info["trips"]), (name, route, r_r, t_r)
        assert c_r["trip_nee"] == (info["trips"] if route == "trip" else 0), (name, route, c_r)
        for key in ("color", "normal", "depth"):
            assert torch.equal(getattr(b_r, key), getattr(want, key)), f"{name} {route}: {key}"
        walls_r[route].append(w_r)
        del b_r
    info["routes_in_turns"] = {}
    for route in ("trip", "body"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            nee_render(name, route=route)
            torch.cuda.synchronize()
        kav = prof.key_averages()
        if route == "trip":
            with open(os.path.join(OUT, f"{name[:-5]}_render_profile.txt"), "w") as fh:
                fh.write(kav.table(sort_by="self_device_time_total", row_limit=40))
        kern = [e for e in kav if e.self_device_time_total > 0]
        r_busy = sum(e.self_device_time_total for e in kern) / 1e3
        n_kern = sum(e.count for e in kern)
        wall_r = sum(walls_r[route]) / len(walls_r[route])
        by_kernel = {k: sum(e.self_device_time_total for e in kern if k in e.key) / 1e3
                     for k in NEE_KERNELS}
        info["routes_in_turns"][route] = dict(
            walls_s=walls_r[route], profiled_device_busy_ms=r_busy, busy_share=r_busy / 1e3 / wall_r,
            kernels=n_kern, kernels_per_trip=n_kern / info["trips"], device_ms=by_kernel)
        print(f"{name}, {route} route: walls {', '.join(f'{w:.3f}' for w in walls_r[route])} s "
              f"({info['rays'] / wall_r / 1e6:.3f} Mrays/s); "
              + (f"profiled: device busy {r_busy:.2f} ms = {r_busy / 1e3 / wall_r:.1%} of the mean "
                 f"wall, {n_kern} kernels = {n_kern / info['trips']:.1f} a trip; device ms "
                 + ", ".join(f"{k} {v:.2f}" for k, v in by_kernel.items() if v > 0)
                 if r_busy > 0 else "the profiler recorded no device time (not measured)")
              + f"  [{smi}]")
    print(f"{name}: the two routes' renders are bit-equal, {info['rays']} segments in "
          f"{info['trips']} trips each; body/trip mean wall "
          f"{sum(walls_r['body']) / sum(walls_r['trip']):.2f}")
    # the trip kernels' work summed over every trip of the render, beside
    # their device ms summed over the profiled render
    _, sums_n = trip_sums(lambda: nee_render(name))
    dev_n = info["routes_in_turns"]["trip"]["device_ms"]
    path_sums[name.removesuffix(".json")] = info["path_sums"] = print_sums(
        f"{name} render", sums_n, {k: dev_n[f"{k}_kernel"] for k in ("trip_head", "trip_nee",
                                                                     "trip_tail")})
    assert all(e["launches"] == info["trips"] for e in info["path_sums"].values()), info
del nee_bufs

# the trip kernels against their twins on recorded trips of each render
# and of sixteen lamps (one light sampled per lane, its sphere test
# excluding that light per lane), each output exact; their times, work,
# bounds and shares
def translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


# tests/test_emissive.py's sixteen lamps over a floor, at BASELINE config 2's
# size, depth and roulette
m16 = tpupt_torch.SceneDescription(bg_down=(0, 0, 0), bg_up=(0, 0, 0))
m16.add_material("floor", "lambertian", albedo=(0.7, 0.7, 0.7))
m16.add_sphere(100.0, translate(0, -100.5, -1), "floor")
for i in range(16):
    m16.add_material(f"lamp{i}", "diffuse_light", emit=(2.0 + 0.2 * i, 2.0, 1.0))
    m16.add_sphere(0.15, translate(-1.5 + 3.0 * i / 15, 0.8, -1.5), f"lamp{i}")
m16.camera = make_camera(vfov=np.pi / 2)
nee_scene["many16"], nee_desc["many16"], NEE_SPP["many16"] = m16.build(device=DEV), m16, 2
assert len(nee_scene["many16"].s_light_objs) == 16 > integrator.NEE_UNROLL_MAX
# tests/test_torch_trip_nee.py's emissive icosphere beside a floor: the mesh
# light's area CDF has 320 entries (subdivision 2; both packages cap a
# scene's emissive triangles at 512), which trip_nee inverts by binary search
ico = tpupt_torch.SceneDescription(bg_down=(0, 0, 0), bg_up=(0, 0, 0))
ico.add_material("floor", "lambertian", albedo=(0.7, 0.7, 0.7))
ico.add_material("ilamp", "diffuse_light", emit=(6.0, 5.0, 4.0))
ico.add_sphere(100.0, translate(0, -100.5, -1), "floor")
ico.add_mesh("ico", *icosphere(2))
ico.add_mesh_object("ico", translate(0.4, 0.2, -1.6) @ np.diag([0.35, 0.35, 0.35, 1.0]), "ilamp")
ico.camera = make_camera(vfov=np.pi / 2)
nee_scene["ico_light"], nee_desc["ico_light"], NEE_SPP["ico_light"] = ico.build(device=DEV), ico, 2
assert nee_scene["ico_light"].s_tri_light_count == 320
for name in NEE_SPP:
    _, rays_n, trips_n = nee_render(name)
    (_, rays_r, trips_r), n_rec, kept_n = record_trip_inputs(lambda: nee_render(name),
                                                             {0, 2, trips_n - 1})
    assert (rays_r, trips_r, n_rec) == (rays_n, trips_n, trips_n), (name, rays_r, trips_r, n_rec)
    if name in nee_fwd:
        assert (rays_n, trips_n) == (nee_fwd[name]["rays"], nee_fwd[name]["trips"]), name
    for t in sorted({0, 2, trips_n - 1}):
        last = " (the last)" if t == trips_n - 1 else ""
        trip_checks[f"{name.removesuffix('.json')}_trip{t}"] = compare_trip(
            f"{name} {NEE_SIZE}^2, {NEE_SPP[name]} spp, trip {t}{last}", kept_n.pop(t))
    del kept_n

twin_fwd = functools.partial(intersect.intersect_scene_ids,
                             closest_hit=sweep_kernel.treelet_closest_hit_plain)
for name in ("cornell.json", "cornell_area.json"):
    bk, rk, _ = nee_render(name, 128)
    bp, rp, _ = nee_render(name, 128, "body", twin_fwd, sweep_kernel.treelet_any_hit_plain)
    assert rk == rp, (name, rk, rp)
    gaps = []
    for key in ("color", "normal", "depth"):
        a, b = getattr(bk, key), getattr(bp, key)
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), (name, key)
        gaps.append(f"{key} {float((a - b).abs().max()):.3g}")
    print(f"{name} at 128^2, the trip kernels vs the body route on the sweeps' twins: {rk} "
          f"segments each; max |difference| " + ", ".join(gaps))

# --- 11 ------------------------------------------------------------------
phase(f"11 fwd+bwd on cornell_area.json: {NEE_SIZE}^2, {NEE_DIFF_SPP} spp, {NEE_BOUNCES} bounces, "
      f"loss sum(color^2), backward to every extract_params leaf")
area_step = functools.partial(fwd_bwd, NEE_SIZE, NEE_DIFF_SPP, NEE_BOUNCES, scn=area,
                              cam=area_cam)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
mem0 = torch.cuda.memory_allocated()
reset_counts()
t0 = time.perf_counter()
a_loss, a_rays, a_grads, _, _, _ = area_step()
torch.cuda.synchronize()
a_first_s = time.perf_counter() - t0
a_launches = read_counts()
a_peak = torch.cuda.max_memory_allocated() - mem0
assert a_launches["treelet_closest_hit(payload=True)"] > 0 and a_launches["treelet_any_hit"] > 0, \
    a_launches
assert a_launches["treelet_closest_hit"] == 0 and a_launches["winner_step"] == 0, a_launches
# emitters: the body route, whose fetch backward is slot_scatter (one a
# bounce) in place of index_add_; the differentiable trip's kernels idle
assert a_launches["diff_trip_fwd"] == 0 and a_launches["trip_tail"] == 0, a_launches
assert 0 < a_launches["slot_scatter"] <= a_launches["treelet_closest_hit(payload=True)"], a_launches
assert bool(torch.isfinite(a_loss)) and a_rays > NEE_SIZE * NEE_SIZE, (a_loss, a_rays)
for k, g in a_grads.items():
    assert bool(torch.isfinite(g).all()), f"non-finite gradient of {k}"
assert float(a_grads["materials.emission"].abs().max()) > 0, "no gradient reached the emission"
print(f"first call {a_first_s:.3f} s; launches {a_launches}; {a_rays} primal segments; loss "
      f"{float(a_loss):.6g}; peak memory {a_peak / 2**30:.2f} GiB above the {mem0 / 2**30:.2f} GiB "
      f"resident before it")
print("  max |grad|: " + ", ".join(f"{k} {float(g.abs().max()):.4g}" for k, g in a_grads.items()))
a_walls, a_split = [], []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _l, rays2, _g, _, f_s, b_s = area_step()
    torch.cuda.synchronize()
    a_walls.append(time.perf_counter() - t0)
    a_split.append((f_s, b_s))
    assert rays2 == a_rays, "the cornell_area fwd+bwd step's segment count is not deterministic"
a_wall = sorted(a_walls)[1]
print(f"calls 2-4: {', '.join(f'{w:.3f}' for w in a_walls)} s wall; median {a_wall:.3f} s = "
      f"{a_rays / a_wall / 1e6:.3f} fwd+bwd Mrays/s (primal segments)  [{smi}]")
print("  forward + loss / backward: " + ", ".join(f"{f:.3f} / {b:.3f} s" for f, b in a_split))
with torch.profiler.profile(activities=acts) as prof:
    area_step()
    torch.cuda.synchronize()
kav = prof.key_averages()
with open(os.path.join(OUT, "cornell_area_fwd_bwd_profile.txt"), "w") as fh:
    fh.write(kav.table(sort_by="self_device_time_total", row_limit=60))
a_busy_ms = sum(e.self_device_time_total for e in kav
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
a_slot_ms = sum(e.self_device_time_total for e in kav if "slot_scatter_kernel" in e.key) / 1e3
a_index_add = [e for e in kav if e.key == "aten::index_add_"]
a_index_add_ms = sum(dev_total(e) for e in a_index_add) / 1e3
print(f"profiled step: device busy {a_busy_ms:.1f} ms = {a_busy_ms / 1e3 / a_wall:.1%} of the median "
      f"wall; slot_scatter {a_slot_ms:.3f} ms in {a_launches['slot_scatter']} launches; index_add_ "
      f"{a_index_add_ms:.3f} ms in {sum(e.count for e in a_index_add)} calls (the positions' gather "
      f"backward)" if a_busy_ms > 0 else "profiled step: the profiler recorded no device time "
      "(not measured)")
# slot_scatter on its main path: the (slot, rows) that the body route's
# _FetchTriRows hands it on one more step, held against its twin and
# index_add_, and timed, on the call with the most triangle lanes (the
# kernels line's numbers) and the one with the fewest
area_rows, fetch_scatter = [], intersect.slot_scatter


def recording_area_scatter(g, slot, cot):
    area_rows.append((g.shape[0], slot.clone(), cot.clone()))
    return fetch_scatter(g, slot, cot)


intersect.slot_scatter = recording_area_scatter
try:
    area_step()
finally:
    intersect.slot_scatter = fetch_scatter
torch.cuda.synchronize()
assert len(area_rows) == a_launches["slot_scatter"], (len(area_rows), a_launches)
tri_lanes = [int((s_ >= 0).sum()) for _, s_, _ in area_rows]
area_most = max(range(len(tri_lanes)), key=tri_lanes.__getitem__)
area_ss = {}
for k in sorted({area_most, min(range(len(tri_lanes)), key=tri_lanes.__getitem__)}):
    r = area_ss[f"cornell_area_step_call{k}"] = check_slot_scatter(
        f"cornell_area call {k}", *area_rows[k])
    print(f"slot_scatter on the body route's rows, call {k} of {len(area_rows)} (triangle lanes "
          f"{min(tri_lanes)}-{max(tri_lanes)} a call): {r['work']['lanes']} lanes, "
          f"{r['work']['triangle_hits']} with a row, in {r['work']['slot_rows']} rows; equal to "
          f"its twin and index_add_; {r['device_ms']:.4f} ms on the device ({r['ms']:.4f} a "
          f"call by events), twin {r['plain_ms']:.3f} ms, index_add_ {r['library_ms']:.4f} ms; "
          f"{r['bytes'] / 1e6:.2f} MB, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
          f"{r['share_of_bound']:.1%} of it  [{smi}]")
area_ss_top = area_ss[f"cornell_area_step_call{area_most}"]
del area_rows
lk, rk3, gk, *_ = fwd_bwd(128, 1, NEE_BOUNCES, scn=area, cam=area_cam)
lp, rp3, gp, *_ = fwd_bwd(128, 1, NEE_BOUNCES, scn=area, cam=area_cam, intersect_fn=twin_diff,
                          any_hit=sweep_kernel.treelet_any_hit_plain)
assert rk3 == rp3, (rk3, rp3)
assert torch.allclose(lk, lp, rtol=1e-5), (float(lk), float(lp))
a_gap = {}
for k in LEAVES:
    scale = float(gp[k].abs().max())
    assert torch.allclose(gk[k], gp[k], rtol=1e-5, atol=1e-5 * scale), k
    a_gap[k] = float((gk[k] - gp[k]).abs().max()) / scale if scale > 0 else 0.0
print(f"gradient parity at 128^2, 1 spp, kernels vs twins: {rk3} segments each; loss {float(lk):.7g} "
      f"vs {float(lp):.7g}; largest gap {max(a_gap.values()):.3g} of its leaf's max |grad|")

# --- 12 ------------------------------------------------------------------
phase(f"12 PathTracer on bunny.json: {SIZE}^2, {MAX_BOUNCES} bounces, rr {RR} (phase 4's render)")


def fresh_tracer(method="megakernel", size=SIZE):
    return tpupt_torch.PathTracer(scene, (size, size), max_bounces=MAX_BOUNCES, rr_start=RR,
                                  method=method)


# one chunk of SPP: the chained render of phase 4, merged into zeroed buffers
tracer = fresh_tracer()
reset_counts()
pt_rays, pt_wall = timed(lambda: tracer.path_trace_many(desc.camera, SPP))
pt_launches = read_counts()
assert (pt_launches["treelet_closest_hit"], pt_rays) == (FWD_LAUNCHES, FWD_SEGMENTS), \
    f"path_trace_many({SPP}) moved the counts: {pt_launches}, {pt_rays}"
assert tracer.iteration == SPP and torch.equal(tracer.buffers.color, img), \
    "path_trace_many's image differs from phase 4's"
print(f"path_trace_many({SPP}): {pt_rays} segments, launches {pt_launches}, {pt_wall:.3f} s = "
      f"{pt_rays / pt_wall / 1e6:.3f} Mrays/s; image equal to phase 4's")
# chunks of SPP/2 + SPP/2: the same segments, the image at the chunk merge's
# tolerance (tests/test_progressive.py: atol 2e-4)
chunked = fresh_tracer()
half = [chunked.path_trace_many(desc.camera, SPP // 2) for _ in range(2)]
assert sum(half) == FWD_SEGMENTS, half
chunk_gap = float((chunked.buffers.color - img).abs().max())
assert torch.allclose(chunked.buffers.color, img, atol=2e-4), chunk_gap
print(f"chunks of {SPP // 2} + {SPP // 2}: {half} segments, max |image - phase 4's| {chunk_gap:.3g}")
# a checkpoint of the chunked tracer, loaded into a new one, continues as
# the uninterrupted tracer
with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, "ckpt.npz")
    chunked.save_checkpoint(ckpt)
    resumed = fresh_tracer()
    resumed.load_checkpoint(ckpt)
assert resumed.iteration == SPP and torch.equal(resumed.buffers.color, chunked.buffers.color)
assert chunked.path_trace(desc.camera) == resumed.path_trace(desc.camera)
for key in ("color", "normal", "depth"):
    assert torch.equal(getattr(resumed.buffers, key), getattr(chunked.buffers, key)), key
print(f"checkpoint at iteration {SPP}: saved, loaded, one more sample equal to the uninterrupted "
      f"tracer's")
# per-sample steps in each mode, in turns (the first of a pair alternates):
# bit-equal, the same segments; the streaming/megakernel wall ratio of
# each pair
MODE_PAIRS = 6
mega, stream = fresh_tracer(), fresh_tracer("streaming")
mode_walls = {"megakernel": [], "streaming": []}
for i in range(MODE_PAIRS):
    pair_rays = {}
    for mode, pt_mode in ((("megakernel", mega), ("streaming", stream)) if i % 2 == 0 else
                          (("streaming", stream), ("megakernel", mega))):
        pair_rays[mode], w_mode = timed(lambda: pt_mode.path_trace(desc.camera))
        mode_walls[mode].append(w_mode)
    assert pair_rays["megakernel"] == pair_rays["streaming"], pair_rays
for key in ("color", "normal", "depth"):
    a, b = getattr(mega.buffers, key), getattr(stream.buffers, key)
    if not torch.equal(a, b):
        bad = (a != b).reshape(a.shape[0], -1).any(dim=1).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"streaming != megakernel in {key}, first pixels {bad}")
mode_ratios = sorted(s / m for s, m in zip(mode_walls["streaming"], mode_walls["megakernel"]))
print(f"path_trace x{MODE_PAIRS}, megakernel (the trip route) and streaming (the body route) "
      f"in turns: bit-equal, "
      f"{pair_rays['megakernel']} segments in the last sample; streaming/megakernel wall "
      f"per pair: median {mode_ratios[MODE_PAIRS // 2 - 1]:.3f}-{mode_ratios[MODE_PAIRS // 2]:.3f}, range "
      f"{mode_ratios[0]:.3f}-{mode_ratios[-1]:.3f}; walls {mode_walls}")


# the sweep on a compacted wavefront bounce: bounce 2 of a streaming sample
# traces only its live lanes, contiguous at the front of the packets; the
# megakernel's bounce 2 hands the sweep the same lanes in pixel order
def bounce2_rows(sample, width, height, rr_start):
    rows = []

    def record(*args, **kw):
        record.calls += 1
        if record.calls == 3:
            rows.append(args)
        return sweep_kernel.treelet_closest_hit(*args, **kw)

    record.calls = 0
    sample(scene, desc.camera.to(DEV), width, height, 0, max_bounces=MAX_BOUNCES,
           rr_start=rr_start,
           intersect_fn=functools.partial(intersect.intersect_scene_ids, closest_hit=record))
    assert len(rows) == 1, record.calls
    return rows[0][:2]


def compare_bounce2(label, width, height, rr_start):
    """The sweep on bounce 2 of one sample, compacted (streaming) and in
    pixel order (megakernel): both equal to the twin; the compacted call
    bounded by the lesser work of the two packings of its rays."""
    mega_rows = bounce2_rows(integrator.trace_sample, width, height, rr_start)
    in_order = compare_sweep(f"{label}, megakernel bounce 2 (pixel order)", scene, *mega_rows)
    live = int(mega_rows[1].sum())
    del mega_rows
    compact_rows = bounce2_rows(wavefront.trace_sample_wavefront, width, height, rr_start)
    assert int(compact_rows[1].sum()) == live < width * height, "not the same lanes"
    assert bool(compact_rows[1].reshape(-1)[:live].all()), "not compacted"
    compact = compare_sweep(f"{label}, wavefront bounce 2 (compacted)", scene, *compact_rows,
                            same_rays=in_order)
    print(f"compacted / pixel order: {compact['ms'] / in_order['ms']:.3f} of the kernel time, "
          f"{compact['work']['visits'] / in_order['work']['visits']:.3f} of the visits, "
          f"{compact['packed_gflop'] / in_order['packed_gflop']:.3f} of the packed GFLOP")
    return compact, in_order


compacted, uncompacted = compare_bounce2(f"{SIZE}^2 rr {RR}", SIZE, SIZE, RR)
# the motion preview, for every display type
previews = {}
for kind in ("final", "color", "normal", "depth"):
    pv, pv_s = timed(lambda: mega.preview_frame(desc.camera, 8, kind))
    assert pv.shape == (SIZE, SIZE, 3) and pv.dtype == np.uint8 and pv.any(), kind
    previews[kind] = pv_s
print("preview_frame: " + ", ".join(f"{k} {s * 1e3:.1f} ms" for k, s in previews.items()))
_, dn_s = timed(lambda: tracer.denoise(desc.camera))
final = tracer.display("final")
assert final.shape == (SIZE, SIZE, 3) and (final != tracer.display("color")).any()
print(f"denoise {dn_s * 1e3:.1f} ms; display('final') shows the denoised image")

# --- 13 ------------------------------------------------------------------
phase("13 the CLI as a user runs it: python -m tpupt_torch.cli, in a subprocess")


def decode_png(path):
    """The image of a PNG that utils.image wrote (8-bit RGB, filter 0)."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", path
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks[tag] = data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def run_cli(name, *args, out_dir=OUT):
    """Run the CLI on a shipped scene; returns (stats, launches, image,
    wall)."""
    png, stats = (os.path.join(out_dir, f"cli_{name}.{ext}") for ext in ("png", "json"))
    cmd = [sys.executable, "-m", "tpupt_torch.cli", *args, "-o", png, "--stats-json", stats]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    print(f"$ {' '.join(cmd[2:])}  ({wall:.1f} s of wall)")
    print("  " + "\n  ".join(ln for ln in proc.stdout.splitlines()
                             if "time:" in ln or "Mrays" in ln or "launches" in ln))
    tag = "Kernel launches while path tracing: "
    launches = json.loads(next(ln[len(tag):] for ln in proc.stdout.splitlines()
                               if ln.startswith(tag)))
    with open(stats) as fh:
        return json.load(fh), launches, decode_png(png), wall


CLI_W, CLI_H, CLI_SPP, CLI_BOUNCES = 1920, 1080, 10, 50  # bunny.json's own, the CLI's default
cli = {}
st_b, la_b, png_b, wall_b = run_cli("bunny", "bunny.json", "--denoise")
assert (st_b["resolution"], st_b["spp"]) == ([CLI_W, CLI_H], CLI_SPP), st_b
# the in-process render, through the trip route as the CLI's, keeps the
# sweep's rows of its first, third and last trips, each over all
# CLI_W x CLI_H lanes
last_trip = la_b["treelet_closest_hit"] - 1
reset_counts()
(buf_b, rays_b), cli_n_trips, cli_kept = record_trip_inputs(
    lambda: tpupt_torch.render_image(scene, desc.camera, CLI_W, CLI_H, spp=CLI_SPP,
                                     max_bounces=CLI_BOUNCES), {0, 2, last_trip})
assert cli_n_trips == last_trip + 1, (cli_n_trips, la_b)
assert st_b["rays"] == int(rays_b), (st_b["rays"], int(rays_b))
assert la_b == {k: v for k, v in read_counts().items() if k in la_b}, (la_b, read_counts())
assert la_b["trip_tail"] == la_b["treelet_closest_hit"], la_b
dn_b = tpupt_torch.atrous_denoise(buf_b.color.reshape(CLI_H, CLI_W, 3),
                                  buf_b.normal.reshape(CLI_H, CLI_W, 3),
                                  buf_b.depth.reshape(CLI_H, CLI_W), desc.camera)
assert np.array_equal(png_b, to_uint8(dn_b.cpu().numpy())), "the CLI's PNG != the render's"
cli["bunny.json"] = dict(stats=st_b, launches=la_b, wall_s=wall_b)
print(f"  {st_b['rays']} segments = the in-process render's; launches {la_b} = the in-process "
      f"render's; the PNG = its denoised display  [{smi}]")
del buf_b, dn_b
cli_trips = {}
for trip in (0, 2, last_trip):
    rec = cli_kept.pop(trip)
    rows_t, act_t = dict(zip(packets._ROW_KEYS, rec["rows"].unbind(0))), rec["act_p"]
    assert act_t.shape[0] == -(-CLI_W * CLI_H // packets.PACKET), act_t.shape  # every lane
    name = f"trip {last_trip} (the last)" if trip == last_trip else f"trip {trip}"
    cli_trips[f"cli_bunny_trip{trip}"] = compare_sweep(
        f"CLI render {CLI_W}x{CLI_H}, {name}", scene, rows_t, act_t)
    del rows_t, act_t, rec

st_s, la_s, png_s, wall_s = run_cli("bunny_streaming", "bunny.json", "--method", "streaming",
                                    "--spp", "2")
_, rays_s2 = tpupt_torch.render_image(scene, desc.camera, CLI_W, CLI_H, spp=2,
                                      max_bounces=CLI_BOUNCES)
assert st_s["rays"] == int(rays_s2), (st_s["rays"], int(rays_s2))
assert la_s["treelet_closest_hit"] > 0 and png_s.shape == (CLI_H, CLI_W, 3), la_s
cli["bunny.json --method streaming --spp 2"] = dict(stats=st_s, launches=la_s, wall_s=wall_s)
print(f"  {st_s['rays']} segments = the chained render's at 2 spp  [{smi}]")
# the streaming command's first sample, bounce 2: compacted, and in pixel
# order
cli_compacted, cli_uncompacted = compare_bounce2(f"CLI {CLI_W}x{CLI_H} no RR", CLI_W, CLI_H,
                                                 None)

# at 4 of the scene's 16 spp: the run's wall is bounded
st_a, la_a, png_a, wall_a = run_cli("cornell_area", "cornell_area.json", "--spp", "4")
assert (st_a["resolution"], st_a["spp"]) == ([NEE_SIZE, NEE_SIZE], 4), st_a
# the trip route: one trip_head, closest-hit call, trip_nee, any-hit call
# and trip_tail a trip
assert (la_a["trip_head"] == la_a["treelet_closest_hit"] == la_a["trip_nee"]
        == la_a["treelet_any_hit"] == la_a["trip_tail"] > 0), la_a
assert st_a["rays"] > NEE_SIZE * NEE_SIZE and png_a.any(), st_a
cli["cornell_area.json"] = dict(stats=st_a, launches=la_a, wall_s=wall_a)
print(f"  [{smi}]")
# the device's time in the bunny command's render: the same render once
# more in this process under torch.profiler, over the CLI's unprofiled
# path-tracing stage
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    tpupt_torch.render_image(scene, desc.camera, CLI_W, CLI_H, spp=CLI_SPP,
                             max_bounces=CLI_BOUNCES)
    torch.cuda.synchronize()
kav = prof.key_averages()
kern = [e for e in kav if e.self_device_time_total > 0]
with open(os.path.join(OUT, "cli_bunny_render_profile.txt"), "w") as fh:
    fh.write(kav.table(sort_by="self_device_time_total", row_limit=40))
cli_busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
cli_sweep_ms = sum(e.self_device_time_total for e in kern
                   if "treelet_closest_hit_kernel" in e.key) / 1e3
cli["bunny.json"].update(profiled_device_busy_ms=cli_busy_ms, profiled_sweep_ms=cli_sweep_ms,
                         profiled_kernels=sum(e.count for e in kern))
print(f"profiled bunny render (the CLI's): device busy {cli_busy_ms:.1f} ms = "
      f"{cli_busy_ms / 1e3 / st_b['path_tracing_secs']:.1%} of the CLI's path-tracing stage; "
      f"treelet_closest_hit_kernel {cli_sweep_ms:.1f} ms; {sum(e.count for e in kern)} kernels"
      if cli_busy_ms > 0 else "profiled render: the profiler recorded no device time (not measured)")
# --profile writes a Chrome trace of the path-tracing stage (a small render)
with tempfile.TemporaryDirectory() as tmp:
    run_cli("profile", "bunny.json", "--spp", "1", "--resolution", "256x144", "--profile", tmp,
            out_dir=tmp)
    with open(os.path.join(tmp, "path_tracing_trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
n_traced = sum(1 for e in events if e.get("cat") == "kernel")
assert n_traced > 0 and any("treelet_closest_hit_kernel" in e.get("name", "") for e in events)
print(f"  --profile: {len(events)} trace events, {n_traced} of them kernels on the card")

# --- 14 ------------------------------------------------------------------
phase("14 the headless viewer on bunny.json, 512^2")
VIEW = 512
viewer = InteractiveViewer(fresh_tracer(size=VIEW),
                           FirstPersonCameraController(vfov=desc.camera.vfov))
frames = []
for _ in range(3):
    frame, frame_s = timed(viewer.step_frame)
    assert frame.shape == (VIEW, VIEW, 3) and frame.dtype == np.uint8
    frames.append((viewer.tracer.iteration, frame_s))
assert [it for it, _ in frames] == sorted(it for it, _ in frames) and frames[0][0] > 0, frames
assert viewer.on_key("w") and viewer.moving and viewer.tracer.iteration == 0
frame, move_s = timed(viewer.step_frame)
assert frame.shape == (VIEW, VIEW, 3) and viewer.tracer.iteration == 0
assert (viewer._preview.width, viewer._preview.height) == (VIEW // 4, VIEW // 4)
print(f"idle frames: (iteration, s) {[(it, round(s, 3)) for it, s in frames]}; after 'w' one "
      f"{viewer._preview.width}^2 preview frame in {move_s * 1e3:.1f} ms, iteration stays 0")

# --- 15 ------------------------------------------------------------------
phase(f"15 BASELINE config 4 as a fit: bunny.json {SIZE}^2, 1 spp, 4 bounces, the denoiser, "
      f"albedos from 0.5, {FIT_STEPS} Adam steps")
with torch.no_grad():
    fit_target = tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=1, max_bounces=4,
                                          differentiable=True)[0].color
fit_start = dataclasses.replace(scene, materials=dataclasses.replace(
    scene.materials, albedo=torch.full_like(scene.materials.albedo, 0.5)))
step_ends = []


def on_step(i, loss):
    torch.cuda.synchronize()
    step_ends.append(time.perf_counter())


torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
mem0 = torch.cuda.memory_allocated()
reset_counts()
t0 = time.perf_counter()
fitted, fit_losses = fit_scene(fit_start, desc.camera, fit_target, SIZE, SIZE, steps=FIT_STEPS,
                               denoise=True, material_filter=("albedo",), callback=on_step)
fit_launches = read_counts()
fit_peak = torch.cuda.max_memory_allocated() - mem0
fit_walls = [b - a for a, b in zip([t0] + step_ends[:-1], step_ends)]
assert len(fit_losses) == FIT_STEPS and all(np.isfinite(fit_losses)), fit_losses
assert fit_losses[-1] < fit_losses[0], fit_losses
assert fit_launches["treelet_closest_hit(payload=True)"] > 0, fit_launches
assert fit_launches["treelet_closest_hit"] == 0 and fit_launches["winner_step"] == 0, fit_launches
# differentiable: the diff_trip route, a trip_head, payload sweep and
# diff_trip_fwd a bounce; only the albedos want a gradient, so no
# slot_scatter
assert fit_launches["trip_tail"] == 0 and fit_launches["slot_scatter"] == 0, fit_launches
assert (fit_launches["diff_trip_fwd"] == fit_launches["diff_trip_bwd"]
        == fit_launches["treelet_closest_hit(payload=True)"] > 0), fit_launches
for name in ("fuzz", "ior", "emission"):
    assert torch.equal(getattr(fitted.materials, name), getattr(scene.materials, name)), name
for name in ("positions", "sphere_center", "sphere_radius"):
    assert torch.equal(getattr(fitted, name), getattr(scene, name)), name
assert not torch.equal(fitted.materials.albedo, fit_start.materials.albedo)
fit_wall = sorted(fit_walls[1:])[len(fit_walls[1:]) // 2]
fit_per_step = {k: v / FIT_STEPS for k, v in fit_launches.items()}
print(f"the diff_trip route; losses {[round(x, 6) for x in fit_losses]}; launches {fit_launches} "
      f"({fit_per_step['treelet_closest_hit(payload=True)']:g} payload sweeps a step); peak "
      f"memory {fit_peak / 2**30:.2f} GiB above the {mem0 / 2**30:.2f} GiB resident before it")
print(f"step walls {', '.join(f'{w:.3f}' for w in fit_walls)} s; median of steps 2-{FIT_STEPS} "
      f"{fit_wall:.3f} s  [{smi}]")
print("  albedo " + str([[round(x, 4) for x in row] for row in fitted.materials.albedo.tolist()])
      + " (true " + str([[round(x, 4) for x in row] for row in scene.materials.albedo.tolist()])
      + ")")
# one more step under the profiler; the denoiser's forward and backward
# alone on a render's buffers, filter_size 4 as in render_loss
with torch.profiler.profile(activities=acts) as prof:
    fit_scene(fit_start, desc.camera, fit_target, SIZE, SIZE, steps=1, denoise=True,
              material_filter=("albedo",))
    torch.cuda.synchronize()
kav = prof.key_averages()
with open(os.path.join(OUT, "fit_step_profile.txt"), "w") as fh:
    fh.write(kav.table(sort_by="self_device_time_total", row_limit=60))
on_card = [e for e in kav if e.device_type == torch.autograd.DeviceType.CUDA]
fit_busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
fit_kernels = sum(e.count for e in on_card)
with torch.no_grad():
    fb, _ = tpupt_torch.render_image(fit_start, desc.camera, SIZE, SIZE, spp=1, max_bounces=4,
                                     differentiable=True)
fit_dn_in = [t.reshape(SIZE, SIZE, -1).squeeze(-1).requires_grad_(True)
             for t in (fb.color, fb.normal, fb.depth)]


def fit_denoise_step():
    img = tpupt_torch.atrous_denoise(*fit_dn_in, desc.camera, filter_size=4)
    torch.autograd.grad(((img - fit_target.reshape(SIZE, SIZE, 3)) ** 2).mean(), fit_dn_in)
    torch.cuda.synchronize()


fit_denoise_step()
with torch.profiler.profile(activities=acts) as prof:
    fit_denoise_step()
fit_dn_ms = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
if fit_busy_ms > 0:
    print(f"profiled step: device busy {fit_busy_ms:.1f} ms = {fit_busy_ms / 1e3 / fit_wall:.1%} of "
          f"the median step; {fit_kernels} kernels; the denoiser's forward and backward alone "
          f"{fit_dn_ms:.1f} ms of device time = {fit_dn_ms / fit_busy_ms:.1%} of the step's")
else:
    print("profiled step: the profiler recorded no device time (not measured)")

# the fit's loss and gradients, kernels against twins, at 128^2
FIT_SMALL = 128
with torch.no_grad():
    tgt_small = tpupt_torch.render_image(scene, desc.camera, FIT_SMALL, FIT_SMALL, spp=1,
                                         max_bounces=4, differentiable=True)[0].color


def twin_render_loss(params):
    """render_loss with the twins bound (tpupt_torch/diff/fit.py's math)."""
    buf, _ = tpupt_torch.render_image(
        tpupt_torch.with_params(fit_start, params), desc.camera, FIT_SMALL, FIT_SMALL, spp=1,
        max_bounces=4, differentiable=True, intersect_fn=twin_diff,
        any_hit=sweep_kernel.treelet_any_hit_plain)
    img = tpupt_torch.atrous_denoise(
        buf.color.reshape(FIT_SMALL, FIT_SMALL, 3), buf.normal.reshape(FIT_SMALL, FIT_SMALL, 3),
        buf.depth.reshape(FIT_SMALL, FIT_SMALL), desc.camera, filter_size=4).reshape(-1, 3)
    return torch.mean((img - tgt_small) ** 2)


pk, pp = tpupt_torch.extract_params(fit_start), tpupt_torch.extract_params(fit_start)
lk = render_loss(pk, fit_start, desc.camera, tgt_small, FIT_SMALL, FIT_SMALL, 1, 4, True, False)
lp = twin_render_loss(pp)
gk = dict(zip(LEAVES, torch.autograd.grad(lk, [leaf(pk, k) for k in LEAVES], allow_unused=True,
                                          materialize_grads=True)))
gp = dict(zip(LEAVES, torch.autograd.grad(lp, [leaf(pp, k) for k in LEAVES], allow_unused=True,
                                          materialize_grads=True)))
assert torch.allclose(lk, lp, rtol=1e-5), (float(lk), float(lp))
fit_gap = {}
for k in LEAVES:
    scale = float(gp[k].abs().max())
    assert torch.allclose(gk[k], gp[k], rtol=1e-5, atol=1e-5 * scale), k
    fit_gap[k] = float((gk[k] - gp[k]).abs().max()) / scale if scale > 0 else 0.0
assert float(gk["materials.albedo"].abs().max()) > 0
print(f"render_loss at {FIT_SMALL}^2, kernels vs twins: {float(lk.detach()):.7g} vs "
      f"{float(lp.detach()):.7g}; every "
      f"gradient within rtol 1e-5 (largest gap {max(fit_gap.values()):.3g} of its leaf's max |grad|)")

# a geometry fit: vertices and spheres too, the table rebaked every step
GEO = 256
with torch.no_grad():
    tgt_geo = tpupt_torch.render_image(scene, desc.camera, GEO, GEO, spp=1, max_bounces=4,
                                       differentiable=True)[0].color
t0 = time.perf_counter()
geo_fit, geo_losses = fit_scene(fit_start, desc.camera, tgt_geo, GEO, GEO, steps=3,
                                learning_rate=1e-3, fit_geometry=True)
torch.cuda.synchronize()
geo_s = time.perf_counter() - t0
assert all(np.isfinite(geo_losses)), geo_losses
assert not torch.equal(geo_fit.positions, scene.positions)
with torch.no_grad():
    assert torch.equal(geo_fit.tre_tris, rebake_treelets(geo_fit).tre_tris), "stale treelet table"
print(f"fit_geometry=True at {GEO}^2, 3 steps in {geo_s:.2f} s: losses "
      f"{[round(x, 6) for x in geo_losses]}; the fitted table is the rebake of its positions")

# --- 16 ------------------------------------------------------------------
phase(f"16 row bands and sharding: bunny.json {SIZE}^2, {BAND_SPP} spp, {MAX_BOUNCES} bounces, "
      f"rr {RR}, in {BANDS} bands of {SIZE // BANDS} rows")
ROWS = SIZE // BANDS
band_info = {}
for chain in (True, False):
    full_b, full_rays = tpupt_torch.render_image(scene, desc.camera, SIZE, SIZE, spp=BAND_SPP,
                                                 max_bounces=MAX_BOUNCES, rr_start=RR,
                                                 chain_samples=chain)
    parts, walls_b, launches_b = [], [], []
    for b in range(BANDS):
        reset_counts()
        part, wall_b = timed(lambda: tpupt_torch.render_image(
            scene, desc.camera, SIZE, SIZE, spp=BAND_SPP, max_bounces=MAX_BOUNCES, rr_start=RR,
            chain_samples=chain, row0=b * ROWS, rows=ROWS))
        launches_b.append(read_counts())
        parts.append(part)
        walls_b.append(wall_b)
    assert all(c["treelet_closest_hit"] > 0 for c in launches_b), launches_b
    # each band's render takes the trip route, one trip_tail a sweep
    assert all(c["trip_tail"] == c["treelet_closest_hit"] for c in launches_b), launches_b
    for key in ("color", "normal", "depth"):
        got = torch.cat([getattr(p[0], key) for p in parts])
        assert torch.equal(got, getattr(full_b, key)), f"bands != the full render in {key}"
    band_rays = [int(p[1]) for p in parts]
    assert sum(band_rays) == int(full_rays), (band_rays, int(full_rays))
    mode = "chained" if chain else "per sample"
    band_info[mode] = dict(rays=band_rays, walls_s=walls_b, launches=launches_b)
    print(f"{mode}: the {BANDS} bands, concatenated, equal the full render in all three buffers; "
          f"segments {band_rays} = {int(full_rays)}; launches by band {launches_b}; walls "
          f"{', '.join(f'{w:.3f}' for w in walls_b)} s")
    if chain:
        full_chained, full_chained_rays = full_b, int(full_rays)
    del full_b, parts


def free_port():
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def collectives(kav):
    """{op: (calls, device ms under them)} of the all-reduce ops a profile
    holds (with one rank, NCCL copies instead of launching its kernels)."""
    return {e.key: (e.count, dev_total(e) / 1e3) for e in kav
            if e.device_type == torch.autograd.DeviceType.CPU
            and ("allreduce" in e.key.lower() or "all_reduce" in e.key.lower())}


# one rank of NCCL: the sharded entry points through a real group
init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
(sh_buf, sh_rays), sh_wall = timed(lambda: render_image_sharded(
    scene, desc.camera, SIZE, SIZE, BAND_SPP, max_bounces=MAX_BOUNCES, rr_start=RR))
assert int(sh_rays) == full_chained_rays
for key in ("color", "normal", "depth"):
    assert torch.equal(getattr(sh_buf, key), getattr(full_chained, key)), key
print(f"render_image_sharded on a one-rank NCCL group: equal to render_image, {int(sh_rays)} "
      f"segments, {sh_wall:.3f} s")
del sh_buf
zeros = torch.zeros((n, 3), device=DEV)
nccl_info = {}
for overlap in (True, False):
    placement = "overlap" if overlap else "posthoc"
    (loss_s, grads_s), wall_s = timed(lambda: render_loss_and_grads_sharded(
        scene, desc.camera, zeros, SIZE, SIZE, DIFF_SPP, max_bounces=DIFF_BOUNCES,
        overlap_grad_psum=overlap))
    assert torch.allclose(loss_s, d_loss, rtol=1e-5), (float(loss_s), float(d_loss))
    # against one process's gradient by the same route: per bounce the
    # body route, post hoc the differentiable trip (phase 6 holds the two
    # routes to each other at 1e-4)
    want_g = d_grads_body if overlap else d_grads
    gap = {}
    for k in LEAVES:
        a, b = leaf(grads_s, k), want_g[k]
        scale = float(b.abs().max())
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale), (placement, k)
        gap[k] = float((a - b).abs().max()) / scale if scale > 0 else 0.0
    with torch.profiler.profile(activities=acts) as prof:
        render_loss_and_grads_sharded(scene, desc.camera, zeros, SIZE, SIZE, DIFF_SPP,
                                      max_bounces=DIFF_BOUNCES, overlap_grad_psum=overlap)
        torch.cuda.synchronize()
    coll = collectives(prof.key_averages())
    nccl_info[placement] = dict(wall_s=wall_s, loss=float(loss_s), grad_gap=gap,
                                collectives=coll)
    print(f"render_loss_and_grads_sharded, {placement}, {SIZE}^2 {DIFF_SPP} spp {DIFF_BOUNCES} "
          f"bounces: loss {float(loss_s):.7g} vs {float(d_loss):.7g} (phase 6); every gradient "
          f"within rtol 1e-5 (largest gap {max(gap.values()):.3g}); {wall_s:.3f} s; collectives "
          f"(calls, device ms) {coll}  [{smi}]")
torch.distributed.destroy_process_group()


def two_ranks(flag, timeout=600):
    """``chip_smoke.py <flag> R PORT OUT`` as ranks 0 and 1 of a gloo group
    on this host, sharing the card; each rank's saved arrays."""
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"), flag,
                                   str(r), str(port), outs[r]], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  # both ranks on this host: gloo's pairs over loopback
                                  env=dict(os.environ, GLOO_SOCKET_IFNAME="lo"))
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (so, se) in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"a {flag} rank exited {p.returncode}:\n{se[-3000:]}")
        return [dict(np.load(o)) for o in outs]


# two ranks on the one card, gloo over CUDA tensors
b2 = BAND2["size"]
ranks2 = two_ranks("--band-rank")
buf2, rays2 = tpupt_torch.render_image(scene, desc.camera, b2, b2, spp=BAND2["spp"],
                                       max_bounces=BAND2["max_bounces"],
                                       rr_start=BAND2["rr_start"])
# one process's gradients by each placement's route: per bounce the body
# route, post hoc the differentiable trip
l2, _, g2_post, *_ = fwd_bwd(b2, BAND2["diff_spp"], DIFF_BOUNCES)
l2b, _, g2_over, *_ = fwd_bwd(b2, BAND2["diff_spp"], DIFF_BOUNCES, intersect_fn=BODY_DIFF)
assert torch.equal(l2, l2b), (float(l2), float(l2b))
g2_by = {"overlap": g2_over, "posthoc": g2_post}
two_info = {}
for r, res in enumerate(ranks2):
    assert int(res["rays"]) == int(rays2), (r, int(res["rays"]), int(rays2))
    for key in ("color", "normal", "depth"):
        assert np.array_equal(res[key], getattr(buf2, key).cpu().numpy()), (r, key)
    for placement in ("overlap", "posthoc"):
        assert np.isclose(float(res[f"{placement}_loss"]), float(l2), rtol=1e-5), (r, placement)
        for k in LEAVES:
            b = g2_by[placement][k].cpu().numpy()
            scale = float(np.abs(b).max())
            assert np.allclose(res[f"{placement}.{k}"], b, rtol=1e-5, atol=1e-5 * scale), \
                (r, placement, k)
    two_info[f"rank{r}"] = {k: float(res[k]) for k in ("render_wall", "overlap_wall",
                                                       "posthoc_wall")}
print(f"two gloo ranks on the card, {b2}^2: the gathered render equals one process's "
      f"({int(rays2)} segments) on both ranks; both placements' loss and gradients match one "
      f"process's; walls (s) {two_info}  [{smi}]")

# --- 17 ------------------------------------------------------------------
phase("17 the oracles: treelet_closest_hit's hits against the BVH walk and the brute force; "
      "treelet_any_hit at K = 14,782 against its twin and the BVH walk")
GEOM = dict(rtol=1e-5, atol=1e-5)


def hold_to_oracle(label, got, want):
    """The kernel's ids and t against an oracle's: equal ids, except where
    both find a hit at the same t within GEOM (an exact-t tie that the two
    visit orders resolve apart); t of the agreeing hits within GEOM.
    Returns (hits, ties, max ulp gap)."""
    differ = ((got.kind != want.kind) | (got.obj_id != want.obj_id)
              | (got.prim_id != want.prim_id))
    close = torch.isclose(got.t, want.t, **GEOM)
    bad = differ & ~close
    assert not bool(bad.any()), f"{label}: {int(bad.sum())} lanes hit other primitives"
    hit = (want.kind >= 0) & ~differ
    assert torch.allclose(got.t[hit], want.t[hit], **GEOM), label
    ties = int(differ.sum())
    gap = ulp_gap(got.t[hit], want.t[hit])
    print(f"  {label}: {int(hit.sum())} hits equal, {ties} exact-t ties, t within {gap} ulps")
    return int(hit.sum()), ties, gap


def oracles_on(label, scn, ro, rd, t_min, active, brute=True):
    ids_k, _ = intersect.intersect_scene_ids(scn, ro, rd, t_min, active)
    (ids_b, _), bvh_s = timed(lambda: intersect.intersect_scene_ids_bvh(scn, ro, rd, t_min,
                                                                        active))
    out = dict(bvh=hold_to_oracle(f"{label} vs the BVH walk ({bvh_s:.2f} s)", ids_k, ids_b))
    if brute:
        (ids_f, _), brute_s = timed(lambda: intersect_scene_ids_brute(scn, ro, rd, t_min, active))
        out["brute"] = hold_to_oracle(f"{label} vs the brute force ({brute_s:.2f} s)", ids_k,
                                      ids_f)
    return out


ORC = 256
pix_o = torch.arange(ORC * ORC, device=DEV)
with torch.no_grad():
    st_o, seed_o = integrator._fresh_state(scene, desc.camera.to(DEV), ORC, ORC, pix_o, 0)
    oracle_info = {"primaries": oracles_on(f"bunny.json {ORC}^2 primaries", scene, st_o["ro"],
                                           st_o["rd"], st_o["t_min"], st_o["alive"])}
    _ids_o, hit_o = intersect.intersect_scene_ids(scene, st_o["ro"], st_o["rd"], st_o["t_min"],
                                                  st_o["alive"])
    ro_o, rd_o, tmin_o, *_ = shade(scene, hit_o, st_o["ro"], st_o["rd"], st_o["t_min"],
                                   st_o["color"], seed_o, torch.zeros_like(pix_o))
    oracle_info["secondaries"] = oracles_on(f"bunny.json {ORC}^2 secondaries", scene, ro_o, rd_o,
                                            tmin_o, hit_o.mask)
REF = 128
(bk, rk), ref_wall = timed(lambda: tpupt_torch.render_image(scene, desc.camera, REF, REF, spp=2,
                                                            max_bounces=6))
(bref, rref), ref_ref_wall = timed(lambda: render_image_ref(scene, desc.camera, REF, REF, spp=2,
                                                            max_bounces=6))
assert int(rk) == int(rref), (int(rk), int(rref))
ref_gap = {}
for key in ("color", "depth"):
    a, b = getattr(bk, key), getattr(bref, key)
    assert torch.allclose(a, b, atol=1e-4), key
    ref_gap[key] = float((a - b).abs().max())
print(f"render_image_ref vs render_image, {REF}^2, 2 spp, 6 bounces: {int(rk)} segments each; max "
      f"|difference| {ref_gap}; {ref_ref_wall:.2f} s vs {ref_wall:.3f} s")
# with NEE: the reference traces the shadow rays by its own closest hit,
# so it launches neither kernel, while the render it checks runs both
reset_counts()
bak, rak = tpupt_torch.render_image(area, area_cam, REF, REF, spp=2, max_bounces=6)
area_ref_launches = read_counts()
assert area_ref_launches["treelet_any_hit"] > 0, area_ref_launches
reset_counts()
(baref, raref), area_ref_wall = timed(lambda: render_image_ref(area, area_cam, REF, REF, spp=2,
                                                               max_bounces=6))
assert not any(read_counts().values()), read_counts()
assert int(rak) == int(raref), (int(rak), int(raref))
area_ref_gap = {}
for key in ("color", "depth"):
    a, b = getattr(bak, key), getattr(baref, key)
    assert torch.allclose(a, b, atol=1e-4), ("cornell_area", key)
    area_ref_gap[key] = float((a - b).abs().max())
print(f"render_image_ref vs render_image on cornell_area.json, {REF}^2, 2 spp, 6 bounces: "
      f"{int(rak)} segments each; max |difference| {area_ref_gap}; the reference launched no "
      f"kernel, the render {area_ref_launches}; {area_ref_wall:.2f} s")

# ajax-white-hi.json: the kernel's first run at this treelet count
ensure_models(names=["ajax_hi.obj"])
hi_desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "ajax-white-hi.json"))
(scene_hi, hi_build_s) = timed(lambda: hi_desc.build(leaf_size=32, device=DEV))
K_hi = scene_hi.tre_min.shape[0]
hi_smem = kernels.load().tpupt_treelet_smem_bytes(K_hi, scene_hi.s_leaf_size)
hi_limit = torch.cuda.get_device_properties(DEV).shared_memory_per_block_optin
print(f"ajax-white-hi.json built in {hi_build_s:.1f} s: {scene_hi.tri_idx.shape[0]} triangles, "
      f"K={K_hi} treelets; the cull's shared memory {hi_smem} B of the block's {hi_limit} B")
fx_h, fy_h = pixel_centers(ORC, ORC, device=DEV)
ro_h, rd_h = generate_rays(hi_desc.camera.to(DEV), ORC, ORC, fx_h, fy_h)
tmin_h = torch.full((ORC * ORC,), 1e-4, device=DEV)
act_h = torch.ones(ORC * ORC, dtype=torch.bool, device=DEV)
with torch.no_grad():
    oracle_info["ajax_white_hi_primaries"] = oracles_on(
        f"ajax-white-hi.json {ORC}^2 primaries", scene_hi, ro_h, rd_h, tmin_h, act_h, brute=False)
    rows_h, actp_h = packets._pack_rows(ro_h, rd_h, tmin_h, torch.full_like(tmin_h, intersect.BIG_T),
                                        act_h)
hi_sweep = compare_sweep(f"ajax-white-hi.json {ORC}^2 primaries", scene_hi, rows_h, actp_h)
hi_sweep.update(smem_bytes=hi_smem, triangles=int(scene_hi.tri_idx.shape[0]))
# the any-hit kernels' first run at this K: shadow rays from the
# primaries' hits toward a point above the bust, where the light is on the
# hit's side of the surface
HI_LIGHT = (0.0, 9.0, 0.0)
with torch.no_grad():
    _ids_hh, hit_hh = intersect.intersect_scene_ids(scene_hi, ro_h, rd_h, tmin_h, act_h)
    to_light = Vec3(*(torch.full_like(hit_hh.point.x, v) for v in HI_LIGHT)) - hit_hh.point
    lit_side = hit_hh.mask & (hit_hh.normal.dot(to_light) > 0)
    rows_hs, actp_hs, (p_hs, d_hs, tmin_hs, tlim_hs) = shadow_rows(hit_hh, lit_side, HI_LIGHT)
hi_any = compare_any_hit(f"ajax-white-hi.json shadow rays ({ORC}^2 primaries' hits)", scene_hi,
                         rows_hs, actp_hs)
# against the BVH walk: occluded iff its closest hit lies in [t_min, t_limit]
with torch.no_grad():
    occ_hk = packets.intersect_treelets_anyhit(scene_hi, p_hs, d_hs, tmin_hs, tlim_hs, lit_side)
    (ids_hb, _), hi_bvh_s = timed(lambda: intersect.intersect_scene_ids_bvh(
        scene_hi, p_hs, d_hs, tmin_hs, lit_side))
    occ_hb = lit_side & (ids_hb.kind >= 0) & (ids_hb.t <= tlim_hs)
bad = occ_hk != occ_hb
assert not bool(bad.any()), (f"ajax-white-hi.json: {int(bad.sum())} lanes' occlusion differs from "
                             f"the BVH walk's; t there {ids_hb.t[bad][:8].tolist()}")
hi_any.update(bvh_equal_lanes=int(lit_side.sum()), bvh_occluded=int(occ_hb.sum()))
print(f"  equal to the BVH walk's occlusion on all {int(lit_side.sum())} lanes "
      f"({int(occ_hb.sum())} occluded; the walk {hi_bvh_s:.2f} s)")
del scene_hi, rows_h, actp_h, rows_hs, actp_hs

# --- 18 ------------------------------------------------------------------
phase("18 the harness: run_config for every config at its CONFIGS size; treelet_closest_hit vs "
      "twin on multi_mesh, ajax-white and ajax-white-hi trips; the sharded branch on two gloo "
      "ranks; the scaling script")
# a twin call on a trip of the bigger scenes is held to about this long: a
# middle band of the trip's image rows where the whole trip would take more
TWIN_BUDGET_S = 5.0
BAND_UNIT = 16  # rows: a band of 16 rows is whole packets at widths 720 and 1024


def run_harness_config(name):
    """``harness.run_config(name, iters=1)`` on the card, counts reset just
    before and read just after: the result, the call's wall, the scene
    build's seconds (inside it), the scene and camera it built, and the
    render calls it made (the warm-up and the windows'); then one more of
    those calls under torch.profiler."""
    cfg, orig_timed, built, calls, call = harness.CONFIGS[name], harness._timed, {}, [], {}

    def build(**kw):
        t0 = time.perf_counter()
        scn, cam = cfg["scene"](**kw)
        torch.cuda.synchronize()
        built.update(build_s=time.perf_counter() - t0, scene=scn, camera=cam)
        return scn, cam

    def timed(fn, args, iters, group=None):
        def counted(*a):
            calls.append(1)
            return fn(*a)
        call.update(fn=fn, args=args)
        return orig_timed(counted, args, iters, group)

    harness.CONFIGS[name], harness._timed = dict(cfg, scene=build), timed
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = harness.run_config(name, iters=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        harness.CONFIGS[name], harness._timed = cfg, orig_timed
    n_calls = len(calls)
    assert all(v % n_calls == 0 for v in counts.values()), (name, counts, n_calls)
    per_call = {k: v // n_calls for k, v in counts.items()}
    scn = built["scene"]
    info = dict(mrays_per_s=res.mrays_per_sec, rays=res.rays, equivalent_s=res.seconds,
                calls=n_calls, wall_s=wall, build_s=built["build_s"],
                treelets=int(scn.tre_min.shape[0]), triangles=int(scn.tri_idx.shape[0]),
                launches_per_call=per_call, extra=res.extra)
    print(f"{name}: {res.mrays_per_sec:.3f} Mrays/s (best window), {res.rays} rays in the "
          f"{n_calls - 1} timed calls, {res.seconds:.3f} equivalent s; the call {wall:.1f} s of "
          f"wall, the scene build {built['build_s']:.2f} s of it; {info['triangles']} triangles, "
          f"K={info['treelets']}; launches per render call {per_call}  [{smi}]", flush=True)
    # the device's time in one more call, by kernel, beside the best
    # window's time a call
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call["fn"](*call["args"])
        torch.cuda.synchronize()
    kav = prof.key_averages()
    kern = sorted((e for e in kav if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    with open(os.path.join(OUT, f"harness_{name}_profile.txt"), "w") as fh:
        fh.write(kav.table(sort_by="self_device_time_total", row_limit=30))
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    call_ms = res.seconds / (n_calls - 1) * 1e3
    sweep = sum(e.self_device_time_total for e in kern if "treelet_closest_hit_kernel" in e.key)
    info.update(best_window_call_ms=call_ms, profiled_device_busy_ms=busy,
                profiled_sweep_ms=sweep / 1e3, profiled_kernels=sum(e.count for e in kern),
                profiled_top=[(e.key[:60], e.self_device_time_total / 1e3) for e in kern[:4]])
    print(f"  profiled call: device busy {busy:.1f} ms = {busy / call_ms:.1%} of the best window's "
          f"{call_ms:.1f} ms a call; the sweep {sweep / 1e3:.1f} ms; {info['profiled_kernels']} "
          f"kernels; top {[(k, round(v, 1)) for k, v in info['profiled_top']]}"
          if busy > 0 else "  profiled call: the profiler recorded no device time (not measured)",
          flush=True)
    return info, scn, built["camera"]


def record_trips(name, scn, cam):
    """One render at the config's settings, its wall and peak memory; then
    the same render once more with the inputs of trips 0 and 2 kept:
    (buffers, rays, trips, {trip: record}, peak bytes, wall)."""
    cfg, (w, h) = harness.CONFIGS[name], config_wh(name)

    def render():
        return tpupt_torch.render_image(scn, cam, w, h, spp=cfg["spp"], max_bounces=cfg["mb"],
                                        rr_start=cfg["rr"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    (buf, rays), wall = timed(render)
    peak = torch.cuda.max_memory_allocated() - mem0
    (buf2, rays2), trips, kept = record_trip_inputs(render, {0, 2})
    assert int(rays2) == int(rays) and torch.equal(buf2.color, buf.color), name
    return buf, int(rays), trips, kept, peak, wall


def config_wh(name):
    size = harness.CONFIGS[name]["size"]
    return (size, size) if isinstance(size, int) else size


def twin_band(scn, rows, act_p, width):
    """The packets of the middle band of a trip's image rows on which one
    twin call takes about TWIN_BUDGET_S (the whole trip where it fits), by
    a probe of 4 x BAND_UNIT middle rows (the bust's, the heaviest, so the
    estimate errs long): (rows, act, first row, rows)."""
    height = act_p.numel() // width
    unit = BAND_UNIT * width // packets.PACKET
    assert BAND_UNIT * width % packets.PACKET == 0 and height % BAND_UNIT == 0, (width, height)
    units = height // BAND_UNIT

    def band(u0, n_units):
        sl = slice(u0 * unit, (u0 + n_units) * unit)
        return {k: v[sl] for k, v in rows.items()}, act_p[sl]

    probe_units = min(4, units)
    probe = functools.partial(sweep_kernel.treelet_closest_hit_plain,
                              *band((units - probe_units) // 2, probe_units), scn.tre_min,
                              scn.tre_max, scn.tre_tris, scn.s_leaf_size)
    probe()  # warm-up
    _, probe_s = timed(probe)
    n_units = max(1, min(units, int(TWIN_BUDGET_S / (probe_s / probe_units))))
    u0 = (units - n_units) // 2
    return (*band(u0, n_units), u0 * BAND_UNIT, n_units * BAND_UNIT)


harness_info = {}
harness_sweeps = {}
# (rays, trips) of a render call of the mesh configs, as the body route
# traces them (PERF.md §5), which the trip route must keep
BODY_ROUTE_COUNTS = {"multimesh": (32_119_424, 122), "ajax": (10_925_373, 62),
                     "ajax_hi": (10_930_056, 62)}
for name in harness.CONFIGS:
    info, scn, cam = run_harness_config(name)
    harness_info[name] = info
    meshes = name in ("bunny", "multimesh", "ajax", "ajax_hi")
    assert (info["launches_per_call"]["treelet_closest_hit"] > 0) == meshes, (name, info)
    assert info["launches_per_call"]["treelet_any_hit"] == 0, (name, info)  # no mesh light
    # the trip route on every forward config, cornell's (sphere NEE: the
    # trip_nee kernel) too; diff (differentiable, no emitter, no mesh)
    # takes the differentiable trip; sphere (no emitter, no mesh, 128^2:
    # one resident wave of trip_drain) hands every lane over at trip 0
    trip_route = name != "diff"
    drained = info["launches_per_call"]["trip_drain"] > 0
    assert drained == (name == "sphere"), (name, info)
    assert (info["launches_per_call"]["trip_tail"] > 0 or drained) == trip_route, (name, info)
    assert (info["launches_per_call"]["trip_nee"] > 0) == (name == "cornell"), (name, info)
    assert (info["launches_per_call"]["diff_trip_fwd"] > 0) == (name == "diff"), (name, info)
    assert (info["launches_per_call"]["diff_trip_bwd"]
            == info["launches_per_call"]["diff_trip_fwd"]), (name, info)
    print(f"  {name}: the {'trip' if trip_route else 'diff_trip'} route", flush=True)
    if name not in ("multimesh", "ajax", "ajax_hi"):
        del scn
        continue
    # the render once more, its trips 0 and 2 kept: the same rays and
    # launches as each of run_config's calls; the sweep against its twin
    buf, rays, trips, kept, peak, wall = record_trips(name, scn, cam)
    per_call = info["rays"] // (info["calls"] - 1)
    assert rays == per_call and trips == info["launches_per_call"]["treelet_closest_hit"], \
        (name, rays, per_call, trips, info["launches_per_call"])
    assert trips == info["launches_per_call"]["trip_tail"], (name, info["launches_per_call"])
    assert (rays, trips) == BODY_ROUTE_COUNTS[name], (name, rays, trips)
    for key in ("color", "normal", "depth"):
        assert bool(torch.isfinite(getattr(buf, key)).all()), (name, key)
    w, h = config_wh(name)
    info.update(trips=trips, peak_bytes=peak, render_wall_s=wall)
    print(f"  {name} render with its trips kept: {rays} rays in {trips} trips, {wall:.2f} s; peak "
          f"memory {peak / 2**30:.2f} GiB; every buffer finite", flush=True)
    if name != "multimesh":
        # the bust is visible: the frame centre differs from the sky that
        # a render with the treelet table emptied shows
        empty = dataclasses.replace(scn, tre_min=torch.full((1, 3), 3e37, device=DEV),
                                    tre_max=torch.full((1, 3), 3e37, device=DEV),
                                    tre_tris=scn.tre_tris[:1])
        sky, _ = tpupt_torch.render_image(empty, cam, w, h, spp=1, max_bounces=2)
        mid = (slice(h // 3, 2 * h // 3), slice(w // 3, 2 * w // 3))
        gap = float((buf.color.reshape(h, w, 3)[mid] - sky.color.reshape(h, w, 3)[mid]).abs().max())
        assert gap > 0.05, f"{name}: bust not visible (gap {gap})"
        info["bust_gap"] = gap
        print(f"  the bust is visible: the frame centre differs from the sky by up to {gap:.3f}")
        del empty, sky
    np.save(os.path.join(OUT, f"{name}_{w}x{h}_{harness.CONFIGS[name]['spp']}spp.npy"),
            buf.color.reshape(h, w, 3).cpu().numpy().astype(np.float16))
    del buf
    for trip in (0, 2):
        rec = kept.pop(trip)
        trip_checks[f"{name}_trip{trip}"] = compare_trip(f"{name} {w}x{h} trip {trip}", rec)
        rows_t, act_t = dict(zip(packets._ROW_KEYS, rec["rows"].unbind(0))), rec["act_p"]
        del rec
        rows_b, act_b, r0, nr = twin_band(scn, rows_t, act_t, w)
        where = "the whole trip" if nr == h else f"rows {r0}-{r0 + nr - 1} of {h}"
        harness_sweeps[f"{name}_trip{trip}"] = res_t = compare_sweep(
            f"{name} {w}x{h} trip {trip}, {where}", scn, rows_b, act_b, plain_reps=1)
        res_t.update(rows=[r0, nr])
        del rows_t, act_t, rows_b, act_b
    del scn, kept

# multi_mesh.json on the card against the same port on the host's CPU
# (where the sweep is its twin and every elementwise op is torch's CPU
# kernel), small: glass and metal meshes, refraction into closed meshes.
# The rule of the CPU tests against the JAX package: rays equal, at least
# 97% of the colour values inside IMAGE (rtol 1e-4, atol 1e-5)
MM_SMALL = dict(width=64, height=64, spp=2, max_bounces=harness.CONFIGS["multimesh"]["mb"],
                rr_start=harness.CONFIGS["multimesh"]["rr"])
scn_gpu, cam_mm = harness.CONFIGS["multimesh"]["scene"]()
scn_cpu, _ = harness.CONFIGS["multimesh"]["scene"](device="cpu")
(on_card, card_rays), card_s = timed(lambda: tpupt_torch.render_image(scn_gpu, cam_mm, **MM_SMALL))
(on_cpu, cpu_rays), cpu_s = timed(lambda: tpupt_torch.render_image(scn_cpu, cam_mm, **MM_SMALL))
assert int(card_rays) == int(cpu_rays), (int(card_rays), int(cpu_rays))
mm_gap = {}
for key in ("color", "normal", "depth"):
    a, b = getattr(on_card, key).cpu(), getattr(on_cpu, key)
    inside = (a - b).abs() <= 1e-5 + 1e-4 * b.abs()
    assert bool(torch.isfinite(a).all()) and float(inside.float().mean()) >= 0.97, key
    outside = (~inside).reshape(a.shape[0], -1).any(dim=1).nonzero().flatten().tolist()
    mm_gap[key] = dict(max_abs=float((a - b).abs().max()), inside=float(inside.float().mean()),
                       pixels_outside=outside[:16], n_outside=len(outside))
harness_info["multimesh"]["card_vs_cpu_64"] = dict(rays=int(card_rays), gaps=mm_gap, card_s=card_s,
                                                   cpu_s=cpu_s)
print(f"multi_mesh.json 64^2, 2 spp, card vs the host's CPU: {int(card_rays)} rays each; "
      + "; ".join(f"{k}: max |diff| {v['max_abs']:.3g}, {v['inside']:.2%} inside IMAGE, pixels "
                  f"outside {v['pixels_outside']}" for k, v in mm_gap.items())
      + f"; {card_s:.2f} s vs {cpu_s:.2f} s")
del scn_gpu, scn_cpu, on_card, on_cpu

# the sharded branch: multimesh on two gloo ranks sharing the card, each
# gathered image held to one process's render of the same work (the
# sharded render runs without roulette, as in the JAX harness)
mm = harness.CONFIGS["multimesh"]
ranks_h = two_ranks("--harness-rank", timeout=900)
scn_mm, cam_mm = mm["scene"]()
one, one_rays = tpupt_torch.render_image(scn_mm, cam_mm, mm["size"], mm["size"], spp=mm["spp"],
                                         max_bounces=mm["mb"])
for r, res in enumerate(ranks_h):
    assert int(res["call_rays"]) == int(one_rays), (r, int(res["call_rays"]), int(one_rays))
    for key in ("color", "normal", "depth"):
        assert np.array_equal(res[key], getattr(one, key).cpu().numpy()), (r, key)
harness_info["multimesh"]["sharded"] = {
    f"rank{r}": {k: float(res[k]) for k in ("mrays", "sharded_mrays", "devices", "scaling_eff")}
    for r, res in enumerate(ranks_h)}
print(f"multimesh sharded branch on two gloo ranks sharing the card: the gathered image equals "
      f"one process's ({int(one_rays)} rays) on both ranks; "
      + "; ".join(f"rank {r}: {float(res['mrays']):.3f} Mrays/s one-process, sharded_mrays "
                  f"{float(res['sharded_mrays']):.3f}, devices {int(res['devices'])}, scaling_eff "
                  f"{float(res['scaling_eff']):.4f}" for r, res in enumerate(ranks_h))
      + f"  [{smi}]")
del scn_mm, one

# the scaling script as a user runs it
proc = subprocess.run([sys.executable, "-m", "tpupt_torch.bench.scaling", "2"], capture_output=True,
                      text=True, timeout=900, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
if proc.returncode != 0:
    raise AssertionError(f"tpupt_torch.bench.scaling exited {proc.returncode}:\n{proc.stderr[-3000:]}")
scaling_line = json.loads(proc.stdout.strip().splitlines()[-1])
assert scaling_line["devices"] == 2 and scaling_line["device"] == torch.cuda.get_device_name(0)
print(f"python -m tpupt_torch.bench.scaling 2: {json.dumps(scaling_line)}  [{smi}]")

phase("19 the tail handover: three_balls.json 512^2, 64 spp, 50 bounces (issued trips, then "
      "trip_drain); its trips 0 and 2 against the twins; trip_drain against trip_drain_plain "
      "from the render's handover state; the render against the issued trips run to the end")
TB_SIZE, TB_SPP, TB_BOUNCES = 512, 64, 50  # more lanes than one resident wave of trip_drain
tb_desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "three_balls.json"))
tb_scene = tb_desc.build(device=DEV)
assert integrator.render_route(tb_scene) == "trip"
handover, drain_w, wave_w = {}, trip_kernel.trip_drain, trip_kernel.drain_wave


def recording_drain(plan, F, I, buf, trips):
    handover.update(plan=plan, F=F.clone(), I=I.clone(), trips=trips)
    out = drain_w(plan, F, I, buf, trips)
    handover.update(F_after=F.clone(), I_after=I.clone(), listed=int(buf.drain_len),
                    cap=buf.drain_cap, left=int(buf.count))
    return out


def tb_render():
    return tpupt_torch.render_image(tb_scene, tb_desc.camera, TB_SIZE, TB_SIZE, spp=TB_SPP,
                                    max_bounces=TB_BOUNCES)


tb_render()  # warm-up
trip_kernel.trip_drain = recording_drain
try:
    reset_counts()
    (tb_buf, tb_rays), tb_trips, tb_kept = record_trip_inputs(tb_render, {0, 2})
    tb_launches = read_counts()
finally:
    trip_kernel.trip_drain = drain_w
tb_rays = int(tb_rays)
# the main path of an emitter-free sphere render: issued trips (trip_head,
# trip_tail; no sweep, no NEE), then one trip_drain once the lanes left fit
# in its wave; the count it left reads 0
assert tb_launches["trip_drain"] == 1, tb_launches
assert tb_launches["trip_head"] == tb_launches["trip_tail"] == tb_trips > 2, tb_launches
assert tb_launches["trip_nee"] == tb_launches["treelet_closest_hit"] == 0, tb_launches
assert tb_launches["treelet_any_hit"] == 0, tb_launches
assert handover["trips"] == handover["plan"].trips_bound - tb_trips, handover["trips"]
assert handover["left"] == 0 and 0 < handover["listed"] <= handover["cap"], handover
_, tb_wall = timed(tb_render)
trip_kernel.drain_wave = lambda plan: 0  # no list: the issued trips to the end
try:
    reset_counts()
    (tb_want, tb_want_rays), tb_issued_wall = timed(tb_render)
    tb_issued = read_counts()
finally:
    trip_kernel.drain_wave = wave_w
assert tb_issued["trip_drain"] == 0 and tb_issued["trip_tail"] > tb_trips, tb_issued
assert int(tb_want_rays) == tb_rays, (int(tb_want_rays), tb_rays)
for key in ("color", "normal", "depth"):
    assert torch.equal(getattr(tb_buf, key), getattr(tb_want, key)), f"handover != issued: {key}"
print(f"three_balls {TB_SIZE}^2, {TB_SPP} spp: {tb_rays} segments; {tb_trips} issued trips, then "
      f"trip_drain on {handover['listed']} lanes (wave {handover['cap']}), 0 left; colour, normal, "
      f"depth and segments equal to the issued trips run to the end ({tb_issued['trip_tail']} "
      f"trips); {tb_wall * 1e3:.1f} ms a render against {tb_issued_wall * 1e3:.1f} issued  [{smi}]",
      flush=True)
del tb_want
for t in (0, 2):
    trip_checks[f"three_balls_trip{t}"] = compare_trip(
        f"three_balls {TB_SIZE}^2, {TB_SPP} spp trip {t}", tb_kept.pop(t))
# trip_drain and its twin from the state the render handed over, each with
# a list of its own; the kernel lists the lanes in warp order, the twin in
# lane order
tb_plan, F0, I0, tb_left_trips = (handover[k] for k in ("plan", "F", "I", "trips"))
bk, bp = (trip_kernel.trip_buffers(tb_plan, drain=True) for _ in range(2))
Fk, Ik, Fp, Ip = F0.clone(), I0.clone(), F0.clone(), I0.clone()
trip_kernel.trip_drain(tb_plan, Fk, Ik, bk, tb_left_trips)
torch.cuda.synchronize()
_, drain_plain_s = timed(lambda: trip_kernel.trip_drain_plain(tb_plan, Fp, Ip, bp, tb_left_trips))
require_equal_state("trip_drain three_balls", (Fk, Ik), (Fp, Ip))
require_equal("trip_drain three_balls count and length", [bk.count, bk.drain_len],
              [bp.count, bp.drain_len])
n_listed = int(bk.drain_len)
assert torch.equal(bk.drain_ids[:n_listed].sort().values, bp.drain_ids[:n_listed]), \
    "trip_drain listed other lanes than its twin"
require_equal_state("trip_drain three_balls vs the render's call", (Fk, Ik),
                    (handover["F_after"], handover["I_after"]))


def restore_drain():
    Fk.copy_(F0)
    Ik.copy_(I0)


drain_ms = events_ms(restore_drain, lambda: trip_kernel.trip_drain(tb_plan, Fk, Ik, bk,
                                                                   tb_left_trips), 5)
drain_dev_ms = kernel_ms(restore_drain, lambda: trip_kernel.trip_drain(tb_plan, Fk, Ik, bk,
                                                                       tb_left_trips), 5)
restore_drain()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    trip_kernel.trip_drain(tb_plan, Fk, Ik, bk, tb_left_trips)
    torch.cuda.synchronize()
drain_prof_ms = {k: sum(e.self_device_time_total for e in prof.key_averages() if k in e.key) / 1e3
                 for k in ("trip_drain_compact_kernel", "trip_drain_kernel")}
if not any(drain_prof_ms.values()):  # after phase 16 the profiler may record no device time
    drain_prof_ms = dict.fromkeys(drain_prof_ms)
# the work (PERF.md section 2's rule): every segment the drain traces, its
# sphere tests, the winner's t and normal and the body; every sample it
# ends, the fold; bytes: every lane's done flag (the compaction), each
# listed lane's id written and read and its state read and written once
ik = trip_kernel.I_KEYS
seg_d = Ik[ik.index("segs")].long() - I0[ik.index("segs")].long()
drain_segs, drain_longest = int(seg_d.sum()), int(seg_d.max())
drain_folds = int((Ik[ik.index("k")].long() - I0[ik.index("k")].long()).sum())
drain_flops = (drain_segs * (tb_plan.tables[1] * HEAD_SPHERE_FLOPS + HEAD_WIN_FLOPS
                             + TAIL_LIVE_FLOPS) + drain_folds * TAIL_FOLD_FLOPS)
drain_bytes = tb_plan.n * 4 + n_listed * (8 + (len(trip_kernel.F_KEYS) + len(ik)) * 8)
drain_bound_ms, drain_bound_by = bound(drain_flops, drain_bytes)
drain_check = dict(
    handover_trip=tb_trips, lanes=n_listed, wave=handover["cap"], segments=drain_segs,
    render_segments=tb_rays, samples_ended=drain_folds, longest_lane_trips=drain_longest,
    ms=drain_ms, device_ms=drain_dev_ms, profiler_ms=drain_prof_ms, plain_ms=drain_plain_s * 1e3,
    bytes=drain_bytes, flops=drain_flops, bound_ms=drain_bound_ms, bound_by=drain_bound_by,
    share_of_bound=drain_bound_ms / drain_dev_ms, max_abs_err=0.0, render_ms=tb_wall * 1e3,
    issued_render_ms=tb_issued_wall * 1e3, issued_trips=tb_issued["trip_tail"])
print(f"trip_drain from the handover state: the whole state, the count and the list equal to "
      f"trip_drain_plain's and to the render's call; {drain_segs} segments "
      f"({drain_segs / tb_rays:.1%} of the render's), {drain_folds} samples ended, the longest "
      f"lane {drain_longest} trips; "
      f"{drain_ms:.4f} ms a call (events), {drain_dev_ms:.4f} ms on the device (profiler: "
      + (", ".join(f"{k} {v:.4f}" for k, v in drain_prof_ms.items())
         if drain_prof_ms["trip_drain_kernel"] is not None else "not measured")
      + f"), twin {drain_plain_s * 1e3:.1f} ms; "
      f"{drain_bytes / 1e6:.1f} MB, {drain_flops / 1e9:.4f} GFLOP; bound {drain_bound_ms:.4f} ms "
      f"({drain_bound_by}), {drain_bound_ms / drain_dev_ms:.1%} of it  [{smi}]", flush=True)
del tb_scene, tb_buf, tb_kept, handover, F0, I0, Fk, Ik, Fp, Ip, bk, bp

# --- 20 ------------------------------------------------------------------
phase("20 lit mesh renders against the benchmark's plain reference: the Cornell box of Ray "
      "Tracing: The Next Week (h100bench's cornell_box) at 512^2 and cornell_area.json's rows "
      "that the cull's repair brought back at 2048^2; 16 spp, 50 bounces, the trip route")
from h100bench import run as bench_run  # noqa: E402
from h100bench.reference import pathtrace as bench_ref  # noqa: E402
from h100bench.reference import pathtrace_scene as bench_ref_scene  # noqa: E402

# rows of cornell_area.json at 2048^2 whose pixels the trip route left off
# the reference before the repair: {sample start: rows} (job 1 of seeds
# 2147492001 and 2147492003)
LIT_AREA_ROWS = {8369: [1686], 8371: [33, 1199]}


def lit_rows_check(label, path, size, start, rows, ref=bench_ref, background=False):
    """``rows`` (None: all) of ``path``'s render at ``size``^2, 16 spp, 50
    bounces, no roulette, on the trip route, against the plain reference
    ``ref`` (the scene's background color read where ``background``): no
    pixel off outside ties, and every trip the sweep, trip_nee and
    any-hit."""
    desc = scene_from_json(path, honor_background=background)
    scn = desc.build(leaf_size=32, device=DEV)
    reset_counts()
    t0 = time.perf_counter()
    if rows is None:
        lit_buf, _ = tpupt_torch.render_image(scn, desc.camera, size, size, spp=16,
                                              max_bounces=50, rr_start=None, start_iteration=start)
        got = [lit_buf.color, lit_buf.normal, lit_buf.depth]
        rows = list(range(size))
    else:
        parts = [tpupt_torch.render_image(scn, desc.camera, size, size, spp=16, max_bounces=50,
                                          rr_start=None, start_iteration=start, row0=r,
                                          rows=1)[0] for r in rows]
        got = [torch.cat([getattr(b, k) for b in parts]) for k in ("color", "normal", "depth")]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    r = torch.tensor(rows, dtype=torch.int64, device=DEV)
    pix = (r[:, None] * size + torch.arange(size, device=DEV)).reshape(-1)
    t0 = time.perf_counter()
    *want, _, tied = ref.render_forward(ref.load_scene(path, DEV), size, size, 16, 50, start,
                                        pix=pix)
    ref_s = time.perf_counter() - t0
    off = torch.zeros_like(tied)
    for a, b in zip(got, want):
        off |= (a != b).reshape(a.shape[0], -1).any(dim=1)
    n_off = int((off & ~tied).sum())
    trips = counts["trip_tail"]
    print(f"{label}: {len(rows)} rows, {int(tied.sum())} tied pixels, {n_off} off the reference; "
          f"{trips} trips, launches {({k: counts[k] for k in ('trip_head', 'treelet_closest_hit', 'trip_nee', 'treelet_any_hit', 'trip_tail')})}; "
          f"render {wall:.2f} s, reference {ref_s:.1f} s", flush=True)
    assert n_off == 0, label
    assert trips > 0 and all(counts[k] == trips for k in (
        "trip_head", "trip_nee", "treelet_closest_hit", "treelet_any_hit")), counts
    return dict(rows=len(rows), tied=int(tied.sum()), off=n_off, trips=trips)


cb_path = bench_run.prepare(ROOT, bench_run.load_json(bench_run.HERE, "configs",
                                                      "cornell_box.json"))
lit_checks = {"cornell_box_512": lit_rows_check("the Cornell box, 512^2", cb_path, 512, 9001,
                                                None, bench_ref_scene, True)}
ensure_models(names=["quad.obj"])
area_path = os.path.join(locate_asset_path(), "scenes", "cornell_area.json")
for start, rows in LIT_AREA_ROWS.items():
    lit_checks[f"cornell_area_{start}"] = lit_rows_check(
        f"cornell_area.json 2048^2 from sample {start}, the rows of the pixels the repair "
        f"brought back", area_path, 2048, start, rows)
phase("report")
print("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_WALLS.items())
      + f"; total {time.perf_counter() - T_START:.1f} s")

# --- report ----------------------------------------------------------------


def band_launches(name):
    """Kernel ``name``'s launches in each band render of phase 16, by loop."""
    return {mode: [c[name] for c in info["launches"]] for mode, info in band_info.items()}


report = {
    "kernels": [dict(
        name="treelet_closest_hit", route="cuda",
        source="tpupt_torch/accel/csrc/treelet_kernels.cu",
        replaces="tpupt/accel/pallas_sweep.py:54",
        launches=launches["treelet_closest_hit"],
        max_abs_err=max(r["max_abs_err"] for r in (
            primary, secondary, closest_area, compacted, uncompacted, cli_compacted,
            cli_uncompacted, *cli_trips.values(), *harness_sweeps.values())),
        # the top-level times are the 1024^2 primaries'
        ms=primary["ms"], plain_ms=primary["plain_ms"], bound_ms=primary["bound_ms"],
        bound_by=primary["bound_by"], library_ms=None, visits=primary["work"]["visits"],
        cli_launches={k: v["launches"]["treelet_closest_hit"] for k, v in cli.items()},
        fit_step_launches=fit_per_step["treelet_closest_hit"],
        band_launches=band_launches("treelet_closest_hit"),
        harness_launches_per_call={k: v["launches_per_call"]["treelet_closest_hit"]
                                   for k, v in harness_info.items()},
        inputs={"primaries": primary, "secondaries": secondary,
                "cornell_area_bounce0": closest_area, "wavefront_compacted": compacted,
                "megakernel_bounce2": uncompacted, **cli_trips,
                "cli_wavefront_compacted": cli_compacted,
                "cli_megakernel_bounce2": cli_uncompacted,
                "ajax_white_hi_primaries": hi_sweep, **harness_sweeps},
    ), dict(
        # the same kernel's payload form (the JAX package's diff_payload
        # sweep, tpupt/accel/packets.py:845), launched by the fwd+bwd step
        name="treelet_closest_hit(payload=True)", route="cuda",
        source="tpupt_torch/accel/csrc/treelet_kernels.cu",
        replaces="tpupt/accel/pallas_sweep.py:54",
        launches=d_launches["treelet_closest_hit(payload=True)"],
        max_abs_err=max(pay_primary["max_abs_err"], pay_secondary["max_abs_err"],
                        pay_area["max_abs_err"]),
        ms=pay_primary["ms"], plain_ms=pay_primary["plain_ms"], bound_ms=pay_primary["bound_ms"],
        bound_by=pay_primary["bound_by"], library_ms=None,
        fit_step_launches=fit_per_step["treelet_closest_hit(payload=True)"],
        band_launches=band_launches("treelet_closest_hit(payload=True)"),
        inputs={"primaries": pay_primary, "secondaries": pay_secondary,
                "cornell_area_bounce0": pay_area},
    ), dict(
        # not Pallas in the JAX package (XLA intersect_treelets_anyhit); the
        # top-level times are the cornell_area bounce-0 shadow rays'; a call
        # is two launches (the warp and block routes), counted once
        name="treelet_any_hit", route="cuda",
        source="tpupt_torch/accel/csrc/treelet_kernels.cu",
        replaces="tpupt/accel/packets.py:961",
        launches=area_launches["treelet_any_hit"],
        max_abs_err=max(r["max_abs_err"] for r in (shadow_bunny, shadow_mixed, shadow_area, hi_any)),
        ms=shadow_area["ms"], plain_ms=shadow_area["plain_ms"], bound_ms=shadow_area["bound_ms"],
        bound_by=shadow_area["bound_by"], library_ms=None,
        cli_launches={k: v["launches"]["treelet_any_hit"] for k, v in cli.items()},
        fit_step_launches=fit_per_step["treelet_any_hit"],
        band_launches=band_launches("treelet_any_hit"),
        device_ms=shadow_area["device_ms"],
        inputs={"bunny_shadow": shadow_bunny, "bunny_mixed_shadow": shadow_mixed,
                "cornell_area_bounce0": shadow_area, "ajax_white_hi_shadow": hi_any},
    )] + [dict(
        # not Pallas in the JAX package: XLA fuses its trip body (the sphere
        # pass, the sweep's rows; the hit record, _bounce_body without NEE,
        # the fold and restart) into a few kernels inside the while_loop of
        # _render_chained (tpupt/render/integrator.py:1001) and trace_sample
        # (:804); the top-level times are bunny's trip 2, 1024^2 lanes
        name=name, route="cuda", source="tpupt_torch/accel/csrc/trip_kernels.cu",
        replaces=replaces, launches=launches[name],
        max_abs_err=max(c[name]["max_abs_err"] for c in trip_checks.values()),
        ms=trip_checks["bunny_trip2"][name]["ms"],
        device_ms=trip_checks["bunny_trip2"][name]["device_ms"],
        plain_ms=trip_checks["bunny_trip2"][name]["plain_ms"],
        bound_ms=trip_checks["bunny_trip2"][name]["bound_ms"],
        bound_by=trip_checks["bunny_trip2"][name]["bound_by"], library_ms=None,
        cli_launches={k: v["launches"][name] for k, v in cli.items()},
        fit_step_launches=fit_per_step[name], band_launches=band_launches(name),
        harness_launches_per_call={k: v["launches_per_call"][name]
                                   for k, v in harness_info.items()},
        inputs={k: dict(v[name], work=v["work"]) for k, v in trip_checks.items()},
        path_sums={k: v[name] for k, v in path_sums.items() if name in v},
    ) for name, replaces in (("trip_head", "tpupt/render/intersect.py:98"),
                             ("trip_tail", "tpupt/render/integrator.py:499"))] + [dict(
        # not Pallas in the JAX package: XLA fuses _bounce_body with NEE
        # (tpupt/render/integrator.py:499, its NEE part :570-600) into the
        # trip body; its main path is the Cornell renders of phase 10 (the
        # launches of the cornell_area render), the top-level times are
        # cornell_area's trip 2, 512^2 lanes; trip_tail's NEE mode is in
        # trip_tail's inputs above
        name="trip_nee", route="cuda", source="tpupt_torch/accel/csrc/trip_kernels.cu",
        replaces="tpupt/render/integrator.py:570", launches=area_launches["trip_nee"],
        cornell_launches=nee_fwd["cornell.json"]["launches"]["trip_nee"],
        max_abs_err=max(c["trip_nee"]["max_abs_err"] for c in trip_checks.values()
                        if "trip_nee" in c),
        **{k: trip_checks["cornell_area_trip2"]["trip_nee"][k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None,
        cli_launches={k: v["launches"]["trip_nee"] for k, v in cli.items()},
        fit_step_launches=fit_per_step["trip_nee"], band_launches=band_launches("trip_nee"),
        harness_launches_per_call={k: v["launches_per_call"]["trip_nee"]
                                   for k, v in harness_info.items()},
        inputs={k: dict(v["trip_nee"], work=v["work"]) for k, v in trip_checks.items()
                if "trip_nee" in v},
        path_sums={k: v["trip_nee"] for k, v in path_sums.items() if "trip_nee" in v},
    )] + [dict(
        # no TPU kernel: the JAX package runs every trip over every lane in
        # the while_loop of _render_chained (tpupt/render/integrator.py:1001);
        # its main path the tail of an emitter-free sphere render, phase 19's
        # three_balls render (its launches); the numbers are that render's
        # handover state's, held against trip_drain_plain from it
        name="trip_drain", route="cuda", source="tpupt_torch/accel/csrc/trip_kernels.cu",
        replaces="tpupt/render/integrator.py:1001", launches=tb_launches["trip_drain"],
        **{k: drain_check[k]
           for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None,
        cli_launches={k: v["launches"].get("trip_drain") for k, v in cli.items()},
        fit_step_launches=fit_per_step["trip_drain"], band_launches=band_launches("trip_drain"),
        harness_launches_per_call={k: v["launches_per_call"]["trip_drain"]
                                   for k, v in harness_info.items()},
        inputs={"three_balls_handover": drain_check},
    )] + [dict(
        # not Pallas in the JAX package: the differentiable trace_sample's
        # lax.scan over _bounce_body with refine_hit and its transpose
        # (tpupt/render/integrator.py:499, :804; tpupt/render/intersect.py:450),
        # compiled by XLA; main path the fwd+bwd step of phase 6 (its first
        # call's launches); the top-level numbers are bounce 0 of the bunny
        # step's first sample (1024^2 lanes, all live)
        name=name, route="cuda", source="tpupt_torch/accel/csrc/diff_trip_kernels.cu",
        replaces=replaces, launches=d_launches[name],
        max_abs_err=max(c[name]["max_abs_err"] for c in diff_checks.values()),
        **{k: diff_checks["bunny_step_bounce0"][name][k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        cornell_area_step_launches=a_launches[name],
        fit_step_launches=fit_per_step[name],
        harness_launches_per_call={k: v["launches_per_call"][name]
                                   for k, v in harness_info.items()},
        inputs={k: dict(v[name], work=v["work"]) for k, v in diff_checks.items()},
        path_sums={k: v[name] for k, v in path_sums.items() if name in v},
    ) for name, replaces in (("diff_trip_fwd", "tpupt/render/integrator.py:499"),
                             ("diff_trip_bwd", "tpupt/render/integrator.py:804"))] + [dict(
        # not Pallas in the JAX package: _fetch_tri_rows' backward scatter,
        # compiled by XLA; main path the body route's cornell_area fwd+bwd
        # step of phase 11 (its launches), whose call with the most triangle
        # lanes gives the top-level numbers; on the bunny step diff_trip_bwd
        # runs the same scatter itself (bunny_step_launches), and the kernel
        # is also held on the rows of that step's bounces (inputs)
        name="slot_scatter", route="cuda", source="tpupt_torch/accel/csrc/diff_trip_kernels.cu",
        replaces="tpupt/render/intersect.py:436", launches=a_launches["slot_scatter"],
        bunny_step_launches=d_launches["slot_scatter"],
        max_abs_err=max([r["max_abs_err"] for r in area_ss.values()]
                        + [c["slot_scatter"]["max_abs_err"] for c in diff_checks.values()]),
        **{k: area_ss_top[k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        fit_step_launches=fit_per_step["slot_scatter"],
        harness_launches_per_call={k: v["launches_per_call"]["slot_scatter"]
                                   for k, v in harness_info.items()},
        inputs={**area_ss, **{k: dict(v["slot_scatter"], work=v["work"])
                              for k, v in diff_checks.items()}},
    )],
    # not launched by the main path, which runs its MT-and-fold arithmetic
    # inside treelet_closest_hit
    "off_path": [dict(
        name="winner_step", route="cuda",
        source="tpupt_torch/accel/csrc/treelet_kernels.cu",
        replaces="tpupt/accel/pallas_step.py:64",
        launches=launches["winner_step"],
        max_abs_err=float((out_k[0] - out_p[0]).abs().max()), ms=ws_ms, plain_ms=ws_plain_ms,
        bound_ms=ws_bound_ms, bound_by=ws_bound_by, library_ms=None,
        fit_step_launches=fit_per_step["winner_step"], band_launches=band_launches("winner_step"),
        rcp_declined_exponents=rcp_declined,
    )],
    "render": dict(rays=rays, wall_s=wall, walls_s=walls, mrays_per_s=rays / wall / 1e6,
                   first_call_s=first_s, profiled_device_busy_ms=busy_ms,
                   profiled_sweep_ms=sweep_ms, routes_in_turns=route_info),
    "fwd_bwd": dict(rays=d_rays, wall_s=d_wall, walls_s=d_walls, mrays_per_s=d_rays / d_wall / 1e6,
                    forward_backward_s=d_split,
                    first_call_s=d_first_s, peak_bytes=d_peak, launches=d_launches,
                    profiled_device_busy_ms=d_busy_ms, profiled_sweep_ms=d_sweep_ms,
                    profiled_index_add_ms=d_index_add_ms, grad_parity_gap=grad_gap,
                    profiled_kernels=d_kernels, routes_in_turns=route_steps,
                    routes_profiled=route_prof,
                    denoise_step_wall_s=dn_wall, denoise_fwd_bwd_ms=dn_ms),
    "nee_render": nee_fwd,
    "nee_fwd_bwd": dict(scene="cornell_area.json", rays=a_rays, wall_s=a_wall, walls_s=a_walls,
                        mrays_per_s=a_rays / a_wall / 1e6, forward_backward_s=a_split,
                        first_call_s=a_first_s, peak_bytes=a_peak, launches=a_launches,
                        profiled_device_busy_ms=a_busy_ms, grad_parity_gap=a_gap,
                        profiled_slot_scatter_ms=a_slot_ms,
                        profiled_index_add_ms=a_index_add_ms),
    "path_tracer": dict(rays=pt_rays, wall_s=pt_wall, launches=pt_launches,
                        chunk_max_abs_gap=chunk_gap, per_sample_walls_s=mode_walls,
                        preview_s=previews, denoise_s=dn_s),
    "cli": cli,
    "viewer": dict(idle_frames=frames, moving_frame_s=move_s),
    "fit": dict(size=SIZE, steps=FIT_STEPS, losses=fit_losses, step_walls_s=fit_walls,
                median_step_s=fit_wall, peak_bytes=fit_peak, launches=fit_launches,
                profiled_device_busy_ms=fit_busy_ms, profiled_kernels=fit_kernels,
                denoise_fwd_bwd_device_ms=fit_dn_ms, twin_grad_gap=fit_gap,
                geometry_losses=geo_losses),
    "bands": band_info,
    "sharding": dict(nccl_one_rank=nccl_info, render_sharded_wall_s=sh_wall,
                     gloo_two_ranks=two_info),
    "oracles": dict(oracle_info, render_image_ref_gap=ref_gap,
                    cornell_area_render_image_ref_gap=area_ref_gap,
                    ajax_white_hi=dict(treelets=K_hi, smem_bytes=hi_smem, build_s=hi_build_s)),
    "harness": harness_info,
    "scaling": scaling_line,
    "lit_mesh_vs_reference": lit_checks,
    "phase_walls_s": PHASE_WALLS,
}
with open(os.path.join(OUT, "chip_smoke.json"), "w") as fh:
    config = dict(scene="bunny.json", size=SIZE, spp=SPP, max_bounces=MAX_BOUNCES, rr_start=RR,
                  fwd_bwd=dict(spp=DIFF_SPP, max_bounces=DIFF_BOUNCES, loss="sum(color^2)"))
    json.dump(dict(report, card=smi, config=config), fh, indent=1)
print()
print(smi)
print(json.dumps(report))
print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}}))
