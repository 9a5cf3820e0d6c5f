"""The differentiable trip's backward of the shipped kernel library against
the library built from another checkout's sources, on one NVIDIA GPU.

    python experiments/torch_diff_bwd.py --compare-root DIR [--bounces 0,1,2,last]
                                         [--reps 50] [--steps 4] [--variants lb3,t128,...]
                                         [--gap-runs 5] [--route-iterations 0,1,2]

``--compare-root`` is a checkout (e.g. a ``git archive`` of an earlier tree
under ``build/``) whose ``tpupt_torch/accel/csrc`` is built with the
library's own flags (``torch_variant.py``) and called by its own C
interface: a ``diff_trip_bwd`` that writes the winner rows' cotangents
into a (9, N) buffer, then ``slot_scatter`` of that buffer into the slot
table's gradient (two launches a bounce), where the shipped kernel scatters
them itself (one launch).  ``--variants`` adds libraries built from the
shipped sources with the substitutions of ``VARIANTS`` (a choice each:
launch bounds, CTA size, chunk size) or of ``DIAGNOSTIC`` (a part of the work dropped, to see where
the time goes: timed, not compared).

The script takes the fwd+bwd step of chip_smoke.py's phase 6 (bunny.json
1024^2, 4 spp, 8 bounces, no roulette, loss sum(color^2), gradients to
every leaf) and keeps the backward's inputs of the first sample's bounces
named.  On each kept bounce every library's backward runs on the same
inputs and must agree with the shipped one (each row of G, the leaf
table and the slot table's gradient at rtol 1e-5, floor 1e-5 x the max:
atomic sums in no fixed order, the shipped VJP's quotients within 2 ulp);
each library's backward, and each library's standalone
``slot_scatter`` on the bounce's slots and winner rows, is timed on the
device (torch.profiler over ``--reps`` calls, the kernels' time summed)
in turns: shipped, other, ..., ..., other, shipped.  Then ``--steps``
steps, alternating the shipped library and the other, each under
torch.profiler, sum each kernel's device time over the step.

The margins of the 1e-5 gates (``--gap-runs``, ``--route-iterations``;
the atomic sums come in no fixed order, so a gate's margin is a spread,
not one number): on each kept bounce every library's backward ``--gap-runs``
times against the twin's VJP (``diff_trip_bwd_plain``), each run's use of
chip_smoke.py's phase 6 gate, the largest |kernel - twin| / (1e-5 x (the
row's, leaf's or column's max + |twin|)), 1 at the gate; and for each
start iteration of ``--route-iterations`` the whole step's gradients on
the body route (twice) and on the differentiable trip by each library
(twice), each run's largest |grad - body route's first| over 1e-5 x the
leaf's max |grad| (phase 6's route gate, 1 at the gate).  The variants
``ieee_div``, ``double_sums`` and ``exact`` (both) undo the VJP's
``__fdividef`` and the warp leaf sums in float, to show what they cost
in margin and in time.

Prints the card's name and power limit and each library's register
report for the two kernels; the last line of standard output is one JSON
object.
"""

import argparse
import contextlib
import ctypes
import functools
import json
import os
import re
import subprocess
import sys

import torch

import torch_variant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpupt_torch import extract_params, render_image, with_params  # noqa: E402
from tpupt_torch.accel import kernels  # noqa: E402
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES  # noqa: E402
from tpupt_torch.render import diff_trip, trip_kernel  # noqa: E402
from tpupt_torch.render.intersect import intersect_scene_ids_diff  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

SIZE, SPP, MAX_BOUNCES = 1024, 4, 8
KERNELS = ("diff_trip_bwd_kernel", "slot_scatter_kernel")
# the VJP's quotients correctly rounded, and the warp leaf sums in double
_IEEE_DIV = ("// a bounce's float residuals (diff_trip.RES_F_KEYS)",
             "#define __fdividef(a, b) __fdiv_rn(a, b)\n// a bounce's float residuals "
             "(diff_trip.RES_F_KEYS)")
_DOUBLE_SUMS = ("    float acc[W];\n    for (int j = 0; j < W; ++j) acc[j] = mine ? v[j] : 0.0f;",
                "    double acc[W];\n    for (int j = 0; j < W; ++j) acc[j] = mine ? (double)v[j] : 0.0;")
# design choices of the shipped backward, one substitution each
VARIANTS = {
    "ieee_div": [_IEEE_DIV],
    "double_sums": [_DOUBLE_SUMS],
    "exact": [_IEEE_DIV, _DOUBLE_SUMS],
    "lb3": [("__launch_bounds__(kBwdThreads, 2) diff_trip_bwd_kernel",
             "__launch_bounds__(kBwdThreads, 3) diff_trip_bwd_kernel")],
    "t128": [("constexpr int kBwdThreads = kThreads;", "constexpr int kBwdThreads = 128;")],
    "chunk1024": [("constexpr int kChunk = 2048;", "constexpr int kChunk = 1024;")],
    "chunk4096": [("constexpr int kChunk = 2048;", "constexpr int kChunk = 4096;")],
}
# where the time goes: each drops a part of the work (their results are
# wrong, so they are timed and not compared): one case's lanes alone, no
# leaf sums, no slot table scatter
_RUN = "case_warp(a, sm, c, j >= 0 ? lane0"
DIAGNOSTIC = {
    "only_miss": [(_RUN, "case_warp(a, sm, c, j >= 0 && c == C_MISS ? lane0")],
    "only_sphere": [(_RUN, "case_warp(a, sm, c, j >= 0 && c == C_SPHERE ? lane0")],
    "only_tri": [(_RUN, "case_warp(a, sm, c, j >= 0 && c == C_TRI ? lane0")],
    "no_sums": [("  unsigned todo = __ballot_sync(kFull, key >= 0);", "  unsigned todo = 0u;")],
    "no_scatter": [("    if (a.g_slot != nullptr) scatter_row(a.g_slot, slot, tv);\n", "")],
    # the scatter's atomics as plain stores (both kernels)
    "scatter_stores": [("    for (int k = 0; k < 9; ++k) atomicAdd(&g[(size_t)s * 9 + k], acc[k]);",
                        "    for (int k = 0; k < 9; ++k) g[(size_t)s * 9 + k] = acc[k];")],
}


@contextlib.contextmanager
def using(lib):
    """Every kernel wrapper launches from ``lib`` inside the block."""
    load = kernels.load
    kernels.load = lambda: lib
    try:
        yield
    finally:
        kernels.load = load


def register_report(log_path):
    """ptxas's lines for the two kernels of a library's build log."""
    out, keep = [], False
    with open(log_path) as fh:
        for ln in fh:
            if "Compiling entry function" in ln:
                keep = any(k in ln for k in KERNELS)
            if keep and ("registers" in ln or "spill" in ln or "Compiling" in ln):
                out.append(re.sub(r"\s+", " ", ln.strip()))
    return out


def fused_bwd(dp, G, res, seed, b, gtab, g_slot):
    """The shipped design: one launch (the wrapper of the library in use)."""
    return diff_trip.diff_trip_bwd(dp, G, res, seed, b, gtab, g_slot)


def split_bwd(lib):
    """The other design by its own C interface: diff_trip_bwd's winner
    rows into a (9, N) buffer, then slot_scatter of it."""
    def bwd(dp, G, res, seed, b, gtab, g_slot=None):
        plan, n = dp.trip, dp.trip.n
        tabs = plan.tables
        rr = trip_kernel._NO_RR if plan.rr_start is None else int(plan.rr_start)
        stream = kernels.stream_of(G)
        tricot = None if g_slot is None else torch.empty((9, n), device=G.device)
        err = lib.tpupt_diff_trip_bwd(
            G.data_ptr(), n, res.f.data_ptr(), res.i.data_ptr(), seed.data_ptr(),
            None if dp.table is None else dp.table.data_ptr(), tabs.table.data_ptr(), tabs.n_sph,
            plan.scene.materials.albedo.shape[0], tabs.mat_off, tabs.obj_off, tabs.bg_off, b, rr,
            gtab.data_ptr(), None if tricot is None else tricot.data_ptr(), stream)
        kernels.check(lib, err, "diff_trip_bwd (other)")
        if g_slot is not None:
            scatter(lib, g_slot, res.i[1], tricot.t())
        return G
    return bwd


def scatter(lib, g, slot, cot):
    """slot_scatter of ``lib`` (the same C interface in both designs)."""
    err = lib.tpupt_slot_scatter(g.data_ptr(), g.shape[0], slot.data_ptr(), cot.data_ptr(),
                                 slot.shape[0], cot.stride(0), cot.stride(1),
                                 kernels.stream_of(g))
    kernels.check(lib, err, "slot_scatter")


FALLBACKS = []  # the timings the profiler did not record, by what was timed


def device_ms(fn, reps, what=""):
    """Mean device milliseconds per call of ``fn`` of the two kernels: the
    profiler's sum over ``reps`` calls; where it records no device time
    (it can stop recording in a long process), CUDA events around each
    call issued behind a ~1 ms spin kernel, so that they time the device
    and not the host's issue (noted in ``FALLBACKS``)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if any(k in e.key for k in KERNELS))
    if total > 0:
        return total / 1e3 / reps
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    FALLBACKS.append(what)
    print(f"  the profiler recorded no device time for {what} (its keys: "
          f"{[e.key[:60] for e in prof.key_averages()][:6]}): CUDA events", flush=True)
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def gate_use(got, want):
    """Phase 6's gate on (G, leaf table split by leaf, g_slot) against the
    twin's: the largest |a - c| / (1e-5 x (max |c| + |c|)) over the rows of
    G, the leaves and the slot table's columns; at most 1 passes."""
    (Gk, lk, sk), (Gp, lp, sp) = got, want
    use = 0.0
    for a, c in [*zip(Gk, Gp), *((lk[k], lp[k]) for k in lp), *zip(sk.t(), sp.t())]:
        if c.numel():
            tol = 1e-5 * (float(c.abs().max()) + c.abs())
            use = max(use, float(((a - c).abs() / tol.clamp(min=1e-30)).max()))
    return use


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare-root", required=True)
    ap.add_argument("--bounces", default="0,1,2,last")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--variants", default="")
    ap.add_argument("--gap-runs", type=int, default=0)
    ap.add_argument("--route-iterations", default="")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    other_path = torch_variant.build(kernels, [], csrc=os.path.join(
        os.path.abspath(args.compare_root), "tpupt_torch", "accel", "csrc"))
    other = kernels.bind(other_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    other.tpupt_diff_trip_bwd.argtypes = [P, I] + [P] * 5 + [I] * 7 + [P] * 3
    libs = {"shipped": (kernels.load(), kernels.library_path()),
            "other": (other, other_path)}
    for v in filter(None, args.variants.split(",")):
        path = torch_variant.build(kernels, {**VARIANTS, **DIAGNOSTIC}[v])
        libs[v] = (kernels.bind(path), path)
    for name, (_, path) in libs.items():
        print(f"{name}: " + "; ".join(register_report(path + ".log")))

    ensure_models(names=["bunny.obj"])
    desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
    scene = desc.build(leaf_size=32, device="cuda")
    leaves = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)

    def step(start_iteration=0, intersect_fn=None):
        params = extract_params(scene)
        buf, _ = render_image(with_params(scene, params), desc.camera, SIZE, SIZE, spp=SPP,
                              max_bounces=MAX_BOUNCES, differentiable=True,
                              start_iteration=start_iteration, intersect_fn=intersect_fn)
        wrt = [params["materials"][k[10:]] if k.startswith("materials.") else params[k]
               for k in leaves]
        return torch.autograd.grad((buf.color ** 2).sum(), wrt, allow_unused=True,
                                   materialize_grads=True)

    kept, first, bwd = {}, [], diff_trip.diff_trip_bwd

    def recording(dp, G, res, seed, b, gtab, g_slot=None):
        if not first:
            first.append(dp)
        if dp is first[0]:
            kept[b] = (G.clone(), res, seed)
        return bwd(dp, G, res, seed, b, gtab, g_slot)

    diff_trip.diff_trip_bwd = recording
    try:
        step()
    finally:
        diff_trip.diff_trip_bwd = bwd
    dp = first[0]
    last = max(kept)
    want = {last if b == "last" else int(b) for b in args.bounces.split(",") if b}
    print(f"bunny.json {SIZE}^2, {SPP} spp, {MAX_BOUNCES} bounces: sample 0 has bounces "
          f"0-{last}; kept {sorted(want)}", flush=True)

    order = list(libs) + list(libs)[::-1]
    per_bounce = {}
    for b in sorted(want):
        G0, res, seed = kept[b]
        code = res.i[0]
        live = int((code != diff_trip.DEAD).sum())
        hits, tri = int((code >= 0).sum()), int(((code >= 0) & (code % 2 == 1)).sum())
        runs, outs = {}, {}
        for name, (lib, _) in libs.items():
            fn = split_bwd(lib) if name == "other" else fused_bwd
            G, gtab, g_slot = G0.clone(), diff_trip.leaf_table_zeros(dp.trip), \
                torch.zeros_like(dp.table)
            with using(lib):
                fn(dp, G, res, seed, b, gtab, g_slot)
            torch.cuda.synchronize()
            outs[name] = (G, gtab, g_slot)
            runs[name] = (fn, G, gtab, g_slot)
        G, gtab, g_slot = outs["shipped"]
        for name, (Gx, gtx, gsx) in outs.items():
            if name in DIAGNOSTIC:
                continue
            for a, c in (*zip(Gx, G), (gtx, gtab), (gsx, g_slot)):
                assert torch.allclose(a, c, rtol=1e-5, atol=1e-5 * float(c.abs().max())), \
                    f"bounce {b}: {name}'s cotangents differ from the shipped"
        # the standalone slot_scatter on the bounce's slots and winner rows
        # (the other library's (9, N) buffer, as its step hands them)
        tricot = torch.zeros((9, dp.trip.n), device="cuda")
        lib_o = libs["other"][0]
        err = lib_o.tpupt_diff_trip_bwd(
            G0.clone().data_ptr(), dp.trip.n, res.f.data_ptr(), res.i.data_ptr(), seed.data_ptr(),
            dp.table.data_ptr(), dp.trip.tables.table.data_ptr(), dp.trip.tables.n_sph,
            dp.trip.scene.materials.albedo.shape[0], dp.trip.tables.mat_off,
            dp.trip.tables.obj_off, dp.trip.tables.bg_off, b, trip_kernel._NO_RR,
            diff_trip.leaf_table_zeros(dp.trip).data_ptr(), tricot.data_ptr(),
            kernels.stream_of(tricot))
        kernels.check(lib_o, int(err), "diff_trip_bwd (other)")
        slot, cot = res.i[1], tricot.t()
        g_s = {name: torch.zeros_like(dp.table) for name in libs}
        for name, (lib, _) in libs.items():
            scatter(lib, g_s[name], slot, cot)
        torch.cuda.synchronize()
        for name in libs:
            if name in DIAGNOSTIC:
                continue
            scale = float(g_s["shipped"].abs().max())
            assert torch.allclose(g_s[name], g_s["shipped"], rtol=1e-5, atol=1e-5 * scale), name
        ms = {name: [] for name in libs}
        ss_ms = {name: [] for name in libs}
        for name in order:
            lib = libs[name][0]
            fn, Gx, gtx, gsx = runs[name]
            with using(lib):
                ms[name].append(device_ms(lambda: fn(dp, Gx, res, seed, b, gtx, gsx), args.reps,
                                          f"bounce {b} backward, {name}"))
            ss_ms[name].append(device_ms(lambda: scatter(lib, g_s[name], slot, cot), args.reps,
                                         f"bounce {b} slot_scatter, {name}"))
        # each library's use of phase 6's gate against the twin, run after run
        gate = {}
        if args.gap_runs:
            G, gtab, g_slot = G0.clone(), diff_trip.leaf_table_zeros(dp.trip), \
                torch.zeros_like(dp.table)
            diff_trip.diff_trip_bwd_plain(dp, G, res, seed, b, gtab, g_slot)
            want = (G, diff_trip.split_leaf_table(dp.trip, gtab), g_slot)
            for name, (lib, _) in libs.items():
                if name in DIAGNOSTIC:
                    continue
                fn, gate[name] = runs[name][0], []
                for _ in range(args.gap_runs):
                    G, gtab, g_slot = G0.clone(), diff_trip.leaf_table_zeros(dp.trip), \
                        torch.zeros_like(dp.table)
                    with using(lib):
                        fn(dp, G, res, seed, b, gtab, g_slot)
                    gate[name].append(gate_use(
                        (G, diff_trip.split_leaf_table(dp.trip, gtab), g_slot), want))
            print(f"bounce {b}: use of the 1e-5 gate against the twin over {args.gap_runs} runs: "
                  + "; ".join(f"{k} {min(v):.3f}-{max(v):.3f}" for k, v in gate.items()),
                  flush=True)
            del want
        per_bounce[b] = dict(lanes=dp.trip.n, live=live, hits=hits, triangle_hits=tri,
                             bwd_ms=ms, slot_scatter_ms=ss_ms, gate_use=gate)
        print(f"bounce {b}: {live} of {dp.trip.n} lanes live, {hits} hits, {tri} on triangles; "
              f"the backward on the device (other: diff_trip_bwd + slot_scatter): "
              + "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)}" for k, v in ms.items())
              + " ms; slot_scatter alone: "
              + "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)}" for k, v in ss_ms.items())
              + f" ms  [{card}]", flush=True)
        del runs, outs, G0, g_s, tricot
    kept.clear()

    steps = []
    for k in range(args.steps):
        name = ("shipped", "other", "other", "shipped")[k % 4]
        lib = libs[name][0]
        with using(lib):
            diff_trip.diff_trip_bwd = split_bwd(lib) if name == "other" else bwd
            try:
                step()  # warm-up of this library's kernels
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    step()
                    torch.cuda.synchronize()
            finally:
                diff_trip.diff_trip_bwd = bwd
        kern = [e for e in prof.key_averages() if e.self_device_time_total > 0]

        def dev(key):
            hits = [e for e in kern if key in e.key]
            return dict(ms=sum(e.self_device_time_total for e in hits) / 1e3,
                        launches=sum(e.count for e in hits))

        r = dict(library=name, busy_ms=sum(e.self_device_time_total for e in kern) / 1e3,
                 kernels=sum(e.count for e in kern), **{k: dev(k) for k in KERNELS})
        steps.append(r)
        print(f"step by {name}: device busy {r['busy_ms']:.2f} ms in {r['kernels']} kernels; "
              f"diff_trip_bwd {r['diff_trip_bwd_kernel']['ms']:.3f} ms in "
              f"{r['diff_trip_bwd_kernel']['launches']}, slot_scatter "
              f"{r['slot_scatter_kernel']['ms']:.3f} ms in "
              f"{r['slot_scatter_kernel']['launches']}  [{card}]", flush=True)
    # phase 6's route gate: each run's largest gradient gap to the body
    # route's first run, over 1e-5 x the leaf's max |grad|
    body = functools.partial(intersect_scene_ids_diff)  # wrapped: the body route
    routes = {}
    for it in (int(x) for x in filter(None, args.route_iterations.split(","))):
        ref = step(it, body)
        uses = {"body": [0.0]}
        pairs = [("body", None)] + [(n, lib) for n, (lib, _) in libs.items()
                                    if n not in DIAGNOSTIC and n != "other"]
        for name, lib in pairs * 2:
            if name == "body" and len(uses["body"]) == 2:
                continue
            with using(lib or kernels.load()):
                got = step(it, body if name == "body" else None)
            uses.setdefault(name, []).append(max(
                float((a - c).abs().max()) / (1e-5 * float(c.abs().max()))
                for a, c in zip(got, ref) if float(c.abs().max()) > 0))
        routes[it] = uses
        print(f"start iteration {it}: use of the 1e-5 route gate (gap to the body route's "
              f"first run): " + "; ".join(f"{k} {', '.join(f'{x:.3f}' for x in v)}"
                                          for k, v in uses.items()) + f"  [{card}]", flush=True)
    print(json.dumps(dict(card=card, compare_root=args.compare_root,
                          registers={k: register_report(p + ".log") for k, (_, p) in libs.items()},
                          bounces=per_bounce, steps=steps, route_gate_use=routes,
                          timed_by_events=FALLBACKS)))


if __name__ == "__main__":
    main()
