"""trip_head of the shipped kernel library against the libraries built from
other checkouts' sources, in turns, on one NVIDIA GPU.

    python experiments/torch_trip_head.py --compare-root DIR[,DIR...] [--variants no_stage,...]
                                          [--trips 0,2,93] [--reps 50] [--renders 2]

``--compare-root`` names checkouts (e.g. a ``git archive`` of an earlier
tree under ``build/``), each labelled by its directory's name, whose
``tpupt_torch/accel/csrc`` is built with the library's own flags
(``torch_variant.py``); their ``tpupt_trip_head`` has the same C
interface, so the shipped wrapper calls any of the libraries.
``--variants`` adds libraries built from the shipped sources with the
substitutions of ``VARIANTS`` (a design choice each: no staged sphere
rows, the lanes a thread (and so a CTA) takes, launch bounds).

The inputs: bunny.json as chip_smoke.py's phase 4 renders it (1024^2, 16
spp, 50 bounces, RR 8), its trips ``--trips`` (93: the last, one live
lane); and phase 10's lit scenes at 512^2, 4 bounces, RR 2 (cornell.json
at 4 spp, cornell_area.json at 16, ``tests/test_torch_trip_nee.py``'s
sixteen lamps and emissive icosphere at 2), their trips 0, 2 and the
last.  On each kept trip every library's trip_head must equal the twin
``trip_head_plain`` in every output (from the buffers the render's head
found), and each is timed on the device (torch.profiler over ``--reps``
calls, the kernel's time summed) in turns: shipped, others...,
variants..., variants..., others..., shipped.  Each trip's bytes and byte
bound are counted as ``chip_smoke.trip_work`` counts them.  Then
``--renders`` renders of bunny.json, cornell.json and cornell_area.json
by each library in turns (shipped, others..., variants..., and back), each
under torch.profiler: trip_head's device ms summed over the render, its
launches, the render's busy time.

Prints the card's name, power limit and SM clocks and each library's
registers and spill for trip_head_kernel.  The last line of standard
output is one JSON object; the same goes to
``chiprun_out/torch_trip_head.json``.
"""

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import subprocess
import sys

import torch

import torch_variant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_trip_nee import _port_scene  # noqa: E402
from tpupt_torch import render_image  # noqa: E402
from tpupt_torch.accel import kernels  # noqa: E402
from tpupt_torch.render import trip_kernel  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

KERNEL = "trip_head_kernel"
HEAD_OUT = ("hrec", "hint", "rows", "act_p")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 HBM3 peak memory rate
# (settings, scenes): bunny.json's forward main path and phase 10's lit renders
BUNNY = dict(size=1024, spp=16, max_bounces=50, rr_start=8)
LIT = {"cornell.json": 4, "cornell_area.json": 16, "many16": 2, "ico_light": 2}
LIT_KW = dict(size=512, max_bounces=4, rr_start=2)

_BOUNDS = "__launch_bounds__(kThreads) trip_head_kernel"
_PER = "constexpr int kHeadPer = 2;"
VARIANTS = {
    # the sphere rows read from device memory, not staged
    "no_stage": [("    const int n_stage = n_sph > 1 && sph <= kStageMax ? sph : 0;",
                  "    const int n_stage = 0;")],
    # the sphere rows staged whatever their count
    "stage_one": [("    const int n_stage = n_sph > 1 && sph <= kStageMax ? sph : 0;",
                   "    const int n_stage = sph <= kStageMax ? sph : 0;")],
    # CTAs of 256 lanes (one a thread) and of 1,024 (four)
    "per1": [(_PER, _PER.replace("2", "1"))],
    "per4": [(_PER, _PER.replace("2", "4"))],
    "lb4": [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 4)"))],
    "lb5": [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 5)"))],
    "lb6": [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 6)"))],
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
    """ptxas's lines for trip_head_kernel in a library's build log."""
    out, keep = [], False
    with open(log_path) as fh:
        for ln in fh:
            if "Compiling entry function" in ln:
                keep = KERNEL in ln
            if keep and ("registers" in ln or "spill" in ln or "stack frame" in ln):
                out.append(re.sub(r"\s+", " ", ln.strip()))
    return out


def device_ms(fn, reps):
    """Mean device milliseconds of trip_head_kernel per call of ``fn``;
    None where the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if KERNEL in e.key)
    return total / 1e3 / reps if total > 0 else None


def record(render, keep):
    """``render()`` with trip_head's inputs on the trips ``keep`` (a set,
    "last" allowed) kept: the render's trips, {trip: (plan, F, I, buffers
    before)}.  Renders twice where "last" is asked for."""
    kept, count, head = {}, [0], trip_kernel.trip_head

    def rec(plan, F, I, buf):
        if count[0] in want:
            kept[count[0]] = (plan, F.clone(), I.clone(),
                              {k: None if getattr(buf, k) is None else getattr(buf, k).clone()
                               for k in HEAD_OUT})
        count[0] += 1
        return head(plan, F, I, buf)

    want = {t for t in keep if t != "last"}
    trip_kernel.trip_head = rec
    try:
        render()
        trips = count[0]
        if "last" in keep:
            want.add(trips - 1)
            kept.clear()
            count[0] = 0
            render()
    finally:
        trip_kernel.trip_head = head
    return trips, kept


def run(plan, F, I, before, fn):
    buf = trip_kernel.trip_buffers(plan)
    for k in HEAD_OUT:
        if getattr(buf, k) is not None:
            getattr(buf, k).copy_(before[k])
    fn(plan, F, I, buf)
    return buf


def work(plan, I):
    """The trip's live lanes and bytes as chip_smoke.trip_work counts them
    (each input read once, each output written once)."""
    live = int((I[trip_kernel.I_KEYS.index("alive")] != 0).sum())
    nbytes = plan.n * 4 + live * (7 * 4 + 8 * 4)
    if plan.mesh:
        nbytes += plan.n_pad * 5 + (live + plan.n_pad - plan.n) * 7 * 4
    return dict(lanes=plan.n, live=live, n_sph=plan.tables.n_sph, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare-root", required=True)
    ap.add_argument("--variants", default="")
    ap.add_argument("--trips", default="0,2,93")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--renders", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card (name, power limit, SM clock, max SM clock): {smi}", flush=True)
    roots = {os.path.basename(os.path.normpath(r)): os.path.join(
        os.path.abspath(r), "tpupt_torch", "accel", "csrc") for r in args.compare_root.split(",")}
    builds = {"shipped": ([], None), **{name: ([], csrc) for name, csrc in roots.items()}}
    for v in filter(None, args.variants.split(",")):
        builds[v] = (VARIANTS[v], None)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(torch_variant.build, kernels, subs, csrc=csrc)
                for name, (subs, csrc) in builds.items()}
        paths = {name: f.result() for name, f in futs.items()}
    libs = {name: kernels.bind(p) for name, p in paths.items()}
    registers = {name: register_report(p + ".log") for name, p in paths.items()}
    for name, lines in registers.items():
        print(f"{name}: " + "; ".join(lines), flush=True)
    order = list(libs) + list(libs)[::-1]

    ensure_models(names=["bunny.obj", "quad.obj"])
    scenes_dir = os.path.join(locate_asset_path(), "scenes")
    desc = scene_from_json(os.path.join(scenes_dir, "bunny.json"))
    renders = {"bunny": (desc.build(leaf_size=32, device="cuda"), desc.camera, BUNNY)}
    for name, spp in LIT.items():
        scene, cam = _port_scene(name, scenes_dir, device="cuda")
        renders[name.removesuffix(".json")] = (scene, cam, dict(LIT_KW, spp=spp))
    keeps = {"bunny": {int(t) for t in args.trips.split(",")}}
    report = dict(card=smi, registers=registers, trips={}, renders={})
    for label, (scene, cam, kw) in renders.items():
        kw = dict(kw)
        size = kw.pop("size")

        def render(scene=scene, cam=cam, size=size, kw=kw):
            return render_image(scene, cam, size, size, **kw)

        trips, kept = record(render, keeps.get(label, {0, 2, "last"}))
        for t, (plan, F, I, before) in sorted(kept.items()):
            key = f"{label}_trip{t}"
            twin = run(plan, F, I, before, trip_kernel.trip_head_plain)
            for lib_name, lib in libs.items():
                with using(lib):
                    got = run(plan, F, I, before, trip_kernel.trip_head)
                torch.cuda.synchronize()
                for k in HEAD_OUT:
                    a, b = getattr(got, k), getattr(twin, k)
                    assert (a is None and b is None) or torch.equal(a, b), \
                        f"{key}: {lib_name}'s trip_head differs from the twin in {k}"
            w = work(plan, I)
            ms = {lib_name: [] for lib_name in libs}
            buf = run(plan, F, I, before, trip_kernel.trip_head_plain)
            for lib_name in order:
                with using(libs[lib_name]):
                    ms[lib_name].append(device_ms(
                        lambda: trip_kernel.trip_head(plan, F, I, buf), args.reps))
            report["trips"][key] = dict(work=w, device_ms=ms, trips=trips)
            print(f"{key} ({w['live']} of {w['lanes']} live, {w['n_sph']} spheres; "
                  f"{w['bytes'] / 1e6:.1f} MB, bound {w['bound_ms']:.4f} ms): "
                  + ", ".join(f"{k} " + "/".join("n/a" if x is None else f"{x:.4f}" for x in v)
                              for k, v in ms.items()) + f"  [{smi}]", flush=True)
        del kept

    # whole renders by each library in turns
    named = list(libs)
    for label in ("bunny", "cornell", "cornell_area"):
        scene, cam, kw = renders[label]
        kw = dict(kw)
        size = kw.pop("size")
        for lib_name in (named + named[::-1]) * args.renders:
            with using(libs[lib_name]):
                render_image(scene, cam, size, size, **kw)
                torch.cuda.synchronize()
                n0 = trip_kernel.LAUNCHES["trip_head"]
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    render_image(scene, cam, size, size, **kw)
                    torch.cuda.synchronize()
            kav = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            rec = report["renders"].setdefault(label, {}).setdefault(lib_name, [])
            rec.append(dict(trip_head_ms=sum(e.self_device_time_total for e in kav
                                             if KERNEL in e.key) / 1e3,
                            busy_ms=sum(e.self_device_time_total for e in kav) / 1e3,
                            launches=trip_kernel.LAUNCHES["trip_head"] - n0))
            print(f"{label} render, {lib_name}: {rec[-1]}  [{smi}]", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_trip_head.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
