"""The tail handover (``trip_kernel.trip_drain``) on the card: its build,
its wave, its bits against the issued trips, the live-lane curve of a
three_balls render, and the render's wall with and without the handover.

    python experiments/torch_trip_drain.py [--phases regs,check,curve,time,whole] [--reps 2]
        [--parent DIR] [--out chiprun_out/trip_drain.json]

three_balls is the benchmark's configuration
(``h100bench/configs/three_balls.json``: four spheres, no emitter, no
mesh), built through the program's JSON path.  "Issued" below is the trip
loop run to the end, the wave forced to 0 (``trip_kernel.drain_wave``).

  regs   nvcc's registers and spills of the trip kernels: this tree's
         library log and, with ``--parent``, that tree's trip_kernels.cu
         compiled alone with the same flags
  check  512^2 at 64 spp and 256^2 at 4 spp, 50 bounces, chained; 256^2
         per sample; 256^2 chained with roulette from bounce 4: the render
         with the handover against the issued one, colour, normal, depth
         and segments bit-equal, with each drain's handover trip, lanes and
         the count it left; the 256^2, 4-spp render timed both ways (CUDA
         events over 10 renders)
  curve  the lanes still to trace after each trip of a 3840x2160,
         200-spp, 50-bounce render, issued to the end
  time   that render with the handover and issued, in turns: the wall
         (ending in a synchronize), issued trips, the handover trip and
         lanes, the drain's device ms (CUDA events around its call); the
         first pair's outputs compared bit for bit
  whole  that render drained from trip 0, with no issued trip, two ways,
         in turns with the handover: ``trip_drain`` over a list of every
         lane (one lane a thread, 8.3 M threads: the card's block
         scheduler hands out the CTAs), and ``experiments/trip_drain_all.cu``
         (one resident wave that takes the listed lanes from a counter, a
         thread taking the next as soon as its lane ends); the wall, the
         drain's device ms and the outputs against the handover's

Prints a summary and writes every number to ``--out``.
"""

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100bench import run as hrun  # noqa: E402
from tpupt_torch import render_image  # noqa: E402
from tpupt_torch.accel import kernels  # noqa: E402
from tpupt_torch.render import trip_kernel as tk  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

KEYS = ("color", "normal", "depth")


def three_balls(dev):
    config = hrun.load_json(hrun.HERE, "configs", "three_balls.json")
    desc = scene_from_json(hrun.prepare(ROOT, config))
    return desc.build(leaf_size=config["leaf_size"], device=dev), desc.camera


@contextlib.contextmanager
def patched(**fns):
    old = {k: getattr(tk, k) for k in fns}
    vars(tk).update(fns)
    try:
        yield
    finally:
        vars(tk).update(old)


def issued():
    """The trip loop run to the end: no list, so no handover."""
    return patched(drain_wave=lambda plan: 0)


def logged(log):
    """trip_drain and trip_tail with each call recorded in ``log``: a
    drain's handover trip, lanes, device ms and the count it left; the
    issued trips' count."""
    drain, tail = tk.trip_drain, tk.trip_tail
    log.setdefault("drains", [])
    log.setdefault("tails", 0)

    def rec_drain(plan, F, I, buf, trips):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = drain(plan, F, I, buf, trips)
        e1.record()
        e1.synchronize()
        log["drains"].append(dict(trip=plan.trips_bound - trips, lanes=int(buf.drain_len),
                                  cap=buf.drain_cap, ms=e0.elapsed_time(e1),
                                  left=int(buf.count)))
        return out

    def rec_tail(*a, **k):
        log["tails"] += 1
        return tail(*a, **k)

    return patched(trip_drain=rec_drain, trip_tail=rec_tail)


def render(scene, cam, w, h, spp, **kw):
    buf, rays = render_image(scene, cam, w, h, spp, max_bounces=50, **kw)
    torch.cuda.synchronize()
    return buf, int(rays)


def equal(a, b):
    return {k: bool(torch.equal(getattr(a[0], k), getattr(b[0], k))) for k in KEYS} | {
        "segs": a[1] == b[1]}


def ptxas_regs(log_text):
    """{kernel: [ptxas's lines on it]} of the trip kernels in an nvcc -v log:
    its registers, and its stack frame and spills."""
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            cur = re.sub(r"^_Z(N12_GLOBAL__N_1)?\d+", "", m.group(1))
        elif cur and "trip" in cur and ("Used" in line or "spill" in line):
            out.setdefault(cur, []).append(line.split(": ", 1)[-1].strip())
    return out


def phase_regs(args, res):
    path = kernels.build()
    with open(path + ".log") as fh:
        res["regs"] = ptxas_regs(fh.read())
    if args.parent:
        src = os.path.join(args.parent, "tpupt_torch", "accel", "csrc", "trip_kernels.cu")
        flags = [f for f in kernels.NVCC_FLAGS if f != "-shared"]
        p = subprocess.run([kernels._nvcc(), *flags, "-c", src, "-o", os.devnull],
                           capture_output=True, text=True, timeout=900)
        res["regs_parent"] = ptxas_regs(p.stdout + p.stderr)


def phase_check(args, res, scene, cam):
    cases = {"512^2 64spp chained": (512, 512, 64, {}),
             "256^2 4spp chained": (256, 256, 4, {}),
             "256^2 4spp per sample": (256, 256, 4, dict(chain_samples=False)),
             "256^2 4spp chained rr4": (256, 256, 4, dict(rr_start=4))}
    out = {}
    for name, (w, h, spp, kw) in cases.items():
        kw = dict(kw, start_iteration=args.start)
        log = {}
        with logged(log):
            got = render(scene, cam, w, h, spp, **kw)
        with issued():
            want = render(scene, cam, w, h, spp, **kw)
        out[name] = dict(equal=equal(got, want), segs=got[1], **log)
        print(f"check {name}: {out[name]}", flush=True)
    # the 256^2, 4-spp render both ways, 10 renders each, in turns
    times = {"handover": [], "issued": []}
    for rep in range(4):
        for mode in (("handover", "issued") if rep % 2 == 0 else ("issued", "handover")):
            with (issued() if mode == "issued" else contextlib.nullcontext()):
                render(scene, cam, 256, 256, 4, start_iteration=args.start)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                for _ in range(10):
                    render_image(scene, cam, 256, 256, 4, max_bounces=50,
                                 start_iteration=args.start)
                e1.record()
                e1.synchronize()
                times[mode].append(dict(wall_ms=(time.perf_counter() - t0) * 100,
                                        event_ms=e0.elapsed_time(e1) / 10))
    out["256^2 4spp ms a render"] = times
    print(f"check 256^2 4spp ms a render: {times}", flush=True)
    res["check"] = out


def phase_curve(args, res, scene, cam):
    curve = []
    tail = tk.trip_tail

    def rec(plan, F, I, buf, *a, **k):
        out = tail(plan, F, I, buf, *a, **k)
        curve.append(int(buf.count))
        return out

    with issued(), patched(trip_tail=rec):
        render(scene, cam, 3840, 2160, 200, start_iteration=args.start)
    res["curve"] = curve
    marks = [c for c in (100, 300, 600, 1000, 1500, 2000, 3000, 5000) if c < len(curve)]
    print("curve: trips", len(curve), {t: curve[t - 1] for t in marks}, flush=True)
    for wave in (33_792, 67_584, 101_376, 135_168, 270_336):
        first = next((t + 1 for t, c in enumerate(curve) if c <= wave), None)
        print(f"curve: first trip after which <= {wave} lanes remain: {first}", flush=True)


def phase_time(args, res, scene, cam):
    rows, first = [], {}
    for rep in range(args.reps):
        for mode in (("handover", "issued") if rep % 2 == 0 else ("issued", "handover")):
            log = {}
            with (issued() if mode == "issued" else contextlib.nullcontext()), logged(log):
                t0 = time.perf_counter()
                out = render(scene, cam, 3840, 2160, 200, start_iteration=args.start)
                wall = time.perf_counter() - t0
            row = dict(mode=mode, wall_s=wall, mrays_per_s=out[1] / wall / 1e6, segs=out[1],
                       trips=log["tails"], drains=log["drains"])
            rows.append(row)
            print(f"time: {row}", flush=True)
            if rep == 0:
                first[mode] = out
    res["time"] = rows
    res["time_equal"] = equal(first["handover"], first["issued"])
    print(f"time: the first pair equal {res['time_equal']}", flush=True)


def drain_all_lib():
    """``experiments/trip_drain_all.cu`` built with the library's flags
    (its registers from ptxas's report) and bound as ``tpupt_trip_drain``
    is."""
    out = os.path.join(os.path.dirname(kernels.library_path()), "trip_drain_all.so")
    src = os.path.join(ROOT, "experiments", "trip_drain_all.cu")
    p = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, src, "-o", out],
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        sys.exit(f"nvcc failed on trip_drain_all.cu:\n{(p.stdout + p.stderr)[-4000:]}")
    lib = ctypes.CDLL(out)
    lib.tpupt_trip_drain_all.restype = ctypes.c_int
    lib.tpupt_trip_drain_all.argtypes = kernels.load().tpupt_trip_drain.argtypes
    regs = {k: v for k, v in ptxas_regs(p.stdout + p.stderr).items() if "drain" in k}
    return lib, regs


def drain_with(lib):
    """``tk.trip_drain`` with ``lib.tpupt_trip_drain_all`` in place of the
    library's entry."""
    def drain(plan, F, I, buf, trips):
        tabs = plan.tables
        rr = tk._NO_RR if plan.rr_start is None else int(plan.rr_start)
        err = lib.tpupt_trip_drain_all(
            F.data_ptr(), I.data_ptr(), plan.n, tabs.table.data_ptr(), tabs.table.numel(),
            tabs.n_sph, tabs.mat_off, tabs.obj_off, tabs.bg_off, tabs.cam.data_ptr(), plan.pix0,
            plan.width, plan.height, plan.iteration, plan.spp, plan.max_bounces, rr,
            int(plan.chained), int(trips), buf.drain_ids.data_ptr(), buf.drain_cap,
            buf.drain_len.data_ptr(), buf.count.data_ptr(), kernels.stream_of(F))
        kernels.check(kernels.load(), err, "trip_drain_all")
        return F, I

    return drain


def phase_whole(args, res, scene, cam):
    lib, regs = drain_all_lib()
    res["whole_regs"] = regs
    print("whole: trip_drain_all registers", json.dumps(regs), flush=True)
    every = dict(drain_wave=lambda plan: 1 << 30)  # a list of every lane: handed over at trip 0
    modes = {"handover": dict(), "whole": every,
             "counter": dict(every, trip_drain=drain_with(lib))}
    rows, first = [], {}
    for mode in modes:  # a warm-up of each
        with patched(**modes[mode]):
            render(scene, cam, 512, 512, 4, start_iteration=args.start)
    for rep in range(args.reps):
        order = list(modes) if rep % 2 == 0 else list(modes)[::-1]
        for mode in order:
            log = {}
            with patched(**modes[mode]), logged(log):
                t0 = time.perf_counter()
                out = render(scene, cam, 3840, 2160, 200, start_iteration=args.start)
                wall = time.perf_counter() - t0
            row = dict(mode=mode, wall_s=wall, mrays_per_s=out[1] / wall / 1e6, segs=out[1],
                       trips=log["tails"], drains=log["drains"])
            rows.append(row)
            print(f"whole: {row}", flush=True)
            if rep == 0:
                first[mode] = out
    res["whole"] = rows
    res["whole_equal"] = {m: equal(first[m], first["handover"]) for m in ("whole", "counter")}
    print(f"whole: outputs against the handover's {res['whole_equal']}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="regs,check,curve,time,whole")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--start", type=int, default=123457)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "trip_drain.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: the drain runs only on the card")
    torch.set_num_threads(4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    res = dict(card=smi.stdout.strip())
    print("card:", res["card"], flush=True)
    phases = args.phases.split(",")
    if "regs" in phases:
        phase_regs(args, res)
        print("regs:", json.dumps(res["regs"], indent=1), flush=True)
        if "regs_parent" in res:
            print("regs parent:", json.dumps(res["regs_parent"], indent=1), flush=True)
    scene, cam = three_balls("cuda")
    from tpupt_torch.render import integrator

    plan = integrator._trip_plan(scene, cam, 64, 64, spp=1, max_bounces=50, rr_start=None,
                                 iteration=0, chained=True)
    res["wave"] = tk.drain_wave(plan)
    print("wave:", res["wave"], flush=True)
    for name, fn in (("check", phase_check), ("curve", phase_curve), ("time", phase_time),
                     ("whole", phase_whole)):
        if name in phases:
            fn(args, res, scene, cam)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    main()
