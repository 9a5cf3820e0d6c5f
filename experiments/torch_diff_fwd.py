"""The differentiable trip's forward (diff_trip_fwd) of the shipped kernel
library against the libraries built from other checkouts' sources, in
turns, on one NVIDIA GPU.

    python experiments/torch_diff_fwd.py --compare-root DIR[,DIR...] [--variants lb2,...]
                                         [--bounces 0,1,2,7] [--reps 50] [--steps 2]

``--compare-root`` names checkouts (e.g. a ``git archive`` of an earlier
tree under ``build/``), each labelled by its directory's name, whose
``tpupt_torch/accel/csrc`` is built with the library's own flags
(``torch_variant.py``); their ``tpupt_diff_trip_fwd`` has the same C
interface, so the shipped wrapper calls any of the libraries.
``--variants`` adds libraries built from the shipped sources with the
substitutions of ``VARIANTS`` (a design choice each: launch bounds, the
lanes a thread (and so a CTA) takes) or of
``DIAGNOSTIC`` (a part of the work dropped: timed, not compared).

The script takes the fwd+bwd step of chip_smoke.py's phase 6 (bunny.json
1024^2, 4 spp, 8 bounces, no roulette, loss sum(color^2), gradients to
every leaf) and keeps diff_trip_fwd's inputs on the first sample's
bounces named.  On each kept bounce every library's forward must equal
the twin ``diff_trip_fwd_plain`` in every output (the lane state, the
residuals it writes, the lanes left), and each is timed on the device
(torch.profiler over ``--reps`` calls, the lane state restored before
each, the kernel's time summed) in turns: shipped, others...,
variants..., variants..., others..., shipped.  Each bounce's bytes and
byte bound are counted as chip_smoke.py's phase 6 counts them.  Then
``--steps`` steps by each library in turns (shipped, others..., variants...,
and back), each under torch.profiler: diff_trip_fwd's and trip_head's
device ms summed over the step, their launches, the step's busy time.

Prints the card's name, power limit and SM clocks and each library's
registers and spill for diff_trip_fwd_kernel.  The last line of standard
output is one JSON object; the same goes to
``chiprun_out/torch_diff_fwd.json``.
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

from tpupt_torch import extract_params, render_image, with_params  # noqa: E402
from tpupt_torch.accel import kernels  # noqa: E402
from tpupt_torch.diff.params import MATERIAL_LEAVES, PARAM_LEAVES  # noqa: E402
from tpupt_torch.render import diff_trip, trip_kernel  # noqa: E402
from tpupt_torch.utils import trace  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

SIZE, SPP, MAX_BOUNCES = 1024, 4, 8
KERNEL = "diff_trip_fwd_kernel"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 HBM3 peak memory rate

_BOUNDS = "__launch_bounds__(kFwdThreads) diff_trip_fwd_kernel"
_PER = "constexpr int kFwdPer = 2;"
VARIANTS = {
    "lb3": [(_BOUNDS, _BOUNDS.replace("(kFwdThreads)", "(kFwdThreads, 3)"))],
    "lb4": [(_BOUNDS, _BOUNDS.replace("(kFwdThreads)", "(kFwdThreads, 4)"))],
    # CTAs of 256 lanes (one a thread) and of 1,024 (four, 16-byte accesses)
    "per1": [(_PER, _PER.replace("2", "1"))],
    "per4": [(_PER, _PER.replace("2", "4"))],
}
# where the time goes: the flags and residual codes alone, no live lane run
# (timed, not compared)
DIAGNOSTIC = {"scan_only": [("  if (!__syncthreads_or(fwd_scan(a, base, codes))) return;",
                             "  __syncthreads_or(fwd_scan(a, base, codes));\n  return;")]}


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
    """ptxas's lines for diff_trip_fwd_kernel in a library's build log."""
    out, keep = [], False
    with open(log_path) as fh:
        for ln in fh:
            if "Compiling entry function" in ln:
                keep = KERNEL in ln
            if keep and ("registers" in ln or "spill" in ln or "stack frame" in ln):
                out.append(re.sub(r"\s+", " ", ln.strip()))
    return out


def device_ms(fn, restore, reps):
    """Mean device milliseconds of diff_trip_fwd_kernel per call of
    ``fn``, ``restore`` (other kernels, not summed) before each; None
    where the profiler records no device time."""
    restore()
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            restore()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if KERNEL in e.key)
    return total / 1e3 / reps if total > 0 else None


def fwd_bytes(plan, code, b):
    """The bounce's bytes as chip_smoke.py's phase 6 counts them for
    diff_trip_fwd (each input read once, each output written once)."""
    n = plan.n
    live = code != diff_trip.DEAD
    hit = code >= 0
    n_live, n_hit = int(live.sum()), int(hit.sum())
    n_tri = int((hit & (code % 2 == 1)).sum())
    n_miss = n_live - n_hit
    first_hits = n_hit if b == 0 else 0
    return (n * 4 + (n - n_live) * 8 + n_live * (4 + (4 if plan.mesh else 0) + 8 + 4 + 8)
            + n_miss * (36 + 12 + 24) + n_hit * (52 + 4 + 52 + 40) + n_tri * 40
            + first_hits * 16 + plan.tables.table.numel() * 4 + 4), \
        dict(lanes=n, live=n_live, hits=n_hit, triangle_hits=n_tri)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare-root", required=True)
    ap.add_argument("--variants", default="")
    ap.add_argument("--bounces", default="0,1,2,7")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card (name, power limit, SM clock, max SM clock): {smi}", flush=True)
    roots = {os.path.basename(os.path.normpath(r)): os.path.join(
        os.path.abspath(r), "tpupt_torch", "accel", "csrc") for r in args.compare_root.split(",")}
    builds = {"shipped": ([], None), **{name: ([], csrc) for name, csrc in roots.items()}}
    for v in filter(None, args.variants.split(",")):
        builds[v] = ({**VARIANTS, **DIAGNOSTIC}[v], None)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(torch_variant.build, kernels, subs, csrc=csrc)
                for name, (subs, csrc) in builds.items()}
        paths = {name: f.result() for name, f in futs.items()}
    libs = {name: kernels.bind(p) for name, p in paths.items()}
    registers = {name: register_report(p + ".log") for name, p in paths.items()}
    for name, lines in registers.items():
        print(f"{name}: " + "; ".join(lines), flush=True)
    order = list(libs) + list(libs)[::-1]

    ensure_models(names=["bunny.obj"])
    desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
    scene = desc.build(leaf_size=32, device="cuda")
    leaves = PARAM_LEAVES + tuple(f"materials.{k}" for k in MATERIAL_LEAVES)

    def step():
        params = extract_params(scene)
        buf, _ = render_image(with_params(scene, params), desc.camera, SIZE, SIZE, spp=SPP,
                              max_bounces=MAX_BOUNCES, differentiable=True)
        wrt = [params["materials"][k[10:]] if k.startswith("materials.") else params[k]
               for k in leaves]
        return torch.autograd.grad((buf.color ** 2).sum(), wrt, allow_unused=True,
                                   materialize_grads=True)

    want = {int(b) for b in args.bounces.split(",")}
    kept, first, fwd = {}, [], diff_trip.diff_trip_fwd

    def recording(dp, F, I, buf, sweep, b, res=None):
        if not first:
            first.append(dp)
        if dp is first[0] and b in want:
            kept[b] = (F.clone(), I.clone(), buf.hint.clone(),
                       None if sweep is None else tuple(o.clone() for o in sweep))
        return fwd(dp, F, I, buf, sweep, b, res)

    diff_trip.diff_trip_fwd = recording
    try:
        step()
    finally:
        diff_trip.diff_trip_fwd = fwd
    dp = first[0]
    print(f"bunny.json {SIZE}^2, {SPP} spp, {MAX_BOUNCES} bounces: kept bounces "
          f"{sorted(kept)} of sample 0", flush=True)

    report = dict(card=smi, registers=registers, bounces={}, steps={})
    n = dp.trip.n
    for b in sorted(kept):
        F0, I0, hint, sweep = kept.pop(b)

        def run(fn):
            F, I = F0.clone(), I0.clone()
            buf = trip_kernel.trip_buffers(dp.trip)
            buf.hint.copy_(hint)
            res = diff_trip.residuals(n, F.device)
            res.f.fill_(7.0)
            fn(dp, F, I, buf, sweep, b, res)
            return F, I, res.f, res.i, buf.count

        twin = run(diff_trip.diff_trip_fwd_plain)
        for lib_name, lib in libs.items():
            if lib_name in DIAGNOSTIC:
                continue
            with using(lib):
                got = run(diff_trip.diff_trip_fwd)
            torch.cuda.synchronize()
            for label, x, y in zip(("F", "I", "res_f", "res_i", "count"), got, twin):
                assert torch.equal(x, y), f"bounce {b}: {lib_name}'s {label} differs from the twin"
        nbytes, w = fwd_bytes(dp.trip, twin[3][0], b)
        w.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        F, I = F0.clone(), I0.clone()
        buf = trip_kernel.trip_buffers(dp.trip)
        buf.hint.copy_(hint)
        res = diff_trip.residuals(n, F.device)

        def restore():
            F.copy_(F0)
            I.copy_(I0)

        ms = {lib_name: [] for lib_name in libs}
        for lib_name in order:
            with using(libs[lib_name]):
                ms[lib_name].append(device_ms(
                    lambda: diff_trip.diff_trip_fwd(dp, F, I, buf, sweep, b, res), restore,
                    args.reps))
        report["bounces"][b] = dict(work=w, device_ms=ms)
        print(f"bounce {b} ({w['live']} live, {w['hits']} hits, {w['triangle_hits']} on "
              f"triangles; {nbytes / 1e6:.1f} MB, bound {w['bound_ms']:.4f} ms): "
              + ", ".join(f"{k} " + "/".join("n/a" if x is None else f"{x:.4f}" for x in v)
                          for k, v in ms.items()) + f"  [{smi}]", flush=True)
        del F0, I0, sweep, F, I, res, twin

    named = list(libs)
    for lib_name in (named + named[::-1]) * args.steps:
        with using(libs[lib_name]):
            step()
            torch.cuda.synchronize()
            n0 = trace.launch_counts()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
        kav = [e for e in prof.key_averages() if e.self_device_time_total > 0]

        def dev(key):
            return sum(e.self_device_time_total for e in kav if key in e.key) / 1e3

        now = trace.launch_counts()
        rec = report["steps"].setdefault(lib_name, [])
        rec.append(dict(diff_trip_fwd_ms=dev(KERNEL), trip_head_ms=dev("trip_head_kernel"),
                        busy_ms=sum(e.self_device_time_total for e in kav) / 1e3,
                        launches={k: now[k] - n0[k] for k in ("diff_trip_fwd", "trip_head")}))
        print(f"step, {lib_name}: {rec[-1]}  [{smi}]", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_diff_fwd.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
