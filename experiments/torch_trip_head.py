"""trip_head of the shipped kernel library against the library built from
another checkout's sources, on one NVIDIA GPU.

    python experiments/torch_trip_head.py --compare-root DIR [--trips 0,2,20,47,93]
                                          [--reps 50]

``--compare-root`` is a checkout (e.g. a ``git archive`` of an earlier
tree under ``build/``) whose ``tpupt_torch/accel/csrc`` is built with the
library's own flags (``torch_variant.py``).  The script renders bunny.json
as chip_smoke.py's phase 4 does (1024^2, 16 spp, 50 bounces, RR 8, the
trip route) and keeps the lane state and trip_head's buffers at the start
of the trips named.  On each kept trip both libraries' trip_head run on the
same inputs and must agree on what the sweep and trip_tail read (every
output of a live lane, every lane's seed t and mask, the pad lanes); each
library's kernel is timed on the device (torch.profiler over ``--reps``
calls; CUDA events over the wrapper would time the host's issue on a trip
with few live lanes) in turns: shipped, other, other, shipped.  Then four
more renders in the same turns, each under torch.profiler, sum each
kernel's device time over the render.  Prints
the card's name and power limit; the last line of standard output is one
JSON object.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys

import torch

import torch_variant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpupt_torch import render_image  # noqa: E402
from tpupt_torch.accel import kernels  # noqa: E402
from tpupt_torch.render import trip_kernel  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

SIZE, SPP, MAX_BOUNCES, RR = 1024, 16, 50, 8
HEAD_OUT = ("hrec", "hint", "rows", "act_p")


@contextlib.contextmanager
def using(lib):
    """Every kernel wrapper launches from ``lib`` inside the block."""
    load = kernels.load
    kernels.load = lambda: lib
    try:
        yield
    finally:
        kernels.load = load


def device_ms(fn, reps):
    """Mean device milliseconds of trip_head_kernel per call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if "trip_head_kernel" in e.key)
    assert total > 0, "the profiler recorded no device time"
    return total / 1e3 / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare-root", required=True)
    ap.add_argument("--trips", default="0,2,20,47,93")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    keep = {int(t) for t in args.trips.split(",")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    libs = {"shipped": kernels.load(),
            "other": kernels.bind(torch_variant.build(kernels, [], csrc=os.path.join(
                os.path.abspath(args.compare_root), "tpupt_torch", "accel", "csrc")))}

    ensure_models(names=["bunny.obj"])
    desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
    scene = desc.build(leaf_size=32, device="cuda")

    def render():
        return render_image(scene, desc.camera, SIZE, SIZE, spp=SPP, max_bounces=MAX_BOUNCES,
                            rr_start=RR)

    kept, calls = {}, [0]
    head = trip_kernel.trip_head

    def recording(plan, F, I, buf):
        if calls[0] in keep:
            kept[calls[0]] = (plan, F.clone(), I.clone(),
                              {k: None if getattr(buf, k) is None else getattr(buf, k).clone()
                               for k in HEAD_OUT})
        calls[0] += 1
        return head(plan, F, I, buf)

    trip_kernel.trip_head = recording
    try:
        render()
    finally:
        trip_kernel.trip_head = head
    print(f"bunny.json {SIZE}^2, {SPP} spp: {calls[0]} trips; kept {sorted(kept)}")

    per_trip = {}
    for trip in sorted(kept):
        plan, F, I, before = kept.pop(trip)
        alive = I[trip_kernel.I_KEYS.index("alive")] != 0
        bufs = {}
        for name, lib in libs.items():
            b = bufs[name] = trip_kernel.trip_buffers(plan)
            for k in HEAD_OUT:
                if getattr(b, k) is not None:
                    getattr(b, k).copy_(before[k])
            with using(lib):
                trip_kernel.trip_head(plan, F, I, b)
        s, o = bufs["shipped"], bufs["other"]
        ok = torch.equal(s.hrec[:, alive], o.hrec[:, alive]) and torch.equal(s.hint[alive],
                                                                              o.hint[alive])
        if plan.mesh:
            live_or_pad = torch.cat([alive, alive.new_ones(plan.n_pad - plan.n)])
            rs, ro = s.rows.reshape(8, -1), o.rows.reshape(8, -1)
            ok = ok and torch.equal(rs[:7, live_or_pad], ro[:7, live_or_pad])
            ok = ok and torch.equal(rs[7], ro[7]) and torch.equal(s.act_p, o.act_p)
        assert ok, f"trip {trip}: the two libraries' trip_head disagree"
        ms = {"shipped": [], "other": []}
        for name in ("shipped", "other", "other", "shipped"):
            with using(libs[name]):
                ms[name].append(device_ms(lambda: trip_kernel.trip_head(plan, F, I, bufs[name]),
                                          args.reps))
        per_trip[trip] = dict(lanes=plan.n, live=int(alive.sum()), ms=ms)
        print(f"trip {trip}: {int(alive.sum())} of {plan.n} lanes live; trip_head on the "
              f"device: shipped {', '.join(f'{x:.4f}' for x in ms['shipped'])} ms, other "
              f"{', '.join(f'{x:.4f}' for x in ms['other'])} ms  [{card}]", flush=True)
        del plan, F, I, before, bufs

    renders = []
    for name in ("shipped", "other", "other", "shipped"):
        with using(libs[name]):
            render()  # warm-up of this library's kernels
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                render()
                torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.self_device_time_total > 0]

        def dev(key):
            hits = [e for e in kern if key in e.key]
            return sum(e.self_device_time_total for e in hits) / 1e3, sum(e.count for e in hits)

        r = dict(library=name, busy_ms=sum(e.self_device_time_total for e in kern) / 1e3)
        for key in ("trip_head_kernel", "trip_tail_kernel", "treelet_closest_hit_kernel"):
            r[key] = dict(zip(("ms", "launches"), dev(key)))
        renders.append(r)
        print(f"render by {name}: device busy {r['busy_ms']:.2f} ms; trip_head "
              f"{r['trip_head_kernel']['ms']:.3f} ms in {r['trip_head_kernel']['launches']}, "
              f"trip_tail {r['trip_tail_kernel']['ms']:.3f} ms, the sweep "
              f"{r['treelet_closest_hit_kernel']['ms']:.3f} ms  [{card}]", flush=True)
    print(json.dumps(dict(card=card, compare_root=args.compare_root, trips=per_trip,
                          renders=renders)))


if __name__ == "__main__":
    main()
