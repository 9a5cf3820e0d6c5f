"""Per-CTA timeline of the port's closest-hit kernel on one NVIDIA GPU.

    python experiments/torch_sweep_cta.py

Builds ``tpupt_torch/accel/csrc`` a second time with
``-DTPUPT_SWEEP_PROFILE``, which makes thread 0 of every CTA (one 256-ray
packet) stamp %globaltimer when the CTA starts, when its cull and
compaction are done, when its sort is done and when it ends, with its SM
id and its treelet visits.  Runs it on chip_smoke.py's two inputs of the
bunny.json 1024^2 render (pixel-centre primaries, secondaries after one
bounce), checks that the variant's six outputs equal the plain build's,
and prints per input: the kernel's time (plain build, profile build with
stamps off and on, CUDA events), the launch's span, CTA durations and
their split into cull, sort and walk, when the last CTA starts and how the
CTAs end.  The last line of standard output is the same as one JSON
object; the stamps go to ``chiprun_out/sweep_cta_<input>.npy``.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpupt_torch.accel import kernels, packets, sweep_kernel  # noqa: E402
from tpupt_torch.core.camera import generate_rays, pixel_centers  # noqa: E402
from tpupt_torch.render import integrator, intersect  # noqa: E402
from tpupt_torch.render.materials import shade  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

SIZE = 1024
STAMPS = 6  # start, culled, sorted, end (ns), SM id, visits


def event_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    plain_lib = kernels.load()
    prof_lib = kernels.bind(kernels.build(["-DTPUPT_SWEEP_PROFILE"]))
    prof_lib.tpupt_sweep_profile_buffer.restype = ctypes.c_int
    prof_lib.tpupt_sweep_profile_buffer.argtypes = [ctypes.c_void_p]

    ensure_models(names=["bunny.obj"])
    desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
    scene = desc.build(leaf_size=32, device=dev)
    L = scene.s_leaf_size
    n = SIZE * SIZE
    fx, fy = pixel_centers(SIZE, SIZE, device=dev)
    ro, rd = generate_rays(desc.camera.to(dev), SIZE, SIZE, fx, fy)
    t_min = torch.full((n,), 1e-4, device=dev)
    pix = torch.arange(n, device=dev)
    st, seed = integrator._fresh_state(scene, desc.camera.to(dev), SIZE, SIZE, pix, 0)
    _ids, hit0 = intersect.intersect_scene_ids(scene, st["ro"], st["rd"], st["t_min"], st["alive"])
    ro2, rd2, tmin2, *_ = shade(scene, hit0, st["ro"], st["rd"], st["t_min"], st["color"], seed,
                                torch.zeros_like(pix))
    inputs = {
        "primaries": (ro, rd, t_min, torch.ones(n, dtype=torch.bool, device=dev)),
        "secondaries": (ro2, rd2, tmin2, hit0.mask),
    }
    print(f"card: {card}")
    report = {"card": card}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    for label, (o, d, tm, act) in inputs.items():
        z = torch.zeros(n, device=dev)
        t_seed = intersect._sphere_pass(scene, o, d, tm, act, z + intersect.BIG_T, z.int() - 1,
                                        z.long() - 1, z.long() - 1)[0]
        rows, act_p = packets._pack_rows(o, d, tm, t_seed, act)
        args = (rows, act_p, scene.tre_min, scene.tre_max, scene.tre_tris, L)
        call = lambda: sweep_kernel.treelet_closest_hit(*args)  # noqa: E731
        kernels.load = lambda: plain_lib
        want = call()
        ms = event_ms(call)
        kernels.load = lambda: prof_lib
        off_ms = event_ms(call)
        np_ = act_p.shape[0]
        buf = torch.zeros((np_, STAMPS), dtype=torch.int64, device=dev)
        kernels.check(prof_lib, prof_lib.tpupt_sweep_profile_buffer(buf.data_ptr()), "profile")
        on_ms = event_ms(call)
        buf.zero_()
        got = call()
        torch.cuda.synchronize()
        kernels.check(prof_lib, prof_lib.tpupt_sweep_profile_buffer(None), "profile")
        kernels.load = lambda: plain_lib
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"{label}: the profile build differs from the plain one"

        P = buf.cpu().numpy()
        t0 = P[:, 0].min()
        start, end = (P[:, 0] - t0) / 1e6, (P[:, 3] - t0) / 1e6
        busy = P[:, 1] > 0  # packets with a live lane
        dur = end - start
        cull = np.where(busy, (P[:, 1] - P[:, 0]) / 1e6, 0.0)
        sort = np.where(busy, (P[:, 2] - P[:, 1]) / 1e6, 0.0)
        walk = np.where(busy, (P[:, 3] - P[:, 2]) / 1e6, 0.0)
        ends = np.sort(end)
        longest = np.argsort(-dur)[:5]
        r = dict(
            kernel_ms=ms, profile_build_stamps_off_ms=off_ms, profile_build_stamps_on_ms=on_ms,
            packets=int(np_), busy_packets=int(busy.sum()), sms=int(len(np.unique(P[:, 4]))),
            span_ms=float(ends[-1]), last_start_ms=float(start.max()),
            end_p50_ms=float(ends[np_ // 2]), end_p90_ms=float(ends[int(0.9 * np_)]),
            end_p99_ms=float(ends[int(0.99 * np_)]),
            cta_mean_ms=float(dur.mean()), cta_max_ms=float(dur.max()),
            cull_mean_ms=float(cull[busy].mean()), sort_mean_ms=float(sort[busy].mean()),
            walk_mean_ms=float(walk[busy].mean()),
            cull_share=float(cull.sum() / dur.sum()), sort_share=float(sort.sum() / dur.sum()),
            walk_share=float(walk.sum() / dur.sum()),
            visits_mean=float(P[:, 5].mean()), visits_max=int(P[:, 5].max()),
            longest=[dict(packet=int(i), start_ms=float(start[i]), ms=float(dur[i]),
                          cull_ms=float(cull[i]), visits=int(P[i, 5])) for i in longest],
        )
        report[label] = r
        np.save(os.path.join(ROOT, "chiprun_out", f"sweep_cta_{label}.npy"), P)
        print(f"{label}: kernel {ms:.4f} ms (profile build {off_ms:.4f} ms stamps off, "
              f"{on_ms:.4f} on); span {r['span_ms']:.4f} ms, last CTA starts at "
              f"{r['last_start_ms']:.4f}, half the CTAs done by {r['end_p50_ms']:.4f}, 90% by "
              f"{r['end_p90_ms']:.4f}, 99% by {r['end_p99_ms']:.4f}")
        print(f"  CTA mean {r['cta_mean_ms']:.4f} ms, max {r['cta_max_ms']:.4f}; per busy CTA "
              f"cull {r['cull_mean_ms']:.4f}, sort {r['sort_mean_ms']:.4f}, walk "
              f"{r['walk_mean_ms']:.4f} ms (shares {r['cull_share']:.1%}, {r['sort_share']:.1%}, "
              f"{r['walk_share']:.1%}); visits mean {r['visits_mean']:.2f}, max {r['visits_max']}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
