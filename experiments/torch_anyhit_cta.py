"""Per-packet timeline of the port's any-hit kernel on one NVIDIA GPU.

    python experiments/torch_anyhit_cta.py [--inputs bunny_shadow,mixed,cornell_area,ajax_shadow]
                                           [--variants NAME,...]

Builds ``tpupt_torch/accel/csrc`` a second time with
``-DTPUPT_SWEEP_PROFILE``, which makes every packet stamp %globaltimer
when its walker starts, when its cull and key compaction are done, when
its sort is done and when it ends, with its SM id (bit 32 set where one
warp walked the packet, clear where a whole CTA did) and its treelet
visits.  Runs ``sweep_kernel.treelet_any_hit`` on chip_smoke.py's
shadow-ray inputs (phases 9 and 17):

  bunny_shadow   the hits of bunny.json's 1024^2 secondaries toward
                 (0, 4, -1.5): sparse packets;
  mixed          the mesh hits of bunny.json's 1024^2 pixel-centre
                 primaries toward the same point: packets dense over the
                 bunnies, empty elsewhere;
  cornell_area   the rows cornell_area.json's first bounce (512^2) hands
                 the kernel: K = 1, dense;
  ajax_shadow    the hits of ajax-white-hi.json's 256^2 pixel-centre
                 primaries toward (0, 9, 0), where the light is on the
                 hit's side of the surface: K = 14,782;
  bunny_shadow_leaf256
                 bunny_shadow's rays on bunny.json built with 256
                 triangles a treelet: K = 58, below the two-level cull,
                 with blocks to walk.

``--variants`` also builds each named design choice of VARIANTS (a copy
of the sources with text substitutions, ``torch_variant.py``), and the
shipped library and the variants are run in turns, in order and then
reversed.  Checks that every library's occlusion, plain and profile
build, equals the twin's, and prints per input and library: the time of
a call by CUDA events over the wrapper (plain build; profile build with
stamps on) and the launches' span from the stamps (device time without
the host's issue); then the packets by live lanes and, for the shipped
library, per route the mean packet time and its split into cull, sort
and walk, with visits.  The last line of standard output is the same as
one JSON object; the stamps go to
``chiprun_out/anyhit_cta_<input>_<library>.npy``.
"""

import argparse
import concurrent.futures
import ctypes
import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpupt_torch.accel import kernels, packets, sweep_kernel  # noqa: E402
from tpupt_torch.core.camera import generate_rays, pixel_centers  # noqa: E402
from tpupt_torch.core.vec import Vec3  # noqa: E402
from tpupt_torch.render import integrator, intersect  # noqa: E402
from tpupt_torch.render.materials import shade  # noqa: E402
from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path  # noqa: E402
from tpupt_torch.scene.json_parser import scene_from_json  # noqa: E402

import torch_variant  # noqa: E402

STAMPS = 6  # start, culled, sorted, end (ns), SM id | warp route << 32, visits
INPUTS = ("bunny_shadow", "mixed", "cornell_area", "ajax_shadow", "bunny_shadow_leaf256")

# the design choices compared with the shipped sources: (shipped text,
# variant text) in csrc/treelet_kernels.cu
_SMALL_K_SMEM = """    const size_t smem = tpupt_treelet_smem_bytes(K, L);
    if ((e = ensure_smem(treelet_any_hit_walk_kernel, walk_hw, smem)) != cudaSuccess) return (int)e;
    treelet_any_hit_walk_kernel<<<n_packets, kPacket, smem, s>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tcap, act, tre_min, tre_max, tre_tris, K, L, occ_out);"""
VARIANTS = {
    # below 96 treelets, the two routes as above (two launches, two streams)
    "small_k_two_routes": [("  if (K < kTwoLevelMinK) {\n    const size_t smem",
                            "  if (false) {\n    const size_t smem")],
    # below 96 treelets, the block route alone (one launch)
    "small_k_block_route": [(_SMALL_K_SMEM, """    const size_t smem = any_hit_block_smem(K, L);
    if ((e = ensure_smem(treelet_any_hit_kernel, block_hw, smem)) != cudaSuccess) return (int)e;
    treelet_any_hit_kernel<<<n_packets, kPacket, smem, s>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tcap, act, tre_min, tre_max, tre_tris, K, L, 0,
        occ_out);""")],
    # the small-K walk testing four pairs at a time, as the routes do
    "walk_pairs_by_four": [("any_block_serial(r, t_b, blk, L)) t_b = -kBig;",
                            "any_block(r, t_b, blk, L, 0, 1)) t_b = -kBig;")],
    # the block route held to 4 or 3 CTAs an SM (64 or 85 registers), the
    # small-K walk to 6 or 8 (40 or 32)
    **{f"block_min_blocks_{n}": [("__launch_bounds__(kPacket) treelet_any_hit_kernel(",
                                  f"__launch_bounds__(kPacket, {n}) treelet_any_hit_kernel(")]
       for n in (3, 4)},
    **{f"walk_min_blocks_{n}": [("__launch_bounds__(kPacket) treelet_any_hit_walk_kernel(",
                                 f"__launch_bounds__(kPacket, {n}) treelet_any_hit_walk_kernel(")]
       for n in (6, 8)},
}


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


def load_scene(name, dev):
    desc = scene_from_json(os.path.join(locate_asset_path(ROOT), "scenes", name))
    return desc, desc.build(leaf_size=32, device=dev)


def shadow_rows(hit, mask, light):
    """Rows of shadow rays from ``hit``'s points (offset along the normal)
    toward the point ``light``, on the lanes of ``mask``."""
    p = hit.point + hit.normal * 1e-4
    to = Vec3(*(torch.full_like(p.x, v) for v in light)) - p
    dist = to.length()
    return packets._pack_rows(p, to * (1.0 / dist), torch.full_like(dist, 1e-4), 0.999 * dist,
                              mask)


@torch.no_grad()
def build_input(label, dev):
    """(scene, rows, act_p) of one input."""
    if label == "bunny_shadow_leaf256":
        _scene, rows, act_p = build_input("bunny_shadow", dev)
        desc = scene_from_json(os.path.join(locate_asset_path(ROOT), "scenes", "bunny.json"))
        return desc.build(leaf_size=256, device=dev), rows, act_p
    if label in ("bunny_shadow", "mixed"):
        ensure_models(names=["bunny.obj"])
        desc, scene = load_scene("bunny.json", dev)
        size = 1024
        n = size * size
        if label == "mixed":
            fx, fy = pixel_centers(size, size, device=dev)
            ro, rd = generate_rays(desc.camera.to(dev), size, size, fx, fy)
            ids, hit = intersect.intersect_scene_ids(scene, ro, rd, torch.full((n,), 1e-4, device=dev),
                                                     torch.ones(n, dtype=torch.bool, device=dev))
            return (scene, *shadow_rows(hit, hit.mask & (ids.kind == intersect.PRIM_TRIANGLE),
                                        (0.0, 4.0, -1.5)))
        pix = torch.arange(n, device=dev)
        st, seed = integrator._fresh_state(scene, desc.camera.to(dev), size, size, pix, 0)
        _ids, hit0 = intersect.intersect_scene_ids(scene, st["ro"], st["rd"], st["t_min"],
                                                   st["alive"])
        ro2, rd2, tmin2, *_ = shade(scene, hit0, st["ro"], st["rd"], st["t_min"], st["color"], seed,
                                    torch.zeros_like(pix))
        _ids1, hit1 = intersect.intersect_scene_ids(scene, ro2, rd2, tmin2, hit0.mask)
        return (scene, *shadow_rows(hit1, hit1.mask, (0.0, 4.0, -1.5)))
    if label == "cornell_area":
        ensure_models(names=["quad.obj"])
        desc, scene = load_scene("cornell_area.json", dev)
        size = 512
        pix = torch.arange(size * size, device=dev)
        st, seed = integrator._fresh_state(scene, desc.camera.to(dev), size, size, pix, 0)
        got = []

        def record(*args):
            got.append(args)
            return sweep_kernel.treelet_any_hit(*args)

        integrator._bounce_body(scene, seed, st, torch.zeros_like(pix), None,
                                intersect.intersect_scene_ids, any_hit=record)
        return (scene, *got[0][:2])
    ensure_models(names=["ajax_hi.obj"])
    desc, scene = load_scene("ajax-white-hi.json", dev)
    size = 256
    n = size * size
    fx, fy = pixel_centers(size, size, device=dev)
    ro, rd = generate_rays(desc.camera.to(dev), size, size, fx, fy)
    _ids, hit = intersect.intersect_scene_ids(scene, ro, rd, torch.full((n,), 1e-4, device=dev),
                                              torch.ones(n, dtype=torch.bool, device=dev))
    light = (0.0, 9.0, 0.0)
    to_light = Vec3(*(torch.full_like(hit.point.x, v) for v in light)) - hit.point
    return (scene, *shadow_rows(hit, hit.mask & (hit.normal.dot(to_light) > 0), light))


def split(P, sel):
    """Mean packet ms and the cull / sort / walk means (ms) over ``sel``."""
    if not sel.any():
        return None
    q = P[sel]
    ms = lambda a, b: float(((q[:, b] - q[:, a]) / 1e6).mean())  # noqa: E731
    return dict(packets=int(sel.sum()), packet_ms=ms(0, 3), cull_ms=ms(0, 1), sort_ms=ms(1, 2),
                walk_ms=ms(2, 3), visits_mean=float(q[:, 5].mean()), visits_max=int(q[:, 5].max()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", default=",".join(INPUTS))
    ap.add_argument("--variants", default="", help=f"any of {', '.join(VARIANTS)}")
    args = ap.parse_args()
    names = ["shipped"] + [v for v in args.variants.split(",") if v]
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def build(name, flags):
        if name == "shipped":
            return kernels.build(flags)
        return torch_variant.build(kernels, VARIANTS[name], flags)

    jobs = [(n, f) for n in names for f in ([], ["-DTPUPT_SWEEP_PROFILE"])]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda j: build(*j), jobs))
    libs = {n: (kernels.bind(paths[2 * i]), kernels.bind(paths[2 * i + 1]))
            for i, n in enumerate(names)}
    for _plain, prof in libs.values():
        prof.tpupt_sweep_profile_buffer.restype = ctypes.c_int
        prof.tpupt_sweep_profile_buffer.argtypes = [ctypes.c_void_p]
    print(f"card: {card}; libraries {names}")
    for n, path in zip(names, paths[::2]):
        with open(path + ".log") as fh:
            log = fh.read().splitlines()
        regs, name = [], None
        for ln in log:
            if "entry function" in ln:
                m = re.search(r"(treelet_any_hit\w*?kernel)", ln)
                name = m.group(1) if m else None
            elif "spill stores" in ln and name:
                spill = ln.strip()
            elif "Used " in ln and name:
                regs.append(f"{name} {ln.split('Used ')[1].split(',')[0]} ({spill})")
                name = None
        print(f"  {n}: any-hit kernels (ptxas): {'; '.join(regs) or 'not found'}")
    report = {"card": card, "libraries": names}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    default_load = kernels.load
    for label in args.inputs.split(","):
        scene, rows, act_p = build_input(label, dev)
        targs = (rows, act_p, scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
        call = functools.partial(sweep_kernel.treelet_any_hit, *targs)
        want = sweep_kernel.treelet_any_hit_plain(*targs)
        np_ = act_p.shape[0]
        buf = torch.zeros((np_, STAMPS), dtype=torch.int64, device=dev)

        def measure(name):
            """(call ms, stamps-on ms, stamps) of one library, both
            builds held to the twin."""
            plain, prof = libs[name]
            kernels.load = lambda: plain
            assert torch.equal(call(), want), f"{label}: {name} differs from the twin"
            ms = event_ms(call)
            kernels.load = lambda: prof
            kernels.check(prof, prof.tpupt_sweep_profile_buffer(buf.data_ptr()), "profile")
            on_ms = event_ms(call)
            buf.zero_()
            got = call()
            torch.cuda.synchronize()
            kernels.check(prof, prof.tpupt_sweep_profile_buffer(None), "profile")
            kernels.load = default_load
            assert torch.equal(got, want), f"{label}: {name}'s profile build differs from the twin"
            return ms, on_ms, buf.cpu().numpy()

        times = {n: dict(kernel_ms=[], stamps_on_ms=[], span_ms=[]) for n in names}
        stamps = {}
        for order in (names, names[::-1]):
            for n in order:
                ms, on_ms, P = measure(n)
                stamps.setdefault(n, P)
                times[n]["kernel_ms"].append(ms)
                times[n]["stamps_on_ms"].append(on_ms)
                times[n]["span_ms"].append(float((P[:, 3].max() - P[:, 0].min()) / 1e6))

        P = stamps["shipped"]
        live = act_p.sum(dim=1).cpu().numpy()
        warp = (P[:, 4] >> 32) == 1
        busy = live > 0
        hist = {f"{lo}-{hi}": int(((live >= lo) & (live <= hi)).sum())
                for lo, hi in ((0, 0), (1, 13), (14, 32), (33, 128), (129, 256))}
        r = dict(times=times, packets=int(np_), treelets=int(scene.tre_min.shape[0]),
                 live_lanes=int(live.sum()), occluded=int(want.sum()), packets_by_live_lanes=hist,
                 warp_route=split(P, busy & warp), block_route=split(P, busy & ~warp),
                 sms=int(len(np.unique(P[:, 4] & 0xFFFFFFFF))))
        report[label] = r
        for n, P in stamps.items():
            np.save(os.path.join(ROOT, "chiprun_out", f"anyhit_cta_{label}_{n}.npy"), P)
        print(f"{label}: K={r['treelets']}; {r['live_lanes']} live lanes in {np_} packets "
              f"(by live lanes {hist}), {r['occluded']} occluded; every library equal to the twin")
        for n, t in times.items():
            print(f"  {n}: kernel {', '.join(f'{m:.4f}' for m in t['kernel_ms'])} ms over the "
                  f"wrapper (profile build, stamps on: "
                  f"{', '.join(f'{m:.4f}' for m in t['stamps_on_ms'])}); span of the stamps "
                  f"{', '.join(f'{m:.4f}' for m in t['span_ms'])} ms  [{card}]")
        for route in ("warp_route", "block_route"):
            s = r[route]
            if s:
                print(f"  shipped {route}: {s['packets']} busy packets, mean {s['packet_ms']:.4f} ms "
                      f"= cull {s['cull_ms']:.4f} + sort {s['sort_ms']:.4f} + walk "
                      f"{s['walk_ms']:.4f}; visits mean {s['visits_mean']:.2f}, max "
                      f"{s['visits_max']}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
