"""Missed hits on axis-aligned quads, on the card: whole renders of a lit
mesh scene held to the benchmark's plain reference, with a census of every
trip's closest-hit and any-hit sweeps against brute force.

    python experiments/torch_quad_miss.py reference --scene cornell_area \\
        --starts 8369,8371 --out /tmp/qm
    python experiments/torch_quad_miss.py program --scene cornell_area \\
        --starts 8369,8371 --refs /tmp/qm --json build/qm.json

``reference`` renders each start's whole image with the benchmark's
plain reference (brute force over every triangle, its box test widened:
``h100bench/reference/pathtrace.py``, for ``cornell_box`` the
configuration's ``pathtrace_scene.py``, which reads its black background
and flags ties of two objects) and saves it under ``--out``.  ``program`` renders the
same images with ``render_image`` on the trip route and compares them,
every pixel, with the saved ones (``pixels_off``, ``segments_gap``, as the
benchmark's check; ``tied_off``, the tied pixels that differ all the same).
Meanwhile every call of ``treelet_closest_hit`` and
``treelet_any_hit`` in the render is held to brute-force Möller–Trumbore
over every triangle of the table on its live lanes: a closest hit the
sweep left out (brute force finds a smaller t) or an occluder it missed is
a miss, recorded with its trip, lane (= pixel), the hit treelet's slab
test without tolerance, and whether the kernel equals its torch twin on
that packet; exact-t ties of two objects are counted too.  Scenes: ``cornell_area`` (``assets/scenes``) and
``cornell_box`` (the benchmark's configuration), at ``--size``², ``--spp``
samples from each start and ``--bounces`` bounces, no roulette, on
``--device`` (the card by default).  The
script imports the package beside it, so a copy of it in another checkout
runs that checkout's program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100bench import compare, run  # noqa: E402
from h100bench.jobs import render as render_job  # noqa: E402
from h100bench.reference import pathtrace, pathtrace_scene  # noqa: E402

BIG = 3.0e38
CHUNK = 1 << 20  # lanes a brute-force chunk


def scene_path(name: str) -> str:
    if name == "cornell_area":
        return os.path.join(ROOT, "assets", "scenes", "cornell_area.json")
    return run.prepare(ROOT, run.load_json(run.HERE, "configs", f"{name}.json"))


def reference_of(name: str):
    """The plain reference that the scene is held to."""
    return pathtrace if name == "cornell_area" else pathtrace_scene


def do_reference(args):
    os.makedirs(args.out, exist_ok=True)
    ref = reference_of(args.scene)
    scene = ref.load_scene(scene_path(args.scene), args.device)
    for start in args.starts:
        t0 = time.perf_counter()
        color, normal, depth, segs, tied = ref.render_forward(
            scene, args.size, args.size, args.spp, args.bounces, start)
        torch.save(dict(color=color.cpu(), normal=normal.cpu(), depth=depth.cpu(),
                        segs=int(segs.sum()), tied=tied.cpu()),
                   os.path.join(args.out, f"{args.scene}_{start}.pt"))
        print(json.dumps(dict(scene=args.scene, start=start, reference_s=time.perf_counter() - t0,
                              tied=int(tied.sum()))), flush=True)


def triangles(scene):
    """The table's valid triangles as 9 (1, T) components p0, e1, e2, each
    one's slot and each one's object."""
    K, L = scene.tre_tris.shape[0], scene.s_leaf_size
    comps = scene.tre_tris.view(K, 13, L)
    slots = torch.nonzero(scene.slot_obj.reshape(-1) >= 0).reshape(-1)
    objs = scene.slot_obj.reshape(-1)[slots].to(torch.float32)
    return [comps[:, c, :].reshape(-1)[slots][None, :] for c in range(9)], slots, objs


def brute(rows, act_p, tri, objs=None):
    """(live lane ids, brute-force closest t (BIG: none), its triangle's
    column, and with ``objs`` whether two objects meet it there) over the
    packed rows' live lanes, within [tmin, t]."""
    from tpupt_torch.accel import packets

    live = torch.nonzero(act_p.reshape(-1)).reshape(-1)
    best = torch.full(live.shape, BIG, device=live.device)
    col = torch.full(live.shape, -1, dtype=torch.int64, device=live.device)
    cross = torch.zeros(live.shape, dtype=torch.bool, device=live.device)
    for c0 in range(0, live.numel(), CHUNK):
        ids = live[c0:c0 + CHUNK]
        ray = {k: rows[k].reshape(-1)[ids][:, None]
               for k in ("rox", "roy", "roz", "rdx", "rdy", "rdz", "tmin")}
        ok, t = packets._dense_mt(tri, ray, rows["t"].reshape(-1)[ids][:, None])
        tm = torch.where(ok, t, BIG)
        b, j = tm.min(dim=1)
        best[c0:c0 + CHUNK] = b
        col[c0:c0 + CHUNK] = torch.where(b < BIG, j, -1)
        if objs is not None:
            at = (tm == b[:, None]) & (b < BIG)[:, None]
            hi = torch.where(at, objs[None, :], -1.0).amax(dim=1)
            lo = torch.where(at, objs[None, :], BIG).amin(dim=1)
            cross[c0:c0 + CHUNK] = (b < BIG) & (lo < hi)
    return live, best, col, cross


def slab(rows, lane, lo, hi):
    """The slab test of packed lane ``lane`` against one box (twin order,
    no tolerance): the six slab ts, near, far, and whether the lane
    passes."""
    o = [float(rows[k].reshape(-1)[lane]) for k in ("rox", "roy", "roz")]
    iv = [float(1.0 / rows[k].reshape(-1)[lane]) for k in ("rdx", "rdy", "rdz")]
    r = {}
    tt = torch.tensor
    ts = []
    for a in range(3):
        t0 = float((tt(lo[a]) - tt(o[a], dtype=torch.float32)) * tt(iv[a], dtype=torch.float32))
        t1 = float((tt(hi[a]) - tt(o[a], dtype=torch.float32)) * tt(iv[a], dtype=torch.float32))
        ts.append((t0, t1))
    near = max(min(t0, t1) for t0, t1 in ts)
    far = min(max(t0, t1) for t0, t1 in ts)
    tmin = float(rows["tmin"].reshape(-1)[lane])
    cap = float(rows["t"].reshape(-1)[lane])
    r.update(slabs=ts, near=near, far=far,
             passes=bool(far >= near and far >= tmin and near <= cap))
    return r


class Census:
    """Wraps the two sweeps of ``sweep_kernel`` for one render."""

    def __init__(self, scene, sk, n_pad, keep=6):
        self.scene, self.sk, self.n_pad, self.keep = scene, sk, n_pad, keep
        self.tri, self.slots, self.objs = triangles(scene)
        self.trip = 0
        self.closest_misses, self.anyhit_misses, self.anyhit_false = 0, 0, 0
        self.cross_ties = 0  # exact-t ties of two objects
        self.miss_pixels = {}  # pixel -> first (trip, kind)
        self.examples = []
        self.orig = (sk.treelet_closest_hit, sk.treelet_any_hit)

    def __enter__(self):
        self.sk.treelet_closest_hit, self.sk.treelet_any_hit = self.closest, self.any_hit
        return self

    def __exit__(self, *exc):
        self.sk.treelet_closest_hit, self.sk.treelet_any_hit = self.orig
        return False

    def example(self, kind, rows, act_p, lane, t_sweep, t_brute, col, twin_equal):
        k = int(self.slots[col]) // self.scene.s_leaf_size
        box = (self.scene.tre_min[k].tolist(), self.scene.tre_max[k].tolist())
        self.examples.append(dict(
            kind=kind, trip=self.trip, lane=lane, t_sweep=t_sweep, t_brute=t_brute, treelet=k,
            slot=int(self.slots[col]), box=box,
            ray=[float(rows[c].reshape(-1)[lane]) for c in
                 ("rox", "roy", "roz", "rdx", "rdy", "rdz", "tmin", "t")],
            exact_slab=slab(rows, lane, *box), kernel_equals_twin_on_packet=twin_equal))

    def packet_twin_equal(self, fn, twin, rows, act_p, lane, args):
        pk = lane // act_p.shape[1]
        sub = {k: v[pk:pk + 1].contiguous() for k, v in rows.items()}
        a = fn(sub, act_p[pk:pk + 1].contiguous(), *args)
        b = twin(sub, act_p[pk:pk + 1].contiguous(), *args)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def note(self, pixel, kind):
        self.miss_pixels.setdefault(pixel, (self.trip, kind))

    def closest(self, rows, act_p, *args, **kw):
        out = self.orig[0](rows, act_p, *args, **kw)
        n_pad = act_p.numel()
        live, best, col, cross = brute(rows, act_p, self.tri, self.objs)
        t_sw = out[0].reshape(-1)[live]
        miss = best < t_sw
        self.cross_ties += int(cross.sum())
        if bool(miss.any()):
            idx = torch.nonzero(miss).reshape(-1)
            self.closest_misses += int(idx.numel())
            for i in idx.tolist():
                lane = int(live[i])
                self.note(lane % n_pad, "closest")
                if len([e for e in self.examples if e["kind"] == "closest"]) < self.keep:
                    eq = self.packet_twin_equal(self.orig[0], self.sk.treelet_closest_hit_plain,
                                                rows, act_p, lane, args)
                    self.example("closest", rows, act_p, lane, float(t_sw[i]), float(best[i]),
                                 int(col[i]), eq)
        self.trip += 1
        return out

    def any_hit(self, rows, act_p, *args, **kw):
        occ = self.orig[1](rows, act_p, *args, **kw)
        live, best, col, _ = brute(rows, act_p, self.tri)
        got = occ.reshape(-1)[live]
        want = best < BIG
        miss, false = want & ~got, got & ~want
        self.anyhit_false += int(false.sum())
        n_pad = self.n_pad
        if bool(miss.any()):
            idx = torch.nonzero(miss).reshape(-1)
            self.anyhit_misses += int(idx.numel())
            for i in idx.tolist():
                lane = int(live[i])
                self.note(lane % n_pad, "any_hit")
                if len([e for e in self.examples if e["kind"] == "any_hit"]) < self.keep:
                    eq = self.packet_twin_equal(self.orig[1], self.sk.treelet_any_hit_plain,
                                                rows, act_p, lane, args)
                    self.example("any_hit", rows, act_p, lane, BIG, float(best[i]), int(col[i]),
                                 eq)
        return occ


def do_program(args):
    from tpupt_torch import render_image
    from tpupt_torch.accel import sweep_kernel
    from tpupt_torch.scene.json_parser import scene_from_json

    path = scene_path(args.scene)
    desc = scene_from_json(path, honor_background=args.scene == "cornell_box")
    scene = desc.build(leaf_size=32, device=args.device)
    n = args.size * args.size
    out = []
    for start in args.starts:
        want = torch.load(os.path.join(args.refs, f"{args.scene}_{start}.pt"))
        want = {k: v.to(args.device) if isinstance(v, torch.Tensor) else v
                for k, v in want.items()}
        with Census(scene, sweep_kernel, -(-n // 256) * 256) as census:
            t0 = time.perf_counter()
            buf, rays = render_image(scene, desc.camera, args.size, args.size, args.spp,
                                     max_bounces=args.bounces, rr_start=None,
                                     start_iteration=start)
            if args.device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = dict(color=buf.color, normal=buf.normal, depth=buf.depth, segs=int(rays))
        numbers = render_job.numbers(got, want)
        off = torch.zeros(n, dtype=torch.bool, device=args.device)
        for key in ("color", "normal", "depth"):
            off |= (got[key] != want[key]).reshape(n, -1).any(dim=1)
        tied_off = int((off & want["tied"]).sum())
        off &= ~want["tied"]
        pixels = torch.nonzero(off).reshape(-1).tolist()
        explained = {p: census.miss_pixels.get(p) for p in pixels[:50]}
        row = dict(scene=args.scene, start=start, numbers=numbers, wall_s=wall,
                   segments=[got["segs"], want["segs"]], tied=int(want["tied"].sum()),
                   tied_off=tied_off,
                   departing_pixels=pixels[:50], departing=len(pixels),
                   departing_with_a_miss=sum(1 for v in explained.values() if v is not None),
                   first_miss_of_departing=explained, trips=census.trip,
                   closest_misses=census.closest_misses, anyhit_misses=census.anyhit_misses,
                   cross_object_ties=census.cross_ties,
                   anyhit_false_occlusions=census.anyhit_false,
                   miss_pixels=len(census.miss_pixels), examples=census.examples,
                   details=compare.details(got, want))
        out.append(row)
        print(json.dumps({k: v for k, v in row.items() if k not in ("examples", "details",
                                                                   "first_miss_of_departing")}),
              flush=True)
        for ex in census.examples[:2]:
            print("  example " + json.dumps(ex), flush=True)
        del want, got, buf
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(out, fh)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("reference", "program"))
    p.add_argument("--scene", required=True, choices=("cornell_area", "cornell_box"))
    p.add_argument("--starts", required=True, type=lambda s: [int(x) for x in s.split(",")])
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=50)
    p.add_argument("--out", default=None)
    p.add_argument("--refs", default=None)
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.mode == "reference":
        do_reference(args)
    else:
        do_program(args)


if __name__ == "__main__":
    main()
