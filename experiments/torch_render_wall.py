"""Host-side cost of the port's bunny render, two checkouts in one process.

    python experiments/torch_render_wall.py --roots DIR_A DIR_B [--labels A B] [--reps N]

Imports ``tpupt_torch`` from each DIR as a module tree of its own (the
trees take turns in ``sys.modules``; each loads its own kernel library),
builds bunny.json on the card with each, and renders it as chip_smoke.py's
main path does (1024^2, 16 spp, 50 bounces, RR from bounce 8): once per
tree to warm up, then N times per tree, the order alternating A B, B A,
... so that both trees see the same host.  For each timed render it
records the wall time (ending in a device sync), the process's CPU time
and the host time spent inside the closest-hit wrapper
(``sweep_kernel.treelet_closest_hit``: argument checks and the launch; it
does not wait for the card).  Prints one JSON line per tree with those
lists, then one with the pairwise comparison, the host's load average and
the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PKG = "tpupt_torch"


def _ours(name):
    return name == PKG or name.startswith(PKG + ".")


class Tree:
    """One checkout's ``tpupt_torch``, its scene and its timed wrapper."""

    def __init__(self, root, label, dev):
        self.root, self.label = os.path.abspath(root), label
        self.modules = {}
        with self.active():
            import tpupt_torch
            from tpupt_torch.accel import sweep_kernel
            from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
            from tpupt_torch.scene.json_parser import scene_from_json

            assert tpupt_torch.__file__.startswith(self.root + os.sep), tpupt_torch.__file__
            ensure_models(names=["bunny.obj"])
            self.desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
            self.scene = self.desc.build(leaf_size=32, device=dev)
            self.render_image = tpupt_torch.render_image
            # intersect_treelets looks the wrapper up at each call; an older
            # checkout's wrapper counts its launches on the module's name
            wrapped = sweep_kernel.treelet_closest_hit
            self.in_wrapper = 0.0

            def timed(*a, **k):
                t0 = time.perf_counter()
                out = wrapped(*a, **k)
                self.in_wrapper += time.perf_counter() - t0
                return out

            timed.launches = 0
            sweep_kernel.treelet_closest_hit = timed
        self.dev = dev
        self.rec = {k: [] for k in ("wall_s", "cpu_s", "wrapper_s")}

    def active(self):
        tree = self

        class _Active:
            def __enter__(self):
                for name in [m for m in sys.modules if _ours(m)]:
                    del sys.modules[name]
                sys.modules.update(tree.modules)
                sys.path.insert(0, tree.root)

            def __exit__(self, *exc):
                sys.path.remove(tree.root)
                tree.modules = {m: mod for m, mod in sys.modules.items() if _ours(m)}

        return _Active()

    def render(self, record=True):
        with self.active():
            self.in_wrapper = 0.0
            torch.cuda.synchronize()
            c0, t0 = time.process_time(), time.perf_counter()
            _buf, rays = self.render_image(self.scene, self.desc.camera, 1024, 1024, spp=16,
                                           max_bounces=50, rr_start=8, device=self.dev)
            torch.cuda.synchronize()
            t1, c1 = time.perf_counter(), time.process_time()
        if record:
            self.rec["wall_s"].append(t1 - t0)
            self.rec["cpu_s"].append(c1 - c0)
            self.rec["wrapper_s"].append(self.in_wrapper)
        return int(rays)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs=2, required=True)
    ap.add_argument("--labels", nargs=2, default=["a", "b"])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    a, b = (Tree(r, lab, dev) for r, lab in zip(args.roots, args.labels))
    rays = {t.render(record=False) for t in (a, b)}
    assert len(rays) == 1, rays
    load_before = os.getloadavg()
    for i in range(args.reps):
        for t in ((a, b) if i % 2 == 0 else (b, a)):
            assert t.render() in rays
    for t in (a, b):
        print(json.dumps(dict(label=t.label, root=t.root, median_wall_s=float(np.median(t.rec["wall_s"])),
                              **t.rec)))
    wa, wb = np.array(a.rec["wall_s"]), np.array(b.rec["wall_s"])
    print(json.dumps(dict(
        card=card, rays=rays.pop(), reps=args.reps, cpus=os.cpu_count(),
        loadavg_before=load_before, loadavg_after=os.getloadavg(),
        median_s={a.label: float(np.median(wa)), b.label: float(np.median(wb))},
        quartiles_s={a.label: np.percentile(wa, [25, 75]).tolist(),
                     b.label: np.percentile(wb, [25, 75]).tolist()},
        pairs_b_faster=int((wb < wa).sum()),
        median_ratio_b_over_a=float(np.median(wb / wa)),
    )))


if __name__ == "__main__":
    main()
