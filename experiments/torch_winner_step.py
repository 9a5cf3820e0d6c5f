"""winner_step on one NVIDIA GPU at chip_smoke.py phase 2's shapes, against
its twin, timed beside its FP32 bound.

    python experiments/torch_winner_step.py [--root DIR] [--reps 3] [--sweep]

``--root`` picks the checkout whose ``tpupt_torch`` is imported (e.g. the
parent commit's ``git archive`` under ``build/parent``), so two commits
are compared by running the script once for each, in turns, in one chip
call.  Inputs at phase 2's shape, from seed 0: sz = 4096 rows of p = 256
lanes and RL = 64 pairs, each pair a random triangle of bunny.json's
treelet table, each ray aimed at a triangle of its row.  Also RL = 61 (no
float4 path) and p = 1024.  Prints per shape the kernel's time by CUDA events (mean of 20
calls, ``--reps`` times), the bound (56 operations a pair at 67 TFLOP/s,
or the bytes at 3.35 TB/s) and the share; the last line of standard
output is one JSON object.  ``--sweep`` also builds the kernels with each
(threads per CTA, rays per thread) of SWEEP in place of ``kStepThreads``
and ``kStepRays`` (variants of the sources, ``torch_variant.py``, all
builds at once) and times each at the first shape, in turns.
"""

import argparse
import concurrent.futures
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

import torch_variant

PEAK_FLOPS, PEAK_BYTES, MT_FLOPS = 67e12, 3.35e12, 56
SWEEP = ((128, 1), (256, 1), (128, 2), (256, 2), (64, 4), (128, 4))


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


def phase2_inputs(scene, sz, p, rl, dev):
    """Rows of rl random triangles of the scene's treelet table and sz x p
    rays, each aimed at one of its row's triangles."""
    K, L = scene.tre_min.shape[0], scene.s_leaf_size
    rng = np.random.default_rng(0)
    slot_ids = rng.integers(0, K * L, (sz, rl))
    blocks = scene.tre_tris.view(K, 13, L)
    comps = blocks[torch.from_numpy(slot_ids // L).to(dev), :,
                   torch.from_numpy(slot_ids % L).to(dev)].permute(0, 2, 1).contiguous()
    j = torch.from_numpy(rng.integers(0, rl, (sz, p))).to(dev)
    tri = torch.gather(comps[:, :9, :], 2, j[:, None, :].expand(sz, 9, p))
    target = tri[:, 0:3] + 0.3 * tri[:, 3:6] + 0.3 * tri[:, 6:9]
    o = torch.from_numpy(rng.uniform(-3.0, 3.0, (sz, 3, p)).astype(np.float32)).to(dev)
    o[:, 1] += 2.0
    d = target - o
    d = (d / d.norm(dim=1, keepdim=True)).permute(0, 2, 1)
    o = o.permute(0, 2, 1)
    rows = {k: v.contiguous() for k, v in dict(
        rox=o[..., 0], roy=o[..., 1], roz=o[..., 2], rdx=d[..., 0], rdy=d[..., 1], rdz=d[..., 2],
        tmin=torch.full((sz, p), 1e-4, device=dev),
        t=torch.from_numpy(np.where(rng.random((sz, p)) < 0.2, 4.0, 3.0e38).astype(np.float32))
        .to(dev)).items()}
    slots = torch.from_numpy(slot_ids).int().to(dev)
    live = torch.from_numpy((rng.random((sz, rl)) < 0.9).astype(np.float32)).to(dev)
    return rows, comps, live, slots


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from tpupt_torch.accel import kernels, step_kernel
    from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
    from tpupt_torch.scene.json_parser import scene_from_json

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ensure_models(names=["bunny.obj"])
    desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", "bunny.json"))
    scene = desc.build(leaf_size=32, device=dev)
    report = {"card": card, "root": args.root}
    for sz, p, rl in ((4096, 256, 64), (4096, 256, 61), (1024, 1024, 64)):
        rows, comps, live, slots = phase2_inputs(scene, sz, p, rl, dev)
        out_k = step_kernel.winner_step(rows, comps, live, slots)
        out_p = step_kernel.winner_step_plain(rows, comps, live, slots)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert a.dtype == b.dtype and torch.equal(a, b), (sz, p, rl)
        ms = [event_ms(lambda: step_kernel.winner_step(rows, comps, live, slots))
              for _ in range(args.reps)]
        flops = sz * p * rl * MT_FLOPS
        nbytes = 4 * (sz * p * (8 + 6) + sz * rl * (13 + 2))
        bound_ms = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
        hits = int((out_k[0] < 3.0e38).sum())
        key = f"sz={sz},p={p},rl={rl}"
        report[key] = dict(ms=ms, bound_ms=bound_ms, share=[bound_ms / m for m in ms], hits=hits)
        print(f"{key}: equal to the twin ({hits} hit lanes); kernel "
              f"{', '.join(f'{m:.4f}' for m in ms)} ms; bound {bound_ms:.4f} ms, "
              f"{bound_ms / min(ms):.1%} at best  [{card}; {args.root}]")
    if args.sweep:
        subs = {tr: [("constexpr int kStepThreads = 128;", f"constexpr int kStepThreads = {tr[0]};"),
                     ("constexpr int kStepRays = 2;", f"constexpr int kStepRays = {tr[1]};")]
                for tr in SWEEP}
        with concurrent.futures.ThreadPoolExecutor(len(SWEEP)) as pool:
            paths = dict(zip(SWEEP, pool.map(functools.partial(torch_variant.build, kernels),
                                             subs.values())))
        libs = {tr: kernels.bind(path) for tr, path in paths.items()}
        default_load = kernels.load
        rows, comps, live, slots = phase2_inputs(scene, 4096, 256, 64, dev)
        want = step_kernel.winner_step_plain(rows, comps, live, slots)
        times = {tr: [] for tr in SWEEP}
        for order in (SWEEP, SWEEP[::-1]):
            for tr in order:
                kernels.load = lambda tr=tr: libs[tr]
                got = step_kernel.winner_step(rows, comps, live, slots)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), tr
                times[tr].append(event_ms(lambda: step_kernel.winner_step(rows, comps, live, slots)))
        kernels.load = default_load
        report["sweep"] = {f"threads={t},rays={r}": ms for (t, r), ms in times.items()}
        for (t, r), ms in times.items():
            print(f"sweep threads={t}, rays={r}: {', '.join(f'{m:.4f}' for m in ms)} ms; equal to the "
                  f"twin  [{card}]")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
