"""Sharding-machinery measurement (counterpart of ``tpupt/bench/scaling.py``).

The same total work (one image, its spp, its bounces) runs as one process
and as ``n`` ranks of a gloo group, each tracing one row band
(``dist.sharding``), all on one device: the card by default, which the
ranks share, or the CPU with ``--device cpu``.  The JAX package runs the
same comparison on a virtual CPU mesh inside one program; here the ranks
are processes, started by ``measure``.

  * ``efficiency_machinery`` = t_single / t_sharded: what sharding adds
    (per-rank programs, the band layout, the gather and the collectives)
    on the same device.  The ranks share it, so the ratio bounds the
    sharding machinery, not scaling across cards.
  * ``efficiency_machinery_fwdbwd`` / ``_overlap``: the same for one
    fwd+bwd step, the gradients all-reduced once (post-hoc) or per bounce
    (``overlap_grad_psum``).
  * ``efficiency_virtual`` = sharded rate / single rate / n.

The JAX package turns its differentiable-scan width ladder off here
(``TPUPT_DIFF_LADDER``); the port has no ladder, so there is nothing to
turn off.

    python -m tpupt_torch.bench.scaling [n_ranks] [--device cpu]

prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

# the JAX package's work: multi-second single-process calls, so the timed
# window dwarfs per-rank dispatch
SIZE, SPP, MAX_BOUNCES = 256, 4, 4


def _flagship_scene(mesh_subdiv: int = 3, device="cuda"):
    """Ground sphere + two instances of a blobby mesh (the bunny.json
    topology): the JAX package's entry-point fixture
    (``__graft_entry__._flagship_scene``, without its NEE lights), built on
    ``device``."""
    from tpupt_torch.core import math3d as m3
    from tpupt_torch.core.camera import make_camera
    from tpupt_torch.scene.description import SceneDescription
    from tpupt_torch.scene.procedural import bunny_substitute, icosphere

    d = SceneDescription()
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.8))
    d.add_material("bunny", "lambertian", albedo=(0.8, 0.8, 0.5))
    d.add_material("bunny2", "lambertian", albedo=(0.6, 0.4, 0.8))
    T = lambda t: np.asarray(m3.mat_translate(t), np.float64)
    S = lambda s: np.asarray(m3.mat_scale(s), np.float64)
    d.add_sphere(100.0, T([0, -100.5, -1.0]), "ground")
    v, f = bunny_substitute() if mesh_subdiv >= 4 else icosphere(mesh_subdiv, 0.5)
    d.add_mesh("bunny", v, f)
    d.add_mesh_object("bunny", T([1.0, -0.2, -2.0]), "bunny")
    d.add_mesh_object("bunny", S(0.5) @ T([-2.0, -0.5, -4.0]), "bunny2")
    return d.build(device=device), make_camera(vfov=np.deg2rad(60))


def _timed(fn, device, iters=3, min_seconds=2.0, group=None):
    """(seconds per call, last output): calls until at least ``iters`` and
    ``min_seconds`` are done, each fenced by a device sync.  With
    ``group``, every rank of it calls this and the stop decision is joint
    (``harness._timed``)."""
    from tpupt_torch.bench.harness import _all_reduce_max

    def fence():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    out = fn()
    fence()
    t0 = time.perf_counter()
    done = 0
    while True:
        out = fn()
        fence()
        done += 1
        secs = time.perf_counter() - t0
        stop = done >= iters and secs >= min_seconds
        if group is not None:
            stop = not _all_reduce_max(float(not stop), group)
        if stop:
            if group is not None:
                secs = _all_reduce_max(secs, group)
            return secs / done, out


def _rank(rank, n, port, device, size, spp, mb, min_seconds, results):
    """One rank: rank 0 times the single-process work while the others
    wait; then every rank times the sharded work; rank 0 puts the JSON
    dict on ``results``."""
    from tpupt_torch.diff.params import extract_params, with_params
    from tpupt_torch.dist.sharding import (
        init_distributed, make_tile_mesh, render_image_sharded, render_loss_and_grads_sharded,
    )
    from tpupt_torch.render.integrator import render_image

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"  # every rank is on this host
    init_distributed(f"localhost:{port}", n, rank, backend="gloo")
    try:
        scene, camera = _flagship_scene(mesh_subdiv=2, device=device)
        mesh = make_tile_mesh(n)
        timed = lambda fn, iters=3, group=None: _timed(fn, device, iters, min_seconds, group)
        target = torch.zeros((size * size, 3), device=device)
        params = extract_params(scene)

        def grad_single():
            buf, _ = render_image(with_params(scene, params), camera, size, size, spp,
                                  max_bounces=mb, differentiable=True)
            loss = torch.sum((buf.color - target) ** 2)
            leaves = [v for k, v in params.items() if k != "materials"]
            leaves += list(params["materials"].values())
            return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)

        if rank == 0:
            t1, (_, rays1) = timed(lambda: render_image(scene, camera, size, size, spp,
                                                        max_bounces=mb))
            rays1 = int(rays1)
            tg1, _ = timed(grad_single, iters=2)
        dist.barrier()
        tn, (_, raysn) = timed(lambda: render_image_sharded(scene, camera, size, size, spp, mesh,
                                                            max_bounces=mb), group=mesh)
        t_grads = {}
        for overlap in (True, False):
            t_grads[overlap], _ = timed(lambda: render_loss_and_grads_sharded(
                scene, camera, target, size, size, spp, mesh, max_bounces=mb,
                overlap_grad_psum=overlap), iters=2, group=mesh)
        if rank == 0:
            # same work: the RNG keys off global pixel ids
            if rays1 != int(raysn):
                raise RuntimeError(f"single-process rays {rays1} != sharded {int(raysn)}")
            t_overlap, t_posthoc = t_grads[True], t_grads[False]
            kind = (torch.cuda.get_device_name(torch.device(device))
                    if torch.device(device).type == "cuda" else "cpu")
            results.put({
                "devices": n,
                "physical_cores": os.cpu_count(),
                "work": f"{size}x{size} spp={spp} mb={mb} per call",
                "single_dev_s": round(t1, 3),
                "sharded_s": round(tn, 3),
                "single_dev_mrays": round(rays1 / t1 / 1e6, 3),
                "sharded_mrays": round(int(raysn) / tn / 1e6, 3),
                "efficiency_machinery": round(t1 / tn, 4),
                "efficiency_machinery_fwdbwd": round(tg1 / min(t_overlap, t_posthoc), 4),
                "efficiency_machinery_fwdbwd_overlap": round(tg1 / t_overlap, 4),
                "efficiency_virtual": round((int(raysn) / tn) / (rays1 / t1) / n, 4),
                "efficiency_ceiling_cores": round(os.cpu_count() / n, 4),
                "fwd_bwd_single_s": round(tg1, 4),
                "fwd_bwd_overlap_s": round(t_overlap, 4),
                "fwd_bwd_posthoc_s": round(t_posthoc, 4),
                "note": f"{n} gloo ranks share one device ({kind}), equal total work: the ratios "
                        "bound the sharding machinery (per-rank programs, band layout, gather, "
                        "collectives), not scaling across cards",
                "device": kind,
            })
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def measure(n: int, size: int = SIZE, spp: int = SPP, mb: int = MAX_BOUNCES, device="cuda",
            min_seconds: float = 2.0, timeout: float = 1800.0) -> dict:
    """Start ``n`` gloo ranks on ``device`` (the card unless the caller
    names another), measure, return rank 0's JSON dict."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to measure on the CPU")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, daemon=True,
                         args=(r, n, port, device, size, spp, mb, min_seconds, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                out = results.get(timeout=1.0)
                break
            except queue.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks gave no result (exit codes {failed})")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="ranks (default 8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n, device=args.device)))


if __name__ == "__main__":
    main()
