"""Benchmark harness for the BASELINE configs (counterpart of
``tpupt/bench/harness.py``): Mrays/s per config, rays being traced path
segments, plus the band-sharded variant of config 5.

    from tpupt_torch.bench.harness import run_config, CONFIGS
    result = run_config("bunny")          # on the card
    result = run_config("sphere", device="cpu")

Configs (the JAX package's ``CONFIGS``, value for value):
  1 sphere    - single sphere + ground, 128^2, 1 spp, 2 bounces
  2 cornell   - cornell.json, 512^2, 4 spp, 4 bounces, RR from bounce 2
  3 bunny     - bunny.json (OBJ mesh + BVH + treelets), 1024^2, 16 spp,
                50 bounces, RR 8
  4 diff      - the sphere scene at 1024^2: a 1-spp, 4-bounce
                differentiable render, the denoiser, grads to every leaf
  5 multimesh - multi_mesh.json 1024^2, 16 spp, 8 bounces, RR 4 (+ the
                band-sharded render when a process group of >1 rank is up)
  ajax        - ajax-white.json (81,920 triangles), 720x1280, 10 spp
  ajax_hi     - ajax-white-hi.json (327,680 triangles), 720x1280, 10 spp

Every scene is built on the card unless the caller names another device;
without a card the build raises, it never falls back to the CPU.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class BenchResult:
    name: str
    mrays_per_sec: float
    rays: int
    seconds: float
    extra: dict


# The JAX package's statistic: each window runs at least _MIN_WINDOW_S and
# at least ceil(iters / _N_WINDOWS) calls, at most _MAX_ITERS; the best of
# _N_WINDOWS windows is reported.  Only calls under 1 ms end a window at
# the call cap (the sphere config's take ~22 ms on an H100).
_MIN_WINDOW_S = 1.0
_N_WINDOWS = 5
_MAX_ITERS = 1000


def _all_reduce_max(value: float, group) -> float:
    """The largest ``value`` over the ranks of ``group``."""
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def _timed(fn, args, iters, group=None):
    """Fenced timer: a warm-up call, then _N_WINDOWS windows, each
    extended to >= _MIN_WINDOW_S and >= ceil(iters / _N_WINDOWS) calls (at
    most _MAX_ITERS); returns (total rays, total rays / the best window's
    rate).  That second number is an EQUIVALENT seconds, not a wall time:
    total rays over it is the best window's rate.  Each call fetches
    ``int(out[1])`` to the host, which on a CUDA tensor waits for the
    device.

    With ``group`` (a ``torch.distributed`` group that ``fn`` makes
    collectives in), every rank of it calls this with the same ``fn``: each
    window's stop decision is taken jointly (a MAX all-reduce of "go on"
    after each call), so every rank makes the same number of calls and the
    collectives pair up; a window's seconds are its slowest rank's."""
    out = fn(*args)
    int(out[1])  # fenced warm-up
    min_calls = max(1, -(-iters // _N_WINDOWS))
    rates, total_rays = [], 0
    for _ in range(_N_WINDOWS):
        t0 = time.perf_counter()
        w_rays, done = 0, 0
        while True:
            out = fn(*args)
            w_rays += int(out[1])
            done += 1
            secs = time.perf_counter() - t0
            stop = (done >= min_calls and secs >= _MIN_WINDOW_S) or done >= _MAX_ITERS
            if group is not None:
                stop = not _all_reduce_max(float(not stop), group)
            if stop:
                break
        if group is not None:
            secs = _all_reduce_max(secs, group)
        rates.append(w_rays / secs)
        total_rays += w_rays
    best = max(rates)
    return total_rays, total_rays / best


def _json_scene(filename, device, models=(), leaf_size=32):
    """A shipped scene JSON through the product path (parser, OBJ loader,
    BVH, treelet bake), built on ``device``; generates ``models`` first."""
    from tpupt_torch.scene.assets_gen import ensure_models, locate_asset_path
    from tpupt_torch.scene.json_parser import scene_from_json

    if models:
        ensure_models(names=list(models))
    desc = scene_from_json(os.path.join(locate_asset_path(), "scenes", filename))
    return desc.build(leaf_size=leaf_size, device=device), desc.camera


def _scene_cornell(device="cuda"):
    return _json_scene("cornell.json", device)


def _scene_sphere(device="cuda"):
    from tpupt_torch.core import math3d as m3
    from tpupt_torch.core.camera import make_camera
    from tpupt_torch.scene.description import SceneDescription

    d = SceneDescription()
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.0))
    d.add_material("ball", "lambertian", albedo=(0.1, 0.2, 0.5))
    d.add_sphere(100.0, np.asarray(m3.mat_translate([0, -100.5, -1])), "ground")
    d.add_sphere(0.5, np.asarray(m3.mat_translate([0, 0, -1])), "ball")
    return d.build(device=device), make_camera(vfov=np.pi / 2)


def _scene_bunny(leaf_size: int = 32, device="cuda"):
    """The product path of BASELINE config 3: bunny.json."""
    return _json_scene("bunny.json", device, ("bunny.obj",), leaf_size)


def _scene_multimesh(device="cuda"):
    return _json_scene("multi_mesh.json", device, ("bunny.obj", "blob.obj", "knot.obj"))


def _scene_ajax(device="cuda"):
    return _json_scene("ajax-white.json", device, ("ajax.obj",))


def _scene_ajax_hi(device="cuda"):
    """The reference's own ajax scale: 327,680 triangles, K = 14,782
    treelets."""
    return _json_scene("ajax-white-hi.json", device, ("ajax_hi.obj",))


def bench_forward(scene, camera, size, spp, max_bounces, iters, rr_start=None):
    from tpupt_torch.render.integrator import render_image

    w, h = (size, size) if isinstance(size, int) else size
    fn = partial(render_image, width=w, height=h, spp=spp, max_bounces=max_bounces,
                 rr_start=rr_start)
    return _timed(fn, (scene, camera), iters)


def bench_fwd_bwd(scene, camera, size, spp, max_bounces, iters, denoise=False):
    """fwd+bwd Mrays/s: a differentiable render, the loss sum(image^2)
    (through the denoiser at filter 4 with ``denoise``), its gradients to
    every ``extract_params`` leaf."""
    from tpupt_torch.denoise.atrous import atrous_denoise
    from tpupt_torch.diff.params import extract_params, with_params
    from tpupt_torch.render.integrator import render_image

    target = torch.zeros((size * size, 3), device=scene.device)

    def grad_fn(params, scene, camera):
        buf, rays = render_image(with_params(scene, params), camera, size, size, spp,
                                 max_bounces=max_bounces, differentiable=True)
        img = buf.color
        if denoise:
            img = atrous_denoise(buf.color.reshape(size, size, 3),
                                 buf.normal.reshape(size, size, 3),
                                 buf.depth.reshape(size, size), camera,
                                 filter_size=4).reshape(-1, 3)
        loss = torch.sum((img - target) ** 2)
        names = [k for k in params if k != "materials"]
        mats = params["materials"]
        grads = torch.autograd.grad(loss, [params[k] for k in names] + list(mats.values()),
                                    allow_unused=True, materialize_grads=True)
        out = dict(zip(names, grads))
        out["materials"] = dict(zip(mats, grads[len(names):]))
        return out, rays

    return _timed(grad_fn, (extract_params(scene), scene, camera), iters)


def bench_sharded(scene, camera, size, spp, max_bounces, iters, n_devices=None):
    """Rays/s with the image split into row bands over a process group
    (ranks [0, n_devices), the world by default); every rank of the world
    calls it.  As in the JAX package the sharded render runs without
    roulette.  Returns (rays, equivalent seconds, ranks)."""
    from tpupt_torch.dist.sharding import make_tile_mesh, render_image_sharded

    mesh = make_tile_mesh(n_devices)

    def fn(scene, camera):
        return render_image_sharded(scene, camera, size, size, spp, mesh,
                                    max_bounces=max_bounces)

    rays, secs = _timed(fn, (scene, camera), iters, group=mesh)
    return rays, secs, dist.get_world_size(mesh)


CONFIGS = {
    "sphere": dict(scene=_scene_sphere, size=128, spp=1, mb=2, rr=None),
    "cornell": dict(scene=_scene_cornell, size=512, spp=4, mb=4, rr=2),
    "bunny": dict(scene=_scene_bunny, size=1024, spp=16, mb=50, rr=8),
    # config 4: the sphere scene, not a fit of bunny.json
    "diff": dict(scene=_scene_sphere, size=1024, spp=1, mb=4, rr=None),
    "multimesh": dict(scene=_scene_multimesh, size=1024, spp=16, mb=8, rr=4),
    # (width, height): the reference's 720x1280 portrait, its 10 spp
    "ajax": dict(scene=_scene_ajax, size=(720, 1280), spp=10, mb=50, rr=8),
    "ajax_hi": dict(scene=_scene_ajax_hi, size=(720, 1280), spp=10, mb=50, rr=8),
}


def run_config(name: str, iters: int = 3, size: int | None = None,
               device="cuda") -> BenchResult:
    """One config on ``device`` (the card unless the caller names
    another).  For "multimesh" inside a process group of more than one
    rank (every rank calls this), also the band-sharded render, in
    ``extra``: sharded_mrays, devices and scaling_eff."""
    cfg = CONFIGS[name]
    scene, camera = cfg["scene"](device=device)
    sz = size or cfg["size"]
    extra = {}
    if name == "diff":
        rays, secs = bench_fwd_bwd(scene, camera, sz, cfg["spp"], cfg["mb"], iters, denoise=True)
    else:
        rays, secs = bench_forward(scene, camera, sz, cfg["spp"], cfg["mb"], iters, cfg["rr"])
    if name == "multimesh" and dist.is_initialized() and dist.get_world_size() > 1:
        s_rays, s_secs, nd = bench_sharded(scene, camera, sz, cfg["spp"], cfg["mb"], iters)
        extra["sharded_mrays"] = s_rays / s_secs / 1e6
        extra["devices"] = nd
        extra["scaling_eff"] = (s_rays / s_secs) / (rays / secs) / nd
    return BenchResult(name, rays / secs / 1e6, rays, secs, extra)
