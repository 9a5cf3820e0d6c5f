"""Small traffic mixes and a run of a cell on the CPU for the tests, and
a small lit scene with meshes for the reference's mesh and NEE paths."""

from __future__ import annotations

import json
import time

from h100bench import run

SMALL = {
    "three_balls.render": dict(job="render", width=24, height=16, spp=2, max_bounces=50,
                               rr_start=None, first_sample_modulus=1048576, trace_jobs=2,
                               check_rows=4),
    "three_balls.grad": dict(job="grad", width=12, height=12, spp=2, max_bounces=8,
                             rr_start=None, first_sample_modulus=1048576, trace_jobs=2),
}

# a unit quad in the XZ plane about the origin: two triangles
PANEL_OBJ = "v -0.5 0 -0.5\nv 0.5 0 -0.5\nv 0.5 0 0.5\nv -0.5 0 0.5\nf 1 2 3\nf 1 3 4\n"

LIT_SCENE = {
    "camera": {"transform": {"from": [0, 1.0, 3.2], "at": [0, 0.6, 0], "up": [0, 1, 0]},
               "vfov": 50, "resolution": [16, 16]},
    "sampler": {"samples": 2},
    "materials": [{"type": "lambertian", "name": "white", "albedo": [0.73, 0.73, 0.73]},
                  {"type": "metal", "name": "mirror", "albedo": [0.9, 0.9, 0.9], "fuzz": 0.02},
                  {"type": "dielectric", "name": "glass", "refraction_index": 1.5},
                  {"type": "diffuse_light", "name": "lamp", "emit": [18.0, 16.5, 14.0]}],
    "surfaces": [{"type": "sphere", "transform": {"translate": [0, -1000, 0]}, "radius": 1000.0,
                  "material": "white"},
                 {"type": "sphere", "transform": {"translate": [-0.5, 0.45, -0.3]},
                  "radius": 0.45, "material": "mirror"},
                 {"type": "sphere", "transform": {"translate": [0.5, 0.45, 0.3]},
                  "radius": 0.45, "material": "glass"},
                 {"type": "mesh", "filename": "../models/panel.obj", "material": "white",
                  "transform": [{"rotate": 90, "axis": [1, 0, 0]}, {"scale": 2.0},
                                {"translate": [0, 1, -1.5]}]},
                 {"type": "mesh", "filename": "../models/panel.obj", "material": "lamp",
                  "transform": [{"scale": [0.9, 1.0, 0.9]}, {"translate": [0, 1.98, 0]}]}]}


def write_lit_scene(root) -> str:
    """LIT_SCENE and its model under ``root``; returns the scene's path."""
    (root / "models").mkdir(parents=True, exist_ok=True)
    (root / "scenes").mkdir(parents=True, exist_ok=True)
    (root / "models" / "panel.obj").write_text(PANEL_OBJ)
    path = root / "scenes" / "lit.json"
    path.write_text(json.dumps(LIT_SCENE))
    return str(path)


def bench():
    return run.load_json(run.ROOT, "BENCHMARK.json")


def cell(name):
    return next(w for w in bench()["workloads"] if w["name"] == name)


def run_small(name, seed=2**31 + 77, trace=False, seconds=0.0):
    return run.run_cell(bench(), cell(name), seed, seconds, trace, device="cpu",
                        traffic=SMALL[name], t_start=time.perf_counter())
