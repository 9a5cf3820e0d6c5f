"""A configuration with a model of its own, a traffic mix, a per-layer
metric and a cell's limits added as new files, with entries in
BENCHMARK.json, run with no edit to any file the harness already has."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from h100bench import run
from h100bench.tests.helpers import PANEL_OBJ

SCENE = {"camera": {"vfov": 40, "resolution": [16, 16]}, "sampler": {"samples": 2},
         "materials": [{"type": "lambertian", "name": "white", "albedo": [0.7, 0.7, 0.7]},
                       {"type": "metal", "name": "steel", "albedo": [0.8, 0.8, 0.9], "fuzz": 0.1}],
         "surfaces": [{"type": "sphere", "transform": {"translate": [0, -100.5, -1]},
                       "radius": 100.0, "material": "white"},
                      {"type": "mesh", "filename": "../models/panel.obj",
                       "transform": [{"rotate": 90, "axis": [1, 0, 0]},
                                     {"translate": [0, 0, -2]}], "material": "steel"}]}


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_from_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "h100bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digest(root / "h100bench")
    hb = root / "h100bench"
    (hb / "models").mkdir(exist_ok=True)
    (hb / "models" / "panel.obj").write_text(PANEL_OBJ)
    (hb / "configs" / "mirror_quad.json").write_text(json.dumps(dict(
        name="mirror_quad", scene=SCENE, scene_file="mirror_quad.json", models=["panel.obj"],
        leaf_size=32, reference="pathtrace")))
    (hb / "traffic" / "render_16sq_2spp.json").write_text(json.dumps(dict(
        job="render", width=16, height=16, spp=2, max_bounces=8, rr_start=None,
        first_sample_modulus=1024, trace_jobs=2)))
    (hb / "metrics" / "segments_per_job.render.py").write_text(
        "def read(ctx):\n    return float(ctx.jobs)\n")
    (hb / "limits" / "mirror_quad.render.json").write_text(json.dumps(dict(
        limits=dict(pixels_off=0.0, segments_gap=0.0))))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="mirror_quad", source="test", file="h100bench/configs/"
                                 "mirror_quad.json", reduced=[], why="test"))
    bench["workloads"].append(dict(name="mirror_quad.render", config="mirror_quad",
                                   traffic="render_16sq_2spp", chips=1, why="test"))
    bench["per_layer"].append(dict(name="segments_per_job.render", unit="jobs", better="higher",
                                   source="program_counter", layer="test",
                                   moves="render_mrays_per_s", workloads=["mirror_quad.render"]))
    for m in bench["end_to_end"]:
        if m["name"] == "render_mrays_per_s":
            m["workloads"].append("mirror_quad.render")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time\nfrom h100bench import run\n"
            "b = run.load_json(run.ROOT, 'BENCHMARK.json')\n"
            "c = [w for w in b['workloads'] if w['name'] == 'mirror_quad.render'][0]\n"
            "out = [run.run_cell(b, c, 5, 0.0, t, device='cpu', t_start=time.perf_counter())"
            " for t in (False, True)]\n"
            "print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=run.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"render_mrays_per_s", "peak_mem_gib", "setup_s"}
    assert traced["metrics"]["segments_per_job.render"]["value"] == traced["attempted"]
    after = _digest(hb)
    assert {k: after[k] for k in before} == before
