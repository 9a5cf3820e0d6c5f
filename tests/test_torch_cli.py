"""The port's CLI (``python -m tpupt_torch.cli``) end to end, in a
subprocess on the CPU (``--device cpu``), held against the port's own
``PathTracer`` on the same scene in this process (the JAX package's CLI
takes minutes per run here; ``test_torch_progressive.py`` holds the
engine against the JAX package's).  The written PNG must decode, by a
zlib decoder and by Pillow, to exactly the tracer's ``display`` image:
both run the same torch code on the same inputs.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_utils import _decode_png
from tpupt_torch import PathTracer
from tpupt_torch.scene.json_parser import scene_from_json

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNCES = 4


def _run_cli(args, timeout=240, device="cpu"):
    env = dict(os.environ, PYTHONPATH=REPO)
    extra = ["--device", device] if device else []
    return subprocess.run(
        [sys.executable, "-m", "tpupt_torch.cli", *args, *extra],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    """test_cli.py's scene: a ground sphere and a fuzzy metal ball, 32x24,
    2 spp."""
    p = tmp_path_factory.mktemp("scene") / "tiny.json"
    p.write_text(json.dumps({
        "camera": {"vfov": 90, "resolution": [32, 24]},
        "sampler": {"samples": 2},
        "materials": [
            {"type": "lambertian", "name": "g", "albedo": [0.8, 0.8, 0.0]},
            {"type": "metal", "name": "m", "albedo": [0.9, 0.8, 0.7], "fuzz": 0.2},
        ],
        "surfaces": [
            {"type": "sphere", "transform": {"translate": [0, -100.5, -1]},
             "radius": 100.0, "material": "g"},
            {"type": "sphere", "transform": {"translate": [0, 0, -1]},
             "radius": 0.5, "material": "m"},
        ],
    }))
    return str(p)


def _tracer(path, method="megakernel"):
    desc = scene_from_json(path)
    return PathTracer(desc.build(device="cpu"), desc.resolution, max_bounces=BOUNCES,
                      method=method), desc.camera


def _read_png(path):
    with open(path, "rb") as fh:
        img = _decode_png(fh.read())
    from PIL import Image  # present here, not a dependency of the port

    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    return img


def _jax_stats_keys():
    """The keys of the stats JSON that the JAX package's CLI writes, read
    from its source (the dict literal handed to json.dump)."""
    with open(os.path.join(REPO, "tpupt", "cli", "main.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dump"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dump of a dict literal in the JAX CLI")


def test_cli_renders_png_with_stats(tiny_scene, tmp_path):
    out, stats = tmp_path / "out.png", tmp_path / "stats.json"
    r = _run_cli([tiny_scene, "-o", str(out), "--max-bounces", str(BOUNCES), "--denoise",
                  "--stats-json", str(stats)])
    assert r.returncode == 0, r.stderr
    for stage in ("Scene loading", "Device init", "Initialization", "Path tracing",
                  "Denoising", "Image writing"):
        assert f"{stage} time:" in r.stdout, stage
    assert "Mrays/s" in r.stdout and "device: cpu" in r.stdout
    s = json.loads(stats.read_text())
    assert set(s) == _jax_stats_keys()
    assert s["spp"] == 2 and s["resolution"] == [32, 24]
    assert set(s["stages"]) >= {"Path tracing", "Denoising"}
    assert s["mrays_per_sec_steady"] > 0 and s["first_dispatch_secs"] > 0

    tracer, cam = _tracer(tiny_scene)
    rays = tracer.path_trace_many(cam, 2)
    tracer.denoise(cam)
    assert s["rays"] == rays > 32 * 24
    img = _read_png(out)
    assert img.shape == (24, 32, 3)
    np.testing.assert_array_equal(img, tracer.display("final"))


def test_cli_streaming(tiny_scene, tmp_path):
    out, stats = tmp_path / "out.png", tmp_path / "stats.json"
    r = _run_cli([tiny_scene, "-o", str(out), "--max-bounces", str(BOUNCES), "--method",
                  "streaming", "--stats-json", str(stats)])
    assert r.returncode == 0, r.stderr
    tracer, cam = _tracer(tiny_scene, "streaming")
    rays = tracer.path_trace_many(cam, 2)
    assert json.loads(stats.read_text())["rays"] == rays
    np.testing.assert_array_equal(_read_png(out), tracer.display("final"))
    mega, _ = _tracer(tiny_scene)
    assert mega.path_trace_many(cam, 2) == rays  # the same paths in both modes


def test_cli_checkpoint_resume(tiny_scene, tmp_path):
    """--spp 1 with a checkpoint, then the scene's 2 spp from it: the
    second run resumes at iteration 1 and renders one more sample, and the
    image is that of two chunks of one sample."""
    out, ckpt = tmp_path / "out.png", tmp_path / "ckpt.npz"
    stats = tmp_path / "stats.json"
    common = [tiny_scene, "-o", str(out), "--max-bounces", str(BOUNCES), "--checkpoint",
              str(ckpt), "--stats-json", str(stats)]
    r1 = _run_cli(common + ["--spp", "1"])
    assert r1.returncode == 0, r1.stderr
    rays1 = json.loads(stats.read_text())["rays"]
    r2 = _run_cli(common + ["--display", "depth"])
    assert r2.returncode == 0, r2.stderr
    assert "Resumed from" in r2.stdout and "at iteration 1" in r2.stdout
    rays2 = json.loads(stats.read_text())["rays"]
    with np.load(ckpt) as data:
        assert int(data["iteration"]) == 2

    tracer, cam = _tracer(tiny_scene)
    assert (tracer.path_trace_many(cam, 1), tracer.path_trace_many(cam, 1)) == (rays1, rays2)
    np.testing.assert_array_equal(_read_png(out), tracer.display("depth"))


def test_cli_profile_writes_a_trace(tiny_scene, tmp_path):
    """--profile DIR: a torch.profiler Chrome trace of the path-tracing
    stage (host operations only on the CPU)."""
    trace_dir = tmp_path / "trace"
    r = _run_cli([tiny_scene, "-o", str(tmp_path / "o.png"), "--spp", "1", "--max-bounces", "2",
                  "--profile", str(trace_dir)])
    assert r.returncode == 0, r.stderr
    with open(trace_dir / "path_tracing_trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e.get("name", "").startswith("aten::")
               for e in events)


def test_cli_rejects_non_json(tmp_path):
    r = _run_cli(["scene.txt", "-o", str(tmp_path / "o.png")], timeout=60)
    assert r.returncode != 0
    assert "json" in (r.stderr + r.stdout).lower()


def test_cli_missing_scene(tmp_path):
    r = _run_cli(["nope_does_not_exist.json", "-o", str(tmp_path / "o.png")], timeout=60)
    assert r.returncode != 0
    assert "Cannot find scene file" in (r.stderr + r.stdout)


def test_cli_needs_a_card_unless_told(tiny_scene, tmp_path):
    """With no --device the CLI renders on the card; without one it exits
    non-zero and writes nothing rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the card-less exit")
    out = tmp_path / "o.png"
    r = _run_cli([tiny_scene, "-o", str(out)], timeout=60, device=None)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert not out.exists()
