"""The lit mesh cell, ``cornell_box.render``: the sweep's counting rule
against a hand count, the cell's readers on a synthetic trace, the
repairs of its plain reference (``reference/pathtrace_scene.py``), and
the cell's files through ``run.run_cell`` on the CPU at a small
traffic."""

import json
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from h100bench import counting_sweep, run
from h100bench.tests.helpers import bench, cell
from h100bench.trace import Reduced

CELL = "cornell_box.render"
SMALL = dict(job="lit_render", width=16, height=16, spp=2, max_bounces=8, rr_start=None,
             first_sample_modulus=1048576, trace_jobs=2, check_rows=4)
# the readers of the device trace in the cell: its own, then the render
# cell's that the cell's name was appended to
READERS = ("sweep_ms.cornell_box", "sweep_roofline.cornell_box", "nee_ms.cornell_box",
           "trips_per_render", "trip_kernels_ms.render", "trip_kernels_roofline",
           "device_idle_pct.render")


def _reader(name):
    return run.load_file(f"{run.HERE}/metrics/{name}.py")


def test_sweep_count_is_the_hand_count():
    """One packet, two live lanes, one treelet of two triangles that both
    lanes' boxes meet: one slab test a lane and one visit of the treelet's
    two triangles (its 30 pad slots not counted); the bytes of every
    lane's mask and outputs, the live lanes' rows and the treelet's box and
    block."""
    from tpupt_torch.accel import sweep_kernel
    from tpupt_torch.scene.description import SceneDescription

    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=(0.5, 0.5, 0.5))
    quad = torch.tensor([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=torch.float32)
    d.add_mesh("quad", quad.numpy(), torch.tensor([[0, 1, 2], [0, 2, 3]]).int().numpy())
    d.add_mesh_object("quad", torch.eye(4).double().numpy(), "m")
    scene = d.build(leaf_size=32, device="cpu")
    rows = {k: torch.zeros(1, 256) for k in ("rox", "roy", "roz", "rdx", "rdy", "rdz", "tmin")}
    rows["roz"][:] = 2.0
    rows["rdx"][:], rows["rdy"][:], rows["rdz"][:] = 0.0, 0.0, -1.0
    rows["rox"][0, 1] = 0.5
    act = torch.zeros(1, 256, dtype=torch.bool)
    act[0, :2] = True
    rows["t"] = torch.where(act, 3.0e38, -3.0e38)
    tre = (scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
    sums = counting_sweep.count_sweeps(lambda: sweep_kernel.treelet_closest_hit(rows, act, *tre))
    c = sums["treelet_closest_hit"]
    assert c["launches"] == 1
    assert c["bytes"] == 256 * (1 + 24) + 2 * 32 + 1 * (6 + 13 * 32) * 4
    assert c["flops"] == 2 * 1 * 27 + 2 * 2 * 56
    assert c["bound_ms"] == pytest.approx(max(c["flops"] / 67e12, c["bytes"] / 3.35e12) * 1e3)


def test_readers_on_a_synthetic_trace():
    """Each reader on a trace of two renders: the kernels' device ms a
    render, their counted bound over it, trips a render, the idle share;
    None where the trace holds nothing to read."""
    ops = {"void (anonymous namespace)::trip_head_kernel<true>(A)": [20, 0.002],
           "void (anonymous namespace)::trip_nee_kernel(A)": [20, 0.006],
           "void (anonymous namespace)::trip_tail_kernel<true>(A)": [20, 0.004],
           "void (anonymous namespace)::treelet_closest_hit_kernel<false>(A)": [20, 0.010],
           "void (anonymous namespace)::treelet_any_hit_walk_kernel(A)": [20, 0.002]}
    counts = {"trip_head": dict(bound_ms=0.5), "trip_nee": dict(bound_ms=1.0),
              "trip_tail": dict(bound_ms=1.5), "treelet_closest_hit": dict(bound_ms=1.25)}
    ctx = SimpleNamespace(jobs=2, window_s=0.1, counts=counts,
                          trace=Reduced(ops=ops, busy_s=0.025))
    got = {n: _reader(n).read(ctx) for n in READERS}
    assert got["sweep_ms.cornell_box"] == pytest.approx(5.0)
    assert got["sweep_roofline.cornell_box"] == pytest.approx(25.0)
    assert got["nee_ms.cornell_box"] == pytest.approx(4.0)
    assert got["trips_per_render"] == 10
    assert got["trip_kernels_ms.render"] == pytest.approx(6.0)
    assert got["trip_kernels_roofline"] == pytest.approx(50.0)
    assert got["device_idle_pct.render"] == pytest.approx(75.0)
    empty = SimpleNamespace(jobs=2, window_s=0.1, counts={}, trace=Reduced())
    assert all(_reader(n).read(empty) is None for n in READERS)
    # every per-layer metric of the cell has its reader
    names = {m["name"] for m in bench()["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert set(READERS) <= names
    assert names - set(READERS) == {"trip_sweep_issue_ms.cornell_box", "trip_wait_ms.render",
                                    "trip_issue_ms.render", "trip_lane_occupancy.render"}


def test_cell_runs_from_its_files():
    """The cell's configuration, models, traffic, job and limits through
    ``run_cell`` on the CPU at 16x16: correct untraced and traced; the
    traced run reads the span and counter metrics (the device ones need a
    card), and the counting job counts one sweep a trip."""
    from tpupt_torch.utils import trace

    b, c = bench(), cell(CELL)
    assert c["chips"] == 1 and c["traffic"] == "render_2048x2048_16spp"
    plain = run.run_cell(b, c, 2**31 + 991, 0.0, False, device="cpu", traffic=SMALL,
                         t_start=time.perf_counter())
    assert plain["correct"] and plain["checks"]["pixels_off"]["value"] == 0.0
    assert set(plain["metrics"]) == {"render_mrays_per_s", "peak_mem_gib", "setup_s"}
    trace.reset()
    traced = run.run_cell(b, c, 2**31 + 991, 0.0, True, device="cpu", traffic=SMALL,
                          t_start=time.perf_counter())
    assert traced["correct"]
    assert {"trip_sweep_issue_ms.cornell_box", "trip_lane_occupancy.render",
            "trip_wait_ms.render", "trip_issue_ms.render"} <= set(traced["metrics"])
    from h100bench.jobs import lit_render

    config = run.load_json(run.HERE, "configs", "cornell_box.json")
    job = lit_render.Job(run.prepare(run.ROOT, config), config, SMALL, 5, "cpu")
    counts = job.count(1)
    assert counts["treelet_closest_hit"]["launches"] == counts["trip_nee"]["launches"] > 0
    assert counts["treelet_closest_hit"]["bound_ms"] > 0


def _scene_file(tmp_path, surfaces, background=None):
    """A scene of two mesh objects for the reference: a quad of 2 triangles
    at z = 0 and a box of 12 (the configuration's unit cube) above it."""
    models = os.path.join(run.HERE, "models")
    j = dict(camera=dict(transform={"from": [0.5, 0.5, 5], "at": [0.5, 0.5, 0], "up": [0, 1, 0]},
                         vfov=40, resolution=[8, 8]),
             materials=[dict(type="lambertian", name="w", albedo=[0.7, 0.7, 0.7])],
             surfaces=[dict(type="mesh", filename=os.path.join(models, f), material="w",
                            transform=t) for f, t in surfaces])
    if background is not None:
        j["background"] = background
    path = os.path.join(str(tmp_path), "scene.json")
    with open(path, "w") as fh:
        json.dump(j, fh)
    return path


def test_reference_repairs(tmp_path):
    """``pathtrace_scene``: the "background" color in place of the sky; a
    hit's rows picked in its own object where another has fewer
    triangles (``pathtrace.py`` fails there); a closest t that two
    objects share flagged tied; nothing of the program or JAX loaded, and
    ``pathtrace`` itself unchanged."""
    import torch

    from h100bench.reference import pathtrace, pathtrace_scene as ps

    floor = ("cornell_box_floor.obj", {"scale": [1 / 555, 1 / 555, 1 / 555]})
    box = ("unit_box.obj", [{"scale": [0.5, 0.5, 0.5]}, {"translate": [0.25, 0, 0.25]}])
    path = _scene_file(tmp_path, [box, floor], background=[0.25, 0.5, 0.75])
    scene = ps.load_scene(path, "cpu")
    assert [len(t["p0"][0]) for t in scene.inst] == [12, 2]
    assert scene.leaves["bg_down"].tolist() == scene.leaves["bg_up"].tolist() == [0.25, 0.5, 0.75]
    assert pathtrace.load_scene(path, "cpu").leaves["bg_down"].tolist() == pytest.approx([0.5, 0.7, 1.0])
    # rays down onto the floor beside the box: the floor (object 1) wins
    # with a triangle index below the box's 12, rays onto the box top with
    # one of the box's
    n = 4
    x = torch.tensor([0.1, 0.9, 0.5, 0.4])
    z = torch.tensor([0.1, 0.9, 0.5, 0.6])
    V3 = ps.V3
    ro, rd = V3(x, torch.full((n,), 2.0), z), V3(torch.zeros(n), -torch.ones(n), torch.zeros(n))
    hit = ps.closest_hit(scene, scene.leaves, ro, rd, torch.full((n,), 1e-4),
                         torch.ones(n, dtype=torch.bool), scene.inst)
    assert hit["obj"].tolist() == [1, 1, 0, 0]
    plain = pathtrace.load_scene(path, "cpu")
    with pytest.raises(IndexError):  # the box top's triangles 8, 9 past the floor's 2
        pathtrace.closest_hit(plain, plain.leaves, ro, rd, torch.full((n,), 1e-4),
                              torch.ones(n, dtype=torch.bool), plain.inst)
    assert hit["normal"].y.tolist() == [1.0, 1.0, 1.0, 1.0]
    # a ray up from inside the box's footprint meets the box's bottom face
    # and the floor at exactly one t: tied
    ties = torch.zeros(1, dtype=torch.bool)
    up = ps.closest_hit(scene, scene.leaves, V3(*(torch.tensor([v]) for v in (0.5, -1.0, 0.5))),
                        V3(*(torch.tensor([v]) for v in (0.0, 1.0, 0.0))), torch.tensor([1e-4]),
                        torch.ones(1, dtype=torch.bool), scene.inst, ties)
    assert float(up["t"][0]) == 1.0 and bool(ties[0])
    assert not any(m.split(".")[0] in ("jax", "tpupt") for m in sys.modules
                   if m.startswith(("jax", "tpupt.")))
