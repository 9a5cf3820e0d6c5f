"""The program's spans, counters and launch counts
(``tpupt_torch/utils/trace.py``), in the two render loops and as the
benchmark's per-layer metrics read them.

* With no profiler active a span opens no ``record_function``, reads no
  clock and records no CUDA event, and nothing is aggregated; a lit mesh
  render still asks for its sweep and NEE spans on every trip.
* Under the profiler a lit mesh render records one ``tpupt.trip.sweep``
  and one ``tpupt.trip.nee`` a trip, inside that trip's
  ``tpupt.trip.issue``.
* Under ``torch.profiler`` a 16x16, 2-spp trip-route render on the CPU
  twins counts one ``tpupt.trip.wait`` a ``trip_tail`` call, the lanes
  live at each trip's start summing to the render's segments, and every
  lane a trip launched over; a differentiable
  render and its gradient one ``tpupt.sample.plan``, ``tpupt.diff.start``
  and ``tpupt.diff.backward`` a sample and one ``tpupt.diff.wait`` a
  bounce; the spans sit in the profiler's events under the caller's
  ``record_function``.
* A render that hands its tail to ``trip_drain`` (its list sized by hand:
  the CPU has none) records one ``tpupt.trip.drain`` and
  ``trip.drain_lanes`` under the profiler and nothing without it, and the
  three drain readers read None where no drain was recorded.
* One launch count for every hand-written kernel,
  ``trace.launch_counts()``.
* The benchmark's readers of the spans and counters, through its harness
  on the CPU (in a subprocess: a run refuses a process that loaded JAX).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import tpupt_torch
from tpupt_torch.core import math3d as m3
from tpupt_torch.core.camera import make_camera
from tpupt_torch.render import diff_trip, integrator
from tpupt_torch.render import trip_kernel as tk
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.scene.procedural import icosphere
from tpupt_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 16
SPP = 2

torch.set_num_threads(1)


def _scene(mesh=False):
    """Glass, metal and diffuse spheres on a ground sphere (paths of many
    lengths), with ``mesh`` an icosphere beside them."""
    def t(x, y, z):
        return np.asarray(m3.mat_translate([x, y, z]), np.float64)

    d = SceneDescription(bg_down=(1.0, 0.9, 0.8), bg_up=(0.4, 0.6, 1.0))
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.7))
    d.add_material("glass", "dielectric", refraction_index=1.5)
    d.add_material("chrome", "metal", albedo=(0.85, 0.85, 0.9), fuzz=0.2)
    d.add_sphere(100.0, t(0, -100.5, -1), "ground")
    d.add_sphere(0.5, t(-0.5, 0, -1.2), "glass")
    d.add_sphere(0.4, t(0.6, -0.1, -1.1), "chrome")
    if mesh:
        v, f = icosphere(1)
        d.add_mesh("ico", v, f)
        d.add_mesh_object("ico", t(0.1, 0.6, -1.6) @ np.diag([0.3, 0.3, 0.3, 1.0]), "ground")
    return d.build(device="cpu"), make_camera(vfov=np.pi / 2.5)


def _lit_scene():
    """``_scene(mesh=True)`` with an emissive quad above it: a trip runs the
    closest-hit sweep, ``trip_nee`` and the any-hit sweep."""
    d = SceneDescription(bg_down=(1.0, 0.9, 0.8), bg_up=(0.4, 0.6, 1.0))
    d.add_material("ground", "lambertian", albedo=(0.8, 0.8, 0.7))
    d.add_material("chrome", "metal", albedo=(0.85, 0.85, 0.9), fuzz=0.2)
    d.add_material("lamp", "diffuse_light", emit=(6.0, 5.5, 5.0))
    d.add_sphere(100.0, np.asarray(m3.mat_translate([0, -100.5, -1]), np.float64), "ground")
    d.add_sphere(0.4, np.asarray(m3.mat_translate([0.6, -0.1, -1.1]), np.float64), "chrome")
    v, f = icosphere(1)
    d.add_mesh("ico", v, f)
    d.add_mesh_object("ico", np.asarray(m3.mat_translate([0.1, 0.2, -1.6]), np.float64)
                      @ np.diag([0.3, 0.3, 0.3, 1.0]), "ground")
    quad = np.asarray([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]], np.float32)
    d.add_mesh("quad", quad, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    d.add_mesh_object("quad", np.asarray(m3.mat_translate([0, 1.2, -1.2]), np.float64), "lamp")
    return d.build(device="cpu"), make_camera(vfov=np.pi / 2.5)


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _profiled(fn):
    """``fn()`` under a CPU profiler session inside a ``record_function``
    of the caller's; returns (fn's result, the profiler)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            out = fn()
    return out, prof


def _counting(monkeypatch, module, name):
    """Counts the calls of ``module.name`` (the twin's too)."""
    calls = []
    fn = getattr(module, name)

    def counting(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counting)
    return calls


def _refuse(*_a, **_k):
    raise AssertionError("touched while no profiler is active")


@pytest.mark.parametrize("what", ["span", "timed span", "count", "render", "lit mesh render"])
def test_no_profiler_costs_only_the_flag(monkeypatch, what):
    """No profiler: no record_function, no clock read, no CUDA event, and
    the aggregates stay empty; a lit mesh render asks for its sweep and
    NEE spans on every trip all the same (the flag is all they cost)."""
    assert not trace.enabled()
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(trace, "_range", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    if what == "render":
        scene, cam = _scene()
        _, rays = tpupt_torch.render_image(scene, cam, W, H, SPP, max_bounces=6)
        assert int(rays) > 0
    elif what == "lit mesh render":
        asked = []
        span = trace.span

        def asking(name, device=None):
            asked.append(name)
            return span(name, device)

        monkeypatch.setattr(trace, "span", asking)
        tails = _counting(monkeypatch, tk, "trip_tail")
        scene, cam = _lit_scene()
        _, rays = tpupt_torch.render_image(scene, cam, W, H, SPP, max_bounces=6)
        assert int(rays) > 0
        assert asked.count("tpupt.trip.sweep") == asked.count("tpupt.trip.nee") == len(tails) > 0
    else:
        monkeypatch.setattr(time, "perf_counter_ns", _refuse)
        if what == "count":
            trace.count("trip.live_lanes", 3)
        else:
            with trace.span("tpupt.test", device="cuda" if what == "timed span" else None):
                pass
    assert trace.snapshot() == dict(spans={}, counters={})


@pytest.mark.parametrize("mode", ["chained", "per sample"])
def test_trip_counters_under_the_profiler(monkeypatch, mode):
    """One tpupt.trip.wait and one tpupt.trip.issue a trip_tail call,
    trip.live_lanes the render's segments, trip.lanes_launched trips x
    lanes; one tpupt.render, and no device time off the card."""
    scene, cam = _scene()
    tails = _counting(monkeypatch, tk, "trip_tail")
    chained = mode == "chained"
    (_, rays), _ = _profiled(lambda: tpupt_torch.render_image(
        scene, cam, W, H, SPP, max_bounces=8, chain_samples=chained))
    snap = trace.snapshot()
    c, s = snap["counters"], snap["spans"]
    trips = len(tails)
    assert trips > (1 if chained else SPP)
    assert c == {"trip.live_lanes": int(rays), "trip.lanes_launched": trips * W * H}
    assert s["tpupt.trip.wait"]["count"] == s["tpupt.trip.issue"]["count"] == trips
    assert s["tpupt.trip.setup"]["count"] == s["tpupt.trip.finish"]["count"] == \
        (1 if chained else SPP)
    assert s["tpupt.render"]["count"] == 1
    assert all(v["device_s"] is None for v in s.values())  # no card: no event
    assert 0 < c["trip.live_lanes"] < c["trip.lanes_launched"]


def test_sweep_and_nee_spans_under_the_profiler(monkeypatch):
    """A lit mesh render under the profiler: one tpupt.trip.sweep and one
    tpupt.trip.nee a trip, each inside its trip's tpupt.trip.issue (in
    the profiler's events and in host time)."""
    scene, cam = _lit_scene()
    tails = _counting(monkeypatch, tk, "trip_tail")
    _, prof = _profiled(lambda: tpupt_torch.render_image(scene, cam, W, H, SPP, max_bounces=6))
    s = trace.snapshot()["spans"]
    trips = len(tails)
    assert trips > 1
    for k in ("tpupt.trip.issue", "tpupt.trip.sweep", "tpupt.trip.nee", "tpupt.trip.wait"):
        assert s[k]["count"] == trips, k
    assert s["tpupt.trip.sweep"]["host_s"] + s["tpupt.trip.nee"]["host_s"] \
        < s["tpupt.trip.issue"]["host_s"]
    events = [e for e in prof.events() if e.name.startswith("tpupt.trip.")]
    issues = [e.time_range for e in events if e.name == "tpupt.trip.issue"]
    inner = [e.time_range for e in events if e.name in ("tpupt.trip.sweep", "tpupt.trip.nee")]
    assert len(inner) == 2 * trips
    for r in inner:
        assert any(i.start <= r.start and r.end <= i.end for i in issues)


def _handover(monkeypatch):
    """Every emitter-free sphere plan's list holds 40 lanes (the CPU has
    none), so its render hands its last lanes to the drain."""
    monkeypatch.setattr(tk, "drain_wave", lambda plan: 40)


@pytest.mark.parametrize("profiled", [True, False], ids=["profiler", "no profiler"])
def test_drain_span_and_counters(monkeypatch, profiled):
    """A chained render that hands over: under the profiler one
    tpupt.trip.drain (the handover's only record: no counter of drains)
    and trip.drain_lanes the lanes handed over (at most the list's 40),
    the issued trips' counters short of the render's segments by what the
    drain traced; without it nothing."""
    _handover(monkeypatch)
    scene, cam = _scene()
    tails = _counting(monkeypatch, tk, "trip_tail")
    render = lambda: tpupt_torch.render_image(scene, cam, W, H, SPP, max_bounces=8)  # noqa: E731
    _, rays = _profiled(render)[0] if profiled else render()
    snap = trace.snapshot()
    if not profiled:
        assert snap == dict(spans={}, counters={}) and len(tails) > 0
        return
    c, s = snap["counters"], snap["spans"]
    assert s["tpupt.trip.drain"]["count"] == 1 and s["tpupt.trip.drain"]["host_s"] > 0
    assert "trip.drains" not in c and 0 < c["trip.drain_lanes"] <= 40
    assert s["tpupt.trip.wait"]["count"] == s["tpupt.trip.issue"]["count"] == len(tails) > 0
    assert c["trip.lanes_launched"] == len(tails) * W * H
    assert c["trip.drain_lanes"] <= int(rays) - c["trip.live_lanes"]


def _reader(name):
    from h100bench import run

    return run.load_file(os.path.join(ROOT, "h100bench", "metrics", name + ".py"))


def test_drain_readers(monkeypatch):
    """trip_drain_ms.render and trip_drain_lanes.render read None where
    the program recorded no drain (a program without the span and
    counter, or a render that never handed over), and a render's host ms
    and lanes over the window's renders where it did."""
    from types import SimpleNamespace

    ctx = SimpleNamespace(jobs=2)
    ms, lanes = _reader("trip_drain_ms.render"), _reader("trip_drain_lanes.render")
    assert ms.read(ctx) is None and lanes.read(ctx) is None
    scene, cam = _scene()
    _profiled(lambda: tpupt_torch.render_image(scene, cam, W, H, SPP, max_bounces=6))
    assert "tpupt.trip.issue" in trace.snapshot()["spans"]
    assert ms.read(ctx) is None and lanes.read(ctx) is None  # no list on the CPU: no handover
    trace.reset()
    _handover(monkeypatch)
    for _ in range(2):
        _profiled(lambda: tpupt_torch.render_image(scene, cam, W, H, SPP, max_bounces=6))
    snap = trace.snapshot()
    assert ms.read(ctx) == snap["spans"]["tpupt.trip.drain"]["host_s"] * 1e3 / 2 > 0
    assert lanes.read(ctx) == snap["counters"]["trip.drain_lanes"] / 2 > 0


def test_drain_kernel_reader():
    """trip_drain_kernel_ms.render reads the device ms a render of the
    drain's two kernels, None from a trace without them; the trip kernels'
    readers match neither of them."""
    from types import SimpleNamespace

    from h100bench.trace import Reduced

    drain_ms, trip_ms = _reader("trip_drain_kernel_ms.render"), _reader("trip_kernels_ms.render")
    trips = {"void (anonymous namespace)::trip_head_kernel<true>(HeadArgs)": [9, 0.004],
             "void (anonymous namespace)::trip_tail_kernel<false>(TailArgs)": [9, 0.012]}
    ctx = SimpleNamespace(jobs=2, trace=Reduced(ops=dict(trips)))
    assert drain_ms.read(ctx) is None and trip_ms.read(ctx) == pytest.approx(8.0)
    ctx.trace.ops.update({
        "void (anonymous namespace)::trip_drain_compact_kernel(DrainArgs)": [1, 0.0001],
        "void (anonymous namespace)::trip_drain_kernel<true>(DrainArgs)": [1, 0.0233]})
    assert drain_ms.read(ctx) == pytest.approx(11.7) and trip_ms.read(ctx) == pytest.approx(8.0)
    assert not any(t in d for t in trip_ms.KERNELS for d in drain_ms.KERNELS)


@pytest.mark.parametrize("mesh", [False, True], ids=["spheres", "spheres and a mesh"])
def test_diff_spans_a_sample_and_a_bounce(monkeypatch, mesh):
    """A differentiable render and its gradient: one sample.plan,
    diff.start and diff.backward a sample, one diff.wait and diff.issue a
    bounce, and no counter of the forward trip's."""
    scene, cam = _scene(mesh)
    fwd = _counting(monkeypatch, diff_trip, "diff_trip_fwd")
    params = tpupt_torch.extract_params(scene)

    def step():
        buf, rays = tpupt_torch.render_image(tpupt_torch.with_params(scene, params), cam, W, H,
                                             SPP, max_bounces=4, differentiable=True)
        leaves = [params["sphere_center"], params["materials"]["albedo"]]
        return rays, torch.autograd.grad((buf.color ** 2).sum(), leaves)

    (rays, grads), _ = _profiled(step)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    snap = trace.snapshot()
    s, c = snap["spans"], snap["counters"]
    bounces = len(fwd)
    assert bounces > SPP
    for k in ("tpupt.sample.plan", "tpupt.diff.start", "tpupt.diff.backward",
              "tpupt.sample.accumulate"):
        assert s[k]["count"] == SPP, k
    assert s["tpupt.diff.wait"]["count"] == s["tpupt.diff.issue"]["count"] == bounces
    assert s["tpupt.render"]["count"] == 1 and int(rays) > 0
    assert c == {}


def test_spans_nest_in_the_profilers_events():
    """The tpupt.* spans are events of the profiler's trace, each inside
    the caller's record_function on its clock."""
    scene, cam = _scene()
    _, prof = _profiled(lambda: tpupt_torch.render_image(scene, cam, W, H, SPP, max_bounces=6))
    events = prof.events()
    caller = next(e for e in events if e.name == "caller")
    ours = [e for e in events if e.name.startswith("tpupt.")]
    names = {e.name for e in ours}
    assert {"tpupt.render", "tpupt.trip.setup", "tpupt.trip.issue", "tpupt.trip.wait",
            "tpupt.trip.finish"} <= names
    for e in ours:
        assert caller.time_range.start <= e.time_range.start <= e.time_range.end \
            <= caller.time_range.end, e.name
    render = next(e for e in ours if e.name == "tpupt.render")
    assert render.cpu_parent is not None and render.cpu_parent.name == "caller"
    waits = [e for e in ours if e.name == "tpupt.trip.wait"]
    assert waits and all(e.cpu_parent.name == "tpupt.render" for e in waits)
    assert trace.snapshot()["spans"]["tpupt.trip.wait"]["count"] == len(waits)


def test_snapshot_reset_and_requests():
    """Totals sum by name over requests (renders), a span's host seconds
    cover the spans inside it; reset clears spans and counters but not
    the launch counts."""
    before = trace.launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for n in (2, 5):
            with trace.span("tpupt.render"):
                with trace.span("tpupt.inner"):
                    trace.count("lanes", n)
                with trace.span("tpupt.inner"):
                    time.sleep(0.002)
    snap = trace.snapshot()
    assert snap["counters"] == {"lanes": 7}
    render, inner = snap["spans"]["tpupt.render"], snap["spans"]["tpupt.inner"]
    assert (render["count"], inner["count"]) == (2, 4)
    assert render["host_s"] >= inner["host_s"] >= 0.004
    assert trace.snapshot()["spans"]["tpupt.inner"]["count"] == 4  # reading clears nothing
    trace.reset()
    assert trace.snapshot() == dict(spans={}, counters={})
    assert trace.launch_counts() == before


def test_one_launch_count_for_every_kernel():
    """trace.launch_counts() names every hand-written kernel under the
    keys the CLI prints; the twins launch nothing; an unknown kernel is
    refused."""
    counts = trace.launch_counts()
    assert set(counts) == {"treelet_closest_hit", "treelet_closest_hit(payload=True)",
                           "treelet_any_hit", "winner_step", "trip_head", "trip_nee",
                           "trip_tail", "trip_drain", "diff_trip_fwd", "diff_trip_bwd",
                           "slot_scatter"}
    scene, cam = _scene(mesh=True)
    tpupt_torch.render_image(scene, cam, 8, 8, 1, max_bounces=3)
    assert trace.launch_counts() == counts  # the CPU runs the twins
    trace.launched("winner_step")
    after = trace.launch_counts()
    assert after["winner_step"] == counts["winner_step"] + 1
    with pytest.raises(KeyError):
        trace.launched("no_such_kernel")
    for mod in (tk, diff_trip, integrator):
        assert not hasattr(mod, "LAUNCHES") and not hasattr(mod, "launch_counts")


_HARNESS = """
import json, sys, time
from h100bench import run
from h100bench.tests.helpers import SMALL, bench, cell
from tpupt_torch.utils import trace
out = {}
for name in ("three_balls.render", "three_balls.grad"):
    trace.reset()
    r = run.run_cell(bench(), cell(name), 2**31 + 91, 0.0, True, device="cpu",
                     traffic=SMALL[name], t_start=time.perf_counter())
    out[name] = dict(correct=r["correct"], jobs=r["attempted"],
                     metrics={k: v["value"] for k, v in r["metrics"].items()})
print(json.dumps(out))
"""


def test_readers_through_the_harness():
    """The five readers in a traced run of each cell at a small size on
    the CPU: the host-clock and counter metrics read values,
    sample_setup_ms.grad none (no card to time it on), and the metrics
    that read the profiler's device operations none here, as before."""
    proc = subprocess.run([sys.executable, "-c", _HARNESS], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    render, grad = out["three_balls.render"], out["three_balls.grad"]
    assert render["correct"] and grad["correct"]
    assert set(render["metrics"]) == {"trip_wait_ms.render", "trip_issue_ms.render",
                                      "trip_lane_occupancy.render"}
    assert set(grad["metrics"]) == {"bounce_wait_ms.grad"}
    m = render["metrics"]
    assert m["trip_wait_ms.render"] > 0 and m["trip_issue_ms.render"] > m["trip_wait_ms.render"]
    assert 0 < m["trip_lane_occupancy.render"] < 100
    assert grad["metrics"]["bounce_wait_ms.grad"] > 0
