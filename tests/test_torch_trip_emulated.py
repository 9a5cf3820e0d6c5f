"""The trip kernels' CUDA source (``tpupt_torch/accel/csrc/trip_kernels.cu``)
compiled by g++ and run on the CPU, against the body route.

``experiments/torch_trip_emulate.py`` builds the source against stubs of
the CUDA built-ins (a launch is a loop over its blocks and threads, one
thread at a time), with ``trip_nee``'s and ``trip_head``'s CTA loops as
plain loops: each block's thread 0 runs the kernel's own table staging,
then its warps' chunks in turn: each thread's flags and the stores that
close its lanes (their NEE terms; the sweep's mask and seeds, the pad
lanes), then each live lane (the hit record, shading, the MIS-weighted
emission, then each NEE term: the light sample, the sphere test, the
contribution and shadow rows; the lazy sphere pass, the record and the
sweep's rows), in order.  So the per-lane and per-term arithmetic, the
layouts, the staged table (and the table read from device memory), the
closing stores and the CDF search are checked on every run of the suite,
on the emitter scenes and on two emitter-free ones (nine spheres with an
exact-t tie and a radius-1000 ground; spheres beside a mesh), with
trip_head held to its twin on dense, sparse and all-dead states at a lane
count that fills no chunk; and trip_drain after k issued trips against
the trip loop run to the end and against its twin.  The warps' queues of
live lanes and the drain list's ranks only on the card
(``tests/test_torch_trip_nee.py``, ``tests/test_torch_trip.py``,
``chip_smoke.py``).  Both sides use correctly rounded float32 sqrt, rsqrt,
sin and cos (torch's CPU functions and the C library's differ in the last
bit).

Skips only where there is no ``g++``.
"""

import ctypes
import functools
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import torch_trip_emulate as emu  # noqa: E402
import test_torch_trip as trip  # noqa: E402
import test_torch_trip_nee as nee  # noqa: E402

from tpupt_torch.render import trip_kernel  # noqa: E402
from tpupt_torch.render.integrator import render_image, render_route  # noqa: E402
from tpupt_torch.render.intersect import intersect_scene_ids  # noqa: E402

SIZE = 8
SCENES = ("lamp", "many16", "quad_mixed", "ico_light")


# trip_nee's staging of the scene table: as shipped (every scene's table
# up to its triangle rows fits), none (every table read from global memory)
_STAGE = "constexpr int kStageMax = 8192;"
STAGING = {"staged": [], "global": [(_STAGE, _STAGE.replace("8192", "0"))]}


@pytest.fixture(scope="module", params=list(STAGING))
def emulated(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the stubs")
    out = str(tmp_path_factory.mktemp("trip_emu"))
    with emu.emulation(out, STAGING[request.param]) as built:
        yield built


@pytest.mark.parametrize("mode", ["chained", "per_sample"])
@pytest.mark.parametrize("name", SCENES)
def test_emulated_trip_route_equals_body_route(emulated, monkeypatch, name, mode):
    """The trip route through the emulated trip_head, trip_nee and
    trip_tail (8^2, 2 spp, 4 bounces, roulette from bounce 2) against the
    body route: colour, normal, depth and segments bit-equal.  On every
    trip the emulated trip_nee equals its twin ``trip_nee_plain`` in every
    output (the lane state, alive_next, each term's contribution, mask and
    shadow rows, pad lanes included)."""
    wrappers, _ = emulated
    scene, cam = nee._port_scene(name, None)
    assert scene.has_nee and render_route(scene) == "trip"
    calls = []

    def checked_nee(plan, F, I, buf, sweep=None):
        twin = (F.clone(), I.clone(), trip_kernel.trip_buffers(plan))
        for k in nee.HEAD_OUT + nee.NEE_OUT:
            if getattr(buf, k) is not None:
                getattr(twin[2], k).copy_(getattr(buf, k))
        out = wrappers["trip_nee"](plan, F, I, buf, sweep)
        calls.append(plan.n)
        trip_kernel.trip_nee_plain(plan, *twin, sweep)
        assert torch.equal(F, twin[0]) and torch.equal(I, twin[1]), len(calls)
        for k in nee.NEE_OUT:
            a, b = getattr(buf, k), getattr(twin[2], k)
            assert (a is None and b is None) or torch.equal(a, b), (len(calls), k)
        return out

    kw = dict(spp=2, max_bounces=4, rr_start=2, chain_samples=mode == "chained")
    for k, fn in dict(wrappers, trip_nee=checked_nee).items():
        monkeypatch.setattr(trip_kernel, k, fn)
    got = render_image(scene, cam, SIZE, SIZE, **kw)
    monkeypatch.undo()
    want = render_image(scene, cam, SIZE, SIZE, intersect_fn=functools.partial(intersect_scene_ids),
                        **kw)
    assert int(got[1]) == int(want[1]) > SIZE * SIZE
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(got[0], key), getattr(want[0], key)), key
    assert float(got[0].color.max()) > 0.05  # the emitters light the scene
    assert calls


@pytest.mark.parametrize("state", list(trip.STATES))
@pytest.mark.parametrize("name", list(trip.FREE_SCENES))
def test_emulated_trip_head_equals_twin(emulated, name, state):
    """The emulated trip_head against ``trip_head_plain`` on every output
    (the record, hint, the packed rows and mask with their pad lanes, and
    what a lane that is not live leaves), every lane, one in 41 or none
    alive, at 23 x 7 lanes: nine spheres with an exact-t tie (no mesh) and
    spheres beside a mesh."""
    wrappers, _ = emulated
    plan, F, I = trip.head_inputs(name, state)
    trip.assert_head_equal(trip.head_run(wrappers["trip_head"], plan, F, I),
                           trip.head_run(trip_kernel.trip_head_plain, plan, F, I))


@pytest.mark.parametrize("name", list(trip.FREE_SCENES))
def test_emulated_emitter_free_route_equals_body_route(emulated, monkeypatch, name):
    """The trip route through the emulated trip_head and trip_tail (23 x
    7, 2 spp, 4 bounces, roulette from bounce 2, chained) against the body
    route: colour, normal, depth and segments bit-equal."""
    wrappers, _ = emulated
    scene, cam = trip.FREE_SCENES[name]()
    assert not scene.has_nee and render_route(scene) == "trip"
    kw = dict(spp=2, max_bounces=4, rr_start=2)
    for k in ("trip_head", "trip_tail"):
        monkeypatch.setattr(trip_kernel, k, wrappers[k])
    got = render_image(scene, cam, trip.W_ODD, trip.H_ODD, **kw)
    monkeypatch.undo()
    want = render_image(scene, cam, trip.W_ODD, trip.H_ODD,
                        intersect_fn=functools.partial(intersect_scene_ids), **kw)
    assert int(got[1]) == int(want[1]) > trip.W_ODD * trip.H_ODD
    for key in ("color", "normal", "depth"):
        assert torch.equal(getattr(got[0], key), getattr(want[0], key)), key


@pytest.mark.parametrize("emulated", ["staged", "global"], indirect=True)
@pytest.mark.parametrize("case", list(trip.DRAIN_CASES))
def test_emulated_drain_equals_issued_trips(emulated, case):
    """The emulated trip_drain after k emulated trips (trip_head,
    trip_tail) on the nine spheres (an exact-t tie, a radius-1000 ground;
    24 x 16, a long tail), from trip 0, a middle trip or the last trip but
    one, chained, per sample and with roulette, against the emulated trip
    loop run to the end: colour, normal, depth and segments bit-equal,
    every lane done and none left in the count; and the same state as
    ``trip_drain_plain``'s from the same start, bounce counters and the
    list's length included (``trip_drain``'s table staged and read from
    global memory, the ``emulated`` fixture's two builds)."""
    wrappers, _ = emulated
    twin = {}
    r = trip.drain_against_issued(wrappers["trip_head"], wrappers["trip_tail"],
                                  trip.twin_checked(wrappers["trip_drain"], twin), case)
    trip.assert_drained(r, trip.DRAIN_CASES[case][0]["chained"])
    assert torch.equal(r["F"][1], twin["F"]) and torch.equal(r["I"][1], twin["I"])
    assert twin["len"] == r["drain_len"]


def _cdf_cases():
    r = np.random.default_rng(5)
    area = r.random(320).astype(np.float64)
    area[[3, 4, 5, 100, 101]] = 0.0  # repeated entries
    ico = (np.cumsum(area) / area.sum()).astype(np.float32)
    return {
        "320 entries, five repeats": ico,
        "one entry": np.array([1.0], np.float32),
        "all equal": np.full(7, 0.5, np.float32),
        "leading zeros": np.array([0.0, 0.0, 0.25, 0.25, 1.0], np.float32),
        "short of 1": np.array([0.1, 0.6, 0.9999], np.float32),
    }


@pytest.mark.parametrize("emulated", ["staged"], indirect=True)
@pytest.mark.parametrize("case", list(_cdf_cases()))
def test_emulated_cdf_search_equals_compare_count(emulated, case):
    """trip_nee's binary search over the area CDF (``cdf_index``) against
    the compare-count of ``integrator._nee_mesh_sample`` (the number of
    entries <= u, clamped to the last): u equal to every entry and one
    float above and below it, 0, the largest uniform draw and 1."""
    _, lib = emulated
    cum = _cdf_cases()[case]
    us = {0.0, 1.0, 1.0 - 2.0 ** -24}
    for c in cum:
        us |= {float(c), float(np.nextafter(c, np.float32(2))),
               float(np.nextafter(c, np.float32(-1)))}
    ptr = cum.ctypes.data_as(ctypes.c_void_p)
    for u in sorted(us):
        u32 = np.float32(u)
        want = min(int((u32 >= cum).sum()), len(cum) - 1)
        assert lib.emu_cdf_index(ptr, len(cum), ctypes.c_float(u32)) == want, (u, want)
