"""The differentiable trip's CUDA source (``tpupt_torch/accel/csrc/
diff_trip_kernels.cu``) compiled by g++ and run on the CPU, against the
torch twins.

``experiments/torch_diff_trip_emulate.py`` builds the source against stubs
of the CUDA built-ins (a launch is a loop over its blocks and threads, one
thread at a time) with what a warp or a CTA does together as plain loops
and adds: the backward's queues by case become one loop over the lanes in
order, the leaf table's warp sums and CTA flush and the slot table's
scatter plain adds; the forward's CTA loop likewise (each thread's codes
and residual stores by the kernel's own ``fwd_codes``, then the live lanes
in order).  So each case's per-lane arithmetic (miss, sphere hit, triangle
hit), the layout and the control flow around them are checked on every
run of the suite, the forward also on dense, sparse and all-dead states at
a lane count that fills no CTA, with roulette and without; the queues and
the reductions only on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).  Both sides use
correctly rounded float32 sqrt, rsqrt, sin and cos (torch's CPU functions
and the C library's differ in the last bit).

Skips only where there is no ``g++``.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import torch_diff_trip_emulate as emu  # noqa: E402
import test_torch_trip as trip  # noqa: E402

from tpupt_torch.render import diff_trip  # noqa: E402
from tpupt_torch.render.integrator import render_route  # noqa: E402

SIZE = 8


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source against the stubs")
    with emu.emulation(str(tmp_path_factory.mktemp("diff_trip_emu"))) as wrappers:
        yield wrappers


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return str(tmp_path_factory.mktemp("assets"))


@pytest.mark.parametrize("rr_start", [None, 1])
@pytest.mark.parametrize("name", emu.SCENES)
def test_emulated_source_equals_twins(emulated, assets, name, rr_start):
    """The differentiable render (8^2, 2 spp, 4 bounces) through the
    emulated diff_trip_fwd and diff_trip_bwd against the twins: colour,
    normal, depth and segments bit-equal; every leaf's gradient and each
    sample's slot table gradient at rtol 1e-5, with a floor of 1e-5 x its
    max |grad| (the backward's arithmetic runs in another order than
    autograd's, its leaf sums in double).  Each backward's last take of a
    chunk leaves the work counter at 0 for the next launch."""
    scene, cam = emu.scene(name, assets)
    assert render_route(scene, True) == "diff_trip"
    bwd, counters = emulated["diff_trip_bwd"], []

    def checked_bwd(*args):
        out = bwd(*args)
        counters.append([c.tolist() for c in diff_trip._WORK.values()])
        return out

    r = emu.compare(scene, cam, SIZE, rr_start, dict(emulated, diff_trip_bwd=checked_bwd))
    assert all(r["forward_equal"].values()), r["forward_equal"]
    assert r["slot_tables"] == (0 if name in ("spheres", "nine spheres") else 2), r["slot_tables"]
    assert r["ok"], r["gaps"]
    assert counters and all(c and all(v == [0] for v in c) for c in counters), counters


FWD_CASES = {"dense, bounce 0": ("dense", 0), "sparse, bounce 2": ("sparse", 2),
             "all dead": ("all_dead", 2)}


@pytest.mark.parametrize("rr_start", [None, 1])
@pytest.mark.parametrize("case", list(FWD_CASES))
@pytest.mark.parametrize("name", list(trip.FREE_SCENES))
def test_emulated_fwd_equals_twin_on_states(emulated, name, case, rr_start):
    """The emulated diff_trip_fwd against ``diff_trip_fwd_plain`` on every
    output (the lane state, the residuals it writes and the 7s it leaves,
    the lanes left), every lane, one in 41 or none alive, at 23 x 7 lanes,
    which fill no CTA and no two-lane access: nine spheres with an exact-t
    tie (no mesh) and spheres beside a mesh (the payload sweep's
    triangles); without roulette and with it from bounce 1."""
    state, bounce = FWD_CASES[case]
    args = trip.diff_inputs(name, state, bounce, rr_start=rr_start)
    got = trip.fwd_run(emulated["diff_trip_fwd"], *args, bounce)
    want = trip.fwd_run(diff_trip.diff_trip_fwd_plain, *args, bounce)
    for label, a, b in zip(("F", "I", "res_f", "res_i", "count"), got, want):
        assert torch.equal(a, b), label


@pytest.mark.parametrize("layout", ["(N, 9), slots aligned", "(9, N) transposed, slots unaligned"])
def test_emulated_slot_scatter_equals_index_add(emulated, layout):
    """slot_scatter's kernel emulated against index_add_ of the rows with
    slot >= 0: a lane count that is not a multiple of a warp's 128 lanes,
    slot -1 lanes with nonzero rows, whole warps on one row, rows by both
    layouts' strides, a slot row that starts off 16 bytes.  (The 16-byte
    slot reads and their passing round the warp are emulated as each
    lane's own read; the card tests hold them.)  The rows are small
    integers, so every order of the sums is exact."""
    r = np.random.default_rng(11)
    n, rows = 1027, 50
    slot = r.integers(0, rows, n + 1).astype(np.int32)
    slot[r.random(n + 1) < 0.4] = -1
    slot[128:320] = 7
    cot = torch.from_numpy(r.integers(-8, 9, (n, 9)).astype(np.float32))
    slot_t = torch.from_numpy(slot)
    if layout.startswith("(9, N)"):
        cot = cot.t().contiguous().t()
        slot_t = slot_t[1:]  # 4 bytes past an aligned start
    else:
        slot_t = slot_t[:n]
    before = emulated["slot_scatter"].launches
    got = emulated["slot_scatter"](torch.zeros((rows, 9)), slot_t, cot)
    keep = slot_t >= 0
    want = torch.zeros((rows, 9)).index_add_(0, slot_t[keep].long(), cot[keep])
    assert emulated["slot_scatter"].launches == before + 1
    assert torch.equal(got, want)
