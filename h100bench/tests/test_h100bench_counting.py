"""The frozen byte rules against counts by hand."""

from types import SimpleNamespace

import torch

from h100bench import counting


def _plan(n, n_pad, mesh=True, chained=True, n_sph=1, table=29):
    return SimpleNamespace(n=n, n_pad=n_pad, mesh=mesh, chained=chained, nee_kinds=("mesh",),
                           tables=SimpleNamespace(n_sph=n_sph, table=torch.zeros(table)))


def test_head_bytes_and_flops():
    plan = _plan(1000, 1024)
    nbytes, flops = counting.head_work(plan, live=100, wins=40)
    # alive of every lane; 7 ray rows + 8 record words a live lane; seed t
    # and mask of every padded lane; 7 rows of each live and pad lane
    assert nbytes == 1000 * 4 + 100 * 60 + 1024 * 5 + (100 + 24) * 28
    assert flops == 100 * 1 * 60 + 40 * 65
    assert counting.bound_ms(0, 3.35e9) == 1.0 and counting.bound_ms(67e9, 0) == 1.0


def test_tail_bytes_on_a_trip():
    tk = SimpleNamespace(I_KEYS=("alive", "seed", "bounce", "k", "segs", "done", "spec"))
    n = 8
    I0 = torch.zeros((7, n), dtype=torch.int32)
    I0[0, :5] = 1  # five live lanes
    I0[5, 7] = 1  # one lane done
    I1 = I0.clone()
    I1[3, :2] = 1  # two lanes fold a sample
    I1[5, 1] = 1  # one of them is done after it
    sweep = (None, torch.tensor([0, -1, 3, -1, -1, 2, -1, -1]))
    hint = torch.tensor([1, 1, -1, -1, -1, -1, -1, -1])
    live, wins, (nbytes, flops) = counting.tail_work(tk, _plan(n, 256), I0, I1, sweep, hint)
    assert (live, wins) == (5, 2)
    touched, mesh_hits, ended, fresh = 7, 2, 2, 1
    assert nbytes == (n * 16 + touched * (17 * 8 + 12) + live * 40 + mesh_hits * 20
                      + ended * 68 + fresh * 4 + 4)
    assert flops == live * 320 + ended * 80


def test_diff_fwd_and_bwd_bytes():
    dt = SimpleNamespace(DEAD=-2)
    plan = SimpleNamespace(n=6, mesh=True, tables=SimpleNamespace(n_sph=1, table=torch.zeros(29)),
                           scene=SimpleNamespace(materials=SimpleNamespace(
                               albedo=torch.zeros(3, 3))))
    code = torch.tensor([-2, -1, 0, 3, 3, -2])  # dead, miss, sphere, two triangle hits
    slot = torch.tensor([-1, -1, -1, 17, 17, -1])
    nbytes, flops = counting.diff_fwd_work(dt, plan, code, 0)
    assert nbytes == (6 * 4 + 2 * 8 + 4 * 28 + 1 * 72 + 3 * 148 + 2 * 40 + 3 * 16 + 29 * 4 + 4)
    assert flops == 3 * 340 + 60
    nbytes, flops = counting.diff_bwd_work(dt, plan, code, slot, 2)
    n_leaf = 4 + 3 * 8 + 6
    assert nbytes == 6 * 4 + 84 + 3 * 128 + 2 * 40 + 1 * 36 + 29 * 4 + n_leaf * 16
    assert flops == 3 * 800 + 60
