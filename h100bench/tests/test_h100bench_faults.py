"""A run with the timed path broken underneath comes out not correct:
a job whose state never moves on (every job renders the first job's samples), half of the
samples left out and the mean taken over the rest, one pixel altered
where it is produced.  (The cells take one chip: there is no exchange
between chips to leave out.)"""

import pytest
import torch

import tpupt_torch
from h100bench.jobs.render import checked_rows
from h100bench.tests.helpers import SMALL, run_small

_render = tpupt_torch.render_image


def _stale():
    """Every job renders the first job's samples: the sequence's state
    never moves on."""
    first = {}

    def render(*a, **kw):
        kw["start_iteration"] = first.setdefault("it", kw["start_iteration"])
        return _render(*a, **kw)

    return render


def _half(*a, **kw):
    a = list(a)
    a[4] = max(1, a[4] // 2)  # spp: half the samples, averaged over themselves
    return _render(*a, **kw)


def _altered(name):
    """One pixel altered where it is produced, in a row that the check
    draws (a render's check holds a sample of its rows)."""
    t = SMALL[name]

    def render(*a, **kw):
        buf, rays = _render(*a, **kw)
        rows = checked_rows(kw["start_iteration"], t["height"], t.get("check_rows"))
        color = buf.color.clone()
        color[rows[len(rows) // 2] * t["width"] + t["width"] // 3, 1] += 0.01
        return type(buf)(color=color, normal=buf.normal, depth=buf.depth,
                         iteration=buf.iteration), rays

    return render


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fn = {"stale": _stale, "half": lambda: _half, "altered": lambda: _altered(name)}[fault]()
    monkeypatch.setattr(tpupt_torch, "render_image", fn)
    assert not run_small(name)["correct"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"], r["checks"]
    assert torch.isfinite(torch.tensor([m["value"] for m in r["metrics"].values()])).all()


def test_the_render_check_draws_its_rows_from_the_job():
    t = SMALL["three_balls.render"]
    a = checked_rows(12345, t["height"], t["check_rows"])
    assert a == checked_rows(12345, t["height"], t["check_rows"]) == sorted(set(a))
    assert len(a) == t["check_rows"] and a != checked_rows(12345 + t["spp"], t["height"], 4)
    assert checked_rows(12345, t["height"], None) == list(range(t["height"]))
