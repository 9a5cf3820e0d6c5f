"""The numbers that decide ``correct``: what the program produced against
what the plain reference produces from the same scene files and sample
indices.

- ``pixels_off``: the share of the checked pixels, of those where no ray
  of the reference met two triangles at exactly its closest distance,
  whose color, normal or depth differs from the reference's at all.  The
  checked pixels are the reference's ``pix`` (indices into the program's
  image) where it has them, else every pixel.
- ``segments_gap``: |program's traced segments - reference's| over the
  reference's.
- ``loss_gap``: |program's loss - reference's| over the reference's.
- ``grad_gap``: over the leaves whose reference gradient norm is at least
  a thousandth of the median leaf's, the largest norm of (program's
  gradient - reference's), over the larger of that leaf's reference norm
  and the median leaf's; the positions leaf without the rows of the
  vertices of tied triangles (either triangle is the closest hit there,
  and the two sides may take different ones).

Each number has a limit of its own, per cell, in ``limits/<cell>.json``;
a number at or under its limit passes.
"""

from __future__ import annotations

import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as fh:
        return json.load(fh)["limits"]


def checked(got: dict, want: dict, key: str) -> torch.Tensor:
    """The program's ``key`` at the pixels the reference rendered (a
    ``got`` with ``pix`` of its own, as the control's, holds those
    pixels already)."""
    a = got[key].to(want[key].device)
    if "pix" not in want:
        return a
    if "pix" in got:
        if not torch.equal(got["pix"].to(want["pix"].device), want["pix"]):
            raise ValueError("the two sides hold different pixels")
        return a
    return a[want["pix"]]


def pixels_off(got: dict, want: dict, tied) -> float:
    """Share of untied checked pixels whose buffers differ at all."""
    off = torch.zeros_like(tied)
    for key in ("color", "normal", "depth"):
        a, b = checked(got, want, key), want[key]
        d = (a != b).reshape(a.shape[0], -1).any(dim=1)
        off |= d
    untied = ~tied
    return float((off & untied).sum()) / max(1, int(untied.sum()))


def segments_gap(got: int, want: int) -> float:
    return abs(got - want) / max(1, want)


def loss_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def grad_gap(got: dict, want: dict, tie_vertices=None) -> float:
    """The worst leaf's gap; ``tie_vertices`` rows of the positions leaf
    (the vertices of triangles that met a ray at exactly its closest t,
    where either triangle is the closest hit) are left out of it."""
    want = dict(want)
    got = dict(got)
    if tie_vertices is not None and tie_vertices.numel():
        keep = torch.ones(len(want["positions"]), dtype=torch.bool,
                          device=want["positions"].device)
        keep[tie_vertices] = False
        want["positions"] = want["positions"][keep]
        got["positions"] = got["positions"].to(keep.device)[keep]
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    ordered = sorted(norms.values())
    median = ordered[len(ordered) // 2]
    worst = 0.0
    for k, g in want.items():
        if norms[k] < 1e-3 * median:
            continue
        diff = float((got[k].to(g.device).double() - g.double()).norm())
        worst = max(worst, diff / max(norms[k], median))
    return worst


def details(got: dict, want: dict) -> dict:
    """What the numbers leave out, for the record: the tied pixels; up to
    five untied pixels that differ (index, |difference| of color, normal,
    depth); each leaf's gradient norm and its gap over that norm (the
    positions' with the tied triangles' rows, which ``grad_gap`` leaves
    out), and how many rows those are; each side's segments (the
    reference's over the checked pixels only) and, where not every pixel
    is checked, how many are."""
    out = dict(tied_pixels=int(want["tied"].sum()), segments=[got["segs"], want["segs"]])
    diff = torch.stack([(checked(got, want, k) - want[k]).abs().reshape(len(want[k]), -1)
                        .amax(dim=1) for k in ("color", "normal", "depth")], dim=1)
    off = torch.nonzero((diff.amax(dim=1) > 0) & ~want["tied"]).reshape(-1)[:5]
    at = want["pix"] if "pix" in want else torch.arange(len(diff), device=diff.device)
    out["pixels_off_at"] = [[int(at[i])] + [float(x) for x in diff[i]] for i in off]
    if "pix" in want:
        out["checked_pixels"] = int(len(want["pix"]))
    if "grads" in want:
        out["grad_gap_by_leaf"] = {
            k: [float(g.double().norm()),
                float((got["grads"][k].to(g.device).double() - g.double()).norm())
                / max(float(g.double().norm()), 1e-30)] for k, g in want["grads"].items()}
        out["tie_vertex_rows"] = int(want["tie_vertices"].numel())
    return out


def judge(numbers: dict, cell_limits: dict) -> tuple[bool, dict]:
    """(every number at or under its limit, {name: {value, limit}})."""
    out = {k: {"value": v, "limit": cell_limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= cell_limits[k] for k, v in numbers.items())
    return ok, out
