"""A forward render job: ``tpupt_torch.render_image`` of the whole image
at the traffic's size, samples and bounces, continuing one progressive
sample sequence (job k starts at sample first + k * spp).  Its work is
the traced segments that ``render_image`` counts.  The check holds the
rows that ``checked_rows`` draws (the traffic's ``check_rows`` of them,
every row where it names none) to the reference."""

from __future__ import annotations

import random

import torch

from h100bench import compare, counting
from h100bench.window import rate


class Job:
    def __init__(self, scene_path: str, config: dict, traffic: dict, first: int, device):
        from tpupt_torch.scene.json_parser import scene_from_json

        desc = scene_from_json(scene_path)
        self.scene = desc.build(leaf_size=config["leaf_size"], device=device)
        self.camera = desc.camera
        self.t = traffic
        self.first = first
        self.device = torch.device(device)

    def start(self, k: int) -> int:
        return self.first + k * self.t["spp"]

    def run(self, k: int):
        """Job ``k``: (segments, its output)."""
        from tpupt_torch import render_image

        t = self.t
        with torch.profiler.record_function("h100bench.render_image"):
            buf, rays = render_image(self.scene, self.camera, t["width"], t["height"], t["spp"],
                                     max_bounces=t["max_bounces"], rr_start=t["rr_start"],
                                     start_iteration=self.start(k))
            segs = int(rays)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return segs, dict(color=buf.color, normal=buf.normal, depth=buf.depth, segs=segs,
                          start=self.start(k))

    def count(self, k: int) -> dict:
        return counting.count_trips(lambda: self.run(k))

    def release(self) -> None:
        self.scene = self.camera = None


def checked_rows(start: int, height: int, count) -> list:
    """The rows of the job that started at ``start`` that the check holds:
    ``count`` of them drawn uniformly from ``start`` (itself drawn from the
    seed), in order; every row where ``count`` is None."""
    if count is None or count >= height:
        return list(range(height))
    return sorted(random.Random(start).sample(range(height), count))


def reference(ref, scene_path: str, traffic: dict, start: int, device) -> dict:
    """The plain reference's render of the checked rows of the job that
    started at ``start``; ``pix`` holds their pixels where those are not
    the whole image."""
    scene = ref.load_scene(scene_path, device)
    t = traffic
    if t["rr_start"] is not None:
        raise NotImplementedError("the reference renders without roulette")
    rows = checked_rows(start, t["height"], t.get("check_rows"))
    pix = None
    if len(rows) < t["height"]:
        r = torch.tensor(rows, dtype=torch.int64, device=scene.device)
        pix = (r[:, None] * t["width"] + torch.arange(t["width"], device=scene.device)).reshape(-1)
    color, normal, depth, segs, tied = ref.render_forward(scene, t["width"], t["height"], t["spp"],
                                                          t["max_bounces"], start, pix=pix)
    want = dict(color=color, normal=normal, depth=depth, segs=int(segs.sum()), tied=tied,
                start=start)
    if pix is not None:
        want["pix"] = pix
    return want


def numbers(got: dict, want: dict) -> dict:
    """``pixels_off`` over the checked rows; ``segments_gap`` where those
    are every row (the program counts its segments over the whole image)."""
    out = dict(pixels_off=compare.pixels_off(got, want, want["tied"]))
    if "pix" not in want:
        out["segments_gap"] = compare.segments_gap(got["segs"], want["segs"])
    return out


def end_to_end(window: dict) -> dict:
    """The window's rate: every job's segments over all its seconds."""
    return dict(render_mrays_per_s=rate(window["work"], window["seconds"]) / 1e6)
