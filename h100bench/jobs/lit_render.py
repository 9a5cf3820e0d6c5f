"""A forward render job of a lit scene with meshes: ``jobs/render.py``'s
job, reference, numbers and rate, with two differences.  The scene is
read with its "background" color where it states one (the program's
``scene_from_json(..., honor_background=True)``; the reference the
configuration names reads it too).  Its count also holds the closest-hit
sweep's work on every trip (``counting_sweep``) beside the trip kernels'
(``counting.count_trips``)."""

from __future__ import annotations

import torch

from h100bench import counting, counting_sweep
from h100bench.jobs import render
from h100bench.jobs.render import end_to_end, numbers, reference

__all__ = ["Job", "end_to_end", "numbers", "reference"]


class Job(render.Job):
    def __init__(self, scene_path: str, config: dict, traffic: dict, first: int, device):
        from tpupt_torch.scene.json_parser import scene_from_json

        desc = scene_from_json(scene_path, honor_background=True)
        self.scene = desc.build(leaf_size=config["leaf_size"], device=device)
        self.camera = desc.camera
        self.t = traffic
        self.first = first
        self.device = torch.device(device)

    def count(self, k: int) -> dict:
        trips = {}
        sweeps = counting_sweep.count_sweeps(
            lambda: trips.update(counting.count_trips(lambda: self.run(k))))
        return dict(trips, **sweeps)
