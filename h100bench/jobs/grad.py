"""A gradient step: ``tpupt_torch.render_image(differentiable=True)`` of
the whole image at the traffic's size, samples and bounces, the loss
sum(color^2), and ``torch.autograd.grad`` of it to every leaf that
``tpupt_torch.extract_params`` gives.  Job k renders samples first +
k * spp onward.  Its work is the primal segments ``render_image``
counts."""

from __future__ import annotations

import torch

from h100bench import compare, counting
from h100bench.window import percentile, rate, walls

LEAVES = ("sphere_center", "sphere_radius", "positions", "bg_down", "bg_up")
MATERIAL_LEAVES = ("albedo", "fuzz", "ior", "emission")


class Job:
    def __init__(self, scene_path: str, config: dict, traffic: dict, first: int, device):
        from tpupt_torch import extract_params
        from tpupt_torch.scene.json_parser import scene_from_json

        desc = scene_from_json(scene_path)
        self.scene = desc.build(leaf_size=config["leaf_size"], device=device)
        self.camera = desc.camera
        self.params = extract_params(self.scene)
        self.t = traffic
        self.first = first
        self.device = torch.device(device)

    def start(self, k: int) -> int:
        return self.first + k * self.t["spp"]

    def run(self, k: int):
        """Job ``k``: (primal segments, its output)."""
        from tpupt_torch import render_image, with_params

        t, p = self.t, self.params
        with torch.profiler.record_function("h100bench.render_image"):
            buf, rays = render_image(with_params(self.scene, p), self.camera, t["width"],
                                     t["height"], t["spp"], max_bounces=t["max_bounces"],
                                     rr_start=t["rr_start"], differentiable=True,
                                     start_iteration=self.start(k))
            loss = torch.sum(buf.color ** 2)
        leaves = [p[k] for k in LEAVES] + [p["materials"][k] for k in MATERIAL_LEAVES]
        with torch.profiler.record_function("h100bench.autograd_grad"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        segs = int(rays)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return segs, dict(color=buf.color.detach(), normal=buf.normal.detach(),
                          depth=buf.depth.detach(), segs=segs, loss=float(loss.detach()),
                          grads=dict(zip(LEAVES + MATERIAL_LEAVES, grads)), start=self.start(k))

    def count(self, k: int) -> dict:
        return counting.count_diff(lambda: self.run(k))

    def release(self) -> None:
        self.scene = self.camera = self.params = None


def reference(ref, scene_path: str, traffic: dict, start: int, device) -> dict:
    """The plain reference's gradient step that started at ``start``."""
    scene = ref.load_scene(scene_path, device)
    t = traffic
    if t["rr_start"] is not None:
        raise NotImplementedError("the reference renders without roulette")
    tie_tris = []
    color, normal, depth, segs, tied, loss, grads = ref.render_grad(
        scene, t["width"], t["height"], t["spp"], t["max_bounces"], start, tie_tris=tie_tris)
    return dict(color=color, normal=normal, depth=depth, segs=int(segs.sum()), tied=tied,
                loss=loss, grads=grads, start=start,
                tie_vertices=ref.tie_vertices(scene, tie_tris))


def numbers(got: dict, want: dict) -> dict:
    return dict(pixels_off=compare.pixels_off(got, want, want["tied"]),
                segments_gap=compare.segments_gap(got["segs"], want["segs"]),
                loss_gap=compare.loss_gap(got["loss"], want["loss"]),
                grad_gap=compare.grad_gap(got["grads"], want["grads"], want["tie_vertices"]))


def end_to_end(window: dict) -> dict:
    """The window's rate over all its steps and time, and the 95th
    percentile of every step's wall."""
    return dict(grad_mrays_per_s=rate(window["work"], window["seconds"]) / 1e6,
                grad_step_ms_p95=percentile(walls(window["ends"]), 95) * 1e3)
