"""Wavefront ("streaming") integrator with compaction (counterpart of
``tpupt/render/wavefront.py``).

The reference's streaming mode relaunches its kernels every bounce and
moves the live paths to the front with ``thrust::stable_partition``,
reading the live count back to the host.  Here each bounce runs
``integrator._bounce_body`` on the live paths only: after the bounce,
``integrator._partition_perm`` orders the lanes live first (stable), the
paths that ended write their estimate to their pixel, and the state is cut
to the first ``count`` lanes.  So the sweep's grid covers only live
packets, and reading ``count`` is the one host sync a bounce makes, in
place of the megakernel loop's check for a live lane.

Every lane carries its global pixel, and the RNG is keyed on it, so a path
takes the same decisions in both modes and the two agree bit for bit (the
reference keys its streaming RNG on the compacted lane index, so its two
modes do not).  Lanes never interact, except through the sweep's visit
order, which follows a packet's composition: only an exact tie in t
between two treelets could resolve otherwise.  Forward only.
"""

from __future__ import annotations

import torch

from tpupt_torch.core.types import Camera, SceneArrays
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.integrator import (
    MAX_BOUNCES_DEFAULT,
    _bounce_body,
    _fresh_state,
    _partition_perm,
)
from tpupt_torch.render.intersect import intersect_scene_ids


def _take(state: dict, idx: torch.Tensor) -> dict:
    return {k: Vec3(v.x[idx], v.y[idx], v.z[idx]) if isinstance(v, Vec3) else v[idx]
            for k, v in state.items()}


def _rows(v: Vec3, idx: torch.Tensor) -> torch.Tensor:
    return torch.stack([v.x[idx], v.y[idx], v.z[idx]], dim=-1)


@torch.no_grad()
def trace_sample_wavefront(
    scene: SceneArrays,
    camera: Camera,
    width: int,
    height: int,
    iteration,
    max_bounces: int = MAX_BOUNCES_DEFAULT,
    rr_start: int | None = None,
    intersect_fn=None,
    any_hit=None,
):
    """One sample per pixel.  Returns (color (N, 3), normal (N, 3), depth
    (N,), traced segments as a 0-dim int64 tensor) in pixel order, equal to
    the forward ``integrator.trace_sample``'s.  ``intersect_fn`` and
    ``any_hit`` as there."""
    fn = intersect_fn or intersect_scene_ids
    dev = scene.device
    n = width * height
    pixel = torch.arange(n, dtype=torch.int64, device=dev)
    state, seed = _fresh_state(scene, camera, width, height, pixel, iteration)
    color = torch.zeros((n, 3), device=dev)
    normal = torch.zeros((n, 3), device=dev)
    depth = torch.zeros((n,), device=dev)

    def finish(final: Vec3, idx: torch.Tensor) -> None:
        """The final gather of lanes ``idx``: a scatter by pixel index."""
        pix = pixel[idx]
        color.index_copy_(0, pix, _rows(final, idx))
        normal.index_copy_(0, pix, _rows(state["normal"], idx))
        depth.index_copy_(0, pix, state["depth"][idx])

    rays = torch.zeros((), dtype=torch.int64, device=dev)
    count = n
    for b in range(max_bounces):
        if count == 0:
            break
        rays = rays + count
        state = _bounce_body(scene, seed, state, b, rr_start, fn, any_hit=any_hit)
        perm, live = _partition_perm(state["alive"])
        count = int(live)
        finish(state["radiance"], perm[count:])  # the paths that ended
        keep = perm[:count]
        state, seed, pixel = _take(state, keep), seed[keep], pixel[keep]
    # paths alive at the bounce cap add their raw throughput
    finish(state["radiance"] + state["color"], torch.arange(count, device=dev))
    return color, normal, depth, rays
