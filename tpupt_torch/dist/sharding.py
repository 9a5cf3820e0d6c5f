"""Row-band sharding over a ``torch.distributed`` group (counterpart of
``tpupt/dist/sharding.py``).

The image is split into horizontal row bands, one per rank of the group;
every rank traces its band with the same replicated scene, with no
communication in a render's bounce loop (except one live flag a bounce
in a differentiable render whose gradients are reduced per bounce).  The RNG and the camera
key off global pixel indices (``integrator._band_pixels``), so the bands
together are the single-process render, bit for bit.  For a training
step, the per-band losses and the scene-parameter gradients are summed
over the group (``diff.overlap``).

Every function here is called on every rank of the group, after
``init_distributed`` (re-exported here).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpupt_torch.core.types import Camera, RenderBuffers, SceneArrays
from tpupt_torch.diff.params import extract_params, with_params
from tpupt_torch.dist.bootstrap import init_distributed  # noqa: F401  (re-export)
from tpupt_torch.render.integrator import MAX_BOUNCES_DEFAULT, render_image


def make_tile_mesh(n_tiles: int | None = None):
    """The process group of ranks [0, n_tiles) (the world by default).
    Every rank of the world calls it; ranks past ``n_tiles`` get
    ``GroupMember.NON_GROUP_MEMBER``."""
    world = dist.get_world_size()
    if n_tiles is None:
        return dist.group.WORLD
    n = int(n_tiles)
    if n > world:
        raise ValueError(f"requested {n} tiles but the world has only {world} ranks")
    return dist.new_group(list(range(n)))


def _band_layout(height: int, group) -> tuple[int, int, int]:
    """(ranks in ``group``, rows per band, this rank's band)."""
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError(f"rank {dist.get_rank()} is not in the group")
    n = dist.get_world_size(group)
    if height % n:
        raise ValueError(f"image height {height} not divisible by {n} ranks")
    return n, height // n, rank


def _gather_bands(band, rank, n, group):
    """The ranks' equal bands (rows of ``band``) stacked in rank order, on
    every rank: one sum all-reduce of buffers that hold -0.0 outside each
    rank's band.  -0.0 is the identity of float addition (x + -0.0 == x for
    every x, +0.0 and NaN included), so every bit comes through, the sign
    of zero too.  Every backend takes it for CUDA tensors, where gloo has
    no all-gather; it sends the whole image from every rank, n times an
    all-gather's traffic."""
    full = band.new_full((n * band.shape[0], *band.shape[1:]), -0.0)
    full[rank * band.shape[0]:(rank + 1) * band.shape[0]] = band
    dist.all_reduce(full, group=group)
    return full


def render_image_sharded(
    scene: SceneArrays,
    camera: Camera,
    width: int,
    height: int,
    spp: int = 1,
    mesh=None,
    max_bounces: int = MAX_BOUNCES_DEFAULT,
    rr_start: int | None = None,
    start_iteration: int = 0,
    chain_samples: bool = True,
):
    """Band-sharded progressive render: rank r of ``mesh`` (a process
    group, the world by default) renders rows [r * height / n, (r + 1) *
    height / n).  Returns, on every rank, (RenderBuffers of the whole image,
    total traced segments) as ``render_image`` does, the bands gathered
    bit for bit (``_gather_bands``)."""
    group = make_tile_mesh() if mesh is None else mesh
    n, rows, rank = _band_layout(height, group)
    buf, rays = render_image(scene, camera, width, height, spp, max_bounces=max_bounces,
                             rr_start=rr_start, start_iteration=start_iteration,
                             chain_samples=chain_samples, row0=rank * rows, rows=rows)
    full = _gather_bands(torch.cat([buf.color, buf.normal, buf.depth[:, None]], dim=1), rank, n,
                         group)
    rays = rays.clone()
    dist.all_reduce(rays, group=group)
    buffers = RenderBuffers(color=full[:, 0:3], normal=full[:, 3:6], depth=full[:, 6],
                            iteration=start_iteration + spp)
    return buffers, rays


def render_loss_and_grads_sharded(
    scene: SceneArrays,
    camera: Camera,
    target,
    width: int,
    height: int,
    spp: int = 1,
    mesh=None,
    max_bounces: int = MAX_BOUNCES_DEFAULT,
    rr_start: int | None = None,
    overlap_grad_psum: bool = True,
):
    """One sharded fwd+bwd step: every rank renders its band
    differentiably and takes sum((band color - its rows of ``target``)^2)
    (``target`` flat (W*H, 3), row-major); the loss is summed over the
    group and the scene-parameter gradients are all-reduced in the
    backward pass, per bounce (``overlap_grad_psum``) or once per sample
    (``diff.overlap``; post-hoc makes the fewer collectives).  Either way
    they are those of the single-process render up to the order of float
    additions.

    Returns (the global loss, a 0-dim tensor; gradients shaped as
    ``extract_params(scene)``), the same on every rank."""
    group = make_tile_mesh() if mesh is None else mesh
    _, rows, rank = _band_layout(height, group)
    params = extract_params(scene)
    buf, _ = render_image(with_params(scene, params), camera, width, height, spp,
                          max_bounces=max_bounces, rr_start=rr_start, differentiable=True,
                          row0=rank * rows, rows=rows, grad_psum_axis=group,
                          grad_psum_overlap=overlap_grad_psum)
    band = slice(rank * rows * width, (rank + 1) * rows * width)
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device)[band]
    loss = ((buf.color - target) ** 2).sum()
    loss.backward()

    def grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad

    grads = {k: grad(v) for k, v in params.items() if k != "materials"}
    grads["materials"] = {k: grad(v) for k, v in params["materials"].items()}
    total = loss.detach().clone()
    dist.all_reduce(total, group=group)
    return total, grads
