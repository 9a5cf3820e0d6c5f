"""The path-tracing integrator (counterpart of
``tpupt/render/integrator.py``).

The whole flat ray batch goes through a bounce loop with masked lanes.

Forward: samples are chained per lane.  The moment a lane's path dies it
folds the sample into its own (n-1)/n running average and starts its next
sample, so the loop runs for the maximum over lanes of the summed path
lengths (at most spp * max_bounces trips) instead of spp times the deepest
path.  RNG is counter-based on (pixel, sample, bounce, lane), so the result
is that of the per-sample loop, with the same ray count.  The port runs
this as one flat loop with a host check for live lanes on every trip.

Differentiable (``differentiable=True``): a loop over samples, each
``trace_sample``: the treelet table is rebaked from the scene's positions,
the slot table is built once, and each bounce finds its hit ids with the
sweep's payload form outside autograd and recomputes the hit in closed
form (``intersect.refine_hit``) under it.  The whole graph is kept for the
backward pass; the sweep never runs in it.

The JAX package's compaction ladders (forward and differentiable) are
scheduling only and are left out.  Emitters (next-event estimation) are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from tpupt_torch.core import camera as cam
from tpupt_torch.core import vec
from tpupt_torch.core.types import OBJ_MESH, Camera, RenderBuffers, SceneArrays
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.intersect import (
    background_color,
    intersect_scene_ids,
    intersect_scene_ids_diff,
    refine_hit,
    slot_tri_table,
)
from tpupt_torch.render.materials import russian_roulette, shade
from tpupt_torch.sampling.rng import jitter_counters, pixel_seed, uniform
from tpupt_torch.scene.bake import rebake_treelets

MAX_BOUNCES_DEFAULT = 50  # reference max_bounces


def _fresh_state(scene, camera, width, height, pix, iteration):
    """Jittered primary ray and path state for every lane; ``iteration``
    may be per lane."""
    seed = pixel_seed(pix, iteration)
    c0, c1 = jitter_counters()
    fx = (pix % width).to(torch.float32) + uniform(seed, c0)
    fy = (pix // width).to(torch.float32) + uniform(seed, c1)
    ro, rd = cam.generate_rays(camera, width, height, fx, fy)
    zf = torch.zeros_like(fx)
    state = dict(
        ro=ro,
        rd=rd,
        t_min=torch.full_like(zf, cam.T_MIN_PRIMARY),
        # radiance accumulates (throughput x emission|background); color is
        # the running throughput product
        radiance=Vec3(zf, zf, zf),
        color=Vec3(zf + 1.0, zf + 1.0, zf + 1.0),
        alive=torch.ones_like(zf, dtype=torch.bool),
        normal=-rd,
        depth=torch.full_like(zf, 1e6),
    )
    return state, seed


def _weighted_emission(radiance, state, emitted, hit_alive):
    """Add the hit surface's emission.  Without next-event estimation
    (the only case ported) its weight is 1."""
    return vec.where(hit_alive, radiance + state["color"] * emitted, radiance)


def _bounce_body(scene, seed, state, bounce, rr_start, intersect_fn, use_refine=False,
                 tri_table=None):
    """One bounce over all lanes; ``bounce`` is per lane or one int.

    ``use_refine``: ``intersect_fn`` is an ids pass that returns (ids,
    tri_vals) (``intersect_scene_ids_diff``), and the hit is recomputed
    differentiably by ``refine_hit``, with ``tri_table`` as the slot table
    of the triangle rows."""
    alive = state["alive"]
    if use_refine:
        ids, tri_vals = intersect_fn(scene, state["ro"], state["rd"], state["t_min"], alive)
        if tri_vals is not None and tri_table is not None:
            tri_vals = dict(tri_vals, table=tri_table)
        hit = refine_hit(scene, state["ro"], state["rd"], state["t_min"], ids, tri_vals)
    else:
        _ids, hit = intersect_fn(scene, state["ro"], state["rd"], state["t_min"], alive)
    hit_alive = alive & hit.mask
    miss = alive & ~hit.mask

    # background light on miss
    radiance = vec.where(
        miss,
        state["radiance"] + state["color"] * background_color(scene, state["rd"]),
        state["radiance"],
    )

    first = bounce == 0
    normal = vec.where(first & hit.mask, hit.normal, state["normal"])
    depth = torch.where(first & hit.mask, hit.t, state["depth"])

    new_ro, new_rd, new_t_min, new_color, emitted, absorb, _spec, _pdf = shade(
        scene, hit, state["ro"], state["rd"], state["t_min"], state["color"], seed, bounce
    )
    radiance = _weighted_emission(radiance, state, emitted, hit_alive)
    out = dict(
        ro=vec.where(hit_alive, new_ro, state["ro"]),
        rd=vec.where(hit_alive, new_rd, state["rd"]),
        t_min=torch.where(hit_alive, new_t_min, state["t_min"]),
        radiance=radiance,
        color=vec.where(hit_alive, new_color, state["color"]),
        alive=hit_alive & ~absorb,
        normal=normal,
        depth=depth,
    )
    if rr_start is not None:
        # survivors divide throughput by the survival probability; killed
        # lanes keep the radiance collected so far
        tp, al = russian_roulette(out["color"], out["alive"], seed, bounce)
        apply = bounce >= rr_start
        if not isinstance(apply, torch.Tensor):  # one bounce for every lane
            apply = torch.full_like(al, apply)
        out["color"] = vec.where(apply & al, tp, out["color"])
        out["alive"] = torch.where(apply, al, out["alive"])
    return out


def accumulate(buffers: RenderBuffers, color, normal, depth) -> RenderBuffers:
    """Progressive average: new = (old*(n-1) + x) / n."""
    it = buffers.iteration
    nf = torch.tensor(float(it + 1), device=color.device)

    def acc(old, new):
        return new if it == 0 else (old * (nf - 1.0) + new) / nf

    return RenderBuffers(
        color=acc(buffers.color, color),
        normal=acc(buffers.normal, normal),
        depth=acc(buffers.depth, depth),
        iteration=it + 1,
    )


def _render_chained(scene, camera, width, height, spp, max_bounces, rr_start,
                    start_iteration, intersect_fn):
    """Forward render with per-lane sample chaining, one flat loop."""
    dev = scene.device
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    it0 = int(start_iteration)

    st, seed = _fresh_state(scene, camera, width, height, pix, it0)
    zf = st["depth"] * 0.0
    zi = torch.zeros_like(pix)
    bounce, k, segs = zi, zi, zi  # per-lane bounce, finished samples, segments
    done = torch.zeros_like(pix, dtype=torch.bool)
    acc_color = acc_normal = Vec3(zf, zf, zf)
    acc_depth = zf

    for _ in range(spp * max_bounces):  # every lane is done by this bound
        if not bool((~done).any()):
            break
        st2 = _bounce_body(scene, seed, st, bounce, rr_start, intersect_fn)
        segs = segs + st["alive"].long()
        b2 = bounce + 1
        capped = st2["alive"] & (b2 >= max_bounces)
        ended = ~done & (~st2["alive"] | capped)

        # fold the finished sample: radiance, plus the raw throughput of
        # paths cut by the bounce cap
        final = vec.where(capped, st2["radiance"] + st2["color"], st2["radiance"])
        git = it0 + k  # global iteration index of the finished sample
        nf = (git + 1).to(torch.float32)
        first = git == 0

        def acc1(old, new):
            mixed = (old * (nf - 1.0) + new) / nf
            return torch.where(ended, torch.where(first, new, mixed), old)

        def acc3(old, new):
            return Vec3(acc1(old.x, new.x), acc1(old.y, new.y), acc1(old.z, new.z))

        acc_color = acc3(acc_color, final)
        acc_normal = acc3(acc_normal, st2["normal"])
        acc_depth = acc1(acc_depth, st2["depth"])

        k = torch.where(ended, k + 1, k)
        done = done | (ended & (k >= spp))
        need = ended & (k < spp)

        fresh, fresh_seed = _fresh_state(scene, camera, width, height, pix, it0 + k)
        st = {}
        for key in fresh:
            if key == "alive":
                st[key] = torch.where(need, True, st2[key] & ~ended)
            elif isinstance(fresh[key], Vec3):
                st[key] = vec.where(need, fresh[key], st2[key])
            else:
                st[key] = torch.where(need, fresh[key], st2[key])
        seed = torch.where(need, fresh_seed, seed)
        bounce = torch.where(need, 0, b2)

    buffers = RenderBuffers(
        color=acc_color.to_array(),
        normal=acc_normal.to_array(),
        depth=acc_depth,
        iteration=it0 + spp,
    )
    return buffers, segs.sum()


def trace_sample(scene, camera, width, height, iteration, max_bounces, rr_start=None,
                 intersect_fn=intersect_scene_ids_diff):
    """One differentiable sample per pixel.  Returns (color (N, 3), normal
    (N, 3), depth (N,), traced segments as a 0-dim int64 tensor), all but
    the count differentiable in the scene's float leaves.

    The treelet table is rebaked from ``scene.positions`` first, so the
    traced geometry is that of the parameters and the sweep's payload
    copies the rows of the slot table built here once.  The bounce loop
    stops early once no lane is alive: a dead lane changes nothing."""
    tri_table = None
    if any(k == OBJ_MESH for k in scene.s_obj_kind):
        scene = rebake_treelets(scene)
        tri_table = slot_tri_table(scene)
    pix = torch.arange(width * height, dtype=torch.int64, device=scene.device)
    state, seed = _fresh_state(scene, camera, width, height, pix, iteration)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for b in range(max_bounces):
        if not bool(state["alive"].any()):
            break
        rays = rays + state["alive"].sum()
        state = _bounce_body(scene, seed, state, b, rr_start, intersect_fn, use_refine=True,
                             tri_table=tri_table)
    # paths alive at the bounce cap add their raw throughput
    final = vec.where(state["alive"], state["radiance"] + state["color"], state["radiance"])
    return final.to_array(), state["normal"].to_array(), state["depth"], rays


def _render_samples(scene, camera, width, height, spp, max_bounces, rr_start,
                    start_iteration, intersect_fn):
    """The differentiable render: ``spp`` samples, each a ``trace_sample``,
    folded by ``accumulate``."""
    n = width * height
    zero = torch.zeros((n, 3), device=scene.device)
    buffers = RenderBuffers(color=zero, normal=zero, depth=zero[:, 0],
                            iteration=int(start_iteration))
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for it in range(start_iteration, start_iteration + spp):
        color, normal, depth, r = trace_sample(scene, camera, width, height, it, max_bounces,
                                               rr_start, intersect_fn)
        buffers = accumulate(buffers, color, normal, depth)
        rays = rays + r
    return buffers, rays


def render_image(
    scene: SceneArrays,
    camera: Camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = MAX_BOUNCES_DEFAULT,
    differentiable: bool = False,
    rr_start: int | None = None,
    start_iteration: int = 0,
    intersect_fn=None,
    chain_samples: bool = True,
    device=None,
):
    """Render ``spp`` progressive samples on ``device`` (default: the
    scene's).  Returns (RenderBuffers, total traced segments as a 0-dim
    int64 tensor).

    ``differentiable=True`` records the render for autograd: its buffers
    are differentiable in the scene's float leaves (``diff.extract_params``
    / ``with_params``).  Otherwise it runs the chained forward loop under
    ``torch.no_grad()``.  ``intersect_fn`` is the hit pass: by default
    ``intersect_scene_ids`` forward and ``intersect_scene_ids_diff`` when
    differentiable (the twin: either with ``closest_hit=
    sweep_kernel.treelet_closest_hit_plain`` bound)."""
    if not chain_samples and not differentiable:
        raise NotImplementedError("only the sample-chained forward loop is ported")
    if scene.has_nee:
        raise NotImplementedError(
            "scenes with emitters need next-event estimation, not ported yet"
        )
    if device is not None:
        scene = scene.to(device)
    camera = camera.to(scene.device)
    if differentiable:
        return _render_samples(scene, camera, width, height, spp, max_bounces, rr_start,
                               start_iteration, intersect_fn or intersect_scene_ids_diff)
    with torch.no_grad():
        return _render_chained(scene, camera, width, height, spp, max_bounces, rr_start,
                               start_iteration, intersect_fn or intersect_scene_ids)
