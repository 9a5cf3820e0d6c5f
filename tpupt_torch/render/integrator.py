"""The forward path-tracing integrator (counterpart of
``tpupt/render/integrator.py``, forward rendering only).

The whole flat ray batch goes through a bounce loop with masked lanes.
Samples are chained per lane: the moment a lane's path dies it folds the
sample into its own (n-1)/n running average and starts its next sample,
so the loop runs for the maximum over lanes of the summed path lengths
(at most spp * max_bounces trips) instead of spp times the deepest path.
RNG is counter-based on (pixel, sample, bounce, lane), so the result is
that of the per-sample loop, with the same ray count.

The port runs this as one flat loop with a host check for live lanes on
every trip.  The JAX package's packet-row compaction ladder is scheduling
only and is left out.  Emitters (next-event estimation) and the
differentiable path are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from tpupt_torch.core import camera as cam
from tpupt_torch.core import vec
from tpupt_torch.core.types import Camera, RenderBuffers, SceneArrays
from tpupt_torch.core.vec import Vec3
from tpupt_torch.render.intersect import background_color, intersect_scene_ids
from tpupt_torch.render.materials import russian_roulette, shade
from tpupt_torch.sampling.rng import jitter_counters, pixel_seed, uniform

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


def _bounce_body(scene, seed, state, bounce, rr_start, intersect_fn):
    """One bounce over all lanes; ``bounce`` is per lane."""
    alive = state["alive"]
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


@torch.no_grad()
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
    intersect_fn=intersect_scene_ids,
    chain_samples: bool = True,
    device=None,
):
    """Render ``spp`` progressive samples on ``device`` (default: the
    scene's).  Returns (RenderBuffers, total traced segments as a 0-dim
    int64 tensor)."""
    if differentiable:
        raise NotImplementedError("the differentiable renderer is not ported yet")
    if not chain_samples:
        raise NotImplementedError("only the sample-chained forward loop is ported")
    if scene.has_nee:
        raise NotImplementedError(
            "scenes with emitters need next-event estimation, not ported yet"
        )
    if device is not None:
        scene = scene.to(device)
    camera = camera.to(scene.device)
    return _render_chained(scene, camera, width, height, spp, max_bounces, rr_start,
                           start_iteration, intersect_fn)
