"""The path-tracing integrator (counterpart of
``tpupt/render/integrator.py``).

The whole flat ray batch goes through a bounce loop with masked lanes.

Forward: samples are chained per lane.  The moment a lane's path dies it
folds the sample into its own (n-1)/n running average and starts its next
sample, so the loop runs for the maximum over lanes of the summed path
lengths (at most spp * max_bounces trips) instead of spp times the deepest
path.  RNG is counter-based on (pixel, sample, bounce, lane), so the result
is that of the per-sample loop, with the same ray count.  The port runs
this as one flat loop with a host check for live lanes on every trip; on
the card, a scene without meshes or emitters hands its lanes to one
``trip_kernel.trip_drain`` launch once they fit in one resident wave of it
(``_run_trips``).

Three routes run the loops (``render_route``).  A forward render through
the default hit pass (and, with emitters, the default shadow sweep) takes
the trip route: per trip the CUDA kernels ``trip_kernel.trip_head``, with
emitters ``trip_nee`` and the any-hit sweep, and ``trip_tail`` around the
closest-hit sweep, over the lane state in SoA device buffers, and one
4-byte read of the lanes left (``_run_trips``).  A differentiable sample
of a scene without emitters through the default ids pass takes the
differentiable trip (``diff_trip.DiffTrip``: per bounce ``trip_head``, the
payload sweep and ``diff_trip_fwd``; backward one ``diff_trip_bwd`` per
bounce, the slot table's scatter inside it).  Everything else takes the body route,
``_bounce_body`` in torch (under autograd when differentiable), which both
trips equal bit for bit (any other ``intersect_fn``, even
``functools.partial(intersect_scene_ids)``, or ``any_hit`` takes it).

Per sample (``chain_samples=False``, and every differentiable render): a
loop over samples, each one ``trace_sample`` folded in by ``accumulate``.
A forward ``trace_sample`` is a flat bounce loop over the closest-hit
pass.  A differentiable one (``differentiable=True``) rebakes the treelet
table from the scene's positions, builds the slot table once, and each
bounce finds its hit ids with the sweep's payload form outside autograd
and recomputes the hit in closed form (``intersect.refine_hit``) under
it.  The body route keeps the whole graph for the backward pass; the
differentiable trip keeps each bounce's inputs and hit and recomputes the
bounce backward.  The sweep never runs backward.

Scenes with emitters run next-event estimation (NEE) with multiple
importance sampling (MIS): every diffuse hit also samples each sphere
light (up to ``NEE_UNROLL_MAX``; above, one light per lane) and the
emissive-mesh triangles, and sends a shadow ray through
``intersect.occlusion_anyhit``; an emissive surface that a diffuse bounce
hits gets the balance heuristic's weight.  NEE is a sample step
(``_nee_samples``), each term's shadow test (``_shadow_lit``) and a
resolve step (``_nee_resolve``); the trip route puts the sample step and
the shadow rays' sphere test in ``trip_nee``, their mesh test in one
any-hit call, and the resolve step in ``trip_tail``.

Row bands (``row0``, ``rows``) render rows [row0, row0 + rows) of the
image: the RNG and the camera stay keyed on the global pixel, so a band
equals the same rows of the whole image.  They are the unit of
``dist.sharding``, whose differentiable renders all-reduce the scene's
cotangents over a process group (``grad_psum_axis``) per bounce or once
(``diff.overlap``).

While a ``torch.profiler`` session runs, the loops mark their stages as
spans of ``utils.trace`` (a render, a trip's set-up, issue, read of the
lanes left and finish; a differentiable sample's plan and accumulate) and
count each trip's live and launched lanes; otherwise a span costs one call
of the profiler's flag.

The JAX package's compaction ladders (forward and differentiable) are
scheduling only and are left out.  The shadow rays take the any-hit
test, whose sweep is ``any_hit``, except under a reference intersector,
which traces them by its own closest hit (``_closest_hit_shadows``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from tpupt_torch.core import camera as cam
from tpupt_torch.core import vec
from tpupt_torch.core.types import (
    MAT_DIFFUSE,
    OBJ_MESH,
    PRIM_NONE,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    Camera,
    RenderBuffers,
    SceneArrays,
    table_rows,
)
from tpupt_torch.core.vec import Vec3
from tpupt_torch.accel import sweep_kernel
from tpupt_torch.diff.overlap import psum_in_backward
from tpupt_torch.render.intersect import (
    background_color,
    intersect_scene_ids,
    intersect_scene_ids_diff,
    occlusion_anyhit,
    refine_hit,
    slot_tri_table,
)
from tpupt_torch.render.materials import (
    INV_PI,
    _material_rows,
    russian_roulette,
    sample_light_sphere,
    shade,
)
from tpupt_torch.sampling.rng import bounce_counter, jitter_counters, pixel_seed, uniform
from tpupt_torch.render import diff_trip
from tpupt_torch.render import trip_kernel as tk
from tpupt_torch.scene.bake import rebake_treelets
from tpupt_torch.utils import debug, trace

MAX_BOUNCES_DEFAULT = 50  # reference max_bounces


def _band_pixels(width, rows, row0, device):
    """Global pixel index of each lane of the band of ``rows`` rows from
    row ``row0`` (the unit of row sharding), row-major.  The JAX package's
    tile swizzle is disabled there and left out here."""
    return row0 * width + torch.arange(width * rows, dtype=torch.int64, device=device)


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
    if scene.has_nee:
        # the last scatter was specular (or there was none): an emitter hit
        # next takes full weight; after a diffuse scatter it takes the MIS
        # weight of pdf_w, the solid-angle pdf of that scatter (0 = delta).
        # Only NEE's emission weight reads them.
        state.update(spec=torch.ones_like(zf, dtype=torch.bool), pdf_w=zf)
    return state, seed


# Up to this many sphere lights, every diffuse hit samples each of them
# (one shadow test per light); above it, each lane samples one light chosen
# uniformly and weights it by the light count.
NEE_UNROLL_MAX = 4
_TWO_PI = 6.283185307179586


def _zero3(like):
    z = torch.zeros_like(like)
    return Vec3(z, z, z)


def _light_emission(scene, li: int) -> Vec3:
    """Emission of sphere light ``li``, read from ``materials.emission`` so
    that its gradient covers the NEE term."""
    return Vec3(*scene.materials.emission[scene.s_light_mats[li]].unbind())


def _cone_pdf(ro, center, radius, selection):
    """(ro outside the sphere, the cone-sampling pdf of the sphere seen
    from ro times ``selection``), as ``sample_light_sphere`` samples it."""
    oc = ro - center
    d2 = oc.dot(oc)
    sin2 = torch.clamp(radius * radius / torch.clamp(d2, min=1e-12), 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
    return d2 > radius * radius, torch.div(selection, torch.clamp(_TWO_PI * (1.0 - cos_max),
                                                                    min=1e-12))


def _light_pdf_at_hit(scene, obj_id, kind, hit, ro, rd, absorb):
    """Solid-angle pdf with which NEE would have sampled this emitter hit
    from ``ro``: the light side of the balance heuristic for an emitter
    that a bounce hit.  Sphere lights: the cone pdf (times 1/nl when one
    light is sampled per lane); emissive triangles: t^2 / (cos_l * total
    area).  0 where NEE could not have sampled the hit (the weight is 1
    there)."""
    pl = torch.zeros_like(hit.t)
    nl = len(scene.s_light_objs)
    if nl > NEE_UNROLL_MAX:
        objs = torch.tensor(scene.s_light_objs, device=obj_id.device)
        match = obj_id[:, None] == objs[None, :]  # (N, nl)
        table = torch.cat([scene.nee_center, scene.nee_radius[:, None]], dim=1)
        rows = table_rows(table, match.to(torch.int64).argmax(dim=1))
        outside, pdf = _cone_pdf(ro, Vec3(*rows[:, :3].unbind(1)), rows[:, 3],
                                 pl.new_tensor(1.0 / nl))
        pl = torch.where(match.any(dim=1) & (kind == PRIM_SPHERE) & outside, pdf, pl)
    else:
        for li, lo in enumerate(scene.s_light_objs):
            outside, pdf = _cone_pdf(ro, Vec3(*scene.nee_center[li].unbind()),
                                     scene.nee_radius[li], pl.new_tensor(1.0))
            pl = torch.where((obj_id == lo) & (kind == PRIM_SPHERE) & outside, pdf, pl)
    if scene.s_tri_light_count > 0:
        # hit.normal faces against the unit ray, so cos_l = -(rd . n); t is
        # BIG where nothing was hit and is zeroed off the taken lanes, which
        # keeps t * t and the backward of the quotient finite
        take = absorb & (kind == PRIM_TRIANGLE)
        t = torch.where(take, hit.t, 0.0)
        cos_l = torch.clamp(-rd.dot(hit.normal), min=1e-6)
        p_tri = t * t / (cos_l * torch.clamp(scene.tri_light_area, min=1e-30))
        pl = torch.where(take, p_tri, pl)
    return pl


def _weighted_emission(scene, radiance, state, ids, hit, emitted, absorb, hit_alive):
    """Add the hit surface's emission.  Without emitters to sample its
    weight is 1; with NEE, 1 after a specular scatter (NEE cannot sample
    a delta lobe) and the balance heuristic pdf_w / (pdf_w + pdf_light)
    after a diffuse one (the NEE terms carry the complement)."""
    if not scene.has_nee:
        return vec.where(hit_alive, radiance + state["color"] * emitted, radiance)
    pl = _light_pdf_at_hit(scene, ids.obj_id, ids.kind, hit, state["ro"], state["rd"], absorb)
    pb, spec = state["pdf_w"], state["spec"]
    # the denominator is 1 on specular lanes too, so that its backward
    # never divides by 1e-20 squared
    w = torch.where(spec, 1.0, pb / torch.where(spec, 1.0, torch.clamp(pb + pl, min=1e-20)))
    return vec.where(hit_alive & absorb, radiance + state["color"] * emitted * w, radiance)


class NeeTerm(NamedTuple):
    """One term of NEE's sum, as the sample step leaves it: per lane a
    point on the light (a sphere light's cone sample, or a point on the
    emissive-mesh triangles), its shadow ray from ``p`` along the unit
    ``direction`` over [1e-4, ``t_limit``], the lanes whose sample is
    valid (``active``), the light's object id that the ray's sphere test
    skips (``light``: an int, or per lane; -1 for the mesh term) and the
    contribution the term adds where the ray is unoccluded.  ``kind`` says
    how the resolve step adds it: "mesh" (the sum's first term), "light"
    (one of the unrolled sphere lights) or "sampled" (one sphere light per
    lane)."""

    kind: str
    contrib: Vec3
    p: Vec3
    direction: Vec3
    t_limit: torch.Tensor
    active: torch.Tensor
    light: object


def _t_light(p, direction, center, radius):
    """Distance along the unit ``direction`` from ``p`` to the near side of
    the sphere light: the end of its shadow window."""
    oc = p - center
    b = direction.dot(oc)
    disc = torch.clamp(b * b - (oc.dot(oc) - radius * radius), min=0.0)
    return -b - torch.sqrt(disc)


def _nee_samples(scene, hit, throughput, seed, bounce, alive) -> list:
    """The sample step of next-event estimation from every diffuse hit: the
    emissive-mesh term (``_nee_mesh_sample``) and, for sphere lights, one
    MIS-weighted sample of each (up to ``NEE_UNROLL_MAX``) or of one light
    per lane (``_nee_sampled_sample``), as ``NeeTerm``s in the order
    ``_nee_resolve`` adds them."""
    mtype, albedo, *_ = _material_rows(scene, hit.mat_id)
    n = hit.normal
    diffuse = alive & hit.mask & (mtype == MAT_DIFFUSE)
    p = hit.point + n * 1e-4  # the scatter's offset
    terms = []
    if scene.s_tri_light_count > 0:
        terms.append(_nee_mesh_sample(scene, p, n, diffuse, albedo, throughput, seed, bounce))
    if len(scene.s_light_objs) > NEE_UNROLL_MAX:
        terms.append(_nee_sampled_sample(scene, p, n, diffuse, albedo, throughput, seed, bounce))
        return terms
    for li, lo in enumerate(scene.s_light_objs):
        center = Vec3(*scene.nee_center[li].unbind())
        radius = scene.nee_radius[li]
        u1 = uniform(seed, bounce_counter(bounce, 4 + 2 * li))
        u2 = uniform(seed, bounce_counter(bounce, 5 + 2 * li))
        direction, pdf, valid = sample_light_sphere(center, radius, p, u1, u2)
        with torch.no_grad():
            t_light = _t_light(p, direction, center, radius)
        # lambertian f = albedo / pi; with the balance heuristic
        # f * w / pdf = f / (pdf_light + pdf_bsdf)
        p_b = torch.clamp(n.dot(direction), min=0.0) * INV_PI
        contrib = throughput * albedo * (p_b / (pdf + p_b)) * _light_emission(scene, li)
        terms.append(NeeTerm("light", contrib, p, direction, t_light, diffuse & valid, lo))
    return terms


def _nee_sampled_sample(scene, p, n, diffuse, albedo, throughput, seed, bounce) -> NeeTerm:
    """One sphere light per lane, chosen uniformly, its contribution
    weighted by the light count.  The lane's light row [centre, radius,
    emission, object] comes from one ``table_rows`` fetch of an (nl, 8)
    table whose emission columns are rows of ``materials.emission``; the
    light the shadow ray's sphere test skips is per lane."""
    nl = len(scene.s_light_objs)
    dev = p.x.device
    li = torch.clamp((uniform(seed, bounce_counter(bounce, 4)) * nl).long(), max=nl - 1)
    emis = scene.materials.emission[torch.tensor(scene.s_light_mats, device=dev)]
    objs = torch.tensor(scene.s_light_objs, dtype=torch.float32, device=dev)
    table = torch.cat([scene.nee_center, scene.nee_radius[:, None], emis, objs[:, None]], dim=1)
    rows = table_rows(table, li)  # (N, 8)
    center, radius = Vec3(*rows[:, 0:3].unbind(1)), rows[:, 3]
    emit, lo_lane = Vec3(*rows[:, 4:7].unbind(1)), rows[:, 7].long()

    u1 = uniform(seed, bounce_counter(bounce, 5))
    u2 = uniform(seed, bounce_counter(bounce, 6))
    direction, pdf, valid = sample_light_sphere(center, radius, p, u1, u2)
    with torch.no_grad():
        t_light = _t_light(p, direction, center, radius)
    # the technique's pdf is pdf / nl: f * w / (pdf / nl) = f * nl / (pdf + nl * pdf_bsdf)
    p_b = torch.clamp(n.dot(direction), min=0.0) * INV_PI
    scale = p_b * float(nl) / (pdf + float(nl) * p_b)
    return NeeTerm("sampled", throughput * albedo * scale * emit, p, direction, t_light,
                   diffuse & valid, lo_lane)


def _nee_mesh_sample(scene, p, n, diffuse, albedo, throughput, seed, bounce) -> NeeTerm:
    """One point per lane on the emissive-mesh triangles: a triangle
    chosen by area (the CDF inverted by a dense compare-count over the
    <= 512 light triangles), a uniform barycentric point, the lights
    two-sided.  The emission is read from ``materials.emission`` by the
    triangle's material."""
    u_sel = uniform(seed, bounce_counter(bounce, 12))
    u1 = uniform(seed, bounce_counter(bounce, 13))
    u2 = uniform(seed, bounce_counter(bounce, 14))
    cum = scene.tri_light_cum  # (Lt,), the last entry 1
    idx = torch.clamp((u_sel[:, None] >= cum[None, :]).sum(dim=1), max=cum.shape[0] - 1)
    rows = table_rows(scene.tri_light_pack, idx)  # (N, 11)
    p0, e1, e2 = (Vec3(*rows[:, k:k + 3].unbind(1)) for k in (0, 3, 6))
    lmat = rows[:, 10].long()

    su = torch.sqrt(u1)
    x = p0 + e1 * (1.0 - su) + e2 * (u2 * su)
    d = x - p
    dist2 = torch.clamp(d.dot(d), min=1e-12)
    dist = torch.sqrt(dist2)
    direction = d * (1.0 / dist)
    nlv = e1.cross(e2)
    cos_l = direction.dot(nlv).abs() * torch.rsqrt(torch.clamp(nlv.dot(nlv), min=1e-30))
    valid = diffuse & (cos_l > 1e-6)
    # the window stops short of the sampled triangle, which must not
    # occlude itself; no sphere is this light
    t_limit = dist * (1.0 - 1e-3)
    # f * w / pdf_tech with pdf_tech = dist^2 / (cos_l * A), multiplied
    # through by cos_l * A so that a grazing light divides by nothing small
    p_b = torch.clamp(n.dot(direction), min=0.0) * INV_PI
    cla = cos_l * scene.tri_light_area
    scale = p_b * cla / (dist2 + p_b * cla)
    emit = Vec3(*table_rows(scene.materials.emission, lmat).unbind(1))
    return NeeTerm("mesh", throughput * albedo * scale * emit, p, direction, t_limit, valid, -1)


@torch.no_grad()
def _shadow_lit(scene, term: NeeTerm, any_hit, shadow_fn):
    """The lanes of ``term`` whose shadow ray reaches the light: the
    any-hit test of its window, the light itself excluded
    (``intersect.occlusion_anyhit``).  With ``shadow_fn`` (a reference
    intersector, see ``_closest_hit_shadows``), its closest hit from 1e-4
    on: a sphere light is lit where that hit is the light, a mesh point
    where nothing is hit before ``t_limit``; the two agree except at
    exact-t ties."""
    t_min = torch.full_like(term.t_limit, 1e-4)
    if shadow_fn is not None:
        ids, _ = shadow_fn(scene, term.p, term.direction, t_min, term.active)
        if term.kind == "mesh":
            return term.active & ~((ids.kind != PRIM_NONE) & (ids.t <= term.t_limit))
        return term.active & (ids.obj_id == term.light)
    return term.active & ~occlusion_anyhit(scene, term.p, term.direction, t_min, term.t_limit,
                                           term.active, term.light, any_hit)


def _nee_resolve(terms, lits, like) -> Vec3:
    """The resolve step: the terms' contributions on their lit lanes,
    added in ``_nee_samples``'s order (the mesh term first, then each
    unrolled light, or the sampled light's)."""
    zero = _zero3(like)
    total = zero
    for term, lit in zip(terms, lits):
        if term.kind == "mesh":
            total = vec.where(lit, term.contrib, zero)
        elif term.kind == "light":
            total = vec.where(lit, total + term.contrib, total)
        else:
            total = total + vec.where(lit, term.contrib, zero)
    return total


def _closest_hit_shadows(intersect_fn) -> bool:
    """Whether ``intersect_fn`` is a reference intersector
    (``intersect_scene_ids_bvh``, ``cpu_ref.renderer.intersect_scene_ids_brute``):
    as in the JAX package, its renders test shadows by its own closest
    hit, so that they share no shadow sweep with the accelerated render
    they check."""
    return getattr(intersect_fn, "closest_hit_shadows", False)


def _bounce_body(scene, seed, state, bounce, rr_start, intersect_fn, use_refine=False,
                 tri_table=None, any_hit=None):
    """One bounce over all lanes; ``bounce`` is per lane or one int.

    ``use_refine``: ``intersect_fn`` is an ids pass that returns (ids,
    tri_vals) (``intersect_scene_ids_diff``), and the hit is recomputed
    differentiably by ``refine_hit``, with ``tri_table`` as the slot table
    of the triangle rows.  An ids pass that returns no second value (the
    reference intersectors: ``intersect_scene_ids_bvh``, the brute force)
    leaves the hit to ``refine_hit`` from the ids, forward and
    differentiably.  ``any_hit`` is the shadow rays' mesh sweep
    (``packets.intersect_treelets_anyhit``); a reference intersector
    traces the shadow rays itself (``_closest_hit_shadows``).

    The bounce is ``_bounce_shade`` (up to NEE's sample step), each NEE
    term's shadow test, and ``_bounce_finish`` (NEE's resolve step and
    roulette); the trip route's twins are assembled from the same two."""
    alive = state["alive"]
    ids, extra = intersect_fn(scene, state["ro"], state["rd"], state["t_min"], alive)
    if use_refine or extra is None:
        tri_vals = extra if use_refine else None
        if tri_vals is not None and tri_table is not None:
            tri_vals = dict(tri_vals, table=tri_table)
        hit = refine_hit(scene, state["ro"], state["rd"], state["t_min"], ids, tri_vals)
    else:
        hit = extra
    out, terms = _bounce_shade(scene, seed, state, bounce, ids, hit)
    nee = None
    if scene.has_nee:
        shadow_fn = intersect_fn if _closest_hit_shadows(intersect_fn) else None
        nee = _nee_resolve(terms, [_shadow_lit(scene, t, any_hit, shadow_fn) for t in terms],
                           hit.t)
    return _bounce_finish(out, seed, bounce, rr_start, nee)


def _bounce_shade(scene, seed, state, bounce, ids, hit):
    """The bounce on its hit record (``ids``, ``hit``) up to NEE's shadow
    rays: background, the first hit's normal and depth, ``shade``, the
    (MIS-weighted) emission and, for a scene with emitters, NEE's sample
    step.  Returns (the state after the bounce, before NEE's sum and
    roulette; the ``NeeTerm`` list, empty without emitters)."""
    alive = state["alive"]
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

    new_ro, new_rd, new_t_min, new_color, emitted, absorb, specular, new_pdf = shade(
        scene, hit, state["ro"], state["rd"], state["t_min"], state["color"], seed, bounce
    )
    radiance = _weighted_emission(scene, radiance, state, ids, hit, emitted, absorb, hit_alive)
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
    terms = []
    if scene.has_nee:
        out.update(spec=torch.where(hit_alive, specular, state["spec"]),
                   pdf_w=torch.where(hit_alive, new_pdf, state["pdf_w"]))
        terms = _nee_samples(scene, hit, state["color"], seed, bounce, alive)
    return out, terms


def _bounce_finish(out, seed, bounce, rr_start, nee=None):
    """The rest of the bounce on ``_bounce_shade``'s state: NEE's sum
    ``nee`` (``_nee_resolve``; None without emitters) added to the
    radiance, then roulette.  Returns the state after the bounce."""
    if nee is not None:
        out["radiance"] = out["radiance"] + nee
    if rr_start is not None:
        # survivors divide throughput by the survival probability; killed
        # lanes keep the radiance collected so far
        tp, al = russian_roulette(out["color"], out["alive"], seed, bounce)
        apply = bounce >= rr_start
        if not isinstance(apply, torch.Tensor):  # one bounce for every lane
            apply = torch.full_like(al, apply)
        out["color"] = vec.where(apply & al, tp, out["color"])
        out["alive"] = torch.where(apply, al, out["alive"])
    # TPUPT_DEBUG=1 guards on the bounce's outputs (nothing when unset)
    debug.check_finite(
        "bounce radiance/throughput",
        out["radiance"].x, out["radiance"].y, out["radiance"].z,
        out["color"].x, out["color"].y, out["color"].z,
    )
    debug.check_finite("bounce scatter", out["ro"].x, out["rd"].x, out["normal"].x)
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


def _chain_start(pix):
    """The chained loop's per-lane counters and accumulators at the start:
    finished samples ``k``, traced segments, ``done``, and the running
    averages of colour, normal and depth."""
    zf = torch.zeros(pix.shape, device=pix.device)
    zi = torch.zeros_like(pix)
    return dict(k=zi, segs=zi, done=torch.zeros_like(pix, dtype=torch.bool),
                color=Vec3(zf, zf, zf), normal=Vec3(zf, zf, zf), depth=zf)


def _chain_step(scene, camera, width, height, pix, it0, spp, max_bounces, st, st2, seed, bounce,
                ch):
    """The fold and restart of one trip of the chained loop, after the
    bounce body took ``st`` to ``st2``: a lane whose path ended (killed, or
    alive at the bounce cap) folds its sample into its (n-1)/n averages in
    ``ch`` and, while it has samples left, restarts on a fresh primary ray.
    Returns (state, seed, bounce, ch) for the next trip."""
    ch = dict(ch, segs=ch["segs"] + st["alive"].long())
    done, k = ch["done"], ch["k"]
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

    ch["color"] = acc3(ch["color"], final)
    ch["normal"] = acc3(ch["normal"], st2["normal"])
    ch["depth"] = acc1(ch["depth"], st2["depth"])

    k = ch["k"] = torch.where(ended, k + 1, k)
    ch["done"] = done | (ended & (k >= spp))
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
    return st, torch.where(need, fresh_seed, seed), torch.where(need, 0, b2), ch


def _chain_buffers(ch, it0, spp) -> RenderBuffers:
    return RenderBuffers(color=ch["color"].to_array(), normal=ch["normal"].to_array(),
                         depth=ch["depth"], iteration=it0 + spp)


def _render_chained(scene, camera, width, height, spp, max_bounces, rr_start,
                    start_iteration, intersect_fn, any_hit=None, row0=0, rows=None):
    """Forward render with per-lane sample chaining, one flat loop, over
    the band of ``rows`` rows from ``row0`` (the whole image by default),
    through ``_bounce_body`` (the body route)."""
    pix = _band_pixels(width, height if rows is None else rows, row0, scene.device)
    it0 = int(start_iteration)
    st, seed = _fresh_state(scene, camera, width, height, pix, it0)
    bounce, ch = torch.zeros_like(pix), _chain_start(pix)
    for _ in range(spp * max_bounces):  # every lane is done by this bound
        if not bool((~ch["done"]).any()):
            break
        st2 = _bounce_body(scene, seed, st, bounce, rr_start, intersect_fn, any_hit=any_hit)
        st, seed, bounce, ch = _chain_step(scene, camera, width, height, pix, it0, spp,
                                           max_bounces, st, st2, seed, bounce, ch)
    return _chain_buffers(ch, it0, spp), ch["segs"].sum()


def render_route(scene: SceneArrays, differentiable: bool = False, intersect_fn=None,
                 any_hit=None, grad_psum_axis=None, grad_psum_overlap: bool = True,
                 camera: Camera | None = None) -> str:
    """Which loop a render takes, chosen from the call before any launch.

    Forward: "trip" (``trip_kernel``: the sphere pass and the sweep's rows
    in ``trip_head``; with emitters the body up to NEE's shadow rays in
    ``trip_nee`` and the any-hit sweep on their rows; NEE's sum, roulette
    and, chained, the fold and restart in ``trip_tail``) through the
    default hit pass and, with emitters, the default shadow sweep.

    Differentiable: "diff_trip" (``diff_trip.DiffTrip``: per bounce
    ``trip_head``, the payload sweep and ``diff_trip_fwd``; backward
    ``diff_trip_bwd``, the slot table's scatter inside it) for a scene without emitters
    through the default ids pass (``intersect_scene_ids_diff`` with its
    own sweep), unsharded or sharded post hoc (``grad_psum_overlap=False``:
    the scene's cotangents reduced once, before the loop), where the
    gradient reaches only ``diff.extract_params``' leaves (the objects'
    matrices and ``camera``'s need none); any rows.

    "body" (``_bounce_body``) for everything else: any other
    ``intersect_fn`` (the reference intersectors, which share no code
    with what they check, or a sweep passed in), on a scene with emitters
    any other ``any_hit`` and every differentiable render (NEE's terms
    have no backward kernel yet), and per-bounce sharded gradients.  The
    choice is made here, not by a failure: a kernel that does not build
    or launch raises."""
    if differentiable:
        local = not any(t is not None and t.requires_grad for t in (
            scene.obj_m, scene.obj_inv_m, None if camera is None else camera.camera_matrix))
        if (intersect_fn in (None, intersect_scene_ids_diff) and not scene.has_nee and local
                and (grad_psum_axis is None or not grad_psum_overlap)):
            return "diff_trip"
        return "body"
    if intersect_fn not in (None, intersect_scene_ids):
        return "body"
    if scene.has_nee and any_hit not in (None, sweep_kernel.treelet_any_hit):
        return "body"
    return "trip"


def _nee_kinds(scene) -> tuple:
    """The kinds of ``_nee_samples``'s terms, in its order."""
    nl = len(scene.s_light_objs)
    mesh = ("mesh",) if scene.s_tri_light_count > 0 else ()
    return mesh + (("sampled",) if nl > NEE_UNROLL_MAX else ("light",) * nl)


def _trip_plan(scene, camera, width, height, *, spp, max_bounces, rr_start, iteration, chained,
               row0=0, rows=None) -> tk.TripPlan:
    """The trip route's plan of a render of the band of ``rows`` rows
    from ``row0`` (``rows`` None: the whole image), with the body route's
    functions that the twins of ``trip_nee`` and ``trip_tail`` are
    assembled from."""
    pix = _band_pixels(width, height if rows is None else rows, row0, scene.device)
    camera = camera.to(scene.device)

    def shade(st, seed, bounce, ids, hit):
        return _bounce_shade(scene, seed, st, bounce, ids, hit)

    def finish(out, seed, bounce, nee):
        return _bounce_finish(out, seed, bounce, rr_start, nee)

    def fold(st, st2, seed, bounce, ch, lane_pix):
        return _chain_step(scene, camera, width, height, lane_pix, iteration, spp, max_bounces, st,
                           st2, seed, bounce, ch)

    return tk.TripPlan(scene, camera, width, height, row0 * width, pix, spp, max_bounces,
                       rr_start, iteration, chained, shade, finish, _nee_resolve, fold,
                       _nee_kinds(scene))


def _trip_start(plan: tk.TripPlan):
    """(F, I) at the trip loop's start: every lane on its first sample's
    primary ray (``_fresh_state``), the counters at zero."""
    st, seed = _fresh_state(plan.scene, plan.camera, plan.width, plan.height, plan.pix,
                            plan.iteration)
    return tk.pack_state(st, seed, torch.zeros_like(plan.pix), _chain_start(plan.pix))


def _trip_setup(scene, camera, width, height, **kw):
    """The trip route's set-up (span ``tpupt.trip.setup``): the plan
    (``_trip_plan``'s arguments), the lane state at the start and the
    trip buffers with the tail handover's list.  Returns (plan, F, I,
    buf)."""
    with trace.span("tpupt.trip.setup"):
        plan = _trip_plan(scene, camera, width, height, **kw)
        F, I = _trip_start(plan)
        return plan, F, I, tk.trip_buffers(plan, drain=True)


def _run_trips(plan, F, I, buf):
    """The trip route's loop on the lane state (F, I) and the trip
    buffers (``_trip_setup``): per trip ``trip_head``, the closest-hit
    sweep on its packed rows (scenes with a mesh), with emitters
    ``trip_nee`` and the any-hit sweep on its shadow rows (every NEE term
    in one call; scenes with a mesh), ``trip_tail`` (span
    ``tpupt.trip.issue``; inside it ``tpupt.trip.sweep`` around the
    closest-hit sweep and ``tpupt.trip.nee`` around ``trip_nee`` and the
    any-hit sweep), and one 4-byte read of the lanes still to trace (span
    ``tpupt.trip.wait``).  Counts the lanes live at each
    trip's start (the segments they trace) and the lanes the trips launch
    over.

    The tail handover: a plan without a mesh or emitters stops issuing
    trips once the lanes still to trace fit in one resident wave of
    ``trip_drain`` (the list ``trip_buffers`` holds; none on the CPU), and
    ``trip_drain`` runs them to their end in one launch; one read of the
    lanes it left, which must be none (span ``tpupt.trip.drain``; counter
    ``trip.drain_lanes``).  Returns the lane state (F, I) after the last
    trip."""
    scene = plan.scene
    tre = (scene.tre_min, scene.tre_max, scene.tre_tris, scene.s_leaf_size)
    wave = buf.drain_cap  # 0 for a plan with a mesh or emitters, and on the CPU
    remaining, trips, live = plan.n, 0, 0
    for _ in range(plan.trips_bound):
        if remaining == 0:
            break
        if remaining <= wave:
            with trace.span("tpupt.trip.drain"):
                tk.trip_drain(plan, F, I, buf, plan.trips_bound - trips)
                left = int(buf.count)
            trace.count("trip.drain_lanes", remaining)
            if left:
                raise RuntimeError(f"trip_drain left {left} of {remaining} lanes to trace")
            break
        trips, live = trips + 1, live + remaining
        with trace.span("tpupt.trip.issue"):
            tk.trip_head(plan, F, I, buf)
            sweep = occ = None
            if plan.mesh:
                with trace.span("tpupt.trip.sweep"):
                    sweep = sweep_kernel.treelet_closest_hit(buf.sweep_rows, buf.act_p, *tre)
            if plan.nee:
                with trace.span("tpupt.trip.nee"):
                    tk.trip_nee(plan, F, I, buf, sweep)
                    if plan.mesh:
                        occ = sweep_kernel.treelet_any_hit(buf.shadow_rows, buf.nee_mask, *tre)
                tk.trip_tail(plan, F, I, buf, occ=occ)
            else:
                tk.trip_tail(plan, F, I, buf, sweep)
        if debug.enabled():  # TPUPT_DEBUG=1 guards on the trip's outputs
            debug.check_finite("bounce radiance/throughput", *tk.rows(F, tk.RADIANCE + tk.COLOR))
            debug.check_finite("bounce scatter", *tk.rows(F, ("rox", "rdx", "nx")))
        with trace.span("tpupt.trip.wait"):
            remaining = int(buf.count)
    trace.count("trip.live_lanes", live)
    trace.count("trip.lanes_launched", trips * plan.n)
    return F, I


def _render_chained_trips(scene, camera, width, height, spp, max_bounces, rr_start,
                          start_iteration, row0=0, rows=None):
    """``_render_chained`` through the trip kernels."""
    plan, F, I, buf = _trip_setup(scene, camera, width, height, spp=spp,
                                  max_bounces=max_bounces, rr_start=rr_start,
                                  iteration=int(start_iteration), chained=True, row0=row0,
                                  rows=rows)
    F, I = _run_trips(plan, F, I, buf)
    with trace.span("tpupt.trip.finish"):
        chain = tk.unpack_state(F, I)["chain"]
        # a row of the lane state is a view: a copy lets the state go
        chain["depth"] = chain["depth"].clone()
        return _chain_buffers(chain, plan.iteration, spp), chain["segs"].sum()


def _partition_perm(alive: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition permutation, live lanes first: ``perm[j]`` is the
    lane that moves to position j.  Built from prefix sums and one
    scatter.  Returns (perm (N,) int64, live count as a 0-dim tensor)."""
    n = alive.shape[0]
    alive_i = alive.to(torch.int64)
    count = alive_i.sum()
    pos_live = torch.cumsum(alive_i, 0) - 1
    pos_dead = count + torch.cumsum(1 - alive_i, 0) - 1
    dest = torch.where(alive, pos_live, pos_dead)
    lanes = torch.arange(n, dtype=torch.int64, device=alive.device)
    return torch.zeros_like(lanes).scatter_(0, dest, lanes), count


def _any_alive(alive, group=None) -> bool:
    """Whether a lane is alive: in this band, or with ``group`` in any
    rank's band (a max all-reduce of the flag)."""
    flag = alive.any()
    if group is not None:
        flag = flag.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag)


def trace_sample(scene, camera, width, height, iteration, max_bounces=MAX_BOUNCES_DEFAULT,
                 differentiable=False, rr_start=None, intersect_fn=None, any_hit=None, row0=0,
                 rows=None, grad_psum_axis=None, grad_psum_overlap=True):
    """One sample per pixel of the band of ``rows`` rows from ``row0``
    (the whole image by default).  Returns (color (N, 3), normal (N, 3),
    depth (N,), traced segments as a 0-dim int64 tensor), N = width *
    rows, in row-major pixel order.

    Forward (the default): a flat bounce loop over ``intersect_fn``
    (default ``intersect_scene_ids``), which hands back the hit record.
    ``differentiable=True``: the treelet table is rebaked from
    ``scene.positions`` first, so the traced geometry is that of the
    parameters and the sweep's payload copies the rows of the slot table
    built here once; each bounce recomputes its hit with ``refine_hit``
    from the ids of ``intersect_fn`` (default ``intersect_scene_ids_diff``),
    and the outputs are differentiable in the scene's float leaves.  NEE's
    shadow rays trace the same table through ``any_hit``.  Either loop
    stops early once no lane is alive: a dead lane changes nothing.

    ``grad_psum_axis`` (a ``torch.distributed`` process group, or None)
    with ``differentiable=True`` all-reduces the scene's cotangents over
    the group in the backward pass, placed as ``grad_psum_overlap`` says:
    per bounce on the scene and once on the slot table, or once on the
    scene before the loop (post-hoc); see ``diff.overlap``.  Per bounce,
    every rank of the group runs as many bounces as the rank whose band
    lives longest, so that the ranks' collectives pair up.

    A forward sample through the default hit pass and shadow sweep runs
    the trip kernels, a differentiable one of a scene without emitters
    through the default ids pass the differentiable trip's
    (``render_route``)."""
    rows = height if rows is None else rows
    route = render_route(scene, differentiable, intersect_fn, any_hit, grad_psum_axis,
                         grad_psum_overlap, camera)
    if route == "trip":
        return _trace_sample_trips(scene, camera, width, height, iteration, max_bounces,
                                   rr_start, row0, rows)
    tri_table = None
    sharded = differentiable and grad_psum_axis is not None
    per_bounce = sharded and grad_psum_overlap
    if sharded and not grad_psum_overlap:
        scene = psum_in_backward(scene, grad_psum_axis)
    if route == "diff_trip":
        return _trace_sample_diff_trips(scene, camera, width, height, iteration, max_bounces,
                                        rr_start, row0, rows)
    if differentiable and any(k == OBJ_MESH for k in scene.s_obj_kind):
        scene = rebake_treelets(scene)
        tri_table = slot_tri_table(scene)
        if per_bounce:
            tri_table = psum_in_backward(tri_table, grad_psum_axis)
    fn = intersect_fn or (intersect_scene_ids_diff if differentiable else intersect_scene_ids)
    pix = _band_pixels(width, rows, row0, scene.device)
    state, seed = _fresh_state(scene, camera, width, height, pix, iteration)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for b in range(max_bounces):
        if not _any_alive(state["alive"], grad_psum_axis if per_bounce else None):
            break
        rays = rays + state["alive"].sum()
        s = psum_in_backward(scene, grad_psum_axis) if per_bounce else scene
        state = _bounce_body(s, seed, state, b, rr_start, fn, use_refine=differentiable,
                             tri_table=tri_table, any_hit=any_hit)
    # paths alive at the bounce cap add their raw throughput
    final = vec.where(state["alive"], state["radiance"] + state["color"], state["radiance"])
    return final.to_array(), state["normal"].to_array(), state["depth"], rays


@torch.no_grad()
def _trace_sample_trips(scene, camera, width, height, iteration, max_bounces, rr_start, row0,
                        rows):
    """The forward ``trace_sample`` through the trip kernels."""
    plan, F, I, buf = _trip_setup(scene, camera, width, height, spp=1, max_bounces=max_bounces,
                                  rr_start=rr_start, iteration=int(iteration), chained=False,
                                  row0=row0, rows=rows)
    F, I = _run_trips(plan, F, I, buf)
    with trace.span("tpupt.trip.finish"):
        out = tk.unpack_state(F, I)
        state = out["state"]
        # paths alive at the bounce cap add their raw throughput
        final = vec.where(state["alive"], state["radiance"] + state["color"], state["radiance"])
        return (final.to_array(), state["normal"].to_array(), state["depth"].clone(),
                out["chain"]["segs"].sum())


def _diff_bounce(scene, state, seed, bounce, ids, tri_vals, rr_start):
    """One bounce of a differentiable sample without emitters on its ids:
    ``refine_hit``, ``_bounce_shade`` and ``_bounce_finish`` (the body
    route's ``_bounce_body`` after its ids pass), which the differentiable
    trip's twins are assembled from."""
    hit = refine_hit(scene, state["ro"], state["rd"], state["t_min"], ids, tri_vals)
    out, _ = _bounce_shade(scene, seed, state, bounce, ids, hit)
    return _bounce_finish(out, seed, bounce, rr_start)


def _trace_sample_diff_trips(scene, camera, width, height, iteration, max_bounces, rr_start,
                             row0, rows):
    """The differentiable ``trace_sample`` of a scene without emitters
    through ``diff_trip.DiffTrip``: the treelet table rebaked from the
    positions (the sweep traces it; no gradient goes through it) and the
    slot table built once, differentiable in the positions (span
    ``tpupt.sample.plan``)."""
    with trace.span("tpupt.sample.plan", device=scene.device):
        table = None
        if any(k == OBJ_MESH for k in scene.s_obj_kind):
            with torch.no_grad():
                scene = rebake_treelets(scene)
            table = slot_tri_table(scene)
        plan = _trip_plan(scene, camera, width, height, spp=1, max_bounces=max_bounces,
                          rr_start=rr_start, iteration=int(iteration), chained=False, row0=row0,
                          rows=rows)
        dp = diff_trip.DiffPlan(plan, None if table is None else table.detach(),
                                functools.partial(_trip_start, plan),
                                functools.partial(_diff_bounce, rr_start=rr_start))
    return diff_trip.trace(dp, table)


def _render_samples(scene, camera, width, height, spp, max_bounces, rr_start,
                    start_iteration, differentiable, intersect_fn, any_hit=None, row0=0,
                    rows=None, grad_psum_axis=None, grad_psum_overlap=True):
    """``spp`` samples, each a ``trace_sample``, folded by ``accumulate``."""
    n = width * (height if rows is None else rows)
    buffers = RenderBuffers.create(n, scene.device, int(start_iteration))
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for it in range(start_iteration, start_iteration + spp):
        color, normal, depth, r = trace_sample(
            scene, camera, width, height, it, max_bounces, differentiable=differentiable,
            rr_start=rr_start, intersect_fn=intersect_fn, any_hit=any_hit, row0=row0, rows=rows,
            grad_psum_axis=grad_psum_axis, grad_psum_overlap=grad_psum_overlap)
        with trace.span("tpupt.sample.accumulate"):
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
    any_hit=None,
    row0: int = 0,
    rows: int | None = None,
    grad_psum_axis=None,
    grad_psum_overlap: bool = True,
):
    """Render ``spp`` progressive samples on ``device`` (default: the
    scene's).  Returns (RenderBuffers, total traced segments as a 0-dim
    int64 tensor).

    ``differentiable=True`` records the render for autograd: its buffers
    are differentiable in the scene's float leaves (``diff.extract_params``
    / ``with_params``).  Otherwise it runs under ``torch.no_grad()``: the
    chained forward loop, or with ``chain_samples=False`` one forward
    ``trace_sample`` per sample (the same ray count; pixels at
    amplified-ulp tolerance).  ``intersect_fn`` is the hit pass: by default
    ``intersect_scene_ids`` forward and ``intersect_scene_ids_diff`` when
    differentiable (the twin: either with ``closest_hit=
    sweep_kernel.treelet_closest_hit_plain`` bound; the reference
    intersectors ``intersect_scene_ids_bvh`` and
    ``cpu_ref.renderer.intersect_scene_ids_brute`` serve both modes).
    ``any_hit`` is the mesh sweep of NEE's shadow rays,
    ``sweep_kernel.treelet_any_hit`` by default (the twin:
    ``treelet_any_hit_plain``).

    ``row0``/``rows`` render the band of ``rows`` rows from ``row0`` (the
    buffers hold width * rows pixels); ``grad_psum_axis`` and
    ``grad_psum_overlap`` are ``trace_sample``'s.

    ``render_route`` picks the loop: the trip kernels for a forward render
    through the default hit pass and shadow sweep, the differentiable trip
    for a differentiable render of a scene without emitters through the
    default ids pass, else ``_bounce_body``.  The call is span
    ``tpupt.render`` of ``utils.trace``."""
    with trace.span("tpupt.render"):
        if device is not None:
            scene = scene.to(device)
        camera = camera.to(scene.device)
        band = dict(row0=row0, rows=rows)
        if differentiable:
            return _render_samples(scene, camera, width, height, spp, max_bounces, rr_start,
                                   start_iteration, True, intersect_fn, any_hit, **band,
                                   grad_psum_axis=grad_psum_axis,
                                   grad_psum_overlap=grad_psum_overlap)
        with torch.no_grad():
            if not chain_samples:
                return _render_samples(scene, camera, width, height, spp, max_bounces,
                                       rr_start, start_iteration, False, intersect_fn, any_hit,
                                       **band)
            if render_route(scene, False, intersect_fn, any_hit) == "trip":
                return _render_chained_trips(scene, camera, width, height, spp, max_bounces,
                                             rr_start, start_iteration, **band)
            return _render_chained(scene, camera, width, height, spp, max_bounces, rr_start,
                                   start_iteration, intersect_fn or intersect_scene_ids,
                                   any_hit, **band)
