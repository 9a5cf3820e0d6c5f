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

Per sample (``chain_samples=False``, and every differentiable render): a
loop over samples, each one ``trace_sample`` folded in by ``accumulate``.
A forward ``trace_sample`` is a flat bounce loop over the closest-hit
pass.  A differentiable one (``differentiable=True``) rebakes the treelet
table from the scene's positions, builds the slot table once, and each
bounce finds its hit ids with the sweep's payload form outside autograd
and recomputes the hit in closed form (``intersect.refine_hit``) under
it.  The whole graph is kept for the backward pass; the sweep never runs
in it.

Scenes with emitters run next-event estimation (NEE) with multiple
importance sampling (MIS): every diffuse hit also samples each sphere
light (up to ``NEE_UNROLL_MAX``; above, one light per lane) and the
emissive-mesh triangles, and sends a shadow ray through
``intersect.occlusion_anyhit``; an emissive surface that a diffuse bounce
hits gets the balance heuristic's weight.

Row bands (``row0``, ``rows``) render rows [row0, row0 + rows) of the
image: the RNG and the camera stay keyed on the global pixel, so a band
equals the same rows of the whole image.  They are the unit of
``dist.sharding``, whose differentiable renders all-reduce the scene's
cotangents over a process group (``grad_psum_axis``) per bounce or once
(``diff.overlap``).

The JAX package's compaction ladders (forward and differentiable) are
scheduling only and are left out.  The shadow rays take the any-hit
test, whose sweep is ``any_hit``, except under a reference intersector,
which traces them by its own closest hit (``_closest_hit_shadows``).
"""

from __future__ import annotations

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
from tpupt_torch.scene.bake import rebake_treelets
from tpupt_torch.utils import debug

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


@torch.no_grad()
def _shadow_lit(scene, p, direction, center, radius, shadow_active, lo, any_hit, shadow_fn):
    """Shadow test toward a point sampled on a sphere light (object ``lo``:
    an int, or per lane): any-hit occlusion of the window [1e-4, distance
    to the light along the unit direction], the light itself excluded.
    With ``shadow_fn`` (a reference intersector, see
    ``_closest_hit_shadows``), whether its closest hit from 1e-4 on is the
    light; the two agree except at exact-t ties."""
    if shadow_fn is not None:
        ids, _ = shadow_fn(scene, p, direction, torch.full_like(p.x, 1e-4), shadow_active)
        return shadow_active & (ids.obj_id == lo)
    oc = p - center
    b = direction.dot(oc)
    disc = torch.clamp(b * b - (oc.dot(oc) - radius * radius), min=0.0)
    t_light = -b - torch.sqrt(disc)
    occ = occlusion_anyhit(scene, p, direction, torch.full_like(b, 1e-4), t_light, shadow_active,
                           lo, any_hit)
    return shadow_active & ~occ


def _nee_direct_light(scene, hit, throughput, seed, bounce, alive, any_hit, shadow_fn=None):
    """Next-event estimation from every diffuse hit: the emissive-mesh
    term (``_nee_mesh_light``) plus, for sphere lights, one MIS-weighted
    sample of each (up to ``NEE_UNROLL_MAX``) or of one light per lane
    (``_nee_sampled_light``).  The shadow rays take ``any_hit``, or the
    closest hit of ``shadow_fn`` when it is given."""
    mtype, albedo, *_ = _material_rows(scene, hit.mat_id)
    n = hit.normal
    diffuse = alive & hit.mask & (mtype == MAT_DIFFUSE)
    p = hit.point + n * 1e-4  # the scatter's offset
    total = (
        _nee_mesh_light(scene, p, n, diffuse, albedo, throughput, seed, bounce, any_hit,
                        shadow_fn)
        if scene.s_tri_light_count > 0
        else _zero3(hit.t)
    )
    if len(scene.s_light_objs) > NEE_UNROLL_MAX:
        return total + _nee_sampled_light(scene, p, n, diffuse, albedo, throughput, seed, bounce,
                                          any_hit, shadow_fn)
    for li, lo in enumerate(scene.s_light_objs):
        center = Vec3(*scene.nee_center[li].unbind())
        radius = scene.nee_radius[li]
        u1 = uniform(seed, bounce_counter(bounce, 4 + 2 * li))
        u2 = uniform(seed, bounce_counter(bounce, 5 + 2 * li))
        direction, pdf, valid = sample_light_sphere(center, radius, p, u1, u2)
        lit = _shadow_lit(scene, p, direction, center, radius, diffuse & valid, lo, any_hit,
                          shadow_fn)
        # lambertian f = albedo / pi; with the balance heuristic
        # f * w / pdf = f / (pdf_light + pdf_bsdf)
        p_b = torch.clamp(n.dot(direction), min=0.0) * INV_PI
        contrib = throughput * albedo * (p_b / (pdf + p_b))
        total = vec.where(lit, total + contrib * _light_emission(scene, li), total)
    return total


def _nee_sampled_light(scene, p, n, diffuse, albedo, throughput, seed, bounce, any_hit,
                       shadow_fn):
    """One sphere light per lane, chosen uniformly, its contribution
    weighted by the light count.  The lane's light row [centre, radius,
    emission, object] comes from one ``table_rows`` fetch of an (nl, 8)
    table whose emission columns are rows of ``materials.emission``."""
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
    lit = _shadow_lit(scene, p, direction, center, radius, diffuse & valid, lo_lane, any_hit,
                      shadow_fn)
    # the technique's pdf is pdf / nl: f * w / (pdf / nl) = f * nl / (pdf + nl * pdf_bsdf)
    p_b = torch.clamp(n.dot(direction), min=0.0) * INV_PI
    scale = p_b * float(nl) / (pdf + float(nl) * p_b)
    return vec.where(lit, throughput * albedo * scale * emit, _zero3(p_b))


def _nee_mesh_light(scene, p, n, diffuse, albedo, throughput, seed, bounce, any_hit, shadow_fn):
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
    if shadow_fn is None:
        occ = occlusion_anyhit(scene, p, direction, torch.full_like(dist, 1e-4), t_limit, valid,
                               -1, any_hit)
    else:
        ids, _ = shadow_fn(scene, p, direction, torch.full_like(dist, 1e-4), valid)
        occ = (ids.kind != PRIM_NONE) & (ids.t <= t_limit)
    # f * w / pdf_tech with pdf_tech = dist^2 / (cos_l * A), multiplied
    # through by cos_l * A so that a grazing light divides by nothing small
    p_b = torch.clamp(n.dot(direction), min=0.0) * INV_PI
    cla = cos_l * scene.tri_light_area
    scale = p_b * cla / (dist2 + p_b * cla)
    emit = Vec3(*table_rows(scene.materials.emission, lmat).unbind(1))
    return vec.where(valid & ~occ, throughput * albedo * scale * emit, _zero3(p_b))


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
    traces the shadow rays itself (``_closest_hit_shadows``)."""
    alive = state["alive"]
    ids, extra = intersect_fn(scene, state["ro"], state["rd"], state["t_min"], alive)
    if use_refine or extra is None:
        tri_vals = extra if use_refine else None
        if tri_vals is not None and tri_table is not None:
            tri_vals = dict(tri_vals, table=tri_table)
        hit = refine_hit(scene, state["ro"], state["rd"], state["t_min"], ids, tri_vals)
    else:
        hit = extra
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
    if scene.has_nee:
        shadow_fn = intersect_fn if _closest_hit_shadows(intersect_fn) else None
        radiance = radiance + _nee_direct_light(scene, hit, state["color"], seed, bounce, alive,
                                                any_hit, shadow_fn)
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
    if scene.has_nee:
        out.update(spec=torch.where(hit_alive, specular, state["spec"]),
                   pdf_w=torch.where(hit_alive, new_pdf, state["pdf_w"]))
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


def _render_chained(scene, camera, width, height, spp, max_bounces, rr_start,
                    start_iteration, intersect_fn, any_hit=None, row0=0, rows=None):
    """Forward render with per-lane sample chaining, one flat loop, over
    the band of ``rows`` rows from ``row0`` (the whole image by default)."""
    dev = scene.device
    pix = _band_pixels(width, height if rows is None else rows, row0, dev)
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
        st2 = _bounce_body(scene, seed, st, bounce, rr_start, intersect_fn, any_hit=any_hit)
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
    lives longest, so that the ranks' collectives pair up."""
    rows = height if rows is None else rows
    tri_table = None
    sharded = differentiable and grad_psum_axis is not None
    per_bounce = sharded and grad_psum_overlap
    if sharded and not grad_psum_overlap:
        scene = psum_in_backward(scene, grad_psum_axis)
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
    ``grad_psum_overlap`` are ``trace_sample``'s."""
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
            return _render_samples(scene, camera, width, height, spp, max_bounces, rr_start,
                                   start_iteration, False, intersect_fn, any_hit, **band)
        return _render_chained(scene, camera, width, height, spp, max_bounces, rr_start,
                               start_iteration, intersect_fn or intersect_scene_ids, any_hit,
                               **band)
