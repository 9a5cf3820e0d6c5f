"""Branch-free BSDF evaluation (counterpart of ``tpupt/render/materials.py``).

All three lobes run for every lane and the material tag selects:
  * shared origin offset: point - 1e-4 * sign(dot(d, n)) * n
  * diffuse: dir = normalize(n + unit_sphere_sample), degenerate -> n;
    throughput *= albedo
  * metal: dir = reflect(d, n) + fuzz * unit_sphere_sample, not normalized;
    a scatter below the horizon zeroes the throughput
  * dielectric: Schlick + stochastic reflect/refract of the normalized
    incident direction, from the un-offset hit point with t_min = 1e-5
  * russian roulette: survive with p = clamp(max throughput channel),
    dividing by p;
  * next-event estimation's sphere-light sampling (``sample_light_sphere``).
"""

from __future__ import annotations

import torch

from tpupt_torch.core import vec
from tpupt_torch.core.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_EMISSIVE,
    MAT_METAL,
    Hit,
    SceneArrays,
    table_rows,
)
from tpupt_torch.core.vec import Vec3
from tpupt_torch.sampling.rng import bounce_counter, uniform
from tpupt_torch.sampling.sphere import random_in_unit_sphere

INV_PI = 0.3183098861837907


def _material_rows(scene: SceneArrays, mat_id: torch.Tensor):
    """Every material field per lane, by exact gathers (``table_rows``).
    Returns (mat_type (N,), albedo Vec3, fuzz (N,), ior (N,), emission
    Vec3)."""
    mats = scene.materials
    m = mat_id.long()
    return (
        mats.mat_type[m],
        Vec3(*table_rows(mats.albedo, m).unbind(-1)),
        table_rows(mats.fuzz, m),
        table_rows(mats.ior, m),
        Vec3(*table_rows(mats.emission, m).unbind(-1)),
    )


def _schlick(cosine, ref_idx):
    """Schlick reflectance."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    p = 1.0 - cosine  # >= 0: cosine is clamped to <= 1
    return r0 + (1.0 - r0) * (p * p * p * p * p)


def shade(scene: SceneArrays, hit: Hit, ro: Vec3, rd: Vec3, t_min, throughput: Vec3,
          seed, bounce):
    """One scatter event for every lane.  Returns (new_ro, new_rd,
    new_t_min, new_throughput, emitted, terminate, specular, pdf_w), as the
    JAX package's ``shade``.  Lanes that missed get values the caller
    masks out."""
    mtype, albedo, fuzz, ior, emitted_all = _material_rows(scene, hit.mat_id)
    n = hit.normal

    sphere_s = random_in_unit_sphere(seed, bounce)
    u_fresnel = uniform(seed, bounce_counter(bounce, 2))

    # shared offset origin (diffuse / metal)
    off = hit.point - n * (1e-4 * torch.sign(rd.dot(n)))

    # --- diffuse -------------------------------------------------------
    d_sum = n + sphere_s
    d_diff = d_sum.normalize()
    degenerate = (
        (d_sum.x.abs() < 1e-8) & (d_sum.y.abs() < 1e-8) & (d_sum.z.abs() < 1e-8)
    )
    d_diff = vec.where(degenerate, n, d_diff)

    # --- metal ---------------------------------------------------------
    d_metal = vec.reflect(rd, n) + sphere_s * fuzz
    metal_ok = d_metal.dot(n) > 0.0
    zero = Vec3(torch.zeros_like(fuzz), torch.zeros_like(fuzz), torch.zeros_like(fuzz))
    metal_mult = vec.where(metal_ok, albedo, zero)

    # --- dielectric ----------------------------------------------------
    ratio = torch.where(hit.front, 1.0 / ior, ior)
    unit_d = rd.normalize()
    cos_theta = torch.clamp((-unit_d).dot(n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    cannot_refract = ratio * sin_theta > 1.0
    choose_reflect = cannot_refract | (_schlick(cos_theta, ratio) > u_fresnel)
    d_diel = vec.where(
        choose_reflect, vec.reflect(unit_d, n), vec.refract(unit_d, n, ratio)
    )

    # --- select by material type --------------------------------------
    is_diff = mtype == MAT_DIFFUSE
    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    is_emis = mtype == MAT_EMISSIVE

    new_rd = vec.where(is_diff, d_diff, vec.where(is_metal, d_metal, d_diel))
    new_ro = vec.where(is_diel, hit.point, off)
    new_t_min = torch.where(is_diel, 1e-5, t_min)
    one = Vec3(torch.ones_like(fuzz), torch.ones_like(fuzz), torch.ones_like(fuzz))
    mult = vec.where(is_diff, albedo, vec.where(is_metal, metal_mult, one))
    new_throughput = throughput * mult

    emitted = vec.where(is_emis, emitted_all, zero)
    specular = is_metal | is_diel
    pdf_w = torch.where(is_diff, torch.clamp(d_diff.dot(n), min=0.0) * INV_PI, 0.0)
    return (new_ro, new_rd, new_t_min, new_throughput, emitted, is_emis,
            specular, pdf_w)


def sample_light_sphere(center: Vec3, radius, p: Vec3, u1, u2):
    """Cone sampling of a sphere light as seen from ``p``: uniform over the
    solid angle it subtends, in a Frisvad frame around the axis.  Returns
    (direction Vec3, pdf 1/sr, valid: ``p`` lies outside the sphere)."""
    d = center - p
    dist2 = d.dot(d)
    valid = dist2 > radius * radius
    w = d * torch.rsqrt(torch.clamp(dist2, min=1e-12))
    sin2_max = torch.clamp(radius * radius / torch.clamp(dist2, min=1e-12), 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))

    cos_t = 1.0 + u1 * (cos_max - 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 6.283185307179586 * u2

    sign = torch.where(w.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + w.z)
    b = w.x * w.y * a
    t1 = Vec3(1.0 + sign * w.x * w.x * a, sign * b, -sign * w.x)
    t2 = Vec3(b, sign + w.y * w.y * a, -w.y)

    direction = w * cos_t + t1 * (sin_t * torch.cos(phi)) + t2 * (sin_t * torch.sin(phi))
    pdf = 1.0 / torch.clamp(6.283185307179586 * (1.0 - cos_max), min=1e-8)
    return direction, pdf, valid


def russian_roulette(throughput: Vec3, alive, seed, bounce):
    """Unbiased RR termination.  Returns (throughput, alive)."""
    u = uniform(seed, bounce_counter(bounce, 3))
    p = torch.clamp(throughput.max_component(), 0.05, 0.95)
    survive = u < p
    inv_p = 1.0 / p
    tp = vec.where(survive, throughput * inv_p, throughput)
    return tp, alive & survive
