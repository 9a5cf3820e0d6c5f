"""Sphere sampling: uniform on the unit sphere *surface* through the
(phi, cos theta) inversion (counterpart of ``tpupt/sampling/sphere.py``)."""

from __future__ import annotations

import torch

from tpupt_torch.core.vec import Vec3
from tpupt_torch.sampling.rng import bounce_counter, uniform

TWO_PI = 6.283185307179586


def random_in_unit_sphere(seed: torch.Tensor, bounce) -> Vec3:
    """Two draws (lanes 0, 1) -> a point on the unit sphere."""
    u0 = uniform(seed, bounce_counter(bounce, 0))
    u1 = uniform(seed, bounce_counter(bounce, 1))
    phi = TWO_PI * u0
    cos_theta = 2.0 * u1 - 1.0
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    return Vec3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta)
