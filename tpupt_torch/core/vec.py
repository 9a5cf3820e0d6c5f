"""Component-SoA 3-vectors (counterpart of ``tpupt/core/vec.py``).

A ``Vec3`` carries three independent ``(N,)`` tensors.  The port keeps this
representation at its public functions so that its tests compare like with
like against the JAX package; on the GPU it also keeps every elementwise op
a full-width, coalesced pass.  ``(N, 3)`` tensors remain the boundary
representation (render buffers, host code).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # --- constructors --------------------------------------------------
    @staticmethod
    def full(shape, x, y, z, device=None) -> "Vec3":
        return Vec3(
            torch.full(shape, x, dtype=torch.float32, device=device),
            torch.full(shape, y, dtype=torch.float32, device=device),
            torch.full(shape, z, dtype=torch.float32, device=device),
        )

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    # --- arithmetic ----------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # --- geometry ------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def length2(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.length2(), min=1e-30))

    def normalize(self) -> "Vec3":
        inv = torch.rsqrt(torch.clamp(self.length2(), min=1e-12))
        return self * inv

    def max_component(self) -> torch.Tensor:
        return torch.maximum(torch.maximum(self.x, self.y), self.z)


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """glm::reflect."""
    return d - n * (2.0 * d.dot(n))


def refract(uv: Vec3, n: Vec3, eta: torch.Tensor) -> Vec3:
    """glm::refract for a unit incident ``uv``."""
    cos_theta = torch.clamp((-uv).dot(n), max=1.0)
    perp = (uv + n * cos_theta) * eta
    k = 1.0 - perp.length2()
    par = n * (-torch.sqrt(torch.clamp(k, min=1e-12)))
    return perp + par


def transform_point(m: torch.Tensor, v: Vec3) -> Vec3:
    """Apply a (4, 4) affine matrix (or (..., 4, 4) with entries that
    broadcast against the components) to points."""
    return Vec3(
        m[..., 0, 0] * v.x + m[..., 0, 1] * v.y + m[..., 0, 2] * v.z + m[..., 0, 3],
        m[..., 1, 0] * v.x + m[..., 1, 1] * v.y + m[..., 1, 2] * v.z + m[..., 1, 3],
        m[..., 2, 0] * v.x + m[..., 2, 1] * v.y + m[..., 2, 2] * v.z + m[..., 2, 3],
    )


def transform_vector(m: torch.Tensor, v: Vec3) -> Vec3:
    return Vec3(
        m[..., 0, 0] * v.x + m[..., 0, 1] * v.y + m[..., 0, 2] * v.z,
        m[..., 1, 0] * v.x + m[..., 1, 1] * v.y + m[..., 1, 2] * v.z,
        m[..., 2, 0] * v.x + m[..., 2, 1] * v.y + m[..., 2, 2] * v.z,
    )


def transform_normal(inv_m: torch.Tensor, n: Vec3) -> Vec3:
    """Inverse-transpose normal transform: row j of the result is column j
    of ``inv_m`` dotted with ``n``."""
    return Vec3(
        inv_m[..., 0, 0] * n.x + inv_m[..., 1, 0] * n.y + inv_m[..., 2, 0] * n.z,
        inv_m[..., 0, 1] * n.x + inv_m[..., 1, 1] * n.y + inv_m[..., 2, 1] * n.z,
        inv_m[..., 0, 2] * n.x + inv_m[..., 1, 2] * n.y + inv_m[..., 2, 2] * n.z,
    )
