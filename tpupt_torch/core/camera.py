"""Camera and primary-ray generation (counterpart of ``tpupt/core/camera.py``).

Viewport math: height = 2 tan(vfov/2), focal length 1, u = x / (W-1),
v = (H - y) / (H-1) (a vertical flip), directions normalized.  The float32
operations run in the JAX package's order.  The two viewport scalars are
computed on the host in numpy float32, where ``tan`` rounds as the JAX
package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupt_torch.core.types import Camera
from tpupt_torch.core.vec import Vec3, transform_vector

T_MIN_PRIMARY = 1e-4


def make_camera(position=(0.0, 0.0, 0.0), rotation=None, vfov=np.pi / 2) -> Camera:
    """Camera from a position and a 3x3 camera-to-world rotation
    (``None`` = identity, looking down -z)."""
    m = np.eye(4, dtype=np.float32)
    if rotation is not None:
        m[:3, :3] = np.asarray(rotation, np.float32)
    m[:3, 3] = np.asarray(position, np.float32)
    return Camera(camera_matrix=torch.from_numpy(m), vfov=float(np.float32(vfov)))


def camera_from_matrix(camera_to_world, vfov) -> Camera:
    m = np.array(camera_to_world, np.float32)
    return Camera(camera_matrix=torch.from_numpy(m), vfov=float(np.float32(vfov)))


def viewport(camera: Camera, width: int, height: int):
    """The viewport's (width, height) as numpy float32 scalars, rounded on
    the host as the JAX package rounds them."""
    vfov = np.float32(camera.vfov)
    aspect = np.float32(width / height)
    viewport_h = np.float32(2.0) * np.tan(vfov / np.float32(2.0))
    return aspect * viewport_h, viewport_h


def generate_rays(camera: Camera, width: int, height: int, fx: torch.Tensor,
                  fy: torch.Tensor):
    """Primary rays through (possibly jittered) float pixel coordinates
    ``fx``, ``fy`` (N,).  Returns (origins, unit directions) as Vec3s on
    ``fx``'s device."""
    dev = fx.device
    viewport_w, viewport_h = viewport(camera, width, height)

    # divisors as device tensors: a true division (CUDA turns a division
    # by a host scalar into a multiply by its reciprocal)
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    u = fx / f32(width - 1)
    v = (float(height) - fy) / f32(height - 1)

    d_cam = Vec3(
        (u - 0.5) * float(viewport_w),
        (v - 0.5) * float(viewport_h),
        torch.full_like(u, -1.0),
    )
    m = camera.camera_matrix.to(dev)
    world_dir = transform_vector(m, d_cam).normalize()
    ones = torch.ones_like(u)
    ro = Vec3(m[0, 3] * ones, m[1, 3] * ones, m[2, 3] * ones)
    return ro, world_dir


def pixel_centers(width: int, height: int, device=None):
    """(N,) fx, fy at pixel centres in row-major y*W+x order."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    x = (idx % width).to(torch.float32) + 0.5
    y = (idx // width).to(torch.float32) + 0.5
    return x, y
