"""Progressive rendering engine (counterpart of
``tpupt/render/progressive.py``): the library form of the reference's
``PathTracer`` class and of the interactive app's controls (progressive
accumulation, restart on a camera move, resize, display-buffer selection,
the denoiser), as methods.

A ``PathTracer`` renders on its scene's device.  Each method launches its
work directly (torch runs eagerly): ``path_trace`` one sample through the
forward ``trace_sample`` or, with ``method="streaming"``, the wavefront
integrator; ``path_trace_many`` a chunk of samples through the chained
renderer.  Checkpoints are ``.npz`` files with the JAX package's keys and
types, so either package loads the other's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupt_torch.core.types import Camera, RenderBuffers, SceneArrays
from tpupt_torch.denoise.atrous import atrous_denoise
from tpupt_torch.render.integrator import (
    MAX_BOUNCES_DEFAULT,
    accumulate,
    render_image,
    trace_sample,
)
from tpupt_torch.render.wavefront import trace_sample_wavefront
from tpupt_torch.utils.image import depth_to_uint8, to_uint8

METHODS = ("megakernel", "streaming")
BUFFER_TYPES = ("final", "color", "normal", "depth")


class PathTracer:
    """Owns the scene, the accumulation buffers and the render steps."""

    def __init__(
        self,
        scene: SceneArrays,
        resolution: tuple[int, int],
        max_bounces: int = MAX_BOUNCES_DEFAULT,
        rr_start: int | None = None,
        method: str = "megakernel",
    ):
        """``method``: "megakernel" (masked bounce loop) or "streaming"
        (wavefront with compaction), the reference's GPUMethod knob."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        self.scene = scene
        self.method = method
        self.max_bounces = max_bounces
        self.rr_start = rr_start
        self.max_iterations = 2_000_000
        # the denoiser's knobs
        self.denoiser_enabled = False
        self.filter_size = 10
        self.color_weight = 0.45
        self.normal_weight = 0.30
        self.position_weight = 0.25

        self._denoised: torch.Tensor | None = None
        self.resize_image(resolution)

    @property
    def device(self) -> torch.device:
        return self.scene.device

    # --- the render steps ------------------------------------------------
    @torch.no_grad()
    def _step(self, camera: Camera) -> tuple[RenderBuffers, int]:
        """One sample of ``self.method``, folded into the buffers."""
        sample = trace_sample_wavefront if self.method == "streaming" else trace_sample
        color, normal, depth, rays = sample(
            self.scene, camera.to(self.device), self.width, self.height, self.iteration,
            max_bounces=self.max_bounces, rr_start=self.rr_start,
        )
        return accumulate(self.buffers, color, normal, depth), int(rays)

    @torch.no_grad()
    def _chunk_step(self, camera: Camera, spp: int) -> tuple[RenderBuffers, int]:
        """``spp`` samples through the chained renderer, merged into the
        buffers.  The merge is exact algebra: the (n-1)/n recurrence is
        linear in its start value with coefficient it0 / (it0 + spp), and
        the chained renderer starts its accumulators at zero, so
        old * it0 / (it0 + spp) + new continues the average (the values of
        ``spp`` single steps up to float association)."""
        it0 = self.iteration
        new, rays = render_image(
            self.scene, camera, self.width, self.height, spp,
            max_bounces=self.max_bounces, rr_start=self.rr_start, start_iteration=it0,
        )
        # the float32 quotient, as the JAX package computes it
        w_old = float(np.float32(it0) / np.float32(it0 + spp))
        b = self.buffers
        return RenderBuffers(
            color=b.color * w_old + new.color,
            normal=b.normal * w_old + new.normal,
            depth=b.depth * w_old + new.depth,
            iteration=new.iteration,
        ), int(rays)

    @torch.no_grad()
    def preview_frame(self, camera: Camera, max_bounces: int = 8,
                      display_type: str = "final") -> np.ndarray:
        """A one-sample uint8 preview at this tracer's resolution, for any
        display type, tonemapped on the device and copied to the host once
        (the interactive viewer's motion preview).  The accumulators are
        not touched."""
        if display_type not in BUFFER_TYPES:
            raise ValueError(f"unknown buffer type {display_type!r}")
        color, normal, depth, _ = trace_sample(
            self.scene, camera.to(self.device), self.width, self.height, 0,
            max_bounces=min(max_bounces, self.max_bounces),
            rr_start=2 if self.rr_start is None else min(self.rr_start, 2),
        )
        # the display conversions of utils.image: normals remap [-1, 1] to
        # [0, 1]; depth shows gamma(1 / depth)
        if display_type == "normal":
            src = normal * 0.5 + 0.5
        elif display_type == "depth":
            src = (1.0 / depth)[:, None].expand(-1, 3)
        else:  # "final" / "color": one fresh sample, no accumulators
            src = color
        c = torch.pow(torch.clamp(src, min=0.0), 1.0 / 2.2)
        img = (torch.clamp(c, 0.0, 1.0) * 255.99).to(torch.uint8)
        return img.cpu().numpy().reshape(self.height, self.width, 3)

    # --- the reference's API ----------------------------------------------
    def resize_image(self, resolution: tuple[int, int]) -> None:
        self.width, self.height = int(resolution[0]), int(resolution[1])
        self.restart()

    def restart(self) -> None:
        self.buffers = RenderBuffers.create(self.width * self.height, self.device)
        self._denoised = None

    @property
    def iteration(self) -> int:
        return int(self.buffers.iteration)

    def path_trace(self, camera: Camera) -> int:
        """One progressive sample.  Returns the ray segments traced."""
        if self.iteration >= self.max_iterations:
            return 0
        self.buffers, rays = self._step(camera)
        self._denoised = None
        return rays

    def path_trace_many(self, camera: Camera, spp: int) -> int:
        """``spp`` progressive samples through the sample-chained renderer:
        the same ray count and RNG streams as ``spp`` x ``path_trace``,
        pixels at amplified-ulp tolerance.  Streaming has no chained form
        and runs one sample at a time.  Returns the ray segments traced."""
        if self.method != "megakernel":
            return sum(self.path_trace(camera) for _ in range(spp))
        spp = min(spp, self.max_iterations - self.iteration)
        if spp <= 0:
            return 0
        self.buffers, rays = self._chunk_step(camera, spp)
        self._denoised = None
        return rays

    @torch.no_grad()
    def denoise(self, camera: Camera) -> torch.Tensor:
        """The à-trous denoiser on the accumulated buffers; ``display``
        shows its result as "final" until the next sample."""
        h, w = self.height, self.width
        self._denoised = atrous_denoise(
            self.buffers.color.reshape(h, w, 3),
            self.buffers.normal.reshape(h, w, 3),
            self.buffers.depth.reshape(h, w),
            camera,
            filter_size=self.filter_size,
            color_weight=self.color_weight,
            normal_weight=self.normal_weight,
            position_weight=self.position_weight,
        ).reshape(-1, 3)
        return self._denoised

    # --- checkpoint and resume ----------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Save the accumulation state: float32 color, normal and depth,
        the int iteration and the resolution (the JAX package's keys)."""
        np.savez_compressed(
            path,
            color=self.buffers.color.cpu().numpy(),
            normal=self.buffers.normal.cpu().numpy(),
            depth=self.buffers.depth.cpu().numpy(),
            iteration=self.iteration,
            width=self.width,
            height=self.height,
        )

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            arrays = {k: data[k] for k in ("color", "normal", "depth", "iteration", "width",
                                           "height")}
        if (int(arrays["width"]), int(arrays["height"])) != (self.width, self.height):
            raise ValueError(
                f"checkpoint resolution {int(arrays['width'])}x{int(arrays['height'])} "
                f"!= tracer resolution {self.width}x{self.height}"
            )
        bufs = {}
        for key in ("color", "normal", "depth"):
            if arrays[key].dtype != np.float32:
                raise ValueError(f"checkpoint {key} is {arrays[key].dtype}, not float32")
            bufs[key] = torch.from_numpy(arrays[key]).to(self.device)
        self.buffers = RenderBuffers(**bufs, iteration=int(arrays["iteration"]))
        self._denoised = None

    def display(self, buffer_type: str = "final") -> np.ndarray:
        """Tonemapped uint8 view of one buffer: final | color | normal |
        depth ("final" is the denoised image when there is one)."""
        h, w = self.height, self.width

        def host(t):
            return t.cpu().numpy()

        if buffer_type == "final":
            src = self._denoised if self._denoised is not None else self.buffers.color
            return to_uint8(host(src).reshape(h, w, 3))
        if buffer_type == "color":
            return to_uint8(host(self.buffers.color).reshape(h, w, 3))
        if buffer_type == "normal":
            return to_uint8(host(self.buffers.normal).reshape(h, w, 3), "neg1_1_to_0_1")
        if buffer_type == "depth":
            return depth_to_uint8(host(self.buffers.depth).reshape(h, w))
        raise ValueError(f"unknown buffer type {buffer_type!r}")
