"""Differentiable edge-avoiding à-trous wavelet denoiser (Dammertz 2010;
counterpart of ``tpupt/denoise/atrous.py``).

Each of a pass's 25 dilated taps is a shifted window of an edge-padded
(H, W) plane, so the filter is plain elementwise torch and autograd
differentiates it end to end (gradients reach color, normal, depth and,
through them, the scene).  All math runs on per-channel planes: channels
are split once on entry and stacked once on exit.

Semantics, as the JAX package's:
  * B3-spline weights {3/8, 1/4, 1/16} indexed by min(|dx|, |dy|);
  * edge-stopping weight c_w * n_w * p_w with
      c_w = min(exp(-||dc||^2 / c_phi), 1)
      n_w = min(exp(-max(||dn||^2 / step^2, 0) / n_phi), 1)
      p_w = min(exp(-||dp||^2 / p_phi), 1);
  * world position rebuilt from the depth buffer along each pixel-centre
    camera ray;
  * step widths 1, 2, 4, ... while <= filter_size;
  * taps clamp to the image (replicate padding), i.e. to width - 1.

torch.minimum/maximum split the gradient evenly at a tie, as JAX's do,
so a weight that rounds to exactly 1 differentiates the same in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpupt_torch.core import camera as cam
from tpupt_torch.core.types import Camera

_KERNEL = (3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _position_planes(depth: torch.Tensor, camera: Camera):
    """(H, W) depth -> 3 world-position planes via pixel-centre rays."""
    h, w = depth.shape
    fx, fy = cam.pixel_centers(w, h, device=depth.device)
    ro, rd = cam.generate_rays(camera, w, h, fx, fy)
    pos = ro + rd * depth.reshape(-1)
    return [c.reshape(h, w) for c in pos]


def _pad(plane: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(plane[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def _atrous_pass_planes(cs, ns, ps, step, color_weight, normal_weight, position_weight):
    """One à-trous pass at dilation ``step`` over per-channel planes."""
    h, w = cs[0].shape
    pad = 2 * step
    pc = [_pad(c, pad) for c in cs]
    pn = [_pad(n, pad) for n in ns]
    pp = [_pad(p, pad) for p in ps]
    one = cs[0].new_ones(())
    zero = cs[0].new_zeros(())

    def tap(planes, sy, sx):
        return [q[pad + sy: pad + sy + h, pad + sx: pad + sx + w] for q in planes]

    acc = [torch.zeros_like(cs[0]) for _ in range(3)]
    cum_w = torch.zeros_like(cs[0])
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            sy, sx = dy * step, dx * step
            ct, nt, pt = tap(pc, sy, sx), tap(pn, sy, sx), tap(pp, sy, sx)
            dc2 = sum((c - t) ** 2 for c, t in zip(cs, ct))
            c_w = torch.minimum(torch.exp(-dc2 / color_weight), one)
            dn2 = sum((n - t) ** 2 for n, t in zip(ns, nt))
            n_w = torch.minimum(
                torch.exp(-torch.maximum(dn2 / float(step * step), zero) / normal_weight), one
            )
            dp2 = sum((p - t) ** 2 for p, t in zip(ps, pt))
            p_w = torch.minimum(torch.exp(-dp2 / position_weight), one)
            weight = c_w * n_w * p_w * _KERNEL[min(abs(dx), abs(dy))]
            acc = [a + t * weight for a, t in zip(acc, ct)]
            cum_w = cum_w + weight
    inv = 1.0 / cum_w
    return [a * inv for a in acc]


def atrous_pass(color, normal, pos, step: int, color_weight: float, normal_weight: float,
                position_weight: float) -> torch.Tensor:
    """One pass at dilation ``step`` over (H, W, 3) tensors."""
    out = _atrous_pass_planes(list(color.unbind(-1)), list(normal.unbind(-1)),
                              list(pos.unbind(-1)), step, color_weight, normal_weight,
                              position_weight)
    return torch.stack(out, dim=-1)


def atrous_denoise(color: torch.Tensor, normal: torch.Tensor, depth: torch.Tensor,
                   camera: Camera, filter_size: int = 10, color_weight: float = 0.45,
                   normal_weight: float = 0.30, position_weight: float = 0.25) -> torch.Tensor:
    """The full filter: passes at doubling dilations while step <=
    ``filter_size``.  Inputs (H, W, 3) color and normal and (H, W) depth;
    returns (H, W, 3)."""
    camera = camera.to(depth.device)
    ps = _position_planes(depth, camera)
    cs, ns = list(color.unbind(-1)), list(normal.unbind(-1))
    step = 1
    while step <= filter_size:
        cs = _atrous_pass_planes(cs, ns, ps, step, color_weight, normal_weight, position_weight)
        step *= 2
    return torch.stack(cs, dim=-1)
