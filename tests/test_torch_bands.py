"""Row bands of the PyTorch port's renders (``render_image(row0=,
rows=)``), the unit of ``dist.sharding``.

A band's lanes are the full render's lanes for the same pixels: the RNG
and the camera key off the global pixel.  Every lane's arithmetic is its
own, so the bands, concatenated, EQUAL the full render bit for bit, with
the same segments in all: chained, per sample and the differentiable
render's forward colour.  Two layouts: 32^2 in four bands of 256 lanes,
one packet each (aligned), and 24^2 in four bands of 144 lanes (not a
packet multiple: a band's packets hold other lanes than the full
render's).  Both are held bit-equal; a cross-treelet exact-t tie could
resolve differently in another packet (tests/test_tie_breaking.py), and
full_scene has none on these rays.

Against the JAX package's band renders (compiled once per layout, the
band's first row a traced argument): equal segment counts, images at
test_torch_render.py's IMAGE (rtol 1e-4, atol 1e-5: last-bit
differences of the two packages' float32 sqrt, rsqrt, sin and cos,
amplified through bounces).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.render.integrator import render_image as jax_render_image

from test_torch_scene import port_scene
from tpupt_torch.core.camera import make_camera
from tpupt_torch.diff.params import extract_params, with_params
from tpupt_torch.render.integrator import render_image

# the test tensors are small, so torch's intra-op thread pool only adds
# overhead (a ~1k-ray twin sweep: 6.5 s on 8 threads, 0.2 s on one)
torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
BANDS = 4
SIZES = (32, 24)  # 256 and 144 lanes a band
MODES = ("chained", "per_sample", "differentiable")
KW = dict(spp=2, max_bounces=4)


def _port_render(pscene, size, mode, **band):
    cam = make_camera(vfov=np.pi / 2)
    if mode == "differentiable":
        pscene = with_params(pscene, extract_params(pscene))
    buf, rays = render_image(pscene, cam, size, size, differentiable=mode == "differentiable",
                             chain_samples=mode == "chained", **KW, **band)
    return buf.color.detach(), buf.depth.detach(), int(rays)


@pytest.fixture(scope="module")
def pscene(full_scene):
    return port_scene(full_scene)


@pytest.fixture(scope="module")
def bands(pscene):
    """{(size, mode): the full render, and the four bands' renders}."""
    out = {}
    for size in SIZES:
        rows = size // BANDS
        for mode in MODES:
            out[size, mode] = (
                _port_render(pscene, size, mode),
                [_port_render(pscene, size, mode, row0=b * rows, rows=rows) for b in range(BANDS)],
            )
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", SIZES)
def test_bands_equal_the_full_render(bands, size, mode):
    (color, depth, rays), parts = bands[size, mode]
    assert all(p[0].shape == (size * size // BANDS, 3) for p in parts)
    assert torch.equal(torch.cat([p[0] for p in parts]), color)
    assert torch.equal(torch.cat([p[1] for p in parts]), depth)
    assert sum(p[2] for p in parts) == rays


@pytest.mark.parametrize("mode", ("chained", "per_sample"))
@pytest.mark.parametrize("size", SIZES)
def test_bands_match_jax(full_scene, bands, size, mode):
    rows = size // BANDS
    run = jax.jit(jax_render_image, static_argnames=(
        "width", "height", "spp", "max_bounces", "rows", "chain_samples"))
    for b, (color, depth, rays) in enumerate(bands[size, mode][1]):
        jbuf, jrays = run(full_scene, jax_make_camera(vfov=np.pi / 2), width=size, height=size,
                          row0=jnp.int32(b * rows), rows=rows, chain_samples=mode == "chained",
                          **KW)
        assert rays == int(jrays)
        np.testing.assert_allclose(color.numpy(), np.asarray(jbuf.color), **IMAGE)
        np.testing.assert_allclose(depth.numpy(), np.asarray(jbuf.depth), **IMAGE)
