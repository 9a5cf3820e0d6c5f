"""The progressive engine of the PyTorch port (``tpupt_torch.PathTracer``)
against the JAX package's ``tpupt.PathTracer``, and the engine's own
behaviour as ``test_progressive.py`` and ``test_checkpoint.py`` check the
JAX one's (CPU: the port runs its torch twins).

Ray counts must be EQUAL.  Images: rtol 1e-4, atol 1e-5 between the two
packages (``test_torch_render.py``'s IMAGE: the packages' float32 sqrt,
rsqrt, sin and cos differ in the last bit, and XLA contracts multiply-adds
into FMAs, amplified through bounces), and atol 2e-4 between the port's
chunked and per-sample accumulation (``test_progressive.py``'s tolerance:
the chunk merge reassociates the running average).  uint8 display buffers
may differ by 1 where a float input sits at a rounding edge of x 255.99.
"""

import numpy as np
import pytest
import torch

from tpupt.core.camera import make_camera as jax_make_camera
from tpupt.render.progressive import PathTracer as JaxPathTracer

from test_torch_scene import port_scene
from tpupt_torch import PathTracer
from tpupt_torch.core.camera import make_camera
from tpupt_torch.render.integrator import render_image

torch.set_num_threads(1)

IMAGE = dict(rtol=1e-4, atol=1e-5)
W = H = 16
BOUNCES = 4
BUFFERS = ("final", "color", "normal", "depth")


def _cams():
    return jax_make_camera(vfov=np.pi / 2), make_camera(vfov=np.pi / 2)


def _assert_buffers_close(pt, jpt, **tol):
    for k in ("color", "normal", "depth"):
        got, want = getattr(pt.buffers, k).numpy(), np.asarray(getattr(jpt.buffers, k))
        assert got.dtype == want.dtype == np.float32, k
        np.testing.assert_allclose(got, want, err_msg=k, **tol)


def _assert_uint8_close(got, want):
    """Equal but for +-1 where the float inputs differ in the last bits."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert gap.max() <= 1, gap.max()
    assert (gap == 0).mean() >= 0.99, (gap == 0).mean()


@pytest.fixture(scope="module")
def tracers(full_scene):
    """(port, JAX) tracers on ``full_scene`` after three ``path_trace``
    samples, the rays of each call, and the same for chunks of 2 + 1."""
    jcam, cam = _cams()
    pscene = port_scene(full_scene)
    out = {}
    for name, steps in (("per_sample", (None, None, None)), ("chunked", (2, 1))):
        jpt = JaxPathTracer(full_scene, (W, H), max_bounces=BOUNCES)
        pt = PathTracer(pscene, (W, H), max_bounces=BOUNCES)
        jr, pr = [], []
        for spp in steps:
            if spp is None:
                jr.append(jpt.path_trace(jcam))
                pr.append(pt.path_trace(cam))
            else:
                jr.append(jpt.path_trace_many(jcam, spp))
                pr.append(pt.path_trace_many(cam, spp))
        out[name] = (pt, jpt, pr, jr)
    return out


@pytest.mark.parametrize("name", ["per_sample", "chunked"])
def test_path_trace_matches_jax(tracers, name):
    """path_trace x3 and path_trace_many(2) + path_trace_many(1): every
    call's ray count equal, the buffers at IMAGE."""
    pt, jpt, pr, jr = tracers[name]
    assert pr == jr and all(isinstance(r, int) and r > W * H for r in pr), (pr, jr)
    assert isinstance(pt.iteration, int) and pt.iteration == jpt.iteration == 3
    _assert_buffers_close(pt, jpt, **IMAGE)


@pytest.mark.parametrize("buffer_type", BUFFERS)
def test_display_matches_jax(tracers, buffer_type):
    pt, jpt, _, _ = tracers["per_sample"]
    got, want = pt.display(buffer_type), jpt.display(buffer_type)
    assert got.shape == (H, W, 3)
    _assert_uint8_close(got, want)


def test_preview_frame_matches_jax(sphere_scene):
    """The one-sample preview, tonemapped on the device, for every display
    type; the accumulators stay untouched."""
    jcam, cam = _cams()
    jpt = JaxPathTracer(sphere_scene, (W, H), max_bounces=BOUNCES)
    pt = PathTracer(port_scene(sphere_scene), (W, H), max_bounces=BOUNCES)
    for buffer_type in BUFFERS:
        got = pt.preview_frame(cam, 8, buffer_type)
        assert got.shape == (H, W, 3)
        _assert_uint8_close(got, jpt.preview_frame(jcam, 8, buffer_type))
    assert pt.iteration == 0 and float(pt.buffers.color.abs().max()) == 0.0
    with pytest.raises(ValueError, match="buffer type"):
        pt.preview_frame(cam, 8, "albedo")


def test_chunked_equals_per_sample(sphere_scene):
    """path_trace_many continues the same progressive average as per-sample
    path_trace calls: exact ray counts, pixels at atol 2e-4, across chunk
    boundaries and mixed with single steps (an it0 > 0 merge)."""
    _, cam = _cams()
    pscene = port_scene(sphere_scene)
    pt_a = PathTracer(pscene, (32, 32), max_bounces=4)
    rays_a = sum(pt_a.path_trace(cam) for _ in range(5))
    pt_b = PathTracer(pscene, (32, 32), max_bounces=4)
    rays_b = pt_b.path_trace(cam)
    rays_b += pt_b.path_trace_many(cam, 3)
    rays_b += pt_b.path_trace_many(cam, 1)
    assert pt_b.iteration == 5
    assert rays_a == rays_b
    np.testing.assert_allclose(pt_a.buffers.color.numpy(), pt_b.buffers.color.numpy(), atol=2e-4)


def test_one_chunk_is_render_image(sphere_scene):
    """A first chunk is the chained render itself, bit for bit."""
    _, cam = _cams()
    pscene = port_scene(sphere_scene)
    pt = PathTracer(pscene, (W, H), max_bounces=4, rr_start=2)
    rays = pt.path_trace_many(cam, 3)
    buf, want = render_image(pscene, cam, W, H, 3, max_bounces=4, rr_start=2)
    assert rays == int(want) and pt.iteration == buf.iteration == 3
    for k in ("color", "normal", "depth"):
        assert torch.equal(getattr(pt.buffers, k), getattr(buf, k)), k


def test_restart_and_resize(sphere_scene):
    _, cam = _cams()
    pt = PathTracer(port_scene(sphere_scene), (16, 16), max_bounces=2)
    pt.path_trace(cam)
    pt.restart()
    assert pt.iteration == 0
    assert float(pt.buffers.color.max()) == 0
    pt.resize_image((8, 4))
    pt.path_trace(cam)
    assert pt.display("final").shape == (4, 8, 3)
    with pytest.raises(ValueError, match="buffer type"):
        pt.display("albedo")
    with pytest.raises(ValueError, match="method"):
        PathTracer(pt.scene, (8, 8), method="warp")


def test_max_iterations_cap(sphere_scene):
    _, cam = _cams()
    pt = PathTracer(port_scene(sphere_scene), (8, 8), max_bounces=2)
    pt.max_iterations = 2
    for _ in range(5):
        pt.path_trace(cam)
    assert pt.iteration == 2
    assert pt.path_trace_many(cam, 4) == 0 and pt.iteration == 2
    pt.max_iterations = 3
    assert pt.path_trace_many(cam, 4) > 0 and pt.iteration == 3


def test_denoise_switches_final(sphere_scene):
    _, cam = _cams()
    pt = PathTracer(port_scene(sphere_scene), (16, 16), max_bounces=3)
    pt.path_trace(cam)
    raw = pt.display("final").copy()
    pt.denoise(cam)
    dn = pt.display("final")
    assert (raw != dn).any()
    assert np.array_equal(pt.display("color"), raw)
    # a new sample drops the denoised image until denoise runs again
    pt.path_trace(cam)
    assert (pt.display("final") != dn).any()


def test_denoise_matches_jax(tracers):
    pt, jpt, _, _ = tracers["per_sample"]
    jcam, cam = _cams()
    got = pt.denoise(cam).numpy()
    want = np.asarray(jpt.denoise(jcam))
    np.testing.assert_allclose(got, want, **IMAGE)
    _assert_uint8_close(pt.display("final"), jpt.display("final"))
    pt._denoised = jpt._denoised = None  # the module's tracers show their buffers again


def test_checkpoint_roundtrip(sphere_scene, tmp_path):
    _, cam = _cams()
    path = str(tmp_path / "ckpt.npz")
    pscene = port_scene(sphere_scene)
    pt = PathTracer(pscene, (16, 16), max_bounces=3)
    for _ in range(3):
        pt.path_trace(cam)
    pt.save_checkpoint(path)
    ref = pt.buffers.color.clone()

    pt2 = PathTracer(pscene, (16, 16), max_bounces=3)
    pt2.load_checkpoint(path)
    assert pt2.iteration == 3 and isinstance(pt2.iteration, int)
    assert torch.equal(pt2.buffers.color, ref)
    # resumed accumulation == uninterrupted accumulation (same RNG streams)
    pt.path_trace(cam)
    pt2.path_trace(cam)
    assert torch.equal(pt2.buffers.color, pt.buffers.color)


def test_checkpoint_resolution_mismatch(sphere_scene, tmp_path):
    _, cam = _cams()
    path = str(tmp_path / "ckpt.npz")
    pscene = port_scene(sphere_scene)
    pt = PathTracer(pscene, (16, 16), max_bounces=2)
    pt.path_trace(cam)
    pt.save_checkpoint(path)
    with pytest.raises(ValueError, match="resolution"):
        PathTracer(pscene, (8, 8), max_bounces=2).load_checkpoint(path)


def test_checkpoints_cross_packages(full_scene, tmp_path):
    """A checkpoint the JAX package writes loads in the port and the
    port's loads in the JAX package, with the same keys, dtypes and values;
    continuing from either equals the uninterrupted tracer of the other
    package (ray counts equal, buffers at IMAGE)."""
    jcam, cam = _cams()
    pscene = port_scene(full_scene)
    jpt = JaxPathTracer(full_scene, (W, H), max_bounces=BOUNCES, rr_start=2)
    pt = PathTracer(pscene, (W, H), max_bounces=BOUNCES, rr_start=2)
    for _ in range(2):
        assert jpt.path_trace(jcam) == pt.path_trace(cam)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jpt.save_checkpoint(jpath)
    pt.save_checkpoint(ppath)
    with np.load(jpath) as j, np.load(ppath) as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k

    from_jax = PathTracer(pscene, (W, H), max_bounces=BOUNCES, rr_start=2)
    from_jax.load_checkpoint(jpath)
    from_port = JaxPathTracer(full_scene, (W, H), max_bounces=BOUNCES, rr_start=2)
    from_port.load_checkpoint(ppath)
    assert from_jax.iteration == from_port.iteration == 2
    np.testing.assert_array_equal(from_jax.buffers.color.numpy(), np.asarray(jpt.buffers.color))
    np.testing.assert_array_equal(np.asarray(from_port.buffers.color), pt.buffers.color.numpy())

    rays = {jpt.path_trace(jcam), pt.path_trace(cam), from_jax.path_trace(cam),
            from_port.path_trace(jcam)}
    assert len(rays) == 1, rays
    _assert_buffers_close(from_jax, jpt, **IMAGE)
    _assert_buffers_close(pt, from_port, **IMAGE)
