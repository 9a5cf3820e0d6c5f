"""The port's utilities (``tpupt_torch.utils``) against the JAX package's
``tpupt.utils``, the port's own PNG writer, and its ``TPUPT_DEBUG`` NaN
guards through ``PathTracer.path_trace`` (as ``test_debug_mode.py`` checks
the JAX package's).  Everything here is exact: the display conversions are
the same numpy code, and the PNG bytes decode to the image written.
"""

import struct
import time
import zlib

import numpy as np
import pytest

from tpupt.utils import image as jax_image
from tpupt.utils.timer import Stopwatch as JaxStopwatch

import tpupt_torch.core.math3d as m3
from tpupt_torch import PathTracer
from tpupt_torch.core.camera import make_camera
from tpupt_torch.scene.description import SceneDescription
from tpupt_torch.utils import debug, image
from tpupt_torch.utils.timer import Stopwatch


def _floats(shape, seed=0):
    r = np.random.default_rng(seed)
    a = r.uniform(-0.5, 1.5, shape).astype(np.float32)
    a.flat[:4] = [0.0, 1.0, np.inf, -np.inf]
    return a


@pytest.mark.parametrize("normalization", ["none", "neg1_1_to_0_1"])
def test_to_uint8_equal(normalization):
    c = _floats((17, 9, 3))
    np.testing.assert_array_equal(image.linear_to_gamma(c), jax_image.linear_to_gamma(c))
    got = image.to_uint8(c, normalization)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_image.to_uint8(c, normalization))


def test_depth_to_uint8_equal():
    d = np.abs(_floats((11, 7), 1)) * 10.0
    d.flat[5] = 0.0  # 1/0
    d.flat[6] = 1e6  # the sky's depth
    got = image.depth_to_uint8(d)
    assert got.shape == (11, 7, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_image.depth_to_uint8(d))


def test_stopwatch_equal(monkeypatch):
    """The same stages, seconds and report on a scripted clock."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    reports = []
    for cls in (Stopwatch, JaxStopwatch):
        sw = cls()
        for name in ("Scene loading", "Device init", "Path tracing"):
            sw.stage(name)
        reports.append((sw.report(), sw.stages, sw.total()))
    assert reports[0] == reports[1]
    assert "Path tracing time: 0.250000s" in reports[0][0]


def _decode_png(data: bytes) -> np.ndarray:
    """A decoder for what ``write_image_file`` writes (8-bit RGB or RGBA, filter
    type 0), checking every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        chunks.append((tag, body))
        pos += 12 + length
    assert [t for t, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, comp, filt, interlace) == (8, 0, 0, 0) and ctype in (2, 6)
    c = 3 if ctype == 2 else 4
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()  # filter type 0 on every scanline
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (13, 21, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    image.write_image_file(path, img)
    with open(path, "rb") as fh:
        np.testing.assert_array_equal(_decode_png(fh.read()), img)
    from PIL import Image  # present here, not a dependency of the port

    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8), np.zeros((4, 4, 3), np.float32),
                                 np.zeros((4, 4, 2), np.uint8)])
def test_png_rejects_other_images(tmp_path, bad):
    with pytest.raises(ValueError, match="uint8"):
        image.write_image_file(str(tmp_path / "x.png"), bad)


def _scene(albedo=(0.5, 0.5, 0.5)):
    d = SceneDescription()
    d.add_material("m", "lambertian", albedo=albedo)
    d.add_sphere(0.5, np.asarray(m3.mat_translate([0, 0, -1])), "m")
    return d.build(device="cpu")


NAN_ALBEDO = (float("nan"), 0.5, 0.5)


@pytest.mark.parametrize("method", ["megakernel", "streaming"])
def test_debug_mode_catches_nan_material(monkeypatch, method):
    monkeypatch.setenv("TPUPT_DEBUG", "1")
    assert debug.enabled()
    tracer = PathTracer(_scene(albedo=NAN_ALBEDO), (16, 16), max_bounces=3, method=method)
    with pytest.raises(RuntimeError, match="non-finite value in bounce"):
        tracer.path_trace(make_camera(vfov=np.pi / 2))


def test_debug_mode_catches_nan_in_chunks(monkeypatch):
    """The chained renderer runs the same bounce body and its guards."""
    monkeypatch.setenv("TPUPT_DEBUG", "1")
    tracer = PathTracer(_scene(albedo=NAN_ALBEDO), (16, 16), max_bounces=3)
    with pytest.raises(RuntimeError, match="non-finite"):
        tracer.path_trace_many(make_camera(vfov=np.pi / 2), 2)


def test_debug_mode_clean_scene_passes(monkeypatch):
    monkeypatch.setenv("TPUPT_DEBUG", "1")
    tracer = PathTracer(_scene(), (16, 16), max_bounces=3)
    assert tracer.path_trace(make_camera(vfov=np.pi / 2)) > 0
    assert tracer.path_trace_many(make_camera(vfov=np.pi / 2), 2) > 0


def test_debug_mode_off_ignores_nan(monkeypatch):
    """Without the variable the guards do nothing: the render carries the
    NaN."""
    monkeypatch.delenv("TPUPT_DEBUG", raising=False)
    assert not debug.enabled()
    tracer = PathTracer(_scene(albedo=NAN_ALBEDO), (16, 16), max_bounces=3)
    assert tracer.path_trace(make_camera(vfov=np.pi / 2)) > 0
    assert np.isnan(tracer.buffers.color.numpy()).any()
