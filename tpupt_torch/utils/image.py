"""Image output and display conversion (counterpart of
``tpupt/utils/image.py``).

The display conversions are the JAX package's numpy code: gamma 1/2.2,
clamp, times 255.99, to uint8.  ``write_image_file`` encodes the PNG
itself with ``zlib`` and ``struct``, so writing an image needs no imaging
library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {3: 2, 4: 6}  # channels -> PNG colour type (RGB8, RGBA8)


def linear_to_gamma(color: np.ndarray) -> np.ndarray:
    return np.power(np.maximum(color, 0.0), 1.0 / 2.2)


def to_uint8(color: np.ndarray, normalization: str = "none") -> np.ndarray:
    """Float buffer (..., 3) -> uint8: an optional [-1, 1] -> [0, 1] remap
    (normals), gamma, clamp * 255.99."""
    c = np.asarray(color, np.float32)
    if normalization == "neg1_1_to_0_1":
        c = c * 0.5 + 0.5
    c = linear_to_gamma(c)
    return (np.clip(c, 0.0, 1.0) * 255.99).astype(np.uint8)


def depth_to_uint8(depth: np.ndarray) -> np.ndarray:
    """Depth display: gamma(1 / depth) as grey."""
    with np.errstate(divide="ignore"):
        v = 1.0 / np.asarray(depth, np.float32)
    return to_uint8(np.repeat(v[..., None], 3, axis=-1))


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_image_file(path: str, rgb_uint8: np.ndarray) -> None:
    """Write a (H, W, 3) or (H, W, 4) uint8 image as PNG: 8 bits per
    channel, every scanline with filter type 0, one zlib stream."""
    img = np.asarray(rgb_uint8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"expected a (H, W, 3|4) uint8 image, got {img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    data = (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)
