"""Host-side image container and PNG I/O (utils/image.rs:5-111).

The framebuffer lives on device as a (H, W, 3) f32 array until the very end;
this wrapper only handles the host boundary: gamma, quantization, PNG encode.
PNG encoding prefers the native C++ encoder (native/, the equivalent of the
reference's `image` crate) and falls back to the standard-library encoder
below (zlib + struct), which needs no third-party package.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (RGB8, color type 2, filter 0 — the
    same stream the native encoder writes)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    # one filter byte (0 = None) per scanline, then the row's RGB bytes
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced grayscale/RGB/RGBA PNG -> (H, W, C)
    uint8 (C = 1, 3 or 4). Covers all five scanline filters, so it reads
    PNGs from any encoder (golden references, this module's output)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, color "
                         f"type {ctype}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = bytearray(stride)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        row = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        for i in range(stride):
            a = row[i - channels] if i >= channels else 0
            b = prev[i]
            c = prev[i - channels] if i >= channels else 0
            if ftype == 1:
                row[i] = (row[i] + a) & 0xFF
            elif ftype == 2:
                row[i] = (row[i] + b) & 0xFF
            elif ftype == 3:
                row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
            elif ftype == 4:
                row[i] = (row[i] + _paeth(a, b, c)) & 0xFF
            elif ftype != 0:
                raise ValueError(f"{path}: bad filter type {ftype}")
        out[y] = np.frombuffer(bytes(row), np.uint8)
        prev = row
    return out.reshape(h, w, channels)

from tinyraytracer_tpu.ops import tonemap


class Image:
    """Float image with optional gamma applied at construction, mirroring
    Image::new_with_gamma_correction (image.rs:29-36)."""

    def __init__(self, data: np.ndarray, gamma: Optional[float] = None):
        data = np.asarray(data, np.float32)
        if data.ndim != 3 or data.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3), got {data.shape}")
        if gamma is not None:
            data = np.maximum(data, 0.0) ** (1.0 / gamma)
        self._data = data

    @staticmethod
    def from_linear(data, gamma: float = tonemap.GAMMA) -> "Image":
        return Image(np.asarray(data), gamma=gamma)

    @property
    def data(self) -> np.ndarray:
        return self._data

    def size(self) -> Tuple[int, int]:
        h, w, _ = self._data.shape
        return (w, h)

    def get_pixel(self, x: int, y: int) -> np.ndarray:
        return self._data[y, x]

    def to_u8(self) -> np.ndarray:
        return np.asarray(
            np.clip(self._data, 0.0, tonemap.INTENSITY_MAX) * 255.0, np.uint8
        )

    def save(self, filename: str) -> None:
        rgb = self.to_u8()
        # Graceful fallback covers a MISSING native encoder only (library
        # unbuilt / import fails); a runtime error from a present encoder is
        # a real defect and must surface — same policy as the native BVH
        # builder (ops/bvh.py:160-164).
        try:
            from tinyraytracer_tpu.native import runtime
        except ImportError:
            runtime = None
        if runtime is not None and runtime.available():
            runtime.write_png(filename, rgb)
            return
        with open(filename, "wb") as f:
            f.write(encode_png(rgb))
