"""PNG decode and encode on ``zlib`` and numpy.

The PNG half of the JAX package's host codec layer (``flyimg_tpu/codecs``,
which goes through Pillow or a native libpng build), with no dependency
beyond the standard library and numpy:

- decode: 8-bit, non-interlaced gray (0), RGB (2), gray+alpha (4) and RGBA
  (6), with all five row filters (None, Sub, Up, Average, Paeth);
  anything else raises ``UnsupportedMediaException``;
- encode: 8-bit RGB or RGBA, each row Up-filtered (the first row has no
  row above it, so Up is the identity there), zlib level 6.

Sub and Up rows unfilter as whole-row numpy operations; Average and Paeth
carry a left-to-right dependency and unfilter one pixel at a time.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    UnsupportedMediaException,
)

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ExecFailedException("truncated PNG chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ExecFailedException(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length


def _paeth_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = [0] * len(filt)
    f = filt.tolist()
    b_ = prior.tolist()
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        b = b_[i]
        c = b_[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (f[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def _average_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = [0] * len(filt)
    f = filt.tolist()
    b_ = prior.tolist()
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (f[i] + ((a + b_[i]) >> 1)) & 0xFF
    return np.array(out, np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < height * (stride + 1):
        raise ExecFailedException("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(
        height, stride + 1
    )
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(rows[y, 0])
        filt = rows[y, 1:]
        if ftype == 0:
            cur = filt.copy()
        elif ftype == 1:    # Sub: running sum along each byte lane
            lanes = filt.reshape(-1, bpp).astype(np.uint64)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = filt + prior
        elif ftype == 3:
            cur = _average_row(filt, prior, bpp)
        elif ftype == 4:
            cur = _paeth_row(filt, prior, bpp)
        else:
            raise ExecFailedException(f"PNG row filter {ftype} is invalid")
        out[y] = cur
        prior = cur
    return out


def decode(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """PNG bytes -> (rgb [h, w, 3] u8, alpha [h, w] u8 or None)."""
    if data[:8] != SIGNATURE:
        raise UnsupportedMediaException("not a PNG stream")
    header = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ExecFailedException("PNG has no IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise UnsupportedMediaException(
            f"PNG with bit depth {depth}, color type {color}, interlace "
            f"{interlace} is not supported (8-bit non-interlaced gray, "
            "gray+alpha, RGB or RGBA only)"
        )
    channels = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ExecFailedException(f"PNG image data: {exc}") from exc
    pixels = _unfilter(raw, height, width * channels, channels).reshape(
        height, width, channels
    )
    if channels in (1, 2):
        rgb = np.repeat(pixels[..., :1], 3, axis=2)
    else:
        rgb = pixels[..., :3]
    alpha = pixels[..., -1].copy() if channels in (2, 4) else None
    return np.ascontiguousarray(rgb), alpha


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + ctype + body
        + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)
    )


def encode(rgb: np.ndarray, alpha: Optional[np.ndarray] = None) -> bytes:
    """[h, w, 3] u8 (+ [h, w] u8 alpha) -> PNG bytes (RGB or RGBA)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes u8 [h, w, 3], got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    pixels = rgb if alpha is None else np.dstack([rgb, alpha])
    color = 2 if alpha is None else 6
    rows = pixels.reshape(h, -1)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]          # Up filter, mod 256 in u8
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[:, 1:] = up
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (
        SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
