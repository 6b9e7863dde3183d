"""PNG decode and encode on ``zlib`` and numpy.

The PNG half of the JAX package's host codec layer (``flyimg_tpu/codecs``,
which goes through Pillow or a native libpng build), with no dependency
beyond the standard library and numpy:

- decode: every colour type and bit depth of the PNG specification (gray
  at 1, 2, 4, 8 and 16 bits; palette at 1, 2, 4 and 8 bits, with ``tRNS``
  alpha; RGB, gray+alpha and RGBA at 8 and 16 bits), non-interlaced or
  Adam7, with all five row filters (None, Sub, Up, Average, Paeth). The
  samples map to 8 bits as Pillow maps them, since Pillow is the JAX
  package's decode wherever its native libpng build is not loaded: gray
  below 8 bits scales to 0-255 (palette indices do not), 16-bit RGB,
  gray+alpha and RGBA keep their high byte, 16-bit gray saturates at 255;
  only a palette's ``tRNS`` gives an alpha plane (a colour key on gray or
  RGB does not); an index past the palette reads black;
- encode: 8-bit RGB or RGBA, each row Up-filtered (the first row has no
  row above it, so Up is the identity there), zlib level 6.

Sub and Up rows unfilter as whole-row numpy operations; Average and Paeth
carry a left-to-right dependency and unfilter one byte at a time. Each of
Adam7's seven passes is a small image of its own, unfiltered alone and
then scattered into the frame.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    UnsupportedMediaException,
)

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> (samples a pixel, the bit depths the specification allows)
_LAYOUT = {
    0: (1, (1, 2, 4, 8, 16)),
    2: (3, (8, 16)),
    3: (1, (1, 2, 4, 8)),
    4: (2, (8, 16)),
    6: (4, (8, 16)),
}
#: Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = (
    (0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
    (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1),
)


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


def _unfilter(raw: memoryview, height: int, stride: int, bpp: int) -> np.ndarray:
    """``height`` filtered rows of ``stride`` bytes (each after its filter
    byte) at the start of ``raw`` -> [height, stride] u8. ``bpp`` is the
    filters' byte distance to the left neighbour (at least 1)."""
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


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered [h, stride] bytes -> [h, width, channels] samples (u8
    below 16 bits, u16 at 16; a row's padding bits dropped)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        wide = rows[:, :width * channels * 2].reshape(h, width * channels, 2)
        return ((wide[..., 0].astype(np.uint16) << 8) | wide[..., 1]).reshape(
            h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]     # channels is 1
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, width, depth) * weights).sum(-1, dtype=np.uint8)[..., None]


def _pixels(raw: memoryview, width: int, height: int, channels: int,
            depth: int, interlace: int) -> np.ndarray:
    """The image's samples [height, width, channels]: one pass, or Adam7's
    seven scattered into the frame."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    if interlace == 0:
        stride = (width * bits + 7) // 8
        return _samples(_unfilter(raw, height, stride, bpp), width, channels, depth)
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in _ADAM7:
        pw = (width - x0 + dx - 1) // dx if width > x0 else 0
        ph = (height - y0 + dy - 1) // dy if height > y0 else 0
        if pw == 0 or ph == 0:
            continue    # an empty pass has no rows, not even filter bytes
        stride = (pw * bits + 7) // 8
        rows = _unfilter(raw[pos:], ph, stride, bpp)
        pos += ph * (stride + 1)
        out[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    return out


def decode(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """PNG bytes -> (rgb [h, w, 3] u8, alpha [h, w] u8 or None)."""
    if data[:8] != SIGNATURE:
        raise UnsupportedMediaException("not a PNG stream")
    header = None
    palette = None
    trns = None
    idat: List[bytes] = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ExecFailedException("PNG has no IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    layout = _LAYOUT.get(color)
    if layout is None or depth not in layout[1] or interlace not in (0, 1):
        raise UnsupportedMediaException(
            f"PNG with bit depth {depth}, color type {color}, interlace "
            f"{interlace} is not a valid PNG layout"
        )
    channels = layout[0]
    if color == 3 and palette is None:
        raise ExecFailedException("palette PNG has no PLTE chunk")
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as exc:
        raise ExecFailedException(f"PNG image data: {exc}") from exc
    pixels = _pixels(raw, width, height, channels, depth, interlace)
    alpha = None
    if color == 3:
        # Pillow's palette is 256 entries, black past the PLTE's, and a
        # tRNS shorter than the palette leaves the rest opaque
        lut = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8)[:768]
        lut[:len(entries) // 3] = entries[:len(entries) // 3 * 3].reshape(-1, 3)
        index = pixels[..., 0]
        rgb = lut[index]
        if trns is not None:
            alut = np.full(256, 255, np.uint8)
            alut[:min(len(trns), 256)] = np.frombuffer(trns, np.uint8)[:256]
            alpha = alut[index]
        return rgb, alpha
    if depth == 16:
        if color == 0:      # Pillow's I;16 -> RGB saturates
            pixels = np.minimum(pixels, 255).astype(np.uint8)
        else:               # RGB;16B, LA;16B, RGBA;16B: the high byte
            pixels = (pixels >> 8).astype(np.uint8)
    elif depth < 8:         # gray: 1, 2 and 4 bits scale to 0-255
        pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    if channels in (1, 2):
        rgb = np.repeat(pixels[..., :1], 3, axis=2)
    else:
        rgb = pixels[..., :3]
    if channels in (2, 4):
        alpha = np.ascontiguousarray(pixels[..., -1])
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
