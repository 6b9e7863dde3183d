"""BMP sources (and the DIB entries of an ICO) for the port's host codec
layer.

The JAX package decodes a BMP through Pillow's BmpImagePlugin; the card
machine has no Pillow. This module reads what that plugin reads, with its
mode choice, so a decode equals Pillow's:

- headers: the OS/2 core header (12 bytes) and the info, v2-v5 headers
  (40, 52, 56, 64, 108 and 124 bytes); rows bottom-up, or top-down for a
  negative height;
- 1-, 4- and 8-bit palettes (a gray ramp palette reads as gray), RLE8 and
  RLE4 (``codecs/native/raster.cpp``, Pillow's decoder quirks included);
- 16-bit (5-5-5, or 5-6-5 and 5-5-5 through bitfields), 24-bit, and 32-bit:
  without bitfields the fourth byte is ignored (RGB), with bitfields the
  masks Pillow knows pick the byte order and whether there is alpha.

Any other layout raises ``UnsupportedMediaException`` naming it.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from flyimg_tpu_torch.codecs import rasterlib
from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    UnsupportedMediaException,
)

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_COMPRESSION_NAMES = {4: "JPEG", 5: "PNG"}

#: (bits, masks) -> the byte layout of a pixel (Pillow's MASK_MODES)
_MASK_LAYOUTS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_DEFAULT_LAYOUTS = {16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _u16(b: bytes, o: int) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _u32(b: bytes, o: int) -> int:
    return struct.unpack_from("<I", b, o)[0]


class Dib:
    """A parsed bitmap: the header's fields, the pixel layout, the palette
    and where the pixels start."""

    def __init__(self, data: bytes, header: int, offset: int) -> None:
        """Read the bitmap header at ``header``; ``offset`` is the file
        header's pixel offset (0 for a DIB, whose pixels follow its palette)."""
        if header + 4 > len(data):
            raise ExecFailedException("BMP decode failed: no bitmap header")
        size = _u32(data, header)
        hd = data[header + 4:header + size]
        if len(hd) < size - 4:
            raise ExecFailedException("BMP decode failed: a truncated header")
        pos = header + size
        self.direction = -1
        masks = None
        if size == 12:
            self.width, self.height = _u16(hd, 0), _u16(hd, 2)
            self.bits, self.compression, colors, pad = _u16(hd, 6), _RAW, 0, 3
        elif size in (40, 52, 56, 64, 108, 124):
            flip = hd[7] == 0xFF
            self.direction = 1 if flip else -1
            self.width = _u32(hd, 0)
            self.height = (2 ** 32 - _u32(hd, 4)) if flip else _u32(hd, 4)
            self.bits, self.compression = _u16(hd, 10), _u32(hd, 12)
            colors, pad = _u32(hd, 28), 4
            if self.compression == _BITFIELDS:
                if len(hd) >= 48:
                    n = 4 if len(hd) >= 52 else 3
                    masks = [_u32(hd, 36 + 4 * k) for k in range(n)] + [0] * (4 - n)
                else:
                    masks = [_u32(data, pos + 4 * k) for k in range(3)] + [0]
                    pos += 12
        else:
            raise UnsupportedMediaException(
                f"a BMP header of {size} bytes is not ported to the PyTorch package")
        self.colors = colors or (1 << self.bits)
        if offset == 14 + size and self.bits <= 8:
            offset += 4 * self.colors
        self.layout = ""
        self.alpha = False
        if self.compression == _BITFIELDS:
            key = (self.bits, tuple(masks) if self.bits == 32 else tuple(masks[:3]))
            layout = _MASK_LAYOUTS.get(key)
            if layout is None:
                raise UnsupportedMediaException(
                    f"BMP bitfields {tuple(hex(m) for m in masks)} at {self.bits} bits "
                    "are not ported to the PyTorch package")
            self.layout, self.alpha = layout, "A" in layout
        elif self.compression == _RAW:
            if self.bits not in (1, 4, 8, 16, 24, 32):
                raise UnsupportedMediaException(
                    f"a {self.bits}-bit BMP is not ported to the PyTorch package")
            self.layout = _DEFAULT_LAYOUTS.get(self.bits, "P")
        elif self.compression in (_RLE8, _RLE4):
            self.layout = "RLE"
        else:
            name = _COMPRESSION_NAMES.get(self.compression, str(self.compression))
            raise UnsupportedMediaException(
                f"BMP compression {name} is not ported to the PyTorch package")
        self.palette: Optional[np.ndarray] = None
        self.gray = False
        if self.bits <= 8:
            if not 0 < self.colors <= 65536:
                raise ExecFailedException(f"BMP decode failed: {self.colors} palette entries")
            raw = data[pos:pos + pad * self.colors]
            pos += pad * self.colors
            entries = np.frombuffer(raw[: len(raw) // pad * pad], np.uint8).reshape(-1, pad)
            bgr = entries[:, :3]
            ramp = np.array([0, 255]) if self.colors == 2 else np.arange(self.colors)
            self.gray = len(bgr) == self.colors and bool(
                (bgr == ramp[:, None]).all())
            # Pillow reads a gray ramp as mode "1" (two entries) or "L", with
            # that mode's own sample size: only 1 and 8 bits read as written
            native = 1 if self.colors == 2 else 8
            if self.gray and (self.bits != native if self.layout != "RLE" else native == 1):
                raise UnsupportedMediaException(
                    f"a {self.bits}-bit BMP with a {self.colors}-entry gray ramp palette "
                    "is not ported to the PyTorch package")
            table = np.zeros((256, 3), np.uint8)
            n = min(len(bgr), 256)
            table[:n] = bgr[:n, ::-1]
            self.palette = table
        self.pixels = offset or pos

    def decode(self, data: bytes, height: Optional[int] = None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The pixels -> (rgb, alpha or None), rows top-down; ``height``
        reads fewer rows than the header says (an ICO's DIB)."""
        w, h = self.width, height if height is not None else self.height
        if w <= 0 or h <= 0:
            raise ExecFailedException("BMP decode failed: an empty bitmap")
        if self.layout == "RLE":
            flat = rasterlib.bmp_rle_decode(data[self.pixels:], self.pixels, w, h,
                                            self.compression == _RLE4)
            rows = min(len(flat) // w, h)
            idx = np.zeros((h, w), np.uint8)
            idx[:rows] = flat[: rows * w].reshape(rows, w)
            # the rows as written, bottom-up unless the height was negative
            idx = idx[::-1] if self.direction == -1 else idx
            return self._lookup(idx), None
        stride = ((w * self.bits + 31) >> 3) & ~3
        need = stride * h
        body = data[self.pixels:self.pixels + need]
        if len(body) < need:
            raise ExecFailedException("image file is truncated (BMP pixel data)")
        rows = np.frombuffer(body, np.uint8).reshape(h, stride)
        if self.direction == -1:
            rows = rows[::-1]
        if self.bits <= 8:
            if self.bits < 8:
                bits = np.unpackbits(rows, axis=1)
                per = self.bits
                vals = bits[:, : w * per].reshape(h, w, per)
                weights = (1 << np.arange(per - 1, -1, -1)).astype(np.uint8)
                idx = (vals * weights).sum(axis=2).astype(np.uint8)
            else:
                idx = rows[:, :w]
            return self._lookup(idx), None
        if self.bits == 16:
            p = rows[:, : 2 * w].view("<u2").astype(np.uint32)
            if self.layout == "BGR;16":
                r, g, b = (p >> 11) & 31, (p >> 5) & 63, p & 31
                rgb = np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], axis=-1)
            else:
                r, g, b = (p >> 10) & 31, (p >> 5) & 31, p & 31
                rgb = np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], axis=-1)
            return rgb.astype(np.uint8), None
        nb = self.bits // 8
        px = rows[:, : nb * w].reshape(h, w, nb)
        chan = {c: k for k, c in enumerate(self.layout)}
        rgb = np.ascontiguousarray(np.stack([px[..., chan[c]] for c in "RGB"], axis=-1))
        alpha = np.ascontiguousarray(px[..., chan["A"]]) if self.alpha else None
        return rgb, alpha

    def _lookup(self, idx: np.ndarray) -> np.ndarray:
        if self.gray:
            if self.colors == 2:
                idx = np.where(idx != 0, 255, 0).astype(np.uint8)
            return np.repeat(idx[..., None], 3, axis=2)
        return self.palette[idx]


def decode(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """BMP bytes -> (rgb [h, w, 3], alpha [h, w] or None), as Pillow
    decodes them."""
    if len(data) < 26 or data[:2] != b"BM":
        raise ExecFailedException("not a BMP file")
    dib = Dib(data, 14, _u32(data, 10))
    return dib.decode(data)
