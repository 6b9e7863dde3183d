"""ICO sources for the port's host codec layer.

The JAX package decodes an icon through Pillow's IcoImagePlugin, which
loads the largest entry (by area, then the least colour depth); the card
machine has no Pillow. An entry is a PNG (decoded by ``codecs/png.py``,
with alpha only when the PNG's own mode carries it: Pillow does not carry a
``tRNS`` key into the icon) or a DIB (``codecs/bmp.py``) at half its
header's height, whose alpha is the fourth byte of each pixel when the entry
is 32-bit and otherwise its AND mask (a set bit is transparent).
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Tuple

import numpy as np

from flyimg_tpu_torch.codecs import bmp, png
from flyimg_tpu_torch.exceptions import ExecFailedException

MAGIC = b"\x00\x00\x01\x00"


def _largest(data: bytes) -> Tuple[int, int, int, int, int, int]:
    """(width, height, bpp, size, offset) of the entry Pillow loads."""
    count = struct.unpack_from("<H", data, 4)[0]
    entries = []
    for i in range(count):
        e = data[6 + 16 * i:22 + 16 * i]
        if len(e) < 16:
            raise ExecFailedException("ICO decode failed: a truncated directory")
        w, h, colors = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack_from("<HII", e, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((w, h, bpp, size, offset, depth))
    if not entries:
        raise ExecFailedException("ICO decode failed: no entries")
    entries.sort(key=lambda x: x[5])
    entries.sort(key=lambda x: x[0] * x[1], reverse=True)
    return entries[0]


def decode(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """ICO bytes -> (rgb, alpha or None) of the entry Pillow loads."""
    if data[:4] != MAGIC:
        raise ExecFailedException("not an ICO file")
    _w, _h, bpp, size, offset, _depth = _largest(data)
    entry = data[offset:]
    if entry[:8] == png.SIGNATURE:
        rgb, alpha = png.decode(entry)
        colour_type = entry[25] if len(entry) > 25 else 0
        return rgb, alpha if colour_type in (4, 6) else None
    dib = bmp.Dib(data, offset, 0)
    w, h = dib.width, int(dib.height / 2)
    rgb, _ = dib.decode(data, height=h)
    if bpp == 32:
        raw = data[dib.pixels:dib.pixels + w * h * 4][3::4]
        if len(raw) < w * h:
            raise ExecFailedException("image file is truncated (ICO alpha)")
        alpha = np.frombuffer(raw, np.uint8).reshape(h, w)[::-1]
    else:
        wp = w + (32 - w % 32) % 32
        total = wp * h // 8
        start = offset + size - total
        raw = data[start:start + total]
        if start < 0 or len(raw) < total:
            raise ExecFailedException("image file is truncated (ICO mask)")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, wp // 8), axis=1)
        alpha = np.where(bits[::-1, :w] == 1, 0, 255).astype(np.uint8)
    return rgb, np.ascontiguousarray(alpha)
