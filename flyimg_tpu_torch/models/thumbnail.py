"""Pillow's LANCZOS resize of an RGB u8 image, in numpy.

The smart-crop prescale of the JAX package calls
``PIL.Image.resize(..., Image.LANCZOS)``; the work image it produces
decides the candidate grid, so a one-level difference here can move the
chosen crop. This is a port of Pillow's fixed-point resampler
(``libImaging/Resample.c``) so the result equals Pillow's byte for byte
without Pillow installed:

- per axis, ``precompute_coeffs`` in double: support ``3 * max(scale, 1)``,
  bounds ``[int(center - support + 0.5), int(center + support + 0.5))``
  clipped to the image, weights ``lanczos((x + xmin - center + 0.5) / fs)``
  normalised by their sum;
- weights become 22-bit fixed point, rounded half away from zero;
- the horizontal pass runs first, over only the source rows the vertical
  pass reads, and clips to u8; the vertical pass reads that u8 image;
- each sum starts at ``1 << 21`` and the result is ``sum >> 22`` clipped
  to [0, 255].
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    # scalar libm sin, as Pillow calls it: a vectorised sin may differ in
    # the last bit, and a weight's last bit can move its fixed-point value
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xmin [out], count [out], fixed-point weights [out, ksize])."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmin = np.empty(out_size, np.int64)
    count = np.empty(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        n = hi - lo
        ss = 1.0 / filterscale
        w = [_lanczos((x + lo - center + 0.5) * ss) for x in range(n)]
        ww = 0.0
        for v in w:  # Pillow sums in index order
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :n] = w
        xmin[xx] = lo
        count[xx] = n
    scaled = kk * (1 << PRECISION_BITS)
    fixed = np.where(kk < 0, -0.5 + scaled, 0.5 + scaled).astype(np.int64)
    return xmin, count, fixed


def _apply(src: np.ndarray, xmin, count, fixed, axis: int) -> np.ndarray:
    """One pass over ``axis`` (1 = horizontal, 0 = vertical) of an
    [h, w, 3] u8 image -> u8."""
    out_size, ksize = fixed.shape
    in_size = src.shape[axis]
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    w = np.where(np.arange(ksize)[None, :] < count[:, None], fixed, 0)
    taps = np.take(src.astype(np.int64), idx, axis=axis)
    if axis == 1:      # [h, out, k, 3]
        acc = np.einsum("hokc,ok->hoc", taps, w)
    else:              # [out, k, w, 3]
        acc = np.einsum("okwc,ok->owc", taps, w)
    acc = acc + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def lanczos_resize(rgb: np.ndarray, w: int, h: int) -> np.ndarray:
    """``Image.fromarray(rgb).resize((w, h), Image.LANCZOS)`` as an
    [h, w, 3] u8 array."""
    in_h, in_w = rgb.shape[:2]
    if (in_w, in_h) == (w, h):
        return np.array(rgb, copy=True)
    need_h = w != in_w
    need_v = h != in_h
    ymin, ycount, yk = _coeffs(in_h, h)
    img = np.asarray(rgb, np.uint8)
    if need_h:
        first = int(ymin[0])
        last = int(ymin[-1] + ycount[-1])
        xmin, xcount, xk = _coeffs(in_w, w)
        img = _apply(img[first:last], xmin, xcount, xk, axis=1)
        ymin = ymin - first
    if need_v:
        img = _apply(img, ymin, ycount, yk, axis=0)
    return np.ascontiguousarray(img)
