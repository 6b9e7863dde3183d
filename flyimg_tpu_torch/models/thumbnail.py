"""Pillow's LANCZOS and BILINEAR resizes of a u8 image, in numpy.

The smart-crop prescale of the JAX package calls
``PIL.Image.resize(..., Image.LANCZOS)``; the work image it produces
decides the candidate grid, so a one-level difference here can move the
chosen crop. BlazeFace's network inputs and the Haar pyramid call
``Image.resize(..., Image.BILINEAR)`` on RGB and luma images. This is a
port of Pillow's fixed-point resampler (``libImaging/Resample.c``) so the
result equals Pillow's byte for byte without Pillow installed:

- per axis, ``precompute_coeffs`` in double: support ``s * max(scale, 1)``
  (``s`` = 3 for LANCZOS, 1 for BILINEAR), bounds
  ``[int(center - support + 0.5), int(center + support + 0.5))`` clipped to
  the image, weights ``filter((x + xmin - center + 0.5) / fs)`` normalised
  by their sum;
- weights become 22-bit fixed point, rounded half away from zero;
- the horizontal pass runs first, over only the source rows the vertical
  pass reads, and clips to u8; the vertical pass reads that u8 image;
- each sum starts at ``1 << 21`` and the result is ``sum >> 22`` clipped
  to [0, 255].

``resize`` takes Pillow's ``box`` (a float region of the source, passed to
the core as C floats), and an RGBA image resizes premultiplied as
``Image.resize`` does it (``convert("RGBa")``, resample, ``convert("RGBA")``,
with Pillow's integer rounding both ways).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


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


def _bilinear(x: float) -> float:
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


#: Pillow's filters: (function, support)
LANCZOS = (_lanczos, 3.0)
BILINEAR = (_bilinear, 1.0)


def _coeffs(in_size: int, out_size: int,
            filt: Tuple[Callable[[float], float], float] = LANCZOS,
            in0: float = 0.0, in1: Optional[float] = None,
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xmin [out], count [out], fixed-point weights [out, ksize]) of the
    source span [in0, in1) (C floats, as ``precompute_coeffs`` takes them;
    the whole axis by default)."""
    fn, base_support = filt
    f0 = np.float32(in0)
    f1 = np.float32(in_size if in1 is None else in1)
    scale = float(f1 - f0) / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmin = np.empty(out_size, np.int64)
    count = np.empty(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = float(f0) + (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        n = hi - lo
        ss = 1.0 / filterscale
        w = [fn((x + lo - center + 0.5) * ss) for x in range(n)]
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
    [h, w, c] u8 image -> u8, a tap at a time (the same integer sums
    without the [.., out, ksize, ..] tensor of every tap)."""
    out_size, ksize = fixed.shape
    in_size = src.shape[axis]
    w = np.where(np.arange(ksize)[None, :] < count[:, None], fixed, 0)
    shape = list(src.shape)
    shape[axis] = out_size
    acc = np.full(shape, 1 << (PRECISION_BITS - 1), np.int64)
    for k in range(ksize):
        idx = np.minimum(xmin + k, in_size - 1)
        tap = np.take(src, idx, axis=axis).astype(np.int64)
        weight = w[:, k][None, :, None] if axis == 1 else w[:, k][:, None, None]
        acc += tap * weight
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pillow's MULDIV255: a * b / 255 rounded, in integers."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def premultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa (``rgbA2rgba``): each colour c * a / 255 with
    its MULDIV255 rounding."""
    px = rgba.astype(np.int64)
    out = px.copy()
    out[..., :3] = muldiv255(px[..., :3], px[..., 3:])
    return out.astype(np.uint8)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA (``rgba2rgbA``): each colour 255 * c / a,
    truncated and clipped; a pixel of alpha 0 or 255 as it is."""
    px = rgba.astype(np.int64)
    a = px[..., 3:]
    scaled = np.minimum(255 * px[..., :3] // np.maximum(a, 1), 255)
    out = px.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), px[..., :3], scaled)
    return out.astype(np.uint8)


def resize(img: np.ndarray, w: int, h: int, filt=LANCZOS,
           box: Optional[Sequence[float]] = None) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), filter, box)`` of an
    [h, w, c] or [h, w] u8 array (c 3, or 4 for RGBA, resized
    premultiplied as Pillow does), as an array of the same rank."""
    img = np.asarray(img, np.uint8)
    flat = img.ndim == 2
    if flat:
        img = img[..., None]
    in_h, in_w = img.shape[:2]
    box = (0.0, 0.0, float(in_w), float(in_h)) if box is None else tuple(box)
    if (in_w, in_h) == (w, h) and box == (0, 0, in_w, in_h):
        out = np.array(img, copy=True)
    elif img.shape[2] == 4:
        out = unpremultiply(_resample(premultiply(img), w, h, filt, box))
    else:
        out = _resample(img, w, h, filt, box)
    out = np.ascontiguousarray(out)
    return out[..., 0] if flat else out


def _resample(img: np.ndarray, w: int, h: int, filt, box) -> np.ndarray:
    """``ImagingResampleInner`` of an [h, w, c] u8 image over ``box``."""
    in_h, in_w = img.shape[:2]
    x0, y0, x1, y1 = (np.float32(v) for v in box)
    # a pass runs where the size changes or the box is not (0, 0, the
    # output size) on that axis
    need_h = w != in_w or x0 != 0 or x1 != w
    need_v = h != in_h or y0 != 0 or y1 != h
    out = img
    ymin, ycount, yk = _coeffs(in_h, h, filt, y0, y1)
    if need_h:
        first = int(ymin[0])
        last = int(ymin[-1] + ycount[-1])
        xmin, xcount, xk = _coeffs(in_w, w, filt, x0, x1)
        out = _apply(out[first:last], xmin, xcount, xk, axis=1)
        ymin = ymin - first
    if need_v:
        out = _apply(out, ymin, ycount, yk, axis=0)
    return out if out is not img else np.array(img, copy=True)


def lanczos_resize(rgb: np.ndarray, w: int, h: int) -> np.ndarray:
    """``Image.fromarray(rgb).resize((w, h), Image.LANCZOS)`` as an
    [h, w, 3] u8 array."""
    return resize(rgb, w, h, LANCZOS)


def bilinear_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.BILINEAR)`` of an
    [h, w, 3] or [h, w] u8 array."""
    return resize(img, w, h, BILINEAR)
