"""Colourspace ops: grayscale and monochrome (ordered dither), and kernel K6.

The port of ``flyimg_tpu/ops/color.py`` (the weights and the Bayer matrix
are this package's own copies). The program's pixel stages — extent pad
(ops/pad.py), grayscale, monochrome dither — run on the card as ONE launch
of kernel K6 (``csrc/pixel_pass.cu``) through ``pixel_pass``, which also
stores u8 when it is the program's last stage. ``to_grayscale``,
``monochrome_dither`` and ``pixel_pass_plain`` are the plain PyTorch
versions; ``pixel_pass`` runs the plain version for a CPU tensor only.

DIVERGENCE from ImageMagick, kept from the JAX package: ``-monochrome`` is
an 8x8 ordered Bayer dither, not error diffusion (a serial recurrence).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.ops.pad import WHITE, extent_pad
from flyimg_tpu_torch.ops.resample import quantize_u8

# Rec.709 luma — what IM uses for '-colorspace Gray' (sRGB-companded luma)
LUMA_WEIGHTS = (0.212656, 0.715158, 0.072186)
# Rec.601 luma — IM's '-colorspace Rec601Luma' (SD-video weights)
LUMA_WEIGHTS_601 = (0.298839, 0.586811, 0.114350)

# canonical 8x8 Bayer matrix, values 0..63 (csrc/pixel_pass.cu holds the
# same table)
_BAYER8 = np.array(
    [
        [0, 32, 8, 40, 2, 34, 10, 42],
        [48, 16, 56, 24, 50, 18, 58, 26],
        [12, 44, 4, 36, 14, 46, 6, 38],
        [60, 28, 52, 20, 62, 30, 54, 22],
        [3, 35, 11, 43, 1, 33, 9, 41],
        [51, 19, 59, 27, 49, 17, 57, 25],
        [15, 47, 7, 39, 13, 45, 5, 37],
        [63, 31, 55, 23, 61, 29, 53, 21],
    ],
    dtype=np.float32,
)

#: 255 / 64, exact in f32: the dither threshold's scale
_BAYER_SCALE = 255.0 / 64.0


def _f32(v: float) -> float:
    """``v`` rounded to f32, as the JAX package's weak typing rounds a
    Python float before an f32 multiply."""
    return float(np.float32(v))


def fma_f32(a: torch.Tensor, b: Union[float, torch.Tensor],
            c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded ONCE, as a fused multiply-add rounds it
    (``b`` an f32 value or an f32 tensor).
    The product is exact in f64 (24 + 24 bits) and TwoSum gives the f64
    sum's error e exactly; rounding the f64 sum to f32 is then the fused
    result except where that sum lies exactly halfway between two f32s,
    where e says which side the exact value is on."""
    p = a.double() * b
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    rd = r.double()
    toward = torch.where(s > rd, torch.full_like(r, math.inf), torch.full_like(r, -math.inf))
    other = torch.nextafter(r, toward)
    od = other.double()
    fix = (s != rd) & ((s - rd) == (od - s)) & (e != 0) & ((e > 0) == (od > rd))
    return torch.where(fix, other, r)


def _luma(image: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """The luma as the JAX package's ``tensordot`` computes it on the CPU
    (XLA's dot): fma(b, w2, fma(g, w1, r * w0)) in f32."""
    w0, w1, w2 = (_f32(v) for v in weights)
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return fma_f32(b, w2, fma_f32(g, w1, r * w0))


def to_grayscale(image: torch.Tensor, weights=LUMA_WEIGHTS) -> torch.Tensor:
    """[..., H, W, 3] -> same shape, all channels = luma under ``weights``
    (Rec709 for '-colorspace Gray', LUMA_WEIGHTS_601 for Rec601Luma)."""
    return _luma(image, weights)[..., None].expand(image.shape).contiguous()


def dither_threshold(h: int, w: int, device=None) -> torch.Tensor:
    """[h, w] f32: (bayer[y % 8][x % 8] + 0.5) * 255/64."""
    tile = np.tile(_BAYER8, (h // 8 + 1, w // 8 + 1))[:h, :w]
    return (torch.from_numpy(np.ascontiguousarray(tile)).to(device) + 0.5) * _BAYER_SCALE


def monochrome_dither(image: torch.Tensor) -> torch.Tensor:
    """Bilevel black/white with ordered dithering, pixel range [0, 255]."""
    luma = _luma(image, LUMA_WEIGHTS)
    h, w = luma.shape[-2], luma.shape[-1]
    bw = torch.where(luma > dither_threshold(h, w, image.device), 255.0, 0.0)
    return bw[..., None].expand(image.shape).to(image.dtype).contiguous()


def gray_weights(colorspace: Optional[str]) -> Optional[Tuple[float, float, float]]:
    """The luma weights a plan's colourspace asks for, or None."""
    return {"gray": LUMA_WEIGHTS, "gray601": LUMA_WEIGHTS_601}.get(colorspace)


def pixel_pass_plain(
    image: torch.Tensor,
    canvas_wh: Optional[Tuple[int, int]],
    offset_xy: Tuple[int, int],
    background: Optional[Tuple[int, int, int]],
    gray: Optional[Sequence[float]],
    dither: bool,
    out_u8: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of K6: extent pad (when ``canvas_wh``),
    grayscale (when ``gray`` weights), monochrome dither, then u8."""
    x = image
    if canvas_wh is not None:
        x = extent_pad(x, canvas_wh, offset_xy, background)
    if gray is not None:
        x = to_grayscale(x, gray)
    if dither:
        x = monochrome_dither(x)
    return quantize_u8(x) if out_u8 else x


def pixel_pass(
    image: torch.Tensor,
    canvas_wh: Optional[Tuple[int, int]],
    offset_xy: Tuple[int, int],
    background: Optional[Tuple[int, int, int]],
    gray: Optional[Sequence[float]],
    dither: bool,
    out_u8: bool = False,
) -> torch.Tensor:
    """The program's pixel stages over an f32 [B, H, W, 3] batch: kernel K6
    on a CUDA tensor, ``pixel_pass_plain`` on a CPU tensor. Output is
    [B, canvas_h, canvas_w, 3] (the frame's shape with no pad), u8 when
    ``out_u8``."""
    if image.dtype != torch.float32 or image.dim() != 4 or image.shape[3] != 3:
        raise ValueError(
            f"pixel_pass takes f32 [B, H, W, 3], got {image.dtype} "
            f"{tuple(image.shape)}"
        )
    if gray is not None and len(gray) != 3:
        raise ValueError(f"gray weights must be 3 values, got {gray!r}")
    b, h, w, _ = image.shape
    if canvas_wh is None:
        ch, cw, off_x, off_y = h, w, 0, 0
    else:
        cw, ch = int(canvas_wh[0]), int(canvas_wh[1])
        off_x, off_y = int(offset_xy[0]), int(offset_xy[1])
    if min(b, h, w, ch, cw) < 1:
        raise ValueError(f"pixel_pass of empty shapes {tuple(image.shape)} -> {(ch, cw)}")
    if image.device.type == "cpu":
        return pixel_pass_plain(image, canvas_wh, offset_xy, background, gray,
                                dither, out_u8)
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    image = image.contiguous()
    dtype = torch.uint8 if out_u8 else torch.float32
    out = torch.empty((b, ch, cw, 3), dtype=dtype, device=image.device)
    bg = [_f32(v) for v in (background or WHITE)]
    gw = [_f32(v) for v in (gray or (0.0, 0.0, 0.0))]
    rc = _lib().flyimg_pixel_pass(
        image.data_ptr(), None if out_u8 else out.data_ptr(),
        out.data_ptr() if out_u8 else None,
        b, h, w, ch, cw, off_y, off_x, *bg, int(gray is not None), *gw,
        int(bool(dither)), torch.cuda.current_stream(image.device).cuda_stream,
    )
    cuda_build.check(rc, "pixel_pass")
    pixel_pass.launches += 1
    return out


#: K6 launches since the last reset (a plain integer)
pixel_pass.launches = 0


def _lib():
    lib = cuda_build.load("pixel_pass")
    if not getattr(lib, "_flyimg_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.flyimg_pixel_pass
        fn.argtypes = [p] * 3 + [i] * 7 + [f] * 3 + [i] + [f] * 3 + [i, p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib
