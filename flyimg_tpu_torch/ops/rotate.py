"""Rotation with background fill, and kernel K4.

The port of ``flyimg_tpu/ops/rotate.py``. Replaces ImageMagick's
shear-based -rotate. Multiples of 90 on the static path are exact
flips/transposes. Every sampled rotate — any angle on the dynamic
(shape-bucketed) path, any other angle on the static path — uses an
inverse affine map with bilinear sampling into the enclosing bounding box,
corners filled with the background colour (IM default white): kernel K4
(``csrc/rotate.cu``) on a CUDA tensor, ``rotate_plain`` on a CPU tensor.

Every function takes a batch [B, H, W, 3] f32; the dynamic path's valid
size and rotated bounds are per-member [B, 2] rows.

The ring rotate of a tall image split by rows across ranks
(``parallel/tiling.py tiled_rotate``) runs ``ring_rotate_step`` once per
rank per ring step: kernel K15 (``csrc/ring_rotate.cu``) on a CUDA tensor,
``ring_rotate_step_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.ops.pad import WHITE
from flyimg_tpu_torch.ops.resample import quantize_u8
from flyimg_tpu_torch.spec.plan import rotated_bounds


def rotation_terms(degrees: float) -> Tuple[float, float]:
    """(cos, sin) of ``degrees % 360``, each rounded to f32 — the values
    the JAX package's weak typing multiplies by."""
    theta = math.radians(degrees % 360.0)
    return float(np.float32(math.cos(theta))), float(np.float32(math.sin(theta)))


def rotate_plain(
    image: torch.Tensor,
    degrees: float,
    background: Optional[Tuple[int, int, int]],
    geom: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch version of K4: ``geom`` [B, 4] f32 rows (valid h,
    valid w, rotated h, rotated w). Output is the static rotated bounds of
    the whole frame; each member's valid rotated content sits top-left in
    it, centred on its rotated bounds, background elsewhere. The reference's
    expression order throughout (xs, ys decide the floor and the
    ``inside`` test)."""
    b, h, w, c = image.shape
    out_w, out_h = rotated_bounds(w, h, degrees)
    dev = image.device
    bg = torch.tensor(background or WHITE, dtype=image.dtype, device=dev)
    cos_t, sin_t = rotation_terms(degrees)
    th = geom[:, 0, None, None]
    tw = geom[:, 1, None, None]
    yo = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    xo = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    cy_out = (geom[:, 2, None, None] - 1.0) / 2.0
    cx_out = (geom[:, 3, None, None] - 1.0) / 2.0
    cy_in = (th - 1.0) / 2.0
    cx_in = (tw - 1.0) / 2.0
    dx = xo - cx_out
    dy = yo - cy_out
    xs = cos_t * dx + sin_t * dy + cx_in
    ys = -sin_t * dx + cos_t * dy + cy_in

    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    bidx = torch.arange(b, device=dev)[:, None, None]

    def gather(yy, xx):
        # clip to the VALID region so bucket padding is never sampled
        yc = torch.minimum(torch.clamp(yy, min=0.0), th - 1.0).to(torch.int64)
        xc = torch.minimum(torch.clamp(xx, min=0.0), tw - 1.0).to(torch.int64)
        return image[bidx, yc, xc]

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    sampled = top * (1 - fy) + bot * fy

    inside = (
        (xs >= -0.5) & (xs <= tw - 0.5) & (ys >= -0.5) & (ys <= th - 0.5)
    )[..., None]
    return torch.where(inside, sampled, bg)


def rotate_sampled(
    image: torch.Tensor,
    degrees: float,
    background: Optional[Tuple[int, int, int]],
    geom: torch.Tensor,
    out_u8: bool = False,
) -> torch.Tensor:
    """Sampled rotate of an f32 [B, H, W, 3] batch with per-member
    ``geom`` [B, 4] (valid h, valid w, rotated h, rotated w): kernel K4 on
    a CUDA tensor, ``rotate_plain`` on a CPU tensor. u8 out when
    ``out_u8``."""
    if image.dtype != torch.float32 or image.dim() != 4 or image.shape[3] != 3:
        raise ValueError(
            f"rotate takes f32 [B, H, W, 3], got {image.dtype} {tuple(image.shape)}"
        )
    b, h, w, _ = image.shape
    if geom.shape != (b, 4) or geom.dtype != torch.float32 or geom.device != image.device:
        raise ValueError(
            f"geom must be f32 [{b}, 4] on {image.device}, got {geom.dtype} "
            f"{tuple(geom.shape)} on {geom.device}"
        )
    if min(b, h, w) < 1:
        raise ValueError(f"rotate of an empty batch {tuple(image.shape)}")
    if image.device.type == "cpu":
        out = rotate_plain(image, degrees, background, geom)
        return quantize_u8(out) if out_u8 else out
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    image, geom = image.contiguous(), geom.contiguous()
    out_w, out_h = rotated_bounds(w, h, degrees)
    dtype = torch.uint8 if out_u8 else torch.float32
    out = torch.empty((b, out_h, out_w, 3), dtype=dtype, device=image.device)
    cos_t, sin_t = rotation_terms(degrees)
    bg = [float(v) for v in (background or WHITE)]
    rc = _lib().flyimg_rotate(
        image.data_ptr(), geom.data_ptr(), None if out_u8 else out.data_ptr(),
        out.data_ptr() if out_u8 else None, b, h, w, out_h, out_w, cos_t,
        sin_t, *bg, torch.cuda.current_stream(image.device).cuda_stream,
    )
    cuda_build.check(rc, "rotate")
    rotate_sampled.launches += 1
    return out


#: K4 launches since the last reset (a plain integer)
rotate_sampled.launches = 0


def rotate_image_dynamic(
    image: torch.Tensor,
    degrees: float,
    background: Optional[Tuple[int, int, int]],
    true_hw: torch.Tensor,
    rot_hw: torch.Tensor,
    out_u8: bool = False,
) -> torch.Tensor:
    """Rotate the DYNAMIC valid top-left (``true_hw`` [B, 2]) region of each
    member of a padded static frame — the shape-bucketed batch path, where
    mixed source sizes share one program. ``rot_hw`` [B, 2] is the
    host-computed rotated bounds (h, w) of each valid region. Output is the
    static rotated bounds of the full padded frame; 90-degree multiples hit
    integer coordinates, where bilinear degenerates to an exact copy."""
    geom = torch.cat([true_hw, rot_hw], dim=1).to(torch.float32)
    return rotate_sampled(image, degrees, background, geom, out_u8)


def rotate_image(
    image: torch.Tensor,
    degrees: float,
    background: Optional[Tuple[int, int, int]] = None,
    out_u8: bool = False,
) -> torch.Tensor:
    """Rotate [B, H, W, 3] clockwise by ``degrees`` (IM convention:
    positive angles rotate clockwise). Output is the static enclosing
    bbox; the whole frame is valid."""
    quad = degrees % 360.0
    if quad in (0.0, 90.0, 180.0, 270.0):
        if quad == 0.0:
            out = image
        elif quad == 90.0:
            out = torch.flip(image.transpose(1, 2), dims=(2,))
        elif quad == 180.0:
            out = torch.flip(image, dims=(1, 2))
        else:
            out = torch.flip(image.transpose(1, 2), dims=(1,))
        return quantize_u8(out) if out_u8 else out.contiguous()
    b, h, w, _ = image.shape
    out_w, out_h = rotated_bounds(w, h, degrees)
    # filled on the device: a host tensor copied here would stall the host
    # on the launch's stream
    geom = torch.empty((b, 4), dtype=torch.float32, device=image.device)
    for i, v in enumerate((h, w, out_h, out_w)):
        geom[:, i] = float(v)
    return rotate_sampled(image, degrees, background, geom, out_u8)


@dataclass(frozen=True)
class RingGeometry:
    """The constants of one ring rotate, each rounded to f32 as the JAX
    package's weak typing rounds them: cos and sin of the angle, the output
    and input centres, and the TRUE input height and width."""

    cos_t: float
    sin_t: float
    cy_out: float
    cx_out: float
    cy_in: float
    cx_in: float
    th: float
    tw: float


def ring_geometry(in_hw: Tuple[int, int], rot_hw: Tuple[int, int],
                  degrees: float) -> RingGeometry:
    """``RingGeometry`` of a ``degrees`` rotate of a true ``in_hw`` (h, w)
    image into rotated bounds ``rot_hw`` (h, w)."""
    cos_t, sin_t = rotation_terms(degrees)
    th, tw = float(in_hw[0]), float(in_hw[1])
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return RingGeometry(
        cos_t, sin_t, f32((rot_hw[0] - 1.0) / 2.0), f32((rot_hw[1] - 1.0) / 2.0),
        f32((th - 1.0) / 2.0), f32((tw - 1.0) / 2.0), th, tw,
    )


def ring_rotate_step_plain(
    visit: torch.Tensor,
    src0: int,
    row0: int,
    acc: torch.Tensor,
    geom: RingGeometry,
    last: bool = False,
    background: Optional[Tuple[int, int, int]] = None,
    out_u8: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of K15, in the reference's written
    expression order (as K4 and ``rotate_plain``; under ``jit`` XLA fuses
    some of these products and sums into multiply-adds, and which ones
    varies with the program): add into ``acc`` (f32 [out_h, out_w, 3], output rows [row0, row0
    + out_h), IN PLACE) the bilinear taps that ``visit`` (f32 [tile_h, W,
    3], source rows [src0, src0 + tile_h)) owns; with ``last``, apply the
    inside test and the background and return the result (u8 when
    ``out_u8``, else ``acc`` itself)."""
    out_h, out_w, _ = acc.shape
    tile_h = visit.shape[0]
    dev = acc.device
    yo = (torch.arange(out_h, dtype=torch.float32, device=dev) + float(row0))[:, None]
    xo = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    dx = xo - geom.cx_out
    dy = yo - geom.cy_out
    xs = geom.cos_t * dx + geom.sin_t * dy + geom.cx_in
    ys = -geom.sin_t * dx + geom.cos_t * dy + geom.cy_in
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    xc0 = torch.clamp(x0, 0.0, geom.tw - 1.0).to(torch.int64)
    xc1 = torch.clamp(x0 + 1.0, 0.0, geom.tw - 1.0).to(torch.int64)
    for yy, wrow in ((y0, 1.0 - fy), (y0 + 1.0, fy)):
        local = torch.clamp(yy, 0.0, geom.th - 1.0).to(torch.int64) - src0
        owned = ((local >= 0) & (local < tile_h))[..., None]
        lc = torch.clamp(local, 0, tile_h - 1)
        val = visit[lc, xc0] * (1.0 - fx) + visit[lc, xc1] * fx
        acc.add_(torch.where(owned, val * wrow, torch.zeros_like(val)))
    if not last:
        return acc
    inside = ((xs >= -0.5) & (xs <= geom.tw - 0.5) & (ys >= -0.5)
              & (ys <= geom.th - 0.5))[..., None]
    bg = torch.tensor(background or WHITE, dtype=torch.float32, device=dev)
    acc.copy_(torch.where(inside, acc, bg))
    return quantize_u8(acc) if out_u8 else acc


def ring_rotate_step(
    visit: torch.Tensor,
    src0: int,
    row0: int,
    acc: torch.Tensor,
    geom: RingGeometry,
    last: bool = False,
    background: Optional[Tuple[int, int, int]] = None,
    out_u8: bool = False,
) -> torch.Tensor:
    """One rank's step of the ring rotate (``ring_rotate_step_plain``'s
    contract): kernel K15 on CUDA tensors, the plain version on CPU
    tensors. ``acc`` is updated in place; the return is ``acc``, or on the
    last step with ``out_u8`` a new u8 tensor."""
    for name, t in (("visit", visit), ("acc", acc)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3:
            raise ValueError(f"{name} must be f32 [h, w, 3], got {t.dtype} {tuple(t.shape)}")
    if visit.device != acc.device:
        raise ValueError(f"visit on {visit.device} and acc on {acc.device}")
    if out_u8 and not last:
        raise ValueError("a u8 store is the last step's")
    tile_h, in_w, _ = visit.shape
    out_h, out_w, _ = acc.shape
    if min(tile_h, in_w, out_h, out_w) < 1 or src0 < 0 or row0 < 0:
        raise ValueError(f"empty ring step: visit {tuple(visit.shape)}, acc "
                         f"{tuple(acc.shape)}, src0 {src0}, row0 {row0}")
    if visit.device.type == "cpu":
        return ring_rotate_step_plain(visit, src0, row0, acc, geom, last,
                                      background, out_u8)
    if visit.device.type != "cuda":
        raise ValueError(f"unsupported device {visit.device}")
    if not acc.is_contiguous():
        raise ValueError("acc must be contiguous (it is updated in place)")
    visit = visit.contiguous()
    out = (torch.empty(acc.shape, dtype=torch.uint8, device=acc.device)
           if out_u8 else None)
    bg = [float(v) for v in (background or WHITE)]
    rc = _ring_lib().flyimg_ring_rotate_step(
        visit.data_ptr(), int(src0), tile_h, in_w, acc.data_ptr(),
        None if out is None else out.data_ptr(), int(row0), out_h, out_w,
        geom.cos_t, geom.sin_t, geom.cy_out, geom.cx_out, geom.cy_in,
        geom.cx_in, geom.th, geom.tw, int(last), *bg,
        torch.cuda.current_stream(acc.device).cuda_stream,
    )
    cuda_build.check(rc, "ring_rotate_step")
    ring_rotate_step.launches += 1
    return acc if out is None else out


#: K15 launches since the last reset (a plain integer)
ring_rotate_step.launches = 0


def _ring_lib():
    lib = cuda_build.load("ring_rotate")
    if not getattr(lib, "_flyimg_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.flyimg_ring_rotate_step
        fn.argtypes = [p, i, i, i, p, p, i, i, i] + [f] * 8 + [i] + [f] * 3 + [p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


def _lib():
    lib = cuda_build.load("rotate")
    if not getattr(lib, "_flyimg_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.flyimg_rotate
        fn.argtypes = [p] * 4 + [i] * 5 + [f] * 5 + [p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib
