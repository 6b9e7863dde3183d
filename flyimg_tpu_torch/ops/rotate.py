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


def source_positions(
    geom: torch.Tensor, degrees: float, out_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xs, ys) f32 [B, out_h, out_w]: each output pixel's source position
    for ``geom`` [B, 4] rows (valid h, valid w, rotated h, rotated w), in
    the reference's expression order (xs, ys decide the floor and the
    ``inside`` test)."""
    out_h, out_w = out_hw
    dev = geom.device
    cos_t, sin_t = rotation_terms(degrees)
    yo = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    xo = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    cy_out = (geom[:, 2, None, None] - 1.0) / 2.0
    cx_out = (geom[:, 3, None, None] - 1.0) / 2.0
    cy_in = (geom[:, 0, None, None] - 1.0) / 2.0
    cx_in = (geom[:, 1, None, None] - 1.0) / 2.0
    dx = xo - cx_out
    dy = yo - cy_out
    xs = cos_t * dx + sin_t * dy + cx_in
    ys = -sin_t * dx + cos_t * dy + cy_in
    return xs, ys


def rotate_taps(
    xs: torch.Tensor, ys: torch.Tensor, geom: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """(inside, ya, yb, xa, xb) [B, out_h, out_w] of the source positions
    ``xs``, ``ys``: the ``inside`` test and the rows and columns of the four
    taps ``rotate_plain`` reads, each clipped to the member's VALID region
    (so bucket padding is never sampled)."""
    th = geom[:, 0, None, None]
    tw = geom[:, 1, None, None]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi - 1.0).to(torch.int64)

    inside = (xs >= -0.5) & (xs <= tw - 0.5) & (ys >= -0.5) & (ys <= th - 0.5)
    return inside, clip(y0, th), clip(y0 + 1, th), clip(x0, tw), clip(x0 + 1, tw)


def rotate_plain(
    image: torch.Tensor,
    degrees: float,
    background: Optional[Tuple[int, int, int]],
    geom: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch version of K4: ``geom`` [B, 4] f32 rows (valid h,
    valid w, rotated h, rotated w). Output is the static rotated bounds of
    the whole frame; each member's valid rotated content sits top-left in
    it, centred on its rotated bounds, background elsewhere."""
    b, h, w, c = image.shape
    out_hw = rotated_bounds(w, h, degrees)[::-1]
    dev = image.device
    bg = torch.tensor(background or WHITE, dtype=image.dtype, device=dev)
    xs, ys = source_positions(geom, degrees, out_hw)
    inside, ya, yb, xa, xb = rotate_taps(xs, ys, geom)
    fx = (xs - torch.floor(xs))[..., None]
    fy = (ys - torch.floor(ys))[..., None]
    bidx = torch.arange(b, device=dev)[:, None, None]
    p00 = image[bidx, ya, xa]
    p01 = image[bidx, ya, xb]
    p10 = image[bidx, yb, xa]
    p11 = image[bidx, yb, xb]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    sampled = top * (1 - fy) + bot * fy
    return torch.where(inside[..., None], sampled, bg)


#: K4's output tile (csrc/rotate.cu TILE): TILE x TILE pixels a block
K4_TILE = 32
#: the card's shared memory a block may take
K4_SMEM_LIMIT = 227 * 1024
#: the most rows a tile's source box may have (csrc/rotate.cu MAX_BOX_ROWS)
K4_MAX_BOX_ROWS = 64


def k4_box_pitch(box_w: int) -> int:
    """Floats of a staged box row of ``box_w`` pixels (csrc/rotate.cu
    box_pitch): its 16-byte words from the aligned one before it, 4 mod 8
    words."""
    return ((3 * box_w + 6) & ~3) | 4


@dataclass(frozen=True)
class K4Plan:
    """A K4 launch's constants: ``margin`` bounds how far an f32 source
    position lies from its exact value (f32, as the kernel receives it);
    a tile's source box spans at most ``box_w`` x ``box_h`` pixels, whose
    shared memory (rows of ``k4_box_pitch(box_w)`` floats) is ``box_cap``
    floats, an f32 launch's ``smem_bytes`` (the u8 instance stages no box:
    it gathers from device memory)."""

    margin: float
    box_w: int
    box_h: int
    box_cap: int
    smem_bytes: int


def k4_plan(batch: int, in_hw: Tuple[int, int], out_hw: Tuple[int, int],
            degrees: float) -> K4Plan:
    """K4's launch constants for a ``degrees`` rotate of a [batch, in_h,
    in_w] frame into [out_h, out_w]. The f32 position xs = (cos dx + sin
    dy) + cx_in is three roundings of terms no larger than |dx| + |dy| +
    |cx_in| (dx, dy and the centres are exact half-integers below 2^22),
    so it lies within 2^-22 (out_w + out_h + in_w) of its exact value; the
    margin doubles that and adds a pixel, which also covers the double
    arithmetic of the tile's corners (``k4_footprint``). A tile's exact
    positions span (TILE - 1)(|cos| + |sin|) pixels on each axis, so its
    box, widened by the margin on both sides and by the second tap, spans
    at most floor(span + 2 margin) + 4 pixels (one of slack)."""
    in_h, in_w = int(in_hw[0]), int(in_hw[1])
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if min(batch, in_h, in_w, out_h, out_w) < 1:
        raise ValueError(f"K4 plan of empty shapes {batch} x {in_hw} -> {out_hw}")
    if batch > 65535 or max(in_h, in_w, out_h, out_w) >= 1 << 22:
        raise ValueError(f"K4 takes at most 65535 members and sides below 2^22, "
                         f"got {batch} x {in_hw} -> {out_hw}")
    cos_t, sin_t = rotation_terms(degrees)
    margin = float(np.float32(1.0 + (out_w + out_h + in_w + in_h) / float(1 << 21)))
    span = (K4_TILE - 1) * (abs(cos_t) + abs(sin_t))
    reach = int(math.floor(span + 2.0 * margin)) + 4
    box_w, box_h = min(in_w, reach), min(in_h, reach)
    if box_h > K4_MAX_BOX_ROWS:
        raise ValueError(f"K4 box of {box_h} rows exceeds {K4_MAX_BOX_ROWS}")
    box_cap = box_h * k4_box_pitch(box_w)
    smem = 4 * box_cap
    if smem > K4_SMEM_LIMIT:
        raise ValueError(f"K4 box of {box_w} x {box_h} pixels exceeds shared memory")
    return K4Plan(margin, box_w, box_h, box_cap, smem)


def k4_footprint(plan: K4Plan, degrees: float, geom_row: Tuple[float, ...],
                 out_hw: Tuple[int, int], ty: int, tx: int) -> Tuple[bool, int, int, int, int]:
    """(skip, bx0, by0, bw, bh) of output tile (ty, tx) for one member's
    geometry row (valid h, valid w, rotated h, rotated w): the twin of
    csrc/rotate.cu thread 0's arithmetic (doubles, in the kernel's order).
    ``skip``: the tile's source box lies wholly outside the valid region, so
    no pixel of it passes the ``inside`` test; else every tap of the tile
    lies in columns [bx0, bx0 + bw) and rows [by0, by0 + bh)."""
    f32 = np.float32
    th, tw = f32(geom_row[0]), f32(geom_row[1])
    cy_out = f32(f32(geom_row[2]) - f32(1.0)) / f32(2.0)
    cx_out = f32(f32(geom_row[3]) - f32(1.0)) / f32(2.0)
    cy_in = f32(th - f32(1.0)) / f32(2.0)
    cx_in = f32(tw - f32(1.0)) / f32(2.0)
    cos_t, sin_t = rotation_terms(degrees)
    out_h, out_w = out_hw
    xo0, yo0 = tx * K4_TILE, ty * K4_TILE
    tw_t, th_t = min(K4_TILE, out_w - xo0), min(K4_TILE, out_h - yo0)
    xe, ye = [], []
    for i in range(4):
        dx = float(xo0 + (i & 1) * (tw_t - 1)) - float(cx_out)
        dy = float(yo0 + (i >> 1) * (th_t - 1)) - float(cy_out)
        xe.append(cos_t * dx + sin_t * dy + float(cx_in))
        ye.append(-sin_t * dx + cos_t * dy + float(cy_in))
    m = plan.margin
    xmin, xmax, ymin, ymax = min(xe), max(xe), min(ye), max(ye)
    skip = (xmax < -0.5 - m or xmin > float(tw) - 0.5 + m or ymax < -0.5 - m
            or ymin > float(th) - 0.5 + m)
    hx, hy = float(tw) - 1.0, float(th) - 1.0

    def clip(v, hi):
        return int(min(max(v, 0.0), hi))

    bx0, bx1 = clip(math.floor(xmin - m), hx), clip(math.floor(xmax + m) + 1.0, hx)
    by0, by1 = clip(math.floor(ymin - m), hy), clip(math.floor(ymax + m) + 1.0, hy)
    return skip, bx0, by0, bx1 - bx0 + 1, by1 - by0 + 1


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
    plan = k4_plan(b, (h, w), (out_h, out_w), degrees)
    dtype = torch.uint8 if out_u8 else torch.float32
    out = torch.empty((b, out_h, out_w, 3), dtype=dtype, device=image.device)
    cos_t, sin_t = rotation_terms(degrees)
    bg = [float(v) for v in (background or WHITE)]
    rc = _lib().flyimg_rotate(
        image.data_ptr(), geom.data_ptr(), None if out_u8 else out.data_ptr(),
        out.data_ptr() if out_u8 else None, b, h, w, out_h, out_w, cos_t,
        sin_t, *bg, plan.margin, plan.box_cap,
        torch.cuda.current_stream(image.device).cuda_stream,
    )
    cuda_build.check(rc, "rotate")
    rotate_sampled.launches += 1
    return out


#: K4 launches since the last reset (a plain integer)
rotate_sampled.launches = 0


def rotate_sampled_prev(
    image: torch.Tensor,
    degrees: float,
    background: Optional[Tuple[int, int, int]],
    geom: torch.Tensor,
    out_u8: bool = False,
) -> torch.Tensor:
    """``rotate_sampled``'s function on a CUDA tensor through the previous
    K4 (``csrc/rotate_prev.cu``), which ``chip_smoke.py`` holds K4 to the
    bit against. Not counted as a launch of ``rotate_sampled``."""
    if image.device.type != "cuda" or image.dtype != torch.float32:
        raise ValueError(f"the previous K4 takes an f32 CUDA tensor, got {image.dtype} "
                         f"on {image.device}")
    image, geom = image.contiguous(), geom.contiguous()
    b, h, w, _ = image.shape
    out_w, out_h = rotated_bounds(w, h, degrees)
    out = torch.empty((b, out_h, out_w, 3), device=image.device,
                      dtype=torch.uint8 if out_u8 else torch.float32)
    cos_t, sin_t = rotation_terms(degrees)
    lib = cuda_build.load("rotate_prev")
    fn = lib.flyimg_rotate_prev
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 4 + [i] * 5 + [f] * 5 + [p]
    fn.restype = ctypes.c_int
    rc = fn(image.data_ptr(), geom.data_ptr(), None if out_u8 else out.data_ptr(),
            out.data_ptr() if out_u8 else None, b, h, w, out_h, out_w, cos_t, sin_t,
            *[float(v) for v in (background or WHITE)],
            torch.cuda.current_stream(image.device).cuda_stream)
    cuda_build.check(rc, "rotate (previous K4)")
    return out


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
        fn.argtypes = [p] * 4 + [i] * 5 + [f] * 6 + [i, p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib
