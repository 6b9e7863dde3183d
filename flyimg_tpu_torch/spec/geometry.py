"""ImageMagick geometry semantics as pure functions.

The reference delegates all size math to ImageMagick's ParseMetaGeometry by
emitting ``-thumbnail WxH>`` (simple resize, no upscale) or
``-thumbnail WxH^ -gravity G -extent WxH`` (crop-fill) command fragments
(reference: src/Core/Processor/ImageProcessor.php:115-162). This module
reimplements that math exactly — including the round-half-up dimension
rounding and the per-axis target clamping the reference applies before a crop
(``updateTargetDimensions``, ImageProcessor.php:277-295) — and is pinned by
the geometry oracle ported from tests/Core/Processor/ImageProcessorTest.php.

All functions are static-shape friendly: they run at plan-build time on the
host, so the device program sees only concrete integers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

# ImageMagick gravity grid (reference docs/url-options.md:96; IM GravityType).
GRAVITIES = (
    "NorthWest",
    "North",
    "NorthEast",
    "West",
    "Center",
    "East",
    "SouthWest",
    "South",
    "SouthEast",
)
# IM parses gravity case-insensitively; unknown values fall back to Center.
_GRAVITY_BY_LOWER = {g.lower(): g for g in GRAVITIES}


def normalize_gravity(value: object) -> str:
    if isinstance(value, str):
        return _GRAVITY_BY_LOWER.get(value.strip().lower(), "Center")
    return "Center"


def _round_dim(value: float) -> int:
    """IM dimension rounding: floor(x + 0.5), min 1 (magick/geometry.c
    ParseMetaGeometry). E.g. 901 * 0.5 -> 451, which is why the reference
    oracle expects w_300 on a 600x901 portrait to give 300x451."""
    return max(int(math.floor(value + 0.5)), 1)


def scale_dimensions(
    src_w: int,
    src_h: int,
    width: Optional[int],
    height: Optional[int],
    *,
    fill: bool = False,
) -> Tuple[int, int]:
    """Proportional scaling core of ParseMetaGeometry.

    - width only  -> scale by width ratio
    - height only -> scale by height ratio
    - both: fit uses min(ratio), fill (the ``^`` flag) uses max(ratio)
    """
    if width and not height:
        factor = width / src_w
    elif height and not width:
        factor = height / src_h
    elif width and height:
        fx, fy = width / src_w, height / src_h
        factor = max(fx, fy) if fill else min(fx, fy)
    else:
        return src_w, src_h
    return _round_dim(src_w * factor), _round_dim(src_h * factor)


def fit_dimensions(
    src_w: int,
    src_h: int,
    width: Optional[int],
    height: Optional[int],
    *,
    no_upscale: bool = True,
) -> Tuple[int, int]:
    """``-thumbnail WxH>`` semantics: proportional fit inside the box; with
    the ``>`` flag (the default, preserve-natural-size=1) each computed axis
    is clamped back to the source size so the image never grows
    (ImageProcessor.php:154-162)."""
    new_w, new_h = scale_dimensions(src_w, src_h, width, height, fill=False)
    if no_upscale:
        if src_w < new_w:
            new_w = src_w
        if src_h < new_h:
            new_h = src_h
    return new_w, new_h


def fill_dimensions(
    src_w: int, src_h: int, width: int, height: int
) -> Tuple[int, int]:
    """``WxH^`` semantics: cover the box (max ratio)."""
    return scale_dimensions(src_w, src_h, width, height, fill=True)


def clamp_crop_target(
    src_w: int, src_h: int, width: int, height: int
) -> Tuple[int, int]:
    """Pre-crop target clamping when preserve-natural-size is on: each target
    axis larger than the source is pulled down to the source size
    (reference ImageProcessor.php:277-295). This is what makes
    ``w_400,h_400,c_1`` on a 300x200 source yield 300x200, and produces the
    'partial crop' cases in the oracle."""
    return min(width, src_w), min(height, src_h)


def gravity_offset(
    canvas_w: int, canvas_h: int, region_w: int, region_h: int, gravity: str
) -> Tuple[int, int]:
    """Top-left offset of a region of (region_w, region_h) positioned inside
    a canvas of (canvas_w, canvas_h) per IM gravity. Offsets can be negative
    when the region is larger than the canvas (extent-padding case). Division
    truncates toward zero like the C code."""
    gravity = normalize_gravity(gravity)
    dx = canvas_w - region_w
    dy = canvas_h - region_h
    if gravity in ("NorthWest", "West", "SouthWest"):
        x = 0
    elif gravity in ("North", "Center", "South"):
        x = int(dx / 2)
    else:
        x = dx
    if gravity in ("NorthWest", "North", "NorthEast"):
        y = 0
    elif gravity in ("West", "Center", "East"):
        y = int(dy / 2)
    else:
        y = dy
    return x, y


@dataclass(frozen=True)
class GeometryPlan:
    """Concrete, fully-resolved size plan for one image.

    ``resize_to``   — dims the source is resampled to (None = no resample).
    ``extent``      — final canvas dims; if different from resize_to the image
                      is cropped (region inside image) and/or padded
                      (image inside canvas) according to ``gravity``.
    The output-size precedence rule (extent over resize_to over source) lives
    in one place: TransformPlan.final_size.
    """

    src: Tuple[int, int]
    resize_to: Optional[Tuple[int, int]]
    extent: Optional[Tuple[int, int]]
    gravity: str = "Center"


def parse_extent(extent: object) -> Optional[Tuple[int, int]]:
    """Parse the ``ett_WxH`` option value."""
    if not extent or not isinstance(extent, str):
        return None
    parts = extent.lower().split("x")
    if len(parts) != 2:
        return None
    try:
        w, h = int(parts[0]), int(parts[1])
    except ValueError:
        return None
    if w <= 0 or h <= 0:
        return None
    return (w, h)


def resolve_geometry(
    src_w: int,
    src_h: int,
    width: Optional[int],
    height: Optional[int],
    *,
    crop: bool = False,
    gravity: str = "Center",
    preserve_natural_size: bool = True,
    preserve_aspect_ratio: bool = True,
    extent: Optional[Tuple[int, int]] = None,
) -> GeometryPlan:
    """Resolve the full size plan, mirroring ImageProcessor::calculateSize
    (reference ImageProcessor.php:115-130) plus the documented
    preserve-aspect-ratio=0 distort behavior (docs/url-options.md:311-315;
    dead code in the reference snapshot but part of its documented API).
    """
    resize_to: Optional[Tuple[int, int]] = None
    extent_out: Optional[Tuple[int, int]] = extent

    if width and height and crop:
        # crop-fill path: -thumbnail WxH^ -gravity G -extent WxH
        tw, th = (width, height)
        if preserve_natural_size:
            tw, th = clamp_crop_target(src_w, src_h, tw, th)
        resize_to = fill_dimensions(src_w, src_h, tw, th)
        extent_out = (tw, th)
    elif width and height and not preserve_aspect_ratio:
        # documented par_0: distort to exactly WxH (IM 'WxH!')
        resize_to = (width, height)
    elif width or height:
        resize_to = fit_dimensions(
            src_w, src_h, width, height, no_upscale=preserve_natural_size
        )

    if resize_to == (src_w, src_h):
        resize_to = None
    return GeometryPlan(
        src=(src_w, src_h),
        resize_to=resize_to,
        extent=extent_out,
        gravity=normalize_gravity(gravity),
    )
