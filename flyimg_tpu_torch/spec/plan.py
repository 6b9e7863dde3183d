"""TransformPlan: the declarative device-program description.

Where the reference builds one ImageMagick command string per request
(reference: src/Core/Processor/ImageProcessor.php:66-110) and hands it to a
shell, this framework resolves the request into a frozen ``TransformPlan``.
The plan is hashable: it IS the compile-cache key (together with the padded
input bucket shape), so every request with the same plan signature shares one
program, and requests sharing a signature can be batched into a single
device launch.

Stage order preserved from the reference's command-line order (IM applies
options left to right): geometry (resize / crop-fill / extent) -> colorspace
-> monochrome -> rotate (with background fill) -> unsharp -> sharpen -> blur.
The ``-filter`` option is applied to the resample itself (documented behavior,
docs/url-options.md:236-242; in the reference snapshot the flag is emitted
after ``-thumbnail`` and therefore silently inert — we follow the docs).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace
from typing import Optional, Tuple

from flyimg_tpu_torch.exceptions import InvalidArgumentException
from flyimg_tpu_torch.spec.colors import parse_color
from flyimg_tpu_torch.spec.geometry import (
    GeometryPlan,
    _round_dim,
    gravity_offset,
    parse_extent,
    resolve_geometry,
)
from flyimg_tpu_torch.spec.options import OptionsBag

# resize filter name -> resample method (IM filter names). THE supported
# f_ vocabulary (docs/application-options.md "Resize filter vocabulary");
# anything else aliases to lanczos3, the reference's IM default.
FILTER_METHODS = {
    "lanczos": "lanczos3",
    "triangle": "triangle",
    "point": "nearest",
    "box": "box",
    "cubic": "cubic",
    "catrom": "cubic",
    "gaussian": "gaussian",  # true taps (ops/resample.py _kernel_fn)
}


def resolve_filter(options: "OptionsBag", metrics=None) -> str:
    """The f_ option -> resample method, aliasing unknown names to
    lanczos3 like the reference's IM default. ``metrics`` is accepted for
    signature parity with the JAX package; this package does not count
    aliases yet."""
    raw = str(options.get_option("filter") or "Lanczos").lower()
    return FILTER_METHODS.get(raw, "lanczos3")


def parse_colorspace(options: "OptionsBag") -> Optional[str]:
    """THE clsp_ parser (build_plan and the handler's container check
    both consume it — two copies would drift). Normalizes IM's spelling
    variants (LinearGray / linear-gray / Linear Gray all name one
    colorspace in IM's MagickCore option table) and returns None (native
    sRGB), 'gray', 'gray601', or 'cmyk'.

    'cmyk': device pixels stay RGB; the ENCODER stores CMYK samples (IM's
    sRGB->CMYK black-extraction formula, JPEG container only — the
    handler validates the container before any decode/device work).
    Every other IM colorspace (lab, hsl, ...) would change the stored
    sample meaning; refusing loudly beats a silent no-op that serves sRGB
    bytes while the URL claims otherwise (reference forwards the value to
    convert, ImageProcessor.php:88)."""
    raw = re.sub(
        r"[^a-z0-9]", "", str(options.get_option("colorspace") or "").lower()
    )
    if raw in ("gray", "grey", "grayscale", "lineargray", "rec709luma"):
        return "gray"
    if raw == "rec601luma":
        return "gray601"  # SD-video luma weights, distinct from 709
    if raw == "cmyk":
        return "cmyk"
    if raw in ("", "none", "srgb", "rgb"):
        return None
    raise InvalidArgumentException(
        f"unsupported colorspace {raw!r} (supported: gray/grey/grayscale/"
        "lineargray/rec601luma/rec709luma, cmyk, srgb, rgb)"
    )


_GEOM_ARG_RE = re.compile(
    r"^(?P<radius>\d*\.?\d+)?(?:x(?P<sigma>\d*\.?\d+))?"
    r"(?:\+(?P<gain>\d*\.?\d+))?(?:\+(?P<threshold>\d*\.?\d+))?$"
)


def parse_kernel_arg(
    value: object,
    *,
    default_gain: float = 1.0,
    default_threshold: float = 0.0,
) -> Optional[Tuple[float, float, float, float]]:
    """Parse IM's ``{radius}x{sigma}[+gain][+threshold]`` argument form used
    by -blur/-sharpen/-unsharp (docs/url-options.md:209-234).

    Returns (radius, sigma, gain, threshold). Omitted fields take the given
    defaults per-field, matching IM which defaults each of sigma/gain/psi
    independently of whether the others were supplied (sigma defaults to 1).
    """
    if value in (None, "", False):
        return None
    match = _GEOM_ARG_RE.match(str(value))
    if not match:
        return None
    radius = float(match.group("radius") or 0.0)
    sigma = float(match.group("sigma")) if match.group("sigma") else 1.0
    gain = float(match.group("gain")) if match.group("gain") else default_gain
    threshold = (
        float(match.group("threshold"))
        if match.group("threshold")
        else default_threshold
    )
    return (radius, sigma, gain, threshold)


@dataclass(frozen=True)
class TransformPlan:
    """Fully-resolved, hashable description of one image transform.

    Every field is a concrete static value; nothing here depends on pixel
    data. ``plan.signature()`` excludes the source dims so images of
    different sizes resized to the same target can share a bucketed batch.
    """

    # geometry
    src_size: Tuple[int, int]                      # (w, h) of decoded source
    resize_to: Optional[Tuple[int, int]]           # resample target (w, h)
    extent: Optional[Tuple[int, int]]              # final canvas (w, h)
    gravity: str = "Center"
    filter_method: str = "lanczos3"
    # pixel ops
    colorspace: Optional[str] = None               # 'gray' | None (sRGB no-op)
    monochrome: bool = False
    rotate: Optional[float] = None                 # degrees, clockwise (IM)
    background: Optional[Tuple[int, int, int]] = None
    unsharp: Optional[Tuple[float, float, float, float]] = None
    sharpen: Optional[Tuple[float, float, float, float]] = None
    blur: Optional[Tuple[float, float]] = None     # (radius, sigma)
    # post passes (run after the main program, possibly on new geometry)
    smart_crop: bool = False
    face_crop: bool = False
    face_crop_position: int = 0
    face_blur: bool = False
    # source pre-pass
    extract: Optional[Tuple[int, int, int, int]] = None  # x0, y0, x1, y1

    # ---- derived geometry ---------------------------------------------------

    @property
    def effective_src(self) -> Tuple[int, int]:
        """Source dims after the extract pre-pass (if any)."""
        if self.extract is not None:
            x0, y0, x1, y1 = self.extract
            return (x1 - x0, y1 - y0)
        return self.src_size

    @property
    def final_size(self) -> Tuple[int, int]:
        """Output (w, h) after geometry + rotate (pre smart/face post-passes)."""
        w, h = self.effective_src
        if self.resize_to is not None:
            w, h = self.resize_to
        if self.extent is not None:
            w, h = self.extent
        if self.rotate:
            w, h = rotated_bounds(w, h, self.rotate)
        return (w, h)

    def crop_offset(self) -> Tuple[int, int]:
        """Gravity offset of the extent canvas within the resized image."""
        if self.extent is None:
            return (0, 0)
        cur_w, cur_h = self.resize_to if self.resize_to else self.effective_src
        return gravity_offset(cur_w, cur_h, self.extent[0], self.extent[1], self.gravity)

    # ---- caching ------------------------------------------------------------

    def signature(self) -> Tuple:
        """Compile/batch key: every field except the concrete source size.
        Two requests with equal signatures and equal input bucket shapes run
        the same device program (and can share one batched launch)."""
        return (
            self.resize_to, self.extent, self.gravity, self.filter_method,
            self.colorspace, self.monochrome, self.rotate, self.background,
            self.unsharp, self.sharpen, self.blur, self.smart_crop,
            self.face_crop, self.face_crop_position, self.face_blur,
        )

    def with_src(self, src_w: int, src_h: int) -> "TransformPlan":
        return replace(self, src_size=(src_w, src_h))

    def device_plan(self) -> "TransformPlan":
        """Canonical form for the program compile cache: geometry fields
        (src/resize/extent/gravity/extract) are zeroed because they reach the
        device program as traced spans or separate static args, and the
        smart/face post-pass flags are dropped because they run as separate
        programs. Only fields the compiled pixel program actually reads
        (filter, color ops, rotate, background, conv kernels) survive."""
        return replace(
            self,
            src_size=(0, 0),
            resize_to=None,
            extent=None,
            gravity="Center",
            extract=None,
            smart_crop=False,
            face_crop=False,
            face_crop_position=0,
            face_blur=False,
        )


# ---------------------------------------------------------------------------
# ROI decode window (docs/host-pipeline.md "ROI window math")

#: safety pixels added beyond the resample filter's tap radius when
#: computing a decode window: absorbs the float span rounding AND the
#: <=1 u8 chroma-upsampling difference a JPEG crop decode can show in its
#: outermost columns (the affected pixels land inside the margin, outside
#: the span any output pixel samples)
ROI_TAP_MARGIN = 2

#: a decode window is only worth restricting to when it covers at most
#: this fraction of the frame's pixels: near-full windows still pay the
#: entropy decode of (almost) every row, so the crop bookkeeping would
#: cost more than the skipped IDCT saves
ROI_MAX_FRAME_FRAC = 0.8


def plan_source_window(
    plan: TransformPlan,
) -> Optional[Tuple[float, float, float, float]]:
    """The float source rectangle ``(x0, y0, x1, y1)`` the plan's windowed
    resample actually samples, or None when it spans the full frame.

    Mirrors ``ops.compose.plan_layout``'s span fusion — extract is a
    source pre-pass, and a pure extent-crop (offset inside the resized
    image on both axes) fuses into the resample window — and is pinned
    against plan_layout by test so the two cannot drift. Everything
    downstream of the resample (color ops, rotate, convs, post passes)
    consumes resample OUTPUT pixels and never widens the source window.
    """
    src_w, src_h = plan.src_size
    if plan.extract is not None:
        x0, y0, x1, y1 = plan.extract
        base_x, base_y = float(x0), float(y0)
        eff_w, eff_h = float(x1 - x0), float(y1 - y0)
    else:
        base_x = base_y = 0.0
        eff_w, eff_h = float(src_w), float(src_h)
    if plan.resize_to is not None:
        rw, rh = plan.resize_to
    else:
        rw, rh = int(eff_w), int(eff_h)
    if plan.extent is not None:
        tw, th = plan.extent
        off_x, off_y = gravity_offset(rw, rh, tw, th, plan.gravity)
        if off_x >= 0 and off_y >= 0 and tw <= rw and th <= rh:
            sx = eff_w / rw
            sy = eff_h / rh
            window = (
                base_x + off_x * sx,
                base_y + off_y * sy,
                base_x + off_x * sx + tw * sx,
                base_y + off_y * sy + th * sy,
            )
            return None if _is_full_frame(window, src_w, src_h) else window
    window = (base_x, base_y, base_x + eff_w, base_y + eff_h)
    return None if _is_full_frame(window, src_w, src_h) else window


def _is_full_frame(window, src_w: int, src_h: int) -> bool:
    x0, y0, x1, y1 = window
    return x0 <= 0.0 and y0 <= 0.0 and x1 >= src_w and y1 >= src_h


def _plan_window_out(plan: TransformPlan) -> Tuple[int, int]:
    """Output (w, h) of the windowed resample — what the span maps onto
    (extent for a fused pure crop, else resize target, else the window
    itself); sets the tap-support scale in decode_roi_window."""
    if plan.extent is not None:
        rw, rh = plan.resize_to if plan.resize_to else plan.effective_src
        tw, th = plan.extent
        off_x, off_y = gravity_offset(rw, rh, tw, th, plan.gravity)
        if off_x >= 0 and off_y >= 0 and tw <= rw and th <= rh:
            return (tw, th)
    if plan.resize_to is not None:
        return plan.resize_to
    return plan.effective_src


def decode_roi_window(
    plan: TransformPlan,
    *,
    max_frame_frac: float = ROI_MAX_FRAME_FRAC,
) -> Optional[Tuple[int, int, int, int]]:
    """The integer source window ``(x0, y0, x1, y1)`` a ROI-capable
    decoder may restrict itself to for this plan, or None when the plan
    consumes (nearly) the whole frame.

    The window is the plan's sampled span (:func:`plan_source_window`)
    expanded per axis by the resample filter's tap support radius in
    SOURCE pixels — ``support * max(downscale_factor, 1)`` taps reach at
    most that far beyond a sampled position — plus ``ROI_TAP_MARGIN``
    slack, clamped to the frame. With that margin, a decode of only this
    window followed by a span shift of the device resample produces
    bit-identical samples to a full-frame decode: every tap an output
    pixel reads lands inside the window, and at real frame edges the
    window edge IS the frame edge so tap zeroing matches exactly.
    """
    window = plan_source_window(plan)
    if window is None:
        return None
    src_w, src_h = plan.src_size
    if src_w <= 0 or src_h <= 0:
        return None
    # lazy import: spec is a lower layer than ops (which imports torch);
    # sharing ops.resample's FILTER_SUPPORT table keeps ONE source of
    # truth for tap radii (the same table K-selection derives from)
    from flyimg_tpu_torch.ops.resample import FILTER_SUPPORT

    support = FILTER_SUPPORT.get(plan.filter_method, 3.0)
    x0, y0, x1, y1 = window
    out_w, out_h = _plan_window_out(plan)
    scale_x = (x1 - x0) / max(out_w, 1)
    scale_y = (y1 - y0) / max(out_h, 1)
    margin_x = math.ceil(support * max(scale_x, 1.0)) + ROI_TAP_MARGIN
    margin_y = math.ceil(support * max(scale_y, 1.0)) + ROI_TAP_MARGIN
    ix0 = max(int(math.floor(x0)) - margin_x, 0)
    iy0 = max(int(math.floor(y0)) - margin_y, 0)
    ix1 = min(int(math.ceil(x1)) + margin_x, src_w)
    iy1 = min(int(math.ceil(y1)) + margin_y, src_h)
    if ix1 <= ix0 or iy1 <= iy0:
        return None
    if (ix1 - ix0) * (iy1 - iy0) > max_frame_frac * src_w * src_h:
        return None
    return (ix0, iy0, ix1, iy1)


def rotated_bounds(w: int, h: int, degrees: float) -> Tuple[int, int]:
    """Enclosing bounding box of a w x h image rotated by ``degrees``
    (IM RotateImage grows the canvas to the rotated bounding box; for
    multiples of 90 the dims swap exactly)."""
    quad = degrees % 360.0
    if quad in (0.0, 180.0):
        return (w, h)
    if quad in (90.0, 270.0):
        return (h, w)
    rad = math.radians(quad)
    new_w = int(math.floor(abs(w * math.cos(rad)) + abs(h * math.sin(rad)) + 0.5))
    new_h = int(math.floor(abs(w * math.sin(rad)) + abs(h * math.cos(rad)) + 0.5))
    return (max(new_w, 1), max(new_h, 1))


def _positive_or_none(value: Optional[int]) -> Optional[int]:
    """Non-positive target dims are nonsense a URL can carry; treat as
    unset — shared by build_plan and decode_target_hint so the DCT
    prescale hint can never diverge from the plan's sanitization."""
    return value if value and value > 0 else None


def decode_target_hint(options: OptionsBag) -> Optional[Tuple[int, int]]:
    """The (w, h) box the decoder may prescale toward (JPEG DCT-domain
    scaling). Accounts for sc_N so an upscaling request never decodes below
    the final target — the decode must stay >= 2x the device resample's
    output for the resample to be quality-determining."""
    if options.truthy("extract"):
        # e_ coordinates are in ORIGINAL source pixels: a DCT-prescaled
        # decode would shrink the frame underneath them and build_plan
        # would clamp the box against the wrong dims — silently cropping
        # a different region. Extract plans decode at full scale; the
        # ROI window decode (decode_roi; docs/host-pipeline.md) is the
        # optimization that serves them instead.
        return None
    tw = _positive_or_none(options.int_option("width"))
    th = _positive_or_none(options.int_option("height"))
    if not (tw or th):
        return None
    w, h = (tw or th), (th or tw)
    pct = _parse_scale(options.get_option("scale"))
    if pct is not None:
        factor = pct / 100.0
        w = _round_dim(w * factor)
        h = _round_dim(h * factor)
    return (w, h)


def _parse_scale(value: object) -> Optional[float]:
    """sc_N -> percentage; accepts '50' or '50%'. Non-positive/garbage -> None."""
    if value in (None, "", False):
        return None
    text = str(value).strip().rstrip("%")
    try:
        pct = float(text)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(pct) or pct <= 0.0:
        return None
    return pct


def _parse_rotate(value: object) -> Optional[float]:
    if value in (None, "", False):
        return None
    try:
        degrees = float(value)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(degrees):
        return None
    return degrees if degrees % 360.0 != 0.0 else None


def build_plan(
    options: OptionsBag,
    src_w: int,
    src_h: int,
    metrics=None,
) -> TransformPlan:
    """Resolve an OptionsBag + source dims into a TransformPlan.

    This is the analog of ImageProcessor::generateCommand
    (reference ImageProcessor.php:66-110) with the same option sources:
    width/height/crop/gravity/preserve-natural-size drive geometry
    (``calculateSize``, :115-130), colorspace/monochrome map to pixel ops,
    and background/rotate/unsharp/sharpen/blur come from the forwarded set
    (``checkForwardedOptions``, :303-315).
    """
    width = _positive_or_none(options.int_option("width"))
    height = _positive_or_none(options.int_option("height"))
    crop = options.truthy("crop")
    pns = options.truthy("preserve-natural-size")
    par = options.truthy("preserve-aspect-ratio")
    gravity = str(options.get_option("gravity") or "Center")

    # Extract is a source pre-pass (reference ImageHandler.php:162-165 runs
    # ExtractProcessor before the main convert; the lazy identify that feeds
    # geometry then sees the post-extract dims). Clamp the box to the image.
    extract = None
    eff_w, eff_h = src_w, src_h
    if options.truthy("extract"):
        coords = [options.int_option(k) for k in (
            "extract-top-x", "extract-top-y", "extract-bottom-x", "extract-bottom-y")]
        if all(c is not None for c in coords):
            x0 = max(0, min(coords[0], src_w))  # type: ignore[type-var]
            y0 = max(0, min(coords[1], src_h))  # type: ignore[type-var]
            x1 = max(0, min(coords[2], src_w))  # type: ignore[type-var]
            y1 = max(0, min(coords[3], src_h))  # type: ignore[type-var]
            if x1 > x0 and y1 > y0:
                extract = (x0, y0, x1, y1)
                eff_w, eff_h = x1 - x0, y1 - y0

    # sc_N: percentage scaling (docs/url-options.md). The reference parses
    # this option but never emits IM's -scale (latent dead code, like the
    # `thread` flag — SURVEY.md section 2.4); here it scales the requested
    # target — or, with no w/h, the post-extract source dims. Explicit
    # scaling means upscaling is intended, so it bypasses the pns
    # no-upscale rule. IM dimension rounding (_round_dim) throughout.
    scale_pct = _parse_scale(options.get_option("scale"))
    if scale_pct is not None:
        factor = scale_pct / 100.0
        if width or height:
            width = _round_dim(width * factor) if width else None
            height = _round_dim(height * factor) if height else None
        else:
            width = _round_dim(eff_w * factor)
            height = _round_dim(eff_h * factor)
        pns = False

    geometry: GeometryPlan = resolve_geometry(
        eff_w, eff_h, width, height,
        crop=crop, gravity=gravity,
        preserve_natural_size=pns, preserve_aspect_ratio=par,
        extent=parse_extent(options.get_option("extent")),
    )

    filter_method = resolve_filter(options, metrics=metrics)
    # rz_1 selects -resize over -thumbnail in the reference (ImageProcessor
    # .php:264-272); both are the same resample here (thumbnail only adds
    # metadata stripping, which is a host/encode concern).

    colorspace = parse_colorspace(options)

    monochrome = options.truthy("monochrome")

    # IM -unsharp defaults psi (threshold) to 0.05 whenever it is absent,
    # independent of whether gain was given (mogrify.c PsiValue handling).
    unsharp = parse_kernel_arg(
        options.get_option("unsharp"), default_threshold=0.05
    )
    sharpen = parse_kernel_arg(options.get_option("sharpen"))
    blur_arg = parse_kernel_arg(options.get_option("blur"))
    blur = (blur_arg[0], blur_arg[1]) if blur_arg else None

    return TransformPlan(
        src_size=(src_w, src_h),
        resize_to=geometry.resize_to,
        extent=geometry.extent,
        gravity=geometry.gravity,
        filter_method=filter_method,
        colorspace=colorspace,
        monochrome=monochrome,
        rotate=_parse_rotate(options.get_option("rotate")),
        background=parse_color(options.get_option("background")),
        unsharp=unsharp,
        sharpen=sharpen,
        blur=blur,
        smart_crop=options.truthy("smart-crop"),
        face_crop=options.truthy("face-crop"),
        face_crop_position=options.int_option("face-crop-position", 0) or 0,
        face_blur=options.truthy("face-blur"),
        extract=extract,
    )
