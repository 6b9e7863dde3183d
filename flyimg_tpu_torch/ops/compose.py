"""Plan -> device program, on PyTorch.

The port of ``flyimg_tpu/ops/compose.py``. A program is the reference's
chain

    uint8 in -> windowed resample (f32) -> [extent pad] -> [grayscale]
    -> [monochrome dither] -> [rotate] -> [unsharp] -> [sharpen] -> [blur]
    -> round (half to even) / clip -> uint8 out

over a leading batch axis, with every per-image geometry input (true
sizes, source spans, rotated bounds) a per-member tensor, so one program
serves every source size in a padded bucket. Every stage takes and returns
f32; the chain rounds once, at the end: the last stage stores u8 itself
where its kernel can, else ``quantize_u8`` does. On the card the stages are
kernels: the resample is the dense form (two ``torch.matmul``s) or K1
(ops/resample.py, u8 or f32 store), pad + grayscale + dither is one K6
launch (ops/color.py), a sampled rotate is K4 (ops/rotate.py; quarter
turns on the static path are flips), each filter is K5 (ops/filters.py).

The face post-passes (``fb_1``, ``fc_1``) run after the program, in the
handler (models/faces.py). ``check_ported`` stays the hook for a stage the
port does not carry: a plan that needs one raises ``NotPortedException``
naming it before any device work, never skipping it silently.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import NotPortedException
from flyimg_tpu_torch.ops.color import gray_weights, pixel_pass
from flyimg_tpu_torch.ops.filters import gaussian_blur, sharpen, unsharp_mask
from flyimg_tpu_torch.ops.resample import (
    kernel_mode,
    quantize_u8,
    resample_banded_f32,
    resample_banded_u8,
    resample_image,
    select_band_taps,
)
from flyimg_tpu_torch.ops.rotate import rotate_image, rotate_image_dynamic
from flyimg_tpu_torch.spec.geometry import gravity_offset
from flyimg_tpu_torch.spec.plan import TransformPlan, rotated_bounds


@dataclass(frozen=True)
class Layout:
    """Host-resolved geometry for one image under one plan: the source
    window (span per axis) and the valid output extent the device program
    needs as per-member inputs."""

    span_y: Tuple[float, float]          # (start, size) in source rows
    span_x: Tuple[float, float]          # (start, size) in source cols
    out_true: Tuple[int, int]            # valid (h, w) of resample output
    resample_out: Tuple[int, int]        # static (h, w) of resample stage
    pad_canvas: Optional[Tuple[int, int]] = None   # (w, h) ett pad canvas
    pad_offset: Tuple[int, int] = (0, 0)


def plan_layout(plan: TransformPlan) -> Layout:
    """Collapse extract + resize/crop-fill + extent-crop into one windowed
    resample (see ops/resample.py). Pure host math, no device work."""
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

    pad_canvas = None
    pad_offset = (0, 0)
    if plan.extent is not None:
        tw, th = plan.extent
        off_x, off_y = gravity_offset(rw, rh, tw, th, plan.gravity)
        if off_x >= 0 and off_y >= 0 and tw <= rw and th <= rh:
            # pure crop: fuse into the resample window
            sx = eff_w / rw
            sy = eff_h / rh
            span_x = (base_x + off_x * sx, tw * sx)
            span_y = (base_y + off_y * sy, th * sy)
            return Layout(span_y, span_x, (th, tw), (th, tw))
        # pad direction (or mixed): resample to (rw, rh) then extent-pad.
        # gravity_offset gives the crop-region offset within the image; the
        # image's position on the larger canvas is its negation.
        pad_canvas = (tw, th)
        pad_offset = (-off_x, -off_y)

    span_x = (base_x, eff_w)
    span_y = (base_y, eff_h)
    return Layout(span_y, span_x, (rh, rw), (rh, rw), pad_canvas, pad_offset)


def _needs_resample(plan: TransformPlan, layout: Optional[Layout] = None) -> bool:
    return (
        plan.resize_to is not None
        or plan.extent is not None
        or plan.extract is not None
    )


#: (plan attribute, stage name) of each stage the port does not carry yet:
#: none since the face post-passes were ported
UNPORTED: Tuple[Tuple[str, str], ...] = ()


def unported_stages(plan: TransformPlan) -> List[str]:
    """The stages this plan needs that the port does not carry yet."""
    return [stage for attr, stage in UNPORTED if getattr(plan, attr)]


def check_ported(plan: TransformPlan) -> None:
    """Raise ``NotPortedException`` naming every stage of ``plan`` the port
    does not carry yet (called before any device work)."""
    missing = unported_stages(plan)
    if missing:
        raise NotPortedException(
            f"stage(s) {', '.join(missing)} not ported to the PyTorch "
            "package yet"
        )


def post_stages(plan: TransformPlan, pad_canvas) -> List[str]:
    """The program's stages after the resample, in the reference's order:
    ``pixel`` (extent pad, grayscale and dither: one K6 launch), ``rotate``,
    ``unsharp``, ``sharpen``, ``blur``."""
    stages = []
    if pad_canvas is not None or gray_weights(plan.colorspace) or plan.monochrome:
        stages.append("pixel")
    for name in ("rotate", "unsharp", "sharpen", "blur"):
        if getattr(plan, name) is not None:
            stages.append(name)
    return stages


def make_program_fn(
    resample_out: Optional[Tuple[int, int]],
    pad_canvas: Optional[Tuple[int, int]],
    pad_offset: Tuple[int, int],
    plan: TransformPlan,
    rotate_dynamic: bool = False,
    band_taps: Optional[Tuple[int, int]] = None,
):
    """The batched device program for one op config:
    ``program(img_u8 [B, H, W, 3], in_true [B, 2 | 4], span_y [B, 2],
    span_x [B, 2], out_true [B, 2]) -> u8 [B, oh, ow, 3]``, every tensor on
    one device. ``band_taps`` None runs the dense resample; ``(Ky, Kx)``
    runs kernel K1 with those static band widths.

    With ``rotate_dynamic`` the rotate stage runs on a shape-bucketed frame
    with per-member valid dims, so mixed-size rotate traffic shares one
    program; ``in_true`` is then [h, w, rot_h, rot_w] — valid input dims
    plus the host-computed rotated output extent (see final_extent)."""
    method = plan.filter_method
    gray = gray_weights(plan.colorspace)
    stages = post_stages(plan, pad_canvas)

    def program(img_u8, in_true, span_y, span_x, out_true):
        cur_true = in_true[:, :2]
        if resample_out is None:
            if not stages:
                # u8 -> f32 -> round/clip -> u8 is the identity
                return img_u8.clone()
            x = img_u8.to(torch.float32)
        elif band_taps is not None:
            banded = resample_banded_f32 if stages else resample_banded_u8
            x = banded(img_u8, resample_out, span_y, span_x, out_true,
                       in_true[:, :2], band_taps, method)
            cur_true = out_true
        else:
            x = resample_image(
                img_u8.to(torch.float32), resample_out, span_y, span_x,
                out_true, in_true[:, :2], method,
            ).contiguous()
            cur_true = out_true
        for i, stage in enumerate(stages):
            u8 = i == len(stages) - 1
            if stage == "pixel":
                x = pixel_pass(x, pad_canvas, pad_offset, plan.background,
                               gray, plan.monochrome, out_u8=u8)
            elif stage == "rotate" and rotate_dynamic:
                # a dynamic rotate never follows a pad (batcher policy)
                x = rotate_image_dynamic(x, plan.rotate, plan.background,
                                         cur_true, in_true[:, 2:4], out_u8=u8)
            elif stage == "rotate":
                x = rotate_image(x, plan.rotate, plan.background, out_u8=u8)
            elif stage == "unsharp":
                r, s, gain, thr = plan.unsharp
                x = unsharp_mask(x, r, s, gain, thr, out_u8=u8)
            elif stage == "sharpen":
                r, s, _, _ = plan.sharpen
                x = sharpen(x, r, s, out_u8=u8)
            else:
                r, s = plan.blur
                x = gaussian_blur(x, r, s, out_u8=u8)
        return x if x.dtype == torch.uint8 else quantize_u8(x).contiguous()

    return program


def final_extent(plan: TransformPlan, layout: Layout) -> Tuple[int, int]:
    """Final valid (h, w) of the program output for one image — what a
    padded/bucketed output must be sliced to. Follows the stage order:
    resample valid extent -> extent canvas -> rotated bounds."""
    h, w = layout.out_true
    if layout.pad_canvas is not None:
        w, h = layout.pad_canvas
    if plan.rotate is not None:
        rw, rh = rotated_bounds(w, h, plan.rotate)
        h, w = rh, rw
    return (int(h), int(w))


def _bucket_dim(size: int, step: int = 128) -> int:
    return max(((size + step - 1) // step) * step, step)


def bucket_batch(n: int) -> int:
    """Round a batch occupancy up the power-of-two ladder, so a handful
    of batch shapes serve every occupancy. Shared by the transform batcher
    and the aux (scoring) programs."""
    return 1 << max(n - 1, 0).bit_length()


def geometry_rows(plan: TransformPlan, layout: Layout, image_hw,
                  src_window=None, rot_hw=None) -> np.ndarray:
    """[8] f32: in_true (h, w), span_y, span_x, out_true — one member's
    per-image program inputs, with a ``src_window`` (x, y) offset applied
    as a span shift; [10] with the rotated bounds ``rot_hw`` (h, w) of a
    dynamic-rotate group appended."""
    h, w = image_hw
    sy0, sy1 = layout.span_y
    sx0, sx1 = layout.span_x
    if src_window is not None:
        sx0 -= src_window[0]
        sy0 -= src_window[1]
    row = [h, w, sy0, sy1, sx0, sx1, layout.out_true[0], layout.out_true[1]]
    if rot_hw is not None:
        row += [rot_hw[0], rot_hw[1]]
    return np.array(row, np.float32)


def program_args(geo: torch.Tensor):
    """(in_true, span_y, span_x, out_true) of a program from [B, 8 | 10]
    geometry rows; in_true is [B, 4] (valid h, w, rotated h, w) when the
    rows carry rotated bounds."""
    in_true = geo[:, 0:2]
    if geo.shape[1] == 10:
        in_true = torch.cat([in_true, geo[:, 8:10]], dim=1)
    return in_true, geo[:, 2:4], geo[:, 4:6], geo[:, 6:8]


def run_plan(
    image: np.ndarray,
    plan: TransformPlan,
    src_window: Optional[Tuple[int, int]] = None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Execute a plan on one host image [h, w, 3] uint8 -> uint8 output.

    Pads the input up to a shape bucket (the pad region gets zero resample
    weight by construction) and runs the batch-1 program on ``device``.
    ``src_window`` is the ROI contract of the JAX package: the image is
    only the window of the plan's source starting at this (x, y) offset,
    threaded to the program as a span shift."""
    dev = resolve_device(device)
    h, w = int(image.shape[0]), int(image.shape[1])
    if src_window is not None:
        wx, wy = int(src_window[0]), int(src_window[1])
        if (
            wx < 0 or wy < 0
            or wx + w > plan.src_size[0] or wy + h > plan.src_size[1]
        ):
            raise ValueError(
                f"src_window {(wx, wy)} + image {(w, h)} exceeds plan "
                f"src {plan.src_size}"
            )
        if not _needs_resample(plan):
            raise ValueError("src_window requires a resample/extract plan")
    elif plan.src_size != (w, h):
        raise ValueError(
            f"plan was built for src {plan.src_size}, got image {(w, h)}; "
            "rebuild the plan with build_plan(options, w, h)"
        )
    check_ported(plan)
    layout = plan_layout(plan)

    slice_out = None
    band = None
    if _needs_resample(plan):
        bh, bw = _bucket_dim(h), _bucket_dim(w)
        padded = np.zeros((bh, bw, image.shape[2]), dtype=np.uint8)
        padded[:h, :w] = image
        resample_out = layout.resample_out
        band = select_band_taps(
            kernel_mode(), plan.filter_method, (bh, bw),
            layout.span_y, layout.span_x, layout.out_true,
        )
    elif plan.rotate is None:
        # pixel-op-only plans ride shape buckets with edge-replicate
        # padding (IM's edge virtual pixels for the filters); the valid
        # region is sliced back out below
        bh, bw = _bucket_dim(h), _bucket_dim(w)
        padded = np.pad(image, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge")
        resample_out = None
        slice_out = (h, w)
    else:
        # a static rotate sees the exact frame: its bounds derive from the
        # whole frame, and bucket padding under a following filter would
        # smear the background across the valid edge. Nothing here
        # compiles, so one program per source size costs nothing.
        padded = image
        resample_out = None

    fn = make_program_fn(
        resample_out, layout.pad_canvas, layout.pad_offset,
        plan.device_plan(), band_taps=band,
    )
    geo = torch.from_numpy(
        geometry_rows(plan, layout, (h, w), src_window)[None]
    ).to(dev)
    out = fn(torch.from_numpy(np.ascontiguousarray(padded)[None]).to(dev),
             *program_args(geo))
    result = out[0].cpu().numpy()
    if slice_out is not None:
        result = np.ascontiguousarray(result[: slice_out[0], : slice_out[1]])
    return result
