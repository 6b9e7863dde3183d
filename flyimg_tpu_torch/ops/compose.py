"""Plan -> device program, on PyTorch.

The port of ``flyimg_tpu/ops/compose.py``. A program is the chain

    uint8 in -> windowed resample -> round/clip -> uint8 out

over a leading batch axis, with every per-image geometry input (true
sizes, source spans) a per-member tensor, so one program serves every
source size in a padded bucket. The resample is either the dense form
(f32 weight matrices + two ``torch.matmul``s, then the u8 epilogue) or
kernel K1, which fuses u8 load, both band passes and the u8 store
(ops/resample.py).

The reference's later stages — extent pad, grayscale, monochrome dither,
rotate, unsharp, sharpen, blur — are not ported yet: a plan that needs
one raises ``NotPortedException`` naming it when its program is built,
never skipping it silently.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import NotPortedException
from flyimg_tpu_torch.ops.resample import (
    kernel_mode,
    quantize_u8,
    resample_banded_u8,
    resample_image,
    select_band_taps,
)
from flyimg_tpu_torch.spec.geometry import gravity_offset
from flyimg_tpu_torch.spec.plan import TransformPlan


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


def unported_stages(
    plan: TransformPlan, pad_canvas: Optional[Tuple[int, int]] = None
) -> List[str]:
    """The device stages this plan needs that the port does not carry yet,
    in the reference's stage order."""
    stages = []
    if pad_canvas is not None:
        stages.append("pad")
    if plan.colorspace in ("gray", "gray601"):
        stages.append("grayscale")
    if plan.monochrome:
        stages.append("monochrome")
    if plan.rotate is not None:
        stages.append("rotate")
    if plan.unsharp is not None:
        stages.append("unsharp")
    if plan.sharpen is not None:
        stages.append("sharpen")
    if plan.blur is not None:
        stages.append("blur")
    return stages


def make_program_fn(
    resample_out: Optional[Tuple[int, int]],
    pad_canvas: Optional[Tuple[int, int]],
    pad_offset: Tuple[int, int],
    plan: TransformPlan,
    band_taps: Optional[Tuple[int, int]] = None,
):
    """The batched device program for one op config:
    ``program(img_u8 [B, H, W, 3], in_true [B, 2], span_y [B, 2],
    span_x [B, 2], out_true [B, 2]) -> u8 [B, oh, ow, 3]``, every tensor on
    one device. ``band_taps`` None runs the dense resample; ``(Ky, Kx)``
    runs kernel K1 with those static band widths."""
    missing = unported_stages(plan, pad_canvas)
    if missing:
        raise NotPortedException(
            f"device stage(s) {', '.join(missing)} not ported to the "
            "PyTorch package yet"
        )
    method = plan.filter_method

    def program(img_u8, in_true, span_y, span_x, out_true):
        if resample_out is None:
            # u8 -> f32 -> round/clip -> u8 is the identity
            return img_u8.clone()
        if band_taps is not None:
            return resample_banded_u8(
                img_u8, resample_out, span_y, span_x, out_true,
                in_true[:, :2], band_taps, method,
            )
        x = resample_image(
            img_u8.to(torch.float32), resample_out, span_y, span_x,
            out_true, in_true[:, :2], method,
        )
        return quantize_u8(x).contiguous()

    return program


def final_extent(plan: TransformPlan, layout: Layout) -> Tuple[int, int]:
    """Final valid (h, w) of the program output for one image — what a
    padded/bucketed output must be sliced to. Follows the stage order:
    resample valid extent -> extent canvas -> rotated bounds."""
    from flyimg_tpu_torch.spec.plan import rotated_bounds

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
                  src_window=None) -> np.ndarray:
    """[8] f32: in_true (h, w), span_y, span_x, out_true — one member's
    per-image program inputs, with a ``src_window`` (x, y) offset applied
    as a span shift."""
    h, w = image_hw
    sy0, sy1 = layout.span_y
    sx0, sx1 = layout.span_x
    if src_window is not None:
        sx0 -= src_window[0]
        sy0 -= src_window[1]
    return np.array(
        [h, w, sy0, sy1, sx0, sx1, layout.out_true[0], layout.out_true[1]],
        np.float32,
    )


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
    else:
        # pixel-op-only plans ride shape buckets with edge-replicate
        # padding; the valid region is sliced back out below
        bh, bw = _bucket_dim(h), _bucket_dim(w)
        padded = np.pad(image, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge")
        resample_out = None
        slice_out = (h, w)

    fn = make_program_fn(
        resample_out, layout.pad_canvas, layout.pad_offset,
        plan.device_plan(), band,
    )
    geo = torch.from_numpy(
        geometry_rows(plan, layout, (h, w), src_window)[None]
    ).to(dev)
    out = fn(
        torch.from_numpy(padded[None]).to(dev),
        geo[:, 0:2], geo[:, 2:4], geo[:, 4:6], geo[:, 6:8],
    )
    result = out[0].cpu().numpy()
    if slice_out is not None:
        result = np.ascontiguousarray(result[: slice_out[0], : slice_out[1]])
    return result
