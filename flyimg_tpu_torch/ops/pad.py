"""Extent padding: place a batch of images on a larger canvas per gravity.

The port of ``flyimg_tpu/ops/pad.py``. The crop direction of ``-extent``
is fused into the windowed resample (ops/resample.py); this op covers the
pad direction — target canvas larger than the image (the ``ett_WxH``
option, and rounding slack in crop-fill), filled with the background colour
(IM default white). On the card it runs inside kernel K6
(``ops/color.py pixel_pass``); ``extent_pad`` here is its plain PyTorch
version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

WHITE = (255, 255, 255)


def extent_pad(
    image: torch.Tensor,
    canvas_wh: Tuple[int, int],
    offset_xy: Tuple[int, int],
    background: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Place [B, H, W, C] at (offset_x, offset_y) on a (canvas_w, canvas_h)
    canvas. Offsets may be negative (image cropped by the canvas edge); all
    values static. Matches IM gravity/extent composition."""
    canvas_w, canvas_h = int(canvas_wh[0]), int(canvas_wh[1])
    off_x, off_y = int(offset_xy[0]), int(offset_xy[1])
    b, h, w, c = image.shape
    bg = torch.tensor(background or WHITE, dtype=image.dtype, device=image.device)
    canvas = bg.expand(b, canvas_h, canvas_w, c).clone()

    src_x0 = max(0, -off_x)
    src_y0 = max(0, -off_y)
    dst_x0 = max(0, off_x)
    dst_y0 = max(0, off_y)
    copy_w = min(w - src_x0, canvas_w - dst_x0)
    copy_h = min(h - src_y0, canvas_h - dst_y0)
    if copy_w > 0 and copy_h > 0:
        canvas[:, dst_y0:dst_y0 + copy_h, dst_x0:dst_x0 + copy_w] = image[
            :, src_y0:src_y0 + copy_h, src_x0:src_x0 + copy_w
        ]
    return canvas
