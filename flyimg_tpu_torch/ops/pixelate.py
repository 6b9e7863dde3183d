"""Region pixelation for face blur, and kernel K7.

The port of ``flyimg_tpu/ops/pixelate.py``: the reference's per-face
``-scale 10% -scale 1000%`` round trip is an average over aligned 10x10
blocks (partial blocks at the right and bottom edges edge-padded),
nearest-upsampled, selected inside any of the (padded, dynamic) face boxes.

On the card the whole of ``facefind.blur_faces``' device work — block mean,
select, round half to even, clip, u8 — is ONE launch of kernel K7
(``csrc/pixelate.cu``) through ``pixelate_regions_u8``. ``_block_pixelate``
and ``pixelate_regions`` are the plain PyTorch versions (f32 in, f32 out,
as in the JAX package); ``pixelate_regions_u8`` runs them for a CPU tensor
only.

The block mean is the block's sum times ``f32(1 / 100)``: the JAX package's
``mean`` is jitted, and XLA rewrites its division by the count into that
multiply (measured on every block sum 0..25500; the two forms differ on
7,166 of them). The sums are of whole numbers below 2^24, so exact in any
order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.ops.resample import quantize_u8

# the reference's -scale 10% ... 1000% round trip = factor-10 blocks
PIXELATE_FACTOR = 10
#: the most boxes K7 takes (it stages them in shared memory)
MAX_BOXES = 256


def _inv_count(factor: int) -> torch.Tensor:
    """f32(1 / factor^2) as a 0-dim tensor (a Python float would be kept
    in double by the multiply on some backends)."""
    return torch.tensor(np.float32(1.0 / (factor * factor)))


def _block_pixelate(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Average over factor x factor blocks of an f32 [h, w, c] image, then
    nearest-upsample back; partial blocks are edge-padded."""
    h, w, c = image.shape
    ph = (-h) % factor
    pw = (-w) % factor
    padded = F.pad(image.permute(2, 0, 1)[None], (0, pw, 0, ph),
                   mode="replicate")[0].permute(1, 2, 0)
    hb, wb = padded.shape[0] // factor, padded.shape[1] // factor
    sums = padded.reshape(hb, factor, wb, factor, c).sum(dim=(1, 3))
    blocks = sums * _inv_count(factor).to(image.device)
    up = blocks.repeat_interleave(factor, 0).repeat_interleave(factor, 1)
    return up[:h, :w]


def _inside_any(h: int, w: int, boxes: torch.Tensor) -> torch.Tensor:
    """[h, w] bool: the pixel lies in any (x, y, w, h) box, tested in f32."""
    boxes = boxes.to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, None, :]
    x, y = boxes[:, 0, None, None], boxes[:, 1, None, None]
    bw, bh = boxes[:, 2, None, None], boxes[:, 3, None, None]
    masks = (xs >= x) & (xs < x + bw) & (ys >= y) & (ys < y + bh)
    return masks.any(dim=0)


def pixelate_regions(image: torch.Tensor, boxes: torch.Tensor,
                     factor: int = PIXELATE_FACTOR) -> torch.Tensor:
    """Pixelate an f32 [h, w, c] image inside each box of ``boxes`` [N, 4]
    = (x, y, w, h); zero-area boxes are inert padding."""
    pixelated = _block_pixelate(image, factor)
    inside = _inside_any(image.shape[0], image.shape[1], boxes.to(image.device))
    return torch.where(inside[..., None], pixelated, image)


def pixelate_regions_u8(image: torch.Tensor, boxes: torch.Tensor,
                        factor: int = PIXELATE_FACTOR) -> torch.Tensor:
    """u8 [h, w, 3] -> u8 [h, w, 3]: ``pixelate_regions`` of the image as
    f32, rounded half to even and clipped. Kernel K7 on a CUDA tensor, the
    plain version on a CPU tensor. ``boxes`` is f32 [N, 4] on the image's
    device."""
    shape, bshape = image.shape, boxes.shape
    if image.dtype != torch.uint8 or len(shape) != 3 or shape[2] != 3:
        raise ValueError(
            f"pixelate_regions_u8 takes u8 [h, w, 3], got {image.dtype} "
            f"{tuple(shape)}"
        )
    if len(bshape) != 2 or bshape[1] != 4 or bshape[0] > MAX_BOXES:
        raise ValueError(
            f"boxes must be [N <= {MAX_BOXES}, 4], got {tuple(bshape)}"
        )
    if not 1 <= factor <= 32:
        raise ValueError(f"pixelate factor must be 1..32, got {factor}")
    dev = image.device
    if dev.type == "cpu":
        out = pixelate_regions(image.to(torch.float32), boxes, factor)
        return quantize_u8(out).contiguous()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if boxes.device != dev:
        raise ValueError(f"boxes on {boxes.device}, image on {dev}")
    if not image.is_contiguous():
        image = image.contiguous()
    if boxes.dtype != torch.float32 or not boxes.is_contiguous():
        boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty_like(image)
    rc = (_launch or _bind())(
        image.data_ptr(), boxes.data_ptr(), out.data_ptr(), shape[0], shape[1],
        bshape[0], factor, cuda_build.current_stream(dev.index),
    )
    cuda_build.check(rc, "pixelate")
    pixelate_regions_u8.launches += 1
    return out


#: K7 launches since the last reset (a plain integer)
pixelate_regions_u8.launches = 0

#: the bound ``flyimg_pixelate`` (set by the first launch)
_launch = None


def _bind():
    global _launch
    fn = cuda_build.load("pixelate").flyimg_pixelate
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    _launch = fn
    return fn
