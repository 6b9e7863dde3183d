"""The flagship batched forward of the PyTorch package.

The counterpart of ``__graft_entry__.entry()``: ``entry()`` returns
``(fn, args)`` where ``fn(*args)`` runs one batch of the
"resize + smart-crop" workload on the card —

1. the crop-fill resample of 512x512x3 u8 sources to 300x250 u8
   (``w_300,h_250,c_1``), dense (two f32 matmuls) or banded (kernel K1)
   as the process-wide ``resample_kernel`` mode selects;
2. the smart-crop saliency field of every output (kernel K2);
3. the scoring correlation of each field with one 150x150 importance
   kernel at stride 8 (kernel K3), giving a [B, 13, 19] score grid.

``fn`` returns ``(out u8 [B, 250, 300, 3], scores f32 [B, 13, 19])``.

``face_entry()`` is the face post-passes' device work: the BlazeFace
forward (kernels K9, K10) over ``FACE_VIEWS`` seeded 128x128 views — the
largest chunk the runtime launches — and the facefind masks (kernel K8) of
``FACE_IMAGES`` seeded 480x640 images with skin-toned ellipses.

``staged_entry(opts)`` builds the batch of one of ``STAGED_OPTIONS`` — the
program stages after the resample (rotate, filters, pad, grayscale,
dither) — on seeded 1920x1080 sources, grouped and padded as the batcher
groups and pads them.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models.smartcrop import (
    _batched_scores,
    _batched_weighted,
    importance_kernel,
)
from flyimg_tpu_torch.ops.compose import (
    geometry_rows,
    make_program_fn,
    plan_layout,
    program_args,
)
from flyimg_tpu_torch.ops.resample import kernel_mode, select_band_taps
from flyimg_tpu_torch.runtime.batcher import transform_group
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan

BATCH = 256
SRC = 512
OUT_HW = (250, 300)
STRIDE = 8

#: one program per stage family after the resample, on STAGED_SRC sources
STAGED_OPTIONS = (
    "w_800,h_600,c_1,r_30",                            # dynamic rotate
    "w_600,r_90",                                      # dynamic quarter turn
    "w_1280,unsh_0.25x0.25+8+0.065",                   # fit path, bucketed out
    "w_300,h_250,ett_400x320,bg_%23333333,clsp_Gray",  # pad + grayscale
    "w_800,mnchr_1",                                   # dither
    "r_-15,bg_%23336699,blr_0x2",                      # static exact frame + blur
    "sh_2x1",                                          # pixel-op bucket
)
STAGED_SRC = (1920, 1080)
STAGED_BATCH = 32

FACE_VIEWS = 64
FACE_IMAGES = 16
FACE_HW = (480, 640)
#: an RGB skin tone: inside the facefind chromaticity ellipse and gates
SKIN_RGB = (205.0, 150.0, 118.0)


def flagship_band():
    """The band widths the current kernel mode selects for the flagship
    geometry (None = dense)."""
    plan = build_plan(OptionsBag("w_300,h_250,c_1"), SRC, SRC)
    layout = plan_layout(plan)
    return select_band_taps(
        kernel_mode(), plan.filter_method, (SRC, SRC),
        layout.span_y, layout.span_x, layout.out_true,
    )


def flagship_fn(device: Union[str, torch.device] = "cuda"):
    dev = resolve_device(device)
    plan = build_plan(OptionsBag("w_300,h_250,c_1"), SRC, SRC).device_plan()
    program = make_program_fn(
        OUT_HW, None, (0, 0), plan, band_taps=flagship_band()
    )
    kernel = torch.from_numpy(importance_kernel(150.0, 150.0)).to(dev)
    kernels = kernel[None, :, :, None, None].contiguous()

    def forward(images, in_true, span_y, span_x, out_true):
        out = program(images, in_true, span_y, span_x, out_true)
        b = out.shape[0]
        valid = torch.tensor(OUT_HW, dtype=torch.float32, device=out.device)
        weighted = _batched_weighted(out, valid.expand(b, 2).contiguous())
        grids, _totals = _batched_scores(weighted, kernels, STRIDE)
        return out, grids[..., 0]

    return forward


def entry(device: Union[str, torch.device] = "cuda", batch: int = BATCH):
    """(fn, example_args) for one flagship batch on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.integers(0, 255, (batch, SRC, SRC, 3), dtype=np.uint8)
    ).to(dev)

    def rows(values):
        return torch.tensor([values], dtype=torch.float32, device=dev).repeat(
            batch, 1
        )

    in_true = rows([float(SRC), float(SRC)])
    # crop-fill 512x512 -> 300x250: fill scale .5859 -> window 512x426.7
    span_y = rows([42.6, 426.7])
    span_x = rows([0.0, 512.0])
    out_true = rows([250.0, 300.0])
    return flagship_fn(dev), (images, in_true, span_y, span_x, out_true)


def staged_entry(opts: str, batch: int = STAGED_BATCH,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 src_wh: Tuple[int, int] = STAGED_SRC):
    """(fn, args, group, plan, final valid (h, w)) for one batch of
    ``batch`` seeded ``src_wh`` sources under ``opts``, in the batcher's
    group (bucket, pad fill, geometry rows, dynamic rotate) and the current
    resample-kernel mode. ``fn(*args)`` is the group's program; its output
    is sliced to the final valid size per member, as the batcher slices
    it."""
    dev = resolve_device(device)
    w, h = src_wh
    plan = build_plan(OptionsBag(opts), w, h)
    group, final_true, _ = transform_group(plan, (h, w))
    bh, bw = group.in_shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    images = torch.zeros((batch, bh, bw, 3), dtype=torch.uint8, device=dev)
    images[:, :h, :w] = torch.randint(0, 256, (batch, h, w, 3), generator=gen,
                                      device=dev, dtype=torch.uint8)
    if group.resample_out is None and (bh, bw) != (h, w):
        # the pixel-op bucket's edge-replicate fill
        images[:, h:, :w] = images[:, h - 1:h, :w]
        images[:, :, w:] = images[:, :, w - 1:w]
    rot = final_true if group.rotate_dynamic else None
    row = geometry_rows(plan, plan_layout(plan), (h, w), None, rot)
    geo = torch.from_numpy(row).to(dev)[None].repeat(batch, 1)
    fn = make_program_fn(group.resample_out, group.pad_canvas,
                         group.pad_offset, group.device_plan,
                         group.rotate_dynamic, group.band_taps)
    return fn, (images, *program_args(geo)), group, plan, final_true


def skin_ellipse_image(rng: np.random.Generator, h: int, w: int,
                       faces: int = 3) -> np.ndarray:
    """[h, w, 3] u8: a smooth bluish background (never skin: blue above
    red) with ``faces`` noisy skin-toned ellipses (upright, about 1.2:1) of
    6-14% of the short side in radius, apart from one another."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c, base in enumerate((50.0, 70.0, 110.0)):
        fy, fx = rng.uniform(0.5, 2.0, 2) * np.pi / np.array([h, w])
        img[..., c] = base + 15 * np.sin(fy * yy + fx * xx + rng.uniform(0, 6))
    side = min(h, w)
    for k in range(faces):
        r = rng.uniform(0.06, 0.14) * side
        cx = (k + 0.5) / faces * w + rng.uniform(-0.05, 0.05) * w
        cy = rng.uniform(0.3, 0.7) * h
        inside = ((yy - cy) / 1.2) ** 2 + (xx - cx) ** 2 < r * r
        img[inside] = np.asarray(SKIN_RGB, np.float32)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def face_entry(device: Union[str, torch.device] = "cuda",
               views: int = FACE_VIEWS, images: int = FACE_IMAGES,
               seed: int = 0):
    """(fn, args) of the face post-passes' device work on ``device``:
    ``fn(views, images, in_true, thresholds)`` runs the BlazeFace forward
    over ``views`` f32 [V, 128, 128, 3] (the packaged weights) and the
    facefind masks of ``images`` u8 [I, 480, 640, 3], returning
    ``(probs [V, 896], boxes [V, 896, 4], masks bool [I, 480, 640])``."""
    from flyimg_tpu_torch.models import blazeface, facefind

    dev = resolve_device(device)
    model = blazeface.load_weights(blazeface.PACKAGED_WEIGHTS, dev)
    rng = np.random.default_rng(seed)
    size = blazeface.INPUT_SIZE
    view_u8 = np.stack([skin_ellipse_image(rng, size, size, 1)
                        for _ in range(views)])
    view_batch = view_u8.astype(np.float32) / 127.5 - 1.0
    h, w = FACE_HW
    image_batch = np.stack([skin_ellipse_image(rng, h, w) for _ in range(images)])
    in_true = np.tile(np.array([[h, w]], np.float32), (images, 1))
    thresholds = np.full((images,), facefind.DEFAULT_THRESHOLD, np.float32)

    def fn(v, imgs, valid, thr):
        probs, boxes = blazeface._forward(model, v)
        masks = facefind._batched_face_masks(imgs, valid, thr)
        return probs, boxes, masks

    args = tuple(torch.from_numpy(a).to(dev) for a in
                 (view_batch, image_batch, in_true, thresholds))
    return fn, args
