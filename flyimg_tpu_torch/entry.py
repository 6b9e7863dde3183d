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

``train_entry()`` is one BlazeFace training step (kernels K9-K14): the
loss, its gradients and the Adam update of a freshly initialised model on
a seeded synthetic batch.

``staged_entry(opts)`` builds the batch of one of ``STAGED_OPTIONS`` — the
program stages after the resample (rotate, filters, pad, grayscale,
dither) — on seeded 1920x1080 sources, grouped and padded as the batcher
groups and pads them.

``tiled_entry(opts, n)`` is the handler's tall-input route: one of
``TILED_OPTIONS`` on a seeded 3840x2160 (H x W) u8 frame over an n-rank
mesh on one device (``parallel/tiling.py``: the halo-exchange resample,
the halo-exchange filter, the ring rotate); ``untiled_fn`` is the same op
on the whole frame. ``dryrun_multichip(n)`` runs the three tiled programs
on a virtual n-rank CPU mesh, as part 2 of ``__graft_entry__``'s does.
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

#: the train step's batch: the default of tools/train_blazeface.py
TRAIN_BATCH = 16

#: the tall-input route's ops (each runs one tiled program), on a
#: TILED_HW (H x W) frame: a 4K portrait, the thumbnail firehose's size class
TILED_OPTIONS = ("w_256", "blr_0x2", "unsh_0.25x0.25+8+0.065", "r_-37")
TILED_HW = (3840, 2160)
TILED_RANKS = 4


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


def train_entry(device: Union[str, torch.device] = "cuda", batch: int = TRAIN_BATCH,
                seed: int = 0):
    """(fn, args) of one BlazeFace training step on ``device``:
    ``fn(images, target_probs, target_boxes, anchor_mask)`` takes a
    ``value_and_grad`` + adam step of a model initialised from ``seed``
    (the model and its optimizer state live in ``fn``) and returns the loss
    before the step; ``args`` is ``synthetic_batch`` of ``batch`` images
    from ``seed``."""
    from flyimg_tpu_torch.models import blazeface_train

    dev = resolve_device(device)
    model = blazeface_train.init_params(seed, dev)
    _optimizer, step = blazeface_train.make_train_step(model)
    arrays = blazeface_train.synthetic_batch(np.random.default_rng(seed), batch)
    return step, blazeface_train.batch_to(arrays, dev)


def _tiled_plan(opts: str, hw: Tuple[int, int]):
    plan = build_plan(OptionsBag(opts), hw[1], hw[0])
    if plan.resize_to is not None:
        return plan, "resample", plan_layout(plan).resample_out
    for op in ("rotate", "blur", "sharpen", "unsharp"):
        if getattr(plan, op) is not None:
            return plan, op, None
    raise ValueError(f"{opts!r} is none of the tiled ops")


def tiled_fn(opts: str, mesh, hw: Tuple[int, int] = TILED_HW,
             out_u8: bool = False, kernel=None, plain: bool = False,
             background=None):
    """``fn(frame)`` running ``opts`` (a full-frame resample, or exactly
    one of rotate, blur, sharpen, unsharp) on an [H, W, 3] u8 frame through
    the tiled program over ``mesh``'s "sp" axis, as the handler calls it;
    ``kernel`` picks the resample's form (None: the process-wide mode),
    ``plain`` runs the kernels' plain versions, ``background`` overrides the
    plan's."""
    from flyimg_tpu_torch.parallel.tiling import tiled_filter, tiled_rotate, tiled_transform

    plan, op, out_hw = _tiled_plan(opts, hw)
    if op == "resample":
        return lambda x: tiled_transform(x, out_hw, mesh, method=plan.filter_method,
                                         kernel=kernel, out_u8=out_u8, plain=plain)
    if op == "rotate":
        bg = background or plan.background
        return lambda x: tiled_rotate(x, plan.rotate, mesh, background=bg,
                                      out_u8=out_u8, plain=plain)
    radius, sigma, gain, thr = (*plan.blur, 1.0, 0.0) if op == "blur" else getattr(plan, op)
    return lambda x: tiled_filter(x, mesh, op, radius, sigma, gain=gain, threshold=thr,
                                  out_u8=out_u8, plain=plain)


def untiled_fn(opts: str, hw: Tuple[int, int] = TILED_HW, out_u8: bool = False,
               kernel=None, background=None):
    """``fn(frame)``: the same op as ``tiled_fn`` on the whole frame on its
    device (K1 or the dense products, K5, K4), as one batch-1 program."""
    from flyimg_tpu_torch.ops import filters, rotate
    from flyimg_tpu_torch.ops.resample import (
        quantize_u8,
        resample_banded_f32,
        resample_banded_u8,
        resample_image,
    )

    plan, op, out_hw = _tiled_plan(opts, hw)
    h, w = hw
    if op == "resample":
        mode = kernel or kernel_mode()
        band = select_band_taps(mode, plan.filter_method, (h, w), (0.0, float(h)),
                                (0.0, float(w)), out_hw)

        def resample(x):
            def rows(v):
                return torch.tensor([v], dtype=torch.float32, device=x.device)

            geo = (rows([0.0, float(h)]), rows([0.0, float(w)]),
                   rows([float(v) for v in out_hw]), rows([float(h), float(w)]))
            if band is not None:
                fn = resample_banded_u8 if out_u8 else resample_banded_f32
                return fn(x[None], out_hw, *geo, band, plan.filter_method)[0]
            out = resample_image(x[None].to(torch.float32), out_hw, *geo,
                                 plan.filter_method)[0]
            return quantize_u8(out) if out_u8 else out.contiguous()

        return resample
    if op == "rotate":
        bg = background or plan.background
        return lambda x: rotate.rotate_image(x[None].to(torch.float32), plan.rotate,
                                             bg, out_u8)[0]
    if op == "blur":
        return lambda x: filters.gaussian_blur(x[None].to(torch.float32), *plan.blur,
                                               out_u8=out_u8)[0]
    radius, sigma, gain, thr = getattr(plan, op)
    if op == "sharpen":
        gain, thr = 1.0, 0.0
    return lambda x: filters.unsharp_mask(x[None].to(torch.float32), radius, sigma,
                                          gain, thr, out_u8)[0]


def tiled_frame(hw: Tuple[int, int] = TILED_HW, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """A seeded [H, W, 3] u8 frame on ``device``: smooth colour fields with
    noise, so filters and resamples see image-like gradients."""
    dev = resolve_device(device)
    h, w = hw
    gen = torch.Generator(device="cpu").manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32)[:, None, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :, None]
    phase = torch.rand(3, generator=gen) * 6.0
    img = 128.0 + 90.0 * torch.sin(yy / 211.0 + phase) * torch.cos(xx / 157.0 - phase)
    img = img + torch.randn((h, w, 3), generator=gen) * 12.0
    return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8).to(dev)


def tiled_entry(opts: str = TILED_OPTIONS[0], n: int = TILED_RANKS,
                device: Union[str, torch.device] = "cuda", seed: int = 0,
                out_u8: bool = True, kernel=None):
    """(fn, (frame,)) of the tall-input route for ``opts``: the seeded
    TILED_HW frame on ``device`` and the tiled program over a virtual
    n-rank mesh there (every rank on that one device)."""
    from flyimg_tpu_torch.parallel.mesh import virtual_mesh

    dev = resolve_device(device)
    mesh = virtual_mesh(n, dev)
    return tiled_fn(opts, mesh, TILED_HW, out_u8, kernel), (tiled_frame(TILED_HW, seed, dev),)


def dryrun_multichip(n_devices: int) -> None:
    """Part 2 of ``__graft_entry__.dryrun_multichip`` (spatial tiling) on a
    virtual ``n_devices``-rank CPU mesh: the halo-exchange resample and
    filter and the ring rotate, with the same shapes and asserts. Parts 1
    (DP x TP BlazeFace training) and 3 (data-parallel serving) are not
    ported yet."""
    from flyimg_tpu_torch.parallel.mesh import virtual_mesh
    from flyimg_tpu_torch.parallel.tiling import tiled_filter, tiled_rotate, tiled_transform
    from flyimg_tpu_torch.spec.plan import rotated_bounds

    sp_mesh = virtual_mesh(n_devices, "cpu")
    rng = np.random.default_rng(1)
    big = torch.from_numpy(rng.integers(0, 255, (32 * n_devices, 96, 3), dtype=np.uint8))
    out_h = 8 * n_devices
    tiled = tiled_transform(big, (out_h, 48), sp_mesh)
    assert tiled.shape == (out_h, 48, 3), tiled.shape
    blurred = tiled_filter(big.to(torch.float32), sp_mesh, "blur", 0.0, 1.5)
    assert blurred.shape == big.shape, blurred.shape
    rot = tiled_rotate(big, -45.0, sp_mesh)
    rw, rh = rotated_bounds(int(big.shape[1]), int(big.shape[0]), -45.0)
    assert rot.shape == (rh, rw, 3), (rot.shape, (rh, rw))
    for out in (tiled, blurred, rot):
        assert bool(torch.isfinite(out).all())
    print(f"dryrun_multichip ok: sp={n_devices} (virtual CPU mesh)")
