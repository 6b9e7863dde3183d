#!/usr/bin/env python3
"""Smoke run of the PyTorch package (flyimg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without a result line:

1. device  — a CUDA card must be visible; prints nvidia-smi's name and
             power limit;
2. build   — compiles kernels K1-K14 from csrc/ with nvcc (one process per
             source, all at once) and prints the build time and ptxas report;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the flagship shape and at a serving shape, with the median times
             of the kernel, the plain version and (where one exists) the one
             PyTorch library call computing the same function; then, not
             timed, the shapes K1's, K2's and K3's tiling could get wrong: an
             output height no tile height divides, an upscale, a large
             downscale with a run-time K, sources wider and taller than one
             shared-memory chunk, mixed geometries in one batch (four
             filters); for K2, every colour of the RGB cube in one
             4096x4096 member, 1x1, one row, one column, w = 3, w = 301
             from an unaligned base, valid sizes of 0, 1 and 2, valid
             regions smaller than the bucket, batch 1, the 8192-wide bucket
             and a skin-toned image (and, timed, a skin-toned flagship
             batch); runs of outputs that do not divide nx, C = 2 and 6,
             stride 4, a window as large as the field, a shared kernel at
             the serving shape; then K1's f32-store form, K4 (rotate), K5
             (separable filter) and K6 (pad/gray/dither pass) at the shapes
             the staged programs give them (32 x 1920x1080 sources), timed,
             with F.grid_sample and a depthwise F.conv2d as yardsticks; and,
             not timed, K1-f32 on fit rows past out_true, K4 on 1x1 and 1 x w
             frames at 0/90/180/270/0.5/359.5/-15 degrees, valid regions
             smaller than the bucket, a coloured background and the
             8192-wide bucket, K5 with 61 taps, images narrower than the
             taps and unsharp thresholds 0 and > 0, K6 with negative
             offsets, a canvas smaller than the image and no overlap; then
             the face kernels at the face pass's shapes, timed, with
             F.avg_pool2d, F.max_pool2d x4 and F.conv2d yardsticks: K7
             (pixelate, exact) on a 480x640 output with its facefind boxes,
             K8 (facefind masks: probability within 1 ulp, mask exact off
             the knife-edge) on 16 x 480x640, K9/K10 (BlazeFace) at every
             layer of the 64-view forward (within 1e-5 relative; the head's
             probabilities within 1e-5 and boxes within 1e-4 absolute); not
             timed, K7 on sides that are not multiples of 10, 1x1, zero-area,
             overlapping, negative and past-the-edge boxes, none and 32; K8
             on 1-member and padded buckets, valid regions smaller than the
             bucket, 1x1 and thresholds 0 and 0.9; the forward at N = 1, 3
             and 64; then the training kernels at the train step's shapes
             (batch 16, full width, a fresh model), timed, with cuDNN's
             conv2d_weight/conv2d_input, a torch.matmul pair and
             torch.optim.Adam(fused=True) as yardsticks: K11 (K9's
             backward) and K12 (K10's and the heads' backward) within 1e-4
             of each output's max |value|, K13 (heads + loss + its gradient)
             within 1e-5, K14 (Adam) within 1e-6 over three steps; and, not
             timed, K11-K14 on odd sizes, one member, 1x1 inputs, pixel
             counts no tile divides, tied 2x2 windows (the residual's
             gradient equal to its plain version's), a head's strided,
             scaled and accumulated gradient, K13 at N = 1 and 3, K14 on a
             length no block divides;
4. entry   — the flagship batch (256 x 512x512x3 u8 -> 300x250, saliency,
             150x150 scoring) with resample_kernel dense and banded, held
             against the plain path on the card, then timed;
5. staged  — each program of flyimg_tpu_torch/entry.py STAGED_OPTIONS
             (rotate, filters, pad, grayscale, dither)
             on a batch of 32 1920x1080 sources built as the batcher builds
             it, banded; two members held against the same program on the
             CPU, then timed (images/s);
6. server  — the package's HTTP server on the card answers 16 concurrent
             /upload/w_300,h_250,c_1[,smc_1]/ requests for seeded synthetic
             PNGs, then 16 concurrent requests spread over the
             STAGED_OPTIONS strings, dense and banded; every answer is held against
             the same request through the handler on the CPU; a repeat is a
             cache hit;
7. faces   — flyimg_tpu_torch/entry.py face_entry (the BlazeFace forward
             over 64 views, the facefind masks of 16 480x640 images) held
             against the plain path and timed (views/s, images/s); then the
             server on the card answers 16 concurrent /upload/w_640,fb_1/
             requests with face_backend facefind, 16 /upload/w_640,fc_1,
             fcp_1/ with blazeface and 4 /upload/w_640,fb_1,fc_1/ with auto
             (which backend auto resolves to is printed), for seeded
             1280x960 PNGs with skin-toned ellipses; every answer is held
             against the CPU handler (1 u8 level, the same size);
8. train   — one BlazeFace train step through K9-K14 held against the
             plain (cuDNN autograd) step from the same weights and batch
             (loss within 1e-5 relative, every gradient leaf within 1e-4 of
             its max |value|); train_synthetic(150 steps, batch 16, seed 3)
             through the kernels, held to the JAX package's conditions
             (tests/test_blazeface.py: a seed-9 loss below half a fresh
             init's, the seed-77 blob found within 0.2 of its centre); the
             weights saved as .npz and reloaded to the same boxes; steps/s
             at batch 16 and 64, kernels and plain.

Launch counters are zeroed right before each main-path phase (4-8)
and read right after; every kernel of the phase's path must have launched.
The last lines are the card, one JSON object describing every kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

PIXEL_TOL = 1                   # u8 levels
DIFF_FRAC = 1e-4                # share of u8 values that may differ by 1
SCORE_RTOL = 1e-5               # max |a - b| / max |b|
F32_TOL = 1e-3                  # f32 stage outputs: K1-f32; K4 off the fill edge
K5_TOL = 1e-4                   # K5's f32 outputs (blur sums in another order)
K5_KNIFE = 1e-3                 # |(|x - blur|) - thr * 255| of an unsharp knife-edge
K6_KNIFE = 1e-4                 # |luma - threshold| of a dither knife-edge
FLIP_FRAC = 1e-5                # share of values a dither threshold may flip
K8_ULP = 1                      # K8's skin probability, ulps
K8_KNIFE = 1e-6                 # |probability - threshold| of a K8 knife-edge
K8_RADIUS = 8                   # pixels four 5x5 passes spread a flipped pixel
BF_RTOL = 1e-5                  # K9/K10 layer outputs, max |a - b| / max |b|
BF_PROB_TOL = 1e-5              # BlazeFace probabilities, absolute
BF_BOX_TOL = 1e-4               # BlazeFace decoded boxes, absolute
TRAIN_RTOL = 1e-4               # K11/K12 outputs and the step's gradient leaves,
                                # max |a - b| / max |b| (long sums in other orders)
LOSS_RTOL = 1e-5                # the training loss, relative
HEAD_GRAD_RTOL = 1e-5           # K13's dlogits and draw, max |a - b| / max |b|
ADAM_RTOL = 1e-6                # K14's parameters and moments, max |a - b| / max |b|
TRAIN_BATCH = 16

#: sources and batch of the staged programs (flyimg_tpu_torch/entry.py
#: STAGED_OPTIONS)
SRC_W, SRC_H = 1920, 1080
STAGED_BATCH = 32


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=10, warmup=2) -> float:
    """Median milliseconds of ``fn()`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(torch, a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_pixels(label, diff_max, n_diff, n_total):
    """Hold u8 outputs to PIXEL_TOL levels and to a DIFF_FRAC share of
    values that differ at all (a rounding fault shifts far more)."""
    frac = n_diff / max(n_total, 1)
    check(diff_max <= PIXEL_TOL,
          f"{label}: max diff {diff_max} > {PIXEL_TOL} u8")
    check(frac <= DIFF_FRAC,
          f"{label}: {n_diff} of {n_total} values differ ({frac:.2e} > "
          f"{DIFF_FRAC:.0e})")
    return frac


def reached(torch, idx, w, in_size):
    """Per member, how many source indices of one axis carry a nonzero band
    weight: idx, w [B, out, K] from _band_axis."""
    b = idx.shape[0]
    flat = torch.where(w.reshape(b, -1) != 0, idx.reshape(b, -1), in_size)
    mask = torch.zeros((b, in_size + 1), dtype=torch.bool, device=idx.device)
    mask.scatter_(1, flat, True)
    return mask[:, :in_size].sum(dim=1).to(torch.float64)


# ---------------------------------------------------------------------------


def reset_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def flagship_geometry(torch, batch, dev):
    from flyimg_tpu_torch.entry import entry

    _fn, args = entry(device=dev, batch=batch)
    return args


def serving_geometry(torch, w, h, batch, dev, rng):
    """A bucketed w_300,h_250,c_1 batch of w x h sources."""
    import numpy as np

    from flyimg_tpu_torch.ops.compose import _bucket_dim, plan_layout
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    plan = build_plan(OptionsBag("w_300,h_250,c_1"), w, h)
    lay = plan_layout(plan)
    bh, bw = _bucket_dim(h), _bucket_dim(w)
    img = np.zeros((batch, bh, bw, 3), np.uint8)
    img[:, :h, :w] = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)

    def rows(v):
        return torch.tensor([v], dtype=torch.float32, device=dev).repeat(batch, 1)

    return plan, lay, (
        torch.from_numpy(img).to(dev), rows([h, w]), rows(list(lay.span_y)),
        rows(list(lay.span_x)), rows(list(lay.out_true)),
    )


def k1_case(torch, label, args, out_hw, band, method, timed=True, f32=False):
    """K1 against its plain version: the u8 store within PIXEL_TOL levels on
    at most a DIFF_FRAC share, or (``f32``) the f32-store form within
    F32_TOL of ``resample_image_banded`` on every row and column, those
    past out_true included."""
    from flyimg_tpu_torch.ops.resample import (
        _band_axis,
        k1_plan,
        quantize_u8,
        resample_banded_f32,
        resample_banded_u8,
        resample_image_banded,
    )

    images, in_true, span_y, span_x, out_true = args
    b, in_h, in_w, _ = images.shape
    in_true = in_true[:, :2]
    name = "K1-f32" if f32 else "K1"

    def kern():
        fn = resample_banded_f32 if f32 else resample_banded_u8
        return fn(images, out_hw, span_y, span_x, out_true, in_true, band,
                  method)

    def plain():
        out = resample_image_banded(
            images.float(), out_hw, span_y, span_x, out_true, in_true, band,
            method,
        )
        return out if f32 else quantize_u8(out)

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if f32:
        err = float((got - ref).abs().max())
        check(err <= F32_TOL, f"{name} {label}: max diff {err} > {F32_TOL}")
        n_diff, frac = int((got != ref).sum()), 0.0
    else:
        diff = (got.int() - ref.int()).abs()
        err = int(diff.max())
        n_diff = int((diff > 0).sum())
        frac = check_pixels(f"K1 {label}", err, n_diff, got.numel())
    # what the function must move: per member, the source rows times the
    # source columns that carry a nonzero band weight, the geometry and the
    # output; work: the nonzero-weight multiply-adds of the cheaper pass
    # order (rows over the reached columns, then columns; or the reverse)
    iy, wy = _band_axis(in_h, out_hw[0], band[0], span_y[:, 0], span_y[:, 1],
                        out_true[:, 0], in_true[:, 0], method)
    ix, wx = _band_axis(in_w, out_hw[1], band[1], span_x[:, 0], span_x[:, 1],
                        out_true[:, 1], in_true[:, 1], method)
    rows_b, cols_b = reached(torch, iy, wy, in_h), reached(torch, ix, wx, in_w)
    nnz_y = (wy != 0).sum(dim=(1, 2)).to(torch.float64)
    nnz_x = (wx != 0).sum(dim=(1, 2)).to(torch.float64)
    flops = 2.0 * 3 * float(torch.minimum(
        nnz_y * cols_b + nnz_x * out_hw[0], nnz_x * rows_b + nnz_y * out_hw[1]
    ).sum())
    nbytes = (3.0 * float((rows_b * cols_b).sum()) + b * 8 * 4
              + got.numel() * got.element_size())
    row = {
        "ms": cuda_ms(torch, kern) if timed else None,
        "plain_ms": cuda_ms(torch, plain, iters=3) if timed else None,
        "library_ms": None, "max_abs_err": float(err),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    plan = k1_plan((in_h, in_w), tuple(out_hw), tuple(band), b)
    times = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
             if timed else "")
    limits = (f"(bound {F32_TOL}), {n_diff} of {got.numel()} values not equal"
              if f32 else f"u8 (bound {PIXEL_TOL}), {n_diff} of {got.numel()} "
              f"values differ ({frac:.2e}, bound {DIFF_FRAC:.0e})")
    print(f"{name} {label}: in {tuple(images.shape)} -> {tuple(out_hw)} K={band} "
          f"max diff {err} {limits}; source reached "
          f"{float((rows_b * cols_b).sum()) / (b * in_h * in_w):.4f} of the "
          f"bucket; {times}bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); {plan}")
    return row


def k2_case(torch, label, images, in_true, timed=True):
    from flyimg_tpu_torch.models.smartcrop import (
        _batched_weighted,
        batched_weighted_plain,
        k2_plan,
    )

    got = _batched_weighted(images, in_true)
    ref = batched_weighted_plain(images, in_true)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"K2 {label}: shape {tuple(got.shape)}")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    check(err == 0.0, f"K2 {label}: max diff {err} != 0")
    b, h, w, _ = images.shape
    row = {
        "ms": cuda_ms(torch, lambda: _batched_weighted(images, in_true))
        if timed else None,
        "plain_ms": cuda_ms(
            torch, lambda: batched_weighted_plain(images, in_true), iters=3
        ) if timed else None,
        "library_ms": None, "max_abs_err": err,
    }
    # ~80 f32 operations a valid pixel (5 lumas, Laplacian, skin with two
    # square roots and three divides, saturation, merge); bytes: the valid
    # region of the input (nothing outside it is read), the geometry and
    # the whole f32 field
    n_valid = float((in_true[:, 0] * in_true[:, 1]).sum())
    row["bound_ms"], row["bound_by"] = bound_ms(
        3 * n_valid + b * 8 + b * h * w * 4, 80.0 * n_valid
    )
    times = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
             if timed else "")
    print(f"K2 {label}: {tuple(images.shape)} valid "
          f"{in_true[0].tolist()} max diff {err} (bound 0); {times}bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {k2_plan(b, h, w)}")
    return row


def k2_edges(torch, dev, rng):
    """K2 at the shapes its tiling or its shortcuts could get wrong, each
    exact against its plain version (correctness only, not timed): every
    colour of the RGB cube, then the edge shapes."""
    import numpy as np

    from flyimg_tpu_torch.k2_breakdown import skin_toned_batch

    # the whole RGB cube as one 4096x4096 member: a column walks green in
    # 16-wide snakes of low blue, a row red in 16-high snakes of high blue,
    # so horizontal neighbours differ by one step of one channel and
    # vertical ones by one step of red or 16 of blue
    i = torch.arange(4096, device=dev)
    snake = torch.where((i // 16) % 2 == 0, i % 16, 15 - i % 16)
    r, bh = (i // 16)[:, None], snake[:, None]
    g, bl = (i // 16)[None, :], snake[None, :]
    b = 16 * bh + bl
    code = (r << 16) | (g << 8) | b
    check(int(torch.unique(code).numel()) == 1 << 24, "K2 cube: colours repeat")
    cube = torch.stack(torch.broadcast_tensors(r, g, b), -1).to(torch.uint8)[None]
    k2_case(torch, "RGB cube", cube.contiguous(),
            torch.tensor([[4096.0, 4096.0]], device=dev), timed=False)

    def case(label, shape, valid, base_offset=0):
        n, h, w = shape
        host = rng.integers(0, 256, (n + base_offset, h, w, 3), dtype=np.uint8)
        img = torch.from_numpy(host).to(dev)[base_offset:]
        k2_case(torch, label, img, torch.tensor(valid, dtype=torch.float32,
                                                device=dev), timed=False)

    case("1x1", (1, 1, 1), [[1, 1]])
    case("1 x w", (2, 1, 37), [[1, 37], [1, 20]])
    case("h x 1", (2, 45, 1), [[45, 1], [30, 1]])
    case("w = 3, valid 2, 1 and 0", (4, 33, 3), [[33, 3], [17, 2], [1, 1], [0, 0]])
    # w a multiple of no 4 and odd valid sizes, from a tensor whose data
    # starts at 14 mod 16 (one member of 50 x 301 x 3 bytes in)
    case("w = 301, odd valid, unaligned base", (2, 50, 301),
         [[50, 301], [49, 297]], base_offset=1)
    case("valid h or w of 1 and 2", (4, 64, 96),
         [[1, 96], [2, 95], [64, 1], [64, 2]])
    case("valid smaller than the bucket", (3, 128, 160),
         [[111, 133], [97, 141], [5, 7]])
    case("batch 1", (1, 128, 160), [[128, 160]])
    # the work image of an 8000x100 panorama (no prescale below 100 px):
    # the widest bucket here, 16 column chunks
    case("wide 8192 bucket", (2, 128, 8192), [[100, 8000], [128, 8192]])
    k2_case(torch, "skin-toned", skin_toned_batch(3, 250, 300, dev, 5),
            torch.tensor([[250.0, 300.0]] * 3, device=dev), timed=False)


def k3_case(torch, label, field, kernels, stride, timed=True):
    import torch.nn.functional as F

    from flyimg_tpu_torch.models.smartcrop import (
        _batched_scores,
        batched_scores_plain,
        k3_plan,
    )

    b, fh, fw = field.shape
    _, khm, kwm, _, c = kernels.shape
    got_g, got_t = _batched_scores(field, kernels, stride)
    ref_g, ref_t = batched_scores_plain(field, kernels, stride)
    torch.cuda.synchronize()
    rel = max(rel_err(torch, got_g, ref_g), rel_err(torch, got_t, ref_t))
    err = float(max((got_g - ref_g).abs().max(), (got_t - ref_t).abs().max()))
    check(rel <= SCORE_RTOL, f"K3 {label}: relative diff {rel} > {SCORE_RTOL}")

    ny, nx = got_g.shape[1:3]
    plan = k3_plan(b, ny, nx, khm, kwm, c, stride)
    # the nonzero kernel taps of every (member, channel) at every window
    # position, plus the field totals
    taps = float((kernels != 0).sum()) * (b // kernels.shape[0])
    flops = 2.0 * ny * nx * taps + b * fh * fw
    nbytes = 4.0 * (field.numel() + kernels.numel() + got_g.numel() + b)
    row = {"ms": None, "plain_ms": None, "library_ms": None,
           "max_abs_err": err, "plan": plan}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    times = ""
    if timed:
        # the yardstick: one grouped convolution (full f32, TF32 off)
        weight = (
            kernels[:, :, :, 0, :].expand(b, khm, kwm, c)
            .permute(0, 3, 1, 2).reshape(b * c, 1, khm, kwm).contiguous()
        )
        inp = field[None]

        def library():
            return F.conv2d(inp, weight, stride=stride, groups=b)

        lib = library().reshape(b, c, ny, nx).permute(0, 2, 3, 1)
        lib_rel = rel_err(torch, lib, ref_g)
        row["ms"] = cuda_ms(torch, lambda: _batched_scores(field, kernels, stride))
        row["plain_ms"] = cuda_ms(
            torch, lambda: batched_scores_plain(field, kernels, stride), iters=3
        )
        row["library_ms"] = cuda_ms(torch, library)
        times = (f"conv2d relative diff {lib_rel:.3e}; kernel {row['ms']:.4f} "
                 f"ms, plain {row['plain_ms']:.4f} ms, conv2d "
                 f"{row['library_ms']:.4f} ms, ")
    print(f"K3 {label}: field {tuple(field.shape)} kernels "
          f"{tuple(kernels.shape)} stride {stride} -> grid {ny}x{nx}x{c}; "
          f"relative diff {rel:.3e} (bound {SCORE_RTOL}); {times}bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {plan}")
    return row


def phase_kernels(torch, dev):
    import numpy as np

    from flyimg_tpu_torch.entry import OUT_HW, flagship_band, flagship_fn
    from flyimg_tpu_torch.k2_breakdown import skin_toned_batch
    from flyimg_tpu_torch.models.smartcrop import (
        _batched_weighted,
        importance_kernel,
    )
    from flyimg_tpu_torch.ops.resample import select_band_taps, set_kernel_mode

    rng = np.random.default_rng(7)
    rows = {}
    # K1 — flagship: 256 x 512x512 -> 300x250, K=16
    set_kernel_mode("banded")
    args = flagship_geometry(torch, 256, dev)
    band = flagship_band()
    rows["K1"] = k1_case(torch, "flagship", args, OUT_HW, band, "lanczos3")
    # K1 — serving: 16 x 1920x1080 sources in the 1152x1920 bucket
    plan, lay, sargs = serving_geometry(torch, 1920, 1080, 16, dev, rng)
    sband = select_band_taps("banded", plan.filter_method,
                             tuple(sargs[0].shape[1:3]), lay.span_y,
                             lay.span_x, lay.out_true)
    k1_case(torch, "serving 1920x1080", sargs, lay.resample_out, sband,
            plan.filter_method)

    # K2 — flagship: the 256 resampled outputs, valid = whole 250x300
    out, _ = flagship_fn(dev)(*args)
    full = torch.tensor(OUT_HW, dtype=torch.float32, device=dev).repeat(256, 1)
    rows["K2"] = k2_case(torch, "flagship", out, full)
    # K2 — serving bucket [16, 128, 160] with in_true < bucket
    simg = torch.from_numpy(
        rng.integers(0, 256, (16, 128, 160, 3), dtype=np.uint8)
    ).to(dev)
    sval = torch.tensor(
        [[111 - i % 5, 133 + i % 7] for i in range(16)], dtype=torch.float32,
        device=dev,
    )
    k2_case(torch, "serving", simg, sval)
    # K2 — a skin-toned coherent batch at the flagship shape, where the
    # exact skin path runs for nearly every pixel
    k2_case(torch, "flagship, skin-toned", skin_toned_batch(256, 250, 300, dev, 3),
            full)

    # K3 — flagship: one 150x150 importance kernel, stride 8
    field = _batched_weighted(out, full)
    ker = torch.from_numpy(importance_kernel(150.0, 150.0)).to(dev)
    rows["K3"] = k3_case(torch, "flagship", field,
                         ker[None, :, :, None, None].contiguous(), 8)
    # K3 — serving: per-member stacks of 2 scales x (importance, box), C = 4
    sfield = _batched_weighted(simg, sval)
    stack = np.zeros((16, 112, 112, 1, 4), np.float32)
    for i in range(16):
        for si, s in enumerate((1.0, 0.9)):
            k = importance_kernel(111.0 * s, 111.0 * s)
            stack[i, :k.shape[0], :k.shape[1], 0, si] = k
            stack[i, :k.shape[0], :k.shape[1], 0, 2 + si] = 1.0
    k3_case(torch, "serving", sfield, torch.from_numpy(stack).to(dev), 8)
    k3_case(torch, "serving, shared kernel", sfield,
            torch.from_numpy(stack[:1]).contiguous().to(dev), 8)

    k1_edges(torch, dev, rng)
    k2_edges(torch, dev, rng)
    k3_edges(torch, dev, rng)
    return rows


def k1_edges(torch, dev, rng):
    """K1 at the shapes its tiling could get wrong, each against its plain
    version under the same limits (correctness only, not timed)."""
    import numpy as np

    from flyimg_tpu_torch.ops.resample import k1_plan

    def batch(n, h, w, geoms):
        img = torch.from_numpy(
            rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)).to(dev)
        cols = [torch.tensor([g[i] for g in geoms], dtype=torch.float32,
                             device=dev) for i in range(4)]
        in_true, span_y, span_x, out_true = cols
        return img, in_true, span_y, span_x, out_true

    def whole(n, h, w, oh, ow):
        return [((h, w), (0.0, h), (0.0, w), (oh, ow))] * n

    # an output height that is a multiple of no tile height
    args = batch(8, 512, 512, whole(8, 512, 512, 251, 301))
    plan = k1_plan((512, 512), (251, 301), (16, 16), 8)
    check(251 % plan.tile_h, f"K1 ragged tile: 251 is a multiple of {plan.tile_h}")
    k1_case(torch, "ragged tile", args, (251, 301), (16, 16), "lanczos3",
            timed=False)
    # upscale: 16 x 128x128 -> 250x300
    args = batch(16, 128, 128, whole(16, 128, 128, 250, 300))
    k1_case(torch, "upscale", args, (250, 300), (8, 8), "lanczos3", timed=False)
    # large downscale with a run-time K: 4 x 4096x4096 -> 250x300, K = 128
    args = batch(4, 4096, 4096, whole(4, 4096, 4096, 250, 300))
    check(k1_plan((4096, 4096), (250, 300), (128, 128), 4).kx_static == 0,
          "K1 large downscale: expected the run-time-K instance")
    k1_case(torch, "downscale 4096, run-time K", args, (250, 300),
            (128, 128), "lanczos3", timed=False)
    # a source wider than one shared-memory chunk: 2 x 256x20480, Kx = 512
    args = batch(2, 256, 20480, whole(2, 256, 20480, 250, 300))
    k1_case(torch, "wide 20480", args, (250, 300), (16, 512), "lanczos3",
            timed=False)
    # a source taller than one chunk of staged row weights: 2 x 20480x256,
    # Ky = 512, so the dense vertical weights are built in row chunks
    args = batch(2, 20480, 256, whole(2, 20480, 256, 250, 300))
    k1_case(torch, "tall 20480", args, (250, 300), (512, 8), "lanczos3",
            timed=False)
    # members of different geometry in one 1152x1920 bucket
    geoms = []
    for w, h in ((1920, 1080), (1303, 977), (800, 600), (1024, 1024),
                 (640, 1152), (1900, 300), (128, 96), (1080, 1080)):
        scale = max(300 / w, 250 / h)
        sw, sh = 300 / scale, 250 / scale
        geoms.append(((h, w), ((h - sh) / 2, sh), ((w - sw) / 2, sw),
                      (250, 300)))
    args = batch(8, 1152, 1920, geoms)
    k1_case(torch, "mixed geometry", args, (250, 300), (32, 32), "lanczos3",
            timed=False)
    for method in ("triangle", "cubic", "nearest"):
        k1_case(torch, f"mixed geometry, {method}", args, (250, 300),
                (32, 32), method, timed=False)


def k3_edges(torch, dev, rng):
    """K3 at the shapes its tiling could get wrong (correctness only)."""
    import numpy as np

    from flyimg_tpu_torch.models.smartcrop import k3_plan

    # nx (23) a multiple of no run length the plan takes
    field = torch.from_numpy(
        rng.uniform(0, 0.3, (8, 96, 224)).astype(np.float32)).to(dev)
    ker = torch.from_numpy(
        rng.normal(0, 1, (8, 40, 48, 1, 2)).astype(np.float32)).to(dev)
    plan = k3_plan(8, 8, 23, 40, 48, 2, 8)
    check(23 % plan.run, f"K3 ragged run: 23 is a multiple of {plan.run}")
    k3_case(torch, "ragged run, C=2", field, ker, 8, timed=False)
    # per-member stacks with C = 6 (three scales), serving-sized
    sfield = torch.from_numpy(
        rng.uniform(0, 0.3, (16, 128, 160)).astype(np.float32)).to(dev)
    stack = torch.from_numpy(
        rng.normal(0, 1, (16, 112, 112, 1, 6)).astype(np.float32)).to(dev)
    k3_case(torch, "C=6", sfield, stack, 8, timed=False)
    # another stride, and a window as wide as the field
    k3_case(torch, "stride 4", field, ker, 4, timed=False)
    k3_case(torch, "window = field", field[:, :40, :48].contiguous(), ker, 8,
            timed=False)


def phase_entry(torch, dev, card):
    from flyimg_tpu_torch.entry import entry, flagship_band
    from flyimg_tpu_torch.models.smartcrop import (
        batched_scores_plain,
        batched_weighted_plain,
        importance_kernel,
    )
    from flyimg_tpu_torch.ops.resample import (
        quantize_u8,
        resample_image,
        resample_image_banded,
        set_kernel_mode,
    )

    rates = {}
    for mode in ("dense", "banded"):
        set_kernel_mode(mode)
        band = flagship_band()
        fn, args = entry(device=dev, batch=256)
        out, scores = fn(*args)
        images, in_true, span_y, span_x, out_true = args
        # the plain path on the card
        if band is None:
            ref_out = quantize_u8(resample_image(
                images.float(), (250, 300), span_y, span_x, out_true, in_true))
        else:
            ref_out = quantize_u8(resample_image_banded(
                images.float(), (250, 300), span_y, span_x, out_true, in_true,
                band))
        valid = torch.tensor([250.0, 300.0], device=dev).repeat(256, 1)
        field = batched_weighted_plain(out, valid)
        ker = torch.from_numpy(importance_kernel(150.0, 150.0)).to(dev)
        ref_scores, _ = batched_scores_plain(field, ker[None, :, :, None, None], 8)
        torch.cuda.synchronize()
        diff = (out.int() - ref_out.int()).abs()
        pix, n_diff = int(diff.max()), int((diff > 0).sum())
        rel = rel_err(torch, scores, ref_scores[..., 0])
        check(out.shape == (256, 250, 300, 3), f"entry {mode}: out {out.shape}")
        check(scores.shape == (256, 13, 19), f"entry {mode}: scores {scores.shape}")
        check(bool(torch.isfinite(scores).all()), f"entry {mode}: non-finite scores")
        frac = check_pixels(f"entry {mode}", pix, n_diff, out.numel())
        check(rel <= SCORE_RTOL, f"entry {mode}: scores differ by {rel} relative")
        iters = 20
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[mode] = 256 * iters / dt
        if band is None:
            # the dense resample (plain torch, no hand kernel): the two f32
            # matmuls as the port runs them (rows, then columns of the
            # row-resampled image), and its bytes: the u8 source, both
            # weight matrices, the u8 output
            b, in_h, in_w, c = images.shape
            oh, ow = out.shape[1:3]
            flops = 2.0 * b * (oh * in_h * in_w * c + ow * in_w * oh * c)
            nbytes = float(images.numel() + 4 * b * (oh * in_h + ow * in_w)
                           + out.numel())
            dense_bound, dense_by = bound_ms(nbytes, flops)
            print(f"entry dense resample: bound {dense_bound:.4f} ms "
                  f"({dense_by}; {flops / 1e9:.1f} GFLOP f32, "
                  f"{nbytes / 1e6:.1f} MB)")
        print(f"entry {mode} (band {band}): pixels within {pix} u8 "
              f"({n_diff} of {out.numel()} differ, {frac:.2e}) and scores "
              f"within {rel:.3e} relative of the plain path; steady state "
              f"{rates[mode]:.1f} images/s ({dt / iters * 1e3:.3f} ms a "
              f"256-image batch) on {card}")
    return rates


def staged_case(torch, dev, opts, n=None, seed=0):
    """One staged program's batch as the batcher builds it for n seeded
    SRC_W x SRC_H sources: (plan, group, final valid (h, w), images on the
    card, program args on the card, program)."""
    from flyimg_tpu_torch.entry import staged_entry

    fn, (img, *args), group, plan, final_true = staged_entry(
        opts, n or STAGED_BATCH, dev, seed, (SRC_W, SRC_H))
    return plan, group, final_true, img, tuple(args), fn


def staged_kernels(group):
    """The kernels a staged group's program launches."""
    from flyimg_tpu_torch.ops.compose import post_stages

    plan = group.device_plan
    stages = post_stages(plan, group.pad_canvas)
    names = []
    if group.resample_out is not None and group.band_taps is not None:
        names.append("K1-f32" if stages else "K1")
    if "pixel" in stages:
        names.append("K6")
    if plan.rotate is not None and (
        group.rotate_dynamic or plan.rotate % 360.0 not in (0.0, 90.0, 180.0, 270.0)
    ):
        names.append("K4")
    if {"unsharp", "sharpen", "blur"} & set(stages):
        names.append("K5")
    return names


def inside_margin(torch, geom, degrees, out_h, out_w):
    """[B, out_h, out_w] f64: how far each output pixel's source position
    lies inside (+) or outside (-) rotate's valid region, in pixels — the
    distance to the `inside` test's knife-edge."""
    from flyimg_tpu_torch.ops.rotate import rotation_terms

    g = geom.double()
    cos_t, sin_t = rotation_terms(degrees)
    yo = torch.arange(out_h, dtype=torch.float64, device=geom.device)[None, :, None]
    xo = torch.arange(out_w, dtype=torch.float64, device=geom.device)[None, None, :]
    th, tw = g[:, 0, None, None], g[:, 1, None, None]
    dx = xo - (g[:, 3, None, None] - 1) / 2
    dy = yo - (g[:, 2, None, None] - 1) / 2
    xs = cos_t * dx + sin_t * dy + (tw - 1) / 2
    ys = -sin_t * dx + cos_t * dy + (th - 1) / 2
    return torch.minimum(torch.minimum(xs + 0.5, tw - 0.5 - xs),
                         torch.minimum(ys + 0.5, th - 0.5 - ys))


def k4_case(torch, label, x, degrees, background, geom, timed=True):
    """K4 against rotate_plain: within F32_TOL wherever the source position
    lies more than F32_TOL from the fill edge."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.ops.rotate import rotate_plain, rotate_sampled

    got = rotate_sampled(x, degrees, background, geom)
    ref = rotate_plain(x, degrees, background, geom)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"K4 {label}: shape {tuple(got.shape)}")
    b, oh, ow, _ = got.shape
    edge = inside_margin(torch, geom, degrees, oh, ow).abs() < F32_TOL
    diff = (got - ref).abs()
    err = float(diff.masked_fill(edge[..., None], 0.0).max())
    n_edge = int(((diff > F32_TOL) & edge[..., None]).sum())
    check(err <= F32_TOL, f"K4 {label}: max diff {err} > {F32_TOL} off the fill edge")
    row = {"ms": None, "plain_ms": None, "library_ms": None, "max_abs_err": err}
    # bytes: the valid input region once, the geometry, the output; ~40
    # flops a pixel (map, four clamped taps, three channel blends)
    n_valid = float((geom[:, 0] * geom[:, 1]).sum())
    row["bound_ms"], row["bound_by"] = bound_ms(
        12 * n_valid + 16 * b + got.numel() * got.element_size(),
        40.0 * b * oh * ow)
    times = ""
    if timed:
        # the yardstick: F.grid_sample, bilinear, align_corners, border
        # padding — the same gather, but no background outside and the
        # whole frame as the clamp region
        _, h, w, _ = x.shape
        from flyimg_tpu_torch.ops.rotate import rotation_terms

        cos_t, sin_t = rotation_terms(degrees)
        yo = torch.arange(oh, dtype=torch.float32, device=x.device)[None, :, None]
        xo = torch.arange(ow, dtype=torch.float32, device=x.device)[None, None, :]
        g = geom[:, :, None, None]
        dx, dy = xo - (g[:, 3] - 1) / 2, yo - (g[:, 2] - 1) / 2
        xs = cos_t * dx + sin_t * dy + (g[:, 1] - 1) / 2
        ys = -sin_t * dx + cos_t * dy + (g[:, 0] - 1) / 2
        grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], -1)
        nchw = x.permute(0, 3, 1, 2).contiguous()

        def library():
            return F.grid_sample(nchw, grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)

        row["ms"] = cuda_ms(torch, lambda: rotate_sampled(x, degrees, background, geom))
        row["plain_ms"] = cuda_ms(
            torch, lambda: rotate_plain(x, degrees, background, geom), iters=3)
        row["library_ms"] = cuda_ms(torch, library)
        times = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                 f"grid_sample {row['library_ms']:.4f} ms (no fill), ")
    print(f"K4 {label}: {tuple(x.shape)} -> {tuple(got.shape)} at {degrees} deg, "
          f"max diff {err} off the fill edge (bound {F32_TOL}), {n_edge} values "
          f"differ on it; {times}bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def k5_case(torch, label, x, kernel, mode, gain, threshold, out_u8, timed=True):
    """K5 against its plain version on the card: f32 within K5_TOL, u8
    within PIXEL_TOL; values differ more only where the unsharp threshold
    lies within K5_KNIFE of |x - blur| (counted)."""
    import numpy as np
    import torch.nn.functional as F

    from flyimg_tpu_torch.ops.filters import (
        MODE_UNSHARP,
        separable_conv_plain,
        separable_filter,
        unsharp_from_blurred,
    )
    from flyimg_tpu_torch.ops.resample import quantize_u8

    def plain():
        out = separable_conv_plain(x, kernel)
        if mode == MODE_UNSHARP:
            out = unsharp_from_blurred(x, out, gain, threshold)
        return quantize_u8(out) if out_u8 else out

    got = separable_filter(x, kernel, mode, gain, threshold, out_u8)
    ref = plain()
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    knife = torch.zeros_like(diff, dtype=torch.bool)
    if mode == MODE_UNSHARP:
        blurred = separable_conv_plain(x, kernel)
        knife = ((x - blurred).abs() - float(np.float32(threshold * 255.0))).abs() < K5_KNIFE
    tol = PIXEL_TOL if out_u8 else K5_TOL
    err = float(diff.masked_fill(knife, 0.0).max())
    n_knife = int((knife & (diff > tol)).sum())
    check(err <= tol, f"K5 {label}: max diff {err} > {tol} off the threshold")
    if out_u8:
        check_pixels(f"K5 {label}", 0, int(((diff > 0) & ~knife).sum()), diff.numel())
    b, h, w, _ = x.shape
    k = int(kernel.shape[0])
    row = {"ms": None, "plain_ms": None, "library_ms": None, "max_abs_err": err}
    # bytes: x once, the output once; flops: both passes' K multiply-adds
    # an element, plus the epilogue
    row["bound_ms"], row["bound_by"] = bound_ms(
        x.numel() * 4 + got.numel() * got.element_size() + 4 * k,
        x.numel() * (4.0 * k + (4 if mode == MODE_UNSHARP else 0)))
    times = ""
    if timed:
        # the yardstick: one depthwise conv2d (the K x K outer product of
        # the taps, groups=3) on the replicate-padded input
        half = k // 2
        ker = torch.from_numpy(np.outer(kernel, kernel).astype(np.float32)).to(x.device)
        padded = F.pad(x.permute(0, 3, 1, 2), (half, half, half, half),
                       mode="replicate").contiguous()
        weight = ker[None, None].expand(3, 1, k, k).contiguous()
        lib_err = float((F.conv2d(padded, weight, groups=3).permute(0, 2, 3, 1)
                         - separable_conv_plain(x, kernel)).abs().max())
        row["ms"] = cuda_ms(torch, lambda: separable_filter(
            x, kernel, mode, gain, threshold, out_u8))
        row["plain_ms"] = cuda_ms(torch, plain, iters=3)
        row["library_ms"] = cuda_ms(torch, lambda: F.conv2d(padded, weight, groups=3))
        times = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                 f"conv2d {k}x{k} {row['library_ms']:.4f} ms (blur only, max "
                 f"diff {lib_err:.2e}), ")
    print(f"K5 {label}: {tuple(x.shape)} {k} taps mode {mode} "
          f"{'u8' if out_u8 else 'f32'}: max diff {err} (bound {tol}), "
          f"{n_knife} values differ more at the threshold; {times}bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def k6_case(torch, label, x, canvas, offset, background, gray, dither, out_u8,
            timed=True):
    """K6 against pixel_pass_plain: exact wherever no dither threshold lies
    within K6_KNIFE of the luma (those values are counted)."""
    from flyimg_tpu_torch.ops.color import (
        LUMA_WEIGHTS,
        _luma,
        dither_threshold,
        pixel_pass,
        pixel_pass_plain,
    )
    from flyimg_tpu_torch.ops.pad import extent_pad

    got = pixel_pass(x, canvas, offset, background, gray, dither, out_u8)
    ref = pixel_pass_plain(x, canvas, offset, background, gray, dither, out_u8)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"K6 {label}: {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - ref.float()).abs()
    knife = torch.zeros(diff.shape[:3], dtype=torch.bool, device=x.device)
    if dither:
        pre = extent_pad(x, canvas, offset, background) if canvas else x
        if gray is not None:
            pre = _luma(pre, gray)[..., None].expand(pre.shape)
        luma = _luma(pre, LUMA_WEIGHTS)
        knife = (luma - dither_threshold(*luma.shape[1:], x.device)).abs() < K6_KNIFE
    err = float(diff.masked_fill(knife[..., None], 0.0).max())
    n_knife = int((knife[..., None] & (diff > 0)).sum())
    check(err == 0.0, f"K6 {label}: max diff {err} off the dither knife-edge")
    b, oh, ow, _ = got.shape
    row = {"ms": None, "plain_ms": None, "library_ms": None, "max_abs_err": err}
    # bytes: the input pixels the canvas shows, the output; ~12 flops a pixel
    shown = oh * ow
    if canvas is not None:
        h, w = x.shape[1:3]
        shown = (max(0, min(h, oh + offset[1]) - max(0, offset[1]))
                 * max(0, min(w, ow + offset[0]) - max(0, offset[0])))
    row["bound_ms"], row["bound_by"] = bound_ms(
        12.0 * b * shown + got.numel() * got.element_size(), 12.0 * b * oh * ow)
    times = ""
    if timed:
        row["ms"] = cuda_ms(torch, lambda: pixel_pass(
            x, canvas, offset, background, gray, dither, out_u8))
        row["plain_ms"] = cuda_ms(torch, lambda: pixel_pass_plain(
            x, canvas, offset, background, gray, dither, out_u8), iters=3)
        times = f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
    print(f"K6 {label}: {tuple(x.shape)} -> {tuple(got.shape)} "
          f"{'u8' if out_u8 else 'f32'}: max diff {err} (exact), {n_knife} values "
          f"differ at a dither threshold (within {K6_KNIFE}); {times}bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_stage_kernels(torch, dev):
    """K1-f32, K4, K5 and K6 against their plain versions at the shapes the
    staged programs give them (32 x 1920x1080 sources), timed; then the
    edge cases, not timed."""
    from flyimg_tpu_torch.entry import STAGED_OPTIONS as STAGED
    from flyimg_tpu_torch.ops.color import LUMA_WEIGHTS, LUMA_WEIGHTS_601
    from flyimg_tpu_torch.ops.filters import (
        MODE_BLUR,
        MODE_UNSHARP,
        gaussian_kernel,
    )
    from flyimg_tpu_torch.ops.resample import resample_banded_f32, set_kernel_mode
    from flyimg_tpu_torch.ops.rotate import rotate_image
    from flyimg_tpu_torch.spec.plan import rotated_bounds

    set_kernel_mode("banded")
    rows = {}

    def resampled(opts, seed):
        plan, group, final_true, img, args, _fn = staged_case(torch, dev, opts, seed=seed)
        in_true, span_y, span_x, out_true = args
        x = resample_banded_f32(img, group.resample_out, span_y, span_x,
                                out_true, in_true[:, :2], group.band_taps,
                                plan.filter_method)
        return plan, group, final_true, img, args, x

    # K1-f32 and K5 unsharp: the fit path w_1280 (bucketed output rows past
    # out_true), then its 3-tap unsharp with the u8 store
    plan, group, _, img, args, x = resampled(STAGED[2], 1)
    in_true, span_y, span_x, out_true = args
    rows["K1-f32"] = k1_case(torch, "serving w_1280 fit", (img, in_true, span_y, span_x, out_true),
                             group.resample_out, group.band_taps, plan.filter_method,
                             f32=True)
    r, s_, gain, thr = plan.unsharp
    k5_case(torch, "serving unsharp 0.25x0.25+8+0.065", x, gaussian_kernel(r, s_),
            MODE_UNSHARP, gain, thr, out_u8=True)
    # K6: w_800 dither, and the pad + grayscale canvas
    plan, group, _, _, _, x = resampled(STAGED[4], 2)
    rows["K6"] = k6_case(torch, "serving w_800 dither", x, None, (0, 0), None,
                         None, True, True)
    plan, group, _, _, _, x = resampled(STAGED[3], 3)
    k6_case(torch, "serving ett_400x320 pad + gray", x, group.pad_canvas,
            group.pad_offset, plan.background, LUMA_WEIGHTS, False, True)
    # K4: the dynamic rotate of the w_800,h_600 crop, then the static exact
    # frame of r_-15, whose f32 output the 13-tap blur (K5's row) takes
    plan, group, final_true, _, args, x = resampled(STAGED[0], 4)
    geom = torch.cat([args[3], args[0][:, 2:4]], dim=1).contiguous()
    k4_case(torch, "serving dynamic r_30", x, plan.rotate, plan.background, geom)
    plan, group, _, img, args, _fn = staged_case(torch, dev, STAGED[5], seed=5)
    frame = img.float()
    b, h, w, _ = frame.shape
    ow, oh = rotated_bounds(w, h, plan.rotate)
    geom = torch.tensor([[h, w, oh, ow]], dtype=torch.float32, device=dev).repeat(b, 1)
    rows["K4"] = k4_case(torch, "serving static r_-15", frame, plan.rotate,
                         plan.background, geom)
    rotated = rotate_image(frame, plan.rotate, plan.background)
    del frame
    r, s_ = plan.blur
    rows["K5"] = k5_case(torch, "serving blur 0x2 of the rotated frame", rotated,
                         gaussian_kernel(r, s_), MODE_BLUR, 1.0, 0.0, out_u8=True)
    del rotated
    stage_edges(torch, dev, LUMA_WEIGHTS_601)
    return rows


def stage_edges(torch, dev, gray601):
    """K1-f32, K4, K5 and K6 at the shapes they could get wrong
    (correctness only, not timed)."""
    from flyimg_tpu_torch.ops.filters import (
        MODE_BLUR,
        MODE_UNSHARP,
        gaussian_kernel,
    )
    from flyimg_tpu_torch.spec.plan import rotated_bounds

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def noise(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    def smooth(n, h, w):
        yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None, None]
        xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :, None]
        c = torch.arange(3, device=dev, dtype=torch.float32)
        base = 128 + 100 * torch.sin(yy / 17.0 + c) * torch.cos(xx / 23.0 - c)
        return (base + noise(n, h, w, 3) * 0.05).expand(n, h, w, 3).contiguous()

    # K1-f32: the fit path's rows past out_true, members of mixed geometry
    geoms = []
    for sw, sh in ((1920, 1080), (1303, 977), (1024, 1024), (640, 1152)):
        ow_, oh_ = 640, round(sh * 640 / sw)
        geoms.append(((sh, sw), (0.0, sh), (0.0, sw), (oh_, ow_)))
    img = torch.randint(0, 256, (4, 1152, 1920, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    cols = [torch.tensor([g[i] for g in geoms], dtype=torch.float32, device=dev)
            for i in range(4)]
    k1_case(torch, "fit rows past out_true, mixed", (img, *cols), (640, 640),
            (32, 32), "lanczos3", timed=False, f32=True)

    # K4: 1x1 and 1 x w frames; every angle kind; valid < bucket; a
    # non-white background; the 8192-wide bucket
    def k4(label, x, deg, bg, valid=None):
        b, h, w, _ = x.shape
        valid = valid or [(h, w)] * b
        rows = []
        for th, tw in valid:
            rw, rh = rotated_bounds(tw, th, deg)
            rows.append([th, tw, rh, rw])
        geom = torch.tensor(rows, dtype=torch.float32, device=dev)
        k4_case(torch, label, x, deg, bg, geom, timed=False)

    for deg in (0, 90, 180, 270, 0.5, 359.5, -15):
        k4(f"1x1 at {deg}", noise(2, 1, 1, 3), deg, None)
        k4(f"1 x 37 at {deg}", noise(2, 1, 37, 3), deg, (10, 200, 30))
        k4(f"valid < bucket at {deg}", smooth(3, 128, 160), deg, (51, 102, 153),
           [(111, 133), (97, 141), (5, 7)])
    k4("wide 8192 bucket at 5", smooth(2, 128, 8192), 5, None,
       [(100, 8000), (128, 8192)])

    # K5: 61 taps (blr_0x10), an image narrower and shorter than the taps,
    # threshold 0 and > 0, f32 and u8
    k61 = gaussian_kernel(0, 10)
    k5_case(torch, "61 taps", smooth(2, 300, 400), k61, MODE_BLUR, 1.0, 0.0,
            False, timed=False)
    k5_case(torch, "61 taps on 5x20", smooth(3, 5, 20), k61, MODE_BLUR, 1.0, 0.0,
            True, timed=False)
    k5_case(torch, "1 wide, 5 taps", smooth(2, 40, 1), gaussian_kernel(2, 1),
            MODE_BLUR, 1.0, 0.0, False, timed=False)
    for thr in (0.0, 0.02):
        k5_case(torch, f"unsharp 2x1+1.5+{thr}", smooth(2, 200, 300),
                gaussian_kernel(2, 1), MODE_UNSHARP, 1.5, thr, False, timed=False)
        k5_case(torch, f"unsharp 0x3+0.8+{thr}, u8", smooth(2, 200, 300),
                gaussian_kernel(0, 3), MODE_UNSHARP, 0.8, thr, True, timed=False)

    # K6: negative offsets, a canvas smaller than the image, no overlap
    x = smooth(3, 90, 120)
    for label, canvas, offset in (
        ("negative offsets", (150, 100), (-20, -7)),
        ("canvas smaller than the image", (70, 50), (-10, -12)),
        ("canvas larger, positive offsets", (200, 160), (40, 33)),
        ("no overlap", (60, 40), (200, 300)),
        ("no overlap, negative", (60, 40), (-500, -3)),
    ):
        for gray, dither, u8 in ((None, False, False), (gray601, False, True),
                                 (None, True, True), (gray601, True, False)):
            k6_case(torch, f"{label}, gray {gray is not None}, dither {dither}",
                    x, canvas, offset, (12, 200, 77), gray, dither, u8, timed=False)
    k6_case(torch, "no pad, gray", x, None, (0, 0), None, gray601, False, False,
            timed=False)


def compare_staged(label, got, ref, dither):
    """Hold a staged program's u8 output to the reference: within PIXEL_TOL
    levels on at most DIFF_FRAC of values; for a dithered plan a value may
    also flip 0 <-> 255 where a threshold lies between the two sides'
    lumas, on at most FLIP_FRAC of values. Returns (n_diff, n_flip)."""
    import numpy as np

    check(got.shape == ref.shape, f"{label}: shape {got.shape} vs {ref.shape}")
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    flips = diff > PIXEL_TOL
    n_flip = int(flips.sum())
    if dither:
        both = np.isin(got[flips], (0, 255)) & np.isin(ref[flips], (0, 255))
        check(bool(both.all()), f"{label}: a dithered value off 0/255 differs")
        check(n_flip <= FLIP_FRAC * diff.size,
              f"{label}: {n_flip} of {diff.size} values flipped (> {FLIP_FRAC:.0e})")
    else:
        check(n_flip == 0, f"{label}: max diff {int(diff.max())} > {PIXEL_TOL}")
    n_diff = int(((diff > 0) & ~flips).sum())
    check_pixels(label, 0, n_diff, diff.size)
    return n_diff, n_flip


def phase_staged(torch, dev, card, kernels):
    """Main path: each staged program on a batch of 32 1920x1080 sources,
    built as the batcher builds it, banded; members 0 and 31 held against
    the same program on the CPU (the plain versions), then timed."""
    from flyimg_tpu_torch.entry import STAGED_OPTIONS as STAGED
    from flyimg_tpu_torch.ops.resample import set_kernel_mode

    set_kernel_mode("banded")
    rates = {}
    for i, opts in enumerate(STAGED):
        plan, group, final_true, img, args, fn = staged_case(torch, dev, opts, seed=50 + i)
        before = read_counts(kernels)
        out = fn(img, *args)
        torch.cuda.synchronize()
        after = read_counts(kernels)
        for name in staged_kernels(group):
            check(after[name] > before[name], f"staged {opts}: {name} never launched")
        pick = [0, STAGED_BATCH - 1]
        ref = fn(img[pick].cpu(), *(a[pick].cpu() for a in args)).numpy()
        got = out[pick].cpu().numpy()
        th, tw = final_true
        n_diff, n_flip = compare_staged(
            f"staged {opts}", got[:, :th, :tw], ref[:, :th, :tw], plan.monochrome)
        iters = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(img, *args)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        rates[opts] = STAGED_BATCH / dt
        print(f"staged {opts}: {tuple(img.shape)} -> {tuple(out.shape)} "
              f"(valid {th}x{tw}), kernels {staged_kernels(group)}; members 0, "
              f"{STAGED_BATCH - 1} vs the CPU: {n_diff} values differ by 1, "
              f"{n_flip} flipped at a dither threshold; steady state "
              f"{rates[opts]:.1f} images/s ({dt * 1e3:.3f} ms a batch) on {card}")
        del img, out, args
    return rates


def synthetic_png(path, w, h, seed):
    """Smooth seeded image with structure: colour gradients, a few soft
    skin-toned and saturated blobs, and a sharp-edged rectangle."""
    import numpy as np

    from flyimg_tpu_torch.codecs import png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 3.0, 2) * np.pi / np.array([h, w])
        img[..., c] = 110 + 60 * np.sin(fy * yy + fx * xx + rng.uniform(0, 6))
    for _ in range(4):
        cy, cx = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w
        r = rng.uniform(0.05, 0.2) * min(h, w)
        mask = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
        color = (np.array([200.0, 146.0, 112.0]) if rng.uniform() < 0.5
                 else rng.uniform(0, 255, 3))
        img = img * (1 - mask) + color * mask
    y0, x0 = int(rng.uniform(0.1, 0.6) * h), int(rng.uniform(0.1, 0.6) * w)
    img[y0:y0 + h // 6, x0:x0 + w // 6] = rng.uniform(0, 255, 3)
    img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(png.encode(img))


def phase_server(torch, dev, workdir, kernels):
    import urllib.request

    import numpy as np

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.entry import STAGED_OPTIONS as STAGED
    from flyimg_tpu_torch.ops.resample import set_kernel_mode
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread
    from flyimg_tpu_torch.service.handler import ImageHandler

    sizes = [(1920, 1080), (1303, 977), (512, 512)]
    sources = []
    for i in range(8):
        w, h = sizes[i % 3]
        path = os.path.join(workdir, f"src{i}_{w}x{h}.png")
        synthetic_png(path, w, h, seed=100 + i)
        sources.append(path)
    option_sets = ("w_300,h_250,c_1", "w_300,h_250,c_1,smc_1")
    requests = [(o, s) for s in sources for o in option_sets]
    # the second wave: 16 requests spread over the staged programs
    staged = [(STAGED[i % len(STAGED)], sources[i % len(sources)])
              for i in range(16)]

    counts = {}
    for mode in ("dense", "banded"):
        params = AppParameters({
            "upload_dir": os.path.join(workdir, mode, "uploads"),
            "tmp_dir": os.path.join(workdir, mode, "tmp"),
            "resample_kernel": mode,
        })
        server = make_server(params, device=dev)
        thread = serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            reset_counts(kernels)
            log0 = len(server.batcher.launch_log)

            def get(req):
                opts, src = req
                url = f"{base}/upload/{opts}/{src}"
                with urllib.request.urlopen(url, timeout=300) as resp:
                    return resp.status, dict(resp.headers), resp.read()

            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(requests)) as pool:
                answers = list(pool.map(get, requests))
            wall = time.perf_counter() - t0
            counts[mode] = read_counts(kernels)
            launches = list(server.batcher.launch_log)[log0:]
            print(f"server {mode}: {len(requests)} concurrent requests in "
                  f"{wall:.3f} s; launches (kind, members, padded batch): "
                  f"{launches}; kernel launches {counts[mode]}")
            for name in ("K2", "K3") + (("K1",) if mode == "banded" else ()):
                check(counts[mode][name] > 0,
                      f"server {mode}: {name} never launched")

            # every answer against the same request through the CPU handler
            cpu = ImageHandler(AppParameters({
                "upload_dir": os.path.join(workdir, mode, "cpu_uploads"),
                "tmp_dir": os.path.join(workdir, mode, "cpu_tmp"),
            }), device="cpu")
            n_diff = n_total = 0
            for (opts, src), (status, headers, body) in zip(requests, answers):
                check(status == 200, f"{mode} {opts} {src}: status {status}")
                check(headers.get("Content-Type") == "image/png",
                      f"{mode} {opts}: content type {headers.get('Content-Type')}")
                got, _ = png.decode(body)
                ref, _ = png.decode(cpu.process_image(opts, src).content)
                if "smc_1" not in opts:
                    check(got.shape == (250, 300, 3), f"{mode} {opts}: {got.shape}")
                check(got.shape == ref.shape,
                      f"{mode} {opts} {src}: card {got.shape} vs cpu {ref.shape}")
                diff = np.abs(got.astype(int) - ref.astype(int))
                check(int(diff.max()) <= PIXEL_TOL,
                      f"{mode} {opts} {src}: card vs cpu differ by "
                      f"{int(diff.max())} u8")
                n_diff += int((diff > 0).sum())
                n_total += diff.size
            frac = check_pixels(f"server {mode} card vs cpu", 0, n_diff,
                                n_total)
            # a repeat is a storage hit: same bytes, no device launch
            before = (read_counts(kernels), len(server.batcher.launch_log))
            status, _h, body = get(requests[1])
            after = (read_counts(kernels), len(server.batcher.launch_log))
            check(status == 200 and body == answers[1][2],
                  f"{mode}: repeat GET changed its answer")
            check(before == after, f"{mode}: repeat GET reached the device")
            print(f"server {mode}: all {len(requests)} answers 200 image/png, "
                  f"within {PIXEL_TOL} u8 of the CPU handler ({n_diff} of "
                  f"{n_total} values differ, {frac:.2e}, bound "
                  f"{DIFF_FRAC:.0e}) with equal smart-crop dims; repeat GET "
                  "served from storage")

            # second wave: the staged programs, 16 concurrent cold requests
            reset_counts(kernels)
            log0 = len(server.batcher.launch_log)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(staged)) as pool:
                answers = list(pool.map(get, staged))
            wall = time.perf_counter() - t0
            wave = read_counts(kernels)
            for name, n in wave.items():
                counts[mode][name] += n
            launches = list(server.batcher.launch_log)[log0:]
            print(f"server {mode} staged: {len(staged)} concurrent requests in "
                  f"{wall:.3f} s; launches {launches}; kernel launches {wave}")
            want = {"K4", "K5", "K6"} | ({"K1-f32"} if mode == "banded" else set())
            for name in sorted(want):
                check(wave[name] > 0, f"server {mode} staged: {name} never launched")
            n_diff = n_flip = n_total = 0
            for (opts, src), (status, headers, body) in zip(staged, answers):
                check(status == 200, f"{mode} {opts} {src}: status {status}")
                got, _ = png.decode(body)
                ref, _ = png.decode(cpu.process_image(opts, src).content)
                d, f = compare_staged(f"server {mode} {opts} {src}", got, ref,
                                      "mnchr_1" in opts)
                n_diff, n_flip = n_diff + d, n_flip + f
                n_total += got.size
            print(f"server {mode} staged: all {len(staged)} answers 200, within "
                  f"{PIXEL_TOL} u8 of the CPU handler ({n_diff} of {n_total} "
                  f"values differ, {n_flip} flipped at a dither threshold)")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    set_kernel_mode("dense")
    return counts


# ---------------------------------------------------------------------------
# the face post-passes: K7 (pixelate), K8 (facefind masks), K9/K10 (BlazeFace)


def knife_region(torch, prob, thresholds, valid):
    """[B, h, w] bool: pixels within K8_RADIUS of a valid pixel whose
    probability lies within K8_KNIFE of its member's threshold."""
    import torch.nn.functional as F

    near = ((prob - thresholds[:, None, None]).abs() < K8_KNIFE) & valid
    k = 2 * K8_RADIUS + 1
    return F.max_pool2d(near.float()[:, None], k, 1, K8_RADIUS)[:, 0] > 0


def k7_case(torch, label, image, boxes, timed=False):
    """K7 against its plain version: u8, exact."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.ops.pixelate import pixelate_regions, pixelate_regions_u8
    from flyimg_tpu_torch.ops.resample import quantize_u8

    def kern():
        return pixelate_regions_u8(image, boxes)

    def plain():
        return quantize_u8(pixelate_regions(image.float(), boxes))

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = int((got.int() - ref.int()).abs().max())
    check(err == 0, f"K7 {label}: max diff {err} u8 (must be exact)")
    h, w, _ = image.shape
    inside = int((got != image).any(dim=2).sum())
    row = {"max_abs_err": float(err), "ms": None, "plain_ms": None,
           "library_ms": None}
    if timed:
        nchw = image.permute(2, 0, 1)[None].float().contiguous()
        row["ms"] = cuda_ms(torch, kern)
        row["plain_ms"] = cuda_ms(torch, plain)
        row["library_ms"] = cuda_ms(
            torch, lambda: F.avg_pool2d(nchw, 10, 10, ceil_mode=True))
    # each pixel read once and written once, the boxes read once; ~4 flops
    # a value (3 adds of the block sum, the scale)
    row["bound_ms"], row["bound_by"] = bound_ms(
        2.0 * image.numel() + boxes.numel() * 4, 4.0 * image.numel())
    times = (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
             f"F.avg_pool2d {row['library_ms']:.4f} ms" if timed else "")
    n_boxes = int((boxes[:, 2:] > 0).all(dim=1).sum())
    print(f"K7 {label}: [{h}, {w}, 3] with {n_boxes} boxes of nonzero area "
          f"(of {boxes.shape[0]}), exact "
          f"({inside} pixels changed){times}; bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']})")
    return row


def k8_case(torch, label, images, in_true, thresholds, timed=False):
    """K8 against its plain version: the probability within K8_ULP ulps,
    the mask exact outside the knife-edge region."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.models.facefind import (
        _batched_face_masks,
        _skin_probability,
        _valid,
        face_masks_plain,
    )

    b, h, w, _ = images.shape
    prob = torch.empty((b, h, w), dtype=torch.float32, device=images.device)
    got = _batched_face_masks(images, in_true, thresholds, prob_out=prob)
    ref = face_masks_plain(images, in_true, thresholds)
    ref_prob = _skin_probability(images)
    torch.cuda.synchronize()
    ulp = int((prob.view(torch.int32).long()
               - ref_prob.view(torch.int32).long()).abs().max())
    check(ulp <= K8_ULP, f"K8 {label}: probability {ulp} ulps off (> {K8_ULP})")
    valid = _valid(in_true, h, w)
    knife = knife_region(torch, ref_prob, thresholds, valid)
    bad = int(((got != ref) & ~knife).sum())
    check(bad == 0, f"K8 {label}: {bad} mask pixels differ off the knife-edge")
    n_knife = int(knife.sum())
    row = {"max_abs_err": float((prob - ref_prob).abs().max()), "ms": None,
           "plain_ms": None, "library_ms": None}
    if timed:
        m = torch.rand((b, 1, h, w), device=images.device)

        def library():
            x = m
            for _ in range(4):
                x = F.max_pool2d(x, 5, 1, 2)
            return x

        row["ms"] = cuda_ms(torch, lambda: _batched_face_masks(images, in_true, thresholds))
        row["plain_ms"] = cuda_ms(torch, lambda: face_masks_plain(images, in_true, thresholds))
        row["library_ms"] = cuda_ms(torch, library)
    # the image read once, the mask written once (a byte a pixel); ~20 f32
    # operations a pixel for the probability (the morphology's compares
    # are not counted)
    px = b * h * w
    row["bound_ms"], row["bound_by"] = bound_ms(4.0 * px + b * 12, 20.0 * px)
    times = (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
             f"F.max_pool2d x4 {row['library_ms']:.4f} ms" if timed else "")
    print(f"K8 {label}: [{b}, {h}, {w}, 3], probability within {ulp} ulp, "
          f"mask equal off the knife-edge ({n_knife} pixels within "
          f"{K8_RADIUS} px of a value within {K8_KNIFE:.0e} of the threshold; "
          f"{int((got != ref).sum())} differ there), {float(got.float().mean()):.4f} "
          f"of pixels set{times}; bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def blazeface_layers(torch, model, views):
    """The forward's layer inputs on the plain path: [(kind, args)] for
    every K9, K10 and K10-head call, each holding the plain twin's input."""
    from flyimg_tpu_torch.models import blazeface as bf

    calls = [("K9", (views, model.stem.kernel, model.stem.bias, 2, True))]
    x = bf.conv5x5_plain(*calls[0][1])
    maps = []
    for i, block in enumerate(model.blocks):
        calls.append(("K9", (x, block.dw_kernel, None, block.stride, False)))
        y = bf.conv5x5_plain(*calls[-1][1])
        calls.append(("K10", (y, block.pw.kernel, block.pw.bias, x, block.stride)))
        x = bf.pointwise_plain(*calls[-1][1])
        if i == bf.X16_BLOCK:
            maps.append(x)
    maps.append(x)
    for fmap, (cls, reg, offset) in zip(maps, model._heads()):
        calls.append(("K10-head", (fmap, cls.kernel, cls.bias, reg.kernel,
                                   reg.bias, offset)))
    return calls


def blazeface_rows(torch, model, views, timed=True):
    """K9, K10 and K10's head form at every layer of one forward over
    ``views``: each call against its plain twin (K9/K10 within BF_RTOL
    relative, the head's probabilities within BF_PROB_TOL and boxes within
    BF_BOX_TOL absolute); timed as the forward runs them (all of a kind's
    calls in a row), with bounds summed over the calls and F.conv2d
    yardsticks."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.models import blazeface as bf

    calls = blazeface_layers(torch, model, views)
    n = views.shape[0]
    probs = torch.empty((n, bf.NUM_ANCHORS), device=views.device)
    boxes = torch.empty((n, bf.NUM_ANCHORS, 4), device=views.device)

    def head(args):
        x, ck, cb, rk, rb, off = args
        bf.head_decode(x, ck, cb, rk, rb, model.anchors, probs, boxes, off)

    def head_ref(args):
        x, ck, cb, rk, rb, off = args
        cls, raw = bf.head_plain(x, ck, cb, rk, rb)
        k = cls.shape[1]
        return torch.sigmoid(cls), bf.decode_boxes(raw, model.anchors[off:off + k])

    run = {"K9": lambda a: bf.conv5x5(*a), "K10": lambda a: bf.pointwise(*a),
           "K10-head": head}
    plain = {"K9": lambda a: bf.conv5x5_plain(*a),
             "K10": lambda a: bf.pointwise_plain(*a), "K10-head": head_ref}
    err = {"K9": 0.0, "K10": 0.0, "K10-head": 0.0}
    nbytes = dict.fromkeys(err, 0.0)
    flops = dict.fromkeys(err, 0.0)
    lib_args = dict((k, []) for k in err)
    for kind, args in calls:
        if kind == "K10-head":
            head(args)
            p_ref, b_ref = head_ref(args)
            off, k = args[5], p_ref.shape[1]
            torch.cuda.synchronize()
            ep = float((probs[:, off:off + k] - p_ref).abs().max())
            eb = float((boxes[:, off:off + k] - b_ref).abs().max())
            check(ep <= BF_PROB_TOL and eb <= BF_BOX_TOL,
                  f"K10-head at anchor {off}: probs {ep}, boxes {eb} off")
            err[kind] = max(err[kind], ep)
            x = args[0]
            cout = args[1].shape[3] + args[3].shape[3]
            nbytes[kind] += 4.0 * (x.numel() + x.shape[3] * cout + cout
                                   + 5 * n * k + 4 * k)
            flops[kind] += 2.0 * x.numel() * cout
            w = torch.cat([args[1], args[3]], dim=3)[0, 0].t()[:, :, None, None]
            lib_args[kind].append((x.permute(0, 3, 1, 2).contiguous(),
                                   w.contiguous(), None, 1))
            continue
        got, ref = run[kind](args), plain[kind](args)
        torch.cuda.synchronize()
        e = rel_err(torch, got, ref)
        check(e <= BF_RTOL, f"{kind} at {tuple(args[0].shape)}: {e} relative off")
        err[kind] = max(err[kind], e)
        x, kern = args[0], args[1]
        if kind == "K9":
            depthwise = kern.shape[2] == 1 and kern.shape[3] == x.shape[3]
            macs = got.numel() * 25 * (1 if depthwise else x.shape[3])
            groups = x.shape[3] if depthwise else 1
            pt, pb, _ = bf.same_pads(x.shape[1], args[3])
            pl, pr, _ = bf.same_pads(x.shape[2], args[3])
            xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous()
            lib_args[kind].append((xn, kern.permute(3, 2, 0, 1).contiguous(),
                                   args[2], args[3], groups))
        else:
            macs = got.numel() * x.shape[3]
            nbytes[kind] += 4.0 * args[3].numel()   # the residual
            lib_args[kind].append((x.permute(0, 3, 1, 2).contiguous(),
                                   kern[0, 0].t()[:, :, None, None].contiguous(),
                                   args[2], 1))
        nbytes[kind] += 4.0 * (x.numel() + got.numel() + kern.numel())
        flops[kind] += 2.0 * macs

    def timed_run(kind):
        sub = [a for k, a in calls if k == kind]
        return lambda: [run[kind](a) for a in sub]

    def timed_plain(kind):
        sub = [a for k, a in calls if k == kind]
        return lambda: [plain[kind](a) for a in sub]

    def timed_lib(kind):
        sub = lib_args[kind]
        if kind == "K9":
            return lambda: [F.conv2d(x, w, b, stride=s, groups=g)
                            for x, w, b, s, g in sub]
        return lambda: [F.conv2d(x, w, None, 1) for x, w, _b, _s in sub]

    rows = {}
    for kind in err:
        row = {"max_abs_err": err[kind], "ms": None, "plain_ms": None,
               "library_ms": None}
        if timed:
            row["ms"] = cuda_ms(torch, timed_run(kind))
            row["plain_ms"] = cuda_ms(torch, timed_plain(kind))
            row["library_ms"] = cuda_ms(torch, timed_lib(kind))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes[kind], flops[kind])
        count = sum(1 for k, _ in calls if k == kind)
        times = (f"; the forward's {count} calls: kernel {row['ms']:.4f} ms, "
                 f"plain {row['plain_ms']:.4f} ms, F.conv2d "
                 f"{row['library_ms']:.4f} ms" if timed else "")
        print(f"{kind} over {n} views: max error {err[kind]:.3e} "
              f"({'absolute, probs' if kind == 'K10-head' else 'relative'})"
              f"{times}; bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
              f"{flops[kind] / 1e9:.3f} GFLOP, {nbytes[kind] / 1e6:.1f} MB)")
        rows[kind] = row
    return rows


def forward_case(torch, model, views, label):
    """The whole forward through K9/K10 against the plain forward."""
    from flyimg_tpu_torch.models import blazeface as bf

    probs, boxes = bf._forward(model, views)
    logits, raw = model.forward_plain(views)
    ref_p, ref_b = torch.sigmoid(logits), bf.decode_boxes(raw, model.anchors)
    torch.cuda.synchronize()
    ep = float((probs - ref_p).abs().max())
    eb = float((boxes - ref_b).abs().max())
    check(probs.shape == (views.shape[0], bf.NUM_ANCHORS), f"forward {label}: {probs.shape}")
    check(bool(torch.isfinite(boxes).all()), f"forward {label}: non-finite boxes")
    check(ep <= BF_PROB_TOL, f"forward {label}: probs {ep} off (> {BF_PROB_TOL})")
    check(eb <= BF_BOX_TOL, f"forward {label}: boxes {eb} off (> {BF_BOX_TOL})")
    print(f"forward {label}: {tuple(views.shape)} -> probs within {ep:.2e}, "
          f"boxes within {eb:.2e} of the plain forward; {int((probs > 0.8).sum())} "
          f"anchors above 0.8")


def phase_face_kernels(torch, dev):
    """K7-K10 against their plain versions at the shapes the face pass gives
    them (timed) and at the edge shapes (not timed)."""
    import numpy as np

    from flyimg_tpu_torch.entry import face_entry, skin_ellipse_image
    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import facefind

    rng = np.random.default_rng(21)
    rows = {}
    # K7 at the wave's shape: a 640x480 output with the facefind boxes
    img = skin_ellipse_image(rng, 480, 640)
    boxes = facefind.detect_faces(img, device=dev)
    check(boxes, "K7: facefind found no boxes on the skin-ellipse image")
    padded = np.zeros((facefind.MAX_FACES, 4), np.float32)
    padded[:len(boxes)] = boxes
    rows["K7"] = k7_case(torch, "serving 480x640", torch.from_numpy(img).to(dev),
                         torch.from_numpy(padded).to(dev), timed=True)
    for h, w in ((237, 311), (1, 1), (7, 13), (10, 20), (1080, 1920)):
        src = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
        edge = torch.tensor([[3, 5, 57, 41], [100, 100, 0, 10], [w - 20, h - 15, 100, 100],
                             [10, 10, 30, 30], [0, 0, w, h / 2], [2, 3, 0, 0],
                             [-5, -5, 12, 12]], dtype=torch.float32, device=dev)
        k7_case(torch, f"{h}x{w}, zero-area, overlapping and edge boxes", src, edge)
    k7_case(torch, "no boxes", src, torch.zeros((0, 4), device=dev))
    k7_case(torch, "32 boxes", src, torch.from_numpy(
        np.concatenate([rng.uniform(-50, 1900, (32, 2)), rng.uniform(0, 300, (32, 2))],
                       axis=1).astype(np.float32)).to(dev))

    # K8 at face_entry's shape: 16 x 480x640, the whole bucket valid
    _fn, args = face_entry(dev)
    views, images, in_true, thresholds = args
    rows["K8"] = k8_case(torch, "16 x 480x640", images, in_true, thresholds,
                         timed=True)
    imgs = np.stack([skin_ellipse_image(rng, 256, 320) for _ in range(4)])
    imgs[3] = rng.integers(0, 256, imgs[3].shape, dtype=np.uint8)
    dev_imgs = torch.from_numpy(imgs).to(dev)
    for label, sel, valid in (
        ("1-member bucket", [0], [[256, 320]]),
        ("valid < bucket, sides not multiples of 32", [0, 1, 2, 3],
         [[250, 301], [237, 311], [33, 65], [256, 320]]),
        ("padded bucket (3 members + a copy)", [0, 1, 2, 2],
         [[256, 320], [201, 299], [256, 17], [256, 17]]),
        ("1x1 valid", [3], [[1, 1]]),
    ):
        k8_case(torch, label, dev_imgs[sel].contiguous(),
                torch.tensor(valid, dtype=torch.float32, device=dev),
                torch.full((len(sel),), facefind.DEFAULT_THRESHOLD, device=dev))
    k8_case(torch, "thresholds 0.01 and 0.9", dev_imgs[:2].contiguous(),
            torch.tensor([[256, 320], [256, 320]], dtype=torch.float32, device=dev),
            torch.tensor([0.01, 0.9], device=dev))

    # K9/K10 at every layer of the 64-view forward, then whole forwards
    model = bf.load_weights(bf.PACKAGED_WEIGHTS, dev)
    rows.update(blazeface_rows(torch, model, views))
    for n in (1, 3):
        blazeface_rows(torch, model, views[:n].contiguous(), timed=False)
    for n in (1, 3, 64):
        forward_case(torch, model, views[:n].contiguous(), f"N = {n}")
    return rows


def face_sources(workdir, n):
    """``n`` seeded 1280x960 PNGs with skin-toned ellipses."""
    import numpy as np

    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.entry import skin_ellipse_image

    paths = []
    for i in range(n):
        img = skin_ellipse_image(np.random.default_rng(300 + i), 960, 1280,
                                 faces=1 + i % 3)
        path = os.path.join(workdir, f"face{i}.png")
        with open(path, "wb") as fh:
            fh.write(png.encode(img))
        paths.append(path)
    return paths


def phase_faces(torch, dev, card, workdir, kernels):
    """Main path: face_entry's steady state, then the face options through
    the HTTP server (facefind fb_1, blazeface fc_1,fcp_1, auto), each answer
    held against the same request through the CPU handler."""
    import urllib.request

    import numpy as np

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.entry import face_entry
    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import facefind
    from flyimg_tpu_torch.models.faces import make_face_backend
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread
    from flyimg_tpu_torch.service.handler import ImageHandler

    fn, args = face_entry(dev)
    views, images, in_true, thresholds = args
    probs, boxes, masks = fn(*args)
    model = bf.load_weights(bf.PACKAGED_WEIGHTS, dev)
    logits, _raw = model.forward_plain(views)
    torch.cuda.synchronize()
    ep = float((probs - torch.sigmoid(logits)).abs().max())
    check(ep <= BF_PROB_TOL, f"faces entry: probs {ep} off the plain forward")
    ref_masks = facefind.face_masks_plain(images, in_true, thresholds)
    knife = knife_region(torch, facefind._skin_probability(images), thresholds,
                         facefind._valid(in_true, *images.shape[1:3]))
    check(not bool(((masks != ref_masks) & ~knife).any()),
          "faces entry: masks differ off the knife-edge")
    n_boxes = sum(len(facefind._boxes_from_mask(m)) for m in masks.cpu().numpy())
    fwd_ms = cuda_ms(torch, lambda: bf._forward(model, views), iters=20)
    mask_ms = cuda_ms(torch, lambda: facefind._batched_face_masks(images, in_true, thresholds),
                      iters=20)
    rates = {"views_per_s": views.shape[0] / fwd_ms * 1e3,
             "images_per_s": images.shape[0] / mask_ms * 1e3}
    print(f"faces entry: probs within {ep:.2e} of the plain forward, masks equal "
          f"off the knife-edge ({n_boxes} boxes in {images.shape[0]} images); "
          f"forward of {views.shape[0]} views {fwd_ms:.4f} ms "
          f"({rates['views_per_s']:.1f} views/s), masks of {images.shape[0]} "
          f"480x640 images {mask_ms:.4f} ms ({rates['images_per_s']:.1f} "
          f"images/s) on {card}")

    auto = make_face_backend("auto", device=dev)
    print(f"faces: face_backend auto resolves to {type(auto).__name__} here")
    sources = face_sources(workdir, 16)
    waves = (("facefind", "w_640,fb_1", sources, ("K7", "K8")),
             ("blazeface", "w_640,fc_1,fcp_1", sources, ("K9", "K10", "K10-head")),
             ("auto", "w_640,fb_1,fc_1", sources[:4], ()))
    for backend, opts, srcs, want in waves:
        params = AppParameters({
            "upload_dir": os.path.join(workdir, backend, "uploads"),
            "tmp_dir": os.path.join(workdir, backend, "tmp"),
            "face_backend": backend,
        })
        server = make_server(params, device=dev)
        thread = serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            before = read_counts(kernels)
            log0 = len(server.batcher.launch_log)

            def get(src):
                with urllib.request.urlopen(f"{base}/upload/{opts}/{src}",
                                            timeout=300) as resp:
                    return resp.status, resp.read()

            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(srcs)) as pool:
                answers = list(pool.map(get, srcs))
            wall = time.perf_counter() - t0
            after = read_counts(kernels)
            wave = {k: after[k] - before[k] for k in after}
            launches = list(server.batcher.launch_log)[log0:]
            print(f"faces {backend}: {len(srcs)} concurrent /upload/{opts}/ in "
                  f"{wall:.3f} s; launches {launches}; kernel launches {wave}")
            for name in want:
                check(wave[name] > 0, f"faces {backend}: {name} never launched")
            cpu = ImageHandler(AppParameters({
                "upload_dir": os.path.join(workdir, backend, "cpu_uploads"),
                "tmp_dir": os.path.join(workdir, backend, "cpu_tmp"),
                "face_backend": backend,
            }), device="cpu")
            n_diff = n_total = 0
            shapes = []
            for src, (status, body) in zip(srcs, answers):
                check(status == 200, f"faces {backend} {src}: status {status}")
                got, _ = png.decode(body)
                ref, _ = png.decode(cpu.process_image(opts, src).content)
                check(got.shape == ref.shape,
                      f"faces {backend} {src}: card {got.shape} vs cpu {ref.shape}")
                diff = np.abs(got.astype(int) - ref.astype(int))
                check(int(diff.max()) <= PIXEL_TOL,
                      f"faces {backend} {src}: card vs cpu differ by {int(diff.max())}")
                n_diff += int((diff > 0).sum())
                n_total += diff.size
                shapes.append(got.shape[:2])
            print(f"faces {backend}: all {len(srcs)} answers 200, the same "
                  f"sizes as the CPU handler {shapes[:4]}..., within {PIXEL_TOL} "
                  f"u8 ({n_diff} of {n_total} values differ)")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    return rates


# ---------------------------------------------------------------------------
# training: K11-K14 (phase 3) and the train step (phase 8)


def train_case(torch, dev, batch, seed):
    """A fresh model and a synthetic batch on the card."""
    import numpy as np

    from flyimg_tpu_torch.models import blazeface_train as bt

    model = bt.init_params(seed, dev)
    arrays = bt.synthetic_batch(np.random.default_rng(seed), batch)
    return model, bt.batch_to(arrays, dev)


def train_layers(torch, model, images, gen):
    """The training forward's backward calls on the plain path, with an
    output gradient drawn from ``gen`` each: [(kind, kwargs)] for K11 (every
    5x5 convolution), K12 (every block's 1x1 and the four heads) and K13."""
    from flyimg_tpu_torch.models import blazeface as bf

    def grad_like(t):
        return torch.randn(t.shape, generator=gen, device=t.device)

    calls = []
    x = bf.conv5x5_plain(images, model.stem.kernel, model.stem.bias, 2, True)
    calls.append(("K11", dict(g=grad_like(x), x=images, kernel=model.stem.kernel, out=x,
                              stride=2, has_bias=True, need_dx=False)))
    maps = []
    for i, block in enumerate(model.blocks):
        y = bf.conv5x5_plain(x, block.dw_kernel, None, block.stride, False)
        calls.append(("K11", dict(g=grad_like(y), x=x, kernel=block.dw_kernel, out=None,
                                  stride=block.stride, has_bias=False, need_dx=True)))
        out = bf.pointwise_plain(y, block.pw.kernel, block.pw.bias, x, block.stride)
        calls.append(("K12", dict(g=grad_like(out), y=y, kernel=block.pw.kernel, out=out,
                                  res=x, stride=block.stride)))
        x = out
        if i == bf.X16_BLOCK:
            maps.append(x)
    maps.append(x)
    heads = []
    for fmap, (cls, reg, _off) in zip(maps, model._heads()):
        heads.append((cls.kernel, cls.bias, reg.kernel, reg.bias))
        for conv in (cls, reg):
            shape = fmap.shape[:3] + (conv.kernel.shape[3],)
            calls.append(("K12", dict(g=torch.randn(shape, generator=gen, device=fmap.device),
                                      y=fmap, kernel=conv.kernel)))
    calls.append(("K13", dict(x16=maps[0], x8=maps[1], heads=tuple(heads))))
    return calls


def _rel_all(torch, got, ref):
    return max(rel_err(torch, a, b) for a, b in zip(got, ref) if b is not None)


def train_kernel_rows(torch, dev):
    """K11-K14 against their plain twins at the training shapes (batch
    TRAIN_BATCH, full width, a fresh model), each kind's calls timed in a
    row as the step runs them, with bounds summed over the calls and
    library yardsticks: cuDNN's conv2d_input/conv2d_weight (K11), the
    torch.matmul pair (K12), torch.optim.Adam(fused=True) (K14)."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import blazeface_train as bt

    model, (images, tp, tb, mask) = train_case(torch, dev, TRAIN_BATCH, 5)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    with torch.no_grad():
        calls = train_layers(torch, model, images, gen)
        k11 = [a for k, a in calls if k == "K11"]
        k12 = [a for k, a in calls if k == "K12"]
        k13 = [a for k, a in calls if k == "K13"][0]

        # K11
        err = 0.0
        nbytes = flops = 0.0
        lib11 = []
        for a in k11:
            got = bt.conv5x5_backward(**a)
            ref = bt.conv5x5_backward_plain(**a)
            torch.cuda.synchronize()
            e = _rel_all(torch, [t for t in got if t is not None],
                         [t for t in ref if t is not None])
            check(e <= TRAIN_RTOL, f"K11 at {tuple(a['x'].shape)}: {e} relative off")
            err = max(err, e)
            x, g, kern = a["x"], a["g"], a["kernel"]
            depthwise = kern.shape[2] == 1
            taps = 25 * (1 if depthwise else x.shape[3])
            flops += 2.0 * g.numel() * taps * (2 if a["need_dx"] else 1)
            nbytes += 4.0 * (x.numel() + g.numel() + 2 * kern.numel()
                             + (g.numel() if a["out"] is not None else 0)
                             + (x.numel() if a["need_dx"] else 0)
                             + (kern.shape[3] if a["has_bias"] else 0))
            n, h, w, cin = x.shape
            pt, pb, _ = bf.same_pads(h, a["stride"])
            pl, pr, _ = bf.same_pads(w, a["stride"])
            gn = g.permute(0, 3, 1, 2).contiguous()
            xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous()
            wn = kern.permute(3, 2, 0, 1).contiguous()
            lib11.append((xp, wn, gn, a["stride"], cin if depthwise else 1, a["need_dx"]))

        def k11_lib():
            for xp, wn, gn, s, groups, need_dx in lib11:
                torch.nn.grad.conv2d_weight(xp, wn.shape, gn, stride=s, groups=groups)
                if need_dx:
                    torch.nn.grad.conv2d_input(xp.shape, wn, gn, stride=s, groups=groups)

        rows["K11"] = train_row(
            torch, "K11", len(k11), err, nbytes, flops,
            lambda: [bt.conv5x5_backward(**a) for a in k11],
            lambda: [bt.conv5x5_backward_plain(**a) for a in k11], k11_lib,
            "cuDNN conv2d_weight/conv2d_input")

        # K12
        err = 0.0
        nbytes = flops = 0.0
        lib12 = []
        for a in k12:
            got = bt.pointwise_backward(**a)
            ref = bt.pointwise_backward_plain(**a)
            torch.cuda.synchronize()
            e = _rel_all(torch, [t for t in got if t is not None],
                         [t for t in ref if t is not None])
            check(e <= TRAIN_RTOL, f"K12 at {tuple(a['y'].shape)} -> "
                  f"{a['kernel'].shape[3]}: {e} relative off")
            err = max(err, e)
            y, g, kern = a["y"], a["g"], a["kernel"]
            res, out = a.get("res"), a.get("out")
            pixels = y.numel() // y.shape[3]
            flops += 4.0 * pixels * kern.shape[2] * kern.shape[3] + pixels * kern.shape[3]
            # y, g, out and the kernel read, dy, dW and db written; dres
            # written, and res read only at stride 2 (the 2x2 argmax): at
            # stride 1 dres is a slice of g
            pooled = a.get("stride", 1) == 2
            nbytes += 4.0 * (2 * y.numel() + g.numel() + 2 * kern.numel() + kern.shape[3]
                             + (out.numel() if out is not None else 0)
                             + ((2 if pooled else 1) * res.numel() if res is not None else 0))
            lib12.append((g.reshape(-1, kern.shape[3]), y.reshape(-1, kern.shape[2]),
                          kern.reshape(kern.shape[2], kern.shape[3])))

        def k12_lib():
            for g2, y2, w2 in lib12:
                torch.matmul(g2, w2.t())
                torch.matmul(y2.t(), g2)

        rows["K12"] = train_row(
            torch, "K12", len(k12), err, nbytes, flops,
            lambda: [bt.pointwise_backward(**a) for a in k12],
            lambda: [bt.pointwise_backward_plain(**a) for a in k12], k12_lib,
            "torch.matmul pair")

        # K13
        args = (k13["x16"], k13["x8"], k13["heads"], tp, tb, mask)
        got = bt.head_loss(*args)
        ref = bt.head_loss_plain(*args)
        torch.cuda.synchronize()
        e_loss = rel_err(torch, got[0], ref[0])
        e = max(rel_err(torch, got[1], ref[1]), rel_err(torch, got[2], ref[2]))
        check(e_loss <= LOSS_RTOL, f"K13: loss {e_loss} relative off")
        check(e <= HEAD_GRAD_RTOL, f"K13: dlogits/draw {e} relative off")
        n = tp.shape[0]
        head_macs = sum(m.numel() * 5 * h[0].shape[3] for m, h in zip(args[:2], args[2]))
        params = sum(t.numel() for h in args[2] for t in h)
        # the maps, head parameters, tp and mask read, dlogits written; tb
        # read, draw written; the loss written
        nbytes = 4.0 * (args[0].numel() + args[1].numel() + params + 3 * tp.numel()
                        + 2 * tb.numel() + 1)
        flops = 2.0 * head_macs + 40.0 * n * bf.NUM_ANCHORS
        rows["K13"] = train_row(
            torch, "K13", 1, max(e, e_loss), nbytes, flops,
            lambda: bt.head_loss(*args), lambda: bt.head_loss_plain(*args), None, None)

    # K14 on the flat parameters with a gradient of the step's scale
    flat = model.flat_params.detach().clone()
    g = torch.randn(flat.shape, generator=gen, device=dev) * 1e-2
    a = [flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)]
    b = [t.clone() for t in a]
    for step in (1, 2, 3):
        bt.adam_update(a[0], g, a[1], a[2], step)
        bt.adam_update_plain(b[0], g, b[1], b[2], step)
    torch.cuda.synchronize()
    e = max(rel_err(torch, x, y) for x, y in zip(a, b))
    check(e <= ADAM_RTOL, f"K14: {e} relative off its plain version")
    fused_p = torch.nn.Parameter(flat.clone())
    fused_p.grad = g.clone()
    fused = torch.optim.Adam([fused_p], lr=1e-3, eps=1e-8, fused=True)
    rows["K14"] = train_row(
        torch, "K14", 1, e, 4.0 * 7 * flat.numel(), 16.0 * flat.numel(),
        lambda: bt.adam_update(a[0], g, a[1], a[2], 4),
        lambda: bt.adam_update_plain(b[0], g, b[1], b[2], 4), fused.step,
        "torch.optim.Adam(fused=True)")
    return rows


def train_edges(torch, dev):
    """K11-K14 against their plain twins, not timed, on the shapes their
    chunking and tiling could get wrong: odd sizes at stride 1 and 2, one
    member, 1x1 inputs, channel counts that divide nothing, pixel counts
    no 16-pixel tile divides, tied 2x2 windows of equal zeros and equal
    positives, a head's strided gradient scaled and added into dy, K13 at
    one and three members, K14 on a length no block divides."""
    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import blazeface_train as bt

    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def compare(label, got, ref, tol):
        e = _rel_all(torch, [t for t in got if t is not None],
                     [t for t in ref if t is not None])
        check(e <= tol, f"{label}: {e} relative off its plain version")
        return e

    worst = {"K11": 0.0, "K12": 0.0, "K13": 0.0, "K14": 0.0}
    with torch.no_grad():
        for n, size, c, stride in ((1, 17, 5, 2), (3, 9, 24, 1), (2, 1, 7, 2),
                                   (1, 2, 96, 2), (2, 33, 28, 2), (1, 6, 3, 1)):
            x = randn(n, size, size, c)
            kern = randn(5, 5, 1, c, scale=0.2)
            y = bf.conv5x5_plain(x, kern, None, stride, False)
            a = dict(g=randn(*y.shape), x=x, kernel=kern, out=None, stride=stride,
                     has_bias=False, need_dx=True)
            worst["K11"] = max(worst["K11"], compare(
                f"K11 depthwise {n} x {size}x{size}x{c} /{stride}",
                bt.conv5x5_backward(**a), bt.conv5x5_backward_plain(**a), TRAIN_RTOL))
        for n, size in ((1, 13), (3, 8), (1, 1)):
            x = randn(n, size, size, 3)
            kern, bias = randn(5, 5, 3, 24, scale=0.2), randn(24, scale=0.1)
            out = bf.conv5x5_plain(x, kern, bias, 2, True)
            a = dict(g=randn(*out.shape), x=x, kernel=kern, out=out, stride=2,
                     has_bias=True, need_dx=False)
            worst["K11"] = max(worst["K11"], compare(
                f"K11 stem {n} x {size}x{size}", bt.conv5x5_backward(**a),
                bt.conv5x5_backward_plain(**a), TRAIN_RTOL))
        for n, h, cin, cout, cres, stride in ((1, 5, 24, 28, 24, 1), (3, 3, 28, 32, 28, 2),
                                              (2, 7, 96, 96, 96, 2), (1, 1, 5, 9, 4, 2),
                                              (2, 4, 42, 48, 42, 2)):
            res = torch.relu(randn(n, stride * h, stride * h, cres))
            if stride == 2:
                res[:, ::2, 1::2] = res[:, ::2, ::2]      # ties in the top row
                res[:, : 2 * (h // 2)] *= (res[:, : 2 * (h // 2)] > 0.7)  # zero windows
            y = randn(n, h, h, cin)
            kern, bias = randn(1, 1, cin, cout, scale=0.2), randn(cout, scale=0.1)
            out = bf.pointwise_plain(y, kern, bias, res, stride)
            a = dict(g=randn(*out.shape), y=y, kernel=kern, out=out, res=res, stride=stride)
            got, ref = bt.pointwise_backward(**a), bt.pointwise_backward_plain(**a)
            worst["K12"] = max(worst["K12"], compare(
                f"K12 {n} x {h}x{h}x{cin}->{cout} /{stride}", got, ref, TRAIN_RTOL))
            check(torch.equal(got[3], ref[3]),
                  f"K12 {n} x {h}x{h} /{stride}: the residual's gradient is not its "
                  f"plain version's (ties route to the first maximum)")
        full = randn(3, bf.NUM_ANCHORS, 4)
        x8 = randn(3, 8, 8, 96)
        kern = randn(1, 1, 96, 24, scale=0.1)
        g = full[:, 512:].reshape(3, 8, 8, 24)
        scale = torch.tensor(0.37, device=dev)
        dy0 = randn(3, 8, 8, 96)
        got = bt.pointwise_backward(g, x8, kern, gscale=scale, dy=dy0.clone())
        ref = bt.pointwise_backward_plain(g, x8, kern, gscale=scale, dy=dy0.clone())
        worst["K12"] = max(worst["K12"], compare(
            "K12 head form, strided gradient, scaled, added", got, ref, TRAIN_RTOL))
        for n in (1, 3):
            model, (images, tp, tb, mask) = train_case(torch, dev, n, 20 + n)
            maps = []
            x = bf.conv5x5_plain(images, model.stem.kernel, model.stem.bias, 2, True)
            for i, block in enumerate(model.blocks):
                x = block.forward_plain(x)
                if i == bf.X16_BLOCK:
                    maps.append(x)
            heads = tuple((c.kernel, c.bias, r.kernel, r.bias) for c, r, _ in model._heads())
            args = (maps[0], x, heads, tp, tb, mask)
            got, ref = bt.head_loss(*args), bt.head_loss_plain(*args)
            check(rel_err(torch, got[0], ref[0]) <= LOSS_RTOL, f"K13 at N = {n}: loss off")
            worst["K13"] = max(worst["K13"], compare(
                f"K13 at N = {n}", got[1:], ref[1:], HEAD_GRAD_RTOL))
    p = randn(12345)
    g = randn(12345, scale=1e-3)
    a = [p.clone(), torch.zeros_like(p), torch.zeros_like(p)]
    b = [t.clone() for t in a]
    for step in range(1, 6):
        bt.adam_update(a[0], g * step, a[1], a[2], step)
        bt.adam_update_plain(b[0], g * step, b[1], b[2], step)
    worst["K14"] = compare("K14 on 12345 values, five steps", a, b, ADAM_RTOL)
    torch.cuda.synchronize()
    print("training kernels on edge shapes, worst relative errors: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))


def train_row(torch, kind, count, err, nbytes, flops, run, plain, lib, lib_name):
    row = {"max_abs_err": err, "ms": cuda_ms(torch, run), "plain_ms": cuda_ms(torch, plain),
           "library_ms": cuda_ms(torch, lib) if lib is not None else None}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    lib_txt = (f", {lib_name} {row['library_ms']:.4f} ms" if lib is not None else "")
    print(f"{kind} at batch {TRAIN_BATCH}: max error {err:.3e} (relative); the step's "
          f"{count} call{'s' if count != 1 else ''}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
          f"{lib_txt}; bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return row


def step_rate(torch, dev, batch, plain, iters=20):
    """Steps/s of the kernel (or plain) train step at ``batch`` on a
    batch already on the card, by the host clock around synchronised runs."""
    from flyimg_tpu_torch.models import blazeface_train as bt
    from flyimg_tpu_torch.profile_entry import plain_train_step

    model, arrays = train_case(torch, dev, batch, 11)
    step = plain_train_step(model) if plain else bt.make_train_step(model)[1]
    for _ in range(3):
        step(*arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(*arrays)
    torch.cuda.synchronize()
    return iters / (time.perf_counter() - t0)


def phase_train(torch, dev, card, workdir):
    """Main path: one kernel train step against the plain autograd step
    from the same weights and batch; train_synthetic(150, 16, seed 3)
    through the kernels to the JAX package's convergence and localisation
    conditions (tests/test_blazeface.py:58-84); the .npz out and back;
    then steps/s at batch 16 and 64, kernel and plain."""
    import numpy as np

    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import blazeface_train as bt
    from flyimg_tpu_torch.profile_entry import plain_train_step

    # one step, kernels against plain, from the same weights and batch
    losses, grads = {}, {}
    for plain in (False, True):
        model, arrays = train_case(torch, dev, TRAIN_BATCH, 3)
        step = plain_train_step(model) if plain else bt.make_train_step(model)[1]
        losses[plain] = step(*arrays)
        grads[plain] = {n: p.grad for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    e_loss = rel_err(torch, losses[False], losses[True])
    check(e_loss <= LOSS_RTOL, f"train step: loss {e_loss} relative off the plain step")
    e_grad, worst = 0.0, ""
    for name, ref in grads[True].items():
        e = rel_err(torch, grads[False][name], ref)
        check(e <= TRAIN_RTOL, f"train step: gradient of {name} {e} relative off")
        if e >= e_grad:
            e_grad, worst = e, name
    print(f"train step (batch {TRAIN_BATCH}): loss {float(losses[False]):.6f} within "
          f"{e_loss:.2e} of the plain step's; every gradient leaf within {e_grad:.2e} "
          f"of its max |value| (worst {worst})")

    # 150 steps through the kernels, then the JAX package's conditions
    t0 = time.perf_counter()
    model, final = bt.train_synthetic(steps=150, batch=TRAIN_BATCH, seed=3, device=dev)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    check(np.isfinite(final), f"train_synthetic: final loss {final}")
    fresh = bt.init_params(9, dev)
    eval_batch = bt.batch_to(bt.synthetic_batch(np.random.default_rng(9), TRAIN_BATCH), dev)
    with torch.no_grad():
        trained_loss = float(bt.loss_fn(model, *eval_batch))
        fresh_loss = float(bt.loss_fn(fresh, *eval_batch))
    check(trained_loss < 0.5 * fresh_loss,
          f"train_synthetic: seed-9 loss {trained_loss} not below half a fresh "
          f"init's {fresh_loss}")
    images, _, _, _ = bt.synthetic_batch(np.random.default_rng(77), 1)
    rgb = ((images[0] + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    found = bf.detect_faces(model, rgb, score_threshold=0.5)
    check(found, "train_synthetic: the trained detector found nothing")
    blob = np.random.default_rng(77)
    blob.uniform(-1, 1, (1, bf.INPUT_SIZE, bf.INPUT_SIZE, 3))
    cx, cy = blob.uniform(0.3, 0.7, 2)
    x, y, w, h = found[0]
    bx, by = (x + w / 2) / rgb.shape[1], (y + h / 2) / rgb.shape[0]
    check(abs(bx - cx) < 0.2 and abs(by - cy) < 0.2,
          f"train_synthetic: box centre ({bx:.3f}, {by:.3f}) off the blob "
          f"({cx:.3f}, {cy:.3f})")
    path = os.path.join(workdir, "blazeface-trained.npz")
    bt.save_weights(model, path)
    reloaded = bf.load_weights(path, dev)
    again = bf.detect_faces(reloaded, rgb, score_threshold=0.5)
    check(again == found, f"reloaded weights: boxes {again} != {found}")
    print(f"train_synthetic(150, {TRAIN_BATCH}, seed 3): {took:.3f} s (host batches "
          f"included), final loss {final:.4f}; seed-9 loss {trained_loss:.4f} against "
          f"a fresh init's {fresh_loss:.4f}; seed-77 box centre ({bx:.3f}, {by:.3f}) "
          f"for the blob at ({cx:.3f}, {cy:.3f}); the .npz reloads to the same "
          f"boxes {found}")

    rates = {}
    for batch in (TRAIN_BATCH, 64):
        for plain in (False, True):
            rate = step_rate(torch, dev, batch, plain)
            rates[(batch, plain)] = rate
            print(f"train step, batch {batch}, {'plain (cuDNN autograd)' if plain else 'kernels'}: "
                  f"{rate:.2f} steps/s, {rate * batch:.1f} images/s on {card}")
    return rates


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "flyimg_tpu_torch")):
        raise SmokeFailure(f"no flyimg_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    import torch

    # phase 1: device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.device import resolve_device
    from flyimg_tpu_torch.models.blazeface import conv5x5, head_decode, pointwise
    from flyimg_tpu_torch.models.blazeface_train import (
        adam_update,
        conv5x5_backward,
        head_loss,
        pointwise_backward,
    )
    from flyimg_tpu_torch.models.facefind import _batched_face_masks
    from flyimg_tpu_torch.models.smartcrop import _batched_scores, _batched_weighted
    from flyimg_tpu_torch.ops.color import pixel_pass
    from flyimg_tpu_torch.ops.filters import separable_filter
    from flyimg_tpu_torch.ops.pixelate import pixelate_regions_u8
    from flyimg_tpu_torch.ops.resample import resample_banded_f32, resample_banded_u8
    from flyimg_tpu_torch.ops.rotate import rotate_sampled

    resolve_device(dev)  # TF32 off for matmuls and convolutions
    kernels = {"K1": resample_banded_u8, "K1-f32": resample_banded_f32,
               "K2": _batched_weighted, "K3": _batched_scores,
               "K4": rotate_sampled, "K5": separable_filter, "K6": pixel_pass,
               "K7": pixelate_regions_u8, "K8": _batched_face_masks,
               "K9": conv5x5, "K10": pointwise, "K10-head": head_decode,
               "K11": conv5x5_backward, "K12": pointwise_backward, "K13": head_loss,
               "K14": adam_update}

    # phase 2: build
    t0 = time.perf_counter()
    took = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(took)} kernels in parallel {took}")
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # phase 3: kernels against their plain versions
    rows = phase_kernels(torch, dev)
    rows.update(phase_stage_kernels(torch, dev))
    rows.update(phase_face_kernels(torch, dev))
    rows.update(train_kernel_rows(torch, dev))
    train_edges(torch, dev)

    # phase 4: entry (main path)
    reset_counts(kernels)
    rates = phase_entry(torch, dev, card)
    entry_counts = read_counts(kernels)
    print(f"entry kernel launches: {entry_counts}")
    for name in ("K1", "K2", "K3"):
        check(entry_counts[name] > 0, f"entry: {name} never launched")

    # phase 5: the staged programs (main path)
    reset_counts(kernels)
    staged_rates = phase_staged(torch, dev, card, kernels)
    staged_counts = read_counts(kernels)
    print(f"staged kernel launches: {staged_counts}")
    for name in ("K1-f32", "K4", "K5", "K6"):
        check(staged_counts[name] > 0, f"staged: {name} never launched")

    # phase 6: server (main path)
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        server_counts = phase_server(torch, dev, workdir, kernels)
        # phase 7: the face post-passes (main path)
        reset_counts(kernels)
        face_rates = phase_faces(torch, dev, card, workdir, kernels)
        face_counts = read_counts(kernels)
        # phase 8: BlazeFace training (main path)
        reset_counts(kernels)
        train_rates = phase_train(torch, dev, card, workdir)
        train_counts = read_counts(kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"faces kernel launches: {face_counts}")
    for name in ("K7", "K8", "K9", "K10", "K10-head"):
        check(face_counts[name] > 0, f"faces: {name} never launched")
    print(f"train kernel launches: {train_counts}")
    for name in ("K9", "K10", "K11", "K12", "K13", "K14"):
        check(train_counts[name] > 0, f"train: {name} never launched")

    meta = {
        "K1": ("resample_banded_u8", "flyimg_tpu_torch/csrc/resample_banded.cu",
               "flyimg_tpu/ops/resample.py:343"),
        "K2": ("saliency_field", "flyimg_tpu_torch/csrc/saliency.cu",
               "flyimg_tpu/models/smartcrop.py:424"),
        "K3": ("candidate_scores", "flyimg_tpu_torch/csrc/scores.cu",
               "flyimg_tpu/models/smartcrop.py:441"),
        "K1-f32": ("resample_banded_f32", "flyimg_tpu_torch/csrc/resample_banded.cu",
                   "flyimg_tpu/ops/resample.py:343"),
        "K4": ("rotate", "flyimg_tpu_torch/csrc/rotate.cu",
               "flyimg_tpu/ops/rotate.py:52"),
        "K5": ("separable_filter", "flyimg_tpu_torch/csrc/separable.cu",
               "flyimg_tpu/ops/filters.py:38"),
        "K6": ("pixel_pass", "flyimg_tpu_torch/csrc/pixel_pass.cu",
               "flyimg_tpu/ops/color.py:51"),
        "K7": ("pixelate_regions_u8", "flyimg_tpu_torch/csrc/pixelate.cu",
               "flyimg_tpu/ops/pixelate.py:37"),
        "K8": ("face_masks", "flyimg_tpu_torch/csrc/facemask.cu",
               "flyimg_tpu/models/facefind.py:143"),
        "K9": ("blazeface_conv5x5", "flyimg_tpu_torch/csrc/blazeface.cu",
               "flyimg_tpu/models/blazeface.py:35"),
        "K10": ("blazeface_pointwise", "flyimg_tpu_torch/csrc/blazeface.cu",
                "flyimg_tpu/models/blazeface.py:35"),
        "K10-head": ("blazeface_head_decode", "flyimg_tpu_torch/csrc/blazeface.cu",
                     "flyimg_tpu/models/blazeface.py:57"),
        "K11": ("blazeface_conv5x5_backward", "flyimg_tpu_torch/csrc/blazeface_train.cu",
                "flyimg_tpu/models/blazeface.py:366"),
        "K12": ("blazeface_pointwise_backward", "flyimg_tpu_torch/csrc/blazeface_train.cu",
                "flyimg_tpu/models/blazeface.py:366"),
        "K13": ("blazeface_head_loss", "flyimg_tpu_torch/csrc/blazeface_train.cu",
                "flyimg_tpu/models/blazeface.py:347"),
        "K14": ("blazeface_adam", "flyimg_tpu_torch/csrc/blazeface_train.cu",
                "flyimg_tpu/models/blazeface.py:366"),
    }
    line = {"kernels": []}
    for key, (name, source, replaces) in meta.items():
        launches = (entry_counts[key] + staged_counts[key]
                    + sum(c[key] for c in server_counts.values())
                    + face_counts[key] + train_counts[key])
        row = rows[key]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    print(f"entry images/s: dense {rates['dense']:.1f}, banded "
          f"{rates['banded']:.1f}")
    print("staged images/s: " + ", ".join(
        f"{opts} {rate:.1f}" for opts, rate in staged_rates.items()))
    print(f"faces: BlazeFace {face_rates['views_per_s']:.1f} views/s, facefind "
          f"masks {face_rates['images_per_s']:.1f} images/s")
    print("train steps/s: " + ", ".join(
        f"batch {b} {'plain' if plain else 'kernels'} {rate:.2f}"
        for (b, plain), rate in train_rates.items()))
    print(card_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
