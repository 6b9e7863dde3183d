#!/usr/bin/env python3
"""Smoke run of the PyTorch package (flyimg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --tiled-only   # phase 9's checks on every card

Phases, in order; any failure exits non-zero without a result line:

1. device  — a CUDA card must be visible; prints nvidia-smi's name and
             power limit;
2. build   — compiles kernels K1-K17 from csrc/ with nvcc (one process per
             source, all at once) and prints the build time and ptxas report;
             builds the host codecs (codecs/native/: the WebP codec's VP8
             and VP8L sources into one library, the GIF/TIFF/BMP loops into
             another, the JPEG writer into a third) with g++ and loads
             nvJPEG, printing both libraries' versions;
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
             with F.grid_sample and a depthwise F.conv2d as yardsticks; K4
             everywhere also to the bit against the previous K4
             (csrc/rotate_prev.cu, f32 and u8 stores) and K5 to its two-pass
             form's values; and, not timed, K1-f32 on fit rows past
             out_true, K4 on 1x1 and 1 x w frames at
             0/90/180/270/0.5/359.5/-15/44.9/45 degrees, valid regions
             smaller than the bucket, a coloured background, the 8192-wide
             bucket and tiles wholly outside a member's valid region (counted
             by k4_footprint), K5 with 61 taps, at k5_plan's switch from the
             tile form to the two-pass form and one past it, sizes no tile
             divides, images narrower than the taps, the tiled form's halo
             (K // 2, less, and an image narrower than it), unsharp
             thresholds 0 and > 0 and an unsharp knife-edge (two flat
             regions meeting), K6 with negative offsets, a canvas smaller
             than the image and no overlap; then
             the face kernels at the face pass's shapes, timed, with
             F.avg_pool2d, F.max_pool2d x4 and F.conv2d yardsticks: K7
             (pixelate, exact) on a 480x640 output with its facefind boxes
             (also its host time, no sync), K8 (facefind masks: probability
             within 1 ulp, mask exact off the knife-edge) on 16 x 480x640,
             K9/K10 (BlazeFace) at every layer of the 64-view forward
             (within 1e-5 relative; the head form's one launch over both
             maps: probabilities within 1e-5 and boxes within 1e-4
             absolute, also at 1 and 3 views), and K10's 16 and K9's 17
             calls one by one (events, device time, byte bound, launch
             plan) and the head's one launch; not timed, K7
             on sides that are not multiples of 10, 1x1, zero-area,
             overlapping, negative and past-the-edge boxes, none and 32,
             factors 1 and 32, a view off 16-byte alignment; K8 (one
             launch a call) on 1-member and padded buckets, valid regions
             smaller than the bucket, 1x1, thresholds 0 and 0.9 and rows
             cut into tiles with valid sides straddling tile edges both
             ways; K10 on pixel counts no
             tile divides, channel counts no multiple of 4 or 8, no
             residual, stride-2 widths that set the tile and an unaligned
             input; K9 on odd sizes at stride 2, widths no run divides,
             C = 3 (full and depthwise), 42 and 96, N = 1, one row and
             unaligned inputs; the forward at N = 1, 3 and 64; then the training
             kernels at the train step's shapes (batch 16, full width, a
             fresh model), timed, with cuDNN's
             conv2d_weight/conv2d_input, a torch.matmul pair and
             torch.optim.Adam(fused=True) as yardsticks: K11 (K9's
             backward) and K12 (K10's and the heads' backward) within 1e-4
             of each output's max |value|, each the same bits on a repeated
             call, K11's input gradient added into a given one (dx_into) in
             one rounding, and K11's 17 and K12's 20 calls one by one
             (events, device time, one launch a call, byte bound, the
             library call, the plan), K13 (heads + loss + its gradient)
             within 1e-5, K14 (Adam) within 1e-6 over three steps; and, not
             timed, K11-K14 on odd and unequal sizes (every stride-2 parity
             class), one member and 64, 1x1 inputs, one chunk and many, the
             96x96 dW tile, pixel counts no tile divides, tied 2x2 windows
             (the residual's gradient equal to its plain version's), a
             block's K12 then K11 into the residual's gradient, a head's strided,
             scaled and accumulated gradient, K13 at N = 1, 3, 16 and 64
             (the same bits on a repeated call, one launch a call), K14 on a
             length no block divides, on a count of 4k + 3, on buffers at one
             shared offset and at unequal offsets off 16-byte alignment,
             each the plain version's bits; then K15 (the ring rotate's step) at
             phase 9's shapes (a 960-row visiting tile of the 3840x2160
             frame into a 1092x4036 accumulator at -37 degrees), a middle
             step and the last (u8, coloured background), within 1e-5
             relative of its plain version, timed; and the dense resample's
             fold2d_bf16 form against its f32 form at the flagship shape,
             timed (not a kernel: the library's products); then the JPEG
             encoder's kernels, K16 (trellis) and K17 (islow FDCT), against
             their plain versions coefficient for coefficient (a differing
             block is named): every luma sampling factor of the 300x250
             fixture source at q90, q1, q100, 1920x1080, 301x251 and 7x5
             frames, K17 also on CMYK planes; timed at the 300x250 answer
             with nvJPEG's whole encode of the frame as the yardstick;
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
             cache hit; then (banded) the JPEG waves: the same 8 sources as
             q90 4:2:0 JPEGs from the package's own encoder (moz_0: K17), 16
             concurrent o_auto requests from a client that accepts WebP
             answered lossy image/webp (as the reference answers a
             browser), 16 o_webp,webpl_1 requests answered lossless
             image/webp and 16 o_auto requests with Accept: */* answered
             image/jpeg, each 200, decoded, 300x250 without smc_1, a
             lossless answer equal to the PNG answer of the same URL, a
             lossy WebP one at least WEBP_ANSWER_PSNR and a JPEG one at
             least JPEG_ANSWER_PSNR against it; o_webp without webpl_1
             answers lossy image/webp; K1, K2 and K3 must launch, and K16
             for the JPEG answers; the waves' wall times beside the PNG
             wave's;
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

9. tiled  — the handler's tall-input route (flyimg_tpu_torch/parallel/,
             entry.py tiled_fn) on a seeded 3840x2160 (H x W) u8 frame over
             a virtual 4-rank mesh on cuda:0: the halo-exchange resample to
             w_256 (455x256) dense and banded (K1 with per-rank geometry),
             the halo-exchange blr_0x2 and unsh_0.25x0.25+8+0.065 (K5's
             tiled form), the ring r_-37 (K15, 4367x4036 out); each held
             against the same op untiled on the card (K1 or the dense
             products, K5, K4; bounds 0.75, 1e-3, 0.51) and against the
             tiled program on the kernels' plain versions (K1-f32 1e-3, K5
             1e-4 off the unsharp threshold, the ring 1e-4 relative), then
             timed against the untiled op (u8 out, as the handler asks; on
             one card the ranks run one after another, so this is the
             schedule's cost, not a multi-card speed); not timed: 2 and 8
             ranks, a 2161-row source, an infeasible halo (must raise), 0,
             90 and 180 degrees and a coloured background; then a server
             with that mesh answers /upload/{w_256,r_-37,blr_0x2},o_png/
             for a 3840x2160 PNG within 1 u8 level of a server without one,
             its handler's tiled counters showing the route, and
             w_256,h_200,c_1 (a crop) not taking it. With more than one
             card the checks run again on a mesh over all of them.
10. codecs — the host codec layer (codecs/): nvJPEG's decode of the JPEG
             fixtures (tests/data/jpeg, written by the JAX package's
             libjpeg-turbo: 4:2:0, 4:4:4, progressive, EXIF orientation 6,
             DCT scales 1, 2 and 4 of 8) against the JAX package's decoded
             pixels (bounds NVJPEG_LEVELS and NVJPEG_SHARE_OVER_1), and a
             header declaring 30000 x 30000 pixels refused; the port's own
             JPEG encodes (K16, K17, the host writer) of
             tests/data/jpeg_enc/source.png byte-equal to every file there
             (the JAX package's native trellis encodes at q1/50/90/100 and
             12 sampling factors, its moz_0 at 1x3 and 2x4, its handler's
             CMYK with optimize off and on); the WebP
             codec's lossless round trip (exact); the VP8 decoder on every
             lossy fixture of tests/data/webp (written by libwebp) equal to
             the JAX package's decoded pixels and alpha, and the VP8
             encoder's q50/75/90 files of source.png and of its
             w_300,h_250,c_1 answer against the JAX package's (at most
             WEBP_BYTES_RATIO its bytes, at least its PSNR less
             WEBP_PSNR_LOSS_DB); then medians of calls: decode of a
             1920x1080 q90 JPEG at 8/8 and at the flagship hint's prescale,
             encode of a 300x250 answer with moz_1 and moz_0 (and nvJPEG's
             encodes of it, the library yardstick), its lossless
             WebP encode and decode, and the VP8 (q90) encode and decode of
             the 300x250 answer and of a 1920x1080 frame (host time), and
             the PNG decoder on a 1920x1080 frame whose every row is
             Paeth-filtered (host time), on one JSON line with the card's
             name and power limit; the gray, Adobe CMYK and YCCK fixtures
             (whole, and with subsampled components: h2v1, h2v2) and the
             RGB-coded one are decoded with the others (NVJPEG_LEVELS), and
             nvJPEG's own interleaved-RGB decode of the RGB-coded file is
             printed beside the port's plane decode of it.
11. resilience — the batcher's containment through the handler (banded):
             an 8-member w_300,h_250,c_1,smc_1 batch of seeded 1024x768
             PNGs with member POISONED failed by the fault injector
             (batcher.member): the 7 others answer the clean run's bits,
             it fails alone, K1 launches in (1, 7] and K2, K3 in [1, 7]
             (2 ceil(log2 8) + 1), it is quarantined, and resubmitted beside
             the 7 it runs alone (their launch of 7); with the fault cleared
             it answers the clean run's bits in a launch of 1. Then a real
             torch.OutOfMemoryError: the reserved peaks of w_1280 launches of
             8 and 4 2400x1600 members and of one 8000x5000 source are
             measured, and torch.cuda.set_per_process_memory_fraction is
             set between them (restored after): the 8 answer the clean
             run's bits through launches of 8 (out of memory), 4 and 4, the
             memory governor's ceiling is 4, nothing is quarantined, and the
             8000x5000 source through a server answers 503 with
             Retry-After.
12. pipeline — the batcher's in-flight window and self-healing (banded):
             a flagship wave (64 1024x768 frames, 8 seeded ones shifted, through
             BatchController.submit at once, launches of 8, then each
             answer's smart-crop scoring as aux groups and the crops) at
             pipeline_depth 1, 2, 2, 1: the same bits, the same K1-K3
             launches and launch sizes, 1 and 2 launches in flight at the
             peak, the wall times printed; a poison-class fault at
             batcher.drain on the second launch's readback, recovered by a
             bisection on its drain thread, every answer the clean wave's; a
             blocking fault at batcher.execute on the first transform: the
             request answers the clean bytes through the direct program on
             the card (wedged_fallbacks 1), its smart-crop submission
             replaces the executor (restarts: wedged 1) and the old thread
             exits when released; 16 JPEG requests through servers with the
             host stage pools on and off, byte-equal, every stage on its pool
             when on; the memory governor's per-member bytes learned from the
             cost ledger's measured peak capping 8 members at launches of 4
             under a budget of 4.5 members; an 8000x5000 JPEG header
             answering 413 under mem_max_source_pixels before any decode;
             the ledger's entries printed.
13. formats — GIF in and out, animated WebP, BMP, ICO and TIFF: every
             fixture of tests/data/gif, webp_anim and raster decodes to its
             PNGs (the JAX package's Pillow decode; read by codecs/png.py),
             and the port's GIF encodes of tests/data/gif/enc.f*.png hold
             the bars against the committed JAX encodes (frames, durations
             and loop equal; PSNR at least theirs less GIF_PSNR_LOSS_DB, at
             most GIF_BYTES_RATIO their bytes). Then through the server on
             the card (banded): a 16-frame 800x600 animation made on the card (written
             by the port's encoder) under w_200,o_gif, its bytes equal to
             encode_animation of its frames through run_plan one at a time
             and K1 launching at most twice (lone_flush); a transparent
             12-frame 480x360 one under w_300,h_250,c_1,o_gif (colour and
             alpha frames, at most twice each); an animated WebP fixture under
             o_gif and o_png,gf_3; a BMP, an ICO and a TIFF under
             w_300,h_250,c_1, each a JPEG (K16) within JPEG_ANSWER_PSNR of
             its PNG answer. Printed on one line with
             the card: host ms to decode and encode the 16-frame animation,
             K1's launches and frames a launch, and the animated request's
             timings (decode, device, encode).
14. jpeg   — the server on the card (banded) answers the URLs of
             tests/data/jpeg_enc/reference.json's "served" on its 300x250
             source (w_300,h_250,c_1,o_jpg: moz_1; ...,moz_0,sf_2x4;
             ...,clsp_CMYK,o_jpg) with the JAX handler's bytes, launching
             K16 and K17; then the encoder's time split (upload, kernel,
             coefficient readback, host writer, whole encode) for moz_1 and
             moz_0 at 300x250 and 1920x1080 beside nvJPEG's encode of the
             same frames, and the 300x250 trellis answer's bytes and PSNR
             against nvJPEG's moz_1 (both decoded by nvJPEG), on one JSON
             line with the card's name and power limit.

Launch counters are zeroed right before each main-path phase (4-9, 11-14)
and read right after; every kernel of the phase's path must have launched.
From phase 6 on, nvJPEG's encode is wrapped in a counter: a served JPEG
encode that reaches it fails the run (phases 10 and 14 time it directly as
the library yardstick).
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
H100_F32_UNFUSED = 33.5e12      # the same, one operation an instruction (no FMA)

PIXEL_TOL = 1                   # u8 levels
#: a JPEG answer of the server against its PNG answer of the same URL, dB
JPEG_ANSWER_PSNR = 30.0
#: a lossy WebP answer (q90, the default) against the same, dB
WEBP_ANSWER_PSNR = 30.0
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
RING_STEP_RTOL = 1e-5           # K15 against its plain version, one step
RING_RTOL = 1e-4                # the whole ring against the plain ring
#: tiled against untiled on the card (tests/test_parallel.py's bounds)
TILED_UNTILED_TOL = {"resample": 0.75, "rotate": 0.51, "blur": 1e-3,
                     "sharpen": 1e-3, "unsharp": 1e-3}

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
    """K4 against the previous K4 (csrc/rotate_prev.cu): the same bits, f32
    and u8; and against rotate_plain: within F32_TOL wherever the source
    position lies more than F32_TOL from the fill edge."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.ops.rotate import rotate_plain, rotate_sampled, rotate_sampled_prev

    got = rotate_sampled(x, degrees, background, geom)
    ref = rotate_plain(x, degrees, background, geom)
    prev = rotate_sampled_prev(x, degrees, background, geom)
    got_u8 = rotate_sampled(x, degrees, background, geom, out_u8=True)
    prev_u8 = rotate_sampled_prev(x, degrees, background, geom, out_u8=True)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"K4 {label}: shape {tuple(got.shape)}")
    check(torch.equal(got.view(torch.int32), prev.view(torch.int32))
          and torch.equal(got_u8, prev_u8), f"K4 {label}: not the previous K4's bits")
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
          f"the previous K4's bits (f32, u8), max diff {err} off the fill edge (bound "
          f"{F32_TOL}), {n_edge} values differ on it; {times}bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def k5_case(torch, label, x, kernel, mode, gain, threshold, out_u8, timed=True,
            halo=0):
    """K5 against its two-pass form (the same values: both sum the taps in
    the same order) and its plain version on the card: f32 within K5_TOL,
    u8 within PIXEL_TOL; values differ more only where the unsharp
    threshold lies within K5_KNIFE of |x - blur| (counted). ``halo``: the
    tiled form's input rows above and below."""
    import numpy as np
    import torch.nn.functional as F

    from flyimg_tpu_torch.ops.filters import (
        MODE_UNSHARP,
        k5_plan,
        separable_conv_plain,
        K5_TWO_PASS,
        k5_launch,
        separable_filter,
        unsharp_from_blurred,
    )
    from flyimg_tpu_torch.ops.resample import quantize_u8

    h_own = x.shape[1] - 2 * halo
    own = x[:, halo:halo + h_own]

    def plain():
        out = separable_conv_plain(x, kernel, halo)
        if mode == MODE_UNSHARP:
            out = unsharp_from_blurred(own, out, gain, threshold)
        return quantize_u8(out) if out_u8 else out

    got = separable_filter(x, kernel, mode, gain, threshold, out_u8, halo)
    two = k5_launch(x, kernel, K5_TWO_PASS, mode, gain, threshold, out_u8, halo)
    ref = plain()
    torch.cuda.synchronize()
    plan = k5_plan(x.shape[0], h_own, x.shape[2], int(kernel.shape[0]), halo, out_u8)
    check(torch.equal(got, two), f"K5 {label}: the {plan.form} form differs from the "
          "two-pass form")
    diff = (got.float() - ref.float()).abs()
    knife = torch.zeros_like(diff, dtype=torch.bool)
    if mode == MODE_UNSHARP:
        blurred = separable_conv_plain(x, kernel, halo)
        knife = ((own - blurred).abs() - float(np.float32(threshold * 255.0))).abs() < K5_KNIFE
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
    print(f"K5 {label}: {tuple(x.shape)} {k} taps halo {halo} mode {mode} "
          f"{'u8' if out_u8 else 'f32'}, {plan.form} form {plan.tile_h}x{plan.tile_w}, "
          f"equal to the two-pass form: max diff {err} (bound {tol}), "
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
    # non-white background; the 8192-wide bucket; tiles wholly outside the
    # valid region (which load nothing)
    def k4(label, x, deg, bg, valid=None):
        b, h, w, _ = x.shape
        valid = valid or [(h, w)] * b
        rows = []
        for th, tw in valid:
            rw, rh = rotated_bounds(tw, th, deg)
            rows.append([th, tw, rh, rw])
        geom = torch.tensor(rows, dtype=torch.float32, device=dev)
        k4_case(torch, label, x, deg, bg, geom, timed=False)
        return rows

    for deg in (0, 90, 180, 270, 0.5, 359.5, -15, 44.9, 45):
        k4(f"1x1 at {deg}", noise(2, 1, 1, 3), deg, None)
        k4(f"1 x 37 at {deg}", noise(2, 1, 37, 3), deg, (10, 200, 30))
        k4(f"valid < bucket at {deg}", smooth(3, 128, 160), deg, (51, 102, 153),
           [(111, 133), (97, 141), (5, 7)])
    k4("wide 8192 bucket at 5", smooth(2, 128, 8192), 5, None,
       [(100, 8000), (128, 8192)])
    from flyimg_tpu_torch.ops.rotate import k4_footprint, k4_plan

    rows = k4("tiles outside the valid region at 30", smooth(2, 600, 800), 30,
              (12, 34, 56), [(17, 23), (600, 800)])
    ow, oh = rotated_bounds(800, 600, 30)
    plan = k4_plan(2, (600, 800), (oh, ow), 30)
    n_tiles = -(-oh // 32) * -(-ow // 32)
    skipped = sum(k4_footprint(plan, 30, rows[0], (oh, ow), t // -(-ow // 32),
                               t % -(-ow // 32))[0] for t in range(n_tiles))
    check(skipped > 0, "K4: no tile lies wholly outside a 17x23 valid region")
    print(f"K4 tiles outside the valid region: {skipped} of {n_tiles} tiles of the "
          "17x23 member load nothing")

    # K5: 61 taps (blr_0x10; the two-pass form), an image narrower and
    # shorter than the taps (both forms),
    # threshold 0 and > 0, f32 and u8; the tap count where k5_plan switches
    # from the 2-D tile form to the two-pass form and one past it; sizes no
    # tile divides; the tiled form's halo (K // 2 and less, and an image
    # narrower than it); an unsharp knife-edge (two flat regions meeting)
    from flyimg_tpu_torch.ops.filters import k5_plan

    k61 = gaussian_kernel(0, 10)
    k5_case(torch, "61 taps", smooth(2, 300, 400), k61, MODE_BLUR, 1.0, 0.0,
            False, timed=False)
    k5_case(torch, "61 taps on 5x20", smooth(3, 5, 20), k61, MODE_BLUR, 1.0, 0.0,
            True, timed=False)
    k5_case(torch, "21 taps on 5x20", smooth(3, 5, 20), gaussian_kernel(10, 3.0),
            MODE_BLUR, 1.0, 0.0, True, timed=False)
    k5_case(torch, "1 wide, 5 taps", smooth(2, 40, 1), gaussian_kernel(2, 1),
            MODE_BLUR, 1.0, 0.0, False, timed=False)
    for thr in (0.0, 0.02):
        k5_case(torch, f"unsharp 2x1+1.5+{thr}", smooth(2, 200, 300),
                gaussian_kernel(2, 1), MODE_UNSHARP, 1.5, thr, False, timed=False)
        k5_case(torch, f"unsharp 0x3+0.8+{thr}, u8", smooth(2, 200, 300),
                gaussian_kernel(0, 3), MODE_UNSHARP, 0.8, thr, True, timed=False)
    last = max(k for k in range(1, 400, 2) if k5_plan(2, 60, 90, k, 0, False).form == "tile")
    for k in (last, last + 2):
        k5_case(torch, f"{k} taps (k5_plan's switch)", smooth(2, 60, 90),
                gaussian_kernel(k // 2, k / 6.0), MODE_BLUR, 1.0, 0.0, False,
                timed=False)
    for k in (3, 5, 13):
        k5_case(torch, f"{k} taps on 37x71", smooth(2, 37, 71), gaussian_kernel(k // 2, 1.0),
                MODE_UNSHARP, 1.3, 0.01, True, timed=False)
    k13 = gaussian_kernel(0, 2)
    for halo in (6, 3):
        k5_case(torch, f"halo {halo} of 13 taps", smooth(1, 97 + 2 * halo, 61), k13,
                MODE_UNSHARP, 1.2, 0.01, True, timed=False, halo=halo)
    k5_case(torch, "halo 6, 2 wide", smooth(1, 52, 2), k13, MODE_BLUR, 1.0, 0.0, False,
            timed=False, halo=6)
    yy = torch.arange(90, device=dev, dtype=torch.float32)[None, :, None, None]
    xx = torch.arange(130, device=dev, dtype=torch.float32)[None, None, :, None]
    step = torch.where((yy < 45) ^ (xx < 70), 60.0, 190.0).expand(2, 90, 130, 3).contiguous()
    for thr in (0.0, 0.065):
        k5_case(torch, f"unsharp knife-edge 0.25x0.25+8+{thr}", step,
                gaussian_kernel(0.25, 0.25), MODE_UNSHARP, 8.0, thr, True, timed=False)

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
    """Write ``synthetic_image(w, h, seed)`` as a PNG."""
    from flyimg_tpu_torch.codecs import png

    with open(path, "wb") as fh:
        fh.write(png.encode(synthetic_image(w, h, seed)))


def synthetic_image(w, h, seed):
    """Smooth seeded image with structure: colour gradients, a few soft
    skin-toned and saturated blobs, and a sharp-edged rectangle."""
    import numpy as np

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
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def phase_server(torch, dev, workdir, kernels):
    import urllib.request

    import numpy as np

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.entry import STAGED_OPTIONS as STAGED
    from flyimg_tpu_torch.ops.resample import set_kernel_mode
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread
    from flyimg_tpu_torch.service.handler import ImageHandler

    from flyimg_tpu_torch import codecs

    sizes = [(1920, 1080), (1303, 977), (512, 512)]
    sources, jpeg_sources = [], []
    for i in range(8):
        w, h = sizes[i % 3]
        path = os.path.join(workdir, f"src{i}_{w}x{h}.png")
        synthetic_png(path, w, h, seed=100 + i)
        sources.append(path)
        # the same image as a q90 4:2:0 JPEG from the package's own encoder
        path = os.path.join(workdir, f"src{i}_{w}x{h}.jpg")
        with open(path, "wb") as fh:
            fh.write(codecs.encode(synthetic_image(w, h, seed=100 + i), "jpg", quality=90,
                                   mozjpeg=False, sampling_factor="2x2", device=dev))
        jpeg_sources.append(path)
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
            if mode == "banded":
                wave = jpeg_wave(torch, dev, base, jpeg_sources, option_sets, kernels)
                for name, n in wave.items():
                    counts[mode][name] += n
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    set_kernel_mode("dense")
    return counts


def jpeg_wave(torch, dev, base, jpeg_sources, option_sets, kernels):
    """Phase 6's JPEG waves on a running (banded) server: JPEG sources, 16
    concurrent o_auto requests from a client that accepts WebP answered
    lossy image/webp, 16 o_webp,webpl_1 answered lossless image/webp and 16
    o_auto from a client that does not (Accept: */*) answered image/jpeg;
    then o_webp without webpl_1 answers lossy image/webp. Returns the kernel
    launches of the waves."""
    import urllib.request

    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.codecs import png

    def get(req):
        opts, src, accept = req
        request = urllib.request.Request(f"{base}/upload/{opts}/{src}",
                                         headers={"Accept": accept})
        with urllib.request.urlopen(request, timeout=300) as resp:
            return resp.status, dict(resp.headers), resp.read()

    counts = {}
    waves = (("", "image/webp,*/*", "image/webp", WEBP_ANSWER_PSNR),
             (",o_webp,webpl_1", "image/webp,*/*", "image/webp", None),
             ("", "*/*", "image/jpeg", JPEG_ANSWER_PSNR))
    for suffix, accept, mime, bound in waves:
        reqs = [(o + suffix, s, accept) for s in jpeg_sources for o in option_sets]
        reset_counts(kernels)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(get, reqs))
        wall = time.perf_counter() - t0
        wave = read_counts(kernels)
        for name, n in wave.items():
            counts[name] = counts.get(name, 0) + n
        label = f"{mime} answers to Accept: {accept}" + (f" ({suffix[1:]})" if suffix else "")
        print(f"server banded JPEG sources, {label}: {len(reqs)} concurrent "
              f"requests in {wall:.3f} s; kernel launches {wave}")
        for name in ("K1", "K2", "K3") + (("K16",) if mime == "image/jpeg" else ()):
            check(wave[name] > 0, f"JPEG wave ({label}): {name} never launched")
        worst = float("inf")
        for (opts, src, _), (status, headers, body) in zip(reqs, answers):
            check(status == 200, f"JPEG wave {opts} {src}: status {status}")
            check(headers.get("Content-Type") == mime,
                  f"JPEG wave {opts} ({accept}): content type {headers.get('Content-Type')}")
            got = codecs.decode(body, device=dev).rgb
            if "smc_1" not in opts:
                check(got.shape == (250, 300, 3), f"JPEG wave {opts}: {got.shape}")
            # the same URL answered as a PNG by the same server
            ref, _ = png.decode(get((opts.replace(",o_webp,webpl_1", "") + ",o_png", src,
                                     "*/*"))[2])
            check(got.shape == ref.shape, f"JPEG wave {opts} {src}: {got.shape} vs "
                  f"its PNG answer's {ref.shape}")
            worst = min(worst, psnr(got, ref))
        if bound is None:
            check(worst == float("inf"), f"JPEG wave ({label}): a lossless answer is not "
                  "its PNG answer")
            print(f"server banded JPEG wave: all {len(reqs)} {label} 200, equal to their "
                  "PNG answers")
        else:
            check(worst >= bound, f"JPEG wave ({label}): an answer is {worst:.2f} dB from "
                  f"its PNG answer (bound {bound})")
            print(f"server banded JPEG wave: all {len(reqs)} {label} 200, at least "
                  f"{worst:.2f} dB PSNR against their PNG answers (bound {bound})")
    status, headers, body = get((option_sets[0] + ",o_webp", jpeg_sources[0], "*/*"))
    check(status == 200 and headers.get("Content-Type") == "image/webp" and
          body[12:16] == b"VP8 ", f"JPEG wave: o_webp answered {status} "
          f"{headers.get('Content-Type')} {body[12:16]!r}, not a lossy image/webp")
    return counts


def psnr(a, b) -> float:
    """PSNR in dB of two u8 images (inf where they are equal)."""
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


# ---------------------------------------------------------------------------
# the codec layer (phase 10)

#: nvJPEG's decode against the JAX package's libjpeg-turbo decode of the
#: same file (tests/data/jpeg): most levels apart, and the share of values
#: more than 1 level apart (tests/test_torch_codecs_card.py holds the
#: same). nvJPEG's IDCT is not libjpeg's islow (this phase's readings on
#: an NVIDIA H100 80GB HBM3 at 700 W: 4 levels at most at full scale, 0.104
#: of values more than 1 apart at 4:2:0, 0.0072 at 4:4:4); the prescale is
#: a box mean of the full decode where libjpeg scales in the DCT domain
#: (2, 11 and 18 levels at most at 1/8, 1/4 and 1/2: the fixture's
#: one-pixel stripes and sharp block edges). The gray, Adobe CMYK and YCCK
#: fixtures read 1, 2 and 1 levels at most on that card (nvJPEG decodes
#: their planes; codecs/native_codec.py converts them as the JAX decode);
#: with subsampled components (h2v1, h2v2; planes upsampled as libjpeg
#: does) CMYK and YCCK read 2, and the RGB-coded file 1 (PR 17, call 1).
NVJPEG_LEVELS = {"q90_420": 4, "q90_444": 4, "q90_420_progressive": 4,
                 "q90_420_orient6": 4, "q90_420.s1": 4, "q90_420.s2": 12, "q90_420.s4": 20,
                 "q90_gray": 1, "q90_cmyk": 2, "q90_ycck": 1,
                 "q90_cmyk_h2v1": 2, "q90_cmyk_h2v2": 2, "q90_ycck_h2v2": 2,
                 "q90_rgb_adobe0": 1}
#: the JPEG fixtures phase 10 decodes at full scale (q90_420 also at 1/8,
#: 1/4 and 1/2)
JPEG_FIXTURES = ("q90_420", "q90_444", "q90_420_progressive", "q90_420_orient6",
                 "q90_gray", "q90_cmyk", "q90_ycck", "q90_cmyk_h2v1", "q90_cmyk_h2v2",
                 "q90_ycck_h2v2", "q90_rgb_adobe0")


def nvjpeg_rgbi(torch, data, dev):
    """nvJPEG's own interleaved-RGB decode of ``data`` ([h, w, 3] u8 on the
    host), whatever the file's colour layout: what nvJPEG does with an
    RGB-coded JPEG when asked for RGB."""
    import ctypes

    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.codecs import native_codec as nc

    lib = nc._nvjpeg()
    with torch.cuda.device(dev), nc._nv_session(lib, dev.index) as session:
        handle, state = session[:2]
        n, css = ctypes.c_int(), ctypes.c_int()
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        nc._nv_check(lib.nvjpegGetImageInfo(handle, data, len(data), ctypes.byref(n),
                                            ctypes.byref(css), widths, heights), "image info")
        out = torch.empty((heights[0], widths[0], 3), dtype=torch.uint8, device=dev)
        image = nc._NvjpegImage()
        image.channel[0], image.pitch[0] = out.data_ptr(), widths[0] * 3
        nc._nv_check(lib.nvjpegDecode(handle, state, data, len(data), nc._OUTPUT_RGBI,
                                      ctypes.byref(image), cuda_build.current_stream(dev.index)),
                     "decode")
        return out.cpu().numpy()
NVJPEG_SHARE_OVER_1 = 0.12


def bomb_header(data: bytes, width: int = 30000, height: int = 30000) -> bytes:
    """``data`` (a baseline JPEG) with its frame header declaring ``width``
    x ``height`` pixels."""
    import struct

    i = data.index(b"\xff\xc0")
    return data[:i + 5] + struct.pack(">HH", height, width) + data[i + 9:]


def paeth_png(rgb) -> bytes:
    """[h, w, 3] u8 as a PNG whose every row is Paeth-filtered (the filter
    the port's decoder unfilters byte by byte on the host)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = rgb.shape
    cur = rgb.reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros((1, w * 3), np.int16), cur[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), cur[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.hstack([np.full((h, 1), 4, np.uint8), ((cur - pred) & 0xFF).astype(np.uint8)])

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def phase_codecs(torch, dev, card):
    """Phase 10: nvJPEG's decode (the library yardstick) against the JAX
    package's fixtures, the WebP codec's round trip, and the codec layer's
    times (the port's own JPEG decoder's among them)."""
    import json as _json

    import numpy as np

    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.codecs import png

    data_dir = os.path.join(ROOT, "tests", "data", "jpeg")

    def read(name):
        with open(os.path.join(data_dir, name), "rb") as fh:
            return fh.read()

    from flyimg_tpu_torch.codecs.exif import apply_orientation, jpeg_orientation
    from flyimg_tpu_torch.codecs.native_codec import nvjpeg_decode

    seen = {}
    for name in JPEG_FIXTURES:
        for scale in (8, 1, 2, 4) if name == "q90_420" else (8,):
            # nvJPEG's own decode (no serving route: the library yardstick),
            # at the scale the hint picks, turned upright
            data = read(name + ".jpg")
            got = apply_orientation(nvjpeg_decode(data, scale, device=dev),
                                    jpeg_orientation(data))
            want, _ = png.decode(read(f"{name}.s{scale}.png"))
            key = name if scale == 8 else f"{name}.s{scale}"
            check(got.shape == want.shape, f"nvJPEG {key}: {got.shape} vs {want.shape}")
            diff = np.abs(got.astype(int) - want.astype(int))
            seen[key] = (int(diff.max()), float((diff > 1).mean()), float((diff > 0).mean()))
            check(seen[key][0] <= NVJPEG_LEVELS[key] and seen[key][1] <= NVJPEG_SHARE_OVER_1,
                  f"nvJPEG {key}: max {seen[key][0]} levels (bound {NVJPEG_LEVELS[key]}), "
                  f"{seen[key][1]:.4f} of values more than 1 apart (bound "
                  f"{NVJPEG_SHARE_OVER_1})")
    print("nvJPEG decode against the JAX package's (max levels, share of values more "
          "than 1 apart, share that differ at all): "
          + ", ".join(f"{k} {v[0]} {v[1]:.4f} {v[2]:.4f}" for k, v in seen.items()))
    # what nvJPEG itself makes of the RGB-coded file when asked for RGB (the
    # port decodes its planes as coded instead: jpeg_decode)
    want, _ = png.decode(read("q90_rgb_adobe0.s8.png"))
    rgbi = np.abs(nvjpeg_rgbi(torch, read("q90_rgb_adobe0.jpg"), dev).astype(int)
                  - want.astype(int))
    print(f"nvJPEG's own RGBI decode of q90_rgb_adobe0 against the JAX package's: max "
          f"{int(rgbi.max())} levels, {float((rgbi > 1).mean()):.4f} of values more than 1 "
          f"apart (the port's plane decode: max {seen['q90_rgb_adobe0'][0]}); card {card}")
    from flyimg_tpu_torch.exceptions import ExecFailedException

    try:
        codecs.decode(bomb_header(read("q90_444.jpg")), device=dev)
        check(False, "nvJPEG decoded a header declaring 30000 x 30000 pixels")
    except ExecFailedException as exc:
        check("decode limit" in str(exc), f"the pixel limit's message: {exc}")
    # the port's JPEG encodes (K16, K17 and the host writer) of
    # tests/data/jpeg_enc/source.png: every file there is the JAX package's
    # native encoder's (or its handler's CMYK) bytes
    enc_ref = _json.loads(jpeg_enc_file("reference.json"))
    enc_src, _ = png.decode(jpeg_enc_file("source.png"))
    for name, entry in enc_ref["files"].items():
        blob = jpeg_fixture_encode(entry, enc_src, dev)
        check(blob == jpeg_enc_file(name), f"JPEG encode {name}: {len(blob)} bytes, not the "
              f"JAX package's {entry['bytes']}")
    print(f"JPEG encodes: all {len(enc_ref['files'])} files of tests/data/jpeg_enc (trellis at "
          "q1/50/90/100 and 12 sampling factors, moz_0 at 1x3 and 2x4, CMYK with optimize "
          "off and on) byte-equal to the JAX package's")
    answer = synthetic_image(300, 250, seed=31)
    blob = codecs.encode(answer, "webp", webp_lossless=True)
    check(np.array_equal(codecs.decode(blob).rgb, answer), "WebP: the round trip is not exact")
    webp_fixtures(codecs, png, np)

    def median_ms(fn, n=21):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    photo = codecs.encode(synthetic_image(1920, 1080, seed=30), "jpg", quality=90,
                          mozjpeg=False, sampling_factor="2x2", device=dev)
    hint = (300, 250)
    check(codecs.decode(photo, target_hint=hint, device=dev).size == (960, 540),
          "the flagship hint's prescale of a 1920x1080 JPEG is not 960x540")
    times = {
        "decode_1920x1080_q90_s8_ms": median_ms(lambda: codecs.decode(photo, device=dev)),
        "decode_1920x1080_q90_s4_ms": median_ms(
            lambda: codecs.decode(photo, target_hint=hint, device=dev)),
        # four components, three upsampled by K19
        "decode_320x240_cmyk_h2v2_ms": median_ms(
            lambda: codecs.decode(read("q90_cmyk_h2v2.jpg"), device=dev)),
        # nvJPEG's decodes of the same files, the library yardstick
        "nvjpeg_decode_1920x1080_q90_s8_ms": median_ms(lambda: nvjpeg_decode(photo, 8, dev)),
        "nvjpeg_decode_1920x1080_q90_s4_ms": median_ms(lambda: nvjpeg_decode(photo, 4, dev)),
        "encode_300x250_jpg_moz1_ms": median_ms(
            lambda: codecs.encode(answer, "jpg", mozjpeg=True, device=dev)),
        "encode_300x250_jpg_moz0_ms": median_ms(
            lambda: codecs.encode(answer, "jpg", mozjpeg=False, device=dev)),
        # nvJPEG's encodes of the same frame, the library yardstick
        "encode_300x250_nvjpeg_moz1_ms": median_ms(
            lambda: NVJPEG_ENCODE(answer, 90, optimize=True, progressive=True, device=dev)),
        "encode_300x250_nvjpeg_moz0_ms": median_ms(
            lambda: NVJPEG_ENCODE(answer, 90, optimize=False, progressive=False, device=dev)),
        "encode_300x250_webp_lossless_ms": median_ms(
            lambda: codecs.encode(answer, "webp", webp_lossless=True)),
        "decode_300x250_webp_lossless_ms": median_ms(lambda: codecs.decode(blob)),
    }
    # VP8 (lossy WebP, q90 as the service's default) of the answer and of a
    # 1920x1080 frame: host time on this machine
    full = synthetic_image(1920, 1080, seed=30)
    # the PNG decoder's slowest filter (Paeth, byte by byte in Python) on a
    # 1920x1080 frame: host time
    paeth = paeth_png(full)
    check(np.array_equal(png.decode(paeth)[0], full), "the Paeth PNG does not decode")
    times["decode_1920x1080_png_paeth_ms"] = median_ms(lambda: png.decode(paeth), 3)
    lossy = {"300x250": codecs.encode(answer, "webp", quality=90),
             "1920x1080": codecs.encode(full, "webp", quality=90)}
    for size, px in (("300x250", answer), ("1920x1080", full)):
        n = 21 if size == "300x250" else 5
        times[f"encode_{size}_webp_q90_ms"] = median_ms(
            lambda: codecs.encode(px, "webp", quality=90), n)
        times[f"decode_{size}_webp_q90_ms"] = median_ms(
            lambda: codecs.decode(lossy[size]), n)
        check(psnr(codecs.decode(lossy[size]).rgb, px) >= WEBP_ANSWER_PSNR,
              f"VP8 q90 of the {size} frame: below {WEBP_ANSWER_PSNR} dB")
    sizes = {
        "jpg_moz1_bytes": len(codecs.encode(answer, "jpg", mozjpeg=True, device=dev)),
        "jpg_moz0_bytes": len(codecs.encode(answer, "jpg", mozjpeg=False, device=dev)),
        "nvjpeg_moz1_bytes": len(NVJPEG_ENCODE(answer, 90, optimize=True, progressive=True,
                                               device=dev)),
        "webp_bytes": len(codecs.encode(answer, "webp", webp_lossless=True)),
        "webp_q90_bytes": len(lossy["300x250"]),
        "webp_q90_1920x1080_bytes": len(lossy["1920x1080"]),
        "photo_jpg_bytes": len(photo),
    }
    print(json.dumps({"codecs": times, "sizes": sizes, "card": card}))
    return times


#: the port's VP8 encode against the JAX package's (libwebp's) of the same
#: pixels at the same quality (tests/data/webp/reference.json): at most
#: this many times its bytes, at least its PSNR less WEBP_PSNR_LOSS_DB
WEBP_BYTES_RATIO = 1.3
WEBP_PSNR_LOSS_DB = 0.75


def webp_fixtures(codecs, png, np):
    """Phase 10's WebP checks: every lossy fixture of tests/data/webp
    (libwebp's files) decodes to the JAX package's pixels exactly; the
    port's q50/75/90 encodes of source.png and of its w_300,h_250,c_1 answer
    against the JAX package's files' bytes and PSNR."""
    import json as _json

    data_dir = os.path.join(ROOT, "tests", "data", "webp")

    def read(name):
        with open(os.path.join(data_dir, name), "rb") as fh:
            return fh.read()

    names = sorted(f[:-5] for f in os.listdir(data_dir)
                   if f.endswith(".webp") and not f.startswith("jax_"))
    check(len(names) >= 60, f"WebP fixtures: only {len(names)} files")
    for name in names:
        got = codecs.decode(read(name + ".webp"))
        rgb, alpha = png.decode(read(name + ".png"))
        check(np.array_equal(got.rgb, rgb), f"VP8 decode of {name}: not libwebp's pixels")
        check((alpha is None and got.alpha is None) or
              (alpha is not None and got.alpha is not None and np.array_equal(got.alpha, alpha)),
              f"VP8 decode of {name}: not libwebp's alpha")
    print(f"VP8 decode: all {len(names)} WebP fixtures equal to the JAX package's pixels")
    ref = _json.loads(read("reference.json"))
    for tag in ("source", "answer"):
        px, _ = png.decode(read(ref["sources"][tag]))
        for q in (50, 75, 90):
            jax = ref["encodes"][f"{tag}_q{q}"]
            blob = codecs.encode(px, "webp", quality=q)
            got = psnr(codecs.decode(blob).rgb, px)
            print(f"VP8 {tag} q{q}: {len(blob)} bytes, PSNR {got:.4f} dB; the JAX package's "
                  f"{jax['bytes']} bytes, {jax['psnr']} dB")
            check(len(blob) <= WEBP_BYTES_RATIO * jax["bytes"],
                  f"VP8 {tag} q{q}: {len(blob)} bytes > {WEBP_BYTES_RATIO} x {jax['bytes']}")
            check(got >= jax["psnr"] - WEBP_PSNR_LOSS_DB,
                  f"VP8 {tag} q{q}: PSNR {got:.4f} < {jax['psnr']} - {WEBP_PSNR_LOSS_DB}")


# ---------------------------------------------------------------------------
# the face post-passes: K7 (pixelate), K8 (facefind masks), K9/K10 (BlazeFace)


def knife_region(torch, prob, thresholds, valid):
    """[B, h, w] bool: pixels within K8_RADIUS of a valid pixel whose
    probability lies within K8_KNIFE of its member's threshold."""
    import torch.nn.functional as F

    near = ((prob - thresholds[:, None, None]).abs() < K8_KNIFE) & valid
    k = 2 * K8_RADIUS + 1
    return F.max_pool2d(near.float()[:, None], k, 1, K8_RADIUS)[:, 0] > 0


def k7_case(torch, label, image, boxes, timed=False, factor=10):
    """K7 against its plain version: u8, exact. Timed: the single call by
    CUDA events and on the host clock (perf_counter, no sync), the plain
    version and F.avg_pool2d."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.ops.pixelate import pixelate_regions, pixelate_regions_u8
    from flyimg_tpu_torch.ops.resample import quantize_u8

    def kern():
        return pixelate_regions_u8(image, boxes, factor)

    def plain():
        return quantize_u8(pixelate_regions(image.float(), boxes, factor))

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = int((got.int() - ref.int()).abs().max())
    check(err == 0, f"K7 {label}: max diff {err} u8 (must be exact)")
    h, w, _ = image.shape
    inside = int((got != image).any(dim=2).sum())
    row = {"max_abs_err": float(err), "ms": None, "plain_ms": None,
           "library_ms": None}
    if timed:
        from flyimg_tpu_torch.face_breakdown import _host_us

        nchw = image.permute(2, 0, 1)[None].float().contiguous()
        row["ms"] = cuda_ms(torch, kern)
        row["host_us"] = _host_us(kern, 200)
        row["plain_ms"] = cuda_ms(torch, plain)
        row["library_ms"] = cuda_ms(
            torch, lambda: F.avg_pool2d(nchw, factor, factor, ceil_mode=True))
    # each pixel read once and written once, the boxes read once; ~4 flops
    # a value (3 adds of the block sum, the scale)
    row["bound_ms"], row["bound_by"] = bound_ms(
        2.0 * image.numel() + boxes.numel() * 4, 4.0 * image.numel())
    times = (f"; kernel {row['ms']:.4f} ms by events, {row['host_us']:.1f} us on "
             f"the host (no sync), plain {row['plain_ms']:.4f} ms, "
             f"F.avg_pool2d {row['library_ms']:.4f} ms" if timed else "")
    n_boxes = int((boxes[:, 2:] > 0).all(dim=1).sum())
    print(f"K7 {label}: [{h}, {w}, 3], factor {factor}, with {n_boxes} boxes of "
          f"nonzero area (of {boxes.shape[0]}), exact "
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
    before = _batched_face_masks.launches
    got = _batched_face_masks(images, in_true, thresholds, prob_out=prob)
    check(_batched_face_masks.launches - before == 1, f"K8 {label}: not one launch a call")
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
    every K9 and K10 call and the one K10-head call (over both anchor maps),
    each holding the plain twin's input."""
    from flyimg_tpu_torch.face_breakdown import forward_calls

    k9, k10, heads = forward_calls(model, views)
    return ([("K9", a) for a in k9] + [("K10", a) for a in k10]
            + [("K10-head", heads)])


def blazeface_rows(torch, model, views, timed=True):
    """K9, K10 and K10's head form at every layer of one forward over
    ``views``: each call against its plain twin (K9/K10 within BF_RTOL
    relative, the head's probabilities within BF_PROB_TOL and boxes within
    BF_BOX_TOL absolute, at each map's anchors); timed as the forward runs
    them (all of a kind's calls in a row), with bounds summed over the calls
    and F.conv2d yardsticks (the head's: one 1x1 F.conv2d a map)."""
    import torch.nn.functional as F

    from flyimg_tpu_torch.models import blazeface as bf

    calls = blazeface_layers(torch, model, views)
    n = views.shape[0]
    probs = torch.empty((n, bf.NUM_ANCHORS), device=views.device)
    boxes = torch.empty((n, bf.NUM_ANCHORS, 4), device=views.device)

    def head(maps):
        bf.head_decode(maps, model.anchors, probs, boxes)

    def head_ref(maps):
        refs = []
        for x, ck, cb, rk, rb, off in maps:
            cls, raw = bf.head_plain(x, ck, cb, rk, rb)
            k = cls.shape[1]
            refs.append((off, torch.sigmoid(cls),
                         bf.decode_boxes(raw, model.anchors[off:off + k])))
        return refs

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
            probs.fill_(float("nan"))
            boxes.fill_(float("nan"))
            head(args)
            refs = head_ref(args)
            torch.cuda.synchronize()
            for (off, p_ref, b_ref), (x, ck, _cb, rk, _rb, _o) in zip(refs, args):
                k = p_ref.shape[1]
                ep = float((probs[:, off:off + k] - p_ref).abs().max())
                eb = float((boxes[:, off:off + k] - b_ref).abs().max())
                check(ep <= BF_PROB_TOL and eb <= BF_BOX_TOL,
                      f"K10-head at anchor {off}: probs {ep}, boxes {eb} off")
                err[kind] = max(err[kind], ep)
                cout = ck.shape[3] + rk.shape[3]
                nbytes[kind] += 4.0 * (x.numel() + x.shape[3] * cout + cout
                                       + 5 * n * k + 4 * k)
                flops[kind] += 2.0 * x.numel() * cout
                w = torch.cat([ck, rk], dim=3)[0, 0].t()[:, :, None, None]
                lib_args[kind].append((x.permute(0, 3, 1, 2).contiguous(),
                                       w.contiguous(), None, 1))
            check(not bool(torch.isnan(probs).any() or torch.isnan(boxes).any()),
                  "K10-head left anchors unwritten")
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
        times = (f"; the forward's {count} call(s): kernel {row['ms']:.4f} ms, "
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
    for factor in (1, 32):
        for h, w in ((237, 311), (1080, 1920)):
            src = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
            edge = torch.tensor([[3, 5, 57, 41], [100, 100, 0, 10],
                                 [w - 20, h - 15, 100, 100], [10, 10, 30, 30],
                                 [0, 0, w, h / 2], [-5, -5, 12, 12]],
                                dtype=torch.float32, device=dev)
            k7_case(torch, f"{h}x{w} at factor {factor}", src, edge, factor=factor)
    # a row start off 16-byte alignment: a view one pixel into a larger image
    big = torch.from_numpy(rng.integers(0, 256, (1 + 480 * 641, 3), dtype=np.uint8)).to(dev)
    k7_case(torch, "an unaligned view", big[1:].view(480, 641, 3), torch.tensor(
        [[100, 50, 200, 150], [600, 400, 100, 100]], dtype=torch.float32, device=dev))

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
    # rows wider than one tile spans: cores of k8_plan's tile_cols with an
    # 8-pixel halo in x; valid sides off the tiles, straddling a tile edge
    # in y and in x
    plan = facefind.k8_plan(2, 100, 2200)
    check(plan.tiles_x > 1 and plan.tiles_y > 1, f"K8: {plan} cuts no rows into tiles")
    vh, vw = plan.tile_rows * 2 + 5, plan.tile_cols * 2 + 34
    wide = torch.from_numpy(np.stack([skin_ellipse_image(rng, 100, 2200, faces=12)
                                      for _ in range(2)]))
    k8_case(torch, f"rows cut into tiles ({plan.tiles_y} x {plan.tiles_x} a member), valid "
            f"sides straddling tile edges", wide.to(dev),
            torch.tensor([[vh, vw], [plan.tile_rows + 1, plan.tile_cols + 1]],
                         dtype=torch.float32, device=dev),
            torch.full((2,), facefind.DEFAULT_THRESHOLD, device=dev))

    # K9/K10 at every layer of the 64-view forward, then whole forwards
    model = bf.load_weights(bf.PACKAGED_WEIGHTS, dev)
    rows.update(blazeface_rows(torch, model, views))
    k10_per_layer(torch, model, views)
    k9_per_layer(torch, model, views)
    for n in (1, 3):
        blazeface_rows(torch, model, views[:n].contiguous(), timed=False)
    k10_edges(torch, dev, rng)
    k9_edges(torch, dev, rng)
    for n in (1, 3, 64):
        forward_case(torch, model, views[:n].contiguous(), f"N = {n}")
    return rows


def k10_per_layer(torch, model, views):
    """K10's 16 calls of the forward one by one: the single call by CUDA
    events and its device time (torch.profiler), beside its byte bound."""
    from flyimg_tpu_torch.face_breakdown import k10_layer_times
    from flyimg_tpu_torch.models import blazeface as bf

    layers = k10_layer_times(model, views, iters=20)
    for r in layers:
        plan = bf.k10_plan(r["n"], r["h"], r["w"], r["cin"], r["cout"], r["cin"],
                           r["stride"], bf._sm_count(views.device.index))
        print(f"K10 layer {r['layer']:2d}: n*h*w {r['pixels']:6d}, {r['cin']:2d} -> "
              f"{r['cout']:2d}, stride {r['stride']}: {r['ms']:.4f} ms by events, "
              f"{r['device_ms']:.4f} ms device; bound {r['bound_ms']:.5f} ms (bytes); "
              f"plan {tuple(plan)}")
    print(f"K10 layers summed: {sum(r['ms'] for r in layers):.4f} ms by events, "
          f"{sum(r['device_ms'] for r in layers):.4f} ms device, bound "
          f"{sum(r['bound_ms'] for r in layers):.5f} ms")


def k9_per_layer(torch, model, views):
    """K9's 17 calls of the forward one by one (events, device time, byte
    bound, plan), then the head form's one call over both maps."""
    from flyimg_tpu_torch.face_breakdown import head_times, k9_layer_times

    layers = k9_layer_times(model, views, iters=20)
    for r in layers:
        print(f"K9 layer {r['layer']}: [{r['n']}, {r['h']}, {r['w']}, {r['cin']}] -> "
              f"{r['cout']}, stride {r['stride']}: {r['ms']:.4f} ms by events, "
              f"{r['device_ms']:.4f} ms device, host {r['host_us']:.1f} us; bound "
              f"{r['bound_ms']:.5f} ms (bytes); plan {r['plan']}")
    print(f"K9 layers summed: {sum(r['ms'] for r in layers):.4f} ms by events, "
          f"{sum(r['device_ms'] for r in layers):.4f} ms device, bound "
          f"{sum(r['bound_ms'] for r in layers):.5f} ms")
    head = head_times(model, views, iters=20)
    check(head["launches"] == 1, f"K10-head: {head['launches']} launches a forward")
    print(f"K10-head over both maps: {head['launches']} launch, {head['ms']:.4f} ms by "
          f"events, {head['device_ms']:.4f} ms device, host {head['host_us']:.1f} us; "
          f"bound {head['bound_ms']:.5f} ms (bytes)")


def k9_edges(torch, dev, rng):
    """K9 on shapes its tiling could get wrong, within BF_RTOL of its plain
    version: odd heights and widths at stride 2, widths no run divides,
    C = 3 (the full form and a depthwise one), 42 (8-byte staging) and 96,
    a full form with C_in = 5, N = 1, one row, an input off 16-byte
    alignment: every instance of the kernel."""
    import numpy as np

    from flyimg_tpu_torch.models import blazeface as bf

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    cases = (  # n, h, w, cin, cout, stride, depthwise
        (1, 17, 17, 3, 24, 2, False), (3, 9, 13, 3, 24, 2, False),
        (2, 7, 5, 3, 24, 1, False), (1, 128, 128, 3, 24, 2, False),
        (2, 11, 13, 3, 3, 2, True), (1, 7, 9, 3, 3, 1, True),
        (3, 13, 11, 42, 42, 2, True), (2, 9, 19, 42, 42, 1, True),
        (1, 8, 8, 96, 96, 1, True), (1, 5, 3, 96, 96, 1, True),
        (2, 15, 15, 96, 96, 2, True), (1, 1, 1, 24, 24, 1, True),
        (5, 1, 37, 28, 28, 2, True), (1, 64, 64, 24, 24, 1, True),
        (7, 33, 31, 36, 36, 2, True), (1, 12, 12, 5, 12, 1, False),
        (2, 13, 11, 5, 12, 2, False),
    )
    for n, h, w, cin, cout, stride, dw in cases:
        x = rand(n, h, w, cin)
        kern = rand(5, 5, 1, cin) if dw else rand(5, 5, cin, cout) * 0.2
        bias = None if dw else rand(cout)
        got = bf.conv5x5(x, kern, bias, stride, not dw)
        ref = bf.conv5x5_plain(x, kern, bias, stride, not dw)
        torch.cuda.synchronize()
        e = rel_err(torch, got, ref)
        check(e <= BF_RTOL, f"K9 edge {n, h, w, cin, cout, stride, dw}: {e} off")
        plan = bf.k9_plan(n, h, w, cin, cout, stride, dw, bf._sm_count(dev.index))
        print(f"K9 edge n {n}, {h}x{w}, {cin} -> {cout}, stride {stride}, "
              f"{'depthwise' if dw else 'full'}: within {e:.2e} relative; "
              f"plan {tuple(plan)}")
    for cin, dw in ((24, True), (3, False)):
        base = rand(1 + 2 * 16 * 16 * cin)
        x = base[1:].view(2, 16, 16, cin)   # 4 bytes past an aligned start
        kern = rand(5, 5, 1, cin) if dw else rand(5, 5, cin, 24) * 0.2
        got = bf.conv5x5(x, kern, None, 2, False)
        ref = bf.conv5x5_plain(x, kern, None, 2, False)
        torch.cuda.synchronize()
        e = rel_err(torch, got, ref)
        check(e <= BF_RTOL, f"K9 edge, unaligned input C = {cin}: {e} off")
        print(f"K9 edge, an input 4 bytes off alignment, C = {cin}: "
              f"within {e:.2e} relative")


def k10_edges(torch, dev, rng):
    """K10 on shapes the tiling could get wrong, within BF_RTOL of its plain
    version: pixel counts no tile divides, channel counts no multiple of 4
    or 8 (4-byte staging, padded output channels), no residual, a stride-2
    width whose rows set the tile, and an input off 16-byte alignment."""
    import numpy as np

    from flyimg_tpu_torch.models import blazeface as bf

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    cases = (  # n, h, w, cin, cout, res_c, stride
        (3, 7, 5, 42, 42, 36, 1), (1, 1, 1, 24, 28, 24, 1), (2, 5, 7, 28, 44, 28, 2),
        (3, 9, 3, 30, 30, 30, 2), (5, 11, 13, 96, 96, 96, 1), (2, 3, 3, 88, 96, 88, 2),
        (1, 6, 6, 17, 20, 0, 1), (7, 19, 23, 24, 24, 24, 1),
    )
    for n, h, w, cin, cout, res_c, stride in cases:
        y = rand(n, h, w, cin)
        kern, bias = rand(1, 1, cin, cout) * 0.2, rand(cout)
        res = rand(n, stride * h, stride * w, res_c)
        got = bf.pointwise(y, kern, bias, res, stride)
        ref = bf.pointwise_plain(y, kern, bias, res, stride)
        torch.cuda.synchronize()
        e = rel_err(torch, got, ref)
        check(e <= BF_RTOL, f"K10 edge {n, h, w, cin, cout, res_c, stride}: {e} off")
        plan = bf.k10_plan(n, h, w, cin, cout, res_c, stride, bf._sm_count(dev.index))
        print(f"K10 edge n {n}, {h}x{w}, {cin} -> {cout}, residual {res_c}, stride "
              f"{stride}: within {e:.2e} relative; plan {tuple(plan)}")
    base = rand(1 + 3 * 8 * 8 * 32)
    y = base[1:].view(3, 8, 8, 32)   # 4 bytes past an aligned start
    kern, bias, res = rand(1, 1, 32, 40) * 0.2, rand(40), rand(3, 8, 8, 32)
    got = bf.pointwise(y, kern, bias, res, 1)
    ref = bf.pointwise_plain(y, kern, bias, res, 1)
    torch.cuda.synchronize()
    e = rel_err(torch, got, ref)
    check(e <= BF_RTOL, f"K10 edge, unaligned input: {e} off")
    print(f"K10 edge, an input 4 bytes off alignment: within {e:.2e} relative")


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
    5x5 convolution), K12 (every block's 1x1 and the four heads) and K13
    (flyimg_tpu_torch/train_breakdown.py backward_calls, and the heads'
    maps for K13)."""
    from flyimg_tpu_torch.train_breakdown import backward_calls

    calls = backward_calls(model, images, gen)
    heads = [(h[0].kernel, h[0].bias, h[1].kernel, h[1].bias) for h in model._heads()]
    maps = [a["y"] for _kind, layer, a in calls if layer.endswith("class")]
    return [(kind, a) for kind, _layer, a in calls] + [
        ("K13", dict(x16=maps[0], x8=maps[1], heads=tuple(heads)))]


def _rel_all(torch, got, ref):
    return max(rel_err(torch, a, b) for a, b in zip(got, ref) if b is not None)


def train_kernel_rows(torch, dev):
    """K11-K14 against their plain twins at the training shapes (batch
    TRAIN_BATCH, full width, a fresh model), each kind's calls timed in a
    row as the step runs them, with bounds summed over the calls and
    library yardsticks: cuDNN's conv2d_input/conv2d_weight (K11), the
    torch.matmul pair (K12), torch.optim.Adam(fused=True) (K14)."""
    from flyimg_tpu_torch import train_breakdown as tb
    from flyimg_tpu_torch.models import blazeface as bf
    from flyimg_tpu_torch.models import blazeface_train as bt

    model, (images, tp, tboxes, mask) = train_case(torch, dev, TRAIN_BATCH, 5)
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
            flops += tb.k11_flops(a)
            nbytes += tb.k11_bytes(a)
            lib11.append(tb.library_call("K11", a))

        def k11_lib():
            for fn in lib11:
                fn()

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
            flops += tb.k12_flops(a)
            nbytes += tb.k12_bytes(a)
            lib12.append(tb.library_call("K12", a))

        def k12_lib():
            for fn in lib12:
                fn()

        rows["K12"] = train_row(
            torch, "K12", len(k12), err, nbytes, flops,
            lambda: [bt.pointwise_backward(**a) for a in k12],
            lambda: [bt.pointwise_backward_plain(**a) for a in k12], k12_lib,
            "torch.matmul pair")

        # the same bits from run to run (no float atomics), and dx added
        # into a given gradient in one rounding
        for kind, fn, kind_calls in (("K11", bt.conv5x5_backward, k11),
                                     ("K12", bt.pointwise_backward, k12)):
            for a in kind_calls:
                first, again = fn(**a), fn(**a)
                check(all(torch.equal(u, v) for u, v in zip(first, again) if v is not None),
                      f"{kind}: two calls at {tuple(next(iter(a.values())).shape)} differ")
        for a in k11:
            if not a["need_dx"]:
                continue
            base = torch.randn(a["x"].shape, generator=gen, device=dev)
            into = bt.conv5x5_backward(**a, dx_into=base.clone())[0]
            check(torch.equal(into, base + bt.conv5x5_backward(**a)[0]),
                  f"K11 dx_into at {tuple(a['x'].shape)}: not dres + dx in one rounding")
            e = rel_err(torch, into, base + bt.conv5x5_backward_plain(**a)[0])
            check(e <= TRAIN_RTOL, f"K11 dx_into at {tuple(a['x'].shape)}: {e} relative off")
        print("K11 and K12: equal bits on repeated calls at every training shape; K11's "
              "dx_into equal to dres + dx")
        train_per_layer(torch, dev)

        # K13
        args = (k13["x16"], k13["x8"], k13["heads"], tp, tboxes, mask)
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
                        + 2 * tboxes.numel() + 1)
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


def train_per_layer(torch, dev):
    """K11's 17 and K12's 20 calls of the batch-16 step one by one
    (flyimg_tpu_torch/train_breakdown.py): events, the wrapper's host time,
    device time and launches a call, byte bound, the library call's events
    and device time, the plan; no call may take more than one launch."""
    from flyimg_tpu_torch.train_breakdown import layer_rows, summary

    rows = list(layer_rows(TRAIN_BATCH, 20, dev, card_line()))
    for r in rows:
        # a profiler window sometimes loses a kernel event: more than one
        # launch a call is what fails
        check(0 < r["launches"] <= 1, f"{r['kernel']} {r['layer']}: {r['launches']} launches "
              f"a call")
        plan = {k: v for k, v in r["plan"].items() if k not in ("smem_bytes", "partial_floats")}
        print(f"{r['kernel']} {r['layer']}: [{r['n']}, {r['h']}, {r['w']}, {r['cin']}] -> "
              f"{r['cout']} /{r['stride']}: {r['ms']:.4f} ms by events, {r['host_us']:.1f} us "
              f"host, {r['device_ms']:.4f} ms device in {r['launches']:g} launch; "
              f"bound {r['bound_ms']:.5f} ms; "
              f"{r['library']} {r['library_ms']:.4f} ms, {r['library_device_ms']:.4f} ms device; "
              f"plan {plan}")
    for kind, t in summary(rows).items():
        print(f"{kind} at batch {TRAIN_BATCH}, {t['calls']} calls summed: {t['ms']:.4f} ms by "
              f"events, {t['host_us']:.1f} us host, {t['device_ms']:.4f} ms device in "
              f"{t['launches']:g} launches, bound {t['bound_ms']:.5f} ms; library "
              f"{t['library_ms']:.4f} ms by events, {t['library_device_ms']:.4f} ms device")


def train_edges(torch, dev):
    """K11-K14 against their plain twins, not timed, on the shapes their
    chunking and tiling could get wrong: odd and unequal sizes at stride 1
    and 2 (every parity class), one member and 64, 1x1 inputs, channel
    counts that divide nothing, one chunk and many (two stages), the 96x96
    dW tile, pixel counts no tile divides, tied 2x2 windows of equal zeros
    and equal positives, a block's K12 then K11 adding into the residual's
    gradient, a head's strided gradient scaled and added into dy, K13 at
    one, three, 16 and 64 members (one launch a call, the same bits on a
    repeated call), K14 on a length no block divides."""
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
        for n, size, c, stride, w in ((1, 17, 5, 2, 17), (3, 9, 24, 1, 9), (2, 1, 7, 2, 1),
                                      (1, 2, 96, 2, 2), (2, 33, 28, 2, 33), (1, 6, 3, 1, 6),
                                      # K11's plans: many chunks of two stages, one chunk,
                                      # stride-2 parity classes on odd and unequal sides
                                      (64, 64, 24, 1, 64), (64, 8, 96, 1, 8), (1, 8, 96, 2, 8),
                                      (1, 11, 8, 2, 6), (3, 7, 42, 2, 13), (2, 13, 42, 1, 10)):
            x = randn(n, size, w, c)
            kern = randn(5, 5, 1, c, scale=0.2)
            y = bf.conv5x5_plain(x, kern, None, stride, False)
            a = dict(g=randn(*y.shape), x=x, kernel=kern, out=None, stride=stride,
                     has_bias=False, need_dx=True)
            worst["K11"] = max(worst["K11"], compare(
                f"K11 depthwise {n} x {size}x{w}x{c} /{stride}",
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
                                              (2, 4, 42, 48, 42, 2),
                                              # K12's plans: the 96x96 tile at batch 64
                                              # and 1, many chunks at 64x64, odd sides
                                              (64, 8, 96, 96, 96, 1), (1, 8, 96, 96, 96, 1),
                                              (64, 64, 24, 28, 24, 1), (1, 33, 42, 48, 42, 1),
                                              (3, 9, 7, 13, 7, 2)):
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
        # a block's backward as _Block chains it: K12, then K11 adding its
        # input gradient into K12's residual gradient, against the plain sum
        for n, size, cin, cout, stride in ((3, 16, 42, 48, 2), (2, 64, 24, 28, 1),
                                           (1, 10, 28, 32, 2)):
            x = torch.relu(randn(n, size, size, cin))
            dwk = randn(5, 5, 1, cin, scale=0.2)
            y = bf.conv5x5_plain(x, dwk, None, stride, False)
            kern, bias = randn(1, 1, cin, cout, scale=0.2), randn(cout, scale=0.1)
            out = bf.pointwise_plain(y, kern, bias, x, stride)
            g = randn(*out.shape)
            dy, _, _, dres = bt.pointwise_backward(g, y, kern, out, x, stride)
            got = bt.conv5x5_backward(dy, x, dwk, None, stride, dx_into=dres)[0]
            pdy, _, _, pdres = bt.pointwise_backward_plain(g, y, kern, out, x, stride)
            ref = pdres + bt.conv5x5_backward_plain(pdy, x, dwk, None, stride, False, True)[0]
            worst["K11"] = max(worst["K11"], compare(
                f"K12 then K11 into dres, {n} x {size}x{size}x{cin} /{stride}", [got], [ref],
                TRAIN_RTOL))
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
        for n in (1, 3, 16, 64):
            model, (images, tp, tb, mask) = train_case(torch, dev, n, 20 + n)
            maps = []
            x = bf.conv5x5_plain(images, model.stem.kernel, model.stem.bias, 2, True)
            for i, block in enumerate(model.blocks):
                x = block.forward_plain(x)
                if i == bf.X16_BLOCK:
                    maps.append(x)
            heads = tuple((c.kernel, c.bias, r.kernel, r.bias) for c, r, _ in model._heads())
            args = (maps[0], x, heads, tp, tb, mask)
            before = bt.head_loss.launches
            got, ref = bt.head_loss(*args), bt.head_loss_plain(*args)
            again = bt.head_loss(*args)
            check(bt.head_loss.launches - before == 2, f"K13 at N = {n}: not one launch a call")
            check(all(torch.equal(u, v) for u, v in zip(got, again)),
                  f"K13 at N = {n}: two calls differ")
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
    # K14 on a count that is not a multiple of 4 and on buffers off 16-byte
    # alignment, at one shared offset and at offsets that differ; each the
    # plain version's bits, nothing written outside its views
    for label, count, offsets in (("a count of 4k + 3", 10003, (0, 0, 0, 0)),
                                  ("buffers at a shared offset", 10003, (1, 1, 1, 1)),
                                  ("buffers at unequal offsets", 10002, (0, 1, 2, 3))):
        bufs = [randn(count + 4) for _ in range(4)]
        bufs[2], bufs[3] = bufs[2].abs() * 1e-3, bufs[3].abs() * 1e-6
        views = [t[o:o + count] for t, o in zip(bufs, offsets)]
        ref = [t.clone() for t in views]
        snap = [t.clone() for t in bufs]
        before = bt.adam_update.launches
        bt.adam_update(views[0], views[1], views[2], views[3], 3)
        bt.adam_update_plain(ref[0], ref[1], ref[2], ref[3], 3)
        check(bt.adam_update.launches - before == 1, f"K14, {label}: not one launch")
        check(all(torch.equal(u, v) for u, v in zip(views, ref)),
              f"K14, {label}: not the plain version's bits")
        check(all(torch.equal(t[:o], r[:o]) and torch.equal(t[o + count:], r[o + count:])
                  for t, r, o in zip(bufs, snap, offsets)),
              f"K14, {label}: wrote outside its views")
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


# ---------------------------------------------------------------------------
# spatial tiling: K15 (phase 3), the fold2d form (phase 3) and phase 9


def k15_case(torch, dev):
    """K15 against ring_rotate_step_plain at phase 9's shapes: rank 1 of 4
    visited by rank 2's tile of the 3840x2160 frame at -37 degrees (a middle
    step, timed), and the last step's u8 store over a coloured background."""
    from flyimg_tpu_torch.entry import TILED_HW, TILED_RANKS, tiled_frame
    from flyimg_tpu_torch.ops.rotate import (
        ring_geometry,
        ring_rotate_step,
        ring_rotate_step_plain,
    )
    from flyimg_tpu_torch.spec.plan import rotated_bounds

    h, w = TILED_HW
    n, deg = TILED_RANKS, -37.0 % 360.0
    rw, rh = rotated_bounds(w, h, deg)
    out_tile_h, tile_h = (rh + (-rh) % n) // n, h // n
    geom = ring_geometry((h, w), (rh, rw), deg)
    frame = tiled_frame(TILED_HW, 0, dev).to(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(15)
    acc0 = torch.rand((out_tile_h, rw, 3), generator=gen, device=dev) * 100.0
    r, k = 1, 2
    visit, src0, row0 = frame[k * tile_h:(k + 1) * tile_h], k * tile_h, r * out_tile_h
    got = ring_rotate_step(visit, src0, row0, acc0.clone(), geom)
    ref = ring_rotate_step_plain(visit, src0, row0, acc0.clone(), geom)
    last = ring_rotate_step(visit, src0, row0, acc0.clone(), geom, True, (10, 200, 30), True)
    last_ref = ring_rotate_step_plain(visit, src0, row0, acc0.clone(), geom, True,
                                      (10, 200, 30), True)
    torch.cuda.synchronize()
    err = rel_err(torch, got, ref)
    check(err <= RING_STEP_RTOL, f"K15: step off by {err:.2e} relative > {RING_STEP_RTOL}")
    u8_err = int((last.int() - last_ref.int()).abs().max())
    check(u8_err <= PIXEL_TOL, f"K15 last step u8: max diff {u8_err}")
    # what this step must move: the accumulator read and written where the
    # visiting tile owns a tap, and the visiting tile's rows those taps reach
    yo = torch.arange(out_tile_h, dtype=torch.float32, device=dev)[:, None] + row0
    xo = torch.arange(rw, dtype=torch.float32, device=dev)[None, :]
    dx, dy = xo - geom.cx_out, yo - geom.cy_out
    y0 = torch.floor(-geom.sin_t * dx + geom.cos_t * dy + geom.cy_in)
    taps = [torch.clamp(y, 0.0, geom.th - 1.0) - src0 for y in (y0, y0 + 1.0)]
    own = [(t >= 0) & (t < tile_h) for t in taps]
    n_own = float((own[0] | own[1]).sum())
    rows_read = int(torch.unique(torch.cat([t[o] for t, o in zip(taps, own)])).numel())
    nbytes = 24.0 * n_own + 12.0 * rows_read * w
    row = {"ms": None, "plain_ms": None, "library_ms": None, "max_abs_err": float(
        (got - ref).abs().max())}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 40.0 * out_tile_h * rw)
    acc = acc0.clone()
    row["ms"] = cuda_ms(torch, lambda: ring_rotate_step(visit, src0, row0, acc, geom))
    row["plain_ms"] = cuda_ms(
        torch, lambda: ring_rotate_step_plain(visit, src0, row0, acc, geom), iters=3)
    print(f"K15 ring step (rank {r} of {n}, tile {k}): visit {tuple(visit.shape)} -> acc "
          f"{tuple(acc0.shape)} at {deg} deg: {err:.2e} relative (bound "
          f"{RING_STEP_RTOL}), last step u8 max diff {u8_err}; {n_own:.0f} pixels own a "
          f"tap, {rows_read} source rows; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          "no library call computes a ring step")
    return row


def fold2d_case(torch, dev):
    """The dense resample's fold2d_bf16 form (bf16 operands, f32 products)
    against its f32 form at the flagship shape: u8 levels apart, times,
    and the products' bound. Not a kernel: both are library products."""
    from flyimg_tpu_torch.ops.resample import _apply_fold2d_bf16, quantize_u8, resample_matrix

    images, in_true, span_y, span_x, out_true = flagship_geometry(torch, 256, dev)
    x = images.to(torch.float32)
    b, h, w, c = x.shape
    oh, ow = 250, 300
    wy = resample_matrix(h, oh, span_y[:, 0], span_y[:, 1], out_true[:, 0], in_true[:, 0])
    wx = resample_matrix(w, ow, span_x[:, 0], span_x[:, 1], out_true[:, 1], in_true[:, 1])

    def f32():
        tmp = torch.matmul(wy, x.reshape(b, h, w * c))
        tmp = tmp.reshape(b, oh, w, c).permute(0, 2, 1, 3).reshape(b, w, oh * c)
        return torch.matmul(wx, tmp).reshape(b, ow, oh, c).permute(0, 2, 1, 3)

    got, ref = _apply_fold2d_bf16(x, wy, wx), f32()
    diff = (quantize_u8(got).int() - quantize_u8(ref).int()).abs()
    check(bool(torch.isfinite(got).all()), "fold2d_bf16: non-finite output")
    flops = 2.0 * b * (oh * h * w * c + ow * w * oh * c)
    t_bf16, t_f32 = cuda_ms(torch, lambda: _apply_fold2d_bf16(x, wy, wx)), cuda_ms(torch, f32)
    bound, by = bound_ms(4.0 * (x.numel() + wy.numel() + wx.numel() + got.numel()), flops)
    print(f"fold2d_bf16 (dense resample, {b} x {h}x{w} -> {oh}x{ow}): {int(diff.max())} u8 "
          f"levels from the f32 form ({int((diff > 0).sum())} of {diff.numel()} values "
          f"differ); fold2d {t_bf16:.4f} ms, f32 {t_f32:.4f} ms, bound {bound:.4f} ms ({by}, "
          "f32 products with TF32 off)")
    return {"fold2d_ms": t_bf16, "f32_ms": t_f32, "bound_ms": bound}


def _unsharp_knife(torch, frame, opts):
    """Values of ``opts``' unsharp whose |x - blur| lies within K5_KNIFE of
    the threshold (where K5 and its plain version may fall on either side)."""
    import numpy as np

    from flyimg_tpu_torch.ops.filters import gaussian_kernel, separable_conv_plain
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    plan = build_plan(OptionsBag(opts), frame.shape[1], frame.shape[0])
    if plan.unsharp is None:
        return None
    r, sg, _gain, thr = plan.unsharp
    x = frame.to(torch.float32)[None]
    blurred = separable_conv_plain(x, gaussian_kernel(r, sg))
    return (((x - blurred).abs() - float(np.float32(thr * 255.0))).abs() < K5_KNIFE)[0]


def tiled_hold(torch, label, opts, mesh, frame, mode=None, background=None):
    """One tiled op on ``mesh`` against the untiled op and against the
    tiled program on the kernels' plain versions, all on the card (f32)."""
    from flyimg_tpu_torch.entry import _tiled_plan, tiled_fn, untiled_fn

    hw = tuple(frame.shape[:2])
    op = _tiled_plan(opts, hw)[1]
    got = tiled_fn(opts, mesh, hw, False, mode, background=background)(frame)
    untiled = untiled_fn(opts, hw, False, mode, background)(frame)
    torch.cuda.synchronize()
    check(got.shape == untiled.shape,
          f"tiled {label} {opts}: {tuple(got.shape)} vs untiled {tuple(untiled.shape)}")
    check(bool(torch.isfinite(got).all()), f"tiled {label} {opts}: non-finite output")
    err_u = float((got - untiled).abs().max())
    check(err_u <= TILED_UNTILED_TOL[op],
          f"tiled {label} {opts}: {err_u} from untiled > {TILED_UNTILED_TOL[op]}")
    text = f"{err_u:.3g} from untiled (bound {TILED_UNTILED_TOL[op]})"
    if mode != "dense":
        plain = tiled_fn(opts, mesh, hw, False, mode, plain=True, background=background)(frame)
        if op == "rotate":
            err_p = rel_err(torch, got, plain)
            check(err_p <= RING_RTOL, f"tiled {label} {opts}: ring {err_p:.2e} relative "
                  f"from plain > {RING_RTOL}")
            text += f", {err_p:.2e} relative from the plain ring (bound {RING_RTOL})"
        else:
            tol = F32_TOL if op == "resample" else K5_TOL
            diff = (got - plain).abs()
            knife = _unsharp_knife(torch, frame, opts)
            n_knife = 0
            if knife is not None:
                n_knife = int((knife & (diff > tol)).sum())
                diff = diff.masked_fill(knife, 0.0)
            err_p = float(diff.max())
            check(err_p <= tol, f"tiled {label} {opts}: {err_p} from plain > {tol}")
            text += f", {err_p:.3g} from plain (bound {tol}; {n_knife} at the threshold)"
    print(f"tiled {label} {opts}{' ' + mode if mode else ''}: {tuple(frame.shape)} -> "
          f"{tuple(got.shape)}: {text}")
    return got


def tiled_server(torch, dev, workdir, mesh, label):
    """A server with ``mesh`` and one without answer the tall route's
    requests for a 3840x2160 PNG; the answers agree within 1 u8 level and
    the tiled handler's counters show the route."""
    import urllib.request

    import numpy as np

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.entry import TILED_HW
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread

    h, w = TILED_HW
    src = os.path.join(workdir, f"tall_{w}x{h}.png")
    if not os.path.exists(src):
        synthetic_png(src, w, h, seed=900)
    requests = (("w_256,o_png", (1, 0)), ("r_-37,o_png", (0, 1)),
                ("blr_0x2,o_png", (0, 1)), ("w_256,h_200,c_1,o_png", (0, 0)))
    answers = {}
    for name, sp_mesh in (("tiled", mesh), ("untiled", None)):
        params = AppParameters({
            "upload_dir": os.path.join(workdir, f"tall_{label}_{name}", "uploads"),
            "tmp_dir": os.path.join(workdir, f"tall_{label}_{name}", "tmp"),
            "resample_kernel": "banded",
        })
        server = make_server(params, device=dev, sp_mesh=sp_mesh)
        if sp_mesh is None:
            server.handler.sp_mesh = None
        thread = serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for opts, taken in requests:
                before = (server.handler.tiled_resamples, server.handler.tiled_single_ops)
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"{base}/upload/{opts}/{src}", timeout=300) as resp:
                    status, body = resp.status, resp.read()
                wall = time.perf_counter() - t0
                after = (server.handler.tiled_resamples, server.handler.tiled_single_ops)
                moved = (after[0] - before[0], after[1] - before[1])
                check(status == 200, f"server {name} {opts}: status {status}")
                want = taken if name == "tiled" else (0, 0)
                check(moved == want, f"server {name} {opts}: tiled counters moved "
                      f"{moved}, expected {want}")
                answers[(name, opts)] = (png.decode(body)[0], wall)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    for opts, taken in requests:
        got, t_tiled = answers[("tiled", opts)]
        ref, t_untiled = answers[("untiled", opts)]
        check(got.shape == ref.shape, f"server {opts}: {got.shape} vs {ref.shape}")
        diff = np.abs(got.astype(int) - ref.astype(int))
        check(int(diff.max()) <= PIXEL_TOL, f"server {opts}: tiled vs untiled "
              f"{int(diff.max())} u8")
        print(f"tiled server {label} {opts}: {got.shape}, {'tiled' if any(taken) else 'batcher'}"
              f" route, {int(diff.max())} u8 from the untiled server "
              f"({int((diff > 0).sum())} of {diff.size} values differ); wall {t_tiled:.3f} s "
              f"vs {t_untiled:.3f} s")


def tiled_bound(opts, mode, n, hw):
    """(ms, by) the card needs at least for one tiled op with u8 out: the
    extended tiles read once and the output written once (the resample,
    the filters, with the filters' K multiply-adds twice an element and the
    dense products' multiply-adds as operations), or for the ring the
    schedule's bytes: n steps of every rank reading the visiting tile and
    reading and writing its accumulator, then the output once."""
    from flyimg_tpu_torch.entry import _tiled_plan
    from flyimg_tpu_torch.ops.filters import gaussian_kernel
    from flyimg_tpu_torch.parallel.tiling import required_halo
    from flyimg_tpu_torch.spec.plan import rotated_bounds

    plan, op, out_hw = _tiled_plan(opts, hw)
    h, w = hw
    tile_h = -(-h // n)
    if op == "rotate":
        rw, rh = rotated_bounds(w, h, plan.rotate)
        per_step = 12.0 * (tile_h * w + 2 * -(-rh // n) * rw)
        return bound_ms(n * n * per_step + 3.0 * rh * rw, 0.0)
    if op == "resample":
        oh, ow = out_hw
        out_tile = -(-oh // n)
        rows = tile_h + 2 * required_halo(tile_h * n, out_tile * n, h, oh, n)
        if mode == "dense":
            flops = 2.0 * n * 3 * (out_tile * rows * w + ow * w * out_tile)
            return bound_ms(n * rows * w * 12.0 + 3.0 * oh * ow, flops)
        return bound_ms(n * rows * w * 3.0 + 3.0 * oh * ow, 0.0)
    k = len(gaussian_kernel(*(plan.blur if op == "blur" else getattr(plan, op)[:2])))
    return bound_ms(n * (tile_h + k - 1) * w * 12.0 + 3.0 * h * w, 4.0 * k * h * w * 3)


def tiled_mesh_checks(torch, frame, label, mesh):
    """Each of TILED_OPTIONS over ``mesh`` held by ``tiled_hold``, then its
    u8 form (the handler's) within PIXEL_TOL of the untiled op's and both
    timed, and (but for the dense form, which has no kernel) the tiled
    program on the kernels' plain versions: {(label, opts, mode): (tiled
    ms, untiled ms, plain ms or None, bound ms)}."""
    from flyimg_tpu_torch.entry import TILED_HW, TILED_OPTIONS, tiled_fn, untiled_fn

    print(f"tiled: mesh {label}: {[str(d) for d in mesh.devices]}")
    times = {}
    for opts in TILED_OPTIONS:
        for mode in (("dense", "banded") if opts.startswith("w_") else (None,)):
            tiled_hold(torch, label, opts, mesh, frame, mode)
            tiled_u8 = tiled_fn(opts, mesh, TILED_HW, True, mode)
            untiled_u8 = untiled_fn(opts, TILED_HW, True, mode)
            diff = (tiled_u8(frame).int() - untiled_u8(frame).int()).abs()
            check(int(diff.max()) <= PIXEL_TOL, f"tiled {label} {opts} u8: "
                  f"{int(diff.max())} levels from untiled")
            plain_ms = None
            if mode != "dense":
                plain_u8 = tiled_fn(opts, mesh, TILED_HW, True, mode, plain=True)
                plain_ms = cuda_ms(torch, lambda: plain_u8(frame), iters=3, warmup=1)
            bound, by = tiled_bound(opts, mode, len(mesh.devices), TILED_HW)
            key = (label, opts, mode)
            times[key] = (cuda_ms(torch, lambda: tiled_u8(frame), iters=5),
                          cuda_ms(torch, lambda: untiled_u8(frame), iters=5),
                          plain_ms, bound)
            print(f"tiled {label} {opts}{' ' + mode if mode else ''} u8: "
                  f"{int(diff.max())} level(s) from untiled on "
                  f"{int((diff > 0).sum())} values; tiled {times[key][0]:.4f} ms, "
                  f"untiled {times[key][1]:.4f} ms, plain "
                  + (f"{plain_ms:.4f} ms" if plain_ms is not None else "-")
                  + f", bound {bound:.4f} ms ({by})"
                  + (" (ranks one after another: the schedule's cost, not a "
                     "multi-card speed)" if label.startswith("virtual") else ""))
    return times


def phase_tiled(torch, dev, workdir):
    """Phase 9: the tall-input route on the card (see the module's doc)."""
    from flyimg_tpu_torch.entry import TILED_HW, TILED_RANKS, tiled_frame
    from flyimg_tpu_torch.parallel.mesh import make_mesh, virtual_mesh
    from flyimg_tpu_torch.parallel.tiling import TilingInfeasible, tiled_rotate, tiled_transform

    frame = tiled_frame(TILED_HW, 0, dev)
    meshes = [(f"virtual {TILED_RANKS} ranks on {dev}", virtual_mesh(TILED_RANKS, dev))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", make_mesh(axis_names=("sp",))))
    times = {}
    for label, mesh in meshes:
        times.update(tiled_mesh_checks(torch, frame, label, mesh))
    mesh = meshes[0][1]
    # not timed: other rank counts, an indivisible height, an infeasible
    # halo, quarter turns and a coloured background
    for n in (2, 8):
        for opts in ("w_256", "blr_0x2", "r_-37"):
            tiled_hold(torch, f"{n} ranks", opts, virtual_mesh(n, dev), frame,
                       "banded" if opts == "w_256" else None)
    odd = tiled_frame((2161, 1440), 1, dev)
    for opts in ("w_256", "unsh_0.25x0.25+8+0.065", "r_-37"):
        tiled_hold(torch, "2161 rows", opts, mesh, odd, "banded" if opts == "w_256" else None)
    try:
        tiled_transform(torch.zeros((4001, 64, 3), dtype=torch.uint8, device=dev),
                        (33, 64), virtual_mesh(8, dev))
        check(False, "tiled: an infeasible halo did not raise")
    except TilingInfeasible as exc:
        print(f"tiled: infeasible halo raises: {exc}")
    check(tiled_rotate(odd, 0.0, mesh) is odd, "tiled: 0 degrees is not the identity")
    for opts in ("r_90", "r_180", "r_-37"):
        tiled_hold(torch, "background (10, 200, 30)", opts, mesh, odd,
                   background=(10, 200, 30))
    for label, mesh in meshes:
        tiled_server(torch, dev, workdir, mesh, label.split()[0])
    return times


def tiled_only(torch) -> int:
    """``--tiled-only``: phase 9's per-mesh checks and timings on a mesh over
    every visible card and on a virtual mesh of as many ranks on card 0,
    then the server with the all-card mesh (the four-card run)."""
    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.device import resolve_device
    from flyimg_tpu_torch.entry import TILED_HW, tiled_frame
    from flyimg_tpu_torch.parallel.mesh import make_mesh, virtual_mesh

    dev = resolve_device("cuda:0")
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s; {n} card(s); peer access from "
          f"cuda:0: {[torch.cuda.can_device_access_peer(0, i) for i in range(1, n)]}")
    frame = tiled_frame(TILED_HW, 0, dev)
    mesh = make_mesh(axis_names=("sp",))
    times = tiled_mesh_checks(torch, frame, f"{n} cards", mesh)
    times.update(tiled_mesh_checks(torch, frame, f"virtual {n} ranks on {dev}",
                                   virtual_mesh(n, dev)))
    workdir = os.path.join(ROOT, "build", "chip_smoke_tiled")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        tiled_server(torch, dev, workdir, mesh, f"{n}-card")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("tiled ms (tiled, untiled; u8 out): " + "; ".join(
        f"{label} {opts}{' ' + mode if mode else ''} {t[0]:.4f}, {t[1]:.4f}"
        for (label, opts, mode), t in times.items()))
    print(card_line())
    return 0



# ---------------------------------------------------------------------------
# batch isolation and out-of-memory recovery (phase 11)

#: the poisoned member of phase 11's flagship batch, and its marker pixel
POISONED = 5
POISON_MARKER = (255, 0, 255)


def _answers(handler, opts, sources):
    """``handler.process_image(opts, src)`` for every source at once, one
    thread each: ("ok", decoded pixels) or ("error", the exception)."""
    from flyimg_tpu_torch.codecs import png

    def one(src):
        try:
            return "ok", png.decode(handler.process_image(opts, src).content)[0]
        except Exception as exc:
            return "error", exc

    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(one, sources))


def _peak_reserved(torch, dev, fn):
    """The device memory ``fn()`` reserves beyond what is reserved before it
    (the caching allocator's cache emptied first), and its result."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_reserved(dev) - before, out


def phase_resilience(torch, dev, card, workdir, kernels):
    """Phase 11: the batcher's containment on the card. An 8-member flagship
    batch with one member failed by the fault injector, against a clean
    run; then a real out-of-memory under a lowered per-process memory
    fraction, against a clean run."""
    import urllib.error
    import urllib.request

    import numpy as np

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.exceptions import ExecFailedException
    from flyimg_tpu_torch.ops.resample import set_kernel_mode
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.runtime.memgovernor import MemoryGovernor
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread
    from flyimg_tpu_torch.service.handler import ImageHandler
    from flyimg_tpu_torch.testing import faults

    t_phase = time.perf_counter()
    set_kernel_mode("banded")
    tags = iter(range(100))

    def handler(batcher):
        root = os.path.join(workdir, f"r{next(tags)}")
        return ImageHandler(AppParameters({"upload_dir": os.path.join(root, "u"),
                                           "tmp_dir": os.path.join(root, "t")}),
                            device=dev, batcher=batcher)

    def batcher(**kw):
        return BatchController(device=dev, max_batch=8, deadline_ms=1000.0,
                               lone_flush=False, quarantine_ttl_s=300.0, **kw)

    def write(name, img):
        path = os.path.join(workdir, name)
        with open(path, "wb") as fh:
            fh.write(png.encode(img))
        return path

    # -- a poisoned member of the flagship batch ---------------------------
    flagship = "w_300,h_250,c_1,smc_1"
    sources = []
    for i in range(8):
        img = synthetic_image(1024, 768, seed=300 + i)
        if i == POISONED:
            img[0, 0] = POISON_MARKER
        sources.append(write(f"flagship{i}.png", img))
    clean_b = batcher()
    try:
        clean = _answers(handler(clean_b), flagship, sources)
    finally:
        clean_b.close()
    check(all(kind == "ok" for kind, _ in clean), f"the clean run failed: {clean}")
    check([n for _k, n, _b in clean_b.launch_log if _k == "transform"] == [8],
          f"the clean run was not one launch of 8: {list(clean_b.launch_log)}")

    def is_poison(image=None, **_ctx):
        return getattr(image, "ndim", 0) == 3 and bool(np.all(image[0, 0] == POISON_MARKER))

    injector = faults.install(faults.FaultInjector())
    injector.plan("batcher.member", faults.poison_member(
        is_poison, lambda: ValueError("poison member (phase 11's fault plan)")))
    poisoned_b = batcher()
    try:
        h = handler(poisoned_b)
        before = read_counts(kernels)
        t0 = time.perf_counter()
        got = _answers(h, flagship, sources)
        wall = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in read_counts(kernels).items()}
        transforms = [n for k, n, _b in poisoned_b.launch_log if k == "transform"]
        for i, ((kind, out), (_c, want)) in enumerate(zip(got, clean)):
            if i == POISONED:
                check(kind == "error" and isinstance(out, ExecFailedException)
                      and "poison member" in str(out),
                      f"the poisoned member answered {kind}: {out}")
            else:
                check(kind == "ok", f"member {i} failed beside the poisoned one: {out}")
                check(out.shape == want.shape and np.array_equal(out, want),
                      f"member {i}: not the clean run's bits")
        bound = 2 * 3 + 1           # 2·ceil(log2 8) + 1
        check(1 < counts["K1"] <= bound and 1 <= counts["K2"] <= bound
              and 1 <= counts["K3"] <= bound,
              f"bisection launches {counts} outside (1, {bound}]")
        check(len(transforms) <= bound, f"transform launches {transforms} > {bound}")
        check(poisoned_b.stats["poison_isolated"] == 1 and len(poisoned_b.quarantine) == 1,
              f"quarantine {len(poisoned_b.quarantine)}, stats {poisoned_b.stats}")
        print(f"resilience poison: 7 of 8 answers equal the clean run's bits, member "
              f"{POISONED} failed alone in {wall:.3f} s; transform launches {transforms} "
              f"(clean: [8]); kernel launches K1 {counts['K1']}, K2 {counts['K2']}, K3 "
              f"{counts['K3']} (bound {bound}); batcher.member fired "
              f"{injector.fired['batcher.member']} times; quarantine "
              f"{len(poisoned_b.quarantine)}; card {card}")
        # a second submission of the quarantined member runs alone
        # (it fails at assembly, alone: no launch of its own, no bisection)
        log0 = len(poisoned_b.launch_log)
        again = _answers(h, flagship + ",rf_1", sources)
        later = [n for k, n, _b in list(poisoned_b.launch_log)[log0:] if k == "transform"]
        check(poisoned_b.stats["quarantine_hits"] == 1 and later == [7]
              and poisoned_b.stats["poison_isolated"] == 2,
              f"the resubmission: transform launches {later}, stats {poisoned_b.stats}")
        check(again[POISONED][0] == "error" and all(
            k == "ok" and np.array_equal(o, c[1])
            for i, ((k, o), c) in enumerate(zip(again, clean)) if i != POISONED),
            "the resubmitted batch did not answer as before")
        faults.clear()
        alone = _answers(h, flagship + ",rf_1", [sources[POISONED]])[0]
        check(alone[0] == "ok" and np.array_equal(alone[1], clean[POISONED][1])
              and list(poisoned_b.launch_log)[-2:][0][:2] == ("transform", 1),
              f"the quarantined member alone, fault cleared: {alone[0]}, "
              f"{list(poisoned_b.launch_log)[-2:]}")
        print(f"resilience quarantine: resubmitted beside 7 others it ran alone (the others "
              f"one launch of {later[0]}); with the fault cleared it answered the clean "
              "run's bits in a launch of 1")
    finally:
        faults.clear()
        poisoned_b.close()

    # -- a real out-of-memory ------------------------------------------------
    fit = "w_1280,o_png"
    members = []
    for i in range(8):
        small = synthetic_image(1200, 800, seed=400 + i)
        members.append(write(f"oom{i}.png", np.repeat(np.repeat(small, 2, 0), 2, 1)))
    big = write("oom_big.png", np.repeat(np.repeat(synthetic_image(1000, 625, seed=499),
                                                   8, 0), 8, 1))    # 8000 x 5000
    base_b = batcher()
    try:
        h = handler(base_b)
        peak8, clean = _peak_reserved(torch, dev, lambda: _answers(h, fit, members))
        peak4, _ = _peak_reserved(torch, dev, lambda: _answers(h, fit + ",rf_1", members[:4]))
        peak_big, single = _peak_reserved(torch, dev, lambda: _answers(h, fit, [big]))
    finally:
        base_b.close()
    check(all(k == "ok" for k, _ in clean + single), "the clean w_1280 runs failed")
    check([n for k, n, _b in base_b.launch_log][:2] == [8, 4],
          f"the clean w_1280 launches: {list(base_b.launch_log)}")
    top = min(peak8, peak_big)
    check(peak4 < 0.8 * top, f"4 members ({peak4} B) and 8 ({peak8} B) or the large "
          f"single source ({peak_big} B) cannot be told apart")
    budget = (peak4 + top) // 2
    total = torch.cuda.get_device_properties(dev).total_memory
    governor = MemoryGovernor(enabled=True)
    oom_b = batcher(governor=governor)
    server = None
    try:
        h = handler(oom_b)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        limit = torch.cuda.memory_reserved(dev) + budget
        torch.cuda.set_per_process_memory_fraction(limit / total, dev)
        t0 = time.perf_counter()
        got = _answers(h, fit, members)
        wall = time.perf_counter() - t0
        launches = list(oom_b.launch_log)
        for i, ((kind, out), (_c, want)) in enumerate(zip(got, clean)):
            check(kind == "ok" and np.array_equal(out, want),
                  f"out-of-memory member {i}: {kind} {out if kind == 'error' else ''} "
                  f"(launches {launches}, limit {limit} B reserved, peaks 8: {peak8}, "
                  f"4: {peak4}, 8000x5000: {peak_big}; now allocated "
                  f"{torch.cuda.memory_allocated(dev)}, reserved "
                  f"{torch.cuda.memory_reserved(dev)})")
        snap = governor.snapshot()
        (ceiling,) = snap["ceilings"].values() if len(snap["ceilings"]) == 1 else (None,)
        check(snap["oom_launches_total"] >= 1 and ceiling is not None
              and ceiling["cap_members"] == 4,
              f"the governor after the out-of-memory: {snap}")
        check(len(oom_b.quarantine) == 0 and oom_b.stats["poison_isolated"] == 0,
              "an out-of-memory member was quarantined")
        check([n for _k, n, _b in launches] == [8, 4, 4],
              f"out-of-memory launches {launches}")
        # a single member that still does not fit: 503 with Retry-After
        server = make_server(AppParameters({
            "upload_dir": os.path.join(workdir, "oom_server", "u"),
            "tmp_dir": os.path.join(workdir, "oom_server", "t"),
            "resample_kernel": "banded", "mem_governor_enable": True,
        }), device=dev)
        thread = serve_in_thread(server)
        url = f"http://127.0.0.1:{server.server_address[1]}/upload/{fit}/{big}"
        try:
            urllib.request.urlopen(url, timeout=300)
            check(False, "the large single source answered 200 under the memory limit")
        except urllib.error.HTTPError as exc:
            status, retry_after, body = exc.code, exc.headers.get("Retry-After"), exc.read()
        check(status == 503 and retry_after == "1" and b"memory exhausted" in body,
              f"the large single source: {status}, Retry-After {retry_after}, {body[:200]}")
        check(len(server.batcher.quarantine) == 0, "the large single source was quarantined")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()
        oom_b.close()
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    set_kernel_mode("dense")
    print(f"resilience out-of-memory: device memory limited to {limit / 2**20:.1f} MiB "
          f"reserved (fraction {limit / total:.6f}; a launch of 8 reserved "
          f"{peak8 / 2**20:.1f} MiB, of 4 {peak4 / 2**20:.1f} MiB, the 8000x5000 source "
          f"{peak_big / 2**20:.1f} MiB): 8 members answered the clean run's bits in "
          f"{wall:.3f} s through launches {[n for _k, n, _b in launches]}, ceiling "
          f"{ceiling['cap_members']}, nothing quarantined; the 8000x5000 source alone "
          f"answered 503, Retry-After {retry_after}; card {card}")
    print(f"resilience phase: {time.perf_counter() - t_phase:.3f} s")


# ---------------------------------------------------------------------------
# the in-flight window, self-healing, host stages, ledger and guards (phase 12)

#: phase 12's flagship wave: members of 1024x768, launches of 8
WAVE_MEMBERS = 64
WAVE_BATCH = 8


def flagship_wave(torch, dev, frames, depth, kernels, drain_plan=None):
    """One flagship wave through a BatchController at ``pipeline_depth``:
    every frame's w_300,h_250,c_1,smc_1 transform submitted at once
    (launches of WAVE_BATCH, none before it is full), then every answer's
    smart-crop scoring as aux groups, then the crops, as the handler runs
    them. Returns (answers, wall s, K1-K3 launches, the controller)."""
    from functools import partial

    from flyimg_tpu_torch.models import smartcrop
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    h, w = frames[0].shape[:2]
    plan = build_plan(OptionsBag("w_300,h_250,c_1,smc_1"), w, h)
    runner = partial(smartcrop.find_best_crops_batched, device=dev)
    ctl = BatchController(device=dev, max_batch=WAVE_BATCH, deadline_ms=60_000.0,
                          lone_flush=False, pipeline_depth=depth)
    try:
        before = read_counts(kernels)
        t0 = time.perf_counter()
        outs = [f.result(timeout=300) for f in [ctl.submit(fr, plan) for fr in frames]]
        ctl.transform_wall = time.perf_counter() - t0
        items = [smartcrop.prepare_work(o) for o in outs]
        crops = [f.result(timeout=300) for f in [
            ctl.submit_aux(("smc", it.bucket, it.step), it, runner) for it in items]]
        answers = [smartcrop.apply_crop(o, c) for o, c in zip(outs, crops)]
        wall = time.perf_counter() - t0
        after = read_counts(kernels)
    finally:
        ctl.close()
    return answers, wall, {k: after[k] - before[k] for k in ("K1", "K2", "K3")}, ctl


def phase_pipeline(torch, dev, card, workdir, kernels):
    """Phase 12: the batcher's in-flight window at depth 1 and 2, a
    drain-side failure, a wedged executor answered by the direct program and
    replaced, the host stage pools on and off, the memory governor's learned
    per-member bytes, and the source pixel guard."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import native_codec, png
    from flyimg_tpu_torch.ops.resample import set_kernel_mode
    from flyimg_tpu_torch.runtime import costledger
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.runtime.memgovernor import MemoryGovernor
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread
    from flyimg_tpu_torch.service.handler import ImageHandler
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan
    from flyimg_tpu_torch.testing import faults

    t_phase = time.perf_counter()
    set_kernel_mode("banded")
    # 8 seeded frames (each takes ~1 s to make), the rest shifted copies
    bases = [synthetic_image(1024, 768, seed=500 + i) for i in range(8)]
    frames = [np.roll(bases[i % 8], 97 * (i // 8), axis=(0, 1)) for i in range(WAVE_MEMBERS)]

    # -- the flagship wave at depth 1 and 2 ------------------------------------
    flagship_wave(torch, dev, frames, 2, kernels)        # warm: kernels, pinned pool
    runs = {1: [], 2: []}
    for depth in (1, 2, 2, 1):
        answers, wall, counts, ctl = flagship_wave(torch, dev, frames, depth, kernels)
        runs[depth].append((answers, wall, counts, ctl.inflight_peak,
                            sorted(ctl.launch_log), ctl.transform_wall))
    clean = runs[1][0][0]
    for depth, rows in runs.items():
        for answers, _wall, counts, peak, log, _tw in rows:
            check(all(np.array_equal(a, b) for a, b in zip(answers, clean)),
                  f"depth {depth}: the flagship answers differ from depth 1's")
            check(counts == runs[1][0][2], f"depth {depth}: K1-K3 launches {counts} vs "
                  f"depth 1's {runs[1][0][2]}")
            check(log == runs[1][0][4], f"depth {depth}: launches {log}")
            check(peak == depth, f"depth {depth}: {peak} launches in flight at the peak")
    walls = {d: [r[1] for r in rows] for d, rows in runs.items()}
    tws = {d: [r[5] for r in rows] for d, rows in runs.items()}
    print(f"pipeline: a flagship wave of {WAVE_MEMBERS} 1024x768 members (launches of "
          f"{WAVE_BATCH}, then the smart-crop aux groups), order 1, 2, 2, 1: wall s at "
          f"depth 1 {walls[1][0]:.4f}, {walls[1][1]:.4f}; depth 2 {walls[2][0]:.4f}, "
          f"{walls[2][1]:.4f}; of which the transform launches at depth 1 "
          f"{tws[1][0]:.4f}, {tws[1][1]:.4f}; depth 2 {tws[2][0]:.4f}, {tws[2][1]:.4f}; "
          f"the same bits; K1-K3 launches {runs[1][0][2]} at both; in flight at the "
          f"peak 1 and 2; card {card}")

    # -- a drain-side failure, contained on the drain thread -------------------
    seen = []

    def once(key=None, **_ctx):
        if key and key[0] == "aux":
            return faults.PASS
        seen.append(threading.current_thread().name)
        if len(seen) == 2:
            raise ValueError("readback poison (phase 12's fault plan)")
        return faults.PASS

    faults.install(faults.FaultInjector()).plan("batcher.drain", once)
    try:
        answers, wall, counts, ctl = flagship_wave(torch, dev, frames[:16], 2, kernels)
    finally:
        faults.clear()
    transforms = [n for k, n, _b in ctl.launch_log if k == "transform"]
    check(all(np.array_equal(a, b) for a, b in zip(answers, clean[:16])),
          "the drain-side failure: an answer differs from the clean wave's")
    check(set(seen) == {"flyimg-torch-batcher-drain"} and sorted(transforms) == [4, 4, 8, 8]
          and ctl.stats["poison_isolated"] == 0,
          f"the drain-side failure: drains on {set(seen)}, launches {transforms}, "
          f"stats {ctl.stats}")
    print(f"pipeline drain fault: the second launch's readback failed on its drain thread "
          f"and was bisected there (transform launches {transforms}); all 16 answers equal "
          f"the clean wave's in {wall:.3f} s; K1-K3 launches {counts}")

    # -- a wedged executor: the direct program answers, the next submit heals --
    src = os.path.join(workdir, "wedge.png")
    with open(src, "wb") as fh:
        fh.write(png.encode(frames[0]))
    flagship = "w_300,h_250,c_1,smc_1"

    def handler(name, ctl, **extra):
        conf = {"upload_dir": os.path.join(workdir, name, "u"),
                "tmp_dir": os.path.join(workdir, name, "t")}
        conf.update(extra)
        return ImageHandler(AppParameters(conf), device=dev, batcher=ctl)

    ctl = BatchController(device=dev, lone_flush=True)
    try:
        want = handler("clean", ctl).process_image(flagship, src).content
    finally:
        ctl.close()
    release = threading.Event()
    blocked = []

    def wedge_first_transform(key=None, **_ctx):
        if key and key[0] != "aux" and not blocked:
            blocked.append(threading.current_thread())
            release.wait(timeout=120)
        return faults.PASS

    faults.install(faults.FaultInjector()).plan("batcher.execute", wedge_first_transform)
    ctl = BatchController(device=dev, lone_flush=True, executor_wedge_timeout_s=0.5)
    try:
        h = handler("wedged", ctl, device_result_timeout_s=1.0)
        t0 = time.perf_counter()
        got = h.process_image(flagship, src).content
        wall = time.perf_counter() - t0
        check(got == want and h.wedged_fallbacks == 1,
              f"the wedged executor: {len(got)} bytes (clean {len(want)}), fallbacks "
              f"{h.wedged_fallbacks}")
        check(ctl.restarts == {"dead": 0, "wedged": 1} and ctl._thread is not blocked[0],
              f"the wedged executor was not replaced: {ctl.restarts}")
        release.set()
        blocked[0].join(timeout=60)
        check(not blocked[0].is_alive(), "the replaced executor did not exit when released")
    finally:
        release.set()
        faults.clear()
        ctl.close()
    print(f"pipeline wedge: the request answered the clean bytes through the direct "
          f"program on {dev} in {wall:.3f} s (wedged_fallbacks 1); its smart-crop "
          f"submission replaced the executor (restarts {ctl.restarts}); the old thread "
          "exited when released")

    # -- 16 JPEG requests with the host stage pools on and off -----------------
    jpegs = []
    for i in range(8):
        path = os.path.join(workdir, f"stage{i}.jpg")
        with open(path, "wb") as fh:
            fh.write(codecs.encode(np.ascontiguousarray(bases[i][:, ::-1]), "jpg",
                                   quality=90, mozjpeg=False, sampling_factor="2x2",
                                   device=dev))
        jpegs.append(path)
    urls = [f"/upload/{opts}/{path}" for path in jpegs
            for opts in (flagship + ",o_jpg", "w_300,h_250,c_1,o_png")]
    bodies, walls_hp = {}, {}
    for enabled in (True, False):
        server = make_server(AppParameters({
            "upload_dir": os.path.join(workdir, f"hp{enabled}", "u"),
            "tmp_dir": os.path.join(workdir, f"hp{enabled}", "t"),
            "resample_kernel": "banded", "host_pipeline_enable": enabled,
        }), device=dev)
        thread = serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(16) as pool:
                bodies[enabled] = list(pool.map(
                    lambda u: urllib.request.urlopen(base + u, timeout=300).read(), urls))
            walls_hp[enabled] = time.perf_counter() - t0
            stages = {n: p.waits for n, p in server.host_pipeline.pools()}
            # the JPEG decodes ride the codec batcher's decode group and the
            # JPEG answers its encode group, as in the JAX app; the PNG
            # answers' encodes take the encode stage
            codec = sum(m for kind, m, _ in server.codec_batcher.launch_log if kind == "aux")
            check(stages == ({"fetch": 16, "decode": 0, "encode": 8} if enabled else {})
                  and codec == 24,
                  f"host pipeline {enabled}: stage tasks {stages}, codec group members "
                  f"{codec}")
            check(server.handler.wedged_fallbacks == 0,
                  f"host pipeline {enabled}: {server.handler.wedged_fallbacks} fallbacks")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    check(bodies[True] == bodies[False], "the host pipeline on and off answer other bytes")
    print(f"pipeline host stages: 16 JPEG requests (8 1024x768 q90 sources, flagship JPEG "
          f"and w_300,h_250,c_1 PNG answers; the 16 decodes and 8 JPEG encodes in the "
          f"codec batcher's groups) byte-equal with the stage pools on and off; "
          f"wall s on {walls_hp[True]:.3f}, off {walls_hp[False]:.3f}")

    # -- the ledger's learned bytes per member cap a launch --------------------
    governor = MemoryGovernor(enabled=True)
    # a capped group's remainder launches at the deadline
    ctl = BatchController(device=dev, max_batch=8, deadline_ms=200.0, lone_flush=False,
                          governor=governor)
    plan = build_plan(OptionsBag("w_300,h_250,c_1"), 1024, 768)
    try:
        first = [f.result(timeout=300) for f in [ctl.submit(fr, plan) for fr in frames[:8]]]
        family = next(iter(governor.snapshot()["per_member_bytes"].items()), (None, None))
        per_member = family[1]
        check(per_member is not None and per_member > 0,
              f"the governor learned nothing from the ledger: {governor.snapshot()}")
        heuristic = 8 * 768 * 1024 * governor.heuristic_bytes_per_pixel
        governor.device_budget_bytes = int(4.5 * per_member)
        log0 = len(ctl.launch_log)
        again = [f.result(timeout=300) for f in [ctl.submit(fr, plan) for fr in frames[:8]]]
        capped = [n for _k, n, _b in list(ctl.launch_log)[log0:]]
    finally:
        ctl.close()
    check(sorted(capped) == [4, 4] and all(np.array_equal(a, b) for a, b in zip(first, again)),
          f"the learned cap: launches {capped}")
    print(f"pipeline governor: learned {per_member:.0f} B a member from the ledger's peak "
          f"(the heuristic predicts {heuristic:.0f} B for a launch of 8); under a budget of "
          f"4.5 members ({governor.device_budget_bytes} B) 8 members ran as launches "
          f"{capped}, the same bits, no out-of-memory")
    ledger = costledger.get_ledger()
    rows = [r for r in ledger.entries() if r["descriptor"].get("device", "").startswith("cuda")]
    print(f"cost ledger: {json.dumps(ledger.aggregates())}, {len(rows)} entries on the "
          f"card; card {card}")
    for row in rows[:8]:
        print("cost ledger entry: " + json.dumps(
            {k: row[k] for k in ("key", "descriptor", "launches", "images", "device_s",
                                 "compile_s", "peak_memory_bytes")}))

    # -- an 8000x5000 header under mem_max_source_pixels ----------------------
    big = os.path.join(workdir, "header_8000x5000.jpg")
    with open(os.path.join(ROOT, "tests", "data", "jpeg", "q90_444.jpg"), "rb") as fh:
        data = fh.read()
    with open(big, "wb") as fh:
        fh.write(bomb_header(data, 8000, 5000))
    limit = native_codec.MAX_PIXELS
    decodes = []
    real_decode = native_codec.jpeg_decode
    native_codec.jpeg_decode = lambda *a, **k: decodes.append(1) or real_decode(*a, **k)
    server = make_server(AppParameters({
        "upload_dir": os.path.join(workdir, "guard", "u"),
        "tmp_dir": os.path.join(workdir, "guard", "t"),
        "mem_max_source_pixels": 32 * 1024 * 1024,
    }), device=dev)
    thread = serve_in_thread(server)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/upload/{flagship}/{big}"
        try:
            urllib.request.urlopen(url, timeout=120)
            status, body = 200, b""
        except urllib.error.HTTPError as exc:
            status, body = exc.code, exc.read()
    finally:
        native_codec.jpeg_decode = real_decode
        native_codec.MAX_PIXELS = limit
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(status == 413 and b"mem_max_source_pixels" in body and not decodes,
          f"the 8000x5000 header: {status}, {body[:200]}, {len(decodes)} decodes")
    print("pipeline guard: an 8000x5000 JPEG header answered 413 under "
          "mem_max_source_pixels 33554432, before any decode")
    set_kernel_mode("dense")
    print(f"pipeline phase: {time.perf_counter() - t_phase:.3f} s; card {card}")
    return {"walls": walls, "transform_walls": tws, "host_walls": walls_hp}


# ---------------------------------------------------------------------------
# the raster formats: GIF in and out, animated WebP, BMP, ICO, TIFF (phase 13)

#: the port's GIF encodes against the JAX package's files of the same pixels
#: (tests/test_torch_gif.py holds the same): PSNR at least theirs less this,
#: at most this many times their bytes
GIF_PSNR_LOSS_DB = 0.75
GIF_BYTES_RATIO = 1.3
#: a served animation's K1 launches: lone_flush may launch the first frame
#: alone, the rest go together
ANIMATION_LAUNCHES = 2


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def format_fixtures(codecs, png, np):
    """Every fixture of tests/data/{gif,webp_anim,raster} decodes to its
    PNGs (the JAX package's Pillow decode), with its frames, durations and
    loop; the port's GIF encodes of tests/data/gif/enc.f*.png hold the bars
    against the committed JAX encodes. Returns the count of files checked."""
    checked = 0
    for folder in ("gif", "webp_anim"):
        data_dir = os.path.join(ROOT, "tests", "data", folder)
        ref = json.loads(_read(os.path.join(data_dir, "reference.json")))
        entries = ref["decode"] if folder == "gif" else ref
        for stem, entry in entries.items():
            anim = codecs.decode_all(_read(os.path.join(data_dir, entry["file"])))
            check(len(anim.frames) == entry["frames"] and anim.durations == entry["durations"]
                  and anim.loop == entry["loop"],
                  f"{folder}/{stem}: {len(anim.frames)} frames {anim.durations} loop "
                  f"{anim.loop}, not {entry['frames']} {entry['durations']} {entry['loop']}")
            for i, frame in enumerate(anim.frames):
                rgb, alpha = png.decode(_read(os.path.join(data_dir, f"{stem}.f{i}.png")))
                check(np.array_equal(frame, rgb), f"{folder}/{stem} frame {i}: not Pillow's")
                check(alpha is None or (anim.alphas is not None
                                        and np.array_equal(anim.alphas[i], alpha)),
                      f"{folder}/{stem} frame {i}: not Pillow's alpha")
            checked += 1
    data_dir = os.path.join(ROOT, "tests", "data", "raster")
    ref = json.loads(_read(os.path.join(data_dir, "reference.json")))
    for stem, entry in ref.items():
        data = _read(os.path.join(data_dir, entry["file"]))
        for page in range(entry["pages"]):
            name = f"{stem}.p{page}.png" if entry["pages"] > 1 else f"{stem}.png"
            rgb, alpha = png.decode(_read(os.path.join(data_dir, name)))
            got = codecs.decode(data, frame=page)
            check(np.array_equal(got.rgb, rgb), f"raster/{name}: not Pillow's pixels")
            check((alpha is None and got.alpha is None) or (
                alpha is not None and got.alpha is not None
                and np.array_equal(got.alpha, alpha)), f"raster/{name}: not Pillow's alpha")
        checked += 1
    data_dir = os.path.join(ROOT, "tests", "data", "gif")
    ref = json.loads(_read(os.path.join(data_dir, "reference.json")))
    frames, alphas = [], []
    for i in range(ref["encode_inputs"]["frames"]):
        rgb, alpha = png.decode(_read(os.path.join(data_dir, f"enc.f{i}.png")))
        frames.append(rgb)
        alphas.append(alpha)
    for name, entry in ref["encode"].items():
        a = alphas if entry["alpha"] else None
        if name == "jax_still.gif":
            blob = codecs.encode(frames[0], "gif")
        else:
            blob = codecs.encode_animation(frames, a, ref["encode_inputs"]["durations"],
                                           entry["loop"])
        anim = codecs.decode_all(blob)
        check(len(anim.frames) == entry["frames"] and anim.durations == entry["durations"]
              and anim.loop == entry["loop"],
              f"GIF encode {name}: {len(anim.frames)} frames {anim.durations} loop "
              f"{anim.loop}, the JAX file {entry['frames']} {entry['durations']} "
              f"{entry['loop']}")
        check(len(blob) <= GIF_BYTES_RATIO * entry["bytes"],
              f"GIF encode {name}: {len(blob)} bytes > {GIF_BYTES_RATIO} x {entry['bytes']}")
        scores = []
        for k, i in enumerate(entry["source_frames"]):
            diff = (anim.frames[k].astype(np.float64) - frames[i]) ** 2
            if a is not None:
                diff = diff[a[i] >= 128]
            mse = float(diff.mean())
            scores.append(float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
            check(scores[-1] >= entry["psnr"][k] - GIF_PSNR_LOSS_DB,
                  f"GIF encode {name} frame {k}: PSNR {scores[-1]:.4f} < "
                  f"{entry['psnr'][k]:.4f} - {GIF_PSNR_LOSS_DB}")
        print(f"GIF encode {name[4:-4]}: {len(blob)} bytes, PSNR "
              f"{min(scores):.4f}-{max(scores):.4f} dB; the JAX package's {entry['bytes']} "
              f"bytes, {min(entry['psnr']):.4f}-{max(entry['psnr']):.4f} dB")
    return checked


def card_frames(torch, dev, n, h, w, seed):
    """``n`` seeded [h, w, 3] u8 frames made on the card: a coarse random
    field upsampled bilinearly, shifted a step a frame."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    field = torch.rand((1, 3, h // 16 + 1, w // 16 + 1), generator=gen, device=dev)
    out = []
    for k in range(n):
        up = torch.nn.functional.interpolate(field.roll(k, dims=3), size=(h, w),
                                             mode="bilinear", align_corners=False)
        out.append((up[0].permute(1, 2, 0) * 255).round().clamp(0, 255).to(torch.uint8))
    return [f.cpu().numpy() for f in out]


def card_alphas(torch, dev, n, h, w):
    """``n`` [h, w] u8 alpha planes made on the card: a disc moving across
    an opaque band (GIF transparency is binary)."""
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    out = []
    for k in range(n):
        cx = w * (0.2 + 0.6 * k / max(n - 1, 1))
        disc = (yy - h / 2) ** 2 + (xx - cx) ** 2 < (h / 3) ** 2
        band = yy < h / 5
        out.append(torch.where(disc | band, 255, 0).to(torch.uint8).cpu().numpy())
    return out


def phase_formats(torch, dev, card, workdir, kernels):
    """Phase 13: the raster formats through the port's server on the card.
    Returns the kernels' launch counts of the served requests."""
    import urllib.request

    import numpy as np

    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.ops.compose import run_plan
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import format_writers as fb

    checked = format_fixtures(codecs, png, np)
    print(f"formats: {checked} fixtures of tests/data/gif, webp_anim and raster equal to "
          "the JAX package's decode")

    # the sources: a 16-frame 800x600 animation and a transparent 12-frame
    # 480x360 one, made on the card and written by the port's own encoder;
    # a BMP, an ICO and a TIFF built by tests/format_writers.py
    frames = card_frames(torch, dev, 16, 600, 800, seed=1800)
    durations = [40 + 10 * (k % 4) for k in range(16)]
    anim_gif = codecs.encode_animation(frames, None, durations, 0)
    t_frames = card_frames(torch, dev, 12, 360, 480, seed=1801)
    t_alphas = card_alphas(torch, dev, 12, 360, 480)
    t_gif = codecs.encode_animation(t_frames, t_alphas, [70] * 12, None)
    photo = synthetic_image(640, 480, seed=1802)
    ramp = np.tile(np.linspace(0, 255, 256).astype(np.uint8), (256, 1))
    sources = {
        "anim.gif": anim_gif, "transparent.gif": t_gif,
        "anim.webp": _read(os.path.join(ROOT, "tests", "data", "webp_anim",
                                        "lossy_alpha.webp")),
        "photo.bmp": fb.bmp(photo, bits=24),
        "icon.ico": fb.ico([fb.ico_dib(photo[:256, :256], bits=32, alpha=ramp)],
                           [(256, 256)], [32]),
        "photo.tif": fb.tiff([dict(samples=photo, bits=8, photometric=2, compression=8,
                                   predictor=2, rows_per_strip=32)]),
    }
    paths = {}
    for name, data in sources.items():
        paths[name] = os.path.join(workdir, name)
        with open(paths[name], "wb") as fh:
            fh.write(data)

    # host time of the animation's codec (median of 3 calls)
    def median_ms(fn, n=3):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    anim = codecs.decode_all(anim_gif)
    host = {"decode_16x800x600_gif_ms": median_ms(lambda: codecs.decode_all(anim_gif)),
            "encode_16x800x600_gif_ms": median_ms(
                lambda: codecs.encode_animation(anim.frames, None, anim.durations, anim.loop))}

    params = AppParameters({"upload_dir": os.path.join(workdir, "uploads"),
                            "tmp_dir": os.path.join(workdir, "tmp"),
                            "resample_kernel": "banded"})
    server = make_server(params, device=dev)
    serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    batcher = server.batcher

    def get(opts, name, accept="*/*"):
        req = urllib.request.Request(f"{base}/upload/{opts}/{paths[name]}",
                                     headers={"Accept": accept})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()

    def launches_during(fn):
        before = len(batcher.launch_log)
        k1 = kernels["K1"].launches
        out = fn()
        log = list(batcher.launch_log)[before:]
        return out, kernels["K1"].launches - k1, [m for kind, m, _p in log
                                                   if kind == "transform"]

    served = {}
    try:
        reset_counts(kernels)
        # the 16-frame animation: bytes as its frames run one at a time
        (status, ctype, body), k1, sizes = launches_during(
            lambda: get("w_200,o_gif", "anim.gif"))
        check(status == 200 and ctype == "image/gif", f"w_200,o_gif: {status} {ctype}")
        check(k1 <= ANIMATION_LAUNCHES and sum(sizes) == 16,
              f"w_200,o_gif: K1 launched {k1} times for 16 frames ({sizes})")
        served["anim"] = (k1, sizes)
        out_anim = codecs.decode_all(body)
        check(len(out_anim.frames) == 16 and out_anim.frames[0].shape == (150, 200, 3)
              and out_anim.durations == durations and out_anim.loop == 0,
              f"w_200,o_gif: {len(out_anim.frames)} frames of "
              f"{out_anim.frames[0].shape}, {out_anim.durations}, loop {out_anim.loop}")
        # the animated request's timings, through the same handler
        result = server.handler.process_image("w_200,o_gif,q_89", paths["anim.gif"])
        timings = {k: round(v * 1e3, 3) for k, v in result.timings.items()}
        # the transparent animation under the reference's crop
        (status, ctype, t_body), k1_t, t_sizes = launches_during(
            lambda: get("w_300,h_250,c_1,o_gif", "transparent.gif"))
        check(status == 200 and ctype == "image/gif", f"transparent o_gif: {status}")
        check(k1_t <= 2 * ANIMATION_LAUNCHES and sum(t_sizes) == 24,
              f"transparent w_300,h_250,c_1: K1 launched {k1_t} times for 12 colour and "
              f"12 alpha frames ({t_sizes})")
        served["transparent"] = (k1_t, t_sizes)
        t_anim = codecs.decode_all(t_body)
        check(len(t_anim.frames) == 12 and t_anim.frames[0].shape == (250, 300, 3)
              and t_anim.alphas is not None and t_anim.loop is None,
              "transparent w_300,h_250,c_1: not 12 transparent 300x250 play-once frames")
        # the animated WebP, as a GIF and as its fourth frame in a PNG
        status, ctype, w_body = get("o_gif", "anim.webp")
        ref = json.loads(_read(os.path.join(ROOT, "tests", "data", "webp_anim",
                                            "reference.json")))["lossy_alpha"]
        w_anim = codecs.decode_all(w_body)
        check(status == 200 and ctype == "image/gif" and len(w_anim.frames) == ref["frames"]
              and w_anim.durations == ref["durations"],
              f"animated WebP o_gif: {status} {ctype}, {len(w_anim.frames)} frames "
              f"{w_anim.durations}")
        status, ctype, p_body = get("o_png,gf_3", "anim.webp")
        rgb, alpha = png.decode(p_body)
        want_rgb, want_alpha = png.decode(_read(os.path.join(
            ROOT, "tests", "data", "webp_anim", "lossy_alpha.f3.png")))
        check(status == 200 and ctype == "image/png" and alpha is not None
              and int(np.abs(rgb.astype(int) - want_rgb).max()) <= PIXEL_TOL
              and np.array_equal(alpha, want_alpha),
              f"animated WebP o_png,gf_3: {status} {ctype}, not frame 3")
        # BMP, ICO and TIFF under the reference's crop: JPEG answers
        for name in ("photo.bmp", "icon.ico", "photo.tif"):
            status, ctype, j_body = get("w_300,h_250,c_1", name)
            status_png, _c, png_body = get("w_300,h_250,c_1,o_png", name)
            got = codecs.decode(j_body, device=dev).rgb
            ref_rgb, _a = png.decode(png_body)
            score = psnr(got, ref_rgb)
            check(status == 200 == status_png and ctype == "image/jpeg"
                  and got.shape == ref_rgb.shape and score >= JPEG_ANSWER_PSNR,
                  f"{name} w_300,h_250,c_1: {status} {ctype} {got.shape}, PSNR {score:.2f} "
                  "against its PNG answer")
            print(f"formats: {name} w_300,h_250,c_1 answered image/jpeg (K16), "
                  f"PSNR {score:.2f} dB against its PNG answer")
        counts = read_counts(kernels)
    finally:
        server.shutdown()
        server.server_close()

    # the served animation against its frames through run_plan one at a time
    plan = build_plan(OptionsBag("w_200,o_gif"), 800, 600)
    outs = [run_plan(f, plan, device=dev) for f in anim.frames]
    check(codecs.encode_animation(outs, None, anim.durations, anim.loop) == body,
          "w_200,o_gif: the served bytes are not the per-frame run_plan encode")
    print("formats: the served 16-frame w_200,o_gif answer equals encode_animation of "
          "its frames through run_plan one at a time")
    print("formats readings: " + json.dumps({
        "card": card, **{k: round(v, 3) for k, v in host.items()},
        "anim_k1_launches": served["anim"][0], "anim_frames_per_launch": served["anim"][1],
        "transparent_k1_launches": served["transparent"][0],
        "transparent_frames_per_launch": served["transparent"][1],
        "anim_request_ms": timings}))
    return counts


# ---------------------------------------------------------------------------
# the JPEG encoder: K16 and K17 (phase 3), its fixtures (phase 10) and its
# served answers (phase 14)

#: nvJPEG's encode, the JPEG encoder's library yardstick; ``main`` puts a
#: counter in its place for phases 6-14, where no served encode may reach it
NVJPEG_ENCODE = None
#: tests/data/jpeg_enc, written by tools/make_jpeg_encode_fixtures.py from the
#: JAX package's native encoders and its handler
JPEG_ENC_DIR = os.path.join(ROOT, "tests", "data", "jpeg_enc")


def jpeg_enc_file(name):
    with open(os.path.join(JPEG_ENC_DIR, name), "rb") as fh:
        return fh.read()


def jpeg_fixture_encode(entry, src, dev):
    """The port's encode of ``src`` as one entry of
    tests/data/jpeg_enc/reference.json describes it, on ``dev``."""
    from flyimg_tpu_torch.codecs import jpeg_enc

    if entry["encoder"] == "fc_jpeg_encode_trellis":
        return jpeg_enc.encode_trellis(src, entry["quality"], tuple(entry["sampling"]),
                                       device=dev)
    if entry["encoder"] == "fc_jpeg_encode":
        return jpeg_enc.encode_plain(src, entry["quality"], sampling=tuple(entry["sampling"]),
                                     device=dev)
    return jpeg_enc.encode_cmyk(src, entry["quality"], entry["optimize"], device=dev)


def coefficient_diff(torch, label, got, want, dims):
    """Fail naming the first block where two int16 [blocks, 64] coefficient
    sets differ (its component, block row and column, zigzag index)."""
    bad = (got != want).any(1).nonzero().flatten()
    if bad.numel() == 0:
        return
    b = int(bad[0])
    comp, first = 0, 0
    while b >= first + dims[comp][0] * dims[comp][1]:
        first += dims[comp][0] * dims[comp][1]
        comp += 1
    row, col = divmod(b - first, dims[comp][0])
    k = int((got[b] != want[b]).nonzero()[0])
    check(False, f"{label}: {bad.numel()} blocks differ; the first is block {b} "
          f"(component {comp}, block row {row}, column {col}): zigzag {k} is "
          f"{int(got[b, k])}, its plain version's {int(want[b, k])}")


def k16_operations(torch, rgb, quality, sampling):
    """The float operations K16's function needs on these inputs: 17 a
    pixel (colour), a box's adds and one division a chroma sample, 2048 a
    block (the DCT), and the dynamic program's: the prefix sums, the
    candidate values, each candidate's 6 plus 2 a run length it scans
    (data-dependent: counted from the DCT of this frame), the ZRL fold and
    the last-position pass."""
    from flyimg_tpu_torch.codecs import jpeg_plain, jpeg_tables

    h, w = rgb.shape[:2]
    params = jpeg_tables.trellis_params(quality)
    dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors(sampling))
    cos = torch.tensor(params["cos"], device=rgb.device)
    hf, vf = sampling
    ops = 17.0 * h * w
    if (hf, vf) != (1, 1):
        ops += 2.0 * (-(-h // vf)) * (-(-w // hf)) * hf * vf
    per_k = torch.tensor([0] + [6 + 2 * (min(k - 1, 15) + 1) for k in range(1, 64)],
                         dtype=torch.float64, device=rgb.device)
    for c, plane in enumerate(jpeg_plain.trellis_planes(rgb, sampling)):
        bw, bh = dims[c]
        samples = jpeg_plain._replicate(plane, bh * 8, bw * 8) - 128.0
        cz = jpeg_plain._to_zigzag(jpeg_plain.fdct8x8_plain(jpeg_plain._blocks(samples, bw, bh),
                                                            cos))
        q = torch.tensor(params["q"][0 if c == 0 else 1], device=rgb.device)
        v0 = (cz.abs() / q + 0.5).floor().clamp_max(1023)
        cands = (v0 >= 1).double() + (v0 >= 2).double()
        ops += float((cands[:, 1:] * per_k[1:]).sum())
        ops += bw * bh * (2048.0 + 2 + 126 + 63 * 4 + 63 * 3)
    return ops


def jpeg_kernel_rows(torch, dev):
    """Phase 3's K16 and K17: each against its plain version on the card,
    coefficient for coefficient, at the main path's shape (the 300x250
    answer of tests/data/jpeg_enc/source.png, q90) and, not timed, at every
    sampling factor, at q1 and q100, at 1920x1080, ragged sizes, on the
    CMYK planes and on the edge frames of
    flyimg_tpu_torch/testing/jpeg_frames.py (flat, 0/255 checkerboards at
    q100, q1, 1x1/8x8/9x9, 1920x1080 at 4:2:0; also their CMYK planes);
    then timed against the plain version and nvJPEG's whole encode of the
    same frame (the library yardstick), with the device time and the bound
    at 300x250 and at 1920x1080. K16 is the encode group's frame-table
    kernel: timed at a group of one (the row) and at a group of 16
    300x250 frames, each frame exact against its plain version."""
    import numpy as np

    from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables, native_codec, png
    from flyimg_tpu_torch.testing import jpeg_frames

    src, _ = png.decode(jpeg_enc_file("source.png"))
    big = synthetic_image(1920, 1080, seed=1900)
    ragged = synthetic_image(301, 251, seed=1901)
    tiny = synthetic_image(7, 5, seed=1902)
    frames = {"300x250": src, "1920x1080": big, "301x251": ragged, "7x5": tiny}
    cases = ([("300x250", 90, s) for s in
              [(h, v) for h in range(1, 5) for v in range(1, 5) if h * v <= 8]]
             + [("300x250", 1, (1, 1)), ("300x250", 100, (2, 2)), ("1920x1080", 90, (1, 1)),
                ("1920x1080", 75, (2, 2)), ("301x251", 50, (3, 2)), ("7x5", 90, (4, 2))])
    n16 = n17 = 0
    err = 0

    def held(label, got, want, dims):
        nonlocal err
        coefficient_diff(torch, label, got, want, dims)
        err = max(err, int((got.int() - want.int()).abs().max()))

    for label, q, s in cases:
        rgb = torch.from_numpy(frames[label]).to(dev)
        h, w = frames[label].shape[:2]
        dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors(s))
        got = jpeg_enc.trellis_coefficients(rgb, q, s)
        want = jpeg_plain.trellis_plain(rgb, q, s)
        held(f"K16 {label} q{q} {s[0]}x{s[1]}", got, want, dims)
        planes = jpeg_plain.grid_planes(rgb, s)
        tables = jpeg_tables.qtables(q)
        got = jpeg_enc.fdct_coefficients(planes, tables, (0, 1, 1))
        want = torch.cat([jpeg_plain.fdct_islow_plain(p, tables[t])
                          for p, t in zip(planes, (0, 1, 1))])
        held(f"K17 {label} q{q} {s[0]}x{s[1]}", got, want, dims)
        n16 += 1
        n17 += 1
    for label in ("300x250", "301x251", "7x5"):
        rgb = torch.from_numpy(frames[label]).to(dev)
        h, w = frames[label].shape[:2]
        planes = jpeg_plain.cmyk_grid_planes(rgb)
        table = [jpeg_tables.build_qtable(90, jpeg_tables.LUMA_Q)]
        got = jpeg_enc.fdct_coefficients(planes, table, (0, 0, 0, 0))
        want = torch.cat([jpeg_plain.fdct_islow_plain(p, table[0]) for p in planes])
        held(f"K17 CMYK {label}", got, want, jpeg_plain.component_blocks(w, h, [(1, 1)] * 4))
        n17 += 1
    for name, q, s in jpeg_frames.CASES:
        img = jpeg_frames.frame(name)
        rgb = torch.from_numpy(img.copy()).to(dev)
        h, w = img.shape[:2]
        dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors(s))
        held(f"K16 {name} q{q} {s[0]}x{s[1]}", jpeg_enc.trellis_coefficients(rgb, q, s),
             jpeg_plain.trellis_plain(rgb, q, s), dims)
        planes = jpeg_plain.grid_planes(rgb, s)
        tables = jpeg_tables.qtables(q)
        held(f"K17 {name} q{q} {s[0]}x{s[1]}",
             jpeg_enc.fdct_coefficients(planes, tables, (0, 1, 1)),
             torch.cat([jpeg_plain.fdct_islow_plain(p, tables[t])
                        for p, t in zip(planes, (0, 1, 1))]), dims)
        n16 += 1
        n17 += 1
    for name, q in sorted({(name, q) for name, q, _ in jpeg_frames.CASES}):
        img = jpeg_frames.frame(name)
        rgb = torch.from_numpy(img.copy()).to(dev)
        h, w = img.shape[:2]
        planes = jpeg_plain.cmyk_grid_planes(rgb)
        table = [jpeg_tables.build_qtable(q, jpeg_tables.LUMA_Q)]
        held(f"K17 CMYK {name} q{q}", jpeg_enc.fdct_coefficients(planes, table, (0, 0, 0, 0)),
             torch.cat([jpeg_plain.fdct_islow_plain(p, table[0]) for p in planes]),
             jpeg_plain.component_blocks(w, h, [(1, 1)] * 4))
        n17 += 1
    torch.cuda.synchronize()
    print(f"K16: {n16} cases, K17: {n17} cases equal to their plain versions on the card, "
          "coefficient for coefficient (every luma sampling factor at 300x250 q90; q1, "
          "q100, 1920x1080, 301x251, 7x5; the edge frames: flat 0/128/255, 0/255 "
          "checkerboards of 1 and 8 pixels at q100, q1 on the source, 1x1, 8x8, 9x9, "
          "1920x1080 at q90 4:2:0; K17 also on CMYK planes)")

    rows = {}
    rgb = torch.from_numpy(src).to(dev)
    h, w = src.shape[:2]
    dims = jpeg_plain.component_blocks(w, h, jpeg_plain.ycc_factors((1, 1)))
    blocks = sum(a * b for a, b in dims)
    row = {"max_abs_err": float(err)}
    row["bound_ms"], row["bound_by"] = bound_ms(3.0 * h * w + 128.0 * blocks,
                                                k16_operations(torch, rgb, 90, (1, 1)))
    row["ms"] = cuda_ms(torch, lambda: jpeg_enc.trellis_coefficients(rgb, 90, (1, 1)))
    row["plain_ms"] = cuda_ms(torch, lambda: jpeg_plain.trellis_plain(rgb, 90, (1, 1)),
                              iters=3, warmup=1)
    row["library_ms"] = cuda_ms(torch, lambda: native_codec.jpeg_encode(
        src, 90, optimize=True, progressive=True, device=dev), iters=5)
    rows["K16"] = row
    planes = jpeg_plain.grid_planes(rgb, (1, 1))
    tables = jpeg_tables.qtables(90)
    row = {"max_abs_err": float(err)}
    row["bound_ms"], row["bound_by"] = bound_ms(1.0 * sum(p.numel() for p in planes)
                                                + 128.0 * blocks, 1100.0 * blocks)
    row["ms"] = cuda_ms(torch, lambda: jpeg_enc.fdct_coefficients(planes, tables, (0, 1, 1)))
    row["plain_ms"] = cuda_ms(torch, lambda: torch.cat([
        jpeg_plain.fdct_islow_plain(p, tables[t]) for p, t in zip(planes, (0, 1, 1))]),
        iters=5)
    row["library_ms"] = cuda_ms(torch, lambda: native_codec.jpeg_encode(
        src, 90, optimize=False, progressive=False, device=dev), iters=5)
    rows["K17"] = row
    # device time alone (torch.profiler), at the answer's shape and at 1080p
    from flyimg_tpu_torch.face_breakdown import _device_ms

    big_rgb = torch.from_numpy(big).to(dev)
    big_planes = jpeg_plain.grid_planes(big_rgb, (1, 1))
    device = {
        "K16": (_device_ms(lambda: jpeg_enc.trellis_coefficients(rgb, 90, (1, 1)), 5,
                           "trellis_kernel"),
                _device_ms(lambda: jpeg_enc.trellis_coefficients(big_rgb, 90, (1, 1)), 5,
                           "trellis_kernel")),
        "K17": (_device_ms(lambda: jpeg_enc.fdct_coefficients(planes, tables, (0, 1, 1)), 5,
                           "fdct_kernel"),
                _device_ms(lambda: jpeg_enc.fdct_coefficients(big_planes, tables, (0, 1, 1)),
                           5, "fdct_kernel")),
    }
    # the bounds at 1920x1080 and K16's operation floor at the unfused rate
    # (--fmad=false: an instruction does one operation)
    bh, bw_ = -(-1080 // 8), -(-1920 // 8)
    big_blocks = 3 * bh * bw_
    ops = {"K16": (k16_operations(torch, rgb, 90, (1, 1)),
                   k16_operations(torch, big_rgb, 90, (1, 1)))}
    big_bound = {"K16": bound_ms(3.0 * 1920 * 1080 + 128.0 * big_blocks, ops["K16"][1]),
                 "K17": bound_ms(1.0 * sum(p.numel() for p in big_planes) + 128.0 * big_blocks,
                                 1100.0 * big_blocks)}
    # the encode group's frame table at a group of 16 answers (16 seeded
    # 300x250 frames, q90 4:4:4): one launch, each frame exact, against the
    # plain version of the 16 (one run) and 16 groups of one
    frames16 = [torch.from_numpy(synthetic_image(300, 250, seed=2200 + k)).to(dev)
                for k in range(16)]
    got16 = jpeg_enc.trellis_coefficients_group(frames16, 90, (1, 1))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want16 = [jpeg_plain.trellis_plain(f, 90, (1, 1)) for f in frames16]
    end.record()
    end.synchronize()
    for k, (got, want) in enumerate(zip(got16, want16)):
        held(f"K16 group of 16, frame {k}", got, want, dims)
    rows["K16"]["max_abs_err"] = float(err)
    blocks16 = 16 * blocks
    group16 = {
        "ms": cuda_ms(torch, lambda: jpeg_enc.trellis_coefficients_group(frames16, 90, (1, 1))),
        "device_ms": _device_ms(lambda: jpeg_enc.trellis_coefficients_group(
            frames16, 90, (1, 1)), 5, "trellis_kernel"),
        "16_groups_of_one_ms": cuda_ms(torch, lambda: [
            jpeg_enc.trellis_coefficients(f, 90, (1, 1)) for f in frames16]),
        "plain_ms": start.elapsed_time(end),
    }
    group16["bound_ms"], group16["bound_by"] = bound_ms(
        16 * 3.0 * h * w + 128.0 * blocks16,
        sum(k16_operations(torch, f, 90, (1, 1)) for f in frames16))
    print(f"K16 encode group of 16 300x250 frames (q90 4:4:4, one launch, each frame equal "
          f"to its plain version): kernel {group16['ms']:.4f} ms, device "
          f"{group16['device_ms']:.4f} ms, bound {group16['bound_ms']:.5f} ms "
          f"({group16['bound_by']}); 16 groups of one {group16['16_groups_of_one_ms']:.4f} ms; "
          f"plain {group16['plain_ms']:.4f} ms (one run); a group of one is the row below")
    for name, what in (("K16", "trellis (300x250 q90 4:4:4, a group of one)"),
                       ("K17", "islow FDCT (300x250 q90 4:4:4 planes)")):
        r = rows[name]
        floor = ""
        if name in ops:
            small, large = (n / H100_F32_UNFUSED * 1e3 for n in ops[name])
            floor = (f"; operation floor at the unfused rate {small:.5f} ms, 1920x1080 "
                     f"{large:.5f} ms")
        print(f"{name} {what}: kernel {r['ms']:.4f} ms, device {device[name][0]:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}); 1920x1080: device "
              f"{device[name][1]:.4f} ms, bound {big_bound[name][0]:.5f} ms "
              f"({big_bound[name][1]}){floor}; plain {r['plain_ms']:.4f} ms, nvJPEG's whole "
              f"encode of the frame {r['library_ms']:.4f} ms (the library yardstick)")
    return rows


def encode_breakdown(torch, dev, rgb, kind):
    """Medians (ms) of one encode's steps on the card: the upload, the
    kernel (events; K17's planes included), the coefficients' readback,
    the host writer; the whole encode; nvJPEG's whole encode of the same
    frame with the same options."""
    from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables

    h, w = rgb.shape[:2]
    tables = jpeg_tables.qtables(90)
    steps = {"upload_ms": [], "kernel_ms": [], "readback_ms": [], "writer_ms": []}
    for _ in range(11):
        t0 = time.perf_counter()
        frame = torch.from_numpy(rgb).to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if kind == "moz_1":
            coef = jpeg_enc.trellis_coefficients(frame, 90, (1, 1))
        else:
            coef = jpeg_enc.fdct_coefficients(jpeg_plain.grid_planes(frame, (1, 1)), tables,
                                              (0, 1, 1))
        end.record()
        end.synchronize()
        t2 = time.perf_counter()
        host = coef.cpu().numpy()
        t3 = time.perf_counter()
        jpeg_enc.write(host, w, h, jpeg_plain.ycc_factors((1, 1)), tables,
                       progressive=kind == "moz_1", optimize=kind == "moz_1")
        t4 = time.perf_counter()
        steps["upload_ms"].append((t1 - t0) * 1e3)
        steps["kernel_ms"].append(start.elapsed_time(end))
        steps["readback_ms"].append((t3 - t2) * 1e3)
        steps["writer_ms"].append((t4 - t3) * 1e3)
    out = {k: round(statistics.median(v), 4) for k, v in steps.items()}
    out["coefficient_bytes"] = int(host.nbytes)
    moz = kind == "moz_1"
    encode = jpeg_enc.encode_trellis if moz else (
        lambda x, q, device: jpeg_enc.encode_plain(x, q, device=device))
    out["encode_ms"] = round(cuda_ms(torch, lambda: encode(rgb, 90, device=dev), iters=11), 4)
    out["nvjpeg_encode_ms"] = round(cuda_ms(torch, lambda: NVJPEG_ENCODE(
        rgb, 90, optimize=moz, progressive=moz, device=dev), iters=11), 4)
    return out


def phase_jpeg(torch, dev, card, workdir, kernels):
    """Phase 14: the port's JPEG answers through its server on the card,
    byte for byte the JAX handler's (tests/data/jpeg_enc's served URLs),
    then the encoder's time split and bytes. Returns the kernels' launch
    counts of the served requests."""
    import urllib.request

    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.codecs import jpeg_enc, png
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread

    ref = json.loads(jpeg_enc_file("reference.json"))
    src_path = os.path.join(workdir, "jpeg_enc_source.png")
    with open(src_path, "wb") as fh:
        fh.write(jpeg_enc_file("source.png"))
    params = AppParameters({"upload_dir": os.path.join(workdir, "uploads"),
                            "tmp_dir": os.path.join(workdir, "tmp"),
                            "resample_kernel": "banded"})
    server = make_server(params, device=dev)
    serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_counts(kernels)
        served = {}
        for opts, name in ref["served"].items():
            with urllib.request.urlopen(f"{base}/upload/{opts}/{src_path}",
                                        timeout=300) as resp:
                status, ctype, body = resp.status, resp.headers.get("Content-Type"), resp.read()
            check(status == 200 and ctype == "image/jpeg", f"{opts}: {status} {ctype}")
            want = jpeg_enc_file(name)
            check(body == want, f"{opts}: {len(body)} bytes, not the JAX handler's {name} "
                  f"({len(want)} bytes)")
            served[opts] = len(body)
        counts = read_counts(kernels)
    finally:
        server.shutdown()
        server.server_close()
    print(f"jpeg: the server on the card answered {len(served)} URLs with the JAX handler's "
          f"bytes ({served}); kernel launches {counts}")
    check(counts["K16"] > 0, "jpeg: the moz_1 answer never launched K16")
    check(counts["K17"] > 0, "jpeg: the moz_0 and CMYK answers never launched K17")

    src, _ = png.decode(jpeg_enc_file("source.png"))
    full = synthetic_image(1920, 1080, seed=1903)
    readings = {}
    for label, rgb in (("300x250", src), ("1920x1080", full)):
        for kind in ("moz_1", "moz_0"):
            readings[f"{kind}_{label}"] = encode_breakdown(torch, dev, rgb, kind)
    trellis = jpeg_enc_file("trellis_q90_1x1.jpg")
    nv = NVJPEG_ENCODE(src, 90, optimize=True, progressive=True, device=dev)
    sizes = {"trellis_moz1_300x250_bytes": len(trellis), "nvjpeg_moz1_300x250_bytes": len(nv),
             "trellis_psnr_db": round(psnr(codecs.decode(trellis, device=dev).rgb, src), 4),
             "nvjpeg_psnr_db": round(psnr(codecs.decode(nv, device=dev).rgb, src), 4)}
    print(json.dumps({"jpeg_encode": readings, "sizes": sizes, "card": card}))
    return counts


# ---------------------------------------------------------------------------
# the port's JPEG decoder: K18 and K19 (phase 3) and its served path
# (phase 15)

JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")
#: the luma sampling factors the decoder's edge cases are encoded at
DECODE_SAMPLINGS = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (2, 4))
#: the edge sizes (one pixel, ragged, past no MCU multiple)
DECODE_EDGE_SIZES = ((1, 1), (7, 9), (17, 33), (203, 157))


def jpeg_file(name):
    with open(os.path.join(JPEG_DIR, name), "rb") as fh:
        return fh.read()


def decode_held(torch, dev, label, items):
    """One batch of ``items`` through K18 and K19 on the card and through
    their plain versions on the same device tensors: both exact (max
    difference 0). Returns (the members' results, K18's and K19's max
    error)."""
    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain

    batch = jpeg_dec.entropy_decode(items, pinned=True)
    check(batch.order, f"{label}: no member decoded ({batch.results})")
    planes, rgb = jpeg_dec.run_kernels(batch, dev)
    tab = batch.tables
    want = plain.k18(batch.coefs.to(dev), batch.quant.to(dev), tab.segments, tab.plane_bytes)
    e18 = int((planes[:tab.plane_bytes].int() - want.int()).abs().max())
    want = plain.k19(planes, tab.members, tab.out_bytes)
    e19 = int((rgb[:tab.out_bytes].int() - want.int()).abs().max())
    check(e18 == 0 and e19 == 0, f"{label}: K18 {e18}, K19 {e19} levels off their plain "
          "versions")
    return jpeg_dec.finish(batch, rgb.cpu().numpy()), e18, e19


def decode_edge_files(dev):
    """The edge sizes at every luma sampling, baseline (moz_0) and
    progressive (moz_1), encoded by the port's own encoder on the card."""
    from flyimg_tpu_torch import codecs

    files = []
    for k, (h, v) in enumerate(DECODE_SAMPLINGS):
        for w, hh in DECODE_EDGE_SIZES:
            for moz in (False, True):
                files.append(codecs.encode(synthetic_image(w, hh, seed=2100 + k + w), "jpg",
                                           quality=85, mozjpeg=moz, sampling_factor=f"{h}x{v}",
                                           device=dev))
    return files


def flagship_jpegs(dev):
    """The full-width photo: a seeded 4032x3024 frame as a q90 4:2:0 JPEG,
    baseline (moz_0) and progressive (moz_1), from the port's own
    encoder."""
    from flyimg_tpu_torch import codecs

    rgb = synthetic_image(4032, 3024, seed=2024)
    return {moz: codecs.encode(rgb, "jpg", quality=90, mozjpeg=moz == "progressive",
                               sampling_factor="2x2", device=dev)
            for moz in ("baseline", "progressive")}


def answer_jpeg(dev):
    """The 300x250 answer shape as a q90 4:2:0 JPEG (tests/data/jpeg_enc's
    source, baseline, from the port's own encoder)."""
    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.codecs import png

    src, _ = png.decode(jpeg_enc_file("source.png"))
    return codecs.encode(src, "jpg", quality=90, mozjpeg=False, sampling_factor="2x2",
                         device=dev)


def jpeg_decode_rows(torch, dev, card):
    """Phase 3's K18 and K19: each equal to its plain version (max
    difference 0) on every tests/data/jpeg file at every DCT scale, on
    its native-route windows and on the edge sizes at every sampling; the
    whole decoder equal to every native-route fixture (the JAX package's
    fc_jpeg_decode and fc_jpeg_decode_roi); then timed (wrapper ms between
    CUDA events, device ms by torch.profiler, the plain versions, the
    bytes bound) at 300x250 and at 4032x3024 at each scale the served
    requests use, each first run through ``run_kernels`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (the device half must not
    wait for the card) and held to its plain version at that shape (max
    difference 0; the kernels line's max_abs_err is the 4032x3024 1/4
    comparison), beside nvJPEG's whole decode of the same file (the
    library yardstick; not a PyTorch call)."""
    import numpy as np

    from flyimg_tpu_torch.codecs import jpeg_dec, native_codec, png
    from flyimg_tpu_torch.codecs import jpeg_dec_plain as plain
    from flyimg_tpu_torch.face_breakdown import _device_ms

    names = sorted(f for f in os.listdir(JPEG_DIR) if f.endswith(".jpg"))
    err18 = err19 = n = 0
    for scale in (1, 2, 4, 8):
        got, e18, e19 = decode_held(torch, dev, f"fixtures 1/{8 // scale}",
                                    [(jpeg_file(f), scale, None) for f in names])
        err18, err19, n = max(err18, e18), max(err19, e19), n + len(names)
        for f, out in zip(names, got):
            want, _ = png.decode(jpeg_file(f"{f[:-4]}.native.s{scale}.png"))
            check(out.rgb.shape == want.shape and np.array_equal(out.rgb, want),
                  f"decode {f} at {scale}/8: not the JAX package's native decode")
    windows = json.loads(jpeg_file("reference.json"))["native_windows"]
    got, e18, e19 = decode_held(torch, dev, "native windows", [
        (jpeg_file(w["source"]), w["scale"], tuple(w["request"])) for w in windows])
    err18, err19 = max(err18, e18), max(err19, e19)
    for w, out in zip(windows, got):
        want, _ = png.decode(jpeg_file(w["file"]))
        check(np.array_equal(out.rgb, want) and list(out.offset) == [w["out_x"], w["out_y"]]
              and list(out.frame_size) == [w["full_w"], w["full_h"]],
              f"window {w['file']}: not the JAX package's native window")
    edges = decode_edge_files(dev)
    for scale in (1, 2, 4, 8):
        _, e18, e19 = decode_held(torch, dev, f"edge sizes 1/{8 // scale}",
                                  [(d, scale, None) for d in edges])
        err18, err19 = max(err18, e18), max(err19, e19)
    print(f"K18, K19: equal to their plain versions (max difference {err18}, {err19}) and the "
          f"decoder equal to the JAX package's native decode on {n} fixture decodes (every "
          f"file at 1/8, 1/4, 1/2, 1/1) and {len(windows)} native windows; the kernels also "
          f"on {len(edges)} edge files ({DECODE_EDGE_SIZES} at {len(DECODE_SAMPLINGS)} "
          "samplings, baseline and progressive) at every scale")

    big = flagship_jpegs(dev)
    cases = {"300x250 1/1": (answer_jpeg(dev), 8),
             "4032x3024 1/4": (big["baseline"], 2),
             "4032x3024 1/2": (big["baseline"], 4),
             "4032x3024 1/1": (big["baseline"], 8)}
    readings, rows = {}, {}
    for label, (data, scale) in cases.items():
        batch = jpeg_dec.entropy_decode([(data, scale, None)], pinned=True)
        # the device half reads nothing back: no call in it may wait for the
        # card (the tables' counts come from the host, the copies from
        # pinned memory)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            planes, rgb = jpeg_dec.run_kernels(batch, dev)
        except RuntimeError as exc:
            raise SmokeFailure(f"{label}: run_kernels waited for the card: {exc}") from exc
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # exact at the timed shape: each kernel against its plain version on
        # the same inputs
        coefs, quant, k18_tiles, mems, k19_tiles = jpeg_dec.upload(batch, dev)
        tab = batch.tables
        want = plain.k18(coefs, quant, tab.segments, tab.plane_bytes)
        e18 = int((planes[:tab.plane_bytes].int() - want.int()).abs().max())
        want = plain.k19(planes, tab.members, tab.out_bytes)
        e19 = int((rgb[:tab.out_bytes].int() - want.int()).abs().max())
        del want, rgb
        check(e18 == 0 and e19 == 0, f"{label}: K18 {e18}, K19 {e19} levels off their plain "
              "versions")
        blocks, pixels = tab.blocks, tab.pixels
        b18 = bound_ms(128.0 * blocks + float(tab.plane_bytes), 0.0)
        b19 = bound_ms(float(tab.plane_bytes) + float(tab.out_bytes), 0.0)

        def k18():
            return jpeg_dec.idct_planes(coefs, quant, k18_tiles, tab.plane_bytes)

        def k19():
            return jpeg_dec.color_planes(planes, mems, tab.out_bytes, k19_tiles)

        r = {
            "k18_ms": cuda_ms(torch, k18),
            "k19_ms": cuda_ms(torch, k19),
            "k18_device_ms": _device_ms(k18, 5, "idct_kernel"),
            "k19_device_ms": _device_ms(k19, 5, "color_kernel"),
            "k18_plain_ms": cuda_ms(torch, lambda: plain.k18(coefs, quant, tab.segments,
                                                             tab.plane_bytes),
                                    iters=3, warmup=1),
            "k19_plain_ms": cuda_ms(torch, lambda: plain.k19(planes, tab.members,
                                                             tab.out_bytes),
                                    iters=3, warmup=1),
            "k18_bound_ms": b18[0], "k19_bound_ms": b19[0],
            "nvjpeg_decode_ms": cuda_ms(torch, lambda: native_codec.nvjpeg_decode(
                data, scale, device=dev), iters=5),
            "blocks": blocks, "pixels": pixels, "k18_max_abs_err": e18, "k19_max_abs_err": e19,
        }
        readings[label] = {k: (round(v, 5) if isinstance(v, float) else v)
                           for k, v in r.items()}
        if label == "4032x3024 1/4":
            # the kernels line's rows: the served flagship request's decode
            for key, pre, bound in (("K18", "k18", b18), ("K19", "k19", b19)):
                rows[key] = {"max_abs_err": float(e18 if key == "K18" else e19),
                             "ms": r[f"{pre}_ms"], "plain_ms": r[f"{pre}_plain_ms"],
                             "bound_ms": bound[0], "bound_by": bound[1],
                             "library_ms": None}
    print(json.dumps({"jpeg_decode_kernels": readings, "card": card}))
    return rows


def decode_split(torch, dev, data, scale, n=7):
    """Median seconds of one decode's steps on the card (host entropy
    decode, the kernels' tables, upload, K18, K19, readback, each
    synchronized) and of nvJPEG's decode of the same file at the same
    scale, in ms."""
    from flyimg_tpu_torch.codecs import jpeg_dec, native_codec

    steps = {}
    for _ in range(n):
        split = {}
        jpeg_dec.decode_batch([(data, scale, None)], dev, split=split)
        for k, v in split.items():
            steps.setdefault(k, []).append(v * 1e3)
    out = {f"{k}_ms": round(statistics.median(v), 4) for k, v in steps.items()}
    out["nvjpeg_decode_ms"] = round(cuda_ms(torch, lambda: native_codec.nvjpeg_decode(
        data, scale, device=dev), iters=n), 4)
    return out


#: phase 15's served requests (each on both flagship files): crops at 1/4
#: (w_300,h_250,c_1 keeps 90 % of a 4:3 frame, past the 80 % a window may
#: cover, so it decodes whole; w_300,h_300,c_1 and w_200,h_300,c_1 decode
#: windows), the full-scale w_2000 and a window extract at 1/1
DECODE_WAVE = ("w_300,h_250,c_1", "w_300,h_250,c_1,smc_1", "w_2000", "w_300,h_300,c_1",
               "e_1,p1x_400,p1y_300,p2x_2400,p2y_2100", "w_300,h_250,c_1,q_80",
               "w_600,h_400,c_1", "w_200,h_300,c_1")
#: phase 15's codec batcher deadline for its launch-count check: the wave's
#: requests reach the decode group over some milliseconds of fetch and
#: planning, longer than the default's 1.0 ms; the wave also runs once at
#: the default, whose group sizes are printed and not checked
DECODE_WAVE_DEADLINE_MS = 25.0


def phase_jpeg_decode(torch, dev, card, workdir, kernels):
    """Phase 15: the full-width JPEG source through the server. 16
    concurrent requests (DECODE_WAVE on a baseline and a progressive
    4032x3024 4:2:0 photo) go through the codec batcher (decode groups by
    DCT scale, windows included; the encode group of the JPEG answers);
    then the same requests one at a time on a fresh server: the answers
    must be byte-equal, and the wave must take fewer K18 launches than
    requests (at DECODE_WAVE_DEADLINE_MS). The wave runs again at the
    default deadline, its answers equal to the single ones too. Prints the
    group sizes, the kernels' launches and wall times of both waves and
    the decode split. Returns the first wave's kernel launches."""
    import urllib.request

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread

    big = flagship_jpegs(dev)
    paths = {}
    for kind, data in big.items():
        paths[kind] = os.path.join(workdir, f"photo4032x3024_{kind}.jpg")
        with open(paths[kind], "wb") as fh:
            fh.write(data)
    requests = [(o, paths[k]) for k in ("baseline", "progressive") for o in DECODE_WAVE]

    def serve(tag, concurrent, deadline_ms=DECODE_WAVE_DEADLINE_MS):
        # the banded resample (K1): a member's pixels do not depend on the
        # batch it rides in, so the wave's answers can equal the single ones
        settings = {"upload_dir": os.path.join(workdir, tag, "uploads"),
                    "tmp_dir": os.path.join(workdir, tag, "tmp"),
                    "resample_kernel": "banded"}
        if deadline_ms is not None:
            settings["decode_deadline_ms"] = deadline_ms
        params = AppParameters(settings)
        server = make_server(params, device=dev)
        thread = serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def get(req):
            opts, src = req
            with urllib.request.urlopen(f"{base}/upload/{opts}/{src}", timeout=300) as resp:
                return resp.status, resp.headers.get("Content-Type"), resp.read()

        try:
            reset_counts(kernels)
            log0 = len(server.codec_batcher.launch_log)
            t0 = time.perf_counter()
            if concurrent:
                with ThreadPoolExecutor(len(requests)) as pool:
                    answers = list(pool.map(get, requests))
            else:
                answers = [get(r) for r in requests]
            wall = time.perf_counter() - t0
            counts = read_counts(kernels)
            groups = [m for kind, m, _ in list(server.codec_batcher.launch_log)[log0:]
                      if kind == "aux"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        return answers, counts, groups, wall

    wave, counts, groups, wall = serve("wave", True)
    default_wave, default_counts, default_groups, default_wall = serve("default", True, None)
    single, single_counts, _, single_wall = serve("single", False)
    for (opts, src), (status, ctype, body), (_, _, b1), (s2, c2, b2) in zip(
            requests, wave, default_wave, single):
        check(status == 200 and ctype == "image/jpeg", f"{opts} {src}: {status} {ctype}")
        check(body == b2 and b1 == b2, f"{opts} {os.path.basename(src)}: a wave's answer is "
              "not the single request's")
    default_ms = AppParameters({}).by_key("decode_deadline_ms")
    print(f"decode wave: {len(requests)} concurrent 4032x3024 JPEG requests in {wall:.3f} s "
          f"at a {DECODE_WAVE_DEADLINE_MS} ms codec deadline, {default_wall:.3f} s at the "
          f"default {default_ms} ms (one at a time: {single_wall:.3f} s), every answer "
          f"byte-equal to the single request's; codec groups (members each: decode groups, "
          f"then encode groups, in launch order) {groups} at {DECODE_WAVE_DEADLINE_MS} ms, "
          f"{default_groups} at {default_ms} ms; kernel launches {counts} at "
          f"{DECODE_WAVE_DEADLINE_MS} ms, "
          f"{ {k: default_counts[k] for k in ('K16', 'K17', 'K18', 'K19')} } at {default_ms} "
          f"ms; one at a time "
          f"{ {k: single_counts[k] for k in ('K16', 'K17', 'K18', 'K19')} }; card {card}")
    check(0 < counts["K18"] < len(requests),
          f"decode wave: {counts['K18']} K18 launches for {len(requests)} requests")
    check(counts["K19"] > 0, "decode wave: K19 never launched")
    splits = {}
    for label, (data, scale) in {"4032x3024 baseline 1/4": (big["baseline"], 2),
                                 "4032x3024 baseline 1/1": (big["baseline"], 8),
                                 "4032x3024 progressive 1/4": (big["progressive"], 2),
                                 "300x250 1/1": (answer_jpeg(dev), 8)}.items():
        splits[label] = decode_split(torch, dev, data, scale)
    print(json.dumps({"decode_split": splits, "encode_group_launches": {
        "K16": counts["K16"], "K17": counts["K17"]}, "decode_wave": {
        f"deadline {DECODE_WAVE_DEADLINE_MS} ms": {"wall_s": round(wall, 4), "groups": groups,
                                                  "K18": counts["K18"]},
        f"deadline {default_ms} ms (default)": {"wall_s": round(default_wall, 4),
                                               "groups": default_groups,
                                               "K18": default_counts["K18"]},
        "one at a time": {"wall_s": round(single_wall, 4), "K18": single_counts["K18"]}},
        "card": card}))
    return counts


def main() -> int:
    global NVJPEG_ENCODE
    if not os.path.isdir(os.path.join(ROOT, "flyimg_tpu_torch")):
        raise SmokeFailure(f"no flyimg_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    import torch

    if sys.argv[1:] == ["--tiled-only"]:
        check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
        return tiled_only(torch)

    # phase 1: device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.codecs.jpeg_dec import color_planes, idct_planes
    from flyimg_tpu_torch.codecs.jpeg_enc import fdct_coefficients, trellis_coefficients
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
    from flyimg_tpu_torch.ops.rotate import ring_rotate_step, rotate_sampled

    resolve_device(dev)  # TF32 off for matmuls and convolutions
    kernels = {"K1": resample_banded_u8, "K1-f32": resample_banded_f32,
               "K2": _batched_weighted, "K3": _batched_scores,
               "K4": rotate_sampled, "K5": separable_filter, "K6": pixel_pass,
               "K7": pixelate_regions_u8, "K8": _batched_face_masks,
               "K9": conv5x5, "K10": pointwise, "K10-head": head_decode,
               "K11": conv5x5_backward, "K12": pointwise_backward, "K13": head_loss,
               "K14": adam_update, "K15": ring_rotate_step,
               "K16": trellis_coefficients, "K17": fdct_coefficients,
               "K18": idct_planes, "K19": color_planes}

    # phase 2: build (the kernels with nvcc and the host codecs with g++,
    # all at once), and nvJPEG loaded
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(cuda_build.build_host)
        took = cuda_build.build()
        host_took = host.result()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(took)} kernels in parallel {took}, host codecs {host_took}")
    from flyimg_tpu_torch.codecs import native_codec

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    print(f"codec libraries: nvJPEG {native_codec.nvjpeg_version()} "
          f"({native_codec.nvjpeg_path()}); WebP (VP8 and VP8L) codec, GIF/TIFF/BMP "
          f"loops and the JPEG writer built by {gxx}")
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    # K16, K17, K18 and K19 keep every value in registers or shared memory,
    # in every instance of each kernel
    for src, kernel in (("jpeg_trellis", "trellis_kernel"), ("jpeg_fdct", "fdct_kernel"),
                        ("jpeg_idct", "idct_kernel"), ("jpeg_color", "color_kernel")):
        found = {k: v for k, v in cuda_build.ptxas_report(
            cuda_build.build_logs.get(src, "")).items() if kernel in k}
        check(len(found) >= 1, f"ptxas: no report of {kernel} in {src}'s build log")
        for name, r in found.items():
            check("stack" in r and r["stack"] == 0 and r["spill_stores"] == 0
                  and r["spill_loads"] == 0,
                  f"ptxas: {name} has a {r.get('stack')}-byte stack frame, "
                  f"{r.get('spill_stores')} bytes of spill stores and {r.get('spill_loads')} "
                  "of spill loads")
            print(f"ptxas {kernel} ({name}): {r['registers']} registers, no stack frame, "
                  "no spills")

    # phase 3: kernels against their plain versions
    rows = phase_kernels(torch, dev)
    rows.update(phase_stage_kernels(torch, dev))
    rows.update(phase_face_kernels(torch, dev))
    rows.update(train_kernel_rows(torch, dev))
    train_edges(torch, dev)
    rows["K15"] = k15_case(torch, dev)
    fold2d = fold2d_case(torch, dev)
    rows.update(jpeg_kernel_rows(torch, dev))
    rows.update(jpeg_decode_rows(torch, dev, card))

    # from here on no served JPEG encode may reach nvJPEG's encode: it is the
    # yardstick phases 10 and 14 call by NVJPEG_ENCODE
    NVJPEG_ENCODE = native_codec.jpeg_encode
    nvjpeg_encodes = []

    def counted_nvjpeg_encode(*args, **kwargs):
        nvjpeg_encodes.append(1)
        return NVJPEG_ENCODE(*args, **kwargs)

    native_codec.jpeg_encode = counted_nvjpeg_encode

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
        # phase 9: the tall-input route (main path)
        reset_counts(kernels)
        tiled_times = phase_tiled(torch, dev, workdir)
        tiled_counts = read_counts(kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"faces kernel launches: {face_counts}")
    for name in ("K7", "K8", "K9", "K10", "K10-head"):
        check(face_counts[name] > 0, f"faces: {name} never launched")
    print(f"train kernel launches: {train_counts}")
    for name in ("K9", "K10", "K11", "K12", "K13", "K14"):
        check(train_counts[name] > 0, f"train: {name} never launched")
    print(f"tiled kernel launches: {tiled_counts}")
    for name in ("K1", "K1-f32", "K5", "K15"):
        check(tiled_counts[name] > 0, f"tiled: {name} never launched")

    # phase 10: the codec layer
    phase_codecs(torch, dev, card)

    # phase 11: batch isolation and out-of-memory recovery (main path)
    os.makedirs(workdir)
    try:
        reset_counts(kernels)
        phase_resilience(torch, dev, card, workdir, kernels)
        resilience_counts = read_counts(kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"resilience kernel launches: {resilience_counts}; card {card}")
    for name in ("K1", "K2", "K3"):
        check(resilience_counts[name] > 0, f"resilience: {name} never launched")

    # phase 12: the in-flight window, self-healing, host stages (main path)
    os.makedirs(workdir)
    try:
        reset_counts(kernels)
        phase_pipeline(torch, dev, card, workdir, kernels)
        pipeline_counts = read_counts(kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"pipeline kernel launches: {pipeline_counts}; card {card}")
    for name in ("K1", "K2", "K3"):
        check(pipeline_counts[name] > 0, f"pipeline: {name} never launched")

    # phase 13: GIF in and out, animated WebP, BMP, ICO and TIFF (main path)
    os.makedirs(workdir)
    try:
        formats_counts = phase_formats(torch, dev, card, workdir, kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"formats kernel launches: {formats_counts}; card {card}")
    check(formats_counts["K1"] > 0, "formats: K1 never launched")
    check(formats_counts["K16"] > 0, "formats: the JPEG answers never launched K16")

    # phase 14: JPEG answers through the server, byte for byte the JAX
    # handler's (main path)
    os.makedirs(workdir)
    try:
        jpeg_counts = phase_jpeg(torch, dev, card, workdir, kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"jpeg kernel launches: {jpeg_counts}; card {card}")

    # phase 15: the full-width JPEG source through the server's codec
    # batcher (main path)
    os.makedirs(workdir)
    try:
        decode_counts = phase_jpeg_decode(torch, dev, card, workdir, kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check(not nvjpeg_encodes, f"{len(nvjpeg_encodes)} JPEG encodes of phases 6-15 reached "
          "nvJPEG's encode")
    native_codec.jpeg_encode = NVJPEG_ENCODE

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
        "K15": ("ring_rotate_step", "flyimg_tpu_torch/csrc/ring_rotate.cu",
                "flyimg_tpu/parallel/tiling.py:370"),
        "K16": ("jpeg_trellis", "flyimg_tpu_torch/csrc/jpeg_trellis.cu",
                "flyimg_tpu/codecs/native/fastcodec.cpp:680"),
        "K17": ("jpeg_fdct", "flyimg_tpu_torch/csrc/jpeg_fdct.cu",
                "flyimg_tpu/codecs/native/fastcodec.cpp:354"),
        # host functions of the JAX package, through libjpeg-turbo's
        # jidctint.c/jidctred.c (K18) and jdsample.c/jdcolor.c (K19)
        "K18": ("jpeg_idct", "flyimg_tpu_torch/csrc/jpeg_idct.cu",
                "flyimg_tpu/codecs/native/fastcodec.cpp:86"),
        "K19": ("jpeg_color", "flyimg_tpu_torch/csrc/jpeg_color.cu",
                "flyimg_tpu/codecs/native/fastcodec.cpp:207"),
    }
    line = {"kernels": []}
    for key, (name, source, replaces) in meta.items():
        launches = (entry_counts[key] + staged_counts[key]
                    + sum(c[key] for c in server_counts.values())
                    + face_counts[key] + train_counts[key] + tiled_counts[key]
                    + resilience_counts[key] + pipeline_counts[key]
                    + formats_counts[key] + jpeg_counts[key] + decode_counts[key])
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
    print("tiled ms (tiled, untiled; u8 out): " + "; ".join(
        f"{label} {opts}{' ' + mode if mode else ''} {t[0]:.4f}, {t[1]:.4f}"
        for (label, opts, mode), t in tiled_times.items()))
    print(f"fold2d_bf16 dense resample: {fold2d['fold2d_ms']:.4f} ms, f32 form "
          f"{fold2d['f32_ms']:.4f} ms, bound {fold2d['bound_ms']:.4f} ms")
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
