#!/usr/bin/env python3
"""Smoke run of the PyTorch package (flyimg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without a result line:

1. device  — a CUDA card must be visible; prints nvidia-smi's name and
             power limit;
2. build   — compiles kernels K1-K3 from csrc/ with nvcc (one process per
             source, all at once) and prints the build time and ptxas report;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the flagship shape and at a serving shape, with the median times
             of the kernel, the plain version and (where one exists) the one
             PyTorch library call computing the same function;
4. entry   — the flagship batch (256 x 512x512x3 u8 -> 300x250, saliency,
             150x150 scoring) with resample_kernel dense and banded, held
             against the plain path on the card, then timed;
5. server  — the package's HTTP server on the card answers 16 concurrent
             /upload/w_300,h_250,c_1[,smc_1]/ requests for seeded synthetic
             PNGs, dense and banded; every answer is held against the same
             request through the handler on the CPU; a repeat is a cache hit.

Launch counters are zeroed right before each main-path phase (4 and 5) and
read right after; every kernel must have launched in each. The last lines
are the card, one JSON object describing every kernel, and
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


def k1_case(torch, label, args, out_hw, band, method):
    from flyimg_tpu_torch.ops.resample import (
        _band_axis,
        quantize_u8,
        resample_banded_u8,
        resample_image_banded,
    )

    images, in_true, span_y, span_x, out_true = args
    b, in_h, in_w, _ = images.shape

    def kern():
        return resample_banded_u8(images, out_hw, span_y, span_x, out_true,
                                  in_true, band, method)

    def plain():
        return quantize_u8(resample_image_banded(
            images.float(), out_hw, span_y, span_x, out_true, in_true, band,
            method,
        ))

    got, ref = kern(), plain()
    torch.cuda.synchronize()
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
    nbytes = 3.0 * float((rows_b * cols_b).sum()) + b * 8 * 4 + got.numel()
    row = {
        "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain, iters=3),
        "library_ms": None, "max_abs_err": float(err),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    print(f"K1 {label}: in {tuple(images.shape)} -> {out_hw} K={band} "
          f"max diff {err} u8 (bound {PIXEL_TOL}), {n_diff} of {got.numel()} "
          f"values differ ({frac:.2e}, bound {DIFF_FRAC:.0e}); source reached "
          f"{float((rows_b * cols_b).sum()) / (b * in_h * in_w):.4f} of the "
          f"bucket; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})")
    return row


def k2_case(torch, label, images, in_true):
    from flyimg_tpu_torch.models.smartcrop import (
        _batched_weighted,
        batched_weighted_plain,
    )

    got = _batched_weighted(images, in_true)
    ref = batched_weighted_plain(images, in_true)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(err == 0.0, f"K2 {label}: max diff {err} != 0")
    b, h, w, _ = images.shape
    row = {
        "ms": cuda_ms(torch, lambda: _batched_weighted(images, in_true)),
        "plain_ms": cuda_ms(
            torch, lambda: batched_weighted_plain(images, in_true), iters=3
        ),
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
    print(f"K2 {label}: {tuple(images.shape)} valid "
          f"{in_true[0].tolist()} max diff {err} (bound 0); kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def k3_case(torch, label, field, kernels, stride):
    import torch.nn.functional as F

    from flyimg_tpu_torch.models.smartcrop import (
        _batched_scores,
        batched_scores_plain,
    )

    b, fh, fw = field.shape
    _, khm, kwm, _, c = kernels.shape
    got_g, got_t = _batched_scores(field, kernels, stride)
    ref_g, ref_t = batched_scores_plain(field, kernels, stride)
    torch.cuda.synchronize()
    rel = max(rel_err(torch, got_g, ref_g), rel_err(torch, got_t, ref_t))
    err = float(max((got_g - ref_g).abs().max(), (got_t - ref_t).abs().max()))
    check(rel <= SCORE_RTOL, f"K3 {label}: relative diff {rel} > {SCORE_RTOL}")

    # the yardstick: one grouped convolution (full f32, TF32 off)
    weight = (
        kernels[:, :, :, 0, :].expand(b, khm, kwm, c)
        .permute(0, 3, 1, 2).reshape(b * c, 1, khm, kwm).contiguous()
    )
    inp = field[None]

    def library():
        return F.conv2d(inp, weight, stride=stride, groups=b)

    lib = library().reshape(b, c, *got_g.shape[1:3]).permute(0, 2, 3, 1)
    lib_rel = rel_err(torch, lib, ref_g)
    ny, nx = got_g.shape[1:3]
    row = {
        "ms": cuda_ms(torch, lambda: _batched_scores(field, kernels, stride)),
        "plain_ms": cuda_ms(
            torch, lambda: batched_scores_plain(field, kernels, stride), iters=3
        ),
        "library_ms": cuda_ms(torch, library), "max_abs_err": err,
    }
    # the nonzero kernel taps of every (member, channel) at every window
    # position, plus the field totals
    taps = float((kernels != 0).sum()) * (b // kernels.shape[0])
    flops = 2.0 * ny * nx * taps + b * fh * fw
    nbytes = 4.0 * (field.numel() + kernels.numel() + got_g.numel() + b)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    print(f"K3 {label}: field {tuple(field.shape)} kernels "
          f"{tuple(kernels.shape)} stride {stride} -> grid {ny}x{nx}x{c}; "
          f"relative diff {rel:.3e} (bound {SCORE_RTOL}), conv2d relative "
          f"diff {lib_rel:.3e}; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, conv2d {row['library_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_kernels(torch, dev):
    import numpy as np

    from flyimg_tpu_torch.entry import OUT_HW, flagship_band, flagship_fn
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
    return rows


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
        print(f"entry {mode} (band {band}): pixels within {pix} u8 "
              f"({n_diff} of {out.numel()} differ, {frac:.2e}) and scores "
              f"within {rel:.3e} relative of the plain path; steady state "
              f"{rates[mode]:.1f} images/s ({dt / iters * 1e3:.3f} ms a "
              f"256-image batch) on {card}")
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
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    set_kernel_mode("dense")
    return counts


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
    from flyimg_tpu_torch.models.smartcrop import _batched_scores, _batched_weighted
    from flyimg_tpu_torch.ops.resample import resample_banded_u8

    resolve_device(dev)  # TF32 off for matmuls and convolutions
    kernels = {"K1": resample_banded_u8, "K2": _batched_weighted,
               "K3": _batched_scores}

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

    # phase 4: entry (main path)
    reset_counts(kernels)
    rates = phase_entry(torch, dev, card)
    entry_counts = read_counts(kernels)
    print(f"entry kernel launches: {entry_counts}")
    for name, n in entry_counts.items():
        check(n > 0, f"entry: {name} never launched")

    # phase 5: server (main path)
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        server_counts = phase_server(torch, dev, workdir, kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    meta = {
        "K1": ("resample_banded_u8", "flyimg_tpu_torch/csrc/resample_banded.cu",
               "flyimg_tpu/ops/resample.py:343"),
        "K2": ("saliency_field", "flyimg_tpu_torch/csrc/saliency.cu",
               "flyimg_tpu/models/smartcrop.py:424"),
        "K3": ("candidate_scores", "flyimg_tpu_torch/csrc/scores.cu",
               "flyimg_tpu/models/smartcrop.py:441"),
    }
    line = {"kernels": []}
    for key, (name, source, replaces) in meta.items():
        launches = entry_counts[key] + sum(c[key] for c in server_counts.values())
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
