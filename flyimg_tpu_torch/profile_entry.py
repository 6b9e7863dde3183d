"""Where the flagship batch's time goes on the card.

    python -m flyimg_tpu_torch.profile_entry [--batch 256] [--iters 20]
    python -m flyimg_tpu_torch.profile_entry --staged [--iters 20]
    python -m flyimg_tpu_torch.profile_entry --faces [--iters 20]
    python -m flyimg_tpu_torch.profile_entry --train [--iters 20]
    python -m flyimg_tpu_torch.profile_entry --tiled [--iters 20]

For the ``entry()`` batch (256 x 512x512x3 u8 -> 300x250 crop-fill,
saliency field, 150x150 stride-8 scoring), dense and banded:

1. a stage split by CUDA events — each stage run alone between two events,
   median over ``--iters`` runs (dense: weights, H matmul, W matmul, u8
   epilogue; banded: K1; both: K2, K3), beside the whole forward;
2. a ``torch.profiler`` window over ``--iters`` whole forwards: device
   time by kernel name and the device's busy share of the window's wall
   time.

Then kernel K2 alone at a serving shape ([16, 128, 160, 3], valid regions
smaller than the bucket): its device time a launch from a ``torch.profiler``
window of ``--iters`` launches, beside CUDA events over bursts of 20
launches (which also hold the host's launch time when that is longer).

Prints one JSON line per mode and one for K2 at the serving shape, with the
card's name and power limit. Needs a CUDA card.

With ``--staged``: each program of ``entry.STAGED_OPTIONS`` (the stages
after the resample, 32 x 1920x1080 sources), banded and dense — the whole
batch by CUDA events and a ``torch.profiler`` window (device time by
kernel, busy share), one JSON line each.

With ``--faces``: ``entry.face_entry``'s batch (the BlazeFace forward over
64 views, the facefind masks of 16 480x640 images) — the forward and the
masks apart by CUDA events (views/s, images/s), and a ``torch.profiler``
window over ``--iters`` batches (device time by kernel, busy share) — and
K7 on a 480x640 output with its facefind boxes (device time a launch);
one JSON line.

With ``--tiled``: the handler's tall-input route, each of
``entry.TILED_OPTIONS`` on the seeded 3840x2160 frame over a virtual
4-rank mesh on the card (the resample dense and banded), u8 out as the
handler asks: the tiled op and the same op untiled by CUDA events, and a
``torch.profiler`` window of each (device time by kernel, busy share). On
one card the ranks run one after another: this measures the schedule's
cost, not a multi-card speed. One JSON line each.

With ``--train``: the BlazeFace train step (kernels K9-K14, as
``entry.train_entry`` builds it) and the plain step (torch autograd, cuDNN) at batch 16 and 64 — the step
by CUDA events and a ``torch.profiler`` window over ``--iters`` steps
(device time by kernel, launches a step, busy share); one JSON line each.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.entry import (
    OUT_HW,
    STAGED_BATCH,
    STAGED_OPTIONS,
    STRIDE,
    entry,
    face_entry,
    flagship_band,
    staged_entry,
)
from flyimg_tpu_torch.models.smartcrop import (
    _batched_scores,
    _batched_weighted,
    importance_kernel,
)
from flyimg_tpu_torch.ops.resample import (
    quantize_u8,
    resample_banded_u8,
    resample_matrix,
    set_kernel_mode,
)


def _median_ms(fn, iters: int) -> float:
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


def stage_split(args, band, iters: int) -> dict:
    images, in_true, span_y, span_x, out_true = args
    b, in_h, in_w, c = images.shape
    oh, ow = OUT_HW
    dev = images.device
    stages = {}
    if band is None:
        def weights():
            return (
                resample_matrix(in_h, oh, span_y[:, 0], span_y[:, 1],
                                out_true[:, 0], in_true[:, 0]),
                resample_matrix(in_w, ow, span_x[:, 0], span_x[:, 1],
                                out_true[:, 1], in_true[:, 1]),
            )

        wy, wx = weights()
        img = images.to(torch.float32)
        tmp = torch.matmul(wy, img.reshape(b, in_h, in_w * c))
        t2 = tmp.reshape(b, oh, in_w, c).permute(0, 2, 1, 3).reshape(
            b, in_w, oh * c)
        res = torch.matmul(wx, t2).reshape(b, ow, oh, c).permute(0, 2, 1, 3)
        stages["u8_to_f32"] = _median_ms(lambda: images.to(torch.float32), iters)
        stages["weights"] = _median_ms(weights, iters)
        stages["h_matmul"] = _median_ms(
            lambda: torch.matmul(wy, img.reshape(b, in_h, in_w * c)), iters)
        stages["w_transpose"] = _median_ms(
            lambda: tmp.reshape(b, oh, in_w, c).permute(0, 2, 1, 3).reshape(
                b, in_w, oh * c), iters)
        stages["w_matmul"] = _median_ms(lambda: torch.matmul(wx, t2), iters)
        stages["u8_epilogue"] = _median_ms(
            lambda: quantize_u8(res).contiguous(), iters)
        out = quantize_u8(res).contiguous()
    else:
        def k1():
            return resample_banded_u8(images, OUT_HW, span_y, span_x,
                                      out_true, in_true, band)

        stages["K1"] = _median_ms(k1, iters)
        out = k1()
    valid = torch.tensor(OUT_HW, dtype=torch.float32, device=dev).repeat(b, 1)
    stages["K2"] = _median_ms(lambda: _batched_weighted(out, valid), iters)
    field = _batched_weighted(out, valid)
    ker = torch.from_numpy(importance_kernel(150.0, 150.0)).to(dev)
    ker = ker[None, :, :, None, None].contiguous()
    stages["K3"] = _median_ms(lambda: _batched_scores(field, ker, STRIDE), iters)
    return stages


def profiler_window(fn, args, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    device_ms = 0.0
    launches = 0
    for evt in prof.key_averages():
        # device-side events only: the CPU-side op events carry the same
        # device time again
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            by_kernel[evt.key[:120]] = dev_us / 1e3 / iters
            device_ms += dev_us / 1e3
            launches += evt.count
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {
        "wall_ms_per_batch": wall_ms / iters,
        "launches_per_batch": launches / iters,
        "device_ms_per_batch": device_ms / iters,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "top_device_ms_per_batch": top,
    }


def _kernel_device_ms(fn, iters: int, name: str) -> float:
    """Device milliseconds a call of ``fn`` spends in kernels whose name
    holds ``name``, from a ``torch.profiler`` window of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = 0.0
    for evt in prof.key_averages():
        if "CUDA" in str(getattr(evt, "device_type", "")) and name in evt.key:
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            device_us += dev_us
    return device_us / 1e3 / iters


def k2_serving(iters: int, dev) -> dict:
    """Device and burst milliseconds a K2 launch at the serving shape."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    images = torch.randint(0, 256, (16, 128, 160, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    valid = torch.tensor([[111 - i % 5, 133 + i % 7] for i in range(16)],
                         dtype=torch.float32, device=dev)

    def burst():
        for _ in range(20):
            _batched_weighted(images, valid)

    burst_ms = _median_ms(burst, iters) / 20
    device_ms = _kernel_device_ms(lambda: _batched_weighted(images, valid),
                                  iters, "saliency")
    return {"shape": [16, 128, 160, 3], "device_ms": device_ms,
            "burst_ms": burst_ms}


def staged_rows(iters: int, dev, card: str):
    """One row per (staged program, resample mode): the whole batch by CUDA
    events, images/s from it, and a profiler window."""
    for opts in STAGED_OPTIONS:
        for mode in ("banded", "dense"):
            set_kernel_mode(mode)
            fn, fargs, group, _plan, final = staged_entry(opts, device=dev)
            forward = _median_ms(lambda: fn(*fargs), iters)
            yield {
                "staged": opts, "mode": mode, "batch": STAGED_BATCH,
                "card": card, "in_shape": list(fargs[0].shape),
                "final_hw": list(final), "band_taps": group.band_taps,
                "forward_ms": forward,
                "images_per_s": STAGED_BATCH / forward * 1e3,
                "profiler": profiler_window(fn, fargs, iters),
            }
            del fargs
            if group.resample_out is None:
                break  # no resample: the two modes run one program
    set_kernel_mode("dense")


def k7_serving(iters: int, dev) -> dict:
    """Device and single-call milliseconds of K7 on a 480x640 output (a
    w_640 face-blur answer) with the boxes facefind finds there."""
    import numpy as np

    from flyimg_tpu_torch.entry import skin_ellipse_image
    from flyimg_tpu_torch.models import facefind
    from flyimg_tpu_torch.ops.pixelate import pixelate_regions_u8

    img = skin_ellipse_image(np.random.default_rng(21), 480, 640)
    found = facefind.detect_faces(img, device=dev)
    boxes = np.zeros((facefind.MAX_FACES, 4), np.float32)
    boxes[:len(found)] = found
    image = torch.from_numpy(img).to(dev)
    dboxes = torch.from_numpy(boxes).to(dev)
    single_ms = _median_ms(lambda: pixelate_regions_u8(image, dboxes), iters)
    device_ms = _kernel_device_ms(lambda: pixelate_regions_u8(image, dboxes),
                                  iters, "pixelate")
    return {"shape": [480, 640, 3], "boxes": len(found),
            "device_ms": device_ms, "single_ms": single_ms}


def face_row(iters: int, dev, card: str) -> dict:
    """The face batch: its two halves by CUDA events, the whole in a
    profiler window; then K7 at a serving shape."""
    from flyimg_tpu_torch.models import blazeface, facefind

    fn, fargs = face_entry(device=dev)
    views, images, in_true, thresholds = fargs
    model = blazeface.load_weights(blazeface.PACKAGED_WEIGHTS, dev)
    forward_ms = _median_ms(lambda: blazeface._forward(model, views), iters)
    masks_ms = _median_ms(lambda: facefind._batched_face_masks(
        images, in_true, thresholds), iters)
    return {
        "faces": True, "card": card, "views": views.shape[0],
        "images": list(images.shape), "batch_ms": _median_ms(lambda: fn(*fargs), iters),
        "forward_ms": forward_ms, "masks_ms": masks_ms,
        "views_per_s": views.shape[0] / forward_ms * 1e3,
        "images_per_s": images.shape[0] / masks_ms * 1e3,
        "profiler": profiler_window(fn, fargs, iters),
        "k7_serving": k7_serving(iters, dev),
    }


def plain_train_step(model):
    """The yardstick of ``make_train_step``: torch autograd over
    ``loss_fn_plain`` (cuDNN's convolutions on the card), the gradients
    concatenated, ``adam_update_plain``. Returns the step like
    ``make_train_step``'s; it runs none of K9-K14."""
    from flyimg_tpu_torch.models import blazeface_train as bt

    if not hasattr(model, "flat_params"):
        bt.flatten_parameters(model)
    params = list(model.parameters())
    mu, nu = torch.zeros_like(model.flat_params), torch.zeros_like(model.flat_params)
    count = [0]

    def step(images, target_probs, target_boxes, anchor_mask):
        for p in params:
            p.grad = None
        loss = bt.loss_fn_plain(model, images, target_probs, target_boxes, anchor_mask)
        loss.backward()
        count[0] += 1
        bt.adam_update_plain(model.flat_params, torch.cat([p.grad.reshape(-1) for p in params]),
                             mu, nu, count[0])
        return loss.detach()

    return step


def train_rows(iters: int, dev, card: str):
    """The train step, kernels and plain, at batch 16 and 64: the step by
    CUDA events and in a profiler window."""
    import numpy as np

    from flyimg_tpu_torch.models import blazeface_train as bt

    for batch in (16, 64):
        sargs = bt.batch_to(bt.synthetic_batch(np.random.default_rng(0), batch), dev)
        for plain in (False, True):
            model = bt.init_params(0, dev)
            step = plain_train_step(model) if plain else bt.make_train_step(model)[1]
            step_ms = _median_ms(lambda: step(*sargs), iters)
            yield {
                "train": "plain" if plain else "kernels", "batch": batch, "card": card,
                "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
                "images_per_s": batch * 1e3 / step_ms,
                "profiler": profiler_window(step, sargs, iters),
            }


def tiled_rows(iters: int, dev, card: str):
    """One row per (tiled op, resample mode): tiled and untiled by CUDA
    events and in a profiler window."""
    from flyimg_tpu_torch.entry import TILED_HW, TILED_OPTIONS, TILED_RANKS, tiled_entry, untiled_fn

    for opts in TILED_OPTIONS:
        for mode in (("dense", "banded") if opts.startswith("w_") else (None,)):
            fn, fargs = tiled_entry(opts, TILED_RANKS, dev, kernel=mode)
            plain = untiled_fn(opts, TILED_HW, True, mode)
            yield {
                "tiled": opts, "mode": mode, "ranks": TILED_RANKS,
                "frame_hw": list(TILED_HW), "card": card,
                "tiled_ms": _median_ms(lambda: fn(*fargs), iters),
                "untiled_ms": _median_ms(lambda: plain(*fargs), iters),
                "profiler": profiler_window(fn, fargs, iters),
                "untiled_profiler": profiler_window(plain, fargs, iters),
            }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flyimg_tpu_torch.profile_entry")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--staged", action="store_true",
                        help="profile the staged programs instead")
    parser.add_argument("--faces", action="store_true",
                        help="profile the face batch instead")
    parser.add_argument("--train", action="store_true",
                        help="profile the BlazeFace train step instead")
    parser.add_argument("--tiled", action="store_true",
                        help="profile the tall-input tiled route instead")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if args.faces:
        print(json.dumps(face_row(args.iters, dev, card)))
        return 0
    if args.train:
        for row in train_rows(args.iters, dev, card):
            print(json.dumps(row))
        return 0
    if args.tiled:
        for row in tiled_rows(args.iters, dev, card):
            print(json.dumps(row))
        return 0
    if args.staged:
        for row in staged_rows(args.iters, dev, card):
            print(json.dumps(row))
        return 0
    for mode in ("dense", "banded"):
        set_kernel_mode(mode)
        fn, fargs = entry(device=dev, batch=args.batch)
        row = {
            "mode": mode, "batch": args.batch, "card": card,
            "forward_ms": _median_ms(lambda: fn(*fargs), args.iters),
            "stages_ms": stage_split(fargs, flagship_band(), args.iters),
            "profiler": profiler_window(fn, fargs, args.iters),
        }
        print(json.dumps(row))
    set_kernel_mode("dense")
    print(json.dumps({"mode": "k2_serving", "card": card,
                      **k2_serving(args.iters, dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
