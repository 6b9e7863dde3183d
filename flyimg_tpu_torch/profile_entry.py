"""Where the flagship batch's time goes on the card.

    python -m flyimg_tpu_torch.profile_entry [--batch 256] [--iters 20]

For the ``entry()`` batch (256 x 512x512x3 u8 -> 300x250 crop-fill,
saliency field, 150x150 stride-8 scoring), dense and banded:

1. a stage split by CUDA events — each stage run alone between two events,
   median over ``--iters`` runs (dense: weights, H matmul, W matmul, u8
   epilogue; banded: K1; both: K2, K3), beside the whole forward;
2. a ``torch.profiler`` window over ``--iters`` whole forwards: device
   time by kernel name and the device's busy share of the window's wall
   time.

Prints one JSON line per mode, with the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.entry import OUT_HW, STRIDE, entry, flagship_band
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
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {
        "wall_ms_per_batch": wall_ms / iters,
        "device_ms_per_batch": device_ms / iters,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "top_device_ms_per_batch": top,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flyimg_tpu_torch.profile_entry")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
