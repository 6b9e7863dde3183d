"""Where K4's and K5's time goes on the card, form by form.

    python3 -m flyimg_tpu_torch.stage_breakdown [--iters 20]

One JSON line a case, with the card's name and power limit, at the shapes
the staged programs give the two kernels (``entry.py STAGED_OPTIONS`` on 32
1920x1080 sources):

- K4 on the r_-15 frame (f32 out) and the r_30 crop of w_800,h_600,c_1
  (valid regions smaller than the bucket; f32 out, and u8 out as that
  staged program stores it): ``rotate_sampled`` and the previous K4
  (``rotate_sampled_prev``): events, device time, the byte bound, and
  whether their outputs are the same bits;
- K5 on the r_-15 frame's blr_0x2 (13 taps, u8 out) and on the w_1280
  fit's unsh_0.25x0.25+8+0.065 (3 taps, u8 out): ``separable_filter``
  (``k5_plan``'s pick) and the two-pass form (``k5_launch`` of
  ``K5_TWO_PASS``): events, device time (the two passes
  apart), the byte bound, and whether the two forms' outputs are equal;
- K5 blurs of the r_-15 frame at 21 and 25 taps, at ``k5_plan``'s last
  tile-form count and the one past it, and at 31 and 61 (blr_0x5,
  blr_0x10): the tile form at ``K5_TILE`` against the two-pass form, by
  events, so that the plan's switch rests on a reading.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flyimg_tpu_torch.face_breakdown import (
    H100_BYTES_PER_S,
    _device_ms as device_ms,
    _event_ms as event_ms,
    card_line,
)


def staged_inputs(dev):
    """(the r_-15 frame's plan, frame f32, geometry rows), (the w_1280 fit's
    plan, its f32 resample), (the r_30 crop's plan, its f32 resample,
    geometry rows): the inputs the staged programs give K4 and K5."""
    from flyimg_tpu_torch.entry import STAGED_OPTIONS, staged_entry
    from flyimg_tpu_torch.ops.resample import resample_banded_f32, set_kernel_mode
    from flyimg_tpu_torch.spec.plan import rotated_bounds

    set_kernel_mode("banded")

    def resampled(opts, seed):
        _fn, (img, *args), group, plan, _final = staged_entry(opts, device=dev, seed=seed)
        in_true, span_y, span_x, out_true = args
        x = resample_banded_f32(img, group.resample_out, span_y, span_x, out_true,
                                in_true[:, :2], group.band_taps, plan.filter_method)
        return plan, x, args

    _fn, (img, *_), _group, plan, _final = staged_entry(STAGED_OPTIONS[5], device=dev, seed=5)
    frame = img.float()
    b, h, w, _ = frame.shape
    ow, oh = rotated_bounds(w, h, plan.rotate)
    geom = torch.tensor([[h, w, oh, ow]], dtype=torch.float32, device=dev).repeat(b, 1)
    fit_plan, fit, _ = resampled(STAGED_OPTIONS[2], 1)
    crop_plan, crop, args = resampled(STAGED_OPTIONS[0], 4)
    crop_geom = torch.cat([args[3], args[0][:, 2:4]], dim=1).contiguous()
    return (plan, frame, geom), (fit_plan, fit), (crop_plan, crop, crop_geom)


def k5_bound_ms(x: torch.Tensor, k: int) -> float:
    """x read once, the u8 output written once, the taps."""
    return (x.numel() * 4 + x.numel() + 4 * k) / H100_BYTES_PER_S * 1e3


def k5_row(label, x, kernel, mode, gain, thr, card, iters) -> dict:
    from flyimg_tpu_torch.ops.filters import K5_TWO_PASS, k5_launch, k5_plan, separable_filter

    b, h, w, _ = x.shape
    k = int(kernel.shape[0])
    plan = k5_plan(b, h, w, k, 0, True)

    def planned():
        return separable_filter(x, kernel, mode, gain, thr, True)

    def two():
        return k5_launch(x, kernel, K5_TWO_PASS, mode, gain, thr, True)

    return {
        "kernel": "K5", "case": label, "card": card, "shape": [b, h, w, 3], "taps": k,
        "plan": plan.__dict__, "forms_equal": bool(torch.equal(planned(), two())),
        "ms": event_ms(planned, iters), "two_pass_ms": event_ms(two, iters),
        "device_ms": device_ms(planned, iters, "tile_kernel" if plan.form == "tile" else "_pass"),
        "two_pass_device_ms": {
            name: device_ms(two, iters, name) for name in ("vertical_pass", "horizontal_pass")},
        "bound_ms": k5_bound_ms(x, k),
    }


def k5_tap_rows(x, card, iters) -> list:
    """K5's tile form at ``K5_TILE`` against its two-pass form on blurs of
    ``x`` at tap counts around ``k5_plan``'s switch, and at 61."""
    from flyimg_tpu_torch.ops.filters import (
        K5_TILE,
        K5_TWO_PASS,
        MODE_BLUR,
        K5Plan,
        k5_launch,
        k5_plan,
        k5_smem_bytes,
    )

    b, h, w, _ = x.shape
    last = max(k for k in range(1, 200, 2) if k5_plan(b, h, w, k, 0, True).form == "tile")
    rows = []
    for k in sorted({21, 25, last, last + 2, 31, 61}):
        half = k // 2
        kernel = np.exp(-(np.arange(-half, half + 1, dtype=np.float32) ** 2)
                        / np.float32(2.0 * (half / 3.0) ** 2)).astype(np.float32)
        kernel /= kernel.sum(dtype=np.float32)
        tile = K5Plan("tile", *K5_TILE, k5_smem_bytes(k, *K5_TILE, True))

        def tiled():
            return k5_launch(x, kernel, tile, out_u8=True)

        def two():
            return k5_launch(x, kernel, K5_TWO_PASS, out_u8=True)

        rows.append({
            "kernel": "K5", "case": f"blur of {k} taps", "card": card, "taps": k,
            "plan": k5_plan(b, h, w, k, 0, True).form,
            "forms_equal": bool(torch.equal(tiled(), two())),
            "tile_ms": event_ms(tiled, iters), "two_pass_ms": event_ms(two, iters),
            "bound_ms": k5_bound_ms(x, k),
        })
    return rows


def k4_row(label, x, degrees, background, geom, card, iters, out_u8=False) -> dict:
    from flyimg_tpu_torch.ops.rotate import rotate_sampled, rotate_sampled_prev

    def new():
        return rotate_sampled(x, degrees, background, geom, out_u8)

    def prev():
        return rotate_sampled_prev(x, degrees, background, geom, out_u8)

    a, p = new(), prev()
    equal = bool(torch.equal(a, p) if out_u8 else
                 torch.equal(a.view(torch.int32), p.view(torch.int32)))
    n_valid = float((geom[:, 0] * geom[:, 1]).sum())
    nbytes = 12 * n_valid + 16 * x.shape[0] + a.numel() * a.element_size()
    return {
        "kernel": "K4", "case": label, "card": card, "shape": list(x.shape),
        "out_shape": list(a.shape), "out": "u8" if out_u8 else "f32",
        "degrees": degrees, "bits_equal": equal,
        "ms": event_ms(new, iters), "prev_ms": event_ms(prev, iters),
        "device_ms": device_ms(new, iters, "rotate"),
        "prev_device_ms": device_ms(prev, iters, "rotate_prev"),
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
    }


def main(argv=None) -> int:
    from flyimg_tpu_torch.device import resolve_device
    from flyimg_tpu_torch.ops.filters import MODE_BLUR, MODE_UNSHARP, gaussian_kernel
    from flyimg_tpu_torch.ops.rotate import rotate_image

    parser = argparse.ArgumentParser(prog="flyimg_tpu_torch.stage_breakdown")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    (plan, frame, geom), (fit_plan, fit), (crop_plan, crop, crop_geom) = staged_inputs(dev)
    print(json.dumps(k4_row("r_-15 static frame", frame, plan.rotate, plan.background,
                            geom, card, args.iters)))
    for out_u8 in (False, True):
        print(json.dumps(k4_row("r_30 crop, valid < bucket", crop, crop_plan.rotate,
                                crop_plan.background, crop_geom, card, args.iters, out_u8)))
    rotated = rotate_image(frame, plan.rotate, plan.background)
    del frame
    r, s = plan.blur
    print(json.dumps(k5_row("blr_0x2 of the r_-15 frame", rotated, gaussian_kernel(r, s),
                            MODE_BLUR, 1.0, 0.0, card, args.iters)))
    for row in k5_tap_rows(rotated, card, max(3, args.iters // 4)):
        print(json.dumps(row))
    del rotated
    r, s, gain, thr = fit_plan.unsharp
    print(json.dumps(k5_row("unsharp of the w_1280 fit", fit, gaussian_kernel(r, s),
                            MODE_UNSHARP, gain, thr, card, args.iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
