"""Where K7's, K8's, K9's and K10's time goes on the card.

    python3 -m flyimg_tpu_torch.face_breakdown [--iters 200]

Five readings, one JSON line each, with the card's name and power limit:

1. K7 (``ops/pixelate.py pixelate_regions_u8``) on a 480x640 answer with
   the boxes facefind finds there, padded to 32: the single call's host time
   (``perf_counter`` around the call, no sync) beside its time by CUDA
   events, and each step a wrapper takes, timed alone on the host clock:
   the argument checks, ``.contiguous()`` and ``.to(float32)`` on tensors
   already in that form, ``torch.empty_like``, the stream lookup (a
   ``torch.cuda.current_stream`` object, or the raw handle), the bound
   ``ctypes`` function's lookup, the ``ctypes`` call alone (arguments the C
   function refuses before it launches) and the launch itself. Medians.
   Then the wrapper against a step-for-step replay of its earlier form
   (the same kernel launched), in turns in one process.
   Then its device time by case: no boxes (every band a copy), a box over
   the whole image (every band summed), factors 1 and 32, and a
   ``Tensor.copy_`` of the image as a yardstick of the bytes alone.
2. K10's block form (``models/blazeface.py pointwise``) at each of the 16
   layers of the 64-view forward: the single call by CUDA events and on the
   host clock, its device time from a ``torch.profiler`` window, and the
   layer's byte bound (input, output, weights and residual once each, at
   3.35 TB/s).
3. K9 (``models/blazeface.py conv5x5``) at each of the 17 calls of that
   forward (the stem, then each block's depthwise convolution): the same
   four numbers (the bound: input, output and filter once each), and the
   layer's ``k9_plan``.
4. K10's head form (``head_decode``) as the forward calls it, over both
   anchor maps: the same four numbers (the bound: both maps, the weights,
   the anchors read and the probabilities and boxes written once each).
5. K8 (``models/facefind.py _batched_face_masks``) at ``face_entry``'s 16 x
   480x640 and at the buckets the facefind face pass serves the 640x480
   answers in (1, 2, 4, 8 and 16 members, as ``detect_faces_batched``
   pads them): events, host, device time and launches a call from a
   ``torch.profiler`` window, the byte bound (3 bytes read and one written a
   pixel) and ``k8_plan``.

Only the package's public functions are called. ``chip_smoke.py`` phase 3
prints these readings too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time

import torch

H100_BYTES_PER_S = 3.35e12


def _host_us(fn, iters: int) -> float:
    """Median microseconds of ``fn()`` on the host clock, no sync."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def _event_ms(fn, iters: int) -> float:
    """Median milliseconds of a single ``fn()`` between two CUDA events."""
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


def _device_ms(fn, iters: int, name: str) -> float:
    """Device milliseconds a call of ``fn`` spends in kernels whose name
    holds ``name``, from a ``torch.profiler`` window of ``iters`` calls (a
    window that caught no such kernel, which happens, is taken again, up
    to three times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    us = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if "CUDA" in str(getattr(evt, "device_type", "")) and name in evt.key:
                dev_us = getattr(evt, "self_device_time_total", None)
                us += dev_us if dev_us is not None else getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            break
    return us / 1e3 / iters


def k7_serving_case(dev):
    """The 480x640 answer with its facefind boxes, padded to 32 (the face
    pass's shape): (image, boxes) on ``dev``."""
    import numpy as np

    from flyimg_tpu_torch.entry import skin_ellipse_image
    from flyimg_tpu_torch.models import facefind

    img = skin_ellipse_image(np.random.default_rng(21), 480, 640)
    found = facefind.detect_faces(img, device=dev)
    boxes = np.zeros((facefind.MAX_FACES, 4), np.float32)
    boxes[:len(found)] = found
    return torch.from_numpy(img).to(dev), torch.from_numpy(boxes).to(dev)


def k7_host_split(image: torch.Tensor, boxes: torch.Tensor, iters: int = 200) -> dict:
    """K7's single call, host and events, and each wrapper step alone on the
    host clock (microseconds)."""
    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.ops.pixelate import pixelate_regions_u8

    fn = cuda_build.load("pixelate").flyimg_pixelate
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(image)
    h, w, _ = image.shape
    index = image.device.index
    stream = torch.cuda.current_stream(image.device).cuda_stream

    def checks():
        return (image.dtype != torch.uint8 or image.dim() != 3 or image.shape[2] != 3
                or boxes.dim() != 2 or boxes.shape[1] != 4 or boxes.shape[0] > 256
                or image.device.type != "cuda" or boxes.device != image.device)

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    steps = {
        "checks": checks,
        "image.contiguous": image.contiguous,
        "boxes.to_f32.contiguous": lambda: boxes.to(torch.float32).contiguous(),
        "is_contiguous+dtype": lambda: (image.is_contiguous(), boxes.dtype == torch.float32,
                                        boxes.is_contiguous()),
        "empty_like": lambda: torch.empty_like(image),
        "current_stream_object": lambda: torch.cuda.current_stream(image.device).cuda_stream,
        "current_stream_raw": (lambda: raw(index)) if raw is not None else None,
        "load_and_getattr": lambda: getattr(cuda_build.load("pixelate"), "_flyimg_bound", False),
        "data_ptrs": lambda: (image.data_ptr(), boxes.data_ptr(), out.data_ptr()),
        # the C function refuses h = 0 before it launches: ctypes alone
        "ctypes_no_launch": lambda: fn(image.data_ptr(), boxes.data_ptr(), out.data_ptr(), 0,
                                       w, boxes.shape[0], 10, stream),
        "launch": lambda: fn(image.data_ptr(), boxes.data_ptr(), out.data_ptr(), h, w,
                             boxes.shape[0], 10, stream),
    }
    split = {name: (_host_us(step, iters) if step is not None else None)
             for name, step in steps.items()}
    call = lambda: pixelate_regions_u8(image, boxes)  # noqa: E731

    def before():
        """The wrapper's earlier form, step for step: every conversion, a
        new output, the stream object, the library lookup."""
        checks()
        img = image.contiguous()
        bx = boxes.to(torch.float32).contiguous()
        o = torch.empty_like(img)
        lib = cuda_build.load("pixelate")
        getattr(lib, "_flyimg_bound", False)
        rc = fn(img.data_ptr(), bx.data_ptr(), o.data_ptr(), h, w, int(bx.shape[0]), 10,
                torch.cuda.current_stream(img.device).cuda_stream)
        cuda_build.check(rc, "pixelate")
        return o

    # the two wrappers in turns in this process (the host's spread between
    # processes is larger than their difference)
    turns = {"before": [], "now": []}
    for _ in range(5):
        turns["before"].append(_host_us(before, iters))
        turns["now"].append(_host_us(call, iters))
    # device time by case: which path (copy or box) the time is in
    whole = torch.tensor([[0.0, 0.0, w, h]], device=image.device)
    cases = {"no boxes": (boxes[:0], 10), "whole-image box": (whole, 10),
             "factor 1": (boxes, 1), "factor 32": (boxes, 32)}
    by_case = {label: _device_ms(lambda b=b, f=f: pixelate_regions_u8(image, b, f), iters,
                                 "pixelate") for label, (b, f) in cases.items()}
    copy_out = torch.empty_like(image)
    by_case["torch copy_ (yardstick)"] = _device_ms(lambda: copy_out.copy_(image), iters, "")
    return {
        "shape": list(image.shape), "boxes": int(boxes.shape[0]),
        "call_host_us": _host_us(call, iters),
        "wrapper_host_us_in_turns": {k: statistics.median(v) for k, v in turns.items()},
        "call_event_ms": _event_ms(call, iters),
        "device_ms": _device_ms(call, iters, "pixelate"),
        "device_ms_by_case": by_case,
        "steps_host_us": split,
    }


def forward_calls(model, views):
    """The forward's kernel calls on the plain path: K9's 17 (x, kernel,
    bias, stride, relu), K10's 16 (y, kernel, bias, residual, stride) and
    the head form's maps (map, class kernel, class bias, offset kernel,
    offset bias, anchor offset), each holding its plain twin's input."""
    from flyimg_tpu_torch.models import blazeface as bf

    k9 = [(views, model.stem.kernel, model.stem.bias, 2, True)]
    x = bf.conv5x5_plain(*k9[0])
    k10, maps = [], []
    for i, block in enumerate(model.blocks):
        k9.append((x, block.dw_kernel, None, block.stride, False))
        k10.append((bf.conv5x5_plain(*k9[-1]), block.pw.kernel, block.pw.bias, x,
                    block.stride))
        x = bf.pointwise_plain(*k10[-1])
        if i == bf.X16_BLOCK:
            maps.append(x)
    maps.append(x)
    heads = [(fmap, cls.kernel, cls.bias, reg.kernel, reg.bias, off)
             for fmap, (cls, reg, off) in zip(maps, model._heads())]
    return k9, k10, heads


def k10_layer_times(model, views, iters: int = 50) -> list:
    """Each of K10's 16 calls at ``views``: its shape, the single call by
    CUDA events (ms) and on the host clock (us), its device time, and its
    byte bound (ms)."""
    from flyimg_tpu_torch.models import blazeface as bf

    rows = []
    for i, args in enumerate(forward_calls(model, views)[1]):
        y, kernel, _bias, res, stride = args
        n, h, w, cin = y.shape
        cout = kernel.shape[3]
        nbytes = 4.0 * (y.numel() + n * h * w * cout + kernel.numel() + res.numel())
        call = lambda a=args: bf.pointwise(*a)  # noqa: E731
        rows.append({
            "layer": i, "n": n, "h": h, "w": w, "pixels": n * h * w, "cin": cin, "cout": cout,
            "stride": stride, "ms": _event_ms(call, iters), "host_us": _host_us(call, iters),
            "device_ms": _device_ms(call, iters, "pointwise"),
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
        })
    return rows


def k9_layer_times(model, views, iters: int = 50) -> list:
    """Each of K9's 17 calls at ``views``: its shape, the single call by CUDA
    events (ms) and on the host clock (us), its device time, its byte bound
    (ms) and its plan."""
    from flyimg_tpu_torch.models import blazeface as bf

    rows = []
    for i, args in enumerate(forward_calls(model, views)[0]):
        x, kernel, bias, stride, _relu = args
        n, h, w, cin = x.shape
        cout = kernel.shape[3]
        oh, ow = -(-h // stride), -(-w // stride)
        nbytes = 4.0 * (x.numel() + n * oh * ow * cout + kernel.numel()
                        + (0 if bias is None else bias.numel()))
        depthwise = kernel.shape[2] == 1 and cout == cin
        plan = bf.k9_plan(n, h, w, cin, cout, stride, depthwise,
                          bf._sm_count(x.device.index))
        call = lambda a=args: bf.conv5x5(*a)  # noqa: E731
        rows.append({
            "layer": "stem" if i == 0 else i - 1, "n": n, "h": h, "w": w, "cin": cin,
            "cout": cout, "stride": stride, "ms": _event_ms(call, iters),
            "host_us": _host_us(call, iters), "device_ms": _device_ms(call, iters, "5x5"),
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "plan": list(plan),
        })
    return rows


def head_times(model, views, iters: int = 50) -> dict:
    """The head form over both maps at ``views``: launches, events (ms),
    host (us), device time (ms) and its byte bound (ms)."""
    from flyimg_tpu_torch.models import blazeface as bf

    maps = forward_calls(model, views)[2]
    n = views.shape[0]
    probs = torch.empty((n, bf.NUM_ANCHORS), device=views.device)
    boxes = torch.empty((n, bf.NUM_ANCHORS, 4), device=views.device)
    call = lambda: bf.head_decode(maps, model.anchors, probs, boxes)  # noqa: E731
    before = bf.head_decode.launches
    call()
    nbytes = 4.0 * (sum(sum(t.numel() for t in m[:5]) for m in maps)
                    + model.anchors.numel() + probs.numel() + boxes.numel())
    return {"n": n, "launches": bf.head_decode.launches - before,
            "ms": _event_ms(call, iters), "host_us": _host_us(call, iters),
            "device_ms": _device_ms(call, iters, "head"),
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}


def k8_rows(images, in_true, thresholds, iters: int = 50) -> list:
    """K8 at ``face_entry``'s bucket and at the face pass's serving buckets
    of 640x480 answers (copies of ``images``' members, the last one padding
    the occupancy up as ``detect_faces_batched`` does)."""
    from flyimg_tpu_torch.models import facefind
    from flyimg_tpu_torch.profile_entry import profiler_window

    cases = [("face_entry", images, in_true, thresholds)]
    for b in (1, 2, 4, 8, 16):
        cases.append((f"serving bucket of {b}", images[:b].contiguous(),
                      in_true[:b].contiguous(), thresholds[:b].contiguous()))
    rows = []
    for label, im, valid, thr in cases:
        b, h, w, _ = im.shape
        call = lambda im=im, valid=valid, thr=thr: facefind._batched_face_masks(  # noqa: E731
            im, valid, thr)
        window = {"launches_per_batch": 0}
        for _ in range(3):
            window = profiler_window(call, (), iters)
            if window["launches_per_batch"] > 0:
                break
        rows.append({
            "case": label, "shape": [b, h, w], "ms": _event_ms(call, iters),
            "host_us": _host_us(call, iters), "device_ms": window["device_ms_per_batch"],
            "launches": window["launches_per_batch"],
            "bound_ms": 4.0 * b * h * w / H100_BYTES_PER_S * 1e3,
            "plan": facefind.k8_plan(b, h, w)._asdict(),
        })
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("face_breakdown needs a CUDA card")
    from flyimg_tpu_torch.device import resolve_device
    from flyimg_tpu_torch.entry import face_entry
    from flyimg_tpu_torch.models import blazeface as bf

    dev = resolve_device("cuda")
    card = card_line()
    image, boxes = k7_serving_case(dev)
    print(json.dumps({"k7": k7_host_split(image, boxes, args.iters), "card": card}))
    _fn, (views, images, in_true, thresholds) = face_entry(dev)
    model = bf.load_weights(bf.PACKAGED_WEIGHTS, dev)
    layers = k10_layer_times(model, views, max(10, args.iters // 4))
    print(json.dumps({"k10_layers": layers, "views": int(views.shape[0]),
                      "total_ms": sum(r["ms"] for r in layers),
                      "total_device_ms": sum(r["device_ms"] for r in layers),
                      "total_host_us": sum(r["host_us"] for r in layers),
                      "total_bound_ms": sum(r["bound_ms"] for r in layers),
                      "card": card}))
    k9 = k9_layer_times(model, views, max(10, args.iters // 4))
    print(json.dumps({"k9_layers": k9, "views": int(views.shape[0]),
                      "total_ms": sum(r["ms"] for r in k9),
                      "total_device_ms": sum(r["device_ms"] for r in k9),
                      "total_host_us": sum(r["host_us"] for r in k9),
                      "total_bound_ms": sum(r["bound_ms"] for r in k9),
                      "card": card}))
    print(json.dumps({"head": head_times(model, views, max(10, args.iters // 4)),
                      "card": card}))
    print(json.dumps({"k8": k8_rows(images, in_true, thresholds, max(10, args.iters // 4)),
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
